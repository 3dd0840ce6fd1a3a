"""decode_attn_roofline.chat: the byte-bound time of the decode-attention
calls (each row's valid bf16 K/V read once) over their summed device time
in the trace. Within a batch's span the calls run in order, one a layer a
step: call n reads positions of step n // n_layers."""

from harness import counts
from harness.peaks import HBM_BYTES_PER_S
from harness.trace import assign

KERNEL = "decode_attention_kernel"


def read(run):
    tr, batches = run.trace_data, run.facts.get("batches")
    if tr is None or not batches:
        return None
    spans = tr.spans_named("batch")
    if len(spans) != len(batches):
        return None
    a = run.arch
    L = a["n_layers"]
    bound = dev = 0.0
    for i, calls in assign(tr.ops_named(KERNEL), spans).items():
        b = batches[i]
        for n, (_, s, e) in enumerate(calls):
            valid = [b["P"] + n // L + 1] * b["B"]
            nbytes = counts.decode_attn_bytes(a["n_heads"], a["n_kv_heads"], a["head_dim"], valid)
            bound += nbytes / HBM_BYTES_PER_S
            dev += (e - s) / 1e9
    return 100.0 * bound / dev if dev else None
