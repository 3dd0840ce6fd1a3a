"""flash_roofline.prefill: the roofline time of the prefills'
flash-attention calls (causal, each at its batch's prompt length) over
their summed device time in the trace. A call belongs to the batch whose
span it starts in: a batch ends waiting for the card."""

from harness import counts
from harness.trace import assign

KERNEL = "flash_attention_kernel"


def read(run):
    tr, batches = run.trace_data, run.facts.get("batches")
    if tr is None or not batches:
        return None
    spans = tr.spans_named("batch")
    if len(spans) != len(batches):
        return None
    a = run.arch
    bound = dev = 0.0
    for i, calls in assign(tr.ops_named(KERNEL), spans).items():
        b = batches[i]
        one = counts.roofline_s(*counts.flash_call(b["B"], a["n_heads"], a["n_kv_heads"], b["P"],
                                                   a["head_dim"]))
        bound += one * len(calls)
        dev += sum(e - s for _, s, e in calls) / 1e9
    return 100.0 * bound / dev if dev else None
