"""flash_roofline.train: the roofline time of the window's flash-attention
calls (forward and remat recompute, causal at the step's shapes) over
their summed device time in the trace."""

from harness import counts

KERNEL = "flash_attention_kernel"


def read(run):
    tr, w = run.trace_data, run.facts.get("window_ns")
    if tr is None or w is None:
        return None
    calls = tr.within(tr.ops_named(KERNEL), *w)
    if not calls:
        return None
    a = run.arch
    one = counts.roofline_s(*counts.flash_call(run.facts["batch"], a["n_heads"], a["n_kv_heads"],
                                               run.facts["seq_len"], a["head_dim"]))
    return 100.0 * one * len(calls) / (sum(e - s for _, s, e in calls) / 1e9)
