"""mfu.prefill: the prefills' forward FLOPs over the program's own
``prefill_s`` (`serve_batch(timings=...)`: host clock, the card waited
for), as a share of the dense TF32 peak."""

from harness import counts, peaks


def read(run):
    batches = run.facts.get("batches")
    if not batches:
        return None
    f = sum(counts.prefill_flops(run.arch, b["B"], b["P"]) for b in batches)
    s = sum(b["timings"]["prefill_s"] for b in batches)
    return 100.0 * f / s / peaks.PEAK_FLOPS
