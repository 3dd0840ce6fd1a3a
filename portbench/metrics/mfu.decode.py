"""mfu.decode: the decode steps' roofline time (the larger of their FLOPs
over the dense TF32 peak and their bytes over HBM's rate) over the
program's own ``decode_s``. An MoE layer's bytes count every expert: at
the chat cell's 32 rows of top-4 of 16, an expert that no row reaches has
a chance of (3/4)^32, 1e-4, a layer and step under even routing."""

from harness import counts


def read(run):
    batches = run.facts.get("batches")
    if not batches:
        return None
    a = run.arch
    bound = 0.0
    for b in batches:
        for j in range(b["gen"] - 1):
            ctx = [b["P"] + j + 1] * b["B"]
            bound += counts.roofline_s(counts.decode_step_flops(a, ctx),
                                       counts.decode_step_bytes(a, ctx))
    s = sum(b["timings"]["decode_s"] for b in batches)
    return 100.0 * bound / s
