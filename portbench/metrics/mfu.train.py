"""mfu.train: the train steps' model FLOPs over their wall time, as a share
of the dense TF32 peak (host clock; counts from the configuration)."""

from harness import counts, peaks


def read(run):
    steps = run.facts.get("steps")
    if not steps:
        return None
    f = counts.train_step_flops(run.arch, run.facts["batch"], run.facts["seq_len"])
    wall = sum(b - a for a, b in steps)
    return 100.0 * f * len(steps) / wall / peaks.PEAK_FLOPS
