"""backward_ms.train: the device time of the operations launched inside the
program's ``lm.train.backward`` spans (the autograd backward of the loss,
the remat recompute within it), per step of the window
(`harness.program_trace`)."""

from harness import program_trace


def read(run):
    return program_trace.ms_per(run, "lm.train.backward", len(run.facts.get("steps") or ()))
