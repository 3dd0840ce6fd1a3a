"""optimizer_ms.train: the device time of the operations launched inside
the program's ``lm.train.optimizer`` spans (the gradients' global norm and
the AdamW update of every parameter), per step of the window
(`harness.program_trace`)."""

from harness import program_trace


def read(run):
    return program_trace.ms_per(run, "lm.train.optimizer", len(run.facts.get("steps") or ()))
