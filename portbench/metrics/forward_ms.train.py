"""forward_ms.train: the device time of the operations launched inside the
program's ``lm.train.forward`` spans (the loss: every layer's forward and
the chunked cross-entropy, with flash attention's kernel), per step of the
window (`harness.program_trace`)."""

from harness import program_trace


def read(run):
    return program_trace.ms_per(run, "lm.train.forward", len(run.facts.get("steps") or ()))
