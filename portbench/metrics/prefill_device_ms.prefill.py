"""prefill_device_ms.prefill: the device time of the operations launched
inside the program's ``lm.prefill`` spans (a batch's prefill and its first
pick), per prefill of the window, over its whole cycle of prompt lengths
(`harness.program_trace`). Beside the program's host-timed ``prefill_s``
(`mfu.prefill`), what of a prefill the card spends working."""

from harness import program_trace


def read(run):
    return program_trace.ms_per(run, "lm.prefill") if run.facts.get("batches") else None
