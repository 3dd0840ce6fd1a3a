"""flash_backward_ms.train: the device time of the operations launched
inside the program's ``lm.attn.flash_backward`` spans (flash attention's
backward kernel, `csrc/flash_attention_bwd.cu`: its delta, dQ and dK/dV
launches), per step of the window (`harness.program_trace`)."""

from harness import program_trace


def read(run):
    return program_trace.ms_per(run, "lm.attn.flash_backward",
                                len(run.facts.get("steps") or ()))
