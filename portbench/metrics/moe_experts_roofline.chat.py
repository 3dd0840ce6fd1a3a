"""moe_experts_roofline.chat: the time HBM needs to read every expert's
float32 weights once a decode step (the bytes `counts.decode_step_bytes`
counts for them), over the device time of the operations launched inside
the program's ``lm.moe.experts`` spans within its ``lm.decode_step`` spans,
over the window's decode steps (`harness.program_trace`)."""

from harness import counts, program_trace
from harness.peaks import HBM_BYTES_PER_S


def read(run):
    pt = program_trace.of(run)
    if not run.facts.get("batches") or pt is None:
        return None
    steps = pt.count("lm.decode_step")
    dev = pt.device_s("lm.moe.experts", within="lm.decode_step")
    if not steps or not dev:
        return None
    a = run.arch
    nbytes = counts.F32 * a["n_layers"] * a["n_experts"] * counts.expert_params(a)
    return 100.0 * steps * nbytes / HBM_BYTES_PER_S / dev
