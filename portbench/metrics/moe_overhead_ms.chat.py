"""moe_overhead_ms.chat: the device time of the operations launched inside
the program's ``lm.moe.router``, ``lm.moe.dispatch`` and ``lm.moe.combine``
spans within its ``lm.decode_step`` spans: the MoE's work besides the
experts' products, per decode step of the window (`harness.program_trace`)."""

from harness import program_trace

PARTS = ("lm.moe.router", "lm.moe.dispatch", "lm.moe.combine")


def read(run):
    pt = program_trace.of(run)
    if not run.facts.get("batches") or pt is None:
        return None
    steps = pt.count("lm.decode_step")
    if not steps or not all(pt.count(p) for p in PARTS):
        return None
    return 1e3 * sum(pt.device_s(p, within="lm.decode_step") for p in PARTS) / steps
