"""Public auction-phase op: the persistent CUDA kernel on the card, the
step-wise loop on CPU.

Dispatch follows the value tensor's device and nothing else: a CPU tensor
takes `ref.auction_phase_ref`, a CUDA tensor launches the kernel (or
raises), anything else raises. There is no fallback from the kernel to the
plain version.
"""

from __future__ import annotations

from . import kernel_cuda, ref


def auction_phase(price0, values_m, value_u, job_col, active, eps: float, max_iters: int):
    """(price, owner, assigned, iters). See ref.py for semantics."""
    kind = values_m.device.type
    if kind == "cuda":
        return kernel_cuda.auction_phase_cuda(price0, values_m, value_u, job_col, active,
                                              eps, max_iters)
    if kind == "cpu":
        return ref.auction_phase_ref(price0, values_m, value_u, job_col, active, eps,
                                     max_iters)
    raise ValueError(f"auction_phase: unsupported device {values_m.device}")
