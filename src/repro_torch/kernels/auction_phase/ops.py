"""Public auction-phase op: the persistent CUDA kernel on the card, the
step-wise loop on CPU.

Dispatch follows the value tensor's device and nothing else: a CPU tensor
takes `ref.auction_phase_ref`, a CUDA tensor launches the kernel (or
raises), anything else raises. There is no fallback from the kernel to the
plain version.
"""

from __future__ import annotations

import torch

from . import kernel_cuda, ref


def auction_phase(price0, values_m, value_u, job_col, active, eps: float, max_iters: int,
                  *, iters_on_device: bool = False):
    """(price, owner, assigned, iters). See ref.py for semantics.

    ``iters_on_device``: ``iters`` is a 0-dim int64 tensor on the values'
    device (on the card the launch is then not waited for), so a caller
    with several solves reads their counts in one transfer.
    """
    kind = values_m.device.type
    if kind == "cuda":
        return kernel_cuda.auction_phase_cuda(price0, values_m, value_u, job_col, active,
                                              eps, max_iters, stats_on_device=iters_on_device)
    if kind == "cpu":
        price, owner, assigned, iters = ref.auction_phase_ref(
            price0, values_m, value_u, job_col, active, eps, max_iters)
        if iters_on_device:
            iters = torch.tensor(iters, dtype=torch.int64)
        return price, owner, assigned, iters
    raise ValueError(f"auction_phase: unsupported device {values_m.device}")
