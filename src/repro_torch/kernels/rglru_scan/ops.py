"""Public RG-LRU scan op: the CUDA kernel on the card, plain on CPU.

Dispatch follows gx's device and nothing else: a CPU tensor takes
`ref.rglru_scan_ref`, a CUDA tensor launches the kernel (or raises),
anything else raises. There is no fallback from the kernel to the plain
version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel_cuda, ref


def rglru_scan(
    log_a: torch.Tensor,
    gx: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
):
    """(states (B, T, D) in gx's dtype, final state (B, D) float32)."""
    kind = gx.device.type
    if kind == "cuda":
        return kernel_cuda.rglru_scan_cuda(log_a, gx, h0)
    if kind == "cpu":
        return ref.rglru_scan_ref(log_a, gx, h0)
    raise ValueError(f"rglru_scan: unsupported device {gx.device}")
