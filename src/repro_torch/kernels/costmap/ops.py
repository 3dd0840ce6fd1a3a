"""Public costmap op: the CUDA kernel on the card, the plain version on CPU.

Dispatch follows the latency tensor's device and nothing else: a CPU tensor
takes `ref.costmap_ref`, a CUDA tensor launches the kernel (or raises),
anything else raises. There is no fallback from the kernel to the plain
version.
"""

from __future__ import annotations

import torch

from . import kernel_cuda, ref


def costmap(
    lut_table: torch.Tensor,
    perf_idx: torch.Tensor,
    latency_us: torch.Tensor,
) -> torch.Tensor:
    """(T, M) int32 arc costs d_{t,m} (paper Eq. 6)."""
    kind = latency_us.device.type
    if kind == "cuda":
        return kernel_cuda.costmap_cuda(lut_table, perf_idx, latency_us)
    if kind == "cpu":
        return ref.costmap_ref(lut_table, perf_idx, latency_us)
    raise ValueError(f"costmap: unsupported device {latency_us.device}")
