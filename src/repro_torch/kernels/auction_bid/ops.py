"""Public auction bidding op: the CUDA kernel on the card, plain on CPU.

Dispatch follows the value tensor's device and nothing else: a CPU tensor
takes `ref.bid_top2_ref`, a CUDA tensor launches the kernel (or raises),
anything else raises. There is no fallback from the kernel to the plain
version.
"""

from __future__ import annotations

from . import kernel_cuda, ref


def bid_top2(values, price1, price2):
    """(best_idx, best_val, second_val) per row. See ref.py for semantics."""
    kind = values.device.type
    if kind == "cuda":
        return kernel_cuda.bid_top2_cuda(values, price1, price2)
    if kind == "cpu":
        return ref.bid_top2_ref(values, price1, price2)
    raise ValueError(f"bid_top2: unsupported device {values.device}")
