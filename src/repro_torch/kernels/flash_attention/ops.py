"""Public flash-attention op: the CUDA kernel on the card, plain on CPU.

Dispatch follows q's device and nothing else: a CPU tensor takes
`ref.attention_ref`, a CUDA tensor launches the kernel (or raises),
anything else raises. There is no fallback from the kernel to the plain
version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel_cuda, ref


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention: (B,H,S,D) x (B,KVH,S,D) -> (B,H,S,D) in q's dtype."""
    kind = q.device.type
    if kind == "cuda":
        return kernel_cuda.flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    if kind == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
