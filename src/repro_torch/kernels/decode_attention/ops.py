"""Public decode-attention op: the CUDA kernel on the card, plain on CPU.

Dispatch follows q's device and nothing else: a CPU tensor takes
`ref.decode_attention_ref`, a CUDA tensor launches the kernel (or raises),
anything else raises. There is no fallback from the kernel to the plain
version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel_cuda, ref


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """(B,H,D) query vs (B,KVH,S,D) cache, (B,) valid lengths -> (B,H,D)."""
    kind = q.device.type
    if kind == "cuda":
        return kernel_cuda.decode_attention_cuda(q, k_cache, v_cache, lengths, scale=scale)
    if kind == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale)
    raise ValueError(f"decode_attention: unsupported device {q.device}")
