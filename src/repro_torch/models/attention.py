"""Attention sequence mixing: global causal and one-token decode.

Port of `repro.models.attention`. Both functions dispatch through their
kernel's ``ops`` by the device of their tensors: a CUDA tensor launches the
hand-written kernel (`repro_torch.kernels.flash_attention`,
`repro_torch.kernels.decode_attention`) or raises, a CPU tensor takes the
plain PyTorch version. K/V stay at KVH heads on the card (the kernels map
query head h to KV head h // G); the plain versions repeat them.

Local (sliding-window) and cross attention belong to block kinds that
later slices of the port bring (ROADMAP.md, module item 11).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels.decode_attention import ops as decode_ops
from ..kernels.flash_attention import ops as flash_ops


def causal_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KVH, S, D)
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return flash_ops.flash_attention(q, k, v, causal=True, scale=scale)


def local_attention(q, k, v, window: int, *, scale: Optional[float] = None):
    raise NotImplementedError(
        "local_attention (the local_attn block) is ported with the "
        "recurrentgemma-2b serving slice (ROADMAP.md, module item 11)"
    )


def cross_attention(q, k, v, *, scale: Optional[float] = None):
    raise NotImplementedError(
        "cross_attention (the cross block of the VLM) is not ported yet "
        "(ROADMAP.md, module item 11)"
    )


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, KVH, S, D)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,)
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    return decode_ops.decode_attention(q, k_cache, v_cache, lengths, scale=scale)
