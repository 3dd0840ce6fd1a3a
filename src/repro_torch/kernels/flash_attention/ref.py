"""Plain PyTorch version of the flash-attention kernel (any device).

Port of the reference's `attention_ref`: K/V repeated to H heads, float32
logits and softmax, masked with -inf above the diagonal. The output has
q's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KVH, S, D)
    v: torch.Tensor,  # (B, KVH, S, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, H, S, D = q.shape
    KVH = k.shape[1]
    assert H % KVH == 0
    g = H // KVH
    if scale is None:
        scale = 1.0 / (D**0.5)
    kx = torch.repeat_interleave(k, g, dim=1).float()
    vx = torch.repeat_interleave(v, g, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx)
    return out.to(q.dtype)
