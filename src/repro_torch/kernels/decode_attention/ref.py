"""Plain PyTorch version of the decode-attention kernel (any device).

Port of the reference's `decode_attention_ref`: the cache repeated to H
heads, float32 logits, positions at or beyond ``lengths[b]`` masked with
-inf, float32 softmax. The output has q's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def decode_attention_ref(
    q: torch.Tensor,  # (B, H, D) query for the new token
    k_cache: torch.Tensor,  # (B, KVH, S, D)
    v_cache: torch.Tensor,  # (B, KVH, S, D)
    lengths: torch.Tensor,  # (B,) valid cache lengths
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:  # (B, H, D)
    B, H, D = q.shape
    KVH, S = k_cache.shape[1], k_cache.shape[2]
    g = H // KVH
    if scale is None:
        scale = 1.0 / (D**0.5)
    kx = torch.repeat_interleave(k_cache, g, dim=1).float()
    vx = torch.repeat_interleave(v_cache, g, dim=1).float()
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kx) * scale
    mask = torch.arange(S, device=q.device)[None, None, :] < lengths.to(q.device)[:, None, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhs,bhsd->bhd", p, vx)
    return out.to(q.dtype)
