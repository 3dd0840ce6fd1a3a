"""Plain PyTorch version of the decode-attention kernel (any device).

Port of the reference's `decode_attention_ref`: the cache repeated to H
heads, float32 logits, positions at or beyond ``lengths[b]`` masked with
-inf, float32 softmax. The output has q's dtype.

With ``return_lse`` it also returns the (B, H) float32 log-sum-exp of each
row's scaled logits over its valid positions, the statistic that merges
the partial outputs of a cache whose sequence is split over ranks
(`repro_torch.models.attention.merge_partials`). A row with no valid
position then has a zero output and a log-sum-exp of -inf (without it,
0 / 0: NaN, as in the reference).
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
    return_lse: bool = False,
):  # (B, H, D), and (B, H) with return_lse
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
    if return_lse:
        m = torch.where(torch.isfinite(m), m, 0.0)  # a row with nothing valid: -inf
    e = torch.exp(logits - m)
    total = e.sum(dim=-1, keepdim=True)
    p = e / (torch.where(total > 0, total, 1.0) if return_lse else total)
    out = torch.einsum("bhs,bhsd->bhd", p, vx).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(total))[..., 0]
    return out
