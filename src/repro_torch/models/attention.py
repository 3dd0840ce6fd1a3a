"""Attention sequence mixing: global causal, local (sliding window), cross
(the VLM's image layers) and one-token decode.

Port of `repro.models.attention`. Causal and decode attention dispatch
through their kernel's ``ops`` by the device of their tensors: a CUDA
tensor launches the hand-written kernel
(`repro_torch.kernels.flash_attention`,
`repro_torch.kernels.decode_attention`) or raises, a CPU tensor takes the
plain PyTorch version. K/V stay at KVH heads on the card (the kernels map
query head h to KV head h // G); the plain versions repeat them.

Local attention over a prompt no longer than its window is causal
attention, so the flash kernel. A longer prompt takes the reference's
chunk-pair form: window-sized query chunks against their (previous, own)
key chunks, O(S x 2W) logits, with PyTorch products, as the reference
computes it with einsums outside any Pallas kernel.

Cross attention (text queries against the image tokens' K/V, no mask) is a
grouped-query product in float32 with PyTorch ops, as the reference
computes it with einsums on every backend: q viewed as (B, KVH, G, S, D),
K/V kept at KVH heads. Neither attention kernel takes it (flash takes one
S for queries and keys; here it is S x n_img). In decode the cross layer's
one query goes through `decode_attention` against the image cache.

A decode cache whose sequence is split over the mesh's ``model`` axis
(`sharding.serve_rules` where the KV heads do not divide it:
recurrentgemma-2b's ring and granite-20b's causal cache at model = 2) is
never gathered: each rank attends with all query heads over its own
positions, and `merge_shards` combines the ranks' partial outputs by the
decode kernel's log-sum-exp (the reference's "psum over per-shard
partial softmax stats").
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.decode_attention import ops as decode_ops
from ..kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30  # the reference's mask value in the chunk-pair form


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


def local_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KVH, S, D)
    v: torch.Tensor,
    window: int,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Sliding-window causal attention (each query sees <= ``window`` keys)."""
    B, H, S, D = q.shape
    KVH = k.shape[1]
    G = H // KVH
    if scale is None:
        scale = 1.0 / (D**0.5)
    if S <= window:
        return causal_attention(q, k, v, scale=scale)
    if S % window:
        pad = (0, 0, 0, window - S % window)
        return local_attention(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), window,
                               scale=scale)[:, :, :S]
    nc = S // window
    qc = q.reshape(B, KVH, G, nc, window, D).float()
    kc = k.reshape(B, KVH, nc, window, D).float()
    vc = v.reshape(B, KVH, nc, window, D).float()
    kprev = torch.cat([torch.zeros_like(kc[:, :, :1]), kc[:, :, :-1]], dim=2)
    vprev = torch.cat([torch.zeros_like(vc[:, :, :1]), vc[:, :, :-1]], dim=2)
    kk = torch.cat([kprev, kc], dim=3)  # (B, KVH, nc, 2W, D)
    vv = torch.cat([vprev, vc], dim=3)
    logits = torch.einsum("bkgcqd,bkcod->bkgcqo", qc, kk) * scale
    ar = torch.arange(2 * window, device=q.device)
    qpos = ar[:window, None] + window
    kpos = ar[None, :]
    ok = (kpos <= qpos) & (kpos > qpos - window)
    first = kpos >= window  # chunk 0: its own keys only
    mask = torch.where((torch.arange(nc, device=q.device) == 0)[:, None, None],
                       ok[None] & first[None], ok[None])  # (nc, W, 2W)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("bkgcqo,bkcod->bkgcqd", p, vv) / p.sum(dim=-1, keepdim=True)
    return out.reshape(B, H, S, D).to(q.dtype)


def cross_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KVH, S_img, D)
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Unmasked GQA attention of S queries over S_img keys -> (B, H, S, D)
    in q's dtype; logits, softmax and products in float32."""
    B, H, S, D = q.shape
    KVH = k.shape[1]
    if scale is None:
        scale = 1.0 / (D**0.5)
    qg = q.reshape(B, KVH, H // KVH, S, D).float()
    logits = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.float()) * scale
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    return out.reshape(B, H, S, D).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, H, D)
    k_cache: torch.Tensor,  # (B, KVH, S, D)
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,)
    *,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    return decode_ops.decode_attention(q, k_cache, v_cache, lengths, scale=scale,
                                       return_lse=return_lse)


def merge_partials(o: torch.Tensor, lse: torch.Tensor, reduce_max, reduce_sum) -> torch.Tensor:
    """Softmax-weighted merge of partial attention outputs ``o`` (.., H, D)
    over disjoint position sets, each with the log-sum-exp ``lse`` (.., H)
    of its logits (-inf for an empty set, whose output is zero):
    sum_r exp(lse_r - M) o_r / sum_r exp(lse_r - M), M = max_r lse_r.
    ``reduce_max`` / ``reduce_sum`` take the max and the sum over the sets
    (all-reduces over ranks, or reductions of a stacked dim)."""
    top = reduce_max(lse)
    w = torch.exp(lse - top)
    num = reduce_sum(o.float() * w[..., None])
    return (num / reduce_sum(w)[..., None]).to(o.dtype)


def merge_shards(o: torch.Tensor, lse: torch.Tensor, comm, axis: str = "model") -> torch.Tensor:
    """`merge_partials` of the ranks' outputs along ``axis``: one max and
    two sums all-reduced."""
    return merge_partials(o, lse, lambda t: comm.all_reduce(t, axis, op="max"),
                          lambda t: comm.all_reduce(t, axis))
