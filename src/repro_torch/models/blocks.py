"""Layer blocks: the ``dense`` kind (attention + FFN).

Port of the dense path of `repro.models.blocks`. The block provides:
  block_specs(kind, cfg)                       -> dict of Param specs
  apply_block_seq(kind, cfg, p, x, pos)        -> (y, cache_entry)
  apply_block_decode(kind, cfg, p, x, pos, cache, lengths) -> (y, cache)

The other kinds raise NotImplementedError naming the slice of the port that
brings them (ROADMAP.md, module item 11).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from . import attention
from .layers import Param, activation_fn, rms_norm, rope

_NOT_PORTED = {
    "rec": "the recurrentgemma-2b serving slice",
    "local_attn": "the recurrentgemma-2b serving slice",
    "rwkv": "the rwkv6-7b serving slice",
    "moe": "the MoE serving slice",
    "cross": "the VLM serving slice",
}


def _check_kind(kind: str) -> None:
    if kind == "dense":
        return
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet: it comes with "
            f"{_NOT_PORTED[kind]} (ROADMAP.md, module item 11)"
        )
    raise ValueError(kind)


# --------------------------------------------------------------------------
# parameter and cache specs
# --------------------------------------------------------------------------


def _attn_specs(cfg: ArchConfig) -> Dict[str, Param]:
    D = cfg.d_model
    s: Dict[str, Param] = {
        "wq": Param((D, cfg.q_dim), ("embed", "heads")),
        "wk": Param((D, cfg.kv_dim), ("embed", "kv_heads")),
        "wv": Param((D, cfg.kv_dim), ("embed", "kv_heads")),
        "wo": Param((cfg.q_dim, D), ("heads", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = Param((cfg.head_dim,), (None,), init="zeros")
        s["k_norm"] = Param((cfg.head_dim,), (None,), init="zeros")
    return s


def _ffn_specs(cfg: ArchConfig) -> Dict[str, Param]:
    D, F = cfg.d_model, cfg.d_ff
    s = {
        "w1": Param((D, F), ("embed", "mlp")),
        "w2": Param((F, D), ("mlp", "embed")),
    }
    if cfg.activation == "swiglu":
        s["w3"] = Param((D, F), ("embed", "mlp"))
    return s


def block_specs(kind: str, cfg: ArchConfig) -> Dict[str, Any]:
    _check_kind(kind)
    norm = lambda: Param((cfg.d_model,), ("embed",), init="zeros")  # noqa: E731
    return {
        "norm_attn": norm(),
        "attn": _attn_specs(cfg),
        "norm_ffn": norm(),
        "ffn": _ffn_specs(cfg),
    }


def cache_spec(kind: str, cfg: ArchConfig, batch: int, s_max: int):
    """Shape/dtype spec dict for one layer's decode cache."""
    _check_kind(kind)
    shape = (batch, cfg.n_kv_heads, s_max, cfg.head_dim)
    return {"k": (shape, torch.bfloat16), "v": (shape, torch.bfloat16)}


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def _split_heads(x, n, d):
    B, S = x.shape[:2]
    return x.reshape(B, S, n, d).transpose(1, 2)  # (B, n, S, d), a view


def _merge_heads(x):
    B, n, S, d = x.shape
    return x.transpose(1, 2).reshape(B, S, n * d)


def _qkv(cfg, p, x, positions, *, rope_on=True):
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(x @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(x @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope_on:
        q = rope(q, positions[:, None, :], cfg.rope_theta)
        k = rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def attn_seq(cfg, p, x, positions, kind):
    """Full-sequence attention sublayer. Returns (out, (k, v))."""
    _check_kind(kind)
    q, k, v = _qkv(cfg, p, x, positions)
    o = attention.causal_attention(q, k, v)
    return _merge_heads(o) @ p["wo"], (k, v)


def attn_decode(cfg, p, x, positions, kind, cache, lengths):
    """One-token attention sublayer against the cache.

    The new K/V go into the cache at slot ``lengths[b]`` IN PLACE (the
    reference returns an updated copy); the returned dict holds the same
    tensors.
    """
    _check_kind(kind)
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x, positions)
    slot = lengths.long()
    valid = (lengths + 1).to(torch.int32)
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, :, slot] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][bidx, :, slot] = v[:, :, 0].to(cache["v"].dtype)
    o = attention.decode_attention(q[:, :, 0], cache["k"], cache["v"], valid)
    return o.reshape(B, 1, -1) @ p["wo"], cache


# --------------------------------------------------------------------------
# FFN and the full block (norms + residuals)
# --------------------------------------------------------------------------


def ffn_apply(cfg, p, x):
    act = activation_fn(cfg.activation)
    h = act(x @ p["w1"])
    if cfg.activation == "swiglu":
        h = h * (x @ p["w3"])
    return h @ p["w2"]


def apply_block_seq(kind, cfg, p, x, positions):
    """Full-sequence block. Returns (y, {"k", "v"} at the prompt's length)."""
    _check_kind(kind)
    xn = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    a, (k, v) = attn_seq(cfg, p["attn"], xn, positions, kind)
    x = x + a
    xn = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    x = x + ffn_apply(cfg, p["ffn"], xn)
    return x, {"k": k, "v": v}


def apply_block_decode(kind, cfg, p, x, positions, cache, lengths):
    """One-token block (x: (B, 1, D)). Returns (y, cache updated in place)."""
    _check_kind(kind)
    xn = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    a, new_cache = attn_decode(cfg, p["attn"], xn, positions, kind, cache, lengths)
    x = x + a
    xn = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    x = x + ffn_apply(cfg, p["ffn"], xn)
    return x, new_cache
