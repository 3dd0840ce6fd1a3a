"""Layer blocks for every architecture family.

Port of `repro.models.blocks`. Each kind provides:
  block_specs(kind, cfg)                       -> dict of Param specs
  cache_spec(kind, cfg, batch, s_max)          -> {name: (shape, dtype)}
  apply_block_seq(kind, cfg, p, x, pos, img)   -> (y, cache_entry)
  apply_block_decode(kind, cfg, p, x, pos, cache, lengths) -> (y, cache)

Kinds: dense (attention + FFN), local_attn (sliding-window attention +
FFN, a ring-buffer cache of the last ``local_window`` keys), cross
(tanh-gated cross-attention to the image tokens + FFN, the VLM's; cache:
the image K/V), moe (attention + a top-k token-choice mixture of experts),
rec (Griffin's RG-LRU recurrent block + FFN, cache: state ``h`` and the
temporal conv's history ``conv``) and rwkv (RWKV-6 time mix + channel mix,
cache: state ``S`` and the token shifts ``shift``, ``shift_c``).

Decode writes every cache entry IN PLACE (the reference returns new
arrays): K/V at their slot, and the recurrent kinds' states over the old
ones; the cross cache is only read. The returned dict holds the same
tensors. The reference's simplifications of the upstream models (static
token-shift ratios, the decay's LoRA only; diagonal RG-LRU gates) are kept
as they are.

On a mesh whose ``model`` axis is larger than 1
(`repro_torch.distributed.tensor_parallel.current`), each function takes
this rank's shards of its parameters and caches and computes Megatron-
style, with the same names: column-parallel ``wq/wk/wv``, ``w1/w3``,
``wx/wgate``, ``wc1`` and RWKV-6's head projections, row-parallel
``wo``, ``w2``, ``wc2``; the MoE's experts split over ``model`` (the
dispatch replicated, ``out_buf`` all-gathered along experts, the combine
local); the RG-LRU and RWKV-6 kernels on the local channels and heads.
Local counts are read from the shards' shapes. A decode cache whose
sequence is split over ``model`` (`SeqShard`) is merged across ranks by
the decode kernel's log-sum-exp, never gathered.

Under rules that map ``act_seq`` to ``model`` (training;
`sharding.seq_split`), `apply_block_seq` may get this rank's piece of
the sequence, (B, S / M, D), which it tells from the whole ``positions``.
The norms and residual adds run on the piece; every mixing layer and
MLP sees the whole sequence. Attention, the FFN, the RG-LRU block and
RWKV-6's mixes gather it as they enter their column products and
reduce-scatter it as their row products leave
(`tensor_parallel.TensorParallel.seq`; RWKV-6's token shifts then cross
the pieces' boundaries on the whole sequence, and its mix vectors and
decay LoRA, which meet it before the columns, go in by `copy`); the MoE
(whose groups, capacity and drops are the whole batch's) and any
sublayer whose leaves ``model`` does not split run whole on every rank
between `_per_piece`'s gather and split.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..distributed import sharding, tensor_parallel
from ..kernels.rglru_scan import ops as rglru_ops
from ..kernels.rwkv6_scan import ops as rwkv_ops
from . import attention
from .layers import Param, activation_fn, rms_norm, rope

RGLRU_C = 8.0  # Griffin's recurrence-gate temperature
RWKV_GN_EPS = 64e-5  # the time mix's group-norm epsilon

# --------------------------------------------------------------------------
# parameter and cache specs
# --------------------------------------------------------------------------


def _attn_specs(cfg: ArchConfig, cross: bool = False) -> Dict[str, Param]:
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
    if cross:
        s["gate"] = Param((1,), (None,), init="zeros")  # llama3.2-style tanh gate
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


def _moe_specs(cfg: ArchConfig) -> Dict[str, Param]:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = {
        "router": Param((D, E), ("embed", None)),
        "we1": Param((E, D, F), ("experts", "embed", None)),
        "we2": Param((E, F, D), ("experts", None, "embed")),
    }
    if cfg.activation == "swiglu":
        s["we3"] = Param((E, D, F), ("experts", "embed", None))
    if cfg.shared_expert:
        s["shared"] = _ffn_specs(cfg)
    return s


def _rec_specs(cfg: ArchConfig) -> Dict[str, Param]:
    D = cfg.d_model
    R = cfg.rnn_width or D
    return {
        "wx": Param((D, R), ("embed", "rnn")),
        "wgate": Param((D, R), ("embed", "rnn")),
        "conv": Param((cfg.conv_width, R), (None, "rnn"), scale=cfg.conv_width**-0.5),
        "wa_diag": Param((R,), ("rnn",), init="zeros"),
        "ba": Param((R,), ("rnn",), init="zeros"),
        "wi_diag": Param((R,), ("rnn",), init="zeros"),
        "bi": Param((R,), ("rnn",), init="zeros"),
        "lam": Param((R,), ("rnn",), init="normal", scale=1.0),
        "wo": Param((R, D), ("rnn", "embed")),
    }


def _rwkv_specs(cfg: ArchConfig) -> Dict[str, Param]:
    D, F = cfg.d_model, cfg.d_ff
    H = cfg.n_heads
    N = cfg.rwkv_head_dim
    lora = 64
    return {
        "mu": Param((5, D), (None, "embed"), init="zeros"),  # r,k,v,g,w shifts
        "wr": Param((D, D), ("embed", "heads")),
        "wk_": Param((D, D), ("embed", "heads")),
        "wv_": Param((D, D), ("embed", "heads")),
        "wg": Param((D, D), ("embed", "heads")),
        "w0": Param((D,), ("heads",), init="zeros"),
        "wA": Param((D, lora), ("embed", None)),
        "wB": Param((lora, D), (None, "heads"), init="zeros"),
        "u": Param((H, N), ("heads", None), init="zeros"),
        "ln_x": Param((D,), ("heads",), init="zeros"),
        "wo": Param((D, D), ("heads", "embed")),
        "mu_c": Param((2, D), (None, "embed"), init="zeros"),
        "wc1": Param((D, F), ("embed", "mlp")),
        "wc2": Param((F, D), ("mlp", "embed")),
        "wcr": Param((D, D), ("embed", "heads")),
    }


def block_specs(kind: str, cfg: ArchConfig) -> Dict[str, Any]:
    norm = lambda: Param((cfg.d_model,), ("embed",), init="zeros")  # noqa: E731
    if kind in ("dense", "local_attn", "cross"):
        return {"norm_attn": norm(), "attn": _attn_specs(cfg, cross=kind == "cross"),
                "norm_ffn": norm(), "ffn": _ffn_specs(cfg)}
    if kind == "moe":
        return {"norm_attn": norm(), "attn": _attn_specs(cfg), "norm_ffn": norm(),
                "moe": _moe_specs(cfg)}
    if kind == "rec":
        return {"norm_mix": norm(), "rec": _rec_specs(cfg), "norm_ffn": norm(),
                "ffn": _ffn_specs(cfg)}
    if kind == "rwkv":
        return {"norm_mix": norm(), "norm_ffn": norm(), "rwkv": _rwkv_specs(cfg)}
    raise ValueError(kind)


def cache_spec(kind: str, cfg: ArchConfig, batch: int, s_max: int):
    """Shape/dtype spec dict for one layer's decode cache."""
    if kind == "rec":
        R = cfg.rnn_width or cfg.d_model
        return {
            "h": ((batch, R), torch.float32),
            "conv": ((batch, cfg.conv_width - 1, R), torch.bfloat16),
        }
    if kind == "rwkv":
        H, N = cfg.n_heads, cfg.rwkv_head_dim
        return {
            "S": ((batch, H, N, N), torch.float32),
            "shift": ((batch, cfg.d_model), torch.bfloat16),
            "shift_c": ((batch, cfg.d_model), torch.bfloat16),
        }
    if kind in ("dense", "moe"):
        s = s_max
    elif kind == "local_attn":
        s = min(cfg.local_window, s_max)
    elif kind == "cross":
        s = cfg.n_image_tokens
    else:
        raise ValueError(kind)
    shape = (batch, cfg.n_kv_heads, s, cfg.head_dim)
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


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """Where a rank's K/V cache sits in the whole one when its KV heads do
    not split over ``model``: positions [offset, offset + local) of
    ``whole`` (offset 0 and local == whole where the cache is replicated)."""

    offset: int
    whole: int


def _kv_of_heads(h0: int, nq: int, group: int, kv0: int):
    """The K/V heads (of those computed, from head kv0 on) that query heads
    h0 .. h0 + nq - 1 read, head h reading h // group: a slice where they
    form equal groups (the attention kernels' layout), else one per query
    head."""
    first, last = h0 // group, (h0 + nq - 1) // group
    n = last - first + 1
    if nq % n == 0 and all((h0 + i) // group - first == i // (nq // n) for i in range(nq)):
        return slice(first - kv0, last - kv0 + 1)
    return [(h0 + i) // group - kv0 for i in range(nq)]


def _attn_tp(cfg, p, seq: bool = False):
    """The ``model`` axis where it splits the attention's projections."""
    return (tensor_parallel.split(p["wo"], cfg.q_dim, 0, seq)
            or tensor_parallel.split(p["wk"], cfg.kv_dim, seq=seq))


def _per_piece(fn, cfg, p, x, *args):
    """``fn``, a sublayer with its one-sequence code, on the whole sequence
    of this rank's piece ``x`` (every rank computes it whole), and this
    rank's piece of its output; the rest of a tuple (cache entries) as
    ``fn`` returns it."""
    sp = tensor_parallel.current(seq=True)
    out = fn(cfg, p, sp.whole(x), *args)
    if isinstance(out, tuple):
        return (sp.piece(out[0]),) + out[1:]
    return sp.piece(out)


def _tp_weights(tp, cfg, p, kv: bool = True):
    """(wq, first q column, wk, first kv column, wv): each this rank's shard
    where it holds whole heads, else gathered over ``model``."""
    if p["wo"].shape[0] == cfg.q_dim:
        raise NotImplementedError(
            f"{cfg.name}: q_dim {cfg.q_dim} does not split over model = {tp.size}")
    hd = cfg.head_dim
    wq, c0 = tp.whole_heads(p["wq"], cfg.q_dim, hd)
    if not kv:
        return wq, c0, None, 0, None
    wk, k0 = tp.whole_heads(p["wk"], cfg.kv_dim, hd)
    wv, _ = tp.whole_heads(p["wv"], cfg.kv_dim, hd)
    return wq, c0, wk, k0, wv


def _attn_seq_tp(tp, cfg, p, x, positions, kind, img):
    """`attn_seq` on this rank's query heads; K/V as the cache holds them
    (its KV heads where they split, else all). With ``tp.seq`` the cross
    gate meets this rank's piece of the output, and its gradient is
    summed over ``model``."""
    hd, eps = cfg.head_dim, cfg.norm_eps
    wq, c0, wk, k0, wv = _tp_weights(tp, cfg, p)
    x = tp.enter(x)
    src = img if kind == "cross" else x
    q = _split_heads(x @ wq, wq.shape[-1] // hd, hd)
    k = _split_heads(src @ wk, wk.shape[-1] // hd, hd)
    v = _split_heads(src @ wv, wv.shape[-1] // hd, hd)
    if cfg.qk_norm:
        q = rms_norm(q, tp.copy(p["q_norm"]), eps)
        if kind != "cross":
            k = rms_norm(k, tp.copy(p["k_norm"]), eps)
    if kind != "cross":
        q = rope(q, positions[:, None, :], cfg.rope_theta)
        k = rope(k, positions[:, None, :], cfg.rope_theta)
    sel = _kv_of_heads(c0 // hd, q.shape[1], cfg.n_heads // cfg.n_kv_heads, k0 // hd)
    ks, vs = k[:, sel], v[:, sel]
    if kind == "cross":
        o = attention.cross_attention(q, ks, vs)
    elif kind == "local_attn":
        o = attention.local_attention(q, ks, vs, cfg.local_window)
    else:
        o = attention.causal_attention(q, ks, vs)
    o = _merge_heads(o)
    rows = p["wo"].shape[0]
    if o.shape[-1] != rows:  # every head computed: this rank's rows of wo
        o = tp.own(o, rows)
    out = tp.row(o, p["wo"])
    if kind == "cross":
        out = torch.tanh(tp.copy(p["gate"]) if tp.seq else p["gate"]) * out
    return out, (k, v)


def _attn_decode_tp(tp, cfg, p, x, positions, kind, cache, lengths, seq: Optional[SeqShard]):
    """`attn_decode` on this rank's shards. A cache split by KV heads pairs
    with this rank's query heads; otherwise (``seq``) the rank attends with
    every query head over its positions and the ranks' outputs merge by
    their log-sum-exp where the sequence is split."""
    B, hd, eps = x.shape[0], cfg.head_dim, cfg.norm_eps
    wq, c0, wk, k0, wv = _tp_weights(tp, cfg, p, kv=kind != "cross")
    q = _split_heads(x @ wq, wq.shape[-1] // hd, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], eps)
    local, whole = cache["k"].shape[2], (seq.whole if seq else cache["k"].shape[2])
    off = seq.offset if seq else 0
    if kind == "cross":
        valid = torch.full((B,), whole, dtype=torch.int32, device=x.device)
    else:
        k = _split_heads(x @ wk, wk.shape[-1] // hd, hd)
        v = _split_heads(x @ wv, wv.shape[-1] // hd, hd)
        if cfg.qk_norm:
            k = rms_norm(k, p["k_norm"], eps)
        q = rope(q, positions[:, None, :], cfg.rope_theta)
        k = rope(k, positions[:, None, :], cfg.rope_theta)
        if kind == "local_attn":
            slot = lengths % whole
            valid = torch.clamp(lengths + 1, max=whole).to(torch.int32)
        else:
            slot, valid = lengths, (lengths + 1).to(torch.int32)
        # The new K/V go to the rank whose positions hold the slot alone.
        mine = (slot >= off) & (slot < off + local)
        at = torch.clamp(slot - off, 0, local - 1).long()
        bidx = torch.arange(B, device=x.device)
        for name, t in (("k", k), ("v", v)):
            old = cache[name][bidx, :, at]
            cache[name][bidx, :, at] = torch.where(mine[:, None, None],
                                                   t[:, :, 0].to(old.dtype), old)
    q = q[:, :, 0]
    if cache["k"].shape[1] < cfg.n_kv_heads:  # split by KV heads: this rank's
        o = attention.decode_attention(q, cache["k"], cache["v"], valid).reshape(B, 1, -1)
    else:
        if q.shape[1] < cfg.n_heads:
            q = tp.comm.all_gather(q.contiguous(), tensor_parallel.AXIS, 1)
        valid = torch.clamp(valid - off, 0, local).to(torch.int32)
        if local < whole:
            o, lse = attention.decode_attention(q, cache["k"], cache["v"], valid,
                                                return_lse=True)
            o = attention.merge_shards(o, lse, tp.comm)
        else:
            o = attention.decode_attention(q, cache["k"], cache["v"], valid)
        o = tp.own(o.reshape(B, 1, -1), p["wo"].shape[0])
    out = tp.row(o, p["wo"])
    return (torch.tanh(p["gate"]) * out if kind == "cross" else out), cache


def attn_seq(cfg, p, x, positions, kind, img=None, seq: bool = False):
    """Full-sequence attention sublayer. Returns (out, (k, v)); for cross,
    K/V are the image tokens' (no rope on either side, q_norm only) and the
    output is scaled by tanh(gate). ``seq``: ``x`` is this rank's piece of
    the sequence (as is ``out``)."""
    tp = _attn_tp(cfg, p, seq)
    if tp is not None:
        return _attn_seq_tp(tp, cfg, p, x, positions, kind, img)
    if seq:
        return _per_piece(attn_seq, cfg, p, x, positions, kind, img)
    if kind == "cross":
        q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = _split_heads(img @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
        v = _split_heads(img @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
        o = attention.cross_attention(q, k, v)
        return torch.tanh(p["gate"]) * (_merge_heads(o) @ p["wo"]), (k, v)
    q, k, v = _qkv(cfg, p, x, positions)
    if kind == "local_attn":
        o = attention.local_attention(q, k, v, cfg.local_window)
    else:
        o = attention.causal_attention(q, k, v)
    return _merge_heads(o) @ p["wo"], (k, v)


def attn_decode(cfg, p, x, positions, kind, cache, lengths, seq: Optional[SeqShard] = None):
    """One-token attention sublayer against the cache.

    The new K/V go into the cache IN PLACE at slot ``lengths[b]`` (dense,
    moe) or ``lengths[b] % w`` (local_attn's ring of w slots, valid
    ``min(lengths[b] + 1, w)``); the returned dict holds the same tensors.
    A cross layer's query attends to all of its image cache, which it
    leaves as it is. ``seq`` places a rank's cache in the whole one where
    ``model`` does not split its KV heads.
    """
    tp = _attn_tp(cfg, p)
    if tp is not None:
        return _attn_decode_tp(tp, cfg, p, x, positions, kind, cache, lengths, seq)
    B = x.shape[0]
    if kind == "cross":
        q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)[:, :, 0]
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        n_img = cache["k"].shape[2]
        full = torch.full((B,), n_img, dtype=torch.int32, device=x.device)
        o = attention.decode_attention(q, cache["k"], cache["v"], full)
        return torch.tanh(p["gate"]) * (o.reshape(B, 1, -1) @ p["wo"]), cache
    q, k, v = _qkv(cfg, p, x, positions)
    if kind == "local_attn":
        w = cache["k"].shape[2]
        slot = (lengths % w).long()
        valid = torch.clamp(lengths + 1, max=w).to(torch.int32)
    else:
        slot = lengths.long()
        valid = (lengths + 1).to(torch.int32)
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, :, slot] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][bidx, :, slot] = v[:, :, 0].to(cache["v"].dtype)
    o = attention.decode_attention(q[:, :, 0], cache["k"], cache["v"], valid)
    return o.reshape(B, 1, -1) @ p["wo"], cache


def _ring(k: torch.Tensor, window: int) -> torch.Tensor:
    """Prefill K or V (B, KVH, S, Dh) in local_attn's ring-buffer layout:
    position p at slot p % window, so decode's (length % w) overwrite stays
    consistent. Only the last ``window`` positions are kept."""
    S = k.shape[2]
    if S <= window:
        return k
    return torch.roll(k[:, :, -window:], S % window, dims=2)


# --------------------------------------------------------------------------
# FFN / MoE
# --------------------------------------------------------------------------


def ffn_apply(cfg, p, x, seq: bool = False):
    """The FFN; ``w1/w3`` column-parallel and ``w2`` row-parallel where
    ``model`` splits d_ff. ``seq``: see `attn_seq`."""
    act = activation_fn(cfg.activation)
    tp = tensor_parallel.split(p["w1"], cfg.d_ff, seq=seq)
    if tp is None and seq:
        return _per_piece(ffn_apply, cfg, p, x)
    if tp is not None:
        x = tp.enter(x)
    h = act(x @ p["w1"])
    if cfg.activation == "swiglu":
        h = h * (x @ p["w3"])
    return tp.row(h, p["w2"]) if tp is not None else h @ p["w2"]


MOE_GROUPS = 64  # dispatch groups (the reference aligns them to the data axis)


def _largest_divisor_leq(n: int, cap: int) -> int:
    for g in range(min(cap, n), 0, -1):
        if n % g == 0:
            return g
    return 1


def _moe_dispatch(cfg, router, xt):
    """Group-local dispatch: (G, Tg, D) tokens -> (G, E, cap, D) buffers.

    Per group, the Tg * K (token, choice) pairs are sorted by expert
    (stably), and each takes the next of its expert's ``cap`` slots; pairs
    past ``cap`` are dropped. Returns (buf, meta) with meta = (e_sorted,
    pos_c, keep, g_sorted, tok_sorted, order): the reference's fields
    (but its group index, a broadcast) and the sort's permutation, which
    `_moe_combine` inverts. The top K are taken from a stable descending
    sort, so that ties go to the lower expert as in ``jax.lax.top_k``.
    Indices are int64 where torch's sort, gather and scatter produce or
    take them (the values equal the reference's int32), positions int32.
    """
    G, Tg, D = xt.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    cap = min(int(cfg.moe_capacity_factor * Tg * K / E) + 1, Tg * K)

    logits = (xt @ router).float()  # (G, Tg, E)
    gate_all = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(gate_all, dim=-1, descending=True, stable=True)
    gates, experts = gates[..., :K], experts[..., :K]  # (G, Tg, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    flat_e = experts.reshape(G, Tg * K)
    flat_g = gates.reshape(G, Tg * K)
    order = torch.argsort(flat_e, dim=1, stable=True)  # group-local sort
    e_sorted = flat_e.gather(1, order)
    tok_sorted = order // K  # the pair's token: flat index t * K + k
    g_sorted = flat_g.gather(1, order)

    # Slot of each pair within its expert's run: its index minus the run's
    # first index (a running max of the runs' first indices).
    ar = torch.arange(Tg * K, dtype=torch.int32, device=xt.device).expand(G, -1)
    change = torch.ones_like(e_sorted, dtype=torch.bool)
    change[:, 1:] = e_sorted[:, 1:] != e_sorted[:, :-1]
    first_idx = torch.cummax(torch.where(change, ar, 0), dim=1).values
    pos = ar - first_idx
    keep = pos < cap
    pos_c = torch.where(keep, pos, 0)

    gathered = xt.gather(1, tok_sorted[..., None].expand(-1, -1, D))
    g_idx = torch.arange(G, device=xt.device)[:, None]
    # A kept pair is alone in its slot; a dropped one adds zeros to slot 0.
    buf = torch.zeros((G, E, cap, D), dtype=xt.dtype, device=xt.device).index_put(
        (g_idx, e_sorted, pos_c.long()), torch.where(keep[..., None], gathered, 0),
        accumulate=True)
    return buf, (e_sorted, pos_c, keep, g_sorted, tok_sorted, order)


def _moe_experts(cfg, p, buf):
    """(G, E, cap, D) -> (G, E, cap, D): each expert's FFN on its slots."""
    act = activation_fn(cfg.activation)
    h = act(torch.einsum("gecd,edf->gecf", buf, p["we1"]))
    if cfg.activation == "swiglu":
        h = h * torch.einsum("gecd,edf->gecf", buf, p["we3"])
    return torch.einsum("gecf,efd->gecd", h, p["we2"])


def _moe_combine(out_buf, meta, shape, dtype):
    """Each token's gate-weighted expert outputs, summed over its K choices.

    The reference scatter-adds the (G, Tg * K) contributions onto their
    tokens. Here they go back through the sort's inverse permutation to
    (token, choice) order and are summed over the K choices in index
    order: the same terms without atomics, so two runs on the card give
    the same bits (XLA's CPU scatter may add them in another order).
    """
    G, Tg, D = shape
    e_sorted, pos_c, keep, g_sorted, tok_sorted, order = meta
    K = e_sorted.shape[1] // Tg
    g_idx = torch.arange(G, device=out_buf.device)[:, None]
    w = torch.where(keep, g_sorted, 0.0)[..., None].to(dtype)
    contrib = out_buf[g_idx, e_sorted, pos_c.long()] * w  # (G, Tg * K, D), sorted order
    inv = torch.empty_like(order).scatter_(1, order, torch.arange(
        Tg * K, device=order.device).expand(G, -1))
    c = contrib.gather(1, inv[..., None].expand(-1, -1, D)).reshape(G, Tg, K, D)
    out = c[:, :, 0]
    for k in range(1, K):
        out = out + c[:, :, k]
    return out


def moe_apply(cfg, p, x):
    """Top-k token-choice MoE with group-local dispatch.

    The tokens of the global batch split into G = the largest divisor of
    their count up to ``MOE_GROUPS`` groups; each expert takes at most cap
    = cf * Tg * K / E (+ 1) pairs of a group (Switch-style), the rest are
    dropped. Where ``model`` splits the experts, the dispatch runs on every
    rank of it, each rank runs its experts on its slice of the buffer's
    expert dim, and the outputs are all-gathered along experts; the
    combine stays local. On one device the global batch is ``x``. On a
    rank of a mesh (under `activation_ctx`) ``x`` holds this rank's rows of it, and the
    groups stay the global batch's, as the reference's condition picks:
    where the batch axes' size d divides G, rank r's T / d tokens are
    exactly groups [r * G / d, (r + 1) * G / d) and it dispatches them
    alone (the reference's ``shard_map`` branch); otherwise groups straddle
    ranks, so the rank all-gathers the tokens over the batch axes, runs the
    global dispatch and keeps its own rows (the reference runs it on the
    global array). Taking G from the local token count instead would
    change the groups, the capacity and the drops (and so would a rank's
    piece of the sequence: `apply_block_seq` gathers it whole first, as
    the reference keeps the MoE's tokens whole along the sequence).
    """
    B, S, D = x.shape
    T_local = B * S
    ctx = sharding.current()
    comm, baxes = (ctx[0], sharding.batch_axes(ctx[0].mesh, ctx[1])) if ctx else (None, ())
    bsize = comm.axis_size(baxes) if comm is not None else 1
    T = T_local * bsize
    G = _largest_divisor_leq(T, MOE_GROUPS)
    Tg = T // G
    straddle = bsize > 1 and G % bsize != 0
    if straddle:
        xt = comm.all_gather(x.reshape(T_local, D), baxes).reshape(G, Tg, D)
    else:
        xt = x.reshape(G // bsize, Tg, D)
    buf, meta = _moe_dispatch(cfg, p["router"], xt)
    tp = tensor_parallel.split(p["we1"], cfg.n_experts, 0)
    n_local = p["we1"].shape[0]
    if tp is not None:
        mine = tp.copy(buf).narrow(1, tp.index * n_local, n_local)
        out_buf = tp.gather(_moe_experts(cfg, p, mine), 1)
    else:
        out_buf = _moe_experts(cfg, p, buf)
    out = _moe_combine(out_buf, meta, tuple(xt.shape), xt.dtype)
    out = out.reshape(-1, D)
    if straddle:
        i = comm.axis_index(baxes)
        out = out[i * T_local:(i + 1) * T_local]
    if cfg.shared_expert:
        out = out + ffn_apply(cfg, p["shared"], x.reshape(T_local, D))
    return out.reshape(B, S, D)


# --------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# --------------------------------------------------------------------------


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _rglru_gates(p, xc):
    """(log_a, gx) from the conv output xc, in float32."""
    xf = xc.float()
    r = torch.sigmoid(xf * p["wa_diag"].float() + p["ba"].float())
    i = torch.sigmoid(xf * p["wi_diag"].float() + p["bi"].float())
    log_a = -RGLRU_C * F.softplus(p["lam"].float()) * r
    return log_a, i * xf


def _conv(p, hist, n: int, width: int):
    """Depthwise temporal conv: sum_i hist[:, i : i + n] * conv[i]."""
    return sum(hist[:, i : i + n] * p["conv"][i] for i in range(width))


def _rec_tp(cfg, p, seq: bool = False):
    """The ``model`` axis where it splits the rnn channels, else None."""
    return tensor_parallel.split(p["wx"], cfg.rnn_width or cfg.d_model, seq=seq)


def rec_seq(cfg, p, x, seq: bool = False):
    """(B, S, D) -> (B, S, D) + cache entry {h, conv} (this rank's rnn
    channels where ``model`` splits them). ``seq``: see `attn_seq`; the
    conv and the scan run on the whole sequence."""
    tp = _rec_tp(cfg, p, seq)
    if tp is None and seq:
        return _per_piece(rec_seq, cfg, p, x)
    if tp is not None:
        x = tp.enter(x)
    B, S, _ = x.shape
    gate = _gelu(x @ p["wgate"])  # (B, S, R)
    xr = x @ p["wx"]  # (B, S, R)
    CW = cfg.conv_width
    pad = torch.zeros((B, CW - 1, xr.shape[-1]), dtype=xr.dtype, device=xr.device)
    xp = torch.cat([pad, xr], dim=1)  # causal: left padding
    log_a, gx = _rglru_gates(p, _conv(p, xp, S, CW))
    h, h_final = rglru_ops.rglru_scan(log_a, gx, None)
    y = gate * h.to(gate.dtype)
    out = tp.row(y, p["wo"]) if tp is not None else y @ p["wo"]
    return out, {"h": h_final, "conv": xp[:, -(CW - 1):]}


def rec_decode(cfg, p, x, cache):
    """One step of the recurrence, inline as in the reference (no kernel);
    ``h`` and ``conv`` are written into the cache in place."""
    tp = _rec_tp(cfg, p)
    gate = _gelu(x @ p["wgate"])  # (B, 1, R)
    xr = x @ p["wx"]  # (B, 1, R)
    CW = cfg.conv_width
    hist = torch.cat([cache["conv"].to(xr.dtype), xr], dim=1)  # (B, CW, R)
    log_a, gx = _rglru_gates(p, _conv(p, hist, 1, CW)[:, 0])
    h = torch.exp(log_a) * cache["h"] + torch.sqrt(-torch.expm1(2.0 * log_a)) * gx
    y = gate[:, 0] * h.to(gate.dtype)
    out = tp.row(y, p["wo"]) if tp is not None else y @ p["wo"]
    cache["h"].copy_(h)
    cache["conv"].copy_(hist[:, 1:])
    return out[:, None], cache


# --------------------------------------------------------------------------
# RWKV-6 block
# --------------------------------------------------------------------------


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros, or ``last`` for t = 0)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _rwkv_mix(mu, x, xs):
    """The r, k, v, g, w token mixes of ``x`` and its shift by ``mu`` (5, D)."""
    return tuple(x + (xs - x) * torch.sigmoid(mu[i]) for i in range(5))  # r,k,v,g,w


def _rwkv_decay(p, xw):
    raw = p["w0"].float() + torch.tanh(xw.float() @ p["wA"].float()) @ p["wB"].float()
    return torch.exp(-torch.exp(raw))  # (.., D) in (0, 1)


def _group_norm(x, scale, eps, n_groups):
    B, S, D = x.shape
    xg = x.reshape(B, S, n_groups, D // n_groups).float()
    mean = xg.mean(-1, keepdim=True)
    var = xg.var(-1, keepdim=True, correction=0)  # jnp.var: population variance
    xg = (xg - mean) * torch.rsqrt(var + eps)
    return (xg.reshape(B, S, D) * (1.0 + scale.float())).to(x.dtype)


def _rwkv_time_mix_tp(tp, cfg, p, x, last, s0, state_out):
    """`rwkv_time_mix` on this rank's heads: the projections, the decay's
    ``wB`` and ``w0``, ``u``, the scan and the group norm on them, ``wo``
    row-parallel; where the shards fall inside heads, the split leaves are
    gathered and every head computed (the state then whole). With
    ``tp.seq`` the whole sequence enters once, and the mix vectors and the
    decay's ``wA``, which meet it before the column products, go in by
    `copy`; where the shards fall inside heads it runs whole on every rank
    (`_per_piece`)."""
    N = cfg.rwkv_head_dim
    cols = p["wr"].shape[-1]
    split = sharding.split_on_heads(cols, N)
    if tp.seq and not split:
        return _per_piece(rwkv_time_mix, cfg, p, x)
    mu, wA = p["mu"], p["wA"]
    if tp.seq:
        x, mu, wA = tp.enter(x), tp.copy(mu), tp.copy(wA)
    B, S, D = x.shape
    xr, xk, xv, xg, xw = _rwkv_mix(mu, x, _shift(x, last))
    if split:
        q = {k: p[k] for k in ("wr", "wk_", "wv_", "wg", "wB", "w0", "ln_x", "u")}
    else:
        q = {k: tp.gather(p[k], -1, grad="sum") for k in ("wr", "wk_", "wv_", "wg", "wB",
                                                            "w0", "ln_x")}
        q["u"] = tp.copy(p["u"])
    H = q["wr"].shape[-1] // N

    def heads(t):
        return t.reshape(B, S, H, N).transpose(1, 2)

    r = heads(tp.column(xr, q["wr"]))
    k = heads(tp.column(xk, q["wk_"]))
    v = heads(tp.column(xv, q["wv_"]))
    g = F.silu(tp.column(xg, q["wg"]))
    lora = torch.tanh(xw.float() @ wA.float())
    w = heads(torch.exp(-torch.exp(q["w0"].float() + tp.column(lora, q["wB"].float()))))
    o, s_final = rwkv_ops.rwkv6_scan(r, k, v, w, q["u"], s0, state_out=state_out)
    o = _group_norm(o.transpose(1, 2).reshape(B, S, H * N), q["ln_x"], RWKV_GN_EPS, H)
    y = o * g
    if not split:
        y = tp.own(y, cols)
    return tp.row(y, p["wo"]), s_final


def rwkv_time_mix(cfg, p, x, last=None, s0=None, state_out=None, seq: bool = False):
    """Time mix over (B, S, D) from shift ``last`` and state ``s0`` (zeros
    when None). Returns (out, final state); with ``state_out`` the final
    state is written there (decode passes its cache's state as both).
    ``seq``: see `attn_seq`."""
    B, S, D = x.shape
    tp = tensor_parallel.split(p["wr"], D, seq=seq)
    if tp is not None:
        return _rwkv_time_mix_tp(tp, cfg, p, x, last, s0, state_out)
    if seq:
        return _per_piece(rwkv_time_mix, cfg, p, x)
    H, N = cfg.n_heads, cfg.rwkv_head_dim
    xr, xk, xv, xg, xw = _rwkv_mix(p["mu"], x, _shift(x, last))

    def heads(t):
        return t.reshape(B, S, H, N).transpose(1, 2)  # (B, H, S, N), a view

    r, k, v = heads(xr @ p["wr"]), heads(xk @ p["wk_"]), heads(xv @ p["wv_"])
    g = F.silu(xg @ p["wg"])
    w = heads(_rwkv_decay(p, xw))
    o, s_final = rwkv_ops.rwkv6_scan(r, k, v, w, p["u"], s0, state_out=state_out)
    o = _group_norm(o.transpose(1, 2).reshape(B, S, D), p["ln_x"], RWKV_GN_EPS, H)
    return (o * g) @ p["wo"], s_final


def rwkv_channel_mix(cfg, p, x, last=None, seq: bool = False):
    """Channel mix; where ``model`` splits them, ``wc1`` column-parallel,
    ``wc2`` row-parallel, and the receptance's columns (``wcr``)
    all-gathered before they gate the sum. ``seq``: see `attn_seq`; the
    whole sequence enters once, ``mu_c`` goes in by `copy`, and the
    receptance, whole, is narrowed to this rank's piece (each rank's
    cotangent of it then holds that piece alone: the gather sums them)."""
    tk = tensor_parallel.split(p["wc1"], cfg.d_ff, seq=seq)
    tr = tensor_parallel.split(p["wcr"], x.shape[-1], seq=seq)
    if seq and (tk is None or tr is None):
        return _per_piece(rwkv_channel_mix, cfg, p, x)
    mu = p["mu_c"]
    if seq:
        x, mu = tk.enter(x), tk.copy(mu)
    xs = _shift(x, last)
    xk = x + (xs - x) * torch.sigmoid(mu[0])
    xr = x + (xs - x) * torch.sigmoid(mu[1])
    if tk is not None:
        kv = tk.row(torch.square(torch.relu(tk.column(xk, p["wc1"]))), p["wc2"])
    else:
        kv = torch.square(torch.relu(xk @ p["wc1"])) @ p["wc2"]
    if tr is None:
        r = xr @ p["wcr"]
    elif seq:
        r = tr.gather(tr.column(xr, p["wcr"]), -1, grad="sum")
        r = r.narrow(1, tr.index * kv.shape[1], kv.shape[1])
    else:
        r = tr.gather(tr.column(xr, p["wcr"]), -1)
    return torch.sigmoid(r) * kv


# --------------------------------------------------------------------------
# the full block (norms + residuals + cache)
# --------------------------------------------------------------------------


def _mlp(kind, cfg, p, x, seq: bool = False):
    if kind == "moe":
        return _per_piece(moe_apply, cfg, p["moe"], x) if seq else moe_apply(cfg, p["moe"], x)
    return ffn_apply(cfg, p["ffn"], x, seq)


def apply_block_seq(kind, cfg, p, x, positions, img=None):
    """Full-sequence block. Returns (y, cache entry at the prompt's length),
    with the entries of ``cache_spec(kind)`` (K/V, for local_attn in the
    ring layout; for cross the image K/V). ``img`` (B, n_img, D) is read
    by cross blocks only. Where ``x`` is this rank's piece of the sequence
    whose ``positions`` (B, S) it gets (`sharding.seq_split`), so is ``y``,
    and the entry, which no cache then takes, is not the prompt's."""
    seq = x.shape[1] < positions.shape[1]
    if kind == "rec":
        xn = rms_norm(x, p["norm_mix"], cfg.norm_eps)
        a, entry = rec_seq(cfg, p["rec"], xn, seq)
        x = x + a
        xn = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
        return x + ffn_apply(cfg, p["ffn"], xn, seq), entry
    if kind == "rwkv":
        pr = p["rwkv"]
        xn = rms_norm(x, p["norm_mix"], cfg.norm_eps)
        a, s_final = rwkv_time_mix(cfg, pr, xn, seq=seq)
        x = x + a
        xn2 = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
        x = x + rwkv_channel_mix(cfg, pr, xn2, seq=seq)
        return x, {"S": s_final, "shift": xn[:, -1], "shift_c": xn2[:, -1]}
    if kind not in ("dense", "local_attn", "cross", "moe"):
        raise ValueError(kind)
    xn = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    a, (k, v) = attn_seq(cfg, p["attn"], xn, positions, kind, img, seq)
    x = x + a
    xn = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    x = x + _mlp(kind, cfg, p, xn, seq)
    if kind == "local_attn":
        k, v = _ring(k, cfg.local_window), _ring(v, cfg.local_window)
    return x, {"k": k, "v": v}


def apply_block_decode(kind, cfg, p, x, positions, cache, lengths,
                       seq: Optional[SeqShard] = None):
    """One-token block (x: (B, 1, D)). Returns (y, cache updated in place);
    ``seq``: see `attn_decode`."""
    if kind == "rec":
        xn = rms_norm(x, p["norm_mix"], cfg.norm_eps)
        a, cache = rec_decode(cfg, p["rec"], xn, cache)
        x = x + a
        xn = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
        return x + ffn_apply(cfg, p["ffn"], xn), cache
    if kind == "rwkv":
        # The sequence path on one token, from the cached shifts and state.
        pr = p["rwkv"]
        xn = rms_norm(x, p["norm_mix"], cfg.norm_eps)
        a, _ = rwkv_time_mix(cfg, pr, xn, cache["shift"], cache["S"], state_out=cache["S"])
        x = x + a
        xn2 = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
        x = x + rwkv_channel_mix(cfg, pr, xn2, cache["shift_c"])
        cache["shift"].copy_(xn[:, 0])
        cache["shift_c"].copy_(xn2[:, 0])
        return x, cache
    if kind not in ("dense", "local_attn", "cross", "moe"):
        raise ValueError(kind)
    xn = rms_norm(x, p["norm_attn"], cfg.norm_eps)
    a, cache = attn_decode(cfg, p["attn"], xn, positions, kind, cache, lengths, seq)
    x = x + a
    xn = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    return x + _mlp(kind, cfg, p, xn), cache
