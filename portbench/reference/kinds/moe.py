"""An MoE layer: pre-norm grouped-query self-attention, then the
token-choice mixture of SwiGLU experts with group-local capacity (each
group's (token, choice) pairs, in token-then-choice order, fill their
expert's ``cap`` slots; the rest are dropped).

Tokens are grouped as the port groups them: the tokens of one call, in
the largest divisor up to the configuration's ``moe_groups`` (64 where
it names none) of groups of consecutive tokens. A train step's call is
the batch; serving's are the batch's prefill (``batch`` x P tokens, in
groups that must not straddle requests) and each decode step (each row's
token alone in its group).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..lm import attention_block, attention_step, mm, rms_norm


def largest_divisor_leq(n: int, cap: int) -> int:
    return next(g for g in range(min(cap, n), 0, -1) if n % g == 0)


def capacity(a: Dict[str, Any], group: int) -> int:
    K, E = a["experts_per_token"], a["n_experts"]
    return min(int(a["moe_capacity_factor"] * group * K / E) + 1, group * K)


def route(a, router_logits: torch.Tensor) -> torch.Tensor:
    """(T, K) experts of each token: the top K of the softmax, ties to the
    lower index."""
    probs = torch.softmax(router_logits, dim=-1)
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :a["experts_per_token"]]


def kept(a, choice: torch.Tensor, group: int) -> torch.Tensor:
    """(T, K) bool: which (token, choice) pairs fit their expert's capacity
    in their group of ``group`` consecutive tokens."""
    T, K = choice.shape
    E = a["n_experts"]
    flat = choice.reshape(T // group, group * K)
    onehot = F.one_hot(flat, E)
    slot = (onehot.cumsum(dim=1) - 1).gather(2, flat[..., None])[..., 0]
    return (slot < capacity(a, group)).reshape(T, K)


def moe(a, p, x: torch.Tensor, group: int, choice: Optional[torch.Tensor] = None):
    """x (T, D) -> (T, D), tokens in groups of ``group``. ``choice`` (T, K):
    experts to use in place of the reference's own top K (see `serve`).
    Returns (out, router logits, the choice used)."""
    logits = mm(x, p["router"]).float()
    if choice is None:
        choice = route(a, logits)
    gates = torch.softmax(logits, dim=-1).gather(1, choice)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    keep = kept(a, choice, group)
    out = torch.zeros_like(x)
    for e in range(a["n_experts"]):
        tok, k = torch.nonzero((choice == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(mm(xe, p["we1"][e])) * mm(xe, p["we3"][e])
        out.index_add_(0, tok, mm(h, p["we2"][e]) * gates[tok, k][:, None])
    return out, logits, choice


def _groups(ps) -> int:
    return ps.config.get("moe_groups", 64)


def prefill_group(a, ps) -> int:
    """Tokens in each group of the prefill of ``ps.batch`` x ``ps.prompt_len``
    tokens, checked not to straddle requests."""
    B, P = ps.batch, ps.prompt_len
    g_pre = B * P // largest_divisor_leq(B * P, _groups(ps))
    g_dec = B // largest_divisor_leq(B, _groups(ps))
    if P % g_pre or g_dec != 1:
        raise ValueError(f"MoE groups of {g_pre} prompt / {g_dec} decode tokens straddle "
                         f"requests (P = {P}, batch = {B})")
    return g_pre


def forward(a, p, x, ps):
    """x (B, S, D). Training (``ps.prompt_len`` None): the batch's tokens in
    one call. Serving (B = 1): the prompt's tokens grouped as the batch's
    prefill grouped them, each later position alone; the router follows
    ``ps.given`` where it is set, and records its logits and choices."""
    x = x + attention_block(a, p["attn"], rms_norm(x, p["norm_attn"], a["norm_eps"]),
                            ps.prompt_len)
    xn = rms_norm(x, p["norm_ffn"], a["norm_eps"])
    if ps.prompt_len is None:
        B, S, D = xn.shape
        T = B * S
        out, _, _ = moe(a, p["moe"], xn.reshape(T, D), T // largest_divisor_leq(T, _groups(ps)))
        return x + out.reshape(B, S, D)
    P, xn = ps.prompt_len, xn[0]
    given = next(ps.given) if ps.given is not None else None
    pre, lg_pre, ch_pre = moe(a, p["moe"], xn[:P], prefill_group(a, ps),
                              None if given is None else given[:P])
    parts, lgs, chs = [pre], [lg_pre], [ch_pre]
    if xn.shape[0] > P:
        dec, lg_dec, ch_dec = moe(a, p["moe"], xn[P:], 1, None if given is None else given[P:])
        parts.append(dec)
        lgs.append(lg_dec)
        chs.append(ch_dec)
    if ps.records is not None:
        ps.records.append((torch.cat(lgs), torch.cat(chs)))
    return x + torch.cat(parts)[None]


def step(a, p, x, pos0, state, ps):
    """The router by its own top K; its choices kept in ``state["chose"]``."""
    x = attention_step(a, p, x, pos0, state)
    xn = rms_norm(x, p["norm_ffn"], a["norm_eps"])
    out, _, ch = moe(a, p["moe"], xn[0], prefill_group(a, ps) if pos0 == 0 else 1)
    state.setdefault("chose", []).append(ch)
    return x + out[None]
