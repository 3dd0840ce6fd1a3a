"""The plain reference of the benchmark's language models, in PyTorch.

Float32 products with TF32 off, written from the equations: RMSNorm in
the ``(1 + scale)`` form, rotary embeddings on the two halves of a head,
grouped-query attention as two products and a softmax over a causal mask,
a SwiGLU FFN, and the token-choice mixture of experts with group-local
capacity (each group's (token, choice) pairs, in token-then-choice order,
fill their expert's ``cap`` slots; the rest are dropped). No kernel, no
cache, no batching: a serving sample is one request's whole sequence.
The configuration's bfloat16 decode cache is the one departure from a
float32 forward that the reference reproduces: queries at decode positions
attend to keys and values rounded to bfloat16, as the cache holds them;
the prompt's own positions attend in float32, as the prefill does.

`precision("tf32")` is the control: the same code with its products in
TF32 (on the card through cuBLAS; on the CPU by rounding each operand to
TF32's 10-bit mantissa, round to nearest).

Nothing here imports the program or anything of the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_ROUND_TF32 = False


@contextlib.contextmanager
def precision(mode: str):
    """"f32" (TF32 off) or "tf32" (the control) for the products inside."""
    global _ROUND_TF32
    if mode not in ("f32", "tf32"):
        raise ValueError(mode)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             _ROUND_TF32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _ROUND_TF32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         _ROUND_TF32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits), ties away."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """a @ b with every product's operands rounded to TF32, the backward's
    products too (as cuBLAS computes both in TF32)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).transpose(-1, -2), round_tf32(a).transpose(-1, -2) @ g


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _ROUND_TF32 and a.device.type == "cpu":
        if a.dim() > 2 and b.dim() == 2:  # a batch of rows times one matrix
            return _TF32Product.apply(a.reshape(-1, a.shape[-1]), b).reshape(
                *a.shape[:-1], b.shape[-1])
        return _TF32Product.apply(a, b)
    return a @ b


def rms_norm(x, scale, eps):
    xf = x.float()
    return xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def rope(x, positions, theta):
    """x (.., S, D) at positions (S,)."""
    half = x.shape[-1] // 2
    freq = torch.from_numpy(np.asarray(theta ** (-np.arange(0, half, dtype=np.float32) / half),
                                       np.float32)).to(x.device)
    ang = positions[:, None].float() * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, q_offset: int):
    """q (B, H, Sq, D) at positions q_offset.. over k, v (B, KVH, Sk, D) at
    0..Sk-1, causal."""
    B, H, Sq, D = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = mm(q, k.transpose(-1, -2)) * (1.0 / D ** 0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    s = s.masked_fill(kpos > qpos, float("-inf"))
    return mm(torch.softmax(s, dim=-1), v)


def layer_params(params: Dict[str, Any], l: int) -> Dict[str, Any]:
    """Layer ``l``'s tensors out of the stacked blocks."""
    (block,) = params["blocks"].values()

    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) else t[l]

    return pick(block)


def _qkv(a, p, x, positions):
    B, S, _ = x.shape
    hd = a["head_dim"]
    q = mm(x, p["wq"]).reshape(B, S, a["n_heads"], hd).transpose(1, 2)
    k = mm(x, p["wk"]).reshape(B, S, a["n_kv_heads"], hd).transpose(1, 2)
    v = mm(x, p["wv"]).reshape(B, S, a["n_kv_heads"], hd).transpose(1, 2)
    if a.get("qk_norm"):
        q = rms_norm(q, p["q_norm"], a["norm_eps"])
        k = rms_norm(k, p["k_norm"], a["norm_eps"])
    return rope(q, positions, a["rope_theta"]), rope(k, positions, a["rope_theta"]), v


def attention_block(a, p, x, prompt_len: Optional[int] = None):
    """Causal self-attention over x (B, S, D). With ``prompt_len`` P, the
    queries at positions >= P read K/V rounded to the cache's bfloat16."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(a, p, x, positions)
    if prompt_len is None or prompt_len >= S:
        o = attend(q, k, v, 0)
    else:
        P = prompt_len
        kb, vb = (t.to(torch.bfloat16).float() for t in (k, v))
        o = torch.cat([attend(q[:, :, :P], k[:, :, :P], v[:, :, :P], 0),
                       attend(q[:, :, P:], kb, vb, P)], dim=2)
    return mm(o.transpose(1, 2).reshape(B, S, -1), p["wo"])


def ffn(p, x):
    return mm(F.silu(mm(x, p["w1"])) * mm(x, p["w3"]), p["w2"])


# ------------------------------------------------------------------ MoE


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


# ------------------------------------------------------------------ model


def _block(a, p, x, prompt_len=None):
    """A dense block on x (B, S, D)."""
    x = x + attention_block(a, p["attn"], rms_norm(x, p["norm_attn"], a["norm_eps"]), prompt_len)
    return x + ffn(p["ffn"], rms_norm(x, p["norm_ffn"], a["norm_eps"]))


def head(a, params, h):
    w = params["embed"].T if a.get("tie_embeddings") else params["head"]
    return mm(h, w).float()


def train_loss(a, params, tokens: torch.Tensor, remat: bool = True, chunk: int = 2048):
    """Mean next-token cross-entropy of a dense model over (B, S) tokens,
    the last position of each row unscored. ``remat`` recomputes each layer
    and each chunk of the loss in the backward (memory only)."""
    x = params["embed"][tokens.long()]
    for l in range(a["n_layers"]):
        p = layer_params(params, l)
        x = checkpoint(_block, a, p, x, use_reentrant=False) if remat else _block(a, p, x)
    h = rms_norm(x, params["final_norm"], a["norm_eps"])
    B, S, _ = h.shape
    tgt = tokens[:, 1:].long()

    def ce(hc, tc):
        return F.cross_entropy(head(a, params, hc).reshape(-1, a["vocab_size"]), tc.reshape(-1),
                               reduction="sum")

    total = 0.0
    for c in range(0, S - 1, chunk):
        e = min(c + chunk, S - 1)
        part = (checkpoint(ce, h[:, c:e], tgt[:, c:e], use_reentrant=False) if remat
                else ce(h[:, c:e], tgt[:, c:e]))
        total = total + part
    return total / (B * (S - 1))


def _prefill_group(a, batch: int, prompt_len: int, moe_groups: int) -> int:
    """Tokens in each MoE group of a prefill of ``batch`` x ``prompt_len``
    tokens (the largest divisor up to ``moe_groups`` of groups of
    consecutive tokens), checked not to straddle requests."""
    P = prompt_len
    g_pre = batch * P // largest_divisor_leq(batch * P, moe_groups)
    g_dec = batch // largest_divisor_leq(batch, moe_groups)
    if tuple(a["pattern"]) == ("moe",) and (P % g_pre or g_dec != 1):
        raise ValueError(f"MoE groups of {g_pre} prompt / {g_dec} decode tokens straddle "
                         f"requests (P = {P}, batch = {batch})")
    return g_pre


def serve(a, params, tokens: torch.Tensor, prompt_len: int, batch: int, moe_groups: int = 64,
          routes: Optional[List[torch.Tensor]] = None):
    """One request as served: ``tokens`` (S,) its prompt and the served
    tokens but the last, ``prompt_len`` P, served in a batch of ``batch``
    rows. Returns (logits (S - P + 1, V) at positions P - 1 .. S - 1, the
    router logits (layer list of (S, E)) and choices used, or Nones).

    An MoE layer groups the prompt's tokens as the batch's prefill did
    (``batch`` x P tokens in the largest divisor up to ``moe_groups`` of
    groups of consecutive tokens, which must not straddle requests) and
    each decode position with the other rows of its step. ``routes`` (per
    layer, (S, K)) are experts to use in place of the reference's own top K.
    """
    S, P = tokens.shape[0], prompt_len
    moe_layer = tuple(a["pattern"]) == ("moe",)
    g_pre = _prefill_group(a, batch, P, moe_groups)
    x = params["embed"][tokens.long()][None]
    router_logits, choices = [], []
    for l in range(a["n_layers"]):
        p = layer_params(params, l)
        if not moe_layer:
            x = _block(a, p, x, P)
            continue
        x = x + attention_block(a, p["attn"], rms_norm(x, p["norm_attn"], a["norm_eps"]), P)
        xn = rms_norm(x, p["norm_ffn"], a["norm_eps"])[0]
        given = routes[l] if routes is not None else None
        pre, lg_pre, ch_pre = moe(a, p["moe"], xn[:P], g_pre,
                                  None if given is None else given[:P])
        parts, lgs, chs = [pre], [lg_pre], [ch_pre]
        if S > P:
            dec, lg_dec, ch_dec = moe(a, p["moe"], xn[P:], 1,
                                      None if given is None else given[P:])
            parts.append(dec)
            lgs.append(lg_dec)
            chs.append(ch_dec)
        x = x + torch.cat(parts)[None]
        router_logits.append(torch.cat(lgs))
        choices.append(torch.cat(chs))
    h = rms_norm(x[0, P - 1:], params["final_norm"], a["norm_eps"])
    return head(a, params, h), (router_logits or None), (choices or None)


def serve_greedy(a, params, prompt: torch.Tensor, gen: int, batch: int, moe_groups: int = 64):
    """The reference as the server of one request: ``gen`` greedy tokens
    after ``prompt`` (P,), one position at a time over a cache of the K/V
    (read rounded to bfloat16 at decode positions, as the configuration's
    cache holds them), an MoE layer routing by its own top K, its prompt
    grouped as `serve` groups it. Returns (tokens (gen,), the logits each
    was chosen from (gen, V), and per layer the experts used at positions
    0 .. P + gen - 2 ((P + gen - 1, K)), or None)."""
    P, L, eps = prompt.shape[0], a["n_layers"], a["norm_eps"]
    moe_layer = tuple(a["pattern"]) == ("moe",)
    g_pre = _prefill_group(a, batch, P, moe_groups)
    kv: List[List[torch.Tensor]] = []
    choices: List[List[torch.Tensor]] = [[] for _ in range(L)]

    def layer(l, x, pos0):
        p = layer_params(params, l)
        S = x.shape[1]
        q, k, v = _qkv(a, p["attn"], rms_norm(x, p["norm_attn"], eps),
                       torch.arange(pos0, pos0 + S, device=x.device))
        if pos0 == 0:
            kv.append([k, v])
            o = attend(q, k, v, 0)
        else:
            kv[l] = [torch.cat([kv[l][0], k], 2), torch.cat([kv[l][1], v], 2)]
            o = attend(q, *(t.to(torch.bfloat16).float() for t in kv[l]), pos0)
        x = x + mm(o.transpose(1, 2).reshape(1, S, -1), p["attn"]["wo"])
        xn = rms_norm(x, p["norm_ffn"], eps)
        if not moe_layer:
            return x + ffn(p["ffn"], xn)
        out, _, ch = moe(a, p["moe"], xn[0], g_pre if pos0 == 0 else 1)
        choices[l].append(ch)
        return x + out[None]

    def forward(tokens, pos0):
        x = params["embed"][tokens.long()][None]
        for l in range(L):
            x = layer(l, x, pos0)
        return head(a, params, rms_norm(x[0, -1:], params["final_norm"], eps))[0]

    logits = [forward(prompt, 0)]
    tokens = [logits[0].argmax()]
    for j in range(gen - 1):
        logits.append(forward(tokens[-1][None], P + j))
        tokens.append(logits[-1].argmax())
    return (torch.stack(tokens), torch.stack(logits),
            [torch.cat(c) for c in choices] if moe_layer else None)


# ------------------------------------------------------------------ AdamW


def adamw_step(params_leaves: List[torch.Tensor], grads: List[torch.Tensor],
               mu: List[torch.Tensor], nu: List[torch.Tensor], step: int,
               opt: Dict[str, Any]) -> None:
    """AdamW with decoupled decay on leaves of two or more dimensions,
    clipped to the global gradient norm ``grad_clip_norm``, bias-corrected,
    in place."""
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    scale = torch.clamp(opt["grad_clip_norm"] / (gnorm + 1e-9), max=1.0)
    b1, b2 = opt["b1"], opt["b2"]
    b1c = 1.0 - b1 ** step
    b2c = 1.0 - b2 ** step
    with torch.no_grad():
        for p, g, m, n in zip(params_leaves, grads, mu, nu):
            g = g.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            n.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / b1c) / (torch.sqrt(n / b2c) + opt["eps"])
            if p.dim() >= 2:
                delta = delta + opt["weight_decay"] * p
            p.sub_(opt["lr"] * delta)


def leaves(tree) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, tensor) of a nested dict, keys sorted."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out.append((path, t))

    walk(tree, ())
    return out
