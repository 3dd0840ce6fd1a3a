"""The plain reference of the benchmark's language models, in PyTorch.

Float32 products with TF32 off, written from the equations: RMSNorm in
the ``(1 + scale)`` form, rotary embeddings on the two halves of a head,
grouped-query attention as two products and a softmax over a causal mask,
a SwiGLU FFN. Each kind of layer is a block of its own,
``reference/kinds/<kind>.py`` (`kind`), found by the name the
configuration's pattern gives it; this file walks the layers in the
port's order (`layers`) and holds the embedding, the head, the loss and
the parts that several kinds share. No kernel, no cache, no batching: a
serving sample is one request's whole sequence.
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
import dataclasses
import importlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

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


def kind(name: str):
    """The reference block of a layer kind, ``reference/kinds/<name>.py``:
    ``forward(a, p, x, ps)`` on a whole sequence x (B, S, D) and ``step(a,
    p, x, pos0, state, ps)`` on positions pos0.. over the layer's cached
    ``state`` (a dict the block keeps between calls), each returning the
    layer's output; ``ps`` is the pass's `Pass`."""
    module = f"{__package__}.kinds.{name}"
    try:
        if not name.isidentifier():
            raise ModuleNotFoundError(name=module)
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"no reference block for layer kind {name!r}: add "
                         f"portbench/reference/kinds/{name}.py") from None


def layers(a: Dict[str, Any], params: Dict[str, Any]) -> List[Tuple[Any, Dict[str, Any]]]:
    """(kind's block, tensors) of every layer in the order the port runs
    them: each superblock's pattern positions (layer l of each stacked
    ``blocks.pos{i}_{kind}``), then the remainder ``rem{j}_{kind}``."""
    pattern, L = list(a["pattern"]), a["n_layers"]

    def pick(t, l):
        return {k: pick(v, l) for k, v in t.items()} if isinstance(t, dict) else t[l]

    out = [(kind(k), pick(params["blocks"][f"pos{i}_{k}"], l))
           for l in range(L // len(pattern)) for i, k in enumerate(pattern)]
    return out + [(kind(k), params[f"rem{j}_{k}"])
                  for j, k in enumerate(pattern[:L % len(pattern)])]


@dataclasses.dataclass
class Pass:
    """What the layers of one pass share.

    ``prompt_len`` P: serving's prompt; the positions after it were decode
    steps, whose queries read K/V rounded to the cache's bfloat16 (None:
    training, every position a prompt's). ``batch``: the rows the program
    ran together, whose tokens a layer that groups tokens grouped with
    this request's. ``config``: the configuration's file, for keys a kind
    reads. ``given``: the choices a choosing layer (an MoE's router) is to
    follow in place of its own, one entry a layer in layer order (None:
    its own). ``records``: where such a layer appends (its scores, what it
    chose), one entry a layer (None: nowhere).
    """

    prompt_len: Optional[int] = None
    batch: int = 1
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    given: Optional[Iterator[torch.Tensor]] = None
    records: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None


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


def attention_step(a, p, x, pos0: int, state: Dict[str, Any]):
    """A layer's pre-norm causal self-attention and its residual, on x (1,
    S, D) at positions pos0 .. pos0 + S - 1 over the K/V that ``state``
    caches: at pos0 = 0 (the prompt) its own K/V in float32, after it the
    cache's K/V rounded to bfloat16."""
    S = x.shape[1]
    q, k, v = _qkv(a, p["attn"], rms_norm(x, p["norm_attn"], a["norm_eps"]),
                   torch.arange(pos0, pos0 + S, device=x.device))
    if pos0 == 0:
        state["kv"] = [k, v]
        o = attend(q, k, v, 0)
    else:
        state["kv"] = [torch.cat([state["kv"][0], k], 2), torch.cat([state["kv"][1], v], 2)]
        o = attend(q, *(t.to(torch.bfloat16).float() for t in state["kv"]), pos0)
    return x + mm(o.transpose(1, 2).reshape(1, S, -1), p["attn"]["wo"])


def ffn(p, x):
    return mm(F.silu(mm(x, p["w1"])) * mm(x, p["w3"]), p["w2"])


# ------------------------------------------------------------------ model


def head(a, params, h):
    w = params["embed"].T if a.get("tie_embeddings") else params["head"]
    return mm(h, w).float()


def train_loss(a, params, tokens: torch.Tensor, remat: bool = True, chunk: int = 2048,
               config: Optional[Dict[str, Any]] = None):
    """Mean next-token cross-entropy over (B, S) tokens, the last position
    of each row unscored. ``remat`` recomputes each layer and each chunk of
    the loss in the backward (memory only). ``config``: see `Pass`."""
    ps = Pass(config=config or {})
    x = params["embed"][tokens.long()]
    for block, p in layers(a, params):
        x = (checkpoint(block.forward, a, p, x, ps, use_reentrant=False) if remat
             else block.forward(a, p, x, ps))
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


def serve(a, params, tokens: torch.Tensor, prompt_len: int, batch: int,
          config: Optional[Dict[str, Any]] = None, routes: Optional[List[torch.Tensor]] = None):
    """One request as served: ``tokens`` (S,) its prompt and the served
    tokens but the last, ``prompt_len`` P, served in a batch of ``batch``
    rows. Returns (logits (S - P + 1, V) at positions P - 1 .. S - 1, and
    per choosing layer (an MoE's router) its scores (S, E) and the choices
    used (S, K), or Nones). ``routes`` (per choosing layer, (S, K)) are
    choices to use in place of the reference's own; ``config``: see
    `Pass`."""
    ps = Pass(prompt_len, batch, config or {}, None if routes is None else iter(routes), [])
    x = params["embed"][tokens.long()][None]
    for block, p in layers(a, params):
        x = block.forward(a, p, x, ps)
    h = rms_norm(x[0, prompt_len - 1:], params["final_norm"], a["norm_eps"])
    scores = [r[0] for r in ps.records] or None
    return head(a, params, h), scores, [r[1] for r in ps.records] or None


def serve_greedy(a, params, prompt: torch.Tensor, gen: int, batch: int,
                 config: Optional[Dict[str, Any]] = None):
    """The reference as the server of one request: ``gen`` greedy tokens
    after ``prompt`` (P,), one position at a time over each layer's cached
    state (K/V read rounded to bfloat16 at decode positions, as the
    configuration's cache holds them), a choosing layer by its own choice,
    the prompt's tokens grouped as `serve` groups them. Returns (tokens
    (gen,), the logits each was chosen from (gen, V), and per choosing
    layer the choices made at positions 0 .. P + gen - 2 ((P + gen - 1,
    K)), or None)."""
    P = prompt.shape[0]
    ps = Pass(P, batch, config or {})
    walk = layers(a, params)
    states: List[Dict[str, Any]] = [{} for _ in walk]

    def forward(tokens, pos0):
        x = params["embed"][tokens.long()][None]
        for (block, p), state in zip(walk, states):
            x = block.step(a, p, x, pos0, state, ps)
        return head(a, params, rms_norm(x[0, -1:], params["final_norm"], a["norm_eps"]))[0]

    logits = [forward(prompt, 0)]
    tokens = [logits[0].argmax()]
    for j in range(gen - 1):
        logits.append(forward(tokens[-1][None], P + j))
        tokens.append(logits[-1].argmax())
    chose = [torch.cat(s["chose"]) for s in states if "chose" in s]
    return torch.stack(tokens), torch.stack(logits), chose or None


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
