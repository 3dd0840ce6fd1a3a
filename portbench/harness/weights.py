"""Weights from the seed, made on the device in a few large calls.

`layout` lists the model's tensors from the configuration's ``arch``
fields alone: the port's nested-dict keys and shapes (each pattern
position's tensors stacked along a leading layer axis), which the driver
holds equal to the port's own `param_specs` before it hands the tensors
over. `make` fills one flat buffer with normal draws of a generator on
the device, a chunk of 2**28 at a time, and scales each tensor's view in
place: matrices by their fan-in**-0.5 (the embedding by d_model**-0.5),
vectors (the norms' scales, around the port's ``1 + scale``) by 0.1. The
same seed gives the same weights on any device of one kind.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], float]  # (path, shape, scale)

CHUNK = 1 << 28
NORM_SCALE = 0.1


def layout(arch: Dict[str, Any]) -> List[Leaf]:
    """(path, shape, scale) of every tensor, in a fixed order."""
    D, V, L = arch["d_model"], arch["vocab_size"], arch["n_layers"]
    H, KVH, hd, F = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"], arch["d_ff"]
    (kind,) = arch["pattern"]
    pos = ("blocks", f"pos0_{kind}")
    out: List[Leaf] = [(("embed",), (V, D), D ** -0.5)]

    def mat(path, shape):
        out.append((pos + path, (L,) + shape, shape[-2] ** -0.5))

    def vec(path, n):
        out.append((pos + path, (L, n), NORM_SCALE))

    vec(("norm_attn",), D)
    mat(("attn", "wq"), (D, H * hd))
    mat(("attn", "wk"), (D, KVH * hd))
    mat(("attn", "wv"), (D, KVH * hd))
    mat(("attn", "wo"), (H * hd, D))
    if arch.get("qk_norm"):
        vec(("attn", "q_norm"), hd)
        vec(("attn", "k_norm"), hd)
    vec(("norm_ffn",), D)
    if kind == "dense":
        mat(("ffn", "w1"), (D, F))
        mat(("ffn", "w2"), (F, D))
        mat(("ffn", "w3"), (D, F))
    elif kind == "moe":
        E = arch["n_experts"]
        mat(("moe", "router"), (D, E))
        mat(("moe", "we1"), (E, D, F))
        mat(("moe", "we2"), (E, F, D))
        mat(("moe", "we3"), (E, D, F))
    else:
        raise ValueError(f"no weight layout for layer kind {kind!r}")
    out.append((("final_norm",), (D,), NORM_SCALE))
    if not arch.get("tie_embeddings"):
        out.append((("head",), (D, V), D ** -0.5))
    return out


def numel(arch: Dict[str, Any]) -> int:
    return sum(math.prod(shape) for _, shape, _ in layout(arch))


def put(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def make(arch: Dict[str, Any], seed: int, device, dtype=torch.float32) -> Dict[str, Any]:
    """The nested dict of weights, views of one flat buffer."""
    flat = torch.empty(numel(arch), dtype=dtype, device=device)
    gen = torch.Generator(device=flat.device)
    gen.manual_seed(int(seed))
    for i in range(0, flat.numel(), CHUNK):
        flat[i:i + CHUNK].normal_(generator=gen)
    tree: Dict[str, Any] = {}
    off = 0
    for path, shape, scale in layout(arch):
        n = math.prod(shape)
        view = flat[off:off + n].view(shape)
        view.mul_(scale)
        put(tree, path, view)
        off += n
    return tree


def shapes(tree) -> Dict[str, Any]:
    """The tree's structure with each tensor's shape."""
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)
