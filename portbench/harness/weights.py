"""Weights from the seed, made on the device in a few large calls.

`layout` lists the model's tensors from the configuration's ``arch``
fields alone: the port's nested-dict keys and shapes (each pattern
position's tensors stacked along a leading layer axis, each remainder
layer's alone; `harness.kinds`), which the driver
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

from . import kinds

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], float]  # (path, shape, scale)

CHUNK = 1 << 28


def layout(arch: Dict[str, Any]) -> List[Leaf]:
    """(path, shape, scale) of every tensor, in a fixed order: the
    embedding, each pattern position's layers stacked, each remainder
    layer, the final norm, the head. A layer's tensors are its kind's
    (`harness/kinds/<kind>.py`)."""
    D, V = arch["d_model"], arch["vocab_size"]
    out: List[Leaf] = [(("embed",), (V, D), D ** -0.5)]
    for prefix, kind, lead in kinds.positions(arch):
        out += [(prefix + path, lead + shape, scale)
                for path, shape, scale in kinds.load(kind).layout(arch)]
    out.append((("final_norm",), (D,), kinds.NORM_SCALE))
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
