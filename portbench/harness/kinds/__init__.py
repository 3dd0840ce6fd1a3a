"""What the harness knows of each kind of layer, one file a kind, found by
the kind's name as the pattern names it.

A configuration's layers are the port's (`LM.param_specs`): the
pattern's positions ``pos{i}_{kind}``, each stacked over the
``n_layers // len(pattern)`` superblocks under ``blocks``, then the
remainder ``rem{j}_{kind}``, the pattern's first ``n_layers %
len(pattern)`` kinds, one layer each, at the top level beside ``blocks``.
Layers run superblock by superblock, then the remainder.

``harness/kinds/<kind>.py`` holds, as arithmetic on the configuration's
``arch`` alone (nothing of the port):

- ``layout(arch)``: the layer's tensors as (path, shape, scale), without
  the layer axis, in the order the weights are drawn;
- ``product_params(arch)``: the product parameters one token meets in the
  layer (of an MoE, the experts it is routed to);
- ``attention_flops(arch, B, S, causal)``: the forward FLOPs of the
  layer's attention over S queries and S keys (0 for a kind with none;
  at B = S = 1, those of one query-key pair);
- ``decode_bytes(arch, contexts)``: the bytes one decode step moves for
  the layer: its weights (of an MoE, every expert's) and its cache's
  reads and writes, rows at ``contexts`` valid positions.

This file holds what several kinds share: the walk over the layers and
the self-attention sublayer's tensors and bytes.
"""

from __future__ import annotations

import importlib
import math
from typing import Any, Dict, List, Tuple

NORM_SCALE = 0.1  # the norms' scales, around the port's ``1 + scale``


def load(kind: str):
    """The module ``harness/kinds/<kind>.py``."""
    name = f"{__name__}.{kind}"
    try:
        if not kind.isidentifier():
            raise ModuleNotFoundError(name=name)
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no harness arithmetic for layer kind {kind!r}: add "
                         f"portbench/harness/kinds/{kind}.py") from None


def positions(arch: Dict[str, Any]) -> List[Tuple[Tuple[str, ...], str, Tuple[int, ...]]]:
    """(path of its tensors, kind, leading layer axis) of each pattern
    position, (n_superblocks,), then of each remainder layer, (), as
    `LM.param_specs` keys them."""
    pattern, L = list(arch["pattern"]), arch["n_layers"]
    out = [(("blocks", f"pos{i}_{k}"), k, (L // len(pattern),)) for i, k in enumerate(pattern)]
    return out + [((f"rem{j}_{k}",), k, ()) for j, k in enumerate(pattern[:L % len(pattern)])]


def layers(arch: Dict[str, Any]) -> List[str]:
    """The kind of each layer, in the order the layers run."""
    pattern, L = list(arch["pattern"]), arch["n_layers"]
    return pattern * (L // len(pattern)) + pattern[:L % len(pattern)]


def census(arch: Dict[str, Any]) -> List[Tuple[Any, int]]:
    """(kind's module, number of its layers) of each kind the model has."""
    kinds = layers(arch)
    return [(load(k), kinds.count(k)) for k in dict.fromkeys(kinds)]


def has(arch: Dict[str, Any], kind: str) -> bool:
    return kind in layers(arch)


def mat(path: Tuple[str, ...], shape: Tuple[int, ...]):
    """A matrix, scaled by its fan-in ** -0.5."""
    return path, shape, shape[-2] ** -0.5


def vec(path: Tuple[str, ...], n: int):
    return path, (n,), NORM_SCALE


def attention_layout(a: Dict[str, Any]) -> list:
    """The pre-norm, the self-attention's projections (and its per-head q/k
    norms), and the norm before the layer's feed-forward part."""
    D, H, KVH, hd = a["d_model"], a["n_heads"], a["n_kv_heads"], a["head_dim"]
    out = [vec(("norm_attn",), D),
           mat(("attn", "wq"), (D, H * hd)), mat(("attn", "wk"), (D, KVH * hd)),
           mat(("attn", "wv"), (D, KVH * hd)), mat(("attn", "wo"), (H * hd, D))]
    if a.get("qk_norm"):
        out += [vec(("attn", "q_norm"), hd), vec(("attn", "k_norm"), hd)]
    return out + [vec(("norm_ffn",), D)]


def weight_bytes(layout: list, itemsize: int) -> int:
    """Bytes of one layer's weights: every tensor of its layout once."""
    return itemsize * sum(math.prod(shape) for _, shape, _ in layout)


def kv_cache_bytes(a: Dict[str, Any], contexts: List[int], itemsize: int) -> int:
    """One decode step's K/V cache traffic in a layer: each row's valid
    positions read, its new K and V written."""
    return 2 * a["n_kv_heads"] * a["head_dim"] * itemsize * (sum(contexts) + len(contexts))
