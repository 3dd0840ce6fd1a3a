"""Logical-axis -> mesh sharding rules (MaxText-style); port of
`repro.distributed.sharding`.

Every parameter and cache leaf carries a tuple of logical axis names
(`repro_torch.models.layers.Param.axes`). Rules map logical names to mesh
axes; a dimension whose size does not divide the mapped mesh-axis product
falls back to replication, and no mesh axis shards two dims of one leaf.

Two standard rule sets:
  train_rules - FSDP("data") on the embed dim x TP("model") on
                heads/mlp/vocab/experts + batch over (pod, data). The
                optimizer state inherits the parameter sharding.
  serve_rules - pure TP: params replicated on "data" except model-axis
                dims; batch over (pod, data); long-context caches shard
                the sequence axis over "model".

A spec is the port's counterpart of ``PartitionSpec``: a plain tuple with
one entry per leading dim (None, an axis name, or a tuple of axis names),
trailing Nones dropped, so ``tuple(P(...))`` of the reference compares
equal. `shard_index` turns a spec into one rank's slices of a leaf: a dim
over axes (a, b) splits into size(a) * size(b) pieces, a-major, as jax
lays them out.

A rank computes on its own shards: `sharded_dim` lists the dims a spec
splits (a leaf may be split over two: ``wq`` under `train_rules` is
(embed -> data, heads -> model)), `gather_leaf` rebuilds the whole leaf
(or only its ``data`` shards, for the FSDP step), and `split_on_heads`
tells block code whether a ``model`` shard holds whole heads.

``activation_ctx`` / ``constrain`` keep the reference's names. In the
reference the context is (mesh, rules) and ``constrain`` a sharding
constraint for GSPMD; here a rank computes on its local tensors, and the
context is (comm, rules): the rank's
`repro_torch.distributed.comm.Comm`, which carries the mesh. Model code
reads it where a function of the global batch needs the batch axes
(`models.blocks.moe_apply`'s groups, `models.lm.LM.loss`'s count), and
`repro_torch.distributed.tensor_parallel` where ``model`` splits the
parameters. ``constrain`` is a no-op: a tensor is already laid out as
its rank holds it. The one layout it would change, the residual
stream's ``("batch", "act_seq", "act_embed")`` under rules that map
``act_seq`` to ``model`` (Megatron-style sequence parallelism), is made
where the stream is made: `models.lm.LM` takes this rank's piece of the
sequence at the embedding when `seq_split` says so, and the blocks
gather the whole sequence where they mix positions.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Rules = Dict[str, Any]  # logical axis -> mesh axis | tuple | None
Spec = Tuple[Any, ...]

_ACT_CTX: list = []


@contextlib.contextmanager
def activation_ctx(comm, rules: Rules):
    """Run model code as one rank of ``comm``'s mesh under ``rules``."""
    _ACT_CTX.append((comm, rules))
    try:
        yield
    finally:
        _ACT_CTX.pop()


def current():
    """(comm, rules) of the innermost `activation_ctx`, or None."""
    return _ACT_CTX[-1] if _ACT_CTX else None


def constrain(x, logical: Tuple[Optional[str], ...]):
    """The reference's sharding constraint: a rank's tensor is already its
    shard, so this returns ``x``."""
    return x


def seq_split(seq_len: int) -> int:
    """Into how many pieces this rank's residual stream of ``seq_len``
    positions is cut along the sequence: the ``model`` axis's size where
    the innermost `activation_ctx`'s rules map ``act_seq`` to it and it
    divides ``seq_len`` (`spec_for`'s fallback: decode's one position
    never splits), else 1."""
    ctx = current()
    if ctx is None:
        return 1
    comm, rules = ctx
    spec = spec_for((None, "act_seq"), (1, seq_len), comm.mesh, rules)
    axes = tuple(a for _, ax in sharded_dim(spec, comm.mesh) for a in ax)
    if axes and axes != ("model",):
        raise NotImplementedError(f"act_seq over {axes}: the sequence splits over model only")
    return comm.mesh.shape["model"] if axes else 1


def train_rules(multi_pod: bool) -> Rules:
    return {
        "batch": ("pod", "data") if multi_pod else ("data",),
        "layers": None,
        "embed": ("data",),  # FSDP
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "experts": ("model",),  # EP
        "moe_cap": ("data",),  # MoE dispatch-buffer capacity dim
        "rnn": ("model",),
        "seq": None,
        "act_embed": None,
        "act_seq": None,
    }


def serve_rules(multi_pod: bool) -> Rules:
    return {
        "batch": ("pod", "data") if multi_pod else ("data",),
        "layers": None,
        "embed": None,  # pure TP at inference
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "moe_cap": ("data",),
        "rnn": ("model",),
        "seq": ("model",),  # sequence-sharded caches (GQA kv heads rarely divide)
        "act_embed": None,
        "act_seq": None,
    }


def _as_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, names) -> int:
    return int(np.prod([mesh.shape[n] for n in _as_axes(names)]))


def batch_axes(mesh, rules: Rules) -> Tuple[str, ...]:
    """The mesh axes the batch dim splits over under ``rules``."""
    return tuple(a for a in _as_axes(rules.get("batch")) if a in mesh.shape)


def spec_for(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...], mesh, rules: Rules) -> Spec:
    """The spec of one leaf, with divisibility fallback and no axis reuse."""
    entries = []
    used: set = set()
    for dim, logical in zip(shape, axes):
        mesh_axes = rules.get(logical) if logical else None
        if mesh_axes is None:
            entries.append(None)
            continue
        mesh_axes = tuple(a for a in _as_axes(mesh_axes) if a in mesh.shape and a not in used)
        if not mesh_axes or dim % axis_size(mesh, mesh_axes) != 0:
            entries.append(None)
            continue
        used.update(mesh_axes)
        entries.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _tree_map(fn, tree, *rest):
    """Over nested dicts; any other value (a tuple of axes too) is a leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_shardings(axes_tree: Any, shape_tree: Any, mesh, rules: Rules):
    """Spec tree for a params/cache tree: ``axes_tree`` leaves are axis
    tuples, ``shape_tree`` leaves anything with ``.shape`` (tensors, meta
    tensors, `Param` specs)."""
    return _tree_map(lambda axes, leaf: spec_for(tuple(axes), tuple(leaf.shape), mesh, rules),
                     axes_tree, shape_tree)


def batch_spec_tree(batch_tree: Any, mesh, rules: Rules):
    """Shard dim0 (batch) of every batch leaf, with divisibility fallback."""
    b = batch_axes(mesh, rules)

    def leaf_spec(leaf):
        if b and leaf.shape and leaf.shape[0] % axis_size(mesh, b) == 0:
            return (b if len(b) != 1 else b[0],)
        return ()

    return _tree_map(leaf_spec, batch_tree)


def cache_axes_tree(cache_tree: Any) -> Any:
    """Logical axes for decode caches, keyed by leaf name and rank:
    K/V (B, KVH, S, D) -> (batch, kv_heads, seq, None);
    rwkv S (B, H, N, N) -> (batch, heads, None, None);
    rec/rwkv vectors (B, D)/(B, C, D) -> (batch, ..., rnn/embed-like);
    a leading "layers" axis under "blocks"."""

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (str(k),)) for k, v in tree.items()}
        name, rank = path[-1], len(tree.shape)
        lead = ("layers",) if rank >= 1 and "blocks" in "/".join(path) else ()
        r = rank - len(lead)
        if name in ("k", "v"):
            return lead + ("batch", "kv_heads", "seq", None)[:r]
        if name == "S":
            return lead + ("batch", "heads", None, None)[:r]
        if name == "h":
            return lead + ("batch", "rnn")[:r]
        if name == "conv":
            return lead + ("batch", None, "rnn")[:r]
        if name in ("shift", "shift_c"):
            return lead + ("batch", "embed")[:r]
        return lead + ("batch",) + (None,) * (r - 1)

    return walk(cache_tree, ())


def shard_index(spec: Spec, shape: Tuple[int, ...], mesh, coords: Dict[str, int]):
    """The slices of a leaf of ``shape`` that the rank at ``coords`` holds."""
    index = []
    for d, dim in enumerate(shape):
        axes = _as_axes(spec[d]) if d < len(spec) else ()
        n, i = 1, 0
        for a in axes:  # a-major: the first axis is the slowest
            n, i = n * mesh.shape[a], i * mesh.shape[a] + coords[a]
        if dim % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split {n} ways")
        size = dim // n
        index.append(slice(i * size, (i + 1) * size))
    return tuple(index)


def sharded_dim(spec: Spec, mesh) -> List[Tuple[int, Tuple[str, ...]]]:
    """[(dim, axes)] of every dim ``spec`` splits over axes of size > 1, in
    dim order (empty where the leaf is whole on every rank)."""
    found = [(d, tuple(a for a in _as_axes(e) if mesh.shape[a] > 1)) for d, e in enumerate(spec)]
    return [(d, axes) for d, axes in found if axes]


def split_on_heads(local: int, unit: int) -> bool:
    """Whether a shard of ``local`` columns of a dim split over ``model``
    holds whole heads of ``unit`` columns: the shards are equal and
    contiguous, so rank r's starts at r * local, a head boundary iff
    ``local`` is a multiple of ``unit``. A shard that falls inside a head
    (recurrentgemma-2b's and granite-20b's single KV head at model = 2)
    is gathered over ``model`` where it is used."""
    return local % unit == 0


def shard_tree(tree: Any, spec_tree: Any, mesh, coords: Dict[str, int], device=None):
    """This rank's shard of every leaf of a whole tree (contiguous copies,
    on ``device``)."""
    def shard(t, spec):
        ix = shard_index(spec, tuple(t.shape), mesh, coords)
        return t[ix].to(device or t.device, copy=True).contiguous()

    return _tree_map(shard, tree, spec_tree)


def gather_leaf(t, spec: Spec, comm, *, keep: Tuple[str, ...] = (), to_first: bool = False):
    """The leaf from the ranks' shards of it (no gradient): every split dim
    all-gathered in turn, but those split over an axis in ``keep`` (the
    FSDP step gathers over ``data`` and keeps its ``model`` shard). With
    ``to_first`` the whole leaf goes to rank 0 alone (a gather): it
    returns None on every other rank."""
    dims = [(d, axes) for d, axes in sharded_dim(spec, comm.mesh)
            if not set(axes) & set(keep)]
    if to_first:
        return _gather_to_first(t.detach(), spec, dims, comm)
    for dim, axes in dims:
        t = comm.all_gather(t.detach(), axes, dim)
    return t


def _gather_to_first(t, spec, dims, comm):
    """Rank 0 assembles the whole leaf from the shards of its group over
    the leaf's split axes; a group without rank 0 has nothing to send."""
    if not dims:
        return t if comm.rank == 0 else None
    axes = tuple(a for _, ax in dims for a in ax)
    _, members = comm._group(axes)
    if 0 not in members:
        return None
    parts = comm.gather(t, axes)
    if parts is None:
        return None
    mesh = comm.mesh
    shape = list(t.shape)
    for d, ax in dims:
        shape[d] *= axis_size(mesh, ax)
    whole = torch.empty(shape, dtype=t.dtype, device=t.device)
    for member, part in zip(members, parts):
        whole[shard_index(spec, tuple(shape), mesh, mesh.coords(member))] = part
    return whole
