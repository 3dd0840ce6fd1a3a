"""Tensor parallelism over the mesh's ``model`` axis, Megatron-style.

The reference has no such module: GSPMD partitions its computation from
the logical rules (`repro_torch.distributed.sharding.train_rules` /
``serve_rules`` put heads, kv heads, mlp, vocab, experts and rnn on
``model``) and inserts the collectives. Here each rank holds the shards
that `spec_for` gives and the block code names the collectives, through
`current()`'s `TensorParallel` (None off a mesh, or where ``model`` is 1:
then the model code is the one-device code, unchanged); `split` tells
whether ``model`` splits a given leaf. Its pieces:

- a column-parallel product: the residual stream enters the model region
  (`enter`: the identity forward, an all-reduce of the cotangent
  backward), then meets the rank's columns of the weight; its output is
  split over ``model``. `column` does both for a tensor every rank holds
  whole;
- a row-parallel product (`row`): the rank's rows of the weight against
  its columns of the input, then an all-reduce (sum) over ``model``;
- the vocab-parallel embedding lookup (`lookup`): rows outside the
  rank's vocab shard masked to zero, then an all-reduce;
- the vocab-parallel cross-entropy (`cross_entropy`: a detached max over
  ``model``, the sum of exp and the gold logit from the rank that owns
  it, each all-reduced) and greedy argmax (`argmax`: the first index of
  the largest logit, ties to the lower index as ``jnp.argmax``).

Sequence parallelism (``seq``: rules that map ``act_seq`` to ``model``,
`sharding.seq_split`): between the regions each rank holds its piece
(B, S / M, D) of the residual stream, so `enter` becomes an all-gather
along the sequence (its backward a reduce-scatter: each rank's cotangent
of the whole sequence is the part of its own columns), `row` a
reduce-scatter along the sequence (its backward an all-gather) and
`lookup` ends in a reduce-scatter. A region that keeps no shard of the
products (a block whose leaves ``model`` does not split, the MoE) takes
the whole sequence with `whole` (its backward keeps this rank's piece:
every rank computes the region whole) and leaves with `piece` (its
backward all-gathers the cotangent). The columns, attention and scans
then run on the whole sequence as before.

A replicated parameter that meets model-local activations (``q_norm``,
``k_norm``; RWKV-6's ``u`` where heads do not split) goes in by `copy`,
so that its gradient is summed over ``model`` and equal on every rank;
one that meets only replicated activations (the MoE router, RWKV-6's
``wA``) needs nothing, its inputs being the same on every rank, but
with ``seq`` where it meets the whole sequence between `enter` and the
columns (RWKV-6's mix vectors and ``wA``): that goes in by `copy`. The
stream's norms meet this rank's piece of the sequence: their gradients
are partial sums, which the train step sums over ``model``
(`repro_torch.train.steps`). Block code reads its local head, mlp, rnn
and expert counts from the shard's shape; where a ``model`` shard falls
inside a head (`sharding.split_on_heads`), `whole_heads` gathers that
leaf at use and the heads are computed whole.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import sharding

AXIS = "model"


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's view of the ``model`` axis: its `Comm`, size and index;
    ``seq``: the stream that enters and leaves the region is this rank's
    piece of the sequence (dim 1)."""

    comm: object
    size: int
    index: int
    seq: bool = False

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The residual stream into the model-parallel region: Megatron's
        copy, or with ``seq`` the whole sequence from the ranks' pieces."""
        if self.seq:
            return self.comm.all_gather(x, AXIS, 1, grad="sum")
        return self.comm.copy_to(x, AXIS)

    def copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, held whole by every rank, into the region: its cotangent
        summed over ``model``."""
        return self.comm.copy_to(t, AXIS)

    def column(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` for this rank's columns of ``w``: ``x`` whole on every
        rank, its cotangent summed over ``model`` here, or with ``seq`` at
        the region's entry (`enter`), from which ``x`` was computed."""
        return (x if self.seq else self.copy(x)) @ w

    def row(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` summed over ``model``: this rank's columns of the input
        against its rows of ``w``; with ``seq`` this rank's piece of the
        sum."""
        if self.seq:
            return self.comm.reduce_scatter(x @ w, AXIS, 1)
        return self.comm.all_reduce(x @ w, AXIS)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence of the stream from the ranks' pieces, for a
        region that every rank computes whole (the backward keeps this
        rank's piece)."""
        return self.gather(x, 1)

    def piece(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the sequence of a ``y`` that every rank
        holds whole (the backward all-gathers the cotangent)."""
        return self.comm.split(y, AXIS, 1)

    def gather(self, x: torch.Tensor, dim: int, grad: str = "slice") -> torch.Tensor:
        """The ranks' pieces of ``x`` along ``dim``; the backward keeps this
        rank's piece (an activation) or sums (``grad="sum"``: a weight)."""
        return self.comm.all_gather(x, AXIS, dim % x.dim(), grad=grad)

    def whole_heads(self, w: torch.Tensor, whole: int, unit: int,
                    dim: int = -1) -> Tuple[torch.Tensor, int]:
        """(leaf, first column held) for a leaf whose ``dim`` has ``whole``
        columns in heads of ``unit``: the shard itself where it holds whole
        heads (or the leaf is not split), else the leaf gathered over
        ``model`` (its gradient summed back to the shards)."""
        local = w.shape[dim]
        if local == whole:
            return w, 0
        if sharding.split_on_heads(local, unit):
            return w, self.index * local
        return self.gather(w, dim, grad="sum"), 0

    def own(self, x: torch.Tensor, local: int, dim: int = -1) -> torch.Tensor:
        """This rank's ``local`` columns of a tensor that holds all of them."""
        return x.narrow(dim, self.index * local, local)

    # ------------------------------------------------------------- vocab

    def lookup(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows ``tokens`` of the embedding whose rows this rank holds a
        contiguous shard of: the others' rows are zeros here, and the sum
        over ``model`` is exact (one term is not zero); with ``seq`` this
        rank's piece of the sequence of it."""
        n = table.shape[0]
        local = tokens - self.index * n
        inside = (local >= 0) & (local < n)
        rows = torch.where(inside[..., None], table[torch.where(inside, local, 0)], 0.0)
        if self.seq:
            return self.comm.reduce_scatter(rows.to(table.dtype), AXIS, 1)
        return self.comm.all_reduce(rows.to(table.dtype), AXIS)

    def cross_entropy(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """logsumexp(logits) - logits[target] per position, from this rank's
        vocab columns of float32 ``logits`` (..., V / size)."""
        n = logits.shape[-1]
        top = self.comm.all_reduce(logits.detach().amax(dim=-1), AXIS, op="max")
        sum_exp = self.comm.all_reduce(torch.exp(logits - top[..., None]).sum(dim=-1), AXIS)
        local = targets - self.index * n
        inside = (local >= 0) & (local < n)
        mine = logits.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
        gold = self.comm.all_reduce(torch.where(inside, mine, 0.0), AXIS)
        return torch.log(sum_exp) + top - gold

    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """(B,) int64 index of the largest of the (B, V) logits whose vocab
        columns are split over ``model``, the lowest index among equals."""
        n = logits.shape[-1]
        best, at = logits.max(dim=-1)  # the first index of the max
        vals = self.comm.all_gather(best.detach()[None], AXIS)  # (size, B)
        idx = self.comm.all_gather((at + self.index * n)[None], AXIS)
        rank = torch.argmax(vals, dim=0)  # the lowest rank among equals
        return idx.gather(0, rank[None])[0]


def current(seq: bool = False) -> Optional[TensorParallel]:
    """The ``model`` axis of the innermost `sharding.activation_ctx`, or
    None where there is none or it has size 1; ``seq``: the stream is
    this rank's piece of the sequence."""
    ctx = sharding.current()
    if ctx is None:
        return None
    comm = ctx[0]
    if comm.mesh.shape.get(AXIS, 1) <= 1:
        return None
    return TensorParallel(comm, comm.axis_size(AXIS), comm.axis_index(AXIS), seq)


def split(leaf: torch.Tensor, whole: int, dim: int = -1,
          seq: bool = False) -> Optional[TensorParallel]:
    """`current(seq)` where ``leaf`` is this rank's shard of its ``whole``
    entries along ``dim``, else None (no ``model`` axis, or it leaves the
    leaf whole): block code asks this, and reads its local sizes from the
    shard."""
    tp = current(seq)
    return tp if tp is not None and leaf.shape[dim] < whole else None


def vocab_whole(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """All ``vocab`` columns of logits that may hold this rank's only."""
    tp = split(logits, vocab)
    return logits if tp is None else tp.gather(logits, -1)
