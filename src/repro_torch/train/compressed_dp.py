"""Data-parallel training with int8 error-feedback gradient compression
(port of `repro.train.compressed_dp`).

Each rank computes the loss and gradients of its own rows of the global
batch, the parameters replicated (the reference's ``shard_map`` over the
data axes), and synchronises the gradients with
`repro_torch.optim.compression`: leaf by leaf, over ``pod`` first and then
``data``, with the error feedback carried per leaf in the state, as the
reference's ``sync`` loop does. Then AdamW on every rank alike. The loss
is the rank's own mean (no activation context: the reference's
``shard_map`` body sees only its shard), and the reported loss its mean
over the data axes.

Scope, as in the reference: DP only (params replicated), the cross-pod
synchronisation pattern.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models import LM
from ..models.layers import tree_map
from ..optim import AdamW, TrainState
from ..optim import compression
from ..optim.adamw import leaves
from ..distributed.comm import local_rows
from .steps import loss_and_grads


@dataclasses.dataclass
class CompressedTrainState:
    inner: TrainState
    error: Any  # error-feedback residuals, same tree as params (fp32)


def _unflatten_like(tree, values):
    it = iter(values)
    # `leaves` walks sorted keys; rebuild in that order.
    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)
    return build(tree)


def data_axes_of(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if not axes:
        raise ValueError(f"{mesh} needs a data axis")
    return axes


def build_compressed_dp_train_step(lm: LM, optimizer: AdamW, comm, *, remat: bool = False):
    """Returns (step_fn, init_fn, place) for DP training with int8 gradient
    sync on ``comm``'s mesh (the reference's ``mesh``).
    ``step_fn(state, batch) -> (state, loss)`` takes the global batch and
    updates ``state`` in place."""
    data_axes = data_axes_of(comm.mesh)

    def init_fn(params) -> CompressedTrainState:
        return CompressedTrainState(inner=optimizer.init(params),
                                    error=compression.init_error(params))

    def place(state: CompressedTrainState) -> CompressedTrainState:
        def to(t):
            return t.to(comm.device)
        inner = state.inner
        return CompressedTrainState(
            TrainState(tree_map(to, inner.params), tree_map(to, inner.mu),
                       tree_map(to, inner.nu), inner.step.to(comm.device)),
            tree_map(to, state.error))

    def step(state: CompressedTrainState, batch):
        local = local_rows(batch, comm, data_axes)
        loss, grads = loss_and_grads(lm, state.inner.params, local, remat=remat)
        gs = [g.float() for g in leaves(grads)]
        errs = list(leaves(state.error))
        for ax in data_axes:
            gs, errs = compression.compressed_all_reduce_tree(gs, errs, comm, ax)
        new_inner = optimizer.apply(state.inner, _unflatten_like(grads, gs))
        for ax in data_axes:
            n = torch.full((), float(comm.axis_size(ax)), device=loss.device)
            loss = comm.all_reduce(loss, ax) / n
        return CompressedTrainState(new_inner, _unflatten_like(state.error, errs)), loss

    return step, init_fn, place
