"""Train and serve steps (port of `repro.train.steps`).

On one device (``comm=None``): loss -> gradients -> AdamW. Gradients come
from ``torch.autograd.grad`` of `LM.loss` with respect to detached copies
of the parameters' tensors (the same storage), so the optimizer then
updates the state in place. With ``remat`` each superblock is recomputed
in the backward (`LM.hidden_states`). ``grad_accum > 1`` splits the
batch's dim 0 into ``grad_accum`` microbatches, sums their float32
gradients and losses, and divides both by ``grad_accum``, as the
reference's scan over microbatches does.

On a mesh (``comm``: the rank's `repro_torch.distributed.comm.Comm`, the
counterpart of the reference's ``mesh``):

- storage: each rank holds only its shard of params, mu and nu, as
  `spec_for` under `train_rules` gives it (FSDP: the embed dim over
  ``data``; tensor parallelism: heads, kv heads, mlp, vocab, experts and
  rnn over ``model``); `param_shardings` / `train_state_shardings` give
  the specs without allocating anything;
- compute: the step all-gathers every leaf over ``data`` only and keeps
  its ``model`` shard, computes the loss and gradients of this rank's
  rows of the global batch under `activation_ctx` (so `LM.loss` divides
  by the global count, MoE groups are the global batch's, and the blocks
  compute on their ``model`` shards,
  `repro_torch.distributed.tensor_parallel`), and reduce-scatters the
  float32 gradients over ``data`` back to shards (all-reducing over batch
  axes a leaf is not sharded on, e.g. ``pod``). A leaf replicated over
  ``model`` gets no sync there: its gradient is the same on every rank
  of the axis (the blocks sum the partial ones of such leaves that meet
  model-local activations), but for the residual stream's norms
  (`LM.STREAM_NORMS`) where the stream was split along the sequence
  (rules that map ``act_seq`` to ``model``, `shd.seq_split`): each rank's
  is the part of its piece, and the step sums them over ``model``, once;
- optimizer: the global norm from the shards' sums of squares, each
  all-reduced over the axes its leaf is split on; AdamW elementwise on
  the shards.

The step takes the global batch, as the reference's jitted step does, and
slices this rank's rows (for ``grad_accum``: of each microbatch).

`build_decode_step` / `build_prefill_step` run `LM.decode_step` /
`LM.prefill` on this rank's rows and ``model`` shards under
`serve_rules`, first gathering any leaf that the rules split over other
axes (``embed`` on ``data``: the reference's weight-gathered serving,
which XLA gathers by itself); `repro_torch.launch.serve.serve_batch`
serves a mesh rank through them, as the reference's does.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import obs
from ..distributed import sharding as shd
from ..distributed.comm import rank_rows
from ..models import LM
from ..models.layers import tree_map
from ..optim import AdamW, TrainState
from ..optim.adamw import leaves


def loss_and_grads(lm: LM, params, batch, *, remat: bool = True):
    """(loss, gradients): the loss a detached 0-d float32 tensor, the
    gradients a dict of the parameters' keys."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    flat = list(leaves(live))
    with torch.enable_grad():
        with obs.span("lm.train.forward"):
            loss = lm.loss(live, batch, remat=remat)
        # A leaf the loss does not reach (the stacked blocks of a model
        # with no superblock) gets zeros, as jax.grad gives it.
        with obs.span("lm.train.backward"):
            grads = dict(zip(map(id, flat),
                             torch.autograd.grad(loss, flat, materialize_grads=True)))
    return loss.detach().float(), tree_map(lambda t: grads[id(t)], live)


def _stream_norms(tree):
    """``tree``'s structure, True at the residual stream's norms."""
    return {k: _stream_norms(v) if isinstance(v, dict) else k in LM.STREAM_NORMS
            for k, v in tree.items()}


def param_shardings(lm: LM, mesh, rules):
    """Spec tree of the parameters (from their `Param` specs: nothing is
    allocated)."""
    specs = lm.param_specs()
    return shd.tree_shardings(tree_map(lambda p: p.axes, specs), specs, mesh, rules)


def train_state_shardings(lm: LM, optimizer: AdamW, mesh, rules):
    """(state_shapes, state_shardings): `Param` specs and spec trees; mu and
    nu share the parameter layout (fully sharded), the step is replicated."""
    specs = lm.param_specs()
    ps = param_shardings(lm, mesh, rules)
    return TrainState(specs, specs, specs, None), TrainState(ps, ps, ps, ())


def build_train_step(lm: LM, optimizer: AdamW, comm=None, rules=None, *, remat: bool = True,
                     grad_accum: int = 1, multi_pod: Optional[bool] = None):
    """One device: ``step(state, batch) -> (state, {"loss", "grad_norm",
    "step"})``, the state updated in place and returned. On a mesh:
    ``(step, state_shardings, batch_shardings)`` as the reference returns,
    ``step`` taking this rank's shards of the state (``opt.init`` of
    `repro_torch.distributed.sharding.shard_tree` of the params) and the
    global batch."""
    if comm is None:
        return _single_device_step(lm, optimizer, remat, grad_accum)
    mesh = comm.mesh
    if multi_pod is None:
        multi_pod = "pod" in mesh.shape
    rules = rules or shd.train_rules(multi_pod)
    _, state_shardings = train_state_shardings(lm, optimizer, mesh, rules)
    specs = state_shardings.params
    baxes = shd.batch_axes(mesh, rules)

    norms = _stream_norms(specs)

    def sync(g, spec, partial):
        """The gradient of this rank's ``model`` shard summed over the batch
        ranks, reduced to this rank's shard: reduce-scatter over the
        ``data``-like axes a dim is split on, all-reduce over the other
        batch axes; over ``model`` only where it is ``partial``."""
        done = ()
        for dim, axes in shd.sharded_dim(spec, mesh):
            if "model" not in axes:
                g = comm.reduce_scatter(g, axes, dim)
                done += axes
        rest = tuple(a for a in baxes if a not in done)
        g = comm.all_reduce(g, rest) if rest else g
        return comm.all_reduce(g, "model") if partial else g

    def global_norm(grads):
        """sqrt of the leaves' sums of squares, each all-reduced over the
        axes its leaf is split on."""
        parts = {}
        for g, spec in zip(leaves(grads), leaves(specs)):
            key = tuple(a for _, axes in shd.sharded_dim(spec, mesh) for a in axes)
            parts[key] = parts.get(key, 0.0) + torch.sum(torch.square(g.float()))
        total = 0.0
        for axes, part in parts.items():
            total = total + (comm.all_reduce(part, axes) if axes else part)
        return torch.sqrt(total)

    def micro_batch(batch, i):
        n = next(iter(batch.values())).shape[0]
        per = n // grad_accum
        out = {}
        for k, v in batch.items():
            mb = v[i * per:(i + 1) * per]
            out[k] = torch.as_tensor(mb[rank_rows(per, comm, baxes)], device=comm.device)
        return out

    def step(state: TrainState, batch):
        full = tree_map(lambda t, spec: shd.gather_leaf(t, spec, comm, keep=("model",)),
                        state.params, specs)
        loss, grads = 0.0, None
        with shd.activation_ctx(comm, rules):
            seq_split = shd.seq_split(lm.seq_len(batch)) > 1
            for i in range(grad_accum):
                l, g = loss_and_grads(lm, full, micro_batch(batch, i), remat=remat)
                loss = loss + l
                grads = g if grads is None else tree_map(lambda a, b: a + b.float(), grads, g)
        del full
        if grad_accum > 1:
            # A tensor divisor: on CUDA a Python one is a reciprocal multiply.
            n = torch.tensor(float(grad_accum), device=comm.device)
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
        grads = tree_map(lambda g, spec, norm: sync(g.float(), spec, norm and seq_split),
                         grads, specs, norms)
        loss = comm.all_reduce(loss, baxes)  # each rank's share of the global mean
        with obs.span("lm.train.optimizer"):
            gnorm = global_norm(grads)
            new_state = optimizer.apply(state, grads, gnorm=gnorm)
        return new_state, {"loss": loss.float(), "grad_norm": gnorm, "step": new_state.step}

    def batch_shardings(batch_tree):
        return shd.batch_spec_tree(batch_tree, mesh, rules)

    return step, state_shardings, batch_shardings


def gather_state(state: TrainState, state_shardings: TrainState, comm,
                 device="cpu") -> Optional[TrainState]:
    """The whole state from the ranks' shards (leaves split over one dim or
    two), leaf by leaf onto ``device``, on rank 0 alone, the checkpoint's
    writer: a gather, not an all-gather; every rank takes part and the
    others get None. Each shard moves to ``device`` before the gather, so
    a host-staged gather onto the host does not take the whole leaf
    through the card."""
    def whole(tree, specs):
        return tree_map(lambda t, spec: shd.gather_leaf(t.to(device), spec, comm,
                                                        to_first=True), tree, specs)

    out = TrainState(whole(state.params, state_shardings.params),
                     whole(state.mu, state_shardings.mu), whole(state.nu, state_shardings.nu),
                     state.step.to(device))
    return out if comm.rank == 0 else None


def _single_device_step(lm: LM, optimizer: AdamW, remat: bool, grad_accum: int):
    def step(state: TrainState, batch):
        if grad_accum == 1:
            loss, grads = loss_and_grads(lm, state.params, batch, remat=remat)
        else:
            micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum) + v.shape[1:])
                     for k, v in batch.items()}
            loss = 0.0
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state.params)
            for i in range(grad_accum):
                l, g = loss_and_grads(lm, state.params, {k: v[i] for k, v in micro.items()},
                                      remat=remat)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + l
            # A tensor divisor: on CUDA a Python one is a reciprocal multiply.
            n = torch.tensor(float(grad_accum), device=loss.device)
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)

        with obs.span("lm.train.optimizer"):
            new_state = optimizer.apply(state, grads)
            gnorm = optimizer.global_norm(grads)
        return new_state, {"loss": loss.float(), "grad_norm": gnorm, "step": new_state.step}

    return step


# ----------------------------------------------------------------- serving


def _serve_rules(comm, rules, multi_pod):
    if multi_pod is None:
        multi_pod = "pod" in comm.mesh.shape
    return rules or shd.serve_rules(multi_pod)


def _gathered(params, specs, comm):
    """Each leaf all-gathered over the axes other than ``model`` that its
    spec splits (weight-gathered serving: rules that put ``embed`` on
    ``data``, as the dry run's for the largest models), in the whole
    leaf's layout, so its products round as one device's; under
    `serve_rules` no leaf is split there and each is returned as it is."""
    return tree_map(lambda t, spec: shd.gather_leaf(t, spec, comm, keep=("model",)).contiguous(),
                    params, specs)


def build_decode_step(lm: LM, comm, rules=None, *, multi_pod: Optional[bool] = None):
    """Returns (step, shardings dict): ``step(params, batch, cache,
    lengths, s_max=None)`` is `LM.decode_step` on this rank's rows and
    shards (cache written in place; ``s_max`` places a sequence-split
    cache, `LM.decode_step`)."""
    rules = _serve_rules(comm, rules, multi_pod)
    mesh = comm.mesh
    specs = param_shardings(lm, mesh, rules)

    def serve_step(params, batch, cache, lengths, s_max=None):
        params = _gathered(params, specs, comm)
        with shd.activation_ctx(comm, rules):
            return lm.decode_step(params, batch, cache, lengths, s_max=s_max)

    def cache_shardings(cache_tree):
        return shd.tree_shardings(shd.cache_axes_tree(cache_tree), cache_tree, mesh, rules)

    return serve_step, {
        "params": specs,
        "cache": cache_shardings,
        "batch": lambda tree: shd.batch_spec_tree(tree, mesh, rules),
        "rules": rules,
    }


def build_prefill_step(lm: LM, comm, rules=None, *, s_max: int, batch_size: int,
                       multi_pod: Optional[bool] = None):
    """Returns (step, shardings dict): ``step(params, batch)`` is
    `LM.prefill` on this rank's rows; ``batch_size`` is the global one."""
    rules = _serve_rules(comm, rules, multi_pod)
    mesh = comm.mesh
    specs = param_shardings(lm, mesh, rules)

    def prefill_step(params, batch):
        params = _gathered(params, specs, comm)
        with shd.activation_ctx(comm, rules):
            return lm.prefill(params, batch, s_max=s_max)

    cache_tree = lm.cache_spec_tree(batch_size, s_max)
    return prefill_step, {
        "params": specs,
        "cache": shd.tree_shardings(shd.cache_axes_tree(cache_tree), cache_tree, mesh, rules),
        "batch": lambda tree: shd.batch_spec_tree(tree, mesh, rules),
        "rules": rules,
    }
