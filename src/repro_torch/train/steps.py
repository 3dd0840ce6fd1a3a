"""The train step on one device (port of `repro.train.steps.build_train_step`
without its mesh and shardings): loss -> gradients -> AdamW.

Gradients come from ``torch.autograd.grad`` of `LM.loss` with respect to
detached copies of the parameters' tensors (the same storage), so the
optimizer then updates the state in place. With ``remat`` each superblock
is recomputed in the backward (`LM.hidden_states`). ``grad_accum > 1``
splits the batch's dim 0 into ``grad_accum`` microbatches, sums their
float32 gradients and losses, and divides both by ``grad_accum``, as the
reference's scan over microbatches does.
"""

from __future__ import annotations

import torch

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
        loss = lm.loss(live, batch, remat=remat)
        grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    return loss.detach().float(), tree_map(lambda t: grads[id(t)], live)


def build_train_step(lm: LM, optimizer: AdamW, *, remat: bool = True, grad_accum: int = 1):
    """``step(state, batch) -> (state, {"loss", "grad_norm", "step"})``; the
    state is updated in place and returned."""

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

        new_state = optimizer.apply(state, grads)
        metrics = {
            "loss": loss.float(),
            "grad_norm": optimizer.global_norm(grads),
            "step": new_state.step,
        }
        return new_state, metrics

    return step
