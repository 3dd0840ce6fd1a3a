"""AdamW with decoupled weight decay, float32 optimizer state and global-norm
gradient clipping (port of `repro.optim.adamw` on one device).

Parameters, moments and gradients are nested dicts of tensors with the
parameters' keys. `AdamW.apply` updates the state IN PLACE under
``torch.no_grad()`` (the reference donates it) and returns it; the
arithmetic keeps the reference's order: the clip scale, the bias
corrections in float32, mu, nu, ``mhat / (sqrt(nhat) + eps)``, decay for
leaves of two or more dimensions only, and a cast back to each
parameter's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..models.layers import tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: Optional[float] = 1.0


@dataclasses.dataclass
class TrainState:
    """(params, mu, nu, step); flattened for checkpoints in that order,
    as the reference's registered pytree is."""

    params: Any
    mu: Any
    nu: Any
    step: torch.Tensor  # int32, 0-d


def leaves(tree):
    """A nested dict's leaves in the reference's (jax's) order: sorted keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


class AdamW:
    def __init__(self, cfg: AdamWConfig, schedule: Optional[Callable] = None):
        self.cfg = cfg
        self.schedule = schedule or (lambda step: cfg.lr)

    def init(self, params) -> TrainState:
        def zeros32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        step = torch.zeros((), dtype=torch.int32, device=next(leaves(params)).device)
        return TrainState(params=params, mu=tree_map(zeros32, params),
                          nu=tree_map(zeros32, params), step=step)

    def global_norm(self, grads) -> torch.Tensor:
        return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(grads)))

    @torch.no_grad()
    def apply(self, state: TrainState, grads, gnorm: Optional[torch.Tensor] = None) -> TrainState:
        """``gnorm``: the gradients' global norm where ``grads`` are shards
        of them (a sharded train step computes it across its ranks)."""
        cfg = self.cfg
        step = state.step + 1
        lr = self.schedule(step)

        if gnorm is None:
            gnorm = self.global_norm(grads)
        if cfg.grad_clip_norm is not None:
            # A true division: ``float / tensor`` would multiply by a reciprocal.
            clip = torch.full_like(gnorm, cfg.grad_clip_norm)
            scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
        else:
            scale = 1.0

        b1c = 1.0 - cfg.b1 ** step.float()
        b2c = 1.0 - cfg.b2 ** step.float()

        def upd(p, g, mu, nu):
            g = g.float() * scale
            mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
            nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g * g)
            mhat = mu / b1c
            nhat = nu / b2c
            delta = mhat / (torch.sqrt(nhat) + cfg.eps)
            if p.dim() >= 2:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)

        tree_map(upd, state.params, grads, state.mu, state.nu)
        state.step = step
        return state
