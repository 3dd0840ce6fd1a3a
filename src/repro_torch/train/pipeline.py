"""Pipeline parallelism over the pod axis (GPipe schedule); port of
`repro.train.pipeline`.

Layers are partitioned across the ranks of the ``pod`` axis (the stacked
superblock axis splits over it; `stage_params`), and microbatches stream
through the stages with `Comm.ring_permute`. Cross-pod links are the
slowest in the fabric, and PP sends only activations (B_mb x S x D per
boundary) instead of DP's full gradient reduction.

GPipe schedule, S stages x M microbatches: step t in [0, M+S-1) has stage
s compute microbatch (t - s) when 0 <= t - s < M. Stage 0 embeds; the last
stage applies the reference's head loss (full-vocab logsumexp minus the
gold logit, summed over mb * (S - 1) positions); the loss is summed over
the axis so every stage holds it. Backward is autograd through the
schedule: `ring_permute`'s backward sends each cotangent back a stage, so
the mirrored backward pipeline needs no code of its own.

Where the reference computes the bubble's steps on garbage and masks
their terms to exact zeros, a stage here skips them and passes the
received activation on. Every rank still makes the same exchanges in the
same order, forward and backward: each stage's input at step t + 1 is the
output of step t's exchange (stage 0 selects its embedding over it, as the
reference's ``where`` does), and the last exchange's output joins every
rank's loss with weight 0, so the exchanges form one chain on every rank
and its backward walks them from last to first.
"""

from __future__ import annotations

import torch

from ..models import LM
from ..models.layers import rms_norm, tree_map
from ..optim.adamw import leaves


def _stage_range(lm: LM, comm, axis: str):
    n_stages = comm.axis_size(axis)
    per = lm.cfg.n_superblocks // n_stages
    s = comm.axis_index(axis)
    return s * per, (s + 1) * per


def stage_params(lm: LM, params, comm, axis: str = "pod"):
    """This stage's parameters: its slice [s*L/S, (s+1)*L/S) of the stacked
    blocks; embed, final norm and head whole (replicated over the axis)."""
    lo, hi = _stage_range(lm, comm, axis)
    return {**params, "blocks": tree_map(lambda t: t[lo:hi], params["blocks"])}


def _apply_stage(lm: LM, stage_blocks, x, positions):
    """Run this stage's superblocks over x."""
    per_layer = tree_map(lambda t: t.unbind(0), stage_blocks)
    n = len(next(leaves(per_layer)))
    for l in range(n):
        x = lm._superblock(x, tree_map(lambda ts: ts[l], per_layer), positions, None)
    return x


def build_pp_loss(lm: LM, comm, *, n_microbatches: int, axis: str = "pod"):
    """Returns ``pp_loss(params, batch) -> scalar`` for this rank of
    ``comm``'s mesh (the reference's ``mesh``), ``params`` its
    `stage_params`, ``batch`` the whole batch (replicated over the axis).
    The loss is differentiable; `pp_value_and_grad` differentiates it."""
    cfg = lm.cfg
    n_stages = comm.axis_size(axis)
    if cfg.n_superblocks % n_stages:
        raise ValueError(f"{cfg.n_superblocks} superblocks do not split into {n_stages} stages")
    if cfg.remainder:
        raise ValueError("remainder layers unsupported under PP")
    M = n_microbatches

    def pp_loss(params, batch):
        device = params["final_norm"].device
        stage = comm.axis_index(axis)
        tokens = torch.as_tensor(batch["tokens"], device=device)
        B, S = tokens.shape
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} microbatches")
        mb = B // M
        positions = torch.arange(S, device=device).expand(mb, S)
        is_first, is_last = stage == 0, stage == n_stages - 1
        head = params["embed"].T if cfg.tie_embeddings else params["head"]

        def head_loss(x, i):
            toks = tokens[i * mb:(i + 1) * mb]
            x = rms_norm(x, params["final_norm"], cfg.norm_eps)
            logits = (x @ head).float()[:, :-1]
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, toks[:, 1:, None].long())[..., 0]
            return (logz - gold).sum()

        total = torch.zeros((), dtype=torch.float32, device=device)
        buf = torch.zeros((mb, S, cfg.d_model), dtype=params["final_norm"].dtype,
                          device=device, requires_grad=True)
        take_embed = torch.ones((), dtype=torch.bool, device=device)
        for t in range(M + n_stages - 1):
            i = t - stage
            if 0 <= i < M:
                x_in = buf
                if is_first:
                    x_in = torch.where(take_embed, params["embed"][tokens[i * mb:(i + 1) * mb]],
                                       buf)
                y = _apply_stage(lm, params["blocks"], x_in, positions)
                if is_last:
                    total = total + head_loss(y, i)
            else:
                y = buf  # the bubble: nothing to compute, the chain passes on
            buf = comm.ring_permute(y, axis)
        total = total + 0.0 * buf.float().sum()  # every rank's loss reaches the ring
        total = comm.all_reduce(total, axis)
        count = torch.full((), float(M * mb * (S - 1)), device=device)
        return total / torch.clamp(count, min=1.0)

    return pp_loss


def pp_value_and_grad(pp_loss, params, batch, comm, axis: str = "pod"):
    """(loss, gradients) of ``pp_loss`` at this stage's ``params``: its
    blocks' own gradients, and the replicated leaves' summed over the axis
    (the embedding's from stage 0 and, tied, from the head's stage)."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = pp_loss(live, batch)
        # backward(), not autograd.grad: grad prunes the nodes that reach
        # none of the tensors asked for, such as the exchange of a bubble
        # step (whose input is the zero buffer), so the ranks would make
        # different numbers of exchanges and wait on each other for ever.
        loss.backward()

    def grad(t):  # a stage may use no part of a replicated leaf
        return torch.zeros_like(t) if t.grad is None else t.grad

    out = {k: (tree_map(grad, v) if k == "blocks"
               else tree_map(lambda t: comm.all_reduce(grad(t), axis), v))
           for k, v in live.items()}
    return loss.detach(), out
