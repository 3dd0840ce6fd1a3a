"""Programs the port's tests run on spawned ranks
(`repro_torch.distributed.comm.run_ranks`).

A rank imports this module by name, so it imports torch, numpy and
repro_torch only: ranks never import jax. The parent test holds what they
return against the reference. Inputs arrive as numpy arrays; `run_jobs`
runs several programs in one spawn, so each test file pays for few.
"""

import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.launch.serve import reduce_config, serve_batch
from repro_torch.models import LM
from repro_torch.models.layers import tree_map
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
from repro_torch.optim.compression import compressed_all_reduce, compressed_all_reduce_tree
from repro_torch.train import build_train_step, pipeline
from repro_torch.train.compressed_dp import build_compressed_dp_train_step
from repro_torch.distributed.comm import Comm, local_rows
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.steps import gather_state, loss_and_grads


def lm_of(arch, reduce=None, **replace):
    cfg = configs.get_config(arch)
    if reduce:
        cfg = reduce_config(cfg, reduce)
    return LM(dataclasses.replace(cfg, **replace))


def tensors(tree, device):
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def run_jobs(comm, jobs):
    """[(name, kwargs)] -> {name: what the program of that name returned}.
    A job's ``mesh=(shape, axes)`` runs it on another mesh of the same ranks
    (its process groups built once, by every rank in job order)."""
    comms, out = {None: comm}, {}
    for name, kw in jobs:
        kw = dict(kw)
        spec = kw.pop("mesh", None)
        if spec not in comms:
            comms[spec] = Comm(make_mesh(*spec), comm.rank, backend=comm.backend,
                                 device=comm.device)
        out[name] = PROGRAMS[kw.pop("program", name)](comms[spec], **kw)
    return out


# ----------------------------------------------------------------- programs


def compressed_sums(comm, gs, es, axes):
    """`compressed_all_reduce` of this rank's (g, e) pairs along ``axes``,
    leaf by leaf and as one tree."""
    g = [torch.from_numpy(a) for a in gs[comm.rank]]
    e = [torch.from_numpy(a) for a in es[comm.rank]]
    one = [compressed_all_reduce(gi, ei, comm, axes) for gi, ei in zip(g, e)]
    tree = compressed_all_reduce_tree(g, e, comm, axes)
    return {"sum": [s for s, _ in one], "error": [n for _, n in one],
            "tree_sum": tree[0], "tree_error": tree[1]}


def compressed_sync(comm, gs, es, axes):
    """The compressed-DP sync of one leaf: over each axis in turn."""
    g, e = torch.from_numpy(gs[comm.rank]), torch.from_numpy(es[comm.rank])
    for ax in axes:
        g, e = compressed_all_reduce(g, e, comm, ax)
    return {"sum": g, "error": e}


def compressed_steps(comm, arch_kw, params, batches, lr, eval_batches=None):
    """Steps of `build_compressed_dp_train_step` from ``params``; per step
    the reported loss and, on ``eval_batches``, ``lm.loss`` of the params
    before the step (the reference test's evaluation)."""
    lm = lm_of(**arch_kw)
    opt = AdamW(AdamWConfig(lr=lr))
    step, init, place = build_compressed_dp_train_step(lm, opt, comm)
    state = place(init(tensors(params, "cpu")))
    axes = ("pod", "data") if "pod" in comm.mesh.shape else ("data",)
    # The first step's local loss and gradients, as the step computes them.
    loss0, grads0 = loss_and_grads(lm, state.inner.params,
                                   local_rows(batches[0], comm, axes), remat=False)
    losses, evals = [], []
    for i, b in enumerate(batches):
        if eval_batches is not None:
            evals.append(float(lm.loss(state.inner.params, tensors(eval_batches[i], comm.device))))
        state, loss = step(state, b)
        losses.append(float(loss))
    out = {"losses": losses, "evals": evals, "loss0": float(loss0), "grads0": grads0}
    if comm.rank == 0:
        out.update(params=state.inner.params, error=state.error)
    return out


def fsdp_steps(comm, arch_kw, params, batches, lr, grad_accum=1, eps=1e-8):
    """Steps of the sharded `build_train_step` from ``params``: losses,
    grad norms, this rank's shard shapes and the gathered params."""
    lm = lm_of(**arch_kw)
    opt = AdamW(AdamWConfig(lr=lr, eps=eps),
                cosine_schedule(lr, warmup_steps=1, total_steps=len(batches)))
    step, shardings, _ = build_train_step(lm, opt, comm, remat=True, grad_accum=grad_accum)
    state = opt.init(sharding.shard_tree(tensors(params, "cpu"), shardings.params, comm.mesh,
                                         comm.coords, comm.device))
    shapes = tree_map(lambda t: tuple(t.shape), state.params)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    full = gather_state(state, shardings, comm)
    return {"losses": losses, "grad_norms": norms, "shard_shapes": shapes,
            "params": full.params if comm.rank == 0 else None}


def pp_grads(comm, arch_kw, params, tokens, n_microbatches):
    """The GPipe loss over ``pod`` and this stage's gradients."""
    lm = lm_of(**arch_kw)
    sp = pipeline.stage_params(lm, tensors(params, comm.device), comm)
    pp = pipeline.build_pp_loss(lm, comm, n_microbatches=n_microbatches)
    loss, grads = pipeline.pp_value_and_grad(pp, sp, {"tokens": tokens}, comm)
    return {"loss": float(loss), "grads": grads, "stage": comm.axis_index("pod")}


def serve(comm, arch_kw, params, prompts, gen):
    """``serve_batch`` on this rank's rows of each prompt batch: the
    gathered tokens and logits."""
    lm = lm_of(**arch_kw)
    p = tensors(params, comm.device)
    out = []
    for pr in prompts:
        tokens, logits = serve_batch(lm, p, pr, gen, comm=comm, return_logits=True)
        out.append({"tokens": tokens, "logits": logits})
    return out


def collectives(comm):
    """Each collective along every axis and all axes at once, on small
    tensors of the rank's device."""
    dev, r, out = comm.device, comm.rank, {}
    axes = [a for a in comm.mesh.axis_names if comm.mesh.shape[a] > 1]
    for ax in axes + [tuple(axes)]:
        key = ax if isinstance(ax, str) else "+".join(ax)
        x = torch.full((2, 3), float(r + 1), device=dev)
        y = torch.tensor([float(r)], device=dev, requires_grad=True)
        z = comm.ring_permute(y * 2, ax)
        (z * (r + 10)).sum().backward()
        out[key] = {"sum": comm.all_reduce(x, ax)[0, 0].item(),
                    "max": comm.all_reduce(x, ax, "max")[0, 0].item(),
                    "gather": comm.all_gather(torch.tensor([r], device=dev), ax).tolist(),
                    "scatter": comm.reduce_scatter(
                        torch.arange(4.0, device=dev) * (r + 1), ax).tolist(),
                    "permuted": z.item(), "permute_grad": y.grad.item()}
    return out


PROGRAMS = {f.__name__: f for f in (compressed_sums, compressed_sync, compressed_steps,
                                    fsdp_steps, pp_grads, serve, collectives)}
