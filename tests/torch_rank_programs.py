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
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import sharding, tensor_parallel
from repro_torch.launch.serve import reduce_config, serve_batch
from repro_torch.models import LM
from repro_torch.models.layers import tree_map
from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
from repro_torch.optim.compression import compressed_all_reduce, compressed_all_reduce_tree
from repro_torch.train import build_train_step, pipeline
from repro_torch.train.compressed_dp import build_compressed_dp_train_step
from repro_torch.distributed.comm import Comm, local_rows, rank_rows
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.steps import (build_decode_step, build_prefill_step, gather_state,
                                     loss_and_grads, param_shardings)


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


def shapes_of(tree):
    return tree_map(lambda t: tuple(t.shape), tree)


def tp_serve(comm, arch_kw, params, batch, gen, decode_embeds=None, prompts=None):
    """One config on this rank's shards under ``serve_rules``: prefill and
    ``gen`` greedy ``decode_step``s with float32 caches (the vocab-parallel
    argmax; the logits gathered), ``serve_batch``'s tokens from
    ``prompts`` (bf16 caches), and the rank's parameter and cache shapes.
    ``decode_embeds`` (gen, B, 1, D): the inputs of an arch that takes
    embeddings."""
    lm = lm_of(**arch_kw)
    rules = sharding.serve_rules(False)
    specs = param_shardings(lm, comm.mesh, rules)
    p = sharding.shard_tree(tensors(params, "cpu"), specs, comm.mesh, comm.coords, comm.device)
    b = tensors(batch, comm.device)
    n = next(iter(b.values())).shape[1]
    s_max = n + gen
    out = {"param_shapes": shapes_of(p)}
    with sharding.activation_ctx(comm, rules):
        tp = tensor_parallel.current()
        logits, cache, lengths = lm.prefill(p, b, s_max=s_max, cache_dtype=torch.float32)
        out["cache_shapes"] = shapes_of(cache)
        seen, toks = [], []
        for i in range(gen):
            seen.append(tensor_parallel.vocab_whole(logits, lm.cfg.vocab_size))
            tok = tp.argmax(logits) if logits.shape[-1] < lm.cfg.vocab_size else logits.argmax(-1)
            toks.append(tok)
            if i == gen - 1:
                break
            nxt = ({"embeds": torch.from_numpy(decode_embeds[i]).to(comm.device)}
                   if decode_embeds is not None else {"tokens": tok[:, None]})
            logits, cache, lengths = lm.decode_step(p, nxt, cache, lengths, s_max=s_max)
    out["logits"] = torch.stack(seen, 1)
    out["tokens"] = torch.stack(toks, 1)
    if prompts is not None:
        out["served"] = serve_batch(lm, p, prompts, gen, comm=comm)
    return out


def tp_train(comm, arch_kw, params, batches, lr, eps, ckpt=None, replicated_grads=False):
    """Steps of the sharded `build_train_step` (FSDP over ``data``, tensor
    parallelism over ``model``) from ``params``: losses, grad norms, the
    rank's shard shapes, the gathered params (rank 0), and with
    ``replicated_grads`` the first batch's gradients of the leaves
    replicated over ``model`` as this rank computes them. With ``ckpt``,
    rank 0 writes the state after the steps there."""
    lm = lm_of(**arch_kw)
    opt = AdamW(AdamWConfig(lr=lr, eps=eps),
                cosine_schedule(lr, warmup_steps=1, total_steps=len(batches)))
    step, shardings, _ = build_train_step(lm, opt, comm, remat=True)
    state = opt.init(sharding.shard_tree(tensors(params, "cpu"), shardings.params, comm.mesh,
                                         comm.coords, comm.device))
    out = {"shard_shapes": shapes_of(state.params), "model_index": comm.axis_index("model"),
           "data_index": comm.axis_index("data")}
    if replicated_grads:
        specs = shardings.params
        full = tree_map(lambda t, s: sharding.gather_leaf(t, s, comm, keep=("model",)),
                        state.params, specs)
        with sharding.activation_ctx(comm, sharding.train_rules(False)):
            _, grads = loss_and_grads(lm, full, local_rows(batches[0], comm, ("data",)))
        out["replicated_grads"] = tree_map(
            lambda g, s: None if any("model" in a for _, a in sharding.sharded_dim(s, comm.mesh))
            else g, grads, specs)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    whole = gather_state(state, shardings, comm)
    if ckpt is not None and comm.rank == 0:
        CheckpointManager(ckpt).save(len(batches), whole, blocking=True)
    out.update(losses=losses, grad_norms=norms,
               params=whole.params if comm.rank == 0 else None)
    return out


def vocab_parallel(comm, logits, targets, table, tokens):
    """The vocab-parallel argmax, cross-entropy and lookup of this rank's
    columns (rows) of whole arrays."""
    tp = tensor_parallel.TensorParallel(comm, comm.axis_size("model"), comm.axis_index("model"))
    cols = logits.shape[-1] // tp.size
    mine = torch.from_numpy(logits[..., tp.index * cols:(tp.index + 1) * cols])
    rows = table.shape[0] // tp.size
    return {"argmax": tp.argmax(mine[:, -1]),
            "ce": tp.cross_entropy(mine, torch.from_numpy(targets)),
            "lookup": tp.lookup(torch.from_numpy(table[tp.index * rows:(tp.index + 1) * rows]),
                                torch.from_numpy(tokens))}


def gather_leaves(comm, whole, specs):
    """This rank's shard of ``whole`` under each spec, gathered back: over
    every split axis, over all but ``model``, and to rank 0 alone."""
    out = []
    for spec in specs:
        t = torch.from_numpy(whole)[sharding.shard_index(spec, whole.shape, comm.mesh,
                                                          comm.coords)]
        out.append({"dims": sharding.sharded_dim(spec, comm.mesh),
                    "all": sharding.gather_leaf(t, spec, comm),
                    "keep_model": sharding.gather_leaf(t, spec, comm, keep=("model",)),
                    "to_first": sharding.gather_leaf(t, spec, comm, to_first=True)})
    return out


def gathered_serve(comm, arch_kw, params, prompts, gen, rules):
    """Greedy serving of this rank's rows of ``prompts`` through
    `build_prefill_step` / `build_decode_step` under ``rules`` (which may
    split leaves over ``data``: weight-gathered serving), from this rank's
    shards of ``params``: the shards' shapes, tokens and logits."""
    lm = lm_of(**arch_kw)
    specs = param_shardings(lm, comm.mesh, rules)
    p = sharding.shard_tree(tensors(params, "cpu"), specs, comm.mesh, comm.coords, comm.device)
    rows = prompts[rank_rows(len(prompts), comm, sharding.batch_axes(comm.mesh, rules))]
    s_max = prompts.shape[1] + gen
    prefill, _ = build_prefill_step(lm, comm, rules, s_max=s_max, batch_size=len(prompts))
    decode, _ = build_decode_step(lm, comm, rules)
    logits, cache, lengths = prefill(p, {"tokens": torch.from_numpy(rows).long()})
    toks, seen = [], []
    for i in range(gen):
        seen.append(logits)
        toks.append(logits.argmax(-1))
        if i < gen - 1:
            logits, cache, lengths = decode(p, {"tokens": toks[-1][:, None]}, cache, lengths)
    return {"shapes": shapes_of(p), "tokens": torch.stack(toks, 1).to(torch.int32),
            "logits": torch.stack(seen, 1)}


PROGRAMS = {f.__name__: f for f in (gather_leaves, compressed_sums, compressed_sync,
                                    compressed_steps, fsdp_steps, pp_grads, serve, collectives,
                                    tp_serve, tp_train, vocab_parallel, gathered_serve)}
