"""The training driver: the port's train step on synthetic batches.

Set-up builds one train step and its state (`build_train_step(lm,
AdamW(...), remat=...)` over the benchmark's weights) and drives it
through the mix's ``check_steps`` first steps on batches 0, 1, 2; it keeps
the losses, each leaf's norm of the first gradient as the optimizer got it
(its first moment after one step over 1 - b1) and of the parameters'
change after the last of them. The window then runs the same step on
batches 3, 4, ... back to back; each step ends in a read of its loss,
which waits for the card. After the window, the reference follows the
first steps from the same weights and batches.
"""

from __future__ import annotations

import math
import time

import torch

from harness import traffic as tr
from harness import weights
from harness.bench import Run, check_layout, profiled, program_arch, span, synchronize


def _batch(run: Run, step: int):
    t = run.cell.traffic
    tok = tr.train_batch(run.seed, step, t["batch"], t["seq_len"], run.arch["vocab_size"])
    return torch.from_numpy(tok).to(run.device)


def setup(run: Run) -> dict:
    from reference.check import leaf_norms

    from repro_torch.models import LM
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import build_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = run.cell.traffic
    lm = LM(program_arch(run.arch))
    params = weights.make(run.arch, run.seed, run.device)
    check_layout(lm, params)
    opt = AdamW(AdamWConfig(**t["optimizer"]))
    state = opt.init(params)
    step = build_train_step(lm, opt, remat=t["remat"])
    if "half_batch" in run.faults:
        whole = step

        def step(state, batch):
            return whole(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    if "stale_state" in run.faults:
        def step(state, batch, _whole=step):
            saved = tree_map(lambda p: p.clone(), state.params)
            state, m = _whole(state, batch)
            tree_map(lambda p, s: p.copy_(s), state.params, saved)
            return state, m

    losses, grad = [], None
    for i in range(t["check_steps"]):
        state, m = step(state, {"tokens": _batch(run, i)})
        losses.append(float(m["loss"]))
        if i == 0:
            b1 = t["optimizer"]["b1"]
            grad = {k: v / (1 - b1) for k, v in leaf_norms(state.mu).items()}
    init = weights.make(run.arch, run.seed, run.device)
    change = leaf_norms(tree_map(lambda p, q: p.detach() - q, state.params, init))
    del init
    run.facts["program"] = {"loss": losses, "grad": grad, "change": change}
    return {"state": state, "step": step}


def measure(run: Run, prog: dict) -> None:
    t = run.cell.traffic
    state, step = prog["state"], prog["step"]
    steps, i = [], t["check_steps"]
    synchronize(run.device)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    with profiled(run), span("window"):
        t0 = time.perf_counter()
        while True:
            batch = {"tokens": _batch(run, i)}
            s0 = time.perf_counter()
            with span("step"):
                state, m = step(state, batch)
                loss = float(m["loss"])
            steps.append((s0, time.perf_counter()))
            run.attempted += 1
            run.failed += 0 if math.isfinite(loss) else 1
            i += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        t1 = time.perf_counter()
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    tokens = len(steps) * t["batch"] * t["seq_len"]
    run.end_to_end["train_tokens_per_s"] = tokens / (t1 - t0)
    run.facts.update(steps=steps, window=(t0, t1), batch=t["batch"], seq_len=t["seq_len"])


def reference_readings(run: Run, mode: str = "f32", rows=None) -> dict:
    """The reference's losses, first gradients (as the optimizer gets them)
    and parameter changes over the first steps, from the seed's weights;
    ``rows`` keeps only those rows of each batch (a planted fault)."""
    from reference import lm as ref
    from reference.check import leaf_norms

    t = run.cell.traffic
    params = weights.make(run.arch, run.seed, run.device)
    init = [p for _, p in ref.leaves(params)]
    flat = [p.detach().clone().requires_grad_() for p in init]
    tree = _like(params, flat)
    mu = [torch.zeros_like(p) for p in flat]
    nu = [torch.zeros_like(p) for p in flat]
    losses, grad = [], None
    with ref.precision(mode):
        for i in range(t["check_steps"]):
            tok = _batch(run, i)
            if rows is not None:
                tok = tok[rows]
            loss = ref.train_loss(run.arch, tree, tok, remat=t["remat"], config=run.cell.config)
            grads = torch.autograd.grad(loss, flat)
            losses.append(float(loss.detach()))
            ref.adamw_step(flat, list(grads), mu, nu, i + 1, t["optimizer"])
            if i == 0:
                b1 = t["optimizer"]["b1"]
                gtree = _like(tree, [m / (1 - b1) for m in mu])
                grad = leaf_norms(gtree)
            del grads, loss
    change = leaf_norms(_like(tree, [p.detach() - q for p, q in zip(flat, init)]))
    return {"loss": losses, "grad": grad, "change": change}


def _like(tree, values):
    """``tree``'s structure with ``values`` at its leaves, in sorted-key order."""
    from reference import lm as ref

    out = {}
    for (path, _), v in zip(ref.leaves(tree), values):
        weights.put(out, path, v)
    return out


def readings(prog: dict, refr: dict) -> dict:
    from reference.check import loss_gap, moving, worst_leaf

    names = moving(refr["grad"])
    return {"loss_rel": loss_gap(prog["loss"], refr["loss"]),
            "grad_leaf": worst_leaf(prog["grad"], refr["grad"], names),
            "change_leaf": worst_leaf(prog["change"], refr["change"], names)}


def check(run: Run, prog: dict) -> None:
    prog.clear()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = readings(run.facts["program"], reference_readings(run))
    run.facts["check_s"] = time.perf_counter() - t0
    for k, v in got.items():
        run.checks[k] = (v, run.cell.limits[k])


def run(run: Run) -> None:
    prog = setup(run)
    synchronize(run.device)
    run.setup_s = time.perf_counter() - run.t_start
    measure(run, prog)
    check(run, prog)
