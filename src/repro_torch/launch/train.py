"""Training entry point on one device (port of `repro.launch.train`).

Trains a (reduced or full-width) architecture with the single-device train
step (`repro_torch.train.build_train_step`: remat, AdamW with a cosine
schedule), synthetic data (`repro_torch.data`) and checkpoint / restart
(`repro_torch.checkpoint`). The weights are drawn from seed 0 on the CPU
and moved to the device, as serving does, so every device trains the same
model. Float32 parameters and products (TF32 off).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduce 1 --steps 4 --batch 8 --seq 1024 --ckpt-dir build/ckpt

The final checkpoint is written once: where the loop's last periodic save
was already of the final step, `main` waits for it instead of writing
the same state again (the reference writes it twice). Without ``--device
cpu`` it runs on the card and raises if there is none.

``--mesh DxM`` spawns D x M ranks (`repro_torch.distributed.comm`; one
JAX process drives all its devices, so the launcher starts its ranks
itself) that run the sharded step (`build_train_step` with a ``comm``:
FSDP over ``data``, tensor parallelism over ``model``): each rank stores
its shards of the state, takes its ``data`` slice's rows of
``data.batch(step)``, the global batch (the reference's pjit shards the
global batch; ``batch(step, host_id, n_hosts)`` is another stream), and
rank 0 prints the reference's lines. Checkpoints hold whole leaves (the
shards are gathered to rank 0, which writes), and ``--resume`` gives each
rank its shard of them, so a run resumes on any mesh, and in the
reference. ``--dist-backend`` names the transport: ``nccl`` (the
default) needs a card per rank, ``gloo`` stages each exchange through
host memory (several ranks can share one card). ``--mesh 1x1`` is the
single-device path.

  PYTHONPATH=src python -m repro_torch.launch.train --mesh 2x2 \
      --dist-backend gloo --reduce 8 --steps 4 --batch 4 --seq 64
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..data import DataConfig, SyntheticLMData
from ..device import resolve_device
from ..distributed import comm as dist_comm
from ..distributed import sharding
from ..models import LM
from ..models.layers import tree_map
from ..optim import AdamW, AdamWConfig, TrainState, cosine_schedule
from ..optim.adamw import leaves
from ..train import build_train_step
from ..train.steps import gather_state
from .mesh import parse_mesh
from .serve import reduce_config


def main(argv=None, *, record: Optional[dict] = None):
    """Runs the training loop; returns the per-step losses. With a
    ``record`` dict, ``record["steps"]`` receives per step its number,
    loss, grad norm and host seconds (the step ends in a read of its loss,
    which waits for the device), and ``record["n_params"]`` the count."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduce", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data-mode", default="markov")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL: FSDP over DATA ranks, tensor parallelism over MODEL")
    ap.add_argument("--dist-backend", default="nccl", choices=dist_comm.BACKENDS,
                    help="transport between the ranks of a --mesh run")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    mesh = parse_mesh(args.mesh)
    if mesh.size > 1:
        recs = dist_comm.run_ranks(_train_rank, mesh, args, backend=args.dist_backend,
                                   device=args.device)
        if record is not None:
            record.update(recs[0]["result"]["record"])
            record["transport"] = dist_comm.transport_name(args.dist_backend, args.device,
                                                           mesh.size)
            record["ranks"] = [{k: r[k] for k in ("s", "launches", "decode_lse_launches",
                                                  "max_memory_allocated", "comm_bytes")}
                               for r in recs]
        return recs[0]["result"]["losses"]

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    cfg = reduce_config(configs.get_config(args.arch), args.reduce)
    lm = LM(cfg)

    opt = AdamW(
        AdamWConfig(lr=args.lr),
        schedule=cosine_schedule(args.lr, warmup_steps=10, total_steps=args.steps),
    )
    step_fn = build_train_step(lm, opt, remat=True)

    data = SyntheticLMData(
        DataConfig(
            vocab_size=cfg.vocab_size,
            seq_len=args.seq,
            global_batch=args.batch,
            mode=args.data_mode,
        )
    )

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    state = None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        specs = lm.param_specs()  # the structure only: nothing is allocated
        state = ckpt.restore(TrainState(specs, specs, specs, 0), device=device)
        start_step = int(state.step)
        print(f"[train] resumed from step {start_step}")
    if state is None:
        params = lm.init(torch.Generator().manual_seed(0), dtype=torch.float32)
        state = opt.init(tree_map(lambda t: t.to(device), params))
        del params

    n_params = sum(t.numel() for t in leaves(state.params))
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M mesh={{'data': 1, 'model': 1}} "
          f"steps={args.steps}")
    if record is not None:
        record.update(n_params=n_params, steps=[])

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.as_tensor(v, device=device) for k, v in data.batch(step).items()}
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if record is not None:
            record["steps"].append({"step": step, "loss": loss,
                                    "grad_norm": float(metrics["grad_norm"]),
                                    "s": time.perf_counter() - t_step})
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"[train] step={step} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} ({dt:.1f}s)", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt:
        if start_step < args.steps and args.steps % args.ckpt_every == 0:
            ckpt.wait()  # the loop's last save is this step's: written once
        else:
            ckpt.save(args.steps, state, blocking=True)
    print(f"[train] done: first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean {np.mean(losses[-10:]):.4f}")
    return losses


def _train_rank(comm, args):
    """One rank of ``main``'s ``--mesh`` run; returns its losses and, per
    step, loss, grad norm, host seconds and bytes moved."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh, lead = comm.mesh, comm.rank == 0
    cfg = reduce_config(configs.get_config(args.arch), args.reduce)
    lm = LM(cfg)
    opt = AdamW(
        AdamWConfig(lr=args.lr),
        schedule=cosine_schedule(args.lr, warmup_steps=10, total_steps=args.steps),
    )
    step_fn, shardings, _ = build_train_step(lm, opt, comm, remat=True)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.batch, mode=args.data_mode))

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    specs = lm.param_specs()
    start_step, state = 0, None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        index = tree_map(lambda p, spec: sharding.shard_index(spec, p.shape, mesh, comm.coords),
                         specs, shardings.params)
        state = ckpt.restore(TrainState(specs, specs, specs, 0), device=comm.device,
                             shardings=TrainState(index, index, index, ()))
        start_step = int(state.step)
        if lead:
            print(f"[train] resumed from step {start_step}", flush=True)
    if state is None:
        params = lm.init(torch.Generator().manual_seed(0), dtype=torch.float32)
        state = opt.init(sharding.shard_tree(params, shardings.params, mesh, comm.coords,
                                             comm.device))
        del params

    n_params = sum(int(np.prod(p.shape)) for p in leaves(specs))
    if lead:
        print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M mesh={mesh.shape} "
              f"steps={args.steps}", flush=True)
    rec = {"n_params": n_params, "steps": []}

    def save(step, **kw):
        host = gather_state(state, shardings, comm)  # every rank takes part; rank 0's
        if lead:
            ckpt.save(step, host, **kw)

    losses = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        moved = dict(comm.bytes)
        t_step = time.perf_counter()
        state, metrics = step_fn(state, data.batch(step))
        loss = float(metrics["loss"])
        losses.append(loss)
        rec["steps"].append({"step": step, "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                             "s": time.perf_counter() - t_step,
                             "comm_bytes": {k: v - moved.get(k, 0)
                                            for k, v in comm.bytes.items()}})
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            dt = time.time() - t0
            print(f"[train] step={step} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} ({dt:.1f}s)", flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    if ckpt:
        if start_step < args.steps and args.steps % args.ckpt_every == 0:
            if lead:
                ckpt.wait()  # the loop's last save is this step's: written once
        else:
            save(args.steps, blocking=True)
    if lead:
        print(f"[train] done: first-10 mean loss {np.mean(losses[:10]):.4f} -> "
              f"last-10 mean {np.mean(losses[-10:]):.4f}", flush=True)
    return {"losses": losses, "record": rec}


if __name__ == "__main__":
    main()
