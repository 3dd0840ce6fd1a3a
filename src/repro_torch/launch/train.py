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
Multi-device meshes (``--mesh`` other than 1x1) are not ported yet.
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
from ..models import LM
from ..models.layers import tree_map
from ..optim import AdamW, AdamWConfig, TrainState, cosine_schedule
from ..optim.adamw import leaves
from ..train import build_train_step
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
    ap.add_argument("--mesh", default="1x1", help="dataxmodel; only 1x1 is ported")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: multi-device training (FSDP x TP sharding) is not "
            "ported yet (ROADMAP.md, module queue); use --mesh 1x1"
        )
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


if __name__ == "__main__":
    main()
