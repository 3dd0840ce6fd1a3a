#!/usr/bin/env python3
"""What a `run_ranks` spawn of `chip_smoke.py`'s parity block spends
besides its ranks' work, on the CPU (no card needed).

    python3 tools/rank_transport.py [--threads 1 2 4]

1. Each of the block's three jobs (dist_parity's inputs, tp_parity's
   serve and train inputs: reduced weights, batches, prompts) written and
   read as `run_ranks` moves it (``torch.save`` of ``(fn, args)`` into a
   file, ``torch.load`` in the rank), once with the numpy arrays pickled as
   they are and once packed as tensors (`comm._pack` / `comm._unpack`):
   megabytes and seconds.
2. dist_parity's two CPU ranks alone, at each ``--threads`` count a rank
   (`run_ranks(..., threads=)`): the spawn's seconds and the ranks' own.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def _round_trip(job, path: str) -> dict:
    import torch

    t0 = time.perf_counter()
    torch.save(job, path)
    t1 = time.perf_counter()
    torch.load(path, weights_only=False)
    t2 = time.perf_counter()
    return {"mb": os.path.getsize(path) / 1e6, "write_s": t1 - t0, "read_s": t2 - t1}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, nargs="*", default=[1, 2, 4])
    args = ap.parse_args()

    import chip_smoke as c
    from repro_torch.distributed import comm
    from repro_torch.launch.mesh import make_mesh

    dist_in, tp_in = c._dist_parity_inputs(), c._tp_parity_inputs()
    jobs = {"dist_parity": (c._dist_parity_rank, (dist_in,)),
            "tp_serve": (c._tp_serve_rank, (tp_in["serve"],)),
            "tp_train": (c._tp_train_rank, (tp_in["train"],))}
    out = {"jobs": {}, "dist_parity_cpu": {}, "cpus": os.cpu_count()}
    with tempfile.TemporaryDirectory(prefix="rank_transport_") as tmp:
        for name, (fn, fn_args) in jobs.items():
            path = os.path.join(tmp, f"{name}.pt")
            out["jobs"][name] = {"pickled_arrays": _round_trip((fn, fn_args), path),
                                 "as_tensors": _round_trip((fn, comm._pack(fn_args)), path)}
    mesh = make_mesh(*c.DIST_MESH)
    for threads in args.threads:
        t0 = time.perf_counter()
        recs = comm.run_ranks(c._dist_parity_rank, mesh, dist_in, backend="gloo", device="cpu",
                              threads=threads, timeout_s=c.DIST_TIMEOUT_S)
        out["dist_parity_cpu"][threads] = {"spawn_s": time.perf_counter() - t0,
                                           "rank_s": [r["s"] for r in recs]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
