#!/usr/bin/env python3
"""The model axis (tensor parallelism) over NCCL, one card a rank, on a
machine with four NVIDIA GPUs.

    python3 tools/model_axis_nccl.py

Builds the kernels, runs the card tests that need two cards
(``tests/test_torch_cuda.py -k nccl``), then ``chip_smoke.py``'s tp_parity
work over NCCL: the ``--mesh 1x2`` greedy serves of its six reduced
configs (float32 caches) on two cards and the ``--mesh 2x2`` FSDP x TP
steps of qwen3-0.6b and dbrx-132b on four, held to the same ranks on the
CPU (gloo) with tp_parity's tolerances; and serve_tp's qwen3-0.6b run (full
width, 8 x (1,024 + 16)) on two cards. Prints the cards' ``nvidia-smi``
name and power limit and one JSON line each for the parity checks and the
serve (prefill s, decode ms a step, bytes per collective kind, peak memory
a rank). Exits non-zero if a check fails or there are fewer than four
cards.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    import chip_smoke as c
    from repro_torch.distributed.comm import run_ranks, transport_name
    from repro_torch.launch.mesh import make_mesh

    if torch.cuda.device_count() < 4:
        print("model_axis_nccl: needs four CUDA devices", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    c.phase_build()
    tests = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
                            "no:cacheprovider", "tests/test_torch_cuda.py", "-k", "nccl"],
                           capture_output=True, text=True, cwd=ROOT,
                           env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    print("tests", tests.returncode, tests.stdout[-1500:], flush=True)
    parity = c._tp_parity_inputs()
    one_two, two_two = make_mesh(*c.TP_MESH), make_mesh(*c.TP_TRAIN_MESH)
    t0 = time.perf_counter()
    serves = run_ranks(c._tp_serve_rank, one_two, parity["serve"], backend="nccl",
                       device="cuda", timeout_s=c.DIST_TIMEOUT_S)
    trains = run_ranks(c._tp_train_rank, two_two, parity["train"], backend="nccl",
                       device="cuda", timeout_s=c.DIST_TIMEOUT_S)
    nccl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_serves = run_ranks(c._tp_serve_rank, one_two, parity["serve"], 1, backend="gloo",
                           device="cpu", timeout_s=c.DIST_TIMEOUT_S)
    cpu_trains = run_ranks(c._tp_train_rank, two_two, parity["train"], 1, backend="gloo",
                           device="cpu", timeout_s=c.DIST_TIMEOUT_S)
    cpu_s = time.perf_counter() - t0
    checks = c._compare_tp([r["result"] for r in serves], [r["result"] for r in cpu_serves],
                           [r["result"] for r in trains], [r["result"] for r in cpu_trains])
    print(json.dumps({"phase": "tp_parity_nccl",
                      "transport": [transport_name("nccl", "cuda", one_two.size),
                                    transport_name("nccl", "cuda", two_two.size)],
                      "checks": checks, "nccl_s": nccl_s, "cpu_s": cpu_s,
                      "decode_lse_launches_by_rank": [r["decode_lse_launches"] for r in serves]}),
          flush=True)
    arch, (layers, requests, prompt_len, gen) = "qwen3-0.6b", c.SERVE_TP_RUNS["qwen3-0.6b"]
    recs = run_ranks(c._serve_tp_one, one_two, arch, 1, layers, requests, prompt_len, gen,
                     backend="nccl", device="cuda", timeout_s=c.DIST_TIMEOUT_S)
    res = recs[0]["result"]
    t = res["timings"]
    print(json.dumps({"phase": "serve_tp_nccl", "arch": arch, "requests": requests,
                      "prompt_len": prompt_len, "gen": gen, "prefill_s": t["prefill_s"],
                      "decode_ms_per_step": t["decode_s"] * 1e3 / t["decode_steps"],
                      "prefill_bytes_by_kind": res["prefill_bytes"],
                      "decode_step_bytes_by_kind": res["decode_step_bytes"],
                      "max_memory_allocated_by_rank": [r["result"]["max_memory_allocated"]
                                                       for r in recs]}), flush=True)
    bad = [k for k, v in checks.items() if not v["ok"]]
    return 1 if bad or tests.returncode else 0


if __name__ == "__main__":
    sys.exit(main())
