"""Shared helpers of the benchmark's CPU tests: a cell cut to a tiny size
(the harness's widths as data), and one run of it on the CPU through the
harness, the chip check skipped."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("qwen3-0.6b.train-4k", "qwen3-0.6b.prefill-long", "dbrx-132b.chat")
SEED = 2 ** 31 + 11


def shrink(cell, **arch):
    """``cell`` at widths a CPU test can hold."""
    cell = copy.deepcopy(cell)
    a = cell.config["arch"]
    a.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
             vocab_size=512)
    if a.get("n_experts"):
        a.update(n_experts=4, experts_per_token=2)
    a.update(arch)
    t = cell.traffic
    if t["driver"] == "train":
        t.update(batch=2, seq_len=64)
    else:
        # 2 x 256 tokens make 64 groups of 8 in the MoE's prefill: capacity drops happen.
        t.update(batch=2, prompt_lens=[16, 256], gen_tokens=6, check_requests_per_len=2)
    return cell


def execute(cell, trace=0, seed=SEED, faults=(), **arch):
    import run

    return run.execute(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                        "--trace", str(trace)], need_chip=False,
                       cell_override=lambda c: shrink(c, **arch), faults=faults)
