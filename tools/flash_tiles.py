#!/usr/bin/env python3
"""Tile sweep of the CUDA flash-attention kernel on one NVIDIA GPU.

    python3 tools/flash_tiles.py [--reps 7]

Builds copies of ``src/repro_torch/csrc/flash_attention.cu`` in which the
`Tile` entry of head_dim 128 or 256 is replaced (NW warps, BK keys per K/V
stage, the CTAs per SM the registers are budgeted for), all nvcc processes
at once with the port's flags. Each variant runs through the port's
wrapper at the two serving shapes, qwen3-0.6b's (8, 16 / 8, 1024, 128) and
recurrentgemma-2b's (8, 10 / 1, 2048, 256), f32 causal, and is held to the
plain version within 2e-5 abs/rel. Then every variant of a shape and one
``scaled_dot_product_attention`` call (a yardstick) are timed by CUDA
events, interleaved round by round in one process so that they share the
card's state. Prints the card's ``nvidia-smi`` name and power limit, then
one JSON line per variant: ptxas' registers and spill bytes of its f32
instance at that head_dim, shared memory per CTA, and the per-call ms of
each round and their median.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {128: (8, 16, 8, 1024), 256: (8, 10, 1, 2048)}  # B, H, KVH, S
# (head_dim, warps, keys per stage, CTAs per SM); the source's own entries
# are added as "committed".
VARIANTS = [
    (128, 8, 32, 1), (128, 4, 32, 2), (128, 4, 16, 3), (128, 8, 16, 2),
    (256, 4, 32, 1),
]
TILE = r"struct Tile<{d}> {{ static constexpr int NW = (\d+), BK = (\d+), kMinBlocks = (\d+); }};"
TOL = 2e-5


def smem_bytes(d: int, nw: int, bk: int) -> int:
    """The kernel's `smem_floats`: Q and two K stages in rows of D + 8
    floats, two V stages in rows of D + 4."""
    return ((16 * nw + 2 * bk) * (d + 8) + 2 * bk * (d + 4)) * 4


def variant_source(source: str, d: int, nw: int, bk: int, mb: int) -> str:
    """``source`` with its `Tile<d>` entry replaced."""
    text, n = re.subn(TILE.format(d=d),
                      f"struct Tile<{d}> {{ static constexpr int NW = {nw}, BK = {bk}, "
                      f"kMinBlocks = {mb}; }};", source)
    assert n == 1, f"no Tile<{d}> entry in the source"
    return text


def events_ms(fn, calls: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_tiles: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel_cuda, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    source = (build.CSRC / kernel_cuda.SOURCE).read_text()
    variants = []
    for d in SHAPES:
        nw, bk, mb = map(int, re.search(TILE.format(d=d), source).groups())
        variants.append((f"d{d}_committed_nw{nw}_bk{bk}_mb{mb}", d, nw, bk, mb))
    variants += [(f"d{d}_nw{nw}_bk{bk}_mb{mb}", d, nw, bk, mb) for d, nw, bk, mb in VARIANTS]
    built = build.build_copies({name: variant_source(source, *tile)
                                for name, *tile in variants}, "flash_tiles")

    gen = torch.Generator(device="cuda").manual_seed(0)
    all_ok = True
    for d, (B, H, KVH, S) in SHAPES.items():
        q, k, v = (torch.randn((B, h, S, d), device="cuda", generator=gen)
                   for h in (H, KVH, KVH))
        want = ref.attention_ref(q, k, v)
        rows, fns = [], {}
        for name, vd, nw, bk, mb in variants:
            if vd != d:
                continue
            lib = ctypes.CDLL(str(built[name][0]))
            kernel_cuda._bind(lib)

            def call(lib=lib):
                build._LIBS[kernel_cuda.SOURCE] = lib
                return kernel_cuda.flash_attention_cuda(q, k, v)

            diff = (call().float() - want).abs()
            ok = bool(diff.le(TOL + TOL * want.abs()).all())
            all_ok &= ok
            rows.append({"variant": name, "shape": [B, H, KVH, S, d], "warps": nw,
                         "keys_per_stage": bk, "min_ctas_per_sm": mb,
                         "smem_bytes": smem_bytes(d, nw, bk), **build.ptxas_report(built[name][1], f"flash_attention_kernelIfLi{d}E"),
                         "max_abs_err": float(diff.max()), "ok": ok, "ms": []})
            if ok:
                fns[name] = call
        rows.append({"variant": "sdpa", "shape": [B, H, KVH, S, d], "ms": []})
        fns["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                             enable_gqa=True)
        calls = 10 if d == 128 else 3
        for fn in fns.values():  # warm-up
            events_ms(fn, 1)
        for _ in range(args.reps):
            for row in rows:
                if row["variant"] in fns:
                    row["ms"].append(events_ms(fns[row["variant"]], calls))
        for row in rows:
            row["median_ms"] = statistics.median(row["ms"]) if row["ms"] else None
            print(json.dumps(row), flush=True)
        build._LIBS.pop(kernel_cuda.SOURCE, None)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
