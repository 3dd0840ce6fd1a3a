#!/usr/bin/env python3
"""Tile sweep of the CUDA RWKV-6 scan kernel on one NVIDIA GPU.

    python3 tools/rwkv6_tiles.py [--reps 7] [--extra NAME=PATH ...]

Builds copies of ``src/repro_torch/csrc/rwkv6_scan.cu`` in which the `Tile`
entry of head size 64 is replaced (KG key groups per warp, kWarps warps
per CTA, kChunk steps per stage, kStages stages, kMinBlocks CTAs per SM the
registers are budgeted for), all nvcc processes at once with the port's
flags. Each variant runs through the port's wrapper at rwkv6-7b's two
shapes, its prefill (8, 64, 1024, 64) f32 and its decode step (8, 64, 1,
64) with the state updated in place, and is held to the plain version
within 1e-4 abs/rel. Then every variant of a shape is timed, interleaved
round by round in one process so that they share the card's state: the
kernel's own time on the card per call from a torch.profiler trace (as
``chip_smoke.py``'s ``device_ms``; at T = 1 a call's host time exceeds the
kernel's). Prints the card's ``nvidia-smi`` name and power limit, then one
JSON line per variant and shape: ptxas' registers and spill bytes of its
f32 instance at N = 64, threads and shared memory per CTA, and the device
ms of each round and their median. ``--extra NAME=PATH`` adds another
source with the same C interface (an earlier version of the kernel, say),
built and timed as it is, beside the variants.
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
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SHAPES = ((8, 64, 1024, 64), (8, 64, 1, 64))  # (B, H, T, N): prefill, decode
# (KG, kWarps, kChunk, kStages, kMinBlocks); the source's own entry is
# added as "committed".
VARIANTS = [
    (2, 4, 8, 4, 4), (1, 4, 8, 4, 4), (4, 4, 8, 4, 4), (2, 2, 8, 4, 4), (2, 4, 8, 3, 4),
    (2, 4, 4, 6, 4), (2, 8, 4, 4, 4), (4, 2, 8, 4, 4),
]
TILE = (r"struct Tile<64> \{ static constexpr int KG = (\d+), kWarps = (\d+), kChunk = (\d+), "
        r"kStages = (\d+), kMinBlocks = (\d+); \};")
TOL = 1e-4


def smem_bytes(warps: int, chunk: int, stages: int, n: int = 64) -> int:
    """The kernel's `Plan::kSmem` for f32 inputs."""
    return stages * chunk * 4 * n * 4 + (2 * warps * chunk * n + 2 * chunk) * 4 + stages * 8


def variant_source(source: str, tile) -> str:
    """``source`` with its `Tile<64>` entry replaced by ``tile``, or
    ``tile`` itself when it is the text of another source."""
    if isinstance(tile, str):
        return tile
    text, n = re.subn(TILE, "struct Tile<64> {{ static constexpr int KG = {}, kWarps = {}, "
                      "kChunk = {}, kStages = {}, kMinBlocks = {}; }};".format(*tile), source)
    assert n == 1, "no Tile<64> entry in the source"
    return text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=PATH",
                    help="another rwkv6_scan.cu to time beside the variants")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("rwkv6_tiles: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import device_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6_scan import kernel_cuda, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    source = (build.CSRC / kernel_cuda.SOURCE).read_text()
    committed = tuple(map(int, re.search(TILE, source).groups()))
    variants = [("committed_{}_{}_{}_{}_{}".format(*committed), committed)]
    variants += [("v_{}_{}_{}_{}_{}".format(*t), t) for t in VARIANTS if t != committed]
    for spec in args.extra:
        name, path = spec.split("=", 1)
        variants.append((name, Path(path).read_text()))
    built = build.build_copies({name: variant_source(source, tile) for name, tile in variants},
                               "rwkv6_tiles")

    gen = torch.Generator(device="cuda").manual_seed(0)
    all_ok = True
    for B, H, T, N in SHAPES:
        r, k, v = (torch.randn((B, H, T, N), device="cuda", generator=gen) for _ in range(3))
        w = torch.rand((B, H, T, N), device="cuda", generator=gen) * 0.799 + 0.2
        u = torch.randn((H, N), device="cuda", generator=gen) * 0.5
        s0 = torch.randn((B, H, N, N), device="cuda", generator=gen) * 0.1
        want_o, want_s = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
        rows, fns = [], {}
        for name, tile in variants:
            lib = ctypes.CDLL(str(built[name][0]))
            kernel_cuda._bind(lib)
            state = s0.clone()

            def call(lib=lib, state=state):
                build._LIBS[kernel_cuda.SOURCE] = lib
                return kernel_cuda.rwkv6_scan_cuda(r, k, v, w, u, state, state_out=state)

            got_o, got_s = call()
            err = max(float((got_o - want_o).abs().max()), float((got_s - want_s).abs().max()))
            ok = bool((got_o - want_o).abs().le(TOL + TOL * want_o.abs()).all()
                      and (got_s - want_s).abs().le(TOL + TOL * want_s.abs()).all())
            all_ok &= ok
            row = {"variant": name, "shape": [B, H, T, N]}
            if not isinstance(tile, str):
                kg, warps, chunk, stages, mb = tile
                row.update(key_groups=kg, warps=warps, columns_per_lane=N * kg // 32,
                           keys_per_thread=N // (warps * kg), chunk=chunk, stages=stages,
                           min_ctas_per_sm=mb, smem_bytes=smem_bytes(warps, chunk, stages))
            rows.append({**row, **build.ptxas_report(built[name][1], "rwkv6_scan_kernelIfLi64E"), "max_abs_err": err, "ok": ok,
                         "ms": []})
            if ok:
                fns[name] = call
        calls = 10 if T > 1 else 50
        for _ in range(args.reps):
            for row in rows:
                if row["variant"] in fns:
                    row["ms"].append(device_ms(fns[row["variant"]], ("rwkv6_scan_kernel",),
                                               n=calls))
        for row in rows:
            row["median_ms"] = statistics.median(row["ms"]) if row["ms"] else None
            print(json.dumps(row), flush=True)
        build._LIBS.pop(kernel_cuda.SOURCE, None)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
