#!/usr/bin/env python3
"""Tile sweep of the CUDA RG-LRU scan kernel on one NVIDIA GPU.

    python3 tools/rglru_tiles.py [--reps 7] [--extra NAME=PATH ...]

Builds copies of ``src/repro_torch/csrc/rglru_scan.cu`` in which the f32
`Tile` entry is replaced (kVec channels per lane, kProducers producer
warps, kChunk steps per stage, kStages stages, kMinBlocks CTAs per SM the
registers are budgeted for), all nvcc processes at once with the port's
flags. Each variant runs through the port's wrapper at ``chip_smoke.py``'s
two `RGLRU_SHAPES`, recurrentgemma-2b's prefill (8, 2048, 2560) f32 and a
ragged (3, 1000, 2500) with a given state, and is held to the plain
version within 1e-5 abs/rel (``bit_equal``: states and final state equal
bit for bit). Then every variant of a shape is timed, interleaved round
by round in one process so that they share the card's state: the
kernel's own time on the card per call from a torch.profiler trace (as
``chip_smoke.py``'s ``device_ms``). Prints the card's ``nvidia-smi`` name
and power limit, then one JSON line per variant and shape: ptxas'
registers and spill bytes of its f32 instance, threads and shared memory
per CTA, CTAs at the shape and how many the card holds at once, and the
device ms of each round and the median of those the trace gave (a
profiler trace sometimes loses a kernel's events); last, as a yardstick
of the memory system, `torch.add(la, gx)`, the same bytes streamed. ``--extra NAME=PATH`` adds
another source with the same C interface (an earlier version of the
kernel, or a copy with a part removed), built and timed as it is beside
the variants, also where it disagrees with the plain version; the exit
code is 1 if a `Tile` variant disagrees.
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

# (kVec, kProducers, kChunk, kStages, kMinBlocks); the source's own entry is
# added as "committed".
VARIANTS = [
    (1, 8, 64, 2, 5), (1, 7, 28, 4, 5), (1, 7, 14, 8, 5), (1, 6, 48, 2, 5), (1, 5, 40, 2, 6),
    (1, 4, 64, 2, 5), (1, 4, 32, 2, 8), (2, 8, 64, 2, 3), (2, 7, 56, 2, 3), (2, 7, 28, 4, 3),
]
TILE = (r"struct Tile<float> \{ static constexpr int kVec = (\d+), kProducers = (\d+), "
        r"kChunk = (\d+), kStages = (\d+), kMinBlocks = (\d+); \};")
N_SM = 132
TOL = 1e-5


def smem_bytes(vec: int, chunk: int, stages: int) -> int:
    """The kernel's `Plan::kSmem`."""
    return stages * chunk * 32 * vec * 8 + 2 * stages * 8


def variant_source(source: str, tile) -> str:
    """``source`` with its `Tile<float>` entry replaced by ``tile``, or
    ``tile`` itself when it is the text of another source."""
    if isinstance(tile, str):
        return tile
    text, n = re.subn(TILE, "struct Tile<float> {{ static constexpr int kVec = {}, "
                      "kProducers = {}, kChunk = {}, kStages = {}, kMinBlocks = {}; }};"
                      .format(*tile), source)
    assert n == 1, "no Tile<float> entry in the source"
    return text


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--extra", action="append", default=[], metavar="NAME=PATH",
                    help="another rglru_scan.cu to time beside the variants")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("rglru_tiles: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import RGLRU_SHAPES, device_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.rglru_scan import kernel_cuda, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    source = (build.CSRC / kernel_cuda.SOURCE).read_text()
    committed = tuple(map(int, re.search(TILE, source).groups()))
    variants = [("committed_" + "_".join(map(str, committed)), committed)]
    variants += [("v_" + "_".join(map(str, t)), t) for t in VARIANTS if t != committed]
    for spec in args.extra:
        name, path = spec.split("=", 1)
        variants.append((name, Path(path).read_text()))
    built = build.build_copies({name: variant_source(source, tile) for name, tile in variants},
                               "rglru_tiles")

    gen = torch.Generator(device="cuda").manual_seed(0)
    all_ok = True
    for i, (B, T, D) in enumerate(RGLRU_SHAPES):
        la = -(torch.rand((B, T, D), device="cuda", generator=gen) * 1.999 + 0.001)
        gx = torch.randn((B, T, D), device="cuda", generator=gen)
        h0 = torch.randn((B, D), device="cuda", generator=gen) * 0.3 if i else None
        want_o, want_h = ref.rglru_scan_ref(la, gx, h0)
        timed = []  # (row, call, kernel names)
        for name, tile in variants:
            lib = ctypes.CDLL(str(built[name][0]))
            kernel_cuda._bind(lib)

            def call(lib=lib):
                build._LIBS[kernel_cuda.SOURCE] = lib
                return kernel_cuda.rglru_scan_cuda(la, gx, h0)

            got_o, got_h = call()
            err = max(float((got_o - want_o).abs().max()), float((got_h - want_h).abs().max()))
            ok = bool((got_o - want_o).abs().le(TOL + TOL * want_o.abs()).all()
                      and (got_h - want_h).abs().le(TOL + TOL * want_h.abs()).all())
            all_ok &= ok or isinstance(tile, str)
            row = {"variant": name, "shape": [B, T, D], "h0": h0 is not None}
            if not isinstance(tile, str):
                vec, prod, chunk, stages, mb = tile
                row.update(channels_per_cta=32 * vec, producers=prod, chunk=chunk,
                           stages=stages, min_ctas_per_sm=mb, threads=32 * (prod + 1),
                           smem_bytes=smem_bytes(vec, chunk, stages),
                           ctas=B * -(-D // (32 * vec)), resident_ctas=N_SM * mb)
            row.update(build.ptxas_report(built[name][1], "rglru_scan_kernelIfE"), max_abs_err=err, ok=ok,
                       bit_equal=bool(torch.equal(got_o, want_o) and torch.equal(got_h, want_h)),
                       ms=[])
            timed.append((row, call, ("rglru_scan_kernel",)))
        # A yardstick of the memory system: torch.add(la, gx) moves the same
        # bytes (two reads, one write) in a streaming pattern.
        buf = torch.empty_like(gx)
        timed.append(({"variant": "torch.add (same bytes, streamed)", "shape": [B, T, D],
                       "ms": []}, lambda: torch.add(la, gx, out=buf), ("elementwise_kernel",)))
        for _ in range(args.reps):
            for row, call, names in timed:
                row["ms"].append(device_ms(call, names))
        for row, _, _ in timed:
            got = [ms for ms in row["ms"] if ms is not None]
            row["median_ms"] = statistics.median(got) if got else None
            print(json.dumps(row), flush=True)
        del la, gx, h0, want_o, want_h, buf
        build._LIBS.pop(kernel_cuda.SOURCE, None)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
