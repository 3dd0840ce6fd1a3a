#!/usr/bin/env python3
"""Tile sweep of the CUDA flash-attention kernels on one NVIDIA GPU.

    python3 tools/flash_tiles.py [--backward] [--reps 7] [--head-dims 128,256] [--plain]

Builds copies of a kernel source in which the `Tile` entry of one head_dim
is replaced, all nvcc processes at once with the port's flags, runs each
through the port's wrapper, and times every variant of a shape and one
``scaled_dot_product_attention`` call (a yardstick) by CUDA events,
interleaved round by round in one process so that they share the card's
state. f32, causal.

- forward (default): ``csrc/flash_attention.cu`` (NW warps, BK keys per K/V
  stage, the CTAs per SM the registers are budgeted for) at the two serving
  shapes, qwen3-0.6b's (8, 16 / 8, 1,024, 128) and recurrentgemma-2b's (8,
  10 / 1, 2,048, 256); each variant held to the plain version within 2e-5
  abs/rel.
- ``--backward``: ``csrc/flash_attention_bwd.cu`` (KW warps and BQ query
  rows a stage of the dK/dV kernel, QW warps and BK keys a stage of the dQ
  kernel, JG blocks of P per fresh fragment, kTwoPass) at the two training
  shapes, qwen3-0.6b.train-4k's layer (4, 16 / 8, 4,096, 128) and
  recurrentgemma-2b's local attention (4, 10 / 1, 2,048, 256), from the
  forward kernel's output and log-sum-exp; each variant's gradients held to
  autograd through the plain version within 1e-5 of their largest
  magnitude, and a second call bit-equal. The yardstick is sdpa's backward
  (``enable_gqa``). The shape's line gives the forward's ms with and
  without its log-sum-exp and the bound (5 products in 3 TF32 passes) with
  the design's 7 beside it; with ``--plain`` the plain backward's ms. The
  committed tiles' line adds each kernel's device ms (``torch.profiler``).

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per variant: ptxas' registers and spill bytes of its f32 instances at that
head_dim, shared memory per CTA, the per-call ms of each round and their
median. A variant whose launch is refused gets the error in its line and
is not timed; the sweep goes on.
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

TF32_PEAK = 495e12  # dense TF32, H100 SXM data sheet
# Per direction: the kernel source's name in kernel_cuda, its binder, the
# fields of its `Tile` entry in order, the mangled f32 kernels whose ptxas
# report a line shows, (B, H, KVH, S) per head_dim, the variants (head_dim,
# *tile; the source's own entries are added as "committed"), calls per
# timed round, and the tolerance.
MODES = {
    "forward": dict(
        source="SOURCE", bind="_bind", keys=("NW", "BK", "kMinBlocks"),
        kernels={"kernel": "flash_attention_kernelIfLi{d}E"},
        shapes={128: (8, 16, 8, 1024), 256: (8, 10, 1, 2048)},
        variants=[(128, 8, 32, 1), (128, 4, 32, 2), (128, 4, 16, 3), (128, 8, 16, 2),
                  (256, 4, 32, 1)],
        calls={128: 10, 256: 3}, tol=2e-5),
    "backward": dict(
        source="BWD_SOURCE", bind="_bind_bwd", keys=("KW", "BQ", "QW", "BK", "JG", "kTwoPass"),
        kernels={"dkdv": "flash_bwd_dkdv_kernelIfLi{d}E", "dq": "flash_bwd_dq_kernelIfLi{d}E"},
        shapes={128: (4, 16, 8, 4096), 256: (4, 10, 1, 2048)},
        variants=[(128, 8, 32, 8, 32, 4, 0), (128, 8, 16, 8, 16, 2, 0),
                  (128, 8, 32, 8, 32, 2, 1)],
        calls={128: 2, 256: 2}, tol=1e-5),
}
BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv")


def tile_regex(d: int, keys) -> str:
    return (rf"struct Tile<{d}> {{ static constexpr int "
            + ", ".join(f"{k} = (\\d+)" for k in keys) + "; };")


def variant_source(source: str, d: int, keys, tile) -> str:
    """``source`` with its `Tile<d>` entry replaced."""
    body = ", ".join(f"{k} = {v}" for k, v in zip(keys, tile))
    text, n = re.subn(tile_regex(d, keys),
                      f"struct Tile<{d}> {{ static constexpr int {body}; }};", source)
    assert n == 1, f"no Tile<{d}> entry in the source"
    return text


def smem_bytes(mode: str, d: int, tile):
    """The kernels' shared memory per CTA, as the sources compute it:
    forward `smem_floats` (Q and two K stages in rows of D + 8 floats, two
    V stages in rows of D + 4); backward `dkdv_smem_floats`,
    `dq_smem_floats` (rows of D + 4)."""
    if mode == "forward":
        nw, bk = tile[:2]
        return ((16 * nw + 2 * bk) * (d + 8) + 2 * bk * (d + 4)) * 4
    kw, bq, qw, bk = tile[:4]
    return (((2 * 16 * kw + 4 * bq) * (d + 4) + 4 * bq) * 4,
            (2 * 16 * qw + 4 * bk) * (d + 4) * 4)


def bwd_bound_ms(B, H, S, D, products: int) -> float:
    """``products`` causal products of 2 B H D operations a (query, key)
    pair, in 3 TF32 passes, over the TF32 peak."""
    return 3 * products * 2 * B * H * D * (S * (S + 1) // 2) / TF32_PEAK * 1e3


def events_ms(fn, calls: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(fn, names, calls: int = 3) -> dict:
    """Device time per call of the kernels whose names contain each of
    ``names``, and their sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {n: sum(e.device_time_total for e in prof.key_averages() if n in e.key) / 1e3 / calls
           for n in names}
    return {**out, "sum": sum(out.values())}


def rel_err(got, want) -> float:
    """The largest error of any of ``got`` over its reference's largest
    magnitude."""
    return max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
               for a, b in zip(got, want))


def forward_case(B, H, KVH, S, d, gen, args):
    """(the wrapper call, its check, the yardstick, the shape's line)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel_cuda, ref

    q, k, v = (torch.randn((B, h, S, d), device="cuda", generator=gen) for h in (H, KVH, KVH))
    want = ref.attention_ref(q, k, v)

    def check(call, tol):
        diff = (call().float() - want).abs()
        return float(diff.max()), bool(diff.le(tol + tol * want.abs()).all())

    return (lambda: kernel_cuda.flash_attention_cuda(q, k, v), check,
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
            {})


def backward_case(B, H, KVH, S, d, gen, args):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel_cuda, ref

    q, do = (torch.randn((B, H, S, d), device="cuda", generator=gen) for _ in range(2))
    k, v = (torch.randn((B, KVH, S, d), device="cuda", generator=gen) for _ in range(2))
    fwd = kernel_cuda.flash_attention_cuda
    o, lse = fwd(q, k, v, return_lse=True)
    line = {"forward_ms": {"with_lse": events_ms(lambda: fwd(q, k, v, return_lse=True), 5),
                           "without": events_ms(lambda: fwd(q, k, v), 5)},
            "bound_ms": bwd_bound_ms(B, H, S, d, 5), "design_ms": bwd_bound_ms(B, H, S, d, 7)}
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ref.attention_ref(*ins)
    want = torch.autograd.grad(out, ins, do, retain_graph=args.plain)
    if args.plain:
        line["plain_backward_ms"] = events_ms(
            lambda: torch.autograd.grad(out, ins, do, retain_graph=True), 2)
    del out
    sdpa_out = F.scaled_dot_product_attention(*ins, is_causal=True, enable_gqa=True)
    line["sdpa_max_rel_err"] = rel_err(torch.autograd.grad(sdpa_out, ins, do, retain_graph=True),
                                       want)
    torch.cuda.empty_cache()

    def check(call, tol):
        got = call()
        err = rel_err(got, want)
        return err, err <= tol and all(torch.equal(a, b) for a, b in zip(got, call()))

    return (lambda: kernel_cuda.flash_attention_backward_cuda(do, q, k, v, o, lse), check,
            lambda: torch.autograd.grad(sdpa_out, ins, do, retain_graph=True), line)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backward", action="store_true",
                    help="sweep flash_attention_bwd.cu at the training shapes")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--head-dims", default=None,
                    help="comma-separated head_dims to run (default: both)")
    ap.add_argument("--plain", action="store_true",
                    help="--backward: also time the plain backward")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("flash_tiles: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel_cuda

    mode = "backward" if args.backward else "forward"
    m = MODES[mode]
    source_name, bind = getattr(kernel_cuda, m["source"]), getattr(kernel_cuda, m["bind"])
    shapes = m["shapes"]
    if args.head_dims:
        shapes = {d: shapes[d] for d in map(int, args.head_dims.split(","))}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    source = (build.CSRC / source_name).read_text()
    variants = []
    for d in shapes:
        tile = tuple(map(int, re.search(tile_regex(d, m["keys"]), source).groups()))
        variants.append((f"d{d}_committed_" + "_".join(map(str, tile)), d, tile))
    variants += [(f"d{d}_" + "_".join(map(str, t)), d, tuple(t))
                 for d, *t in m["variants"] if d in shapes]
    built = build.build_copies({name: variant_source(source, d, m["keys"], t)
                                for name, d, t in variants}, f"flash_tiles_{mode}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    all_ok = True
    for d, (B, H, KVH, S) in shapes.items():
        case = backward_case if args.backward else forward_case
        wrapper_call, check, yardstick, line = case(B, H, KVH, S, d, gen, args)
        print(json.dumps({"shape": [B, H, KVH, S, d], **line}), flush=True)
        rows, fns = [], {}
        for name, vd, tile in variants:
            if vd != d:
                continue
            lib = ctypes.CDLL(str(built[name][0]))
            bind(lib)

            def call(lib=lib):
                build._LIBS[source_name] = lib
                return wrapper_call()

            log = built[name][1]
            row = {"variant": name, "shape": [B, H, KVH, S, d], **dict(zip(m["keys"], tile)),
                   "smem_bytes": smem_bytes(mode, d, tile),
                   **{k: build.ptxas_report(log, e.format(d=d)) for k, e in m["kernels"].items()},
                   "ms": []}
            rows.append(row)
            try:
                row["max_err"], row["ok"] = check(call, m["tol"])
            except RuntimeError as e:
                row["error"], row["ok"], all_ok = str(e), False, False
                continue
            all_ok &= row["ok"]
            fns[name] = call  # timed either way: ``ok`` says whether it passed
            if args.backward and "committed" in name:
                row["device_ms"] = device_ms(call, BWD_KERNELS)
        rows.append({"variant": "sdpa", "shape": [B, H, KVH, S, d], "ms": []})
        fns["sdpa"] = yardstick
        for fn in fns.values():  # warm-up
            events_ms(fn, 1)
        for _ in range(args.reps):
            for row in rows:
                if row["variant"] in fns:
                    row["ms"].append(events_ms(fns[row["variant"]], m["calls"][d]))
        for row in rows:
            row["median_ms"] = statistics.median(row["ms"]) if row["ms"] else None
            print(json.dumps(row), flush=True)
        build._LIBS.pop(source_name, None)
        del wrapper_call, check, yardstick, fns
        torch.cuda.empty_cache()
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
