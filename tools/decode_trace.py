#!/usr/bin/env python3
"""Where a call of the CUDA decode-attention kernel spends its time, on one
NVIDIA GPU.

    python3 tools/decode_trace.py

Builds a copy of ``src/repro_torch/csrc/decode_attention.cu`` in which
thread 0 of every CTA writes the card's `%globaltimer` (ns) at fixed points
into a device array: kernel entry, q in shared memory, tiles 0 and 1 in
place, tile 1's logits and softmax done, the split's loop done, before and
after the combine's first cluster barrier, and the output written; and the
time its threads spent waiting on `cp.async` copies. Runs it through the
port's wrapper at the two serving shapes, qwen3-0.6b's (8, 16 / 8, 1,088,
128) with ragged lengths 1,025-1,088 and recurrentgemma-2b's (8, 10 / 1,
2,048, 256) full, f32 q against a bf16 cache, warm and with the L2 flushed
first (a 128 MB buffer zeroed and read back), checks it against the plain
version (2e-5), and prints the card's ``nvidia-smi`` name and power limit,
then one JSON line per shape and state: each point's minimum, median and
maximum over the CTAs in microseconds after the first CTA's entry (the
globaltimer ticks in steps of about 0.26 us on an H100).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SLOTS = 16
POINTS = {0: "entry", 1: "q_in_place", 2: "tile0_in_place", 3: "tile1_in_place",
          4: "tile1_logits", 5: "tile1_softmax", 10: "loop_done", 11: "combine_barrier_in",
          12: "combine_barrier_out", 14: "output_written"}
HEADER = """#include <type_traits>
__device__ unsigned long long g_trace[65536 * 16];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int decode_trace_copy(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}
extern "C" int decode_trace_clear(const void* src) {
  return (int)cudaMemcpyToSymbol(g_trace, src, sizeof(g_trace));
}
#define CTA_ (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))
#define STAMP(i) do { if (threadIdx.x == 0 && CTA_ < 65536) g_trace[CTA_ * 16 + (i)] = gtime(); } while (0)
"""
# (text in the source, text that replaces it); each must occur once.
PROBES = [
    ("  for (int t = 0; t < nt; ++t) {\n    cp_async_wait_at_most",
     "  unsigned long long waited_ = 0;\n  for (int t = 0; t < nt; ++t) {\n    cp_async_wait_at_most"),
    ("#include <type_traits>\n", HEADER),
    ("  const int split = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;\n",
     "  const int split = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;\n  STAMP(0);\n"),
    ("  __syncthreads();  // sQ in place\n", "  __syncthreads();  // sQ in place\n  STAMP(1);\n"),
    ("    cp_async_wait_at_most(p.nst - 2);\n",
     "    const unsigned long long tw0_ = gtime();\n    cp_async_wait_at_most(p.nst - 2);\n"
     "    waited_ += gtime() - tw0_;\n"),
    ("    load_tile(t + p.nst - 1);\n", "    if (t < 2) STAMP(2 + t);\n    load_tile(t + p.nst - 1);\n"),
    ("    __syncthreads();\n\n    // Online softmax",
     "    if (t == 1) STAMP(4);\n    __syncthreads();\n\n    // Online softmax"),
    ("    __syncthreads();\n\n    if constexpr (TC) {\n      // O += P V",
     "    if (t == 1) STAMP(5);\n    __syncthreads();\n\n    if constexpr (TC) {\n      // O += P V"),
    ("  cp_async_wait<0>();\n  __syncthreads();  // every tile consumed",
     "  if (threadIdx.x == 0 && CTA_ < 65536) g_trace[CTA_ * 16 + 15] = waited_;\n"
     "  cp_async_wait<0>();\n  __syncthreads();  // every tile consumed"),
    ("  __syncthreads();  // every tile consumed: the ring is free for the accumulator\n",
     "  __syncthreads();  // every tile consumed: the ring is free for the accumulator\n"
     "  STAMP(10);\n"),
    ("  cluster.sync();  // every split's partial in place\n",
     "  STAMP(11);\n  cluster.sync();  // every split's partial in place\n  STAMP(12);\n"),
    ("      store_out(p.out, out_base + i, sAcc[i] / sL[i / D], p.q_dtype);\n    return;\n",
     "      store_out(p.out, out_base + i, sAcc[i] / sL[i / D], p.q_dtype);\n    STAMP(14);\n"
     "    return;\n"),
    ("  cluster.sync();  // no CTA leaves while another reads its shared memory\n",
     "  STAMP(14);\n  cluster.sync();  // no CTA leaves while another reads its shared memory\n"),
]
SHAPES = ((8, 16, 8, 1088, 128, False), (8, 10, 1, 2048, 256, True))  # B, H, KVH, S, D, full
TOL = 2e-5


def probed_source(text: str) -> str:
    for old, new in PROBES:
        if text.count(old) != 1:
            raise RuntimeError(f"probe point not found once in the source: {old!r}")
        text = text.replace(old, new)
    return text


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("decode_trace: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import kernel_cuda, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    probed = probed_source((build.CSRC / kernel_cuda.SOURCE).read_text())
    lib_path, _ = build.build_copies({"decode_attention_trace": probed},
                                     "decode_trace")["decode_attention_trace"]
    lib = ctypes.CDLL(str(lib_path))
    kernel_cuda._bind(lib)
    build._LIBS[kernel_cuda.SOURCE] = lib
    rng = np.random.default_rng(0)
    flush = torch.empty(32 * 2**20, device="cuda")
    zeros = np.zeros(65536 * SLOTS, np.uint64)
    ok = True
    for B, H, KVH, S, D, full in SHAPES:
        q = torch.from_numpy(rng.normal(0, 1, (B, H, D)).astype(np.float32)).cuda()
        kc, vc = (torch.from_numpy(rng.normal(0, 1, (B, KVH, S, D)).astype(np.float32))
                  .cuda().bfloat16() for _ in range(2))
        lengths_np = (np.full(B, S, np.int32) if full
                      else rng.integers(S - 63, S + 1, size=B).astype(np.int32))
        lengths = torch.from_numpy(lengths_np).cuda()
        want = ref.decode_attention_ref(q, kc, vc, lengths)
        splits = lib.decode_attention_splits(B, H, KVH, S, D, 1)
        n_cta = splits * KVH * B  # one head block at these shapes
        for cold in (False, True):
            for _ in range(3):  # the last of three calls is read
                lib.decode_trace_clear(zeros.ctypes.data_as(ctypes.c_void_p))
                if cold:
                    flush.zero_()
                    flush.sum()
                torch.cuda.synchronize()
                got = kernel_cuda.decode_attention_cuda(q, kc, vc, lengths)
                torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok &= bool((got - want).abs().le(TOL + TOL * want.abs()).all())
            buf = np.zeros(65536 * SLOTS, np.uint64)
            lib.decode_trace_copy(buf.ctypes.data_as(ctypes.c_void_p))
            tr = buf.reshape(65536, SLOTS)[:n_cta].astype(np.float64)
            t0 = tr[:, 0][tr[:, 0] > 0].min()
            row = {"shape": [B, H, KVH, S, D], "lengths": lengths_np.tolist(),
                   "l2": "flushed" if cold else "warm", "splits": splits, "ctas": n_cta,
                   "max_abs_err": err}
            for slot, name in POINTS.items():
                x = tr[:, slot][tr[:, slot] > 0]
                x = (x - t0) / 1e3
                row[name] = ([float(x.min()), float(np.median(x)), float(x.max())]
                             if len(x) else None)
            w = tr[:, 15][tr[:, 0] > 0] / 1e3
            row["copy_wait_us"] = [float(w.min()), float(np.median(w)), float(w.max())]
            print(json.dumps(row), flush=True)
    build._LIBS.pop(kernel_cuda.SOURCE, None)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
