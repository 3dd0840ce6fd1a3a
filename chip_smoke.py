#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the script
exits non-zero; nothing is caught):

1. device   - ``nvidia-smi`` name and power limit (also printed raw, as
              nvidia-smi gives it), torch and CUDA versions.
2. build    - nvcc builds every kernel source of the port at once
              (sm_90a), seconds taken and ptxas' register and spill lines
              per source. flash_attention.cu, decode_attention.cu,
              rwkv6_scan.cu, rglru_scan.cu and auction_phase.cu are rebuilt
              on every run, so their ptxas reports are always read; fails if
              any instance of any of them spills (or a report is missing).
3. kernels  - each kernel against its plain PyTorch version on the card at
              the main path's shapes (exact equality required: tolerance
              0, index mismatches 0; boundary latencies and bid rows with
              planted ties across chunk boundaries), and times: kernel and
              plain version per call by CUDA events (median of 21 runs of 10
              calls, host overhead included), the kernels' own time on the
              card from a torch.profiler trace, and the bound. The
              persistent auction phase is held to the step-wise loop
              (the host loop around the bid kernel) on the round phase's
              full-width instance (1,024 tasks, 12,500 machines), on a
              1,536-task round (the replay's largest bucket, 2,048 padded
              rows), on an 8-task round of the same width and on a price war
              (identical rows in exact mode): price, owner, assignment,
              iterations and bidder rows bit-equal to the loop on the same
              card tensors and to the loop on CPU copies (there the bid is
              its plain PyTorch version, not auction_bid.cu); per solve the
              kernel's ms (events) and device ms (profiler), the loop's ms on
              the card, iterations, us per iteration and the bidder rows
              summed over the iterations. The bound reads each row that
              bids from memory once (the active rows; a re-read of a row
              may hit the L2 and is not charged) and the slot tables once,
              against the bid's BID_OPS operations on every bidder row at
              the f32 rate. Beside it latency_ms: iterations x 2 grid
              barriers, a barrier's cost measured in this run as half the
              device time of an iteration of a price war at 64 machines on
              the same full grid.
4. round    - one full-width round (12,500 machines, 1,024 tasks): the
              cost build on the card against the numpy host reference,
              every field bit-equal. Then the migration path's pieces at
              full width: a window of 4 rounds through `place_window`,
              exogenous slots bit-equal to 4 sequential `auction` `place`
              calls and chained slots to the same calls with the host's
              slot accounting between them (4 costmap and 4 auction_phase
              launches a window); 5 what-if lanes (beta in {0, 100/3600}
              x every / every other mover, and every mover frozen), each
              bit-equal to the lane solved alone and, unmasked, to `place`
              under its params (5 launches of each kernel); the device
              latency oracle's rows for 300 roots bit-equal to the host's
              on a drifting-hotspot and regime-shift plane, at a regime
              boundary and across hotspot steps. Times (host clock, each
              call ending in a read back): the window against the 4
              sequential calls, with the window's host staging and device
              part and the calls' cost builds beside it; the 5 lanes
              against one; the oracle's rows against numpy
              `latency_rows`, and one host decomposition of a root.
5. parity   - a 1,536-machine, 60 s replay with preemption and a machine
              failure on the card and on the CPU: every SimMetrics series
              and summary() equal.
6. full     - the paper's §6 Google cluster, 12,500 machines, 90 s of the
              synthetic workload on the card: rounds, tasks, auction
              iterations, kernel launches (costmap > 0, auction_phase once
              per solve with tasks, auction_bid 0: the bid runs inside the
              phase kernel), wall time, per-round algo_s (p50, p99, max),
              the solver.auction and sim.build_state seconds, us per auction
              iteration, the slowest solves (ms, tasks, padded tasks,
              iterations), peak device memory, the card's busy share over
              the slowest solve (run again: its median host wall time,
              then its device time under torch.profiler), and the
              avg_app_perf_area next to the random baseline's on the same
              workload (paper Fig. 5).
6b. dynamic_parity - the migration controller (device latency oracle,
              what-if lanes, `benchmarks/migration_quality.py`'s settings)
              on the drifting_hotspot scenario, 1,536 machines, 60 s, on
              the card and on the CPU: every SimMetrics series (the
              controller's included), summary(), the counters and the
              controller's audit events equal; then `auction_windowed` with
              the oracle and plain migration rounds on the card equal to
              the `auction` backend with host rows.
6c. dynamic - the §6 Google cluster (12,500 machines), 120 s of the
              synthetic workload at utilisation 0.6 on the drifting_hotspot
              plane, with measured algo_s, twice, both through
              `auction_windowed` and the oracle: ON (the controller, as in
              6b) and OFF (PolicyParams(p_m=105, p_r=110), no controller).
              Each: rounds, controller rounds, lanes, migrations, reverts,
              iterations, launches (auction_phase and costmap once per
              window round and per lane, auction_bid 0), wall, algo_s p50 /
              p99 / max, sim.build_state beside the full phase's, the
              what-if calls' time, the oracle's stats (fails unless its
              floats per round are below M), peak device memory and
              avg_app_perf_area. Fails if ON ran no controller round.
6d. mcmf_parity - the paper's Quincy flow network solved by successive
              shortest paths (`MCMFBackend`, its Bellman-Ford as int32 torch
              scatters on the card), 384 machines in the Google layout (8
              racks of 48), 60 s, NoMora with preemption and migration every
              30 s, fixed_algo_s = 0, on the card and on the CPU: every
              SimMetrics series and summary() equal. Rounds, augmenting
              paths, Bellman-Ford iterations, host syncs, solver.mcmf
              seconds a round.
6e. mcmf_round - one round of the full cluster (12,500 machines, the round
              phase's synthetic state at 64 tasks) through the Quincy graph
              and MCMF on the card and through the exact auction without
              tie jitter: equal objectives, no machine over its free slots.
              Nodes, arcs, graph-build seconds (host), augmentations,
              iterations, solve seconds.
6f. trace   - (a) a `synth_trace` cursor (3,600 s windows) at 1,536
              machines, 60 s, with streaming metrics on the card and on the
              CPU: summaries equal; the cursor with full SimMetrics equal to
              `materialize(cursor)` on the card. (b) the committed Google
              cluster-data v2 fixture through `CsvTraceCursor`, card against
              CPU. (c) the `google_trace` scenario on the 12,500-machine
              cluster, 90 s, measured algo_s: wall, sim.build_state, algo_s
              p50 / p99 from the streaming quantiles, launches, peak device
              memory and the host's ru_maxrss.
6g. serving - (a) the `smoke` serving preset on the card with 8 rounds
              recorded: `verify_replay` 0 mismatches and no kernel built or
              loaded after warm-up; (b) a `ScheduleService` at 12,500
              machines in the Google layout through `auction_windowed` and
              the device latency oracle, 512-task batches, 60 s of arrivals
              at 2 jobs/s (halved once if the queue does not drain): decision
              latency p50 / p99 / mean (wall clock, measured, never
              compared), round wall p50 / p99, busy fraction, queue peak,
              and 0 builds or loads after warm-up (held).
6h. sweep   - a 2-policy (nomora:auction, random) x 2-seed grid at 384
              machines, 60 s, on the card: `run_sweep(workers=2)` (a spawn
              pool, CUDA in each worker) and shards (0, 2) + (1, 2) merged
              equal to one process's run, wall-clock fields dropped.
7. attention_kernels - flash_attention and decode_attention against their
              plain versions on the card at the qwen3-0.6b serving shapes,
              in the dtypes the serving path gives them (f32 prefill;
              f32 query against a bf16 cache in decode) and with bf16
              inputs, then both at head_dim 42 (a small shape: flash
              zero-pads it, decode takes its element path); tolerance 2e-5
              abs/rel when every input is f32 (as
              tests/test_kernels_attention.py: the sums run in another
              order), 2e-2 with bf16 inputs (one bf16 rounding of the
              output). Times as in phase 3, plus library_ms: one
              torch.nn.functional.scaled_dot_product_attention call on the
              same inputs (a yardstick only; the port never calls it).
              Flash's bound_ms with f32 inputs is that of f32-accurate
              products on the tensor cores (3 TF32 passes at 495
              TFLOP/s), with bf16 inputs the bf16 tensor cores' (989
              TFLOP/s); beside it, cuda_core_bound_ms (the bound of the
              kernel's earlier design, f32 CUDA cores at 67 TFLOP/s for
              f32 inputs) and tf32_passes (the TF32 passes per operation
              the kernel takes: 3 for f32 inputs, 1.5 for bf16). Decode
              rows also give device_ms_cold: the kernel's device time with
              the L2 flushed before each call (a 128 MB buffer zeroed and
              read back inside the timed call; neither is counted), as a
              decode step finds the cache after the other layers' weights.
8. serve    - qwen3-0.6b at full width (28 layers, reduce 1), seeded
              float32 parameters and a bf16 cache: 8 requests of 1,024
              prompt tokens, 64 generated (s_max 1,088), through
              ``serve_batch`` on the card. Prefill seconds, decode ms per
              step, tokens/s, peak device memory; launches must be exactly
              28 flash and 28 * 63 decode. The kernels are checked again
              against their plain versions on layer-0 tensors captured
              from this run. The decode profile gives the device time per
              step and decode_attention's device ms per call in it.
9. serve_parity - the same path at reduce 8 with GQA restored (4 query
              heads over 2 KV heads), 2 requests, 64-token prompts, 16
              generated, the same parameters on the card and on the CPU:
              logits within 2e-3 abs/rel at every step (f32 products summed
              in another order; a K/V value may round to the neighbouring
              bf16 step) and the greedy tokens equal.
10. recurrent_kernels - rglru_scan and rwkv6_scan against their plain
              versions on the card: the RG-LRU at recurrentgemma-2b's
              prefill shape (8, 2048, 2560) f32 and at a ragged one with a
              given state, each row with bit_equal (states and final state
              equal to the plain version's bit for bit); RWKV-6 at rwkv6-7b's prefill shape (8, 64, 1024,
              64) f32, at T = 1 with the state given and updated in place
              (its decode step), at a ragged (3, 64, 1000, 64) with a given
              state, and at the prefill shape with the model's decays (w =
              exp(-exp(raw)), raw ~ N(0, 2)) and with r, k, v, w laid out
              as the rwkv block passes them (heads split out of (B, T, H N)
              projections); tolerance 1e-5 (RG-LRU) and 1e-4 (RWKV-6)
              abs/rel, as tests/test_kernels_scans.py. Flash attention at
              recurrentgemma-2b's prefill, (8, 10 / 1, 2048, 256) f32 causal,
              and decode attention at its decode, G = 10, head_dim 256, f32
              query against a bf16 ring cache of 2,048, tolerance 2e-5.
              Times and flash's two bounds as in phase 7; library_ms null
              for the scans (no single PyTorch call computes either
              recurrence).
11. serve_recurrentgemma - recurrentgemma-2b at full width (26 layers,
              d_model 2,560, MQA 10 / 1 heads of 256, window 2,048, V
              256,000), seeded f32 parameters, bf16 K/V and conv history:
              8 requests of 2,048 prompt tokens (the window, exactly), 64
              generated (s_max 2,112: every decode step writes across the
              ring's wrap). Launches exactly 18 rglru_scan, 8 flash and
              8 * 63 decode; measures and checks as phase 8.
12. serve_rwkv - rwkv6-7b at full width (32 layers, d_model 4,096, 64 heads
              of 64, d_ff 14,336, V 65,536), seeded f32 parameters: 8 x
              (1,024 + 64) tokens; launches exactly 32 + 32 * 63 rwkv6_scan.
13. recurrent_parity - each of the two at reduce 8, card against CPU on the
              same parameters, 2 requests, 16 generated (recurrentgemma
              from 160-token prompts, longer than its reduced window of 128,
              so its chunk-pair attention and ring wrap run; rwkv6 from 64):
              greedily with a float32 cache, logits within 2e-3 abs/rel at
              every step and the tokens equal; then ``serve_batch`` with its
              bf16 cache, whose logit difference and token equality are
              reported, not held (a value one f32 bit apart may round to
              the neighbouring bf16 step, and the recurrent states carry
              such steps on: rwkv6 re-rounds whole activation rows, its
              token shifts, at every step).

Then a ``{"kernels": [...]}`` line (one entry per kernel: route, source,
the TPU kernel it replaces, launches in the run of its main path - the
full-width replay for the scheduler's kernels (with the dynamic ON and OFF
replays' and phases 6d-6h's beside them), the qwen3-0.6b serve for
the attention kernels (with the recurrentgemma serve's beside them), the
recurrentgemma and rwkv6 serves for the scans - max abs error and
tolerance, kernel / device / plain / bound / library times at the main
shape) and, last, ``{"ok": true, "device": {...}}``.

Runs from a checkout (it imports ``src/repro_torch``); it needs no JAX and
no network, and exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
SEED = 0
N_REPS = 21
N_PER_REP = 10

MAIN_SHAPE = (1024, 12_500)
COSTMAP_SHAPES = ((1024, 12_500), (8, 12_500))
BID_SHAPES = ((1024, 12_500), (8, 12_500), (2048, 12_500))
# Operations per element, counted from the kernels' arithmetic.
COSTMAP_OPS = 10  # div, rint, 2 clamps, max, div, mul, rint, mul, convert
BID_OPS = 7  # 2 subs, floor max, 2 compares, 2 max/min of the merge

KERNEL_INFO = {
    "costmap": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/costmap.cu",
        "replaces": "src/repro/kernels/costmap/kernel.py:75",
    },
    "auction_bid": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/auction_bid.cu",
        "replaces": "src/repro/kernels/auction_bid/kernel.py:71",
    },
    "auction_phase": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/auction_phase.cu",
        # the bid fused with the reference's while_loop (src/repro/core/auction.py:219)
        "replaces": "src/repro/kernels/auction_bid/kernel.py:71",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
    },
    "decode_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:67",
    },
    "rglru_scan": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:59",
    },
    "rwkv6_scan": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:66",
    },
}
SCHEDULER_KERNELS = ("costmap", "auction_bid", "auction_phase")
# Full-width auction phases: rounds of (tasks, jobs) at 12,500 machines, and
# a price war: PRICE_WAR[0] tasks with identical rows in exact mode, of which
# PRICE_WAR[1] machines are cheapest by one cost unit (one free slot each).
# The barrier probe is the same war at PRICE_WAR[0] machines on the full grid.
PHASE_ROUNDS = ((1024, 300), (1536, 450), (8, 3))
PRICE_WAR = (64, 60)
PHASE_MAX_ITERS = 500_000
# The migration path: a window of 4 full-width rounds, what-if lanes, and
# the dynamic replays under `benchmarks/migration_quality.py`'s controller
# settings on the drifting-hotspot scenario.
WINDOW_ROUNDS = 4
DYNAMIC_SCENARIO = "drifting_hotspot"
QOS = dict(qos_threshold=0.95, qos_window=2, qos_hold_s=30.0)
WHATIF_BETAS = (0.0, 100.0 / 3600.0)
# The rest of the scheduler: the MCMF replay's cluster (the Google layout,
# 8 racks of 48) and the trace cursor's window.
MCMF_PARITY_MACHINES = 384
TRACE_WINDOW_S = 3600
# Sources rebuilt on every run whose ptxas reports must show no spill.
SPILL_GATED = ("flash_attention.cu", "decode_attention.cu", "rwkv6_scan.cu", "rglru_scan.cu",
               "auction_phase.cu")
DECODE_KERNEL = ("decode_attention_kernel",)
L2_FLUSH_BYTES = 128 * 2**20  # more than the H100's 50 MB L2
# A small shape at a head_dim no kernel is compiled for (qwen3-0.6b's at
# --reduce 3): (B, H, KVH, S, D).
ODD_HEAD_DIM_SHAPE = (2, 6, 2, 200, 42)
SERVE_KERNELS = ("flash_attention", "decode_attention", "rglru_scan", "rwkv6_scan")

# The LM serving path: qwen3-0.6b, full width; 8 requests of 1,024 prompt
# tokens and 64 generated ones.
SERVE_ARCH = "qwen3-0.6b"
SERVE_REQUESTS, SERVE_PROMPT, SERVE_GEN = 8, 1024, 64
ATT_TOL = {"f32": 2e-5, "bf16": 2e-2}
PARITY_TOL = 2e-3
# The recurrent serving paths at full width. recurrentgemma-2b's prompts
# fill its 2,048-token window: flash runs at S = 2,048 and every decode step
# writes across the ring's wrap.
RECURRENT_SERVES = {
    "recurrentgemma-2b": dict(phase="serve_recurrentgemma", requests=8, prompt_len=2048,
                              gen=64),
    "rwkv6-7b": dict(phase="serve_rwkv", requests=8, prompt_len=1024, gen=64),
}
RECURRENT_PARITY_PROMPT = {"recurrentgemma-2b": 160, "rwkv6-7b": 64}
SCAN_TOL = {"rglru_scan": 1e-5, "rwkv6_scan": 1e-4}
RGLRU_SHAPES = ((8, 2048, 2560), (3, 1000, 2500))  # (B, T, D): prefill, ragged
RWKV_SHAPE = (8, 64, 1024, 64)  # (B, H, T, N), prefill; decode at T = 1
RWKV_RAGGED = (3, 64, 1000, 64)  # T a multiple of neither the chunk nor the ring
# Operations per element or per state entry, counted from the kernels.
RGLRU_OPS = 8  # 2*la, expm1, negate, sqrt, exp, a*h, mult*gx, add
# RWKV-6 needs 5 per state entry and step: an FMA r*S into o (2), k*v (1)
# and an FMA w*S + kv (2); the bonus sum_i r_i u_i k_i v_j factors out as
# v_j * c_t, one scalar per step and head.
RWKV_OPS = 5
NO_SCAN_LIBRARY = (
    "no single PyTorch call computes either recurrence (a sequential scan "
    "whose decay depends on the data)"
)
NO_LIBRARY = (
    "no single PyTorch call computes a scheduler kernel's function (torch.max has no "
    "runner-up, torch.topk ignores the second slot price; none runs an auction)"
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int = N_REPS, per_rep: int = N_PER_REP, warmup: int = 3) -> float:
    """Per-launch time: CUDA events around ``per_rep`` back-to-back calls,
    divided by ``per_rep``; the median of ``reps`` such runs, after
    ``warmup`` calls. A call's host-side overhead shows where it exceeds the
    work on the card (small shapes)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return float(np.median(times))


def device_ms(fn, kernel_names, n: int = N_PER_REP):
    """Mean time on the card per call of the named CUDA kernels, from a
    torch.profiler trace of ``n`` calls (host overhead excluded); None if
    the trace shows no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if any(k in evt.key for k in kernel_names):
            total_us += getattr(evt, "device_time_total", 0.0) or 0.0
    return total_us / n / 1e3 if total_us else None


def decode_times(q, k_cache, v_cache, lengths) -> dict:
    """Call, warm device and cold device (L2 flushed before each call) ms of
    the decode kernel on these inputs."""
    import torch

    from repro_torch.kernels.decode_attention import kernel_cuda as dec_k

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=q.device)

    def cold():
        flush.zero_()
        flush.sum()  # read back: no dirty line is left for the call to write back
        dec_k.decode_attention_cuda(q, k_cache, v_cache, lengths)

    out = {
        "kernel_ms": time_ms(lambda: dec_k.decode_attention_cuda(q, k_cache, v_cache, lengths)),
        "device_ms": device_ms(lambda: dec_k.decode_attention_cuda(q, k_cache, v_cache, lengths),
                               DECODE_KERNEL),
        "device_ms_cold": device_ms(cold, DECODE_KERNEL),
    }
    del flush
    return out


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {
        "phase": "device",
        "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import KERNELS, build

    # Rebuilt every run: the spill check below reads their ptxas reports.
    for src in SPILL_GATED:
        build.library_path(src).unlink(missing_ok=True)
    t0 = time.perf_counter()
    logs = build.build_all([src for _, _, src in KERNELS])
    seconds = time.perf_counter() - t0
    ptxas = {
        src: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for src, log in logs.items()
    }
    emit({"phase": "build", "seconds": seconds, "built": sorted(logs), "ptxas": ptxas})
    for src in SPILL_GATED:
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", logs[src])
        if not spills or any(n != "0" for pair in spills for n in pair):
            raise AssertionError(f"{src} spills registers (or ptxas gave no report): {spills}")


# --------------------------------------------------------------------- #
# Kernels against their plain versions


def _costmap_inputs(rng, T, M, device):
    import torch

    perf_idx = rng.integers(0, 4, size=T).astype(np.int32)
    lat = rng.uniform(0, 1400, size=(T, M)).astype(np.float32)
    # Boundary latencies: thresholds, the 45 us rounding edge, both ends of
    # the table, below zero, and exact half steps (round half to even).
    edges = np.array(
        [0.0, 39.9, 44.9, 45.0, 45.1, 55.0, 995.0, 1005.0, -3.0, 5.0, 15.0,
         25.0, 1000.0, 1400.0, 199.9, 200.1],
        np.float32,
    )
    lat[:, : len(edges)] = edges
    lat[: min(T, 4), :] = np.resize(edges, M)
    return (
        torch.from_numpy(perf_idx).to(device),
        torch.from_numpy(lat).to(device),
    )


def _bid_inputs(rng, T, C, device, chunk_cols):
    """Integer-valued float32 values and slot prices (price2 >= price1),
    with rows whose best value ties exactly across and inside column
    chunks, a row where every column ties, and price2 == price1 columns."""
    import torch

    values = rng.integers(-(2**20), 0, size=(T, C)).astype(np.float32)
    p1 = rng.integers(0, 2**16, size=C).astype(np.float32)
    p2 = np.maximum(p1, rng.integers(0, 2**17, size=C)).astype(np.float32)
    p2[::7] = p1[::7]
    top = np.float32(2**21)
    for r in range(min(T, 64)):
        a = int(rng.integers(0, C))
        b = (a + chunk_cols * int(rng.integers(1, 4))) % C  # other chunks
        c = min(C - 1, a + 1)  # same chunk
        for j in (a, b, c) if r % 2 else (b, a):
            values[r, j] = p1[j] + top
    values[T - 1, :] = p1 + np.float32(5.0)  # every column ties: index 0
    return tuple(torch.from_numpy(x).to(device) for x in (values, p1, p2))


def phase_kernels() -> dict:
    import torch

    device = "cuda"

    from repro_torch.core import perf_model
    from repro_torch.kernels.auction_bid import kernel_cuda as bid_k
    from repro_torch.kernels.auction_bid import ref as bid_ref
    from repro_torch.kernels.costmap import kernel_cuda as cm_k
    from repro_torch.kernels.costmap import ref as cm_ref

    rng = np.random.default_rng(SEED)
    lut = perf_model.perf_lut_table()
    lut_dev = lut.to(device)
    out = {"costmap": [], "auction_bid": []}

    for T, M in COSTMAP_SHAPES:
        perf_idx, lat = _costmap_inputs(rng, T, M, device)
        got = cm_k.costmap_cuda(lut_dev, perf_idx, lat)
        want = cm_ref.costmap_ref(lut_dev, perf_idx, lat)
        host = cm_ref.costmap_ref(lut, perf_idx.cpu(), lat.cpu())
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max())
        host_mismatch = int((got.cpu() != host).sum())
        nbytes = T * M * 8 + T * 4 + lut.numel() * 4
        b_ms, b_by = bound_ms(nbytes, T * M * COSTMAP_OPS)
        row = {
            "shape": [T, M],
            "max_abs_diff": diff,
            "mismatches": int((got != want).sum()),
            "cpu_plain_mismatches": host_mismatch,
            "kernel_ms": time_ms(lambda: cm_k.costmap_cuda(lut_dev, perf_idx, lat)),
            "device_ms": device_ms(lambda: cm_k.costmap_cuda(lut_dev, perf_idx, lat),
                                   ("costmap_kernel",)),
            "plain_ms": time_ms(lambda: cm_ref.costmap_ref(lut_dev, perf_idx, lat)),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }
        if diff or row["mismatches"] or host_mismatch:
            raise AssertionError(f"costmap kernel disagrees with its plain version: {row}")
        out["costmap"].append(row)

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for T, C in BID_SHAPES:
        default_chunk = bid_k.chunk_columns(T, C, n_sms)
        values, p1, p2 = _bid_inputs(rng, T, C, device, min(default_chunk, 512))
        want = bid_ref.bid_top2_ref(values, p1, p2)
        host = bid_ref.bid_top2_ref(values.cpu(), p1.cpu(), p2.cpu())
        checks = {}
        for label, chunk in (("default", None), ("chunk512", 512)):
            got = bid_k.bid_top2_cuda(values, p1, p2, chunk_cols=chunk)
            torch.cuda.synchronize()
            checks[label] = {
                "index_mismatches": int((got[0] != want[0]).sum()),
                "max_abs_diff": float(
                    max((got[k] - want[k]).abs().max() for k in (1, 2))
                ),
                "cpu_plain_mismatches": int(
                    sum((g.cpu() != h).sum() for g, h in zip(got, host))
                ),
            }
        nbytes = T * C * 4 + 2 * C * 4 + 3 * T * 4
        b_ms, b_by = bound_ms(nbytes, T * C * BID_OPS)
        row = {
            "shape": [T, C],
            "chunk_cols": default_chunk,
            "max_abs_diff": max(c["max_abs_diff"] for c in checks.values()),
            "index_mismatches": sum(c["index_mismatches"] for c in checks.values()),
            "checks": checks,
            "kernel_ms": time_ms(lambda: bid_k.bid_top2_cuda(values, p1, p2)),
            "device_ms": device_ms(lambda: bid_k.bid_top2_cuda(values, p1, p2),
                                   ("bid_chunk_kernel", "bid_merge_kernel")),
            "plain_ms": time_ms(lambda: bid_ref.bid_top2_ref(values, p1, p2)),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }
        if row["max_abs_diff"] or row["index_mismatches"] or any(
            c["cpu_plain_mismatches"] for c in checks.values()
        ):
            raise AssertionError(f"auction_bid kernel disagrees with its plain version: {row}")
        out["auction_bid"].append(row)

    probe = barrier_probe()
    out["auction_phase"] = [
        check_phase(label, args, probe["barrier_us"])
        for label, args in [(f"round_{T}", phase_round_inputs(T, J)) for T, J in PHASE_ROUNDS]
        + [("price_war", price_war_inputs(*PRICE_WAR))]
    ]
    emit({"phase": "kernels", "tolerance": 0, "library_ms_null_because": NO_LIBRARY,
          "barrier_probe": probe, "kernels": out})
    return out


def phase_round_inputs(n_tasks: int, n_jobs: int, device="cuda", n_machines: int = 12_500):
    """The auction phase's inputs (price0, values, value_u, job_col, active)
    of a synthetic full-width round, built as the ``auction`` backend builds
    them: the cost build, then `solve_transportation_device`'s preparation
    (tie jitter 9, unscaled costs)."""
    import torch

    from repro_torch.core import auction, latency, perf_model, policy, topology

    topo = topology.google_topology(n_machines)
    plane = latency.LatencyPlane.synthesize(topo, 4, seed=SEED)
    state = full_width_round_state(topo, plane, n_tasks, n_jobs, 2, SEED)
    T, M, Tp = n_tasks, topo.n_machines, auction._bucket(n_tasks)
    w_m, a, *_ = policy.device_round_costs(
        state, topo, _policy(), perf_model.perf_lut_table().to(device),
        n_pad_tasks=Tp, n_pad_jobs=auction._bucket(n_jobs),
    )
    job_col = np.full(Tp, M, np.int32)
    job_col[:T] = M + state.task_job
    active = torch.from_numpy(np.arange(Tp) < T).to(device)
    vm, vu, price0, _ = auction.prepare_values_step(
        w_m, a, auction._jitter_device(Tp, M, 9, str(torch.device(device))), active,
        torch.from_numpy(state.free_slots.astype(np.int32)).to(device), 1,
        topo.slots_per_machine,
    )
    return price0, vm, vu, torch.from_numpy(job_col).to(device), active


def price_war_inputs(n_tasks: int, n_cheap: int, device="cuda", n_machines: int = 12_500,
                     n_slots: int = 8):
    """A price war: ``n_tasks`` tasks of one job with identical rows, in exact
    mode (costs scaled by T + 1, no jitter); ``n_cheap`` machines cost 10,
    the others 11, and every machine has one free slot. The tasks that find
    no cheap slot raise the cheap slots' prices by eps-sized steps until the
    next level pays as well."""
    import torch

    T, M = n_tasks, n_machines
    cost = np.full(M, 11, np.int64)
    cost[np.linspace(0, M - 1, n_cheap).astype(np.int64)] = 10
    values = np.broadcast_to((-cost * (T + 1)).astype(np.float32), (T, M)).copy()
    price0 = np.full((M, n_slots), np.float32(2.0**40), np.float32)
    price0[:, 0] = 0.0
    host = (price0, values, np.full(T, -1500 * (T + 1), np.float32), np.full(T, M, np.int32),
            np.ones(T, bool))
    return tuple(torch.from_numpy(x).to(device) for x in host)


def phase_bound(args, bidder_rows: int):
    """(bound_ms, bound_by) of a solve: each row that bids read once (every
    active row bids in the first iteration; padded rows never do), the slot
    prices read and price, owner and assignment written once, against
    BID_OPS operations per element of every bidder row."""
    price0, values, _, _, active = args
    Tp, M = values.shape
    n_bytes = (int(active.sum()) * M * 4 + Tp * (4 + 4 + 1 + 4)
               + price0.numel() * (4 + 4 + 4))
    return bound_ms(n_bytes, bidder_rows * M * BID_OPS)


def barrier_probe() -> dict:
    """A grid barrier's cost on the phase kernel's full grid: half the device
    time of an iteration of a price war whose rows are PRICE_WAR[0] machines
    wide (the work of an iteration is a few L2 round trips), launched on as
    many CTAs as can be co-resident."""
    from repro_torch.kernels.auction_phase import kernel_cuda as ph_k
    from repro_torch.kernels.auction_phase import ref as ph_ref

    n = PRICE_WAR[0]
    args = price_war_inputs(n, PRICE_WAR[1], n_machines=n)
    ctas = ph_k.max_ctas()
    got = ph_k.auction_phase_cuda(*args, 1.0, PHASE_MAX_ITERS, ctas=ctas)
    want = ph_ref.auction_phase_ref(*args, 1.0, PHASE_MAX_ITERS)
    if got[3] != want[3] or not all(
        bool((g == w).all()) for g, w in zip(got[:3], want[:3])
    ):
        raise AssertionError("auction_phase disagrees with the step-wise loop on the probe")
    dev = device_ms(lambda: ph_k.auction_phase_cuda(*args, 1.0, PHASE_MAX_ITERS, ctas=ctas),
                    ("auction_phase_kernel",))
    if dev is None:
        raise AssertionError("the profiler shows no device time for the barrier probe")
    return {"shape": list(args[1].shape), "ctas": ctas, "iterations": got[3],
            "device_ms": dev, "barrier_us": dev * 1e3 / got[3] / 2}


def check_phase(label: str, args, barrier_us: float) -> dict:
    """The persistent phase kernel against the step-wise loop on the same
    card tensors and on CPU copies (the plain bid): price, owner, assigned,
    iterations and bidder rows equal (raises otherwise); then its times
    beside the loop's, the bound and the barriers' latency."""
    import torch

    from repro_torch.kernels.auction_phase import kernel_cuda as ph_k
    from repro_torch.kernels.auction_phase import ref as ph_ref

    got = ph_k.auction_phase_cuda(*args, 1.0, PHASE_MAX_ITERS, return_bidder_rows=True)
    want = ph_ref.auction_phase_ref(*args, 1.0, PHASE_MAX_ITERS, return_bidder_rows=True)
    cpu = ph_ref.auction_phase_ref(*(a.cpu() for a in args), 1.0, PHASE_MAX_ITERS,
                                   return_bidder_rows=True)
    torch.cuda.synchronize()
    names = ("price", "owner", "assigned")
    mismatches = {n: int((g != w).sum()) for n, g, w in zip(names, got[:3], want[:3])}
    cpu_mismatches = {n: int((g.cpu() != c).sum()) for n, g, c in zip(names, got[:3], cpu[:3])}
    diff = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got[:3], want[:3]))
    iters, rows = got[3], got[4]
    row = {"label": label, "shape": list(args[1].shape), "slots": int(args[0].shape[1]),
           "max_abs_diff": diff, "mismatches": mismatches, "cpu_mismatches": cpu_mismatches,
           "iterations": iters, "loop_iterations": want[3], "cpu_iterations": cpu[3],
           "bidder_rows": rows, "loop_bidder_rows": want[4], "cpu_bidder_rows": cpu[4]}
    if (diff or any(mismatches.values()) or any(cpu_mismatches.values())
            or not iters == want[3] == cpu[3] or not rows == want[4] == cpu[4]):
        raise AssertionError(f"auction_phase kernel disagrees with the step-wise loop: {row}")
    b_ms, b_by = phase_bound(args, rows)

    def call():
        return ph_k.auction_phase_cuda(*args, 1.0, PHASE_MAX_ITERS)

    def loop():
        return ph_ref.auction_phase_ref(*args, 1.0, PHASE_MAX_ITERS)

    long_war = iters > 1000  # the loop takes seconds a solve there
    row.update(
        kernel_ms=time_ms(call, **(dict(reps=5, per_rep=2) if long_war else {})),
        device_ms=device_ms(call, ("auction_phase_kernel",)),
        plain_ms=time_ms(loop, reps=1 if long_war else 3, per_rep=1, warmup=0 if long_war else 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        latency_ms=iters * 2 * barrier_us / 1e3,
    )
    row["us_per_iteration"] = row["kernel_ms"] * 1e3 / iters
    row["device_us_per_iteration"] = (row["device_ms"] * 1e3 / iters
                                      if row["device_ms"] is not None else None)
    row["plain_us_per_iteration"] = row["plain_ms"] * 1e3 / iters
    return row


# --------------------------------------------------------------------- #
# Rounds and replays


def _policy():
    from repro_torch.core.policy import PolicyParams

    return PolicyParams(p_m=105, p_r=110, preemption=True, beta_scale=1.0)


def full_width_round_state(topo, plane, n_tasks: int, n_jobs: int, t: int, seed: int):
    """A synthetic full-width round: n_tasks tasks of n_jobs jobs rooted on
    random machines, a third of them running (preemption arcs)."""
    from repro_torch.core.policy import RoundState

    rng = np.random.default_rng(seed)
    roots = rng.integers(0, topo.n_machines, size=n_jobs)
    cur = np.full(n_tasks, -1, np.int64)
    run_s = np.zeros(n_tasks, np.float32)
    k = n_tasks // 3
    cur[:k] = rng.integers(0, topo.n_machines, size=k)
    run_s[:k] = rng.uniform(0, 7200, size=k)
    return RoundState(
        task_job=np.sort(rng.integers(0, n_jobs, size=n_tasks)),
        perf_idx=rng.integers(0, 4, size=n_tasks),
        root_machine=roots,
        root_latency=plane.latency_rows(roots, t),
        wait_s=rng.uniform(0, 100, size=n_tasks).astype(np.float32),
        run_s=run_s,
        cur_machine=cur,
        free_slots=rng.integers(0, topo.slots_per_machine + 1, size=topo.n_machines).astype(np.int32),
    )


def _wall_ms(fn, reps: int = 5) -> float:
    """Median host wall time of ``fn`` (which ends in a device-to-host read,
    so in a synchronised state) over ``reps`` runs, after one warm-up run."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def _launches_of(fn) -> dict:
    """The scheduler kernels' launches during one call of ``fn``."""
    from repro_torch import kernels

    kernels.reset_launch_counts()
    fn()
    return {k: kernels.launch_counts()[k] for k in SCHEDULER_KERNELS}


def round_window_check(topo, plane, params, device) -> dict:
    """A window of WINDOW_ROUNDS full-width rounds through `place_window`,
    in both slot modes, against sequential `auction` backend `place` calls
    (exogenous: each round's own free slots; chained: the host's slot
    accounting between the calls, the later rounds' rows as deltas)."""
    from repro_torch.core import policy
    from repro_torch.core import scheduler_backend as sb
    from repro_torch.core.round_program import stack_round_states

    R = WINDOW_ROUNDS
    states = [full_width_round_state(topo, plane, MAIN_SHAPE[0], 300, r, SEED + r)
              for r in range(R)]
    seq = sb.AuctionBackend(params, topo, device=device)
    win = sb.WindowedAuctionBackend(params, topo, device=device)
    ctx = sb.RoundContext(rng=np.random.default_rng(SEED),
                          task_counts=np.zeros(topo.n_machines, np.int64), n_ready=0)
    out = {"rounds": R, "tasks": MAIN_SHAPE[0]}
    # Exogenous slots: bit-equal to R sequential `place` calls.
    want = [seq.place(s, ctx) for s in states]
    got = win.place_window(states)
    if not all(np.array_equal(g.cols, w.cols) and g.objective == w.objective
               for g, w in zip(got, want)):
        raise AssertionError("place_window (exogenous) differs from sequential place calls")
    out["exogenous_launches"] = _launches_of(lambda: win.place_window(states))
    # Chained slots: the later rounds' free slots are deltas on the carry.
    rng = np.random.default_rng(SEED)
    chained = [dataclasses.replace(s) for s in states]
    for s in chained[1:]:
        d = np.zeros(topo.n_machines, np.int32)
        np.add.at(d, rng.integers(0, topo.n_machines, size=200), 1)
        s.free_slots = d
    free = chained[0].free_slots.astype(np.int64)
    want_c = []
    for r, s in enumerate(chained):
        if r:
            free = free + s.free_slots
        p = seq.place(dataclasses.replace(s, free_slots=free.astype(np.int32)), ctx)
        want_c.append(p)
        np.subtract.at(free, p.cols[p.cols < topo.n_machines], 1)
    got_c = win.place_window(chained, chain=True)
    if not all(np.array_equal(g.cols, w.cols) and g.objective == w.objective
               for g, w in zip(got_c, want_c)):
        raise AssertionError("place_window (chained) differs from sequential place calls "
                             "with host slot accounting")
    if (free < 0).any():
        raise AssertionError("chained window oversubscribed a machine")
    out["chained_launches"] = _launches_of(lambda: win.place_window(chained, chain=True))
    for mode in ("exogenous", "chained"):
        n = out[f"{mode}_launches"]
        if device == "cuda" and (n["auction_phase"] != R or n["costmap"] != R
                                 or n["auction_bid"]):
            raise AssertionError(f"{mode} window launches {n}, expected {R} phases")
    out.update(
        bit_equal=["exogenous", "chained"],
        window_ms=_wall_ms(lambda: win.place_window(states)),
        chained_window_ms=_wall_ms(lambda: win.place_window(chained, chain=True)),
        sequential_place_ms=_wall_ms(lambda: [seq.place(s, ctx) for s in states]),
    )
    # Where the window's time goes: host staging (padding and stacking the
    # R rounds), then the rounds on the device with their one read back;
    # beside it the sequential calls' cost builds (staging, upload, costs).
    _, prog = win._program(MAIN_SHAPE[0], 300)

    def stack():
        return stack_round_states(states, n_pad_tasks=prog.n_pad_tasks,
                                  n_pad_jobs=prog.n_pad_jobs)

    window = stack()
    lut = seq.lut

    def cost_builds():
        for s in states:
            policy.device_round_costs(s, topo, params, lut, n_pad_tasks=prog.n_pad_tasks,
                                      n_pad_jobs=prog.n_pad_jobs)
        _sync(device)

    out.update(
        window_stack_ms=_wall_ms(stack),
        window_advance_ms=_wall_ms(
            lambda: prog.advance(prog.init_state(states[0].free_slots), window)),
        sequential_cost_build_ms=_wall_ms(cost_builds),
        iterations=[int(i) for i in prog.advance(
            prog.init_state(states[0].free_slots), window)[1].iterations],
    )
    return out


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def round_whatif_check(topo, plane, params, device) -> dict:
    """WHATIF_LANES lanes of one full-width round: beta in {0, 100/3600} x
    {every mover, every other mover}, plus a lane with every mover frozen
    (the running third of the tasks are the movers). Each lane bit-equal
    to the same lane solved alone; the unmasked lanes also to the
    `auction` backend's `place` under the lane's params."""
    from repro_torch.core import scheduler_backend as sb

    state = full_width_round_state(topo, plane, MAIN_SHAPE[0], 300, 3, SEED + 7)
    T = state.n_tasks
    movers = state.cur_machine >= 0
    every = np.ones(T, bool)
    half = every.copy()
    half[np.nonzero(movers)[0][::2]] = False
    variants, masks = [params], [~movers]  # lane 0: all movers frozen
    for b in (0.0, 100.0 / 3600.0):
        for m in (every, half):
            variants.append(dataclasses.replace(params, beta_scale=b))
            masks.append(m)
    masks = np.stack(masks)
    win = sb.WindowedAuctionBackend(params, topo, device=device)
    ctx = sb.RoundContext(rng=np.random.default_rng(SEED),
                          task_counts=np.zeros(topo.n_machines, np.int64), n_ready=0)
    res, _ = win.whatif_result(state, ctx, variants, active_masks=masks)
    _, prog = win._program(T, state.n_jobs)
    fields = ("assigned", "iterations", "per_task_cost", "per_task_true_cost",
              "per_task_stay_cost")
    for k, (v, m) in enumerate(zip(variants, masks)):
        alone = prog.what_if(state, [v], active_masks=m[None])
        if not all(np.array_equal(getattr(res, f)[k], getattr(alone, f)[0]) for f in fields):
            raise AssertionError(f"what-if lane {k} differs from its lane solved alone")
        if m.all():
            p = sb.AuctionBackend(v, topo, device=device).place(state, ctx)
            if not (np.array_equal(res.variant_cols(k), p.cols)
                    and int(res.per_task_cost[k].astype(np.int64).sum()) == p.objective):
                raise AssertionError(f"what-if lane {k} differs from place under its params")
    if not (res.assigned[0, :T][~movers] >= 0).all():
        raise AssertionError("the all-frozen lane left ready rows unsolved")
    launches = _launches_of(lambda: win.whatif_result(state, ctx, variants, active_masks=masks))
    K = len(variants)
    if device == "cuda" and (launches["auction_phase"] != K or launches["costmap"] != K
                             or launches["auction_bid"]):
        raise AssertionError(f"what-if launches {launches}, expected {K} phases")
    return {
        "lanes": K, "tasks": T, "movers": int(movers.sum()), "bit_equal": True,
        "iterations": [int(i) for i in res.iterations],
        "lane_outcomes": [int(x) for x in res.lane_outcomes()],
        "launches": launches,
        "lanes_ms": _wall_ms(lambda: win.whatif_result(state, ctx, variants,
                                                        active_masks=masks)),
        "one_lane_ms": _wall_ms(lambda: prog.what_if(state, variants[1:2])),
    }


def oracle_plane(topo, duration_s: int):
    """A drifting rack hotspot (two racks wide, 4x, one rack every 2 s)
    and two regime shifts, seed SEED."""
    from repro_torch.core import latency

    ev = latency.LatencyEvents(
        hotspots=(latency.DriftingHotspot(start_s=4.0, end_s=duration_s - 4.0, rack0=0,
                                          drift_racks_per_s=0.5, width_racks=2,
                                          multiplier=4.0),),
        regime=latency.RegimeSchedule(times=(10.0, 20.0), frac=0.5),
    )
    return latency.LatencyPlane.synthesize(topo, duration_s, seed=SEED, events=ev)


def oracle_rows_check(topo, device) -> dict:
    """Oracle rows bit-equal to `plane.latency_rows` at 12,500 machines, at
    a regime boundary and across hotspot steps; their times beside the
    host's."""
    from repro_torch.core import latency_device

    plane = oracle_plane(topo, 30)
    oracle = latency_device.DeviceLatencyOracle(plane, device=device)
    roots = np.random.default_rng(SEED).integers(0, topo.n_machines, size=300)
    times = (3, 4, 5, 9, 10, 11, 20)  # hotspot start and steps; shifts at 10 and 20
    for t in times:
        got = oracle.root_rows(roots, t).cpu().numpy()
        if not np.array_equal(got, plane.latency_rows(roots, t)):
            raise AssertionError(f"oracle rows differ from the host's at t={t}")

    def rows():
        oracle.root_rows(roots, 11)
        _sync(device)

    # A root seen for the first time (or in a new regime epoch) costs one
    # host decomposition, hashed in numpy over all M machines.
    return {"roots": len(roots), "times": list(times), "bit_equal": True,
            "oracle_rows_ms": _wall_ms(rows), "host_rows_ms": _wall_ms(
                lambda: plane.latency_rows(roots, 11), reps=3),
            "decomposition_ms": _wall_ms(lambda: plane.row_decomposition(7, 1)),
            "stats": oracle.stats()}


def phase_round(device="cuda", n_machines: int = 12_500) -> dict:
    from repro_torch.core import auction, latency, perf_model, policy, topology

    topo = topology.google_topology(n_machines)
    plane = latency.LatencyPlane.synthesize(topo, 4, seed=SEED)
    state = full_width_round_state(topo, plane, MAIN_SHAPE[0], 300, 2, SEED)
    params = _policy()
    lut = perf_model.perf_lut_table()
    host = policy.dense_costs(state, topo, params, lut)
    dev = policy.dense_costs_device(state, topo, params, lut, device=device)
    fields = {}
    for f in ("w", "col_capacity", "d", "c_rack", "b", "a"):
        h = getattr(host, f)
        d = getattr(dev, f).cpu().numpy()
        if h.shape != d.shape or h.dtype != d.dtype or not np.array_equal(h, d):
            raise AssertionError(f"full-width round: field {f} differs from the host reference")
        fields[f] = list(h.shape)
    w_m, a, *_ = policy.device_round_costs(
        state, topo, params, lut.to(device),
        n_pad_tasks=auction._bucket(state.n_tasks), n_pad_jobs=auction._bucket(state.n_jobs),
    )
    res = auction.solve_transportation_device(
        w_m, a, state.n_tasks, state.free_slots, topo.n_machines, state.task_job,
        slots_per_machine=topo.slots_per_machine, tie_jitter=9, exact=False,
        cost_bound=20_000,
    )
    cols = res.assigned_col
    placed = cols[cols < topo.n_machines]
    over = np.bincount(placed, minlength=topo.n_machines) > state.free_slots
    if over.any():
        raise AssertionError("full-width round oversubscribed a machine")
    info = {"phase": "round", "machines": n_machines, "tasks": state.n_tasks,
            "jobs": state.n_jobs, "fields_equal": fields,
            "placed": int(len(placed)), "iterations": res.iterations,
            "total_cost": res.total_cost,
            "window": round_window_check(topo, plane, params, device),
            "whatif": round_whatif_check(topo, plane, params, device),
            "oracle": oracle_rows_check(topo, device)}
    emit(info)
    return info


def replay(topo, duration_s: int, device: str, backend: str = "auction", *,
           failures=(), fixed_algo_s=None):
    from repro_torch import obs
    from repro_torch.core import latency, simulator, workload

    plane = latency.LatencyPlane.synthesize(topo, duration_s, seed=SEED)
    wl = workload.synth_workload(topo, duration_s, seed=SEED, target_utilisation=0.6)
    cfg = simulator.SimConfig(
        policy="nomora", backend=backend, device=device, seed=SEED,
        params=_policy(), migration_interval_s=30, failures=failures,
        fixed_algo_s=fixed_algo_s,
    )
    with obs.scope() as tel:
        sim = simulator.Simulator(wl, plane, cfg)
        t0 = time.perf_counter()
        metrics = sim.run()
        wall = time.perf_counter() - t0
        counters = obs.counters()
        spans: dict = {}
        for rec in tel.spans:  # host wall time by span name
            spans[rec.name] = spans.get(rec.name, 0.0) + rec.dur_ns * 1e-9
    counters["spans_s"] = spans
    return sim, metrics, wall, counters


SERIES = ("algo_runtime_s", "placement_latency_s", "response_time_s",
          "migrated_pct_per_round", "per_job_perf")
SCALARS = ("tasks_placed", "tasks_migrated", "rounds")


def phase_parity(device="cuda", n_machines: int = 1536, duration_s: int = 60) -> dict:
    from repro_torch.core.topology import Topology

    topo = Topology(n_machines, 48, 16, slots_per_machine=8)
    kw = dict(failures=((20, 7),), fixed_algo_s=0.0)
    _, card, card_s, _ = replay(topo, duration_s, device, **kw)
    _, cpu, cpu_s, _ = replay(topo, duration_s, "cpu", **kw)
    diffs = [f for f in SERIES + SCALARS if getattr(card, f) != getattr(cpu, f)]
    sa, sb = card.summary(), cpu.summary()
    diffs += [k for k in sa if not (sa[k] == sb[k] or (np.isnan(sa[k]) and np.isnan(sb[k])))]
    if diffs:
        raise AssertionError(f"parity replay: card and CPU differ in {diffs}")
    info = {"phase": "parity", "machines": n_machines, "duration_s": duration_s,
            "rounds": card.rounds, "tasks_placed": card.tasks_placed,
            "tasks_migrated": card.tasks_migrated, "card_wall_s": card_s,
            "cpu_wall_s": cpu_s, "equal": list(SERIES + SCALARS) + ["summary"]}
    emit(info)
    return info


class _Solves:
    """Wraps `auction.solve_transportation_device`: counts the solves that
    have tasks and keeps the arguments of the slowest one (host clock; the
    solve ends in a device-to-host read). Its cost tensors are kept as they
    are (a round never writes them again), host arrays copied."""

    def __init__(self, fn):
        self.fn, self.n, self.slowest_s, self.slowest = fn, 0, -1.0, None
        self.log = []  # (ms, tasks, padded tasks, iterations) of each solve with tasks

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        res = self.fn(*args, **kw)
        dt = time.perf_counter() - t0
        if args[2] > 0:  # n_tasks
            self.n += 1
            self.log.append((dt * 1e3, int(args[2]), int(args[0].shape[0]), res.iterations))
            if dt > self.slowest_s:
                self.slowest_s = dt
                self.slowest = ([a.copy() if isinstance(a, np.ndarray) else a for a in args],
                                dict(kw))
        return res


def solve_busy_share(args, kw, reps: int = 5) -> dict:
    """One round's solve run again: its host wall time (median of ``reps``
    runs, each ending synchronised), then once under torch.profiler (CPU and
    CUDA) for the card's busy time (every device event: kernels, copies,
    fills; they run on one stream), its share of the unprofiled wall time,
    and the host operations that took the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import auction

    walls = []
    for _ in range(reps + 1):  # the first run warms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = auction.solve_transportation_device(*args, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls[1:]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        auction.solve_transportation_device(*args, **kw)
        torch.cuda.synchronize()
    busy_us, kernels, host = 0.0, {}, {}
    for evt in prof.key_averages():
        dev = getattr(evt, "device_time_total", 0.0) or 0.0
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            if dev > 0:
                busy_us += dev
                kernels[evt.key[:60]] = dev / 1e3
        elif evt.self_cpu_time_total > 0:
            host[evt.key[:60]] = (evt.self_cpu_time_total / 1e3, evt.count)
    busy_ms = busy_us / 1e3
    return {"tasks": int(args[2]), "iterations": res.iterations, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "device_ms_by_kernel": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6]),
            "profiled_host_ms_calls": dict(sorted(host.items(), key=lambda kv: -kv[1][0])[:8])}


def phase_full(device="cuda", n_machines: int = 12_500, duration_s: int = 90) -> dict:
    import torch

    from repro_torch import kernels
    from repro_torch.core import auction
    from repro_torch.core.topology import google_topology

    topo = google_topology(n_machines)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    solves = _Solves(auction.solve_transportation_device)
    auction.solve_transportation_device = solves
    try:
        kernels.reset_launch_counts()
        sim, m, wall, counters = replay(topo, duration_s, device)
        launches = {k: kernels.launch_counts()[k] for k in SCHEDULER_KERNELS}
    finally:
        auction.solve_transportation_device = solves.fn
    iters = int(counters.get("auction.iterations", 0))
    algo = np.asarray(m.algo_runtime_s, np.float64)
    if not (m.rounds > 0 and m.tasks_placed > 0 and np.isfinite(algo).all()):
        raise AssertionError("full-width replay produced no rounds or non-finite times")
    if (sim.free_slots < 0).any() or (sim.free_slots > topo.slots_per_machine).any():
        raise AssertionError("full-width replay broke slot accounting")
    # On the card every solve with tasks is one launch of the phase kernel,
    # which runs the bid inside it: the bid kernel itself never launches.
    if on_card and not (launches["costmap"] > 0 and solves.n > 0
                        and launches["auction_phase"] == solves.n
                        and launches["auction_bid"] == 0):
        raise AssertionError(f"kernel launches {launches} vs {solves.n} solves with tasks")
    busy = solve_busy_share(*solves.slowest) if on_card else None
    slowest_solves = sorted(solves.log, reverse=True)[:8]
    del solves
    _, rnd, rnd_wall, _ = replay(topo, duration_s, device, backend="random")
    summ = m.summary()
    spans = counters["spans_s"]
    info = {
        "phase": "full",
        "machines": n_machines,
        "duration_s": duration_s,
        "rounds": m.rounds,
        "tasks_placed": m.tasks_placed,
        "tasks_migrated": m.tasks_migrated,
        "auction_iterations": iters,
        "solves_with_tasks": launches["auction_phase"] if on_card else None,
        "launches": launches,
        "wall_s": wall,
        "algo_s_p50": float(np.median(algo)),
        "algo_s_p99": float(np.percentile(algo, 99)),
        "algo_s_max": float(algo.max()),
        "algo_s_sum": float(algo.sum()),
        "solver_auction_s": spans.get("solver.auction", 0.0),
        "sim_build_state_s": spans.get("sim.build_state", 0.0),
        "us_per_auction_iteration": spans.get("solver.auction", 0.0) * 1e6 / max(iters, 1),
        "slowest_solves_ms_tasks_padded_iterations": slowest_solves,
        "slowest_solve_profile": busy,
        "spans_s": spans,
        "max_memory_allocated": int(torch.cuda.max_memory_allocated()) if on_card else None,
        "avg_app_perf_area": summ["avg_app_perf_area"],
        "random_avg_app_perf_area": rnd.summary()["avg_app_perf_area"],
        "random_wall_s": rnd_wall,
    }
    emit(info)
    return info


# --------------------------------------------------------------------- #
# The migration path (paper §7): controller, what-if lanes, device oracle


def scenario_replay(topo, duration_s: int, device: str, mode: str, *,
                    backend: str = "auction_windowed", oracle: bool = True,
                    fixed_algo_s=None):
    """A replay of DYNAMIC_SCENARIO's plane over ``synth_workload(0.6,
    seed SEED)``. ``mode``: ``"on"`` the migration controller with
    `benchmarks/migration_quality.py`'s settings (the scenario's params and
    cadence, QoS threshold 0.95, window 2, hold 30 s, what-if betas);
    ``"off"`` that benchmark's OFF (PolicyParams(p_m=105, p_r=110), no
    controller); ``"migrate"`` the scenario's params and cadence with
    plain migration rounds. Returns (sim, metrics, wall s, counters with
    span seconds and counts, launches, audit events)."""
    from repro_torch import kernels, obs
    from repro_torch.core import latency, policy, scenarios, simulator, workload

    scn = scenarios.get_scenario(DYNAMIC_SCENARIO)
    plane = scn.plane(latency.LatencyPlane.synthesize(topo, duration_s, seed=SEED), duration_s)
    wl = workload.synth_workload(topo, duration_s, seed=SEED, target_utilisation=0.6)
    if mode == "off":
        kw = dict(params=policy.PolicyParams(p_m=105, p_r=110))
    else:
        kw = dict(params=scn.policy_params(p_m=105, p_r=110),
                  **scn.sim_config_kwargs(topo, duration_s, SEED))
        if mode == "on":
            kw.update(migration_controller=True, whatif_betas=WHATIF_BETAS, **QOS)
    cfg = simulator.SimConfig(policy="nomora", backend=backend, device=device, seed=SEED,
                              device_latency=oracle, fixed_algo_s=fixed_algo_s, **kw)
    with obs.scope() as tel:
        sim = simulator.Simulator(wl, plane, cfg)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = sim.run()
        wall = time.perf_counter() - t0
        launches = {k: kernels.launch_counts()[k] for k in SCHEDULER_KERNELS}
        counters = obs.counters()
        spans, n_spans = {}, {}
        for rec in tel.spans:
            spans[rec.name] = spans.get(rec.name, 0.0) + rec.dur_ns * 1e-9
            n_spans[rec.name] = n_spans.get(rec.name, 0) + 1
        audit = [{k: v for k, v in e.items() if k != "algo_s"} for e in tel.audit]
    counters["spans_s"], counters["span_counts"] = spans, n_spans
    return sim, metrics, wall, counters, launches, audit


CONTROLLER_SERIES = ("controller_improvement_per_round", "degraded_jobs_per_round")
CONTROLLER_SCALARS = ("controller_rounds",)


def _metric_diffs(a, b) -> list:
    fields = SERIES + SCALARS + CONTROLLER_SERIES + CONTROLLER_SCALARS
    diffs = [f for f in fields if getattr(a, f) != getattr(b, f)]
    sa, sb = a.summary(), b.summary()
    return diffs + [k for k in sa
                    if not (sa[k] == sb[k] or (np.isnan(sa[k]) and np.isnan(sb[k])))]


def phase_dynamic_parity(device="cuda", n_machines: int = 1536, duration_s: int = 60) -> dict:
    """The controller with the oracle and what-if lanes, card against CPU:
    every SimMetrics series (the controller's included), summary(), the
    counters and the controller's audit events equal; then the windowed
    backend fed by the oracle without the controller against the
    ``auction`` backend with host rows, on the card."""
    from repro_torch.core.topology import Topology

    topo = Topology(n_machines, 48, 16, slots_per_machine=8)
    _, card, card_s, cc, card_launches, ca = scenario_replay(topo, duration_s, device, "on",
                                                             fixed_algo_s=0.0)
    _, cpu, cpu_s, pc, _, pa = scenario_replay(topo, duration_s, "cpu", "on",
                                               fixed_algo_s=0.0)
    diffs = _metric_diffs(card, cpu)
    strip = ("spans_s", "span_counts")
    if {k: v for k, v in cc.items() if k not in strip} != {
            k: v for k, v in pc.items() if k not in strip}:
        diffs.append("counters")
    if ca != pa:
        diffs.append("audit")
    if diffs:
        raise AssertionError(f"dynamic parity: card and CPU differ in {diffs}")
    if card.controller_rounds == 0:
        raise AssertionError("dynamic parity: the controller never ran")
    _, win, win_s, _, _, _ = scenario_replay(topo, duration_s, device, "migrate",
                                             fixed_algo_s=0.0)
    _, host, host_s, _, _, _ = scenario_replay(topo, duration_s, device, "migrate",
                                               backend="auction", oracle=False,
                                               fixed_algo_s=0.0)
    diffs = _metric_diffs(win, host)
    if diffs:
        raise AssertionError(f"windowed + oracle differs from auction + host rows in {diffs}")
    info = {"phase": "dynamic_parity", "machines": n_machines, "duration_s": duration_s,
            "scenario": DYNAMIC_SCENARIO, "rounds": card.rounds,
            "controller_rounds": card.controller_rounds, "lanes": cc.get("whatif.lanes", 0),
            "tasks_migrated": card.tasks_migrated, "audit_events": len(ca),
            "launches": card_launches, "card_wall_s": card_s, "cpu_wall_s": cpu_s,
            "equal": list(SERIES + SCALARS + CONTROLLER_SERIES + CONTROLLER_SCALARS)
            + ["summary", "counters", "audit"],
            "no_controller": {"rounds": win.rounds, "tasks_migrated": win.tasks_migrated,
                              "windowed_oracle_wall_s": win_s, "auction_host_rows_wall_s": host_s,
                              "equal": True}}
    emit(info)
    return info


def phase_dynamic(device="cuda", n_machines: int = 12_500, duration_s: int = 120,
                  full: dict | None = None) -> dict:
    """The paper's §6 Google cluster under DYNAMIC_SCENARIO's drifting
    hotspot, ON (the controller) and OFF, both with the device oracle and
    measured algo_s."""
    import torch

    from repro_torch.core.topology import google_topology

    topo = google_topology(n_machines)
    on_card = device == "cuda"
    out = {"phase": "dynamic", "machines": n_machines, "duration_s": duration_s,
           "scenario": DYNAMIC_SCENARIO}
    for mode in ("on", "off"):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sim, m, wall, c, launches, audit = scenario_replay(topo, duration_s, device, mode)
        algo = np.asarray(m.algo_runtime_s, np.float64)
        if not (m.rounds > 0 and m.tasks_placed > 0 and np.isfinite(algo).all()):
            raise AssertionError(f"dynamic {mode}: no rounds or non-finite times")
        if (sim.free_slots < 0).any() or (sim.free_slots > topo.slots_per_machine).any():
            raise AssertionError(f"dynamic {mode}: slot accounting broken")
        solves = int(c.get("window.rounds", 0))
        lanes = int(c.get("whatif.lanes", 0))
        if on_card and not (launches["auction_phase"] == solves + lanes
                            and launches["costmap"] == solves + lanes
                            and launches["auction_bid"] == 0):
            raise AssertionError(f"dynamic {mode}: launches {launches} vs {solves} solves "
                                 f"and {lanes} lane solves")
        st = sim.oracle.stats()
        if not st["floats_per_round"] < n_machines:
            raise AssertionError(f"dynamic {mode}: oracle uploads {st['floats_per_round']} "
                                 f"floats a round, not below M = {n_machines}")
        spans, counts = c["spans_s"], c["span_counts"]
        row = {
            "rounds": m.rounds, "controller_rounds": m.controller_rounds,
            "solves": solves, "lanes": lanes, "tasks_placed": m.tasks_placed,
            "tasks_migrated": m.tasks_migrated,
            "controller_reverts": int(c.get("controller.reverts", 0)),
            "qos_triggers": int(c.get("qos.triggers", 0)),
            "auction_iterations": int(c.get("auction.iterations", 0)),
            "launches": launches, "wall_s": wall,
            "algo_s_p50": float(np.median(algo)),
            "algo_s_p99": float(np.percentile(algo, 99)),
            "algo_s_max": float(algo.max()),
            "sim_build_state_s": spans.get("sim.build_state", 0.0),
            "full_sim_build_state_s": None if full is None else full["sim_build_state_s"],
            "whatif_s": spans.get("round_program.whatif", 0.0),
            "whatif_calls": counts.get("round_program.whatif", 0),
            "whatif_ms_per_call": (spans.get("round_program.whatif", 0.0) * 1e3
                                   / max(counts.get("round_program.whatif", 0), 1)),
            "advance_s": spans.get("round_program.advance", 0.0),
            "spans_s": spans,
            "oracle": st,
            "max_memory_allocated": int(torch.cuda.max_memory_allocated()) if on_card else None,
            "avg_app_perf_area": m.summary()["avg_app_perf_area"],
            "audit_events": len(audit),
        }
        out[mode] = row
    if out["on"]["controller_rounds"] == 0:
        raise AssertionError("dynamic: no controller round ran")
    emit(out)
    return out


# --------------------------------------------------------------------- #
# The rest of the scheduler: MCMF, trace replay with streaming metrics,
# the online ScheduleService, sweeps


def _summary_diffs(a: dict, b: dict) -> list:
    if a.keys() != b.keys():
        return ["<keys>"]
    return [k for k in a if not (a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])))]


def _counted(fn):
    """``fn()`` under fresh telemetry and launch counts: (its result, the
    counters with host seconds by span name under "spans_s", the scheduler
    kernels' launches)."""
    from repro_torch import kernels, obs

    with obs.scope() as tel:
        kernels.reset_launch_counts()
        out = fn()
        launches = {k: kernels.launch_counts()[k] for k in SCHEDULER_KERNELS}
        counters = obs.counters()
        spans: dict = {}
        for rec in tel.spans:
            spans[rec.name] = spans.get(rec.name, 0.0) + rec.dur_ns * 1e-9
    counters["spans_s"] = spans
    return out, counters, launches


def phase_mcmf_parity(device="cuda", n_machines: int = MCMF_PARITY_MACHINES,
                      duration_s: int = 60) -> dict:
    """The Quincy graph and MCMF (its Bellman-Ford on ``device``) in a
    replay with preemption and migration every 30 s, card against CPU:
    every SimMetrics series and summary() equal."""
    from repro_torch.core.topology import google_topology

    topo = google_topology(n_machines)
    runs = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        (_, m, _, _), c, launches = _counted(
            lambda dev=dev: replay(topo, duration_s, dev, backend="mcmf", fixed_algo_s=0.0))
        runs[dev] = (m, time.perf_counter() - t0, c, launches)
    (card, card_s, c, launches), (cpu, cpu_s, _, _) = runs[device], runs["cpu"]
    diffs = [f for f in SERIES + SCALARS if getattr(card, f) != getattr(cpu, f)]
    diffs += _summary_diffs(card.summary(), cpu.summary())
    if diffs or card.rounds == 0:
        raise AssertionError(f"mcmf_parity: card and CPU differ in {diffs} "
                             f"(rounds {card.rounds})")
    solver_s = c["spans_s"].get("solver.mcmf", 0.0)
    info = {"phase": "mcmf_parity", "machines": n_machines, "duration_s": duration_s,
            "rounds": card.rounds, "tasks_placed": card.tasks_placed,
            "tasks_migrated": card.tasks_migrated,
            "augmenting_paths": int(c.get("mcmf.augmentations", 0)),
            "bf_iterations": int(c.get("mcmf.bf_iterations", 0)),
            "host_syncs": int(c.get("mcmf.host_syncs", 0)),
            "solver_mcmf_s": solver_s, "solver_mcmf_s_per_round": solver_s / card.rounds,
            "card_wall_s": card_s, "cpu_wall_s": cpu_s, "launches": launches,
            "equal": list(SERIES + SCALARS) + ["summary"]}
    emit(info)
    return info


def phase_mcmf_round(device="cuda", n_machines: int = 12_500, n_tasks: int = 64,
                     n_jobs: int = 19) -> dict:
    """One full-cluster round (the round phase's synthetic state at
    ``n_tasks``) through the paper's Quincy graph and MCMF on ``device``
    and through the exact auction (no tie jitter): equal objectives, no
    machine over its free slots."""
    from repro_torch.core import flow_network, latency, mcmf, perf_model, scheduler_backend
    from repro_torch.core.policy import dense_costs
    from repro_torch.core.topology import google_topology

    topo = google_topology(n_machines)
    plane = latency.LatencyPlane.synthesize(topo, 4, seed=SEED)
    state = full_width_round_state(topo, plane, n_tasks, n_jobs, 2, SEED)
    params, lut = _policy(), perf_model.perf_lut_table()
    ctx = scheduler_backend.RoundContext(rng=np.random.default_rng(SEED),
                                         task_counts=np.zeros(n_machines, np.int64),
                                         n_ready=n_tasks)
    costs = dense_costs(state, topo, params, lut)
    t0 = time.perf_counter()
    g = flow_network.build_flow_graph(state, topo, params, costs)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (fr, c, _) = _counted(lambda: mcmf.min_cost_max_flow(
        g.src, g.dst, g.cap, g.cost, g.source, g.sink, g.n_nodes, device=device))
    solve_s = time.perf_counter() - t0
    backend = scheduler_backend.MCMFBackend(params, topo, lut, device=device)
    p_mcmf = backend.place(state, ctx)
    exact = scheduler_backend.AuctionBackend(params, topo, lut, tie_jitter=0, exact=True,
                                             device=device)
    t0 = time.perf_counter()
    (p_auc, ca, launches) = _counted(lambda: exact.place(state, ctx))
    auction_s = time.perf_counter() - t0
    if not (p_mcmf.objective == p_auc.objective == fr.total_cost
            and fr.total_flow == n_tasks):
        raise AssertionError(f"mcmf_round: objectives {p_mcmf.objective} (mcmf) vs "
                             f"{p_auc.objective} (exact auction), flow {fr.total_flow}")
    for name, p in (("mcmf", p_mcmf), ("auction", p_auc)):
        on = p.cols[(p.cols >= 0) & (p.cols < n_machines)]
        if (np.bincount(on, minlength=n_machines) > state.free_slots).any():
            raise AssertionError(f"mcmf_round: {name} overfills a machine")
    info = {"phase": "mcmf_round", "machines": n_machines, "tasks": n_tasks, "jobs": n_jobs,
            "nodes": g.n_nodes, "arcs": int(len(g.src)), "graph_build_s": build_s,
            "augmenting_paths": int(c.get("mcmf.augmentations", 0)),
            "bf_iterations": int(c.get("mcmf.bf_iterations", 0)),
            "host_syncs": int(c.get("mcmf.host_syncs", 0)), "solve_s": solve_s,
            "objective": int(p_mcmf.objective), "exact_auction_s": auction_s,
            "exact_auction_iterations": int(ca.get("auction.iterations", 0)),
            "launches": launches, "objectives_equal": True}
    emit(info)
    return info


def _trace_replay(topo, cursor, duration_s: int, device: str, **cfg):
    from repro_torch.core import latency, simulator

    plane = latency.LatencyPlane.synthesize(topo, duration_s, seed=SEED)
    config = simulator.SimConfig(policy="nomora", seed=SEED, device=device, **cfg)
    sim = simulator.Simulator(cursor, plane, config)
    t0 = time.perf_counter()
    metrics = sim.run()
    return sim, metrics, time.perf_counter() - t0


def phase_trace(device="cuda", n_machines: int = 1536, duration_s: int = 60,
                full_machines: int = 12_500, full_duration_s: int = 90) -> dict:
    """(a) A `synth_trace` cursor with streaming metrics, card against CPU
    (equal summaries), and the cursor's replay with full SimMetrics against
    the replay of `materialize(cursor)`, both on the card (equal series);
    (b) the committed cluster-data v2 fixture through `CsvTraceCursor`,
    card against CPU; (c) the `google_trace` scenario at the full cluster
    on the card: wall, sim.build_state, algo_s quantiles from the streaming
    metrics, memory."""
    import resource

    import torch

    from repro_torch.core import scenarios, trace
    from repro_torch.core.metrics_stream import StreamingSimMetrics
    from repro_torch.core.topology import google_topology

    topo = google_topology(n_machines)
    cur = trace.synth_trace(topo, duration_s, seed=SEED, target_utilisation=0.6,
                            window_s=TRACE_WINDOW_S)
    kw = dict(fixed_algo_s=0.0, params=_policy(), migration_interval_s=30)
    walls, summaries = {}, {}
    for dev in (device, "cpu"):
        _, m, walls[dev] = _trace_replay(topo, cur, duration_s, dev, streaming_metrics=True,
                                         **kw)
        if not isinstance(m, StreamingSimMetrics) or m.tasks_placed == 0:
            raise AssertionError("trace: the streamed replay placed nothing")
        summaries[dev] = m.summary()
    diffs = _summary_diffs(summaries[device], summaries["cpu"])
    _, streamed, _ = _trace_replay(topo, cur, duration_s, device, **kw)
    _, mat, _ = _trace_replay(topo, trace.materialize(cur), duration_s, device, **kw)
    diffs += [f"materialized.{f}" for f in SERIES + SCALARS
              if getattr(streamed, f) != getattr(mat, f)]
    fixture = ROOT / "tests" / "data" / "task_events_fixture.csv.gz"
    fx_topo = google_topology(96)
    fx, fx_jobs = {}, 0
    for dev in (device, "cpu"):
        csv = trace.CsvTraceCursor(topo=fx_topo, duration_s=120, paths=(str(fixture),))
        fx_sim, fx[dev], _ = _trace_replay(fx_topo, csv, 120, dev, fixed_algo_s=0.0)
        fx_jobs = fx_sim.jt.n
    diffs += [f"fixture.{f}" for f in SERIES + SCALARS
              if getattr(fx[device], f) != getattr(fx["cpu"], f)]
    if diffs or fx[device].tasks_placed == 0:
        raise AssertionError(f"trace: card and CPU (or streamed and materialized) differ "
                             f"in {diffs}")
    # (c) the paper's cluster on the google_trace scenario, measured algo_s.
    gt = scenarios.get_scenario("google_trace")
    full_topo = google_topology(full_machines)
    gcur = trace.synth_trace(full_topo, full_duration_s, seed=SEED, target_utilisation=0.6,
                             **gt.trace_kwargs)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    (sim, m, wall), c, launches = _counted(lambda: _trace_replay(
        full_topo, gcur, full_duration_s, device,
        **gt.sim_config_kwargs(full_topo, full_duration_s, SEED)))
    s = m.summary()
    if not (isinstance(m, StreamingSimMetrics) and m.rounds > 0 and m.tasks_placed > 0
            and np.isfinite(s["algo_runtime_s_p99"])):
        raise AssertionError("trace: the google_trace replay ran no rounds")
    if device == "cuda" and not (launches["costmap"] > 0 and launches["auction_phase"] > 0
                                 and launches["auction_bid"] == 0):
        raise AssertionError(f"trace: google_trace launches {launches}")
    info = {"phase": "trace",
            "streamed": {"machines": n_machines, "duration_s": duration_s,
                         "window_s": TRACE_WINDOW_S, "jobs": cur.n_jobs_hint,
                         "tasks_placed": int(summaries[device]["tasks_placed"]),
                         "card_wall_s": walls[device], "cpu_wall_s": walls["cpu"],
                         "equal": ["summary", "streamed == materialized (SimMetrics)"]},
            "fixture": {"jobs": fx_jobs, "tasks_placed": fx[device].tasks_placed,
                        "equal": "SimMetrics"},
            "google_trace": {
                "machines": full_machines, "duration_s": full_duration_s,
                "rounds": m.rounds, "tasks_placed": m.tasks_placed, "wall_s": wall,
                "sim_build_state_s": c["spans_s"].get("sim.build_state", 0.0),
                "solver_auction_s": c["spans_s"].get("solver.auction", 0.0),
                "algo_s_p50": s["algo_runtime_s_p50"], "algo_s_p99": s["algo_runtime_s_p99"],
                "algo_s_max": s["algo_runtime_s_max"],
                "avg_app_perf_area": s["avg_app_perf_area"], "launches": launches,
                "max_memory_allocated": (int(torch.cuda.max_memory_allocated())
                                         if device == "cuda" else None),
                "ru_maxrss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}}
    info["launches"] = launches
    emit(info)
    return info


def phase_serving(device="cuda", n_machines: int = 12_500, rate_jobs_s: float = 2.0,
                  horizon_s: int = 60) -> dict:
    """(a) The ``smoke`` preset on the card, 8 rounds recorded: replayed
    through a fresh per-round ``auction`` backend with 0 mismatches, and no
    kernel built or loaded after warm-up; (b) a `ScheduleService` on the
    paper's Google layout through ``auction_windowed`` and the device
    latency oracle: wall-clock decision latency (measured, never compared),
    the queue, and no kernel built or loaded after warm-up (the rate halves
    once if the queue does not drain)."""
    from repro_torch import obs
    from repro_torch.core import scenarios, serving

    smoke_cfg = serving.ServingConfig(**scenarios.get_serving_preset("smoke").config_kwargs,
                                      record_rounds=8, device=device)
    with obs.scope():
        smoke = serving.ScheduleService(smoke_cfg).run()
    if not (smoke.replay_mismatches == 0 and smoke.jit_compiles_post_warmup == 0.0
            and smoke.drained):
        raise AssertionError(f"serving: smoke {smoke}")
    rates, report = [], None
    for rate in (rate_jobs_s, rate_jobs_s / 2):
        cfg = serving.ServingConfig(
            backend="auction_windowed", device_latency=True, n_machines=n_machines,
            machines_per_rack=48, racks_per_pod=16, batch_tasks=512, horizon_s=horizon_s,
            rate_jobs_s=rate, device=device)
        report, c, launches = _counted(lambda cfg=cfg: serving.ScheduleService(cfg).run())
        rates.append(rate)
        if report.drained:
            break
    if not (report.drained and report.jit_compiles_post_warmup == 0.0):
        raise AssertionError(f"serving: {report}")
    if device == "cuda" and not (launches["auction_phase"] > 0
                                 and launches["auction_bid"] == 0):
        raise AssertionError(f"serving: launches {launches}")
    info = {"phase": "serving",
            "smoke": {"replay_mismatches": smoke.replay_mismatches,
                      "compiles_post_warmup": smoke.jit_compiles_post_warmup,
                      "tasks_placed": smoke.tasks_placed},
            "machines": n_machines, "rates_tried": rates, **dataclasses.asdict(report),
            "launches": launches, "spans_s": c["spans_s"]}
    emit(info)
    return info


def phase_sweep(device="cuda", n_machines: int = 384, duration_s: int = 60) -> dict:
    """A (policy x seed) grid: `run_sweep` with a 2-worker spawn pool (each
    worker on the card) equal to one process, and shards (0, 2) + (1, 2)
    merged equal to the single run, wall-clock fields dropped."""
    from repro_torch.core import sweep

    spec = sweep.SweepSpec(n_machines=n_machines, machines_per_rack=48, racks_per_pod=16,
                           slots_per_machine=8, duration_s=duration_s,
                           policies=("nomora:auction", "random"), seeds=(0, 1),
                           fixed_algo_s=0.0)

    def comparable(res):
        d = res.to_jsonable()
        d.pop("wall_s")
        for cell in d["cells"]:
            cell.pop("wall_s")
        return json.dumps(d, sort_keys=True)

    # Telemetry stays off: spawned workers would record none, and a cell's
    # counters are part of its saved result.
    from repro_torch import kernels

    kernels.reset_launch_counts()
    single = sweep.run_sweep(spec, device=device)
    launches = {k: kernels.launch_counts()[k] for k in SCHEDULER_KERNELS}
    t0 = time.perf_counter()
    pool = sweep.run_sweep(spec, workers=2, device=device)
    pool_s = time.perf_counter() - t0
    merged = sweep.merge_sweep_results(
        [sweep.run_sweep(spec, shard=(i, 2), device=device) for i in range(2)])
    if not comparable(single) == comparable(pool) == comparable(merged):
        raise AssertionError("sweep: workers=2 or the merged shards differ from one run")
    info = {"phase": "sweep", "machines": n_machines, "duration_s": duration_s,
            "cells": len(single.cells), "wall_s": single.wall_s, "pool_wall_s": pool_s,
            "merged_shards_wall_s": merged.wall_s, "launches": launches,
            "avg_app_perf_area": {c.policy + f"/{c.seed}": c.summary["avg_app_perf_area"]
                                  for c in single.cells},
            "equal": ["workers=2", "shards (0, 2) + (1, 2)"]}
    emit(info)
    return info


# --------------------------------------------------------------------- #
# The LM serving path: attention kernels, full-width serve, parity


_TORCH_DTYPES = {"f32": "float32", "bf16": "bfloat16"}


def _dt(name):
    import torch

    return getattr(torch, _TORCH_DTYPES[name])


def _att_peak(*dtypes) -> float:
    """Peak rate for the inputs' type: f32 CUDA cores unless all are bf16."""
    return BF16_OPS_PER_S if all(d == "bf16" for d in dtypes) else F32_OPS_PER_S


# TF32 passes per operation that flash's tensor-core products take: 3 with
# f32 inputs (3xTF32); bf16 values are exact in TF32, so 1 for Q K^T and 2
# for P V (P is f32), 1.5 on average. Reported beside the bound, not in it.
FLASH_TF32_PASSES = {"f32": 3.0, "bf16": 1.5}


def flash_bound(B, H, KVH, S, D, dt: str, causal: bool = True) -> dict:
    """bound_ms / bound_by of the function on the tensor cores: f32-accurate
    products from f32 inputs take 3 TF32 passes (495 TFLOP/s), bf16 inputs
    run at the bf16 rate. Beside it the bound of the kernel's earlier
    CUDA-core design (the same as bound_ms for bf16) and the kernel's
    TF32 passes."""
    esize = 4 if dt == "f32" else 2
    n_bytes = (2 * B * H * S * D + 2 * B * KVH * S * D) * esize  # q, o; k, v
    pairs = S * (S + 1) // 2 if causal else S * S
    ops = 4 * B * H * D * pairs
    cuda_core = bound_ms(n_bytes, ops, _att_peak(dt))
    b_ms, b_by = bound_ms(n_bytes, 3 * ops, TF32_OPS_PER_S) if dt == "f32" else cuda_core
    return {"bound_ms": b_ms, "bound_by": b_by, "tf32_passes": FLASH_TF32_PASSES[dt],
            "cuda_core_bound_ms": cuda_core[0]}


def decode_bound(H, KVH, D, lengths, q_dt: str, c_dt: str):
    csize = 4 if c_dt == "f32" else 2
    qsize = 4 if q_dt == "f32" else 2
    total = int(np.sum(lengths))
    B = len(lengths)
    n_bytes = 2 * total * KVH * D * csize + 2 * B * H * D * qsize
    return bound_ms(n_bytes, 4 * total * H * D, _att_peak(q_dt, c_dt))


def _sdpa_decode_args(q, k_cache, v_cache, lengths):
    """scaled_dot_product_attention's arguments for one-token decode: the
    cache cast to q's dtype and a boolean length mask (made here, outside
    any timed window)."""
    import torch

    S = k_cache.shape[2]
    mask = (torch.arange(S, device=q.device)[None, :] < lengths[:, None].long())
    return (q[:, :, None, :], k_cache.to(q.dtype), v_cache.to(q.dtype), mask[:, None, None, :])


def _agree(what: str, got, want, tol: float) -> dict:
    """Raises unless |got - want| <= tol + tol * |want| everywhere and got is
    finite; returns the max abs error and the tolerance."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not (bool(diff.le(tol + tol * want.float().abs()).all()) and got.isfinite().all()):
        raise AssertionError(f"{what} disagrees with its plain version: max abs err {err}, "
                             f"tolerance {tol}")
    return {"max_abs_err": err, "tolerance": tol}


def check_flash(q, k, v, dt: str) -> dict:
    from repro_torch.kernels.flash_attention import kernel_cuda, ref

    return _agree(f"flash_attention ({dt})", kernel_cuda.flash_attention_cuda(q, k, v),
                  ref.attention_ref(q, k, v), ATT_TOL[dt])


def check_decode(q, k_cache, v_cache, lengths, q_dt: str, c_dt: str) -> dict:
    from repro_torch.kernels.decode_attention import kernel_cuda, ref

    return _agree(f"decode_attention ({q_dt} q, {c_dt} cache)",
                  kernel_cuda.decode_attention_cuda(q, k_cache, v_cache, lengths),
                  ref.decode_attention_ref(q, k_cache, v_cache, lengths), ATT_TOL[q_dt])


def phase_attention_kernels() -> dict:
    """Both attention kernels against their plain versions at the serving
    shapes; the first row of each is the dtype combination serving uses."""
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel_cuda as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref

    cfg = configs.get_config(SERVE_ARCH)
    B, H, KVH, D = SERVE_REQUESTS, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S, s_max = SERVE_PROMPT, SERVE_PROMPT + SERVE_GEN
    rng = np.random.default_rng(SEED)
    out = {"flash_attention": [], "decode_attention": []}

    def randn(shape, dt):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to("cuda", _dt(dt))

    for dt in ("f32", "bf16"):
        q, k, v = randn((B, H, S, D), dt), randn((B, KVH, S, D), dt), randn((B, KVH, S, D), dt)
        row = {"shape": [B, H, KVH, S, D], "dtype": dt, "causal": True,
               **check_flash(q, k, v, dt)}
        row.update(
            kernel_ms=time_ms(lambda: fa_k.flash_attention_cuda(q, k, v)),
            device_ms=device_ms(lambda: fa_k.flash_attention_cuda(q, k, v),
                                ("flash_attention_kernel",)),
            plain_ms=time_ms(lambda: fa_ref.attention_ref(q, k, v)),
            **flash_bound(B, H, KVH, S, D, dt),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)),
        )
        out["flash_attention"].append(row)
        del q, k, v

    # Ragged valid lengths around the serving run's (1,025 .. 1,088).
    lengths_np = rng.integers(S + 1, s_max + 1, size=B).astype(np.int32)
    lengths_np[0], lengths_np[-1] = S + 1, s_max
    lengths = torch.from_numpy(lengths_np).to("cuda")
    for q_dt, c_dt in (("f32", "bf16"), ("bf16", "bf16"), ("f32", "f32")):
        q = randn((B, H, D), q_dt)
        kc, vc = randn((B, KVH, s_max, D), c_dt), randn((B, KVH, s_max, D), c_dt)
        row = {"shape": [B, H, KVH, s_max, D], "q_dtype": q_dt, "cache_dtype": c_dt,
               "lengths": lengths_np.tolist(), **check_decode(q, kc, vc, lengths, q_dt, c_dt)}
        b_ms, b_by = decode_bound(H, KVH, D, lengths_np, q_dt, c_dt)
        lib_args = _sdpa_decode_args(q, kc, vc, lengths)
        row.update(
            **decode_times(q, kc, vc, lengths),
            plain_ms=time_ms(lambda: dec_ref.decode_attention_ref(q, kc, vc, lengths)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                *lib_args[:3], attn_mask=lib_args[3], enable_gqa=True)),
        )
        out["decode_attention"].append(row)
        del q, kc, vc, lib_args

    # A head_dim no kernel is compiled for: flash in f32, decode with an f32
    # query against a bf16 cache.
    B, H, KVH, S, D = ODD_HEAD_DIM_SHAPE
    q, k, v = randn((B, H, S, D), "f32"), randn((B, KVH, S, D), "f32"), randn((B, KVH, S, D), "f32")
    row = {"shape": [B, H, KVH, S, D], "dtype": "f32", "causal": True,
           **check_flash(q, k, v, "f32")}
    row.update(
        kernel_ms=time_ms(lambda: fa_k.flash_attention_cuda(q, k, v)),
        device_ms=device_ms(lambda: fa_k.flash_attention_cuda(q, k, v),
                            ("flash_attention_kernel",)),
        plain_ms=time_ms(lambda: fa_ref.attention_ref(q, k, v)),
        **flash_bound(B, H, KVH, S, D, "f32"),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
    )
    out["flash_attention"].append(row)
    lengths_np = np.array([S, S // 2 + 1], np.int32)
    lengths = torch.from_numpy(lengths_np).to("cuda")
    q = randn((B, H, D), "f32")
    kc, vc = randn((B, KVH, S, D), "bf16"), randn((B, KVH, S, D), "bf16")
    b_ms, b_by = decode_bound(H, KVH, D, lengths_np, "f32", "bf16")
    lib_args = _sdpa_decode_args(q, kc, vc, lengths)
    out["decode_attention"].append({
        "shape": [B, H, KVH, S, D], "q_dtype": "f32", "cache_dtype": "bf16",
        "lengths": lengths_np.tolist(), **check_decode(q, kc, vc, lengths, "f32", "bf16"),
        **decode_times(q, kc, vc, lengths),
        "plain_ms": time_ms(lambda: dec_ref.decode_attention_ref(q, kc, vc, lengths)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *lib_args[:3], attn_mask=lib_args[3], enable_gqa=True)),
    })
    del q, k, v, kc, vc, lib_args

    emit({"phase": "attention_kernels", "tolerance": ATT_TOL,
          "library": "torch.nn.functional.scaled_dot_product_attention (yardstick only)",
          "kernels": out})
    return out


def rglru_bound(B, T, D, dt: str = "f32", with_h0: bool = False):
    esize = 4 if dt == "f32" else 2
    n_bytes = 3 * B * T * D * esize + B * D * 4 * (2 if with_h0 else 1)  # la, gx, out; h
    return bound_ms(n_bytes, RGLRU_OPS * B * T * D)


def rwkv6_bound(B, H, T, N, dt: str = "f32", with_s0: bool = False):
    esize = 4 if dt == "f32" else 2
    n_bytes = (4 * esize + 4) * B * H * T * N + H * N * 4  # r, k, v, out; w; u
    n_bytes += B * H * N * N * 4 * (2 if with_s0 else 1)  # states
    return bound_ms(n_bytes, RWKV_OPS * B * H * T * N * N)


def check_rglru(la, gx, h0=None) -> dict:
    """The kernel against its plain version: within the tolerance, and
    whether states and final state are equal bit for bit (reported)."""
    import torch

    from repro_torch.kernels.rglru_scan import kernel_cuda, ref

    got, want = kernel_cuda.rglru_scan_cuda(la, gx, h0), ref.rglru_scan_ref(la, gx, h0)
    tol = SCAN_TOL["rglru_scan"]
    out = _agree("rglru_scan (states)", got[0], want[0], tol)
    out["max_abs_err"] = max(out["max_abs_err"],
                             _agree("rglru_scan (final)", got[1], want[1], tol)["max_abs_err"])
    out["bit_equal"] = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    return out


def check_rwkv6(r, k, v, w, u, s0=None) -> dict:
    """The kernel against its plain version; with ``s0`` also updated in
    place (state_out=s0 on a copy), as decode does."""
    import torch

    from repro_torch.kernels.rwkv6_scan import kernel_cuda, ref

    tol = SCAN_TOL["rwkv6_scan"]
    want = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    got = kernel_cuda.rwkv6_scan_cuda(r, k, v, w, u, s0)
    errs = [_agree("rwkv6_scan (out)", got[0], want[0], tol)["max_abs_err"],
            _agree("rwkv6_scan (state)", got[1], want[1], tol)["max_abs_err"]]
    if s0 is not None:
        state = s0.clone()
        o2, _ = kernel_cuda.rwkv6_scan_cuda(r, k, v, w, u, state, state_out=state)
        if not (torch.equal(o2, got[0]) and torch.equal(state, got[1])):
            raise AssertionError("rwkv6_scan in place differs from rwkv6_scan out of place")
    return {"max_abs_err": max(errs), "tolerance": tol}


def phase_recurrent_kernels() -> dict:
    """The scans, and the attention kernels at recurrentgemma-2b's shapes,
    against their plain versions; the first row of each is the serving
    path's main shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel_cuda as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rglru_scan import kernel_cuda as rg_k
    from repro_torch.kernels.rglru_scan import ref as rg_ref
    from repro_torch.kernels.rwkv6_scan import kernel_cuda as rk_k
    from repro_torch.kernels.rwkv6_scan import ref as rk_ref

    rng = np.random.default_rng(SEED)
    out = {"rglru_scan": [], "rwkv6_scan": [], "flash_attention": [], "decode_attention": []}

    def randn(shape, scale=1.0, dt=torch.float32):
        x = rng.normal(0, scale, shape).astype(np.float32)
        return torch.from_numpy(x).to("cuda", dt)

    def uniform(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to("cuda")

    plain_reps = dict(reps=3, per_rep=1)  # the plain scans loop over T in Python
    for i, (B, T, D) in enumerate(RGLRU_SHAPES):
        la, gx = -uniform(0.001, 2.0, (B, T, D)), randn((B, T, D))
        h0 = randn((B, D), 0.3) if i else None
        b_ms, b_by = rglru_bound(B, T, D, with_h0=h0 is not None)
        out["rglru_scan"].append({
            "shape": [B, T, D], "h0": h0 is not None, **check_rglru(la, gx, h0),
            "kernel_ms": time_ms(lambda: rg_k.rglru_scan_cuda(la, gx, h0)),
            "device_ms": device_ms(lambda: rg_k.rglru_scan_cuda(la, gx, h0),
                                   ("rglru_scan_kernel",)),
            "plain_ms": time_ms(lambda: rg_ref.rglru_scan_ref(la, gx, h0), **plain_reps),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        del la, gx, h0

    B, H, T, N = RWKV_SHAPE
    # (shape, s0 given, state updated in place, decays, r k v w laid out as
    # the rwkv block passes them: heads split out of (B, T, H N) projections)
    rows = ((RWKV_SHAPE, False, False, "uniform", False),
            ((B, H, 1, N), True, True, "uniform", False),
            (RWKV_RAGGED, True, False, "uniform", False),
            (RWKV_SHAPE, False, False, "model", False),
            (RWKV_SHAPE, False, False, "uniform", True))
    for (B, H, t_len, N), given, in_place, decay, heads in rows:
        def operand(scale=1.0):
            if heads:
                return randn((B, t_len, H, N), scale).transpose(1, 2)
            return randn((B, H, t_len, N), scale)

        r, k, v = (operand() for _ in range(3))
        if decay == "model":  # w = exp(-exp(raw)): down to 0 and up to ~1
            w = torch.exp(-torch.exp(operand(2.0)))
        else:
            w = uniform(0.2, 0.999, (B, H, t_len, N))  # as exp(-exp(x)) gives
            if heads:
                w = w.transpose(1, 2).contiguous().transpose(1, 2)
        u = randn((H, N), 0.5)
        s0 = randn((B, H, N, N), 0.1) if given else None
        b_ms, b_by = rwkv6_bound(B, H, t_len, N, with_s0=given)
        if in_place:  # decode: the state read and written in place
            state = s0.clone()
            call = lambda: rk_k.rwkv6_scan_cuda(r, k, v, w, u, state, state_out=state)  # noqa: E731
        else:
            call = lambda: rk_k.rwkv6_scan_cuda(r, k, v, w, u, s0)  # noqa: E731
        out["rwkv6_scan"].append({
            "shape": [B, H, t_len, N], "s0": given, "in_place": in_place,
            "decay": decay, "layout": "heads of a projection" if heads else "contiguous",
            **check_rwkv6(r, k, v, w, u, s0),
            "kernel_ms": time_ms(call), "device_ms": device_ms(call, ("rwkv6_scan_kernel",)),
            "plain_ms": time_ms(lambda: rk_ref.rwkv6_scan_ref(r, k, v, w, u, s0),
                                **(plain_reps if t_len > 1 else {})),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        del r, k, v, w, u, s0

    cfg = configs.get_config("recurrentgemma-2b")
    serve_cfg = RECURRENT_SERVES[cfg.name]
    B, H, KVH, D = serve_cfg["requests"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = serve_cfg["prompt_len"]
    q, k, v = randn((B, H, S, D)), randn((B, KVH, S, D)), randn((B, KVH, S, D))
    out["flash_attention"].append({
        "shape": [B, H, KVH, S, D], "dtype": "f32", "causal": True,
        **check_flash(q, k, v, "f32"),
        "kernel_ms": time_ms(lambda: fa_k.flash_attention_cuda(q, k, v), reps=5, per_rep=2),
        "device_ms": device_ms(lambda: fa_k.flash_attention_cuda(q, k, v),
                               ("flash_attention_kernel",), n=3),
        "plain_ms": time_ms(lambda: fa_ref.attention_ref(q, k, v), reps=5, per_rep=2),
        **flash_bound(B, H, KVH, S, D, "f32"),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=5, per_rep=2),
    })
    del q, k, v
    ring = min(cfg.local_window, S + serve_cfg["gen"])  # every slot valid in decode
    lengths_np = np.full(B, ring, np.int32)
    lengths = torch.from_numpy(lengths_np).to("cuda")
    q = randn((B, H, D))
    kc, vc = (randn((B, KVH, ring, D), dt=torch.bfloat16) for _ in range(2))
    b_ms, b_by = decode_bound(H, KVH, D, lengths_np, "f32", "bf16")
    lib_args = _sdpa_decode_args(q, kc, vc, lengths)
    out["decode_attention"].append({
        "shape": [B, H, KVH, ring, D], "q_dtype": "f32", "cache_dtype": "bf16",
        "lengths": lengths_np.tolist(), **check_decode(q, kc, vc, lengths, "f32", "bf16"),
        **decode_times(q, kc, vc, lengths),
        "plain_ms": time_ms(lambda: dec_ref.decode_attention_ref(q, kc, vc, lengths)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *lib_args[:3], attn_mask=lib_args[3], enable_gqa=True)),
    })
    del q, kc, vc, lib_args

    emit({"phase": "recurrent_kernels", "tolerance": {**SCAN_TOL, "attention": ATT_TOL["f32"]},
          "library_ms_null_because": NO_SCAN_LIBRARY,
          "library": "torch.nn.functional.scaled_dot_product_attention (yardstick only)",
          "kernels": out})
    return out


class _Capture:
    """Wraps an ops function: clones the arguments of the calls numbered in
    ``at`` (0-based), then calls through unchanged."""

    def __init__(self, fn, at):
        self.fn, self.at, self.n, self.got = fn, set(at), 0, {}

    def __call__(self, *args, **kw):
        import torch

        if self.n in self.at:
            self.got[self.n] = [a.clone() if torch.is_tensor(a) else a for a in args]
        self.n += 1
        return self.fn(*args, **kw)


def _serve_launches(cfg, prompt_len: int, gen: int) -> dict:
    """Exact kernel launches of one ``serve_batch`` (prefill + gen - 1 decode
    steps) on the card: flash once per attention layer whose prompt fits its
    window (a longer prompt takes local attention's chunk-pair form),
    decode once per attention layer and step, the RG-LRU scan once per rec
    layer (its decode step is inline), the RWKV-6 scan once per rwkv layer
    in prefill and in every step."""
    kinds = cfg.pattern * cfg.n_superblocks + cfg.remainder
    n_attn = kinds.count("dense") + kinds.count("local_attn")
    n_flash = kinds.count("dense") + (kinds.count("local_attn")
                                      if prompt_len <= cfg.local_window else 0)
    return {"flash_attention": n_flash, "decode_attention": n_attn * (gen - 1),
            "rglru_scan": kinds.count("rec"), "rwkv6_scan": kinds.count("rwkv") * gen}


def _cache_bytes(cfg, batch: int, s_max: int) -> int:
    from repro_torch.models import blocks

    kinds = cfg.pattern * cfg.n_superblocks + cfg.remainder
    return sum(int(np.prod(shape)) * dt.itemsize
               for kind in kinds
               for shape, dt in blocks.cache_spec(kind, cfg, batch, s_max).values())


def phase_serve(device="cuda", reduce: int = 1, requests: int = SERVE_REQUESTS,
                prompt_len: int = SERVE_PROMPT, gen: int = SERVE_GEN, *,
                arch: str = SERVE_ARCH, phase: str = "serve") -> dict:
    """The serving run of ``arch``; ``device="cpu"`` and a larger ``reduce``
    rehearse its control flow on the CPU (no launches, no kernel checks
    there). The previous phase's tensors are freed first."""
    import torch

    from repro_torch import configs, kernels
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rwkv6_scan import ops as rk_ops
    from repro_torch.launch import serve
    from repro_torch.models import LM

    t_phase = time.perf_counter()
    cfg = serve.reduce_config(configs.get_config(arch), reduce)
    lm = LM(cfg)
    B, P, G = requests, prompt_len, gen
    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    if tf32:
        raise AssertionError("TF32 matmuls are on; the f32 projections must stay f32")
    params = lm.init(torch.Generator(device=device).manual_seed(SEED), dtype=torch.float32)
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, size=(B, P))
    serve.serve_batch(lm, params, prompts[:, :64], 4)  # warm-up: cuBLAS, libraries
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    want = _serve_launches(cfg, P, G)
    per_step = {"decode_attention": want["decode_attention"] // max(G - 1, 1),
                "rwkv6_scan": want["rwkv6_scan"] // G}
    # (module, function, {call number: label}): layer 0's calls.
    caps = {
        "flash_attention": (fa_ops, "flash_attention", {0: "prefill"}),
        "decode_attention": (dec_ops, "decode_attention", {
            0: "first_step", per_step["decode_attention"] * (G - 2): "last_step"}),
        "rglru_scan": (rg_ops, "rglru_scan", {0: "prefill"}),
        "rwkv6_scan": (rk_ops, "rwkv6_scan", {
            0: "prefill", per_step["rwkv6_scan"] * (G - 1): "last_step"}),
    }
    captures = {name: _Capture(getattr(mod, fn), at) for name, (mod, fn, at) in caps.items()}
    for name, (mod, fn, _) in caps.items():
        setattr(mod, fn, captures[name])
    try:
        kernels.reset_launch_counts()
        timings = {}
        tokens = serve.serve_batch(lm, params, prompts, G, timings=timings)
        launches = kernels.launch_counts()
    finally:
        for name, (mod, fn, _) in caps.items():
            setattr(mod, fn, captures[name].fn)
    peak = int(torch.cuda.max_memory_allocated()) if on_card else None
    got = {k: launches[k] for k in want}
    if on_card and got != want:
        raise AssertionError(f"{phase} launches {got}, expected {want}")
    if tokens.shape != (B, G) or tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"{phase} tokens of shape {tokens.shape} out of range")

    # The kernels against their plain versions on layer-0 tensors of this run.
    captured = {}
    for name, cap in captures.items():
        for n, label in caps[name][2].items():
            if n not in cap.got:
                continue
            args = cap.got[n]
            key = f"{name}_{label}"
            captured[key] = {"layer": 0, "call": n}
            if name == "decode_attention":
                captured[key]["lengths"] = args[3].tolist()
            if not on_card:
                continue
            if name == "flash_attention":
                captured[key].update(shape=list(args[0].shape), **check_flash(*args[:3], "f32"))
            elif name == "decode_attention":
                captured[key].update(check_decode(*args[:4], "f32", "bf16"))
            elif name == "rglru_scan":
                captured[key].update(shape=list(args[1].shape), **check_rglru(*args[:3]))
            else:
                captured[key].update(shape=list(args[0].shape), **check_rwkv6(*args[:6]))
    if on_card and len(captured) != sum(len(caps[k][2]) for k in want if want[k]):
        raise AssertionError(f"{phase}: captured {sorted(captured)} for launches {want}")
    del captures, caps
    total_s = timings["prefill_s"] + timings["decode_s"]
    profile = decode_profile(lm, params, prompts, G)
    step_ms = timings["decode_s"] * 1e3 / timings["decode_steps"]
    if profile["device_busy_ms_per_step"] is not None:
        # Against the unprofiled step time of the run above.
        profile["device_idle_share"] = 1.0 - profile["device_busy_ms_per_step"] / step_ms
    info = {
        "phase": phase,
        "arch": cfg.name,
        "layers": cfg.n_layers, "pattern": list(cfg.pattern), "remainder": list(cfg.remainder),
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
        "requests": B, "prompt_len": P, "gen": G, "s_max": P + G,
        "param_dtype": "float32", "cache_dtype": "bfloat16", "allow_tf32": tf32,
        "prefill_s": timings["prefill_s"],
        "decode_s": timings["decode_s"],
        "decode_ms_per_step": step_ms,
        "tokens_per_s": B * G / total_s,
        "decode_tokens_per_s": B * timings["decode_steps"] / timings["decode_s"],
        "prefill_tokens_per_s": B * P / timings["prefill_s"],
        "param_bytes": param_bytes,
        "cache_bytes": _cache_bytes(cfg, B, P + G),
        "max_memory_allocated": peak,
        "launches": got,
        "captured_checks": captured,
        "decode_profile": profile,
        "tokens_head": tokens[:2, :8].tolist(),
        "phase_s": time.perf_counter() - t_phase,
    }
    del params
    emit(info)
    return info


def _kernel_calls(prof) -> dict:
    """{port kernel: {"device_ms_per_call", "calls"}} of the serving path's
    CUDA kernels in a torch.profiler trace."""
    got = {}
    for evt in prof.key_averages():
        for name in SERVE_KERNELS:
            dev = getattr(evt, "device_time_total", 0.0) or 0.0
            if f"{name}_kernel" in evt.key and dev > 0:
                ms, calls = got.get(name, (0.0, 0))
                got[name] = (ms + dev / 1e3, calls + evt.count)
    return {k: {"device_ms_per_call": ms / calls, "calls": calls} for k, (ms, calls) in got.items()}


def decode_profile(lm, params, prompts, gen: int, steps: int = 4) -> dict:
    """Where a decode step's time goes: a torch.profiler trace (CPU and
    CUDA) of ``steps`` decode steps after a fresh prefill of the same
    prompts. Host wall per step against the card's busy time per step
    (sum of kernel times; kernels do not overlap on one stream), and the
    kernels with the most device time. On the card the prefill is traced
    too (CUDA only): the port's kernels' device ms per call in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    device = params["embed"].device
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tokens = torch.as_tensor(prompts, dtype=torch.long, device=device)
    pre = profile(activities=[ProfilerActivity.CUDA]) if on_card else contextlib.nullcontext()
    with pre:
        logits, cache, lengths = lm.prefill(params, {"tokens": tokens},
                                            s_max=prompts.shape[1] + gen)
        sync()
    prefill_kernels = _kernel_calls(pre) if on_card else None
    tok = logits.argmax(-1)[:, None]
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache, lengths = lm.decode_step(params, {"tokens": tok}, cache, lengths)
            tok = logits.argmax(-1)[:, None]
        sync()
        wall = time.perf_counter() - t0
    by_kernel, host, launches = {}, {}, 0
    dec_ms, dec_calls = 0.0, 0
    for evt in prof.key_averages():
        dev = getattr(evt, "device_time_total", 0.0) or 0.0
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            if dev > 0:
                by_kernel[evt.key] = dev / steps / 1e3
                launches += evt.count
                if any(k in evt.key for k in DECODE_KERNEL):
                    dec_ms += dev / 1e3
                    dec_calls += evt.count
        elif evt.self_cpu_time_total > 0:
            host[evt.key] = (evt.self_cpu_time_total / steps / 1e3, evt.count / steps)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "steps": steps,
        "profiled_wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": sum(by_kernel.values()) if by_kernel else None,
        "kernels_per_step": launches / steps,
        "decode_attention_device_ms_per_call": dec_ms / dec_calls if dec_calls else None,
        "decode_attention_calls_per_step": dec_calls / steps,
        "kernels_device_ms_per_call": _kernel_calls(prof) if on_card else None,
        "prefill_kernels_device_ms_per_call": prefill_kernels,
        "top_kernels_ms_per_step": [[k[:80], v] for k, v in top],
        "top_host_ops_ms_calls_per_step": [[k[:60], *v] for k, v in top_host],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_serve_parity(device="cuda") -> dict:
    import torch

    from repro_torch import configs, kernels
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.models.layers import tree_map

    cfg = dataclasses.replace(serve.reduce_config(configs.get_config(SERVE_ARCH), 8),
                              n_heads=4, n_kv_heads=2)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(SEED), dtype=torch.float32)
    prompts = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, size=(2, 64))
    t0 = time.perf_counter()
    cpu_tokens, cpu_logits = serve.serve_batch(lm, params, prompts, 16, return_logits=True)
    cpu_s = time.perf_counter() - t0
    card = tree_map(lambda t: t.to(device), params)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tokens, logits = serve.serve_batch(lm, card, prompts, 16, return_logits=True)
    card_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    want = {"flash_attention": cfg.n_layers, "decode_attention": cfg.n_layers * 15}
    got = {k: launches[k] for k in want}
    diff = np.abs(logits - cpu_logits)
    ok = bool((diff <= PARITY_TOL + PARITY_TOL * np.abs(cpu_logits)).all())
    info = {
        "phase": "serve_parity",
        "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                   "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                   "vocab": cfg.vocab_size},
        "requests": 2, "prompt_len": 64, "gen": 16,
        "max_abs_logit_diff": float(diff.max()),
        "max_abs_logit": float(np.abs(cpu_logits).max()),
        "tolerance": PARITY_TOL,
        "tokens_equal": bool((tokens == cpu_tokens).all()),
        "launches": got,
        "card_s": card_s, "cpu_s": cpu_s,
    }
    emit(info)
    if not (ok and info["tokens_equal"] and np.isfinite(logits).all()) or (
        device == "cuda" and got != want
    ):
        raise AssertionError(f"serve parity failed: {info}")
    return info


def greedy(lm, params, prompts, gen: int, cache_dtype):
    """``serve_batch``'s greedy loop with the decode cache in ``cache_dtype``:
    (B, gen) tokens and the (B, gen, V) float32 logits they were taken from."""
    import torch

    device = params["embed"].device
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long, device=device)}
    logits, cache, lengths = lm.prefill(params, batch, s_max=prompts.shape[1] + gen,
                                        cache_dtype=cache_dtype)
    out, seen = [], []
    for i in range(gen):
        if i:
            logits, cache, lengths = lm.decode_step(params, {"tokens": out[-1][:, None]},
                                                    cache, lengths)
        out.append(logits.argmax(-1))
        seen.append(logits)
    return torch.stack(out, 1).cpu().numpy(), torch.stack(seen, 1).float().cpu().numpy()


def _logit_diff(logits, ref_logits) -> tuple:
    diff = np.abs(logits - ref_logits)
    ok = bool((diff <= PARITY_TOL + PARITY_TOL * np.abs(ref_logits)).all())
    return float(diff.max()), ok and bool(np.isfinite(logits).all())


def phase_recurrent_parity(arch: str, device="cuda", gen: int = 16) -> dict:
    """``arch`` at reduce 8 on the card against the CPU, same parameters:
    greedily with a float32 cache (held: logits within PARITY_TOL, tokens
    equal, exact launches), then through ``serve_batch`` with its bf16 cache
    (reported)."""
    import torch

    from repro_torch import configs, kernels
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.models.layers import tree_map

    cfg = serve.reduce_config(configs.get_config(arch), 8)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(SEED), dtype=torch.float32)
    P = RECURRENT_PARITY_PROMPT[arch]
    prompts = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, size=(2, P))
    t0 = time.perf_counter()
    cpu_tokens, cpu_logits = greedy(lm, params, prompts, gen, torch.float32)
    cpu_s = time.perf_counter() - t0
    card = tree_map(lambda t: t.to(device), params)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tokens, logits = greedy(lm, card, prompts, gen, torch.float32)
    card_s = time.perf_counter() - t0
    got = {k: kernels.launch_counts()[k] for k in SERVE_KERNELS}
    want = _serve_launches(cfg, P, gen)
    max_diff, ok = _logit_diff(logits, cpu_logits)
    b_cpu_tokens, b_cpu_logits = serve.serve_batch(lm, params, prompts, gen, return_logits=True)
    b_tokens, b_logits = serve.serve_batch(lm, card, prompts, gen, return_logits=True)
    if not (np.isfinite(b_logits).all() and b_tokens.shape == (2, gen)):
        raise AssertionError(f"{arch} serve_batch on the card gave non-finite logits")
    info = {
        "phase": "recurrent_parity",
        "arch": cfg.name,
        "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                   "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                   "local_window": cfg.local_window, "rwkv_head_dim": cfg.rwkv_head_dim,
                   "vocab": cfg.vocab_size},
        "requests": 2, "prompt_len": P, "gen": gen, "cache_dtype": "float32",
        "max_abs_logit_diff": max_diff,
        "max_abs_logit": float(np.abs(cpu_logits).max()),
        "tolerance": PARITY_TOL,
        "tokens_equal": bool((tokens == cpu_tokens).all()),
        "launches": got,
        "card_s": card_s, "cpu_s": cpu_s,
        "serve_batch_bf16_cache": {
            "max_abs_logit_diff": float(np.abs(b_logits - b_cpu_logits).max()),
            "tokens_equal": bool((b_tokens == b_cpu_tokens).all()),
        },
    }
    emit(info)
    if not (ok and info["tokens_equal"]) or (device == "cuda" and got != want):
        raise AssertionError(f"{arch} parity failed (launches expected {want}): {info}")
    return info


def _entry(name: str, main: dict, launches: int) -> dict:
    return {
        "name": name,
        **KERNEL_INFO[name],
        "launches": int(launches),
        "max_abs_err": main.get("max_abs_err", main.get("max_abs_diff")),
        "tolerance": main.get("tolerance", 0),
        "ms": main["kernel_ms"],
        "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        **({"device_ms_cold": main["device_ms_cold"]} if "device_ms_cold" in main else {}),
        "shape": main["shape"],
    }


def kernels_line(kern: dict, full: dict, dynamic: dict, att: dict, served: dict, rec: dict,
                 rec_served: dict, rest: dict) -> dict:
    """One entry per kernel at its main shape; ``rec_served`` maps an arch
    to its serve phase's output, ``rest`` the scheduler's later phases to
    theirs. The scheduler's kernels count their launches in the full
    replay, with the dynamic replays' and the later phases' beside them."""
    entries = []
    for name, rows in kern.items():
        main = next(r for r in rows if tuple(r["shape"]) == MAIN_SHAPE)
        entries.append({**_entry(name, main, full["launches"][name]), "shapes": rows,
                        "launches_by_phase": {
                            "full": full["launches"][name],
                            "dynamic_on": dynamic["on"]["launches"][name],
                            "dynamic_off": dynamic["off"]["launches"][name],
                            **{phase: out["launches"][name] for phase, out in rest.items()}},
                        "library_ms_null_because": NO_LIBRARY})
    gemma = rec_served["recurrentgemma-2b"]
    for name, rows in att.items():
        # The dtypes the serving path uses; recurrentgemma-2b's shape after.
        entries.append({
            **_entry(name, rows[0], served["launches"][name]),
            "launches_by_phase": {p["phase"]: p["launches"][name] for p in (served, gemma)},
            "shapes": rows + rec[name],
        })
    for name, arch in (("rglru_scan", "recurrentgemma-2b"), ("rwkv6_scan", "rwkv6-7b")):
        entries.append({**_entry(name, rec[name][0], rec_served[arch]["launches"][name]),
                        "library_ms_null_because": NO_SCAN_LIBRARY, "shapes": rec[name]})
    return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)

    info = phase_device()
    phase_build()
    kern = phase_kernels()
    att = phase_attention_kernels()
    rec = phase_recurrent_kernels()
    phase_round()
    phase_parity()
    full = phase_full()
    phase_dynamic_parity()
    dynamic = phase_dynamic(full=full)
    rest = {"mcmf_parity": phase_mcmf_parity(), "mcmf_round": phase_mcmf_round(),
            "trace": phase_trace(), "serving": phase_serving(), "sweep": phase_sweep()}
    served = phase_serve()
    phase_serve_parity()
    rec_served = {arch: phase_serve(arch=arch, **kw) for arch, kw in RECURRENT_SERVES.items()}
    for arch in RECURRENT_SERVES:
        phase_recurrent_parity(arch)
    emit(kernels_line(kern, full, dynamic, att, served, rec, rec_served, rest))
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
