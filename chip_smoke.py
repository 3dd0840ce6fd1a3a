#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the script
exits non-zero; nothing is caught):

1. device   - ``nvidia-smi`` name and power limit (also printed raw, as
              nvidia-smi gives it), torch and CUDA versions.
2. build    - nvcc builds every kernel source of the scheduling path at
              once (sm_90a), seconds taken and ptxas' register counts.
3. kernels  - each kernel against its plain PyTorch version on the card at
              the main path's shapes (exact equality required: tolerance
              0, index mismatches 0; boundary latencies and bid rows with
              planted ties across chunk boundaries), and times: kernel and
              plain version per call by CUDA events (median of 21 runs of 10
              calls, host overhead included), the kernels' own time on the
              card from a torch.profiler trace, and the bound.
4. round    - one full-width round (12,500 machines, 1,024 tasks): the
              cost build on the card against the numpy host reference,
              every field bit-equal.
5. parity   - a 1,536-machine, 60 s replay with preemption and a machine
              failure on the card and on the CPU: every SimMetrics series
              and summary() equal.
6. full     - the paper's §6 Google cluster, 12,500 machines, 90 s of the
              synthetic workload on the card: rounds, tasks, auction
              iterations, kernel launches (both > 0, bid launches equal to
              auction iterations), wall time, per-round algo_s, peak device
              memory, and the avg_app_perf_area next to the random
              baseline's on the same workload (paper Fig. 5).

Then a ``{"kernels": [...]}`` line (one entry per kernel: route, source,
the TPU kernel it replaces, launches in the full-width run, max abs error,
kernel / plain / bound times at the main shape, library_ms) and, last,
``{"ok": true, "device": {...}}``.

Runs from a checkout (it imports ``src/repro_torch``); it needs no JAX and
no network, and exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
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
}
NO_LIBRARY = (
    "no single PyTorch call computes it (torch.max has no runner-up, "
    "torch.topk ignores the second slot price)"
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int = N_REPS, per_rep: int = N_PER_REP) -> float:
    """Per-launch time: CUDA events around ``per_rep`` back-to-back calls,
    divided by ``per_rep``; the median of ``reps`` such runs, after a
    warm-up. A call's host-side overhead shows where it exceeds the work on
    the card (small shapes)."""
    import torch

    for _ in range(3):
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

    t0 = time.perf_counter()
    logs = build.build_all([src for _, _, src in KERNELS])
    seconds = time.perf_counter() - t0
    ptxas = {
        src: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for src, log in logs.items()
    }
    emit({"phase": "build", "seconds": seconds, "built": sorted(logs), "ptxas": ptxas})


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

    emit({"phase": "kernels", "tolerance": 0, "library_ms_null_because": NO_LIBRARY,
          "kernels": out})
    return out


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
            "total_cost": res.total_cost}
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


def phase_full(device="cuda", n_machines: int = 12_500, duration_s: int = 90) -> dict:
    import torch

    from repro_torch import kernels
    from repro_torch.core.topology import google_topology

    topo = google_topology(n_machines)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    sim, m, wall, counters = replay(topo, duration_s, device)
    launches = kernels.launch_counts()
    iters = int(counters.get("auction.iterations", 0))
    algo = np.asarray(m.algo_runtime_s, np.float64)
    if not (m.rounds > 0 and m.tasks_placed > 0 and np.isfinite(algo).all()):
        raise AssertionError("full-width replay produced no rounds or non-finite times")
    if (sim.free_slots < 0).any() or (sim.free_slots > topo.slots_per_machine).any():
        raise AssertionError("full-width replay broke slot accounting")
    if on_card and (min(launches.values()) <= 0 or launches["auction_bid"] != iters):
        raise AssertionError(f"kernel launches {launches} vs auction iterations {iters}")
    _, rnd, rnd_wall, _ = replay(topo, duration_s, device, backend="random")
    summ = m.summary()
    info = {
        "phase": "full",
        "machines": n_machines,
        "duration_s": duration_s,
        "rounds": m.rounds,
        "tasks_placed": m.tasks_placed,
        "tasks_migrated": m.tasks_migrated,
        "auction_iterations": iters,
        "launches": launches,
        "wall_s": wall,
        "algo_s_p50": float(np.median(algo)),
        "algo_s_p99": float(np.percentile(algo, 99)),
        "algo_s_max": float(algo.max()),
        "algo_s_sum": float(algo.sum()),
        "ms_per_auction_iteration": float(algo.sum()) * 1e3 / max(iters, 1),
        "spans_s": counters["spans_s"],
        "max_memory_allocated": int(torch.cuda.max_memory_allocated()) if on_card else None,
        "avg_app_perf_area": summ["avg_app_perf_area"],
        "random_avg_app_perf_area": rnd.summary()["avg_app_perf_area"],
        "random_wall_s": rnd_wall,
    }
    emit(info)
    return info


def kernels_line(kern: dict, full: dict) -> dict:
    entries = []
    for name, rows in kern.items():
        main = next(r for r in rows if tuple(r["shape"]) == MAIN_SHAPE)
        entries.append({
            "name": name,
            **KERNEL_INFO[name],
            "launches": int(full["launches"][name]),
            "max_abs_err": main["max_abs_diff"],
            "tolerance": 0,
            "ms": main["kernel_ms"],
            "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
            "shape": main["shape"],
            "shapes": rows,
        })
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
    phase_round()
    phase_parity()
    full = phase_full()
    emit(kernels_line(kern, full))
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
