"""Online serving mode: open-loop arrivals, wall-clock decision latency.

Port of `repro.core.serving`, its rounds on ``ServingConfig.device``
(default ``"cuda"``).

The paper's second headline claim is *task placement latency* (1.79x
better than random, Fig. 8) — but a batch replay only measures simulated
placement latency and amortised solver wall time. This module runs the
scheduler as a long-lived **service**: an open-loop Poisson job stream
(`trace.OpenLoopCursor` — offered load does not slow down when the
scheduler falls behind) feeds the simulator's round machinery tick by
tick, and every task's **wall-clock decision latency** (arrival tick ->
placement visible) is recorded individually. That is the regime where the
decision-latency tail, not throughput, binds (Shah & Xie; Popescu &
Moore, PAPERS.md).

What makes this a new contract rather than a plain loop over the simulator:

- **Warm re-entry.** A long-lived loop cannot afford to build or load a
  kernel inside a decision, so the backend's shapes are pinned up front
  (`SchedulerBackend.pin_serving` — task/job bucket floors) and run once
  (`warm_serving` -> `RoundProgram.warmup`), which builds and loads every
  kernel the rounds use, and the device latency oracle pins its padded
  job bucket (`DeviceLatencyOracle.pin_jobs`) so its rows keep one shape
  as the live-job count varies. The loop *proves* the pin held: it
  snapshots the ``jit.backend_compiles`` obs counter (kernel builds and
  library loads, `kernels.build`) after `warmup_rounds` solve rounds and
  reports the post-warmup delta (0 = contract held).
- **Open-loop saturation.** `saturation_sweep` walks an arrival-rate
  ladder and reports the largest rate whose queue still drains — the
  knee before queue blow-up — reusing ONE warmed backend across rungs so
  the sweep itself stays build-free.
- **Parity with batch replay.** With ``record_rounds > 0`` the service
  snapshots the first K solver rounds (exact `RoundState` + chosen
  columns) and `verify_replay` re-solves them through a fresh per-round
  ``auction`` backend: placements must be bit-identical (the windowed
  program's parity contract, now exercised through the warm serving
  path with pinned, padded buckets).

Wall-clock timestamps only enter the *measured* latencies; simulated
dynamics (admission, retirement, queue evolution) run on the simulator's
virtual clock with ``fixed_algo_s=0.0``, so a serving run's placement
sequence is a deterministic function of its config — measured latency
varies run to run, placements never do.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs

from .latency import LatencyPlane
from .policy import PolicyParams, RoundState
from .scheduler_backend import (
    RoundContext,
    SchedulerBackend,
    make_backend,
)
from .simulator import SimConfig, Simulator
from .topology import Topology
from .trace import open_loop_trace


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """One serving run: cluster shape, load, and warm-path settings."""

    backend: str = "auction_windowed"
    rate_jobs_s: float = 1.0  # open-loop offered load
    horizon_s: int = 120  # arrival horizon (drain continues past it)
    round_interval_s: int = 1
    seed: int = 0
    n_machines: int = 64
    machines_per_rack: int = 8
    racks_per_pod: int = 4
    slots_per_machine: int = 4
    plane_seed: int = 42
    # Round batch cap AND the pinned serving bucket: every round's live
    # task/job counts must fit inside it for the zero-compile contract.
    batch_tasks: int = 128
    # Solve rounds before the compile-counter snapshot (builds and loads
    # during these are warmup, not violations).
    warmup_rounds: int = 5
    max_drain_s: int = 300  # give-up horizon after arrivals stop
    queue_limit_tasks: int = 1024  # queue depth that counts as blow-up
    device_latency: bool = False  # stream plane updates through the oracle
    # Scales job durations (distribution *shape* preserved) so saturation
    # sweeps reach the knee on small clusters in benchmark-sized runs.
    duration_scale: float = 0.1
    # Snapshot the first K solver rounds for `verify_replay` (0 = off).
    record_rounds: int = 0
    params: PolicyParams = dataclasses.field(default_factory=PolicyParams)
    # Torch device of the rounds ("cuda" or "cpu"); never falls back.
    device: str = "cuda"

    def topology(self) -> Topology:
        return Topology(
            n_machines=self.n_machines,
            machines_per_rack=self.machines_per_rack,
            racks_per_pod=self.racks_per_pod,
            slots_per_machine=self.slots_per_machine,
        )


@dataclasses.dataclass
class ServingReport:
    """One serving run's measured outcome."""

    rate_jobs_s: float
    ticks: int
    jobs_admitted: int
    tasks_placed: int
    # Wall-clock per-decision placement latency (arrival tick -> placed).
    decision_p50_ms: float
    decision_p99_ms: float
    decision_mean_ms: float
    # Wall-clock per-round solve+apply latency.
    round_wall_p50_ms: float
    round_wall_p99_ms: float
    busy_fraction: float  # round wall time / total loop wall time
    peak_queue_depth: int
    final_queue_depth: int
    drained: bool  # every admitted task placed by the end
    saturated: bool
    saturated_reason: str  # "", "queue_limit", "drain_timeout"
    # Post-warmup ``jit.backend_compiles`` delta (0 = warm path held).
    jit_compiles_post_warmup: float
    # Recorded rounds whose fresh batch-replay placements differed (the
    # bit-parity gate; -1 = replay not run).
    replay_mismatches: int

    def to_jsonable(self) -> Dict:
        out = dataclasses.asdict(self)
        return {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in out.items()
        }


class _RoundRecorder:
    """Transparent backend wrapper capturing the first K solver rounds.

    Delegates everything (flags included) to the wrapped backend via
    ``__getattr__``; only `place` is intercepted, and only to *copy* the
    round's inputs/outputs — the placement itself is untouched, so a
    recorded run places identically to an unrecorded one.
    """

    def __init__(self, inner: SchedulerBackend, k: int):
        self._inner = inner
        self._k = k
        self.records: List[Tuple[RoundState, np.ndarray]] = []

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def place(self, state, ctx):
        placement = self._inner.place(state, ctx)
        if len(self.records) < self._k:
            self.records.append(
                (_host_state(state), np.asarray(placement.cols, np.int64).copy())
            )
        return placement


def _host_state(state: RoundState) -> RoundState:
    """Host-side copy of a RoundState, padded oracle rows stripped.

    With a pinned `DeviceLatencyOracle`, ``root_latency`` is a device
    tensor with inert rows past ``n_jobs``; the replay oracle is the plain
    per-round path, which expects exactly (J, M) on the host.
    """
    rl = state.root_latency
    rl = rl.cpu().numpy() if isinstance(rl, torch.Tensor) else np.asarray(rl)
    return RoundState(
        task_job=np.asarray(state.task_job).copy(),
        perf_idx=np.asarray(state.perf_idx).copy(),
        root_machine=np.asarray(state.root_machine).copy(),
        root_latency=rl[: state.n_jobs].copy(),
        wait_s=np.asarray(state.wait_s).copy(),
        run_s=np.asarray(state.run_s).copy(),
        cur_machine=np.asarray(state.cur_machine).copy(),
        free_slots=np.asarray(state.free_slots).copy(),
    )


class ScheduleService:
    """Long-running scheduler loop over an open-loop arrival stream.

    Reuses the simulator's round machinery (`_admit` / `_retire` /
    `_round`) under an externally driven tick loop, adding the serving
    concerns the batch `Simulator.run` has no notion of: per-task
    wall-clock decision stamps, queue blow-up detection, a drain phase
    after the arrival horizon, and the warm-path compile gate.

    ``shared_backend`` lets a rate sweep reuse one pinned + warmed
    backend across runs (its compiled programs are keyed by bucket, and
    serving windows are exogenous — a stale donated carry from a prior
    run cannot influence results).
    """

    def __init__(
        self,
        cfg: ServingConfig,
        *,
        shared_backend: Optional[SchedulerBackend] = None,
    ):
        self.cfg = cfg
        topo = cfg.topology()
        # The plane must cover the drain tail too: `_time_index` raises
        # outside [0, duration) and serving never wraps.
        plane_duration = int(
            cfg.horizon_s + cfg.max_drain_s + 2 * cfg.round_interval_s
        )
        self.plane = LatencyPlane.synthesize(
            topo, plane_duration, seed=cfg.plane_seed
        )
        self.cursor = open_loop_trace(
            topo,
            cfg.horizon_s,
            cfg.rate_jobs_s,
            seed=cfg.seed,
            duration_scale=cfg.duration_scale,
        )
        sim_cfg = SimConfig(
            policy="nomora",
            params=cfg.params,
            backend=cfg.backend,
            round_interval_s=cfg.round_interval_s,
            seed=cfg.seed,
            max_round_tasks=cfg.batch_tasks,
            device_latency=cfg.device_latency,
            device=cfg.device,
            # Simulated dynamics must not depend on measured wall time:
            # decision latency is *recorded*, never fed back.
            fixed_algo_s=0.0,
        )
        self.sim = Simulator(self.cursor, self.plane, sim_cfg)
        if shared_backend is not None:
            if shared_backend.name != self.sim.backend.name:
                raise ValueError(
                    f"shared backend {shared_backend.name!r} != configured "
                    f"backend {self.sim.backend.name!r}"
                )
            self.sim.backend = shared_backend
        if not self.sim.backend.supports_serving:
            raise ValueError(
                f"backend {self.sim.backend.name!r} cannot run the serving "
                f"loop (supports_serving=False); pick one whose compiled "
                f"shapes can be pinned (e.g. auction_windowed) or a host "
                f"backend"
            )
        # Pin + warm the path (kernels built and loaded) before any clock starts.
        self.sim.backend.pin_serving(cfg.batch_tasks, cfg.batch_tasks)
        warm_rows = None
        if self.sim.oracle is not None:
            # Must match the window's job bucket so the stacked scatter
            # keeps one shape (oracle rows are (jp, M) when pinned).
            self.sim.oracle.pin_jobs(cfg.batch_tasks)
            # One throwaway pinned-shape query runs the oracle's rows ahead
            # of the loop; feeding them into warm_serving also runs the
            # device-row stacking branch, so the first real decision meets
            # everything built.
            warm_rows = self.sim.oracle.root_rows(np.zeros(1, np.int64), 0)
        self.sim.backend.warm_serving(self.sim.free_slots, root_latency=warm_rows)
        self.recorder: Optional[_RoundRecorder] = None
        if cfg.record_rounds > 0:
            self.recorder = _RoundRecorder(self.sim.backend, cfg.record_rounds)
            self.sim.backend = self.recorder

    # ------------------------------------------------------------------ #

    def run(self) -> ServingReport:
        cfg, sim = self.cfg, self.sim
        jobs_iter = iter(self.cursor.jobs)
        next_job = next(jobs_iter, None)

        unplaced = np.empty(0, np.int64)  # admitted, not yet placed
        unplaced_ns = np.empty(0, np.int64)  # their arrival-tick stamps
        decision_ns: List[int] = []
        round_walls_ns: List[int] = []
        jobs_admitted = 0
        ticks = 0
        peak_qd = 0
        warm_snapshot: Optional[float] = None
        saturated_reason = ""

        t = 0
        loop_ns0 = time.perf_counter_ns()
        while True:
            tick_ns0 = time.perf_counter_ns()
            with obs.span("serving.decision", t=float(t)):
                arrivals = []
                while next_job is not None and next_job.arrival_s <= t:
                    arrivals.append(next_job)
                    next_job = next(jobs_iter, None)
                if arrivals:
                    n0 = sim.tt.n
                    sim._admit(arrivals, t)
                    new_ids = np.arange(n0, sim.tt.n, dtype=np.int64)
                    unplaced = np.concatenate([unplaced, new_ids])
                    unplaced_ns = np.concatenate(
                        [unplaced_ns, np.full(len(new_ids), tick_ns0, np.int64)]
                    )
                    jobs_admitted += len(arrivals)
                    obs.add("serving.jobs_admitted", len(arrivals))

                sim._retire(t)

                migration_round = (
                    sim.backend.supports_migration
                    and cfg.params.preemption
                    and t % sim.cfg.migration_interval_s == 0
                )
                if len(sim.pending_roots) or len(sim.pending) or migration_round:
                    r0 = time.perf_counter_ns()
                    sim._round(t, migration_round)
                    round_walls_ns.append(time.perf_counter_ns() - r0)
                    if (
                        warm_snapshot is None
                        and sim.metrics.rounds >= cfg.warmup_rounds
                    ):
                        warm_snapshot = obs.jit_compiles()

                if len(sim.pending):
                    sim.tt.wait_s[sim.pending] += cfg.round_interval_s

            tick_ns1 = time.perf_counter_ns()
            if len(unplaced):
                placed = sim.tt.machine[unplaced] >= 0
                if placed.any():
                    decision_ns.extend(
                        (tick_ns1 - unplaced_ns[placed]).tolist()
                    )
                    unplaced = unplaced[~placed]
                    unplaced_ns = unplaced_ns[~placed]

            qd = len(sim.pending) + len(sim.pending_roots)
            peak_qd = max(peak_qd, qd)
            obs.gauge("serving.queue_depth", float(qd))
            obs.gauge("serving.unplaced_tasks", float(len(unplaced)))
            ticks += 1

            if qd > cfg.queue_limit_tasks:
                saturated_reason = "queue_limit"
                break
            if next_job is None and t >= cfg.horizon_s and qd == 0:
                break  # arrivals exhausted and queue drained
            if t >= cfg.horizon_s + cfg.max_drain_s:
                saturated_reason = "drain_timeout"
                break
            t += cfg.round_interval_s

        loop_ns = max(1, time.perf_counter_ns() - loop_ns0)
        # Read the counter before replay verification: the fresh replay
        # backend is not part of the served loop and must not pollute the
        # gate.
        jit_post = (
            obs.jit_compiles() - warm_snapshot if warm_snapshot is not None else 0.0
        )
        replay_mismatches = self.verify_replay()

        qd = len(sim.pending) + len(sim.pending_roots)
        dns = np.asarray(decision_ns, np.float64)
        rns = np.asarray(round_walls_ns, np.float64)
        report = ServingReport(
            rate_jobs_s=cfg.rate_jobs_s,
            ticks=ticks,
            jobs_admitted=jobs_admitted,
            tasks_placed=int(sim.metrics.tasks_placed),
            decision_p50_ms=float(np.percentile(dns, 50)) / 1e6 if len(dns) else 0.0,
            decision_p99_ms=float(np.percentile(dns, 99)) / 1e6 if len(dns) else 0.0,
            decision_mean_ms=float(dns.mean()) / 1e6 if len(dns) else 0.0,
            round_wall_p50_ms=float(np.percentile(rns, 50)) / 1e6 if len(rns) else 0.0,
            round_wall_p99_ms=float(np.percentile(rns, 99)) / 1e6 if len(rns) else 0.0,
            busy_fraction=float(rns.sum()) / loop_ns,
            peak_queue_depth=int(peak_qd),
            final_queue_depth=int(qd),
            drained=bool(qd == 0 and len(unplaced) == 0 and next_job is None),
            saturated=bool(saturated_reason),
            saturated_reason=saturated_reason,
            jit_compiles_post_warmup=float(jit_post),
            replay_mismatches=replay_mismatches,
        )
        obs.audit_event(
            "serving_run",
            rate_jobs_s=cfg.rate_jobs_s,
            backend=cfg.backend,
            ticks=ticks,
            drained=report.drained,
            saturated=report.saturated,
            jit_compiles_post_warmup=report.jit_compiles_post_warmup,
        )
        return report

    # ------------------------------------------------------------------ #

    def verify_replay(self) -> int:
        """Re-solve recorded serving rounds through a fresh per-round
        ``auction`` backend; returns the count of rounds whose placements
        differ (the windowed program's bit-parity contract, exercised
        through the warm pinned path). -1 when nothing was recorded or
        the serving backend is not auction-family (baseline backends
        draw from the simulator's shared rng stream, which a fresh
        replay cannot reproduce)."""
        if self.recorder is None or not self.recorder.records:
            return -1
        if not self.cfg.backend.startswith("auction"):
            return -1
        ref = make_backend(
            "auction", self.cfg.params, self.cfg.topology(), self.sim.lut,
            device=self.cfg.device,
        )
        mismatches = 0
        for state, cols in self.recorder.records:
            ctx = RoundContext(
                rng=np.random.default_rng(0),
                task_counts=np.zeros(self.cfg.n_machines, np.int64),
                n_ready=state.n_tasks,
            )
            ref_cols = np.asarray(ref.place(state, ctx).cols, np.int64)
            if not np.array_equal(ref_cols, cols):
                mismatches += 1
        return mismatches


# --------------------------------------------------------------------- #


def serve(cfg: ServingConfig, **overrides) -> ServingReport:
    """One serving run (convenience wrapper)."""
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return ScheduleService(cfg).run()


def saturation_sweep(
    base_cfg: ServingConfig,
    rates: Sequence[float],
    *,
    share_backend: bool = True,
) -> Tuple[List[ServingReport], float]:
    """Walk an ascending arrival-rate ladder; return per-rate reports and
    the max sustainable rate (largest rate that drained without
    saturating; 0.0 if none did).

    With ``share_backend`` (device backends only) every rung reuses the
    first run's pinned + warmed backend, so the ladder warms once — and
    the post-warmup compile gate covers the *whole sweep*.
    """
    reports: List[ServingReport] = []
    shared: Optional[SchedulerBackend] = None
    sustainable = 0.0
    for rate in sorted(rates):
        svc = ScheduleService(
            dataclasses.replace(base_cfg, rate_jobs_s=float(rate)),
            shared_backend=shared,
        )
        if share_backend and shared is None:
            inner = svc.sim.backend
            while isinstance(inner, _RoundRecorder):
                inner = inner._inner
            shared = inner
        report = svc.run()
        reports.append(report)
        if report.drained and not report.saturated:
            sustainable = max(sustainable, float(rate))
    return reports, sustainable
