"""Event-driven cluster scheduling simulator (paper §6), PyTorch port.

Port of `repro.core.simulator`: replays a workload against a topology and
latency plane under a scheduler backend, collecting the paper's §6 metric
set, with the reference's semantics (1 s latency refresh and round cadence,
roots placed first on a random free machine, non-root tasks placed relative
to their root in a later round, preemption with the beta discount, placement
latency including the round's algorithm runtime, failures re-queueing a
machine's tasks, straggler-triggered migration rounds), and the paper's
§7 migration path: what-if migration rounds (``whatif_betas``), the
device-resident latency oracle (``device_latency``) and the QoS-driven
migration controller (``migration_controller``), all on the
``auction_windowed`` backend.

Task state is structure-of-arrays (`engine.TaskTable`); the host side is
numpy, draw for draw the reference's streams. The scheduling round runs on
``SimConfig.device`` (default ``"cuda"``): on the card the ``auction``
backend's round goes through the costmap and auction_phase CUDA kernels.
With ``fixed_algo_s`` set, `SimMetrics` are bit-identical to the
reference's on the same workload and plane.

Not ported yet: streaming metrics (setting ``streaming_metrics`` raises
NotImplementedError) and trace cursors (the workload is a materialised
`Workload`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Literal, Optional

import numpy as np

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.distributed.straggler import QoSTracker, StragglerDetector

from . import perf_model
from .engine import EMPTY_IDS, JobTable, TaskTable, drop_positions, take_ready
from .latency import LatencyPlane
from .metrics import SimMetrics
from .policy import PolicyParams, RoundState
from .scheduler_backend import Placement, RoundContext, backend_for_config
from .workload import Job

PolicyName = Literal[
    "nomora",
    "random",
    "load_spreading",
    # solver-backed baselines (paper §6.2 compares *Firmament* policies'
    # solver runtimes; these run fixed/load-derived costs through the same
    # auction engine NoMora uses):
    "random_solver",
    "spread_solver",
]


@dataclasses.dataclass
class TaskRec:
    """Per-task view record (materialised from the SoA arrays on demand)."""

    job_id: int
    task_idx: int  # 0 == root
    submit_s: float
    machine: int = -1
    start_s: float = -1.0
    placed_s: float = -1.0
    end_s: float = -1.0
    wait_s: float = 0.0


@dataclasses.dataclass
class JobRec:
    job: Job
    tasks: List[TaskRec]
    root_machine: int = -1
    done: bool = False

    @property
    def placed_tasks(self) -> List[TaskRec]:
        return [t for t in self.tasks if t.machine >= 0]


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Grouped view of SimConfig's migration/controller knobs.

    Construct `SimConfig(migration=MigrationConfig(...))` or keep the
    flat kwargs (``migration_interval_s=...``) — both spellings populate
    the same flat fields; the grouped object wins where both are given.
    Read back via `SimConfig.migration_cfg`.
    """

    interval_s: int = 10
    straggler_threshold: Optional[float] = None
    whatif_betas: tuple = ()
    controller: bool = False
    qos_threshold: float = 0.9
    qos_window: int = 2
    qos_clear_margin: float = 0.02
    qos_hold_s: float = 45.0
    budget: int = 256


@dataclasses.dataclass(frozen=True)
class MetricsConfig:
    """Grouped view of SimConfig's metrics/measurement knobs (see
    `MigrationConfig` for the construction contract)."""

    streaming: bool = False
    perf_sample_interval_s: int = 15
    fixed_algo_s: Optional[float] = None


@dataclasses.dataclass
class SimConfig:
    policy: PolicyName = "nomora"
    params: PolicyParams = dataclasses.field(default_factory=PolicyParams)
    solver: Literal["auction", "mcmf"] = "auction"
    # Explicit SchedulerBackend name (scheduler_backend.BACKEND_NAMES);
    # overrides the (policy, solver) mapping when set. "auction" is the
    # fused round on the device, "auction_host" the numpy reference path.
    backend: Optional[str] = None
    # Torch device of the scheduling round ("cuda" or "cpu"); the round
    # never falls back from the card to the CPU.
    device: str = "cuda"
    round_interval_s: int = 1  # scheduling cadence (latency refresh cadence)
    migration_interval_s: int = 10  # preemption re-optimisation cadence
    perf_sample_interval_s: int = 15
    seed: int = 0
    max_round_tasks: int = 1024  # tasks admitted to one round (Firmament batches)
    # Fault tolerance: ((t_seconds, machine_id), ...) machine-removal events.
    failures: tuple = ()
    # Straggler mitigation (paper §7): migrate jobs whose predicted perf
    # EWMA stays below this threshold (requires preemption).
    straggler_threshold: float | None = None
    # Deterministic stand-in for measured solver wall time. Placement and
    # response times include the round's algorithm runtime, so wall-clock
    # jitter leaks into the metrics; parity tests pin it (usually to 0.0).
    fixed_algo_s: float | None = None
    # The reference's bounded streaming metrics: not ported yet, so setting
    # it raises NotImplementedError (ROADMAP module item 7).
    streaming_metrics: bool = False
    # What-if migration (paper §7 "pick a better placement"): candidate
    # beta_scale values evaluated per migration/straggler round through the
    # backend's what-if axis; the variant whose placement has the lowest
    # *true* (undiscounted) cost is applied. Empty = regular single-solve
    # rounds (the parity default). Requires a backend with `place_whatif`
    # (``auction_windowed``).
    whatif_betas: tuple = ()
    # ---- time-varying plane + continuous migration controller (§7) ---- #
    # Device-resident latency oracle: each round's root-latency rows are
    # computed on the device from incremental per-second plane updates (the
    # 24-float series column + rack hotspot multipliers; see
    # latency_device.DeviceLatencyOracle) and handed to the round program
    # as device tensors — no host (J, M) rebuild or upload per round.
    # Requires the windowed backend. Bit-identical to the host path.
    device_latency: bool = False
    # Close the §7 loop: detect QoS-degraded jobs from the perf-sampling
    # path (consecutive-sample trigger window with hysteresis + a
    # post-migration hold-down, never a single-sample trigger), evaluate
    # candidate re-placements — beta scales x mover subsets — through the
    # backend's what-if axis each migration round, and migrate under
    # `migration_budget` ranked by true-cost improvement. Requires
    # preemption and the auction_windowed backend.
    migration_controller: bool = False
    qos_threshold: float = 0.9  # degraded below this predicted perf
    qos_window: int = 2  # consecutive below-threshold samples to trigger
    qos_clear_margin: float = 0.02  # hysteresis band above the threshold
    qos_hold_s: float = 45.0  # post-migration re-trigger hold-down
    migration_budget: int = 256  # max migrations per controller round
    # Grouped construction (InitVar: consumed by __post_init__, never a
    # field — `dataclasses.replace(cfg, ...)` keeps working on the flats).
    migration: dataclasses.InitVar[Optional[MigrationConfig]] = None
    metrics: dataclasses.InitVar[Optional[MetricsConfig]] = None

    def __post_init__(
        self,
        migration: Optional[MigrationConfig],
        metrics: Optional[MetricsConfig],
    ) -> None:
        # Grouped sub-configs overwrite the corresponding flat fields
        # wholesale (the grouped object wins).
        if migration is not None:
            self.migration_interval_s = migration.interval_s
            self.straggler_threshold = migration.straggler_threshold
            self.whatif_betas = migration.whatif_betas
            self.migration_controller = migration.controller
            self.qos_threshold = migration.qos_threshold
            self.qos_window = migration.qos_window
            self.qos_clear_margin = migration.qos_clear_margin
            self.qos_hold_s = migration.qos_hold_s
            self.migration_budget = migration.budget
        if metrics is not None:
            self.streaming_metrics = metrics.streaming
            self.perf_sample_interval_s = metrics.perf_sample_interval_s
            self.fixed_algo_s = metrics.fixed_algo_s

    @property
    def migration_cfg(self) -> MigrationConfig:
        """The migration knobs as one grouped (frozen) object."""
        return MigrationConfig(
            interval_s=self.migration_interval_s,
            straggler_threshold=self.straggler_threshold,
            whatif_betas=self.whatif_betas,
            controller=self.migration_controller,
            qos_threshold=self.qos_threshold,
            qos_window=self.qos_window,
            qos_clear_margin=self.qos_clear_margin,
            qos_hold_s=self.qos_hold_s,
            budget=self.migration_budget,
        )

    @property
    def metrics_cfg(self) -> MetricsConfig:
        """The metrics knobs as one grouped (frozen) object."""
        return MetricsConfig(
            streaming=self.streaming_metrics,
            perf_sample_interval_s=self.perf_sample_interval_s,
            fixed_algo_s=self.fixed_algo_s,
        )


class Simulator:
    """Vectorized structure-of-arrays simulator (public API unchanged)."""

    def __init__(
        self,
        workload,  # Workload (topo, duration_s, jobs)
        plane: LatencyPlane,
        config: SimConfig,
    ):
        self.wl = workload
        self.topo = workload.topo
        self.plane = plane
        self.cfg = config
        if config.streaming_metrics:
            raise NotImplementedError(
                "SimConfig.streaming_metrics is not ported to repro_torch yet "
                "(ROADMAP.md module queue item 7)"
            )
        self.device = resolve_device(config.device)
        self.rng = np.random.default_rng(config.seed)
        self.metrics = SimMetrics()
        self.lut = perf_model.perf_lut_table()
        self.lut_np = self.lut.numpy()

        M = self.topo.n_machines
        self.free_slots = np.full(M, self.topo.slots_per_machine, np.int32)
        self.task_counts = np.zeros(M, np.int64)  # for load-spreading
        self.tt = TaskTable(capacity=workload.n_tasks_total)
        self.jt = JobTable(capacity=len(workload.jobs))
        # Sparse: only LM jobs carry an ml_arch label. Everything else a
        # `jobs`-view record needs lives in the SoA tables.
        self._ml_arch: Dict[int, str] = {}  # dense job -> ml_arch
        self.pending_roots: np.ndarray = EMPTY_IDS  # root task ids, queue order
        self.pending: np.ndarray = EMPTY_IDS  # non-root task ids, queue order
        self.running: np.ndarray = EMPTY_IDS  # placed task ids, start order
        self.backend = backend_for_config(config, self.topo, self.lut)
        if config.whatif_betas and not self.backend.supports_whatif:
            raise ValueError(
                f"whatif_betas requires a backend with a what-if axis "
                f"(auction_windowed), got {self.backend.name!r}"
            )
        if config.migration_controller:
            if not self.backend.supports_whatif:
                raise ValueError(
                    f"migration_controller requires a backend with a what-if "
                    f"axis (auction_windowed), got {self.backend.name!r}"
                )
            if not config.params.preemption:
                raise ValueError(
                    "migration_controller requires params.preemption=True "
                    "(it migrates running tasks)"
                )
        self.oracle = None
        if config.device_latency:
            if not self.backend.supports_whatif:
                raise ValueError(
                    f"device_latency requires the windowed backend "
                    f"(auction_windowed), got {self.backend.name!r}"
                )
            from .latency_device import DeviceLatencyOracle

            self.oracle = DeviceLatencyOracle(plane, device=self.device)
        self.dead: set = set()  # failed machines
        self.dead_mask = np.zeros(M, bool)
        self._failures = sorted(config.failures)
        self.straggler = (
            StragglerDetector(threshold=config.straggler_threshold)
            if config.straggler_threshold is not None
            else None
        )
        self._straggler_jobs: set = set()
        self.qos = (
            QoSTracker(
                threshold=config.qos_threshold,
                window=config.qos_window,
                clear_margin=config.qos_clear_margin,
                hold_s=config.qos_hold_s,
            )
            if config.migration_controller
            else None
        )

    # ------------------------------------------------------------------ #

    @property
    def jobs(self) -> Dict[int, JobRec]:
        """Per-object view of the SoA state (seed-compatible read API).

        Materialised on access — `Job` records are reconstructed from the
        table columns (task spans recovered from the admission-ordered
        ``tt.job``), so nothing per-job is retained during a streamed
        replay. Mutating the returned records does not write back into
        the engine.
        """
        tt, jt = self.tt, self.jt
        jn = jt.n
        dense = np.arange(jn)
        # tt.job is non-decreasing (tasks admitted job by job), so each
        # job's tasks are the contiguous run [lo[j], hi[j]).
        lo = np.searchsorted(tt.job[: tt.n], dense, side="left")
        hi = np.searchsorted(tt.job[: tt.n], dense, side="right")
        out: Dict[int, JobRec] = {}
        for j in range(jn):
            job = Job(
                job_id=int(jt.job_id[j]),
                arrival_s=float(jt.arrival_s[j]),
                n_tasks=int(hi[j] - lo[j]),
                duration_s=float(jt.duration_s[j]),
                perf_idx=int(jt.perf_idx[j]),
                ml_arch=self._ml_arch.get(j),
            )
            tasks = [
                TaskRec(
                    job_id=job.job_id,
                    task_idx=int(tt.task_idx[i]),
                    submit_s=float(tt.submit_s[i]),
                    machine=int(tt.machine[i]),
                    start_s=float(tt.start_s[i]),
                    placed_s=float(tt.placed_s[i]),
                    end_s=float(tt.end_s[i]),
                    wait_s=float(tt.wait_s[i]),
                )
                for i in range(int(lo[j]), int(hi[j]))
            ]
            out[job.job_id] = JobRec(
                job=job,
                tasks=tasks,
                root_machine=int(jt.root_machine[j]),
                done=bool(jt.done[j]),
            )
        return out

    # ------------------------------------------------------------------ #

    def run(self) -> SimMetrics:
        cfg = self.cfg
        duration = self.wl.duration_s
        jobs_iter = iter(self.wl.jobs)
        next_job = next(jobs_iter, None)

        for t in range(0, duration, cfg.round_interval_s):
            # 1. Admit arrivals (batched: one queue concatenate per tick).
            arrivals = []
            while next_job is not None and next_job.arrival_s <= t:
                arrivals.append(next_job)
                next_job = next(jobs_iter, None)
            if arrivals:
                self._admit(arrivals, t)

            # 1b. Machine-removal events (fault tolerance).
            while self._failures and self._failures[0][0] <= t:
                _, machine = self._failures.pop(0)
                self._fail_machine(int(machine), t)

            # 2. Retire finished tasks / jobs.
            self._retire(t)

            # 3. Scheduling round.
            migration_round = (
                self.backend.supports_migration
                and cfg.params.preemption
                and t % cfg.migration_interval_s == 0
            )
            straggler_round = bool(self._straggler_jobs)
            if (
                len(self.pending_roots)
                or len(self.pending)
                or migration_round
                or straggler_round
            ):
                self._round(t, migration_round or straggler_round)

            # 4. Performance sampling.
            if t % cfg.perf_sample_interval_s == 0:
                self._sample_perf(t)

            # 5. Wait-time accrual.
            if len(self.pending):
                self.tt.wait_s[self.pending] += cfg.round_interval_s

        if self.oracle is not None and obs.enabled():
            # Mirror the device oracle's upload/LRU accounting into the
            # counter namespace (one shot — the oracle is per-Simulator).
            for key, val in self.oracle.stats().items():
                if key in (
                    "round_uploads", "uploaded_floats",
                    "decomp_builds", "decomp_hits",
                ):
                    obs.add(f"oracle.{key}", float(val))
        return self.metrics

    # ------------------------------------------------------------------ #

    def _algo_s(self, measured: float) -> float:
        return measured if self.cfg.fixed_algo_s is None else self.cfg.fixed_algo_s

    def _admit(self, jobs: List[Job], t: float) -> None:
        """Admit one tick's arrivals (arrival order == dense-id order)."""
        roots, workers = [self.pending_roots], [self.pending]
        for job in jobs:
            j = self.jt.append(
                job.job_id, float(job.duration_s), int(job.perf_idx),
                job.n_tasks, float(job.arrival_s),
            )
            ids = self.tt.append_job(j, job.n_tasks, float(max(t, job.arrival_s)))
            if job.ml_arch is not None:
                self._ml_arch[j] = job.ml_arch
            roots.append(ids[:1])
            workers.append(ids[1:])
        self.pending_roots = np.concatenate(roots)
        self.pending = np.concatenate(workers)

    def _fail_machine(self, machine: int, t: float) -> None:
        """Machine removal: zero its capacity, re-queue its tasks (the
        paper's cluster-event handling; recovery = re-placement)."""
        if machine in self.dead:
            return
        self.dead.add(machine)
        self.dead_mask[machine] = True
        self.free_slots[machine] = 0
        self.task_counts[machine] = 0
        if not len(self.running):
            return
        on_m = self.tt.machine[self.running] == machine
        if not on_m.any():
            return
        ids = self.running[on_m]
        roots = ids[self.tt.task_idx[ids] == 0]
        others = ids[self.tt.task_idx[ids] != 0]
        self.tt.requeue(ids)
        if len(roots):
            self.jt.root_machine[self.tt.job[roots]] = -1
        self.pending_roots = np.concatenate([self.pending_roots, roots])
        self.pending = np.concatenate([self.pending, others])
        self.running = self.running[~on_m]

    def _retire(self, t: float) -> None:
        if len(self.running):
            finished = self.tt.end_s[self.running] <= t
            if finished.any():
                ids = self.running[finished]  # running order == seed order
                machines = self.tt.machine[ids]
                alive = ~self.dead_mask[machines]
                np.add.at(self.free_slots, machines[alive], 1)
                np.subtract.at(self.task_counts, machines[alive], 1)
                self.metrics.response_time_s.extend(
                    (self.tt.end_s[ids] - self.tt.submit_s[ids]).tolist()
                )
                np.subtract.at(self.jt.unfinished, self.tt.job[ids], 1)
                self.running = self.running[~finished]
        # Sticky job-done marking: a job completes in the round its last
        # task retires (the seed's all-tasks scan, as a counter).
        jn = self.jt.n
        if jn:
            newly = (~self.jt.done[:jn]) & (self.jt.unfinished[:jn] == 0)
            if newly.any():
                self.jt.done[:jn] |= newly
                # Retire straggler-detector state with the job: done jobs
                # are never sampled again (the _sample_perf mask excludes
                # them), so dropping their EWMA/counter entries is
                # semantics-neutral and keeps the detector O(live jobs)
                # instead of O(all jobs ever) on multi-week replays.
                # (_straggler_jobs itself is cleared every straggler round
                # and must keep done jobs until then — seed semantics.)
                if self.straggler is not None or self.qos is not None:
                    for j in np.nonzero(newly)[0]:
                        jid = int(self.jt.job_id[j])
                        if self.straggler is not None:
                            self.straggler.forget(jid)
                        if self.qos is not None:
                            self.qos.forget(jid)

    def _start_batch(
        self, ids: np.ndarray, machines: np.ndarray, t: float, algo_s: float
    ) -> None:
        """Vectorized `_start_task` over a batch (order = metric order)."""
        if not len(ids):
            return
        jdense = self.tt.job[ids]
        self.tt.start(ids, machines, t, algo_s, self.jt.duration_s[jdense])
        np.subtract.at(self.free_slots, machines, 1)
        np.add.at(self.task_counts, machines, 1)
        self.running = np.concatenate([self.running, ids])
        self.metrics.tasks_placed += len(ids)
        self.metrics.placement_latency_s.extend(
            (self.tt.placed_s[ids] - self.tt.submit_s[ids]).tolist()
        )
        is_root = self.tt.task_idx[ids] == 0
        if is_root.any():
            self.jt.root_machine[jdense[is_root]] = machines[is_root]

    def _round(self, t: float, migration_round: bool) -> None:
        with obs.span("sim.round", t=float(t), migration=bool(migration_round)):
            self._round_body(t, migration_round)
            if obs.enabled():
                # Post-round cluster gauges (Perfetto counter tracks).
                obs.gauge("sim.queue_depth", float(len(self.pending)))
                obs.gauge("sim.pending_roots", float(len(self.pending_roots)))
                obs.gauge("sim.free_slots", float(self.free_slots.sum()))
                obs.gauge("sim.running_tasks", float(len(self.running)))

    def _round_body(self, t: float, migration_round: bool) -> None:
        cfg = self.cfg

        # Roots: immediate placement on any available machine (random).
        # Sequential on purpose: each placement consumes a slot and an RNG
        # draw, exactly like the seed loop (roots are O(jobs), not O(tasks));
        # the running-queue concatenate happens once for the whole round.
        if len(self.pending_roots):
            with obs.span("sim.roots", n=int(len(self.pending_roots))):
                tt, jt = self.tt, self.jt
                kept, placed = [], []
                for rid in self.pending_roots:
                    free_m = np.nonzero(self.free_slots > 0)[0]
                    if len(free_m) == 0:
                        tt.wait_s[rid] += cfg.round_interval_s
                        kept.append(rid)
                        continue
                    m = int(self.rng.choice(free_m))
                    j = tt.job[rid]
                    when = float(t)  # roots place with zero algorithm time
                    tt.machine[rid] = m
                    tt.placed_s[rid] = when
                    tt.start_s[rid] = when
                    tt.end_s[rid] = when + jt.duration_s[j]
                    jt.root_machine[j] = m
                    self.free_slots[m] -= 1
                    self.task_counts[m] += 1
                    placed.append(rid)
                    self.metrics.tasks_placed += 1
                    self.metrics.placement_latency_s.append(
                        float(when - tt.submit_s[rid])
                    )
                if placed:
                    obs.add("sim.tasks_placed", len(placed))
                    self.running = np.concatenate(
                        [self.running, np.asarray(placed, np.int64)]
                    )
                self.pending_roots = (
                    np.asarray(kept, np.int64) if kept else EMPTY_IDS
                )

        self._round_solve(t, migration_round)

    def _ready_prefix(self, limit: int):
        """Queue positions/ids of pending tasks whose root is placed."""
        ready_mask = self.jt.root_machine[self.tt.job[self.pending]] >= 0
        return take_ready(self.pending, ready_mask, limit)

    def _build_round_state(
        self,
        ready_ids: np.ndarray,
        mover_ids: np.ndarray,
        t: float,
        with_latency: bool = True,
    ) -> RoundState:
        tids = np.concatenate([ready_ids, mover_ids])
        jdense = self.tt.job[tids]
        jid_actual = self.jt.job_id[jdense]
        # Round-local job ids, sorted by workload job_id (seed: sorted set).
        uniq_dense = np.unique(jdense)
        order = np.argsort(self.jt.job_id[uniq_dense], kind="stable")
        job_dense_sorted = uniq_dense[order]
        job_ids_sorted = self.jt.job_id[job_dense_sorted]
        task_job = np.searchsorted(job_ids_sorted, jid_actual).astype(np.int64)
        root_machine = self.jt.root_machine[job_dense_sorted].astype(np.int64)
        if with_latency:
            # Canonical batched rows; with the device oracle they are
            # tensors computed on the device from incremental plane updates
            # and never come back to the host (bit-identical either way).
            if self.oracle is not None:
                root_latency = self.oracle.root_rows(root_machine, int(t))
            else:
                root_latency = self.plane.latency_rows(root_machine, int(t))
        else:
            # Cost-model-free backends never read the latency plane; a
            # zero-width stand-in makes accidental use fail loudly.
            root_latency = np.zeros((len(root_machine), 0), np.float32)
        free = self.free_slots.copy()
        if len(mover_ids):  # movers' slots are reclaimable within the round
            np.add.at(free, self.tt.machine[mover_ids], 1)
        start = self.tt.start_s[tids]
        return RoundState(
            task_job=task_job,
            perf_idx=self.jt.perf_idx[jdense].astype(np.int64),
            root_machine=root_machine,
            root_latency=root_latency,
            wait_s=self.tt.wait_s[tids].astype(np.float32),
            run_s=np.where(start >= 0, np.maximum(0.0, t - start), 0.0).astype(
                np.float32
            ),
            cur_machine=self.tt.machine[tids].astype(np.int64),
            free_slots=free,
        )

    def _select_movers(self, restrict_jobs=None) -> np.ndarray:
        """Running tasks eligible to migrate this round (seed order).

        ``restrict_jobs`` (iterable of workload job ids) limits movers to
        those jobs — the migration controller passes its QoS-degraded set
        so only degraded jobs' tasks are candidates (takes precedence over
        the straggler filter).
        """
        cfg = self.cfg
        if not len(self.running):
            return EMPTY_IDS
        full = cfg.params.preemption
        keep = self.tt.task_idx[self.running] != 0
        # A mover is re-priced relative to its root's machine; a task whose
        # root was lost to a machine failure has root_machine == -1, which
        # would silently index latency_from(-1) as machine M-1. Hold such
        # tasks until their root is re-placed.
        keep &= self.jt.root_machine[self.tt.job[self.running]] >= 0
        if restrict_jobs is not None:
            jid = self.jt.job_id[self.tt.job[self.running]]
            wanted = np.fromiter(restrict_jobs, np.int64, len(restrict_jobs))
            keep &= np.isin(jid, wanted)
        elif self._straggler_jobs:
            jid = self.jt.job_id[self.tt.job[self.running]]
            keep &= np.isin(
                jid, np.fromiter(self._straggler_jobs, np.int64, len(self._straggler_jobs))
            )
        elif not full:
            keep &= False
        # Bound the round size for tractability.
        return self.running[keep][: min(cfg.max_round_tasks, 512)]

    def _round_solve(self, t: float, migration_round: bool) -> None:
        """One scheduling round: build RoundState, let the backend place."""
        cfg = self.cfg
        backend = self.backend
        if backend.caps_admission:
            # Admit at most (free capacity + slack) tasks per round: a large
            # backlog against a full cluster degenerates the auction into
            # unscheduled-price wars (Firmament likewise schedules what
            # fits; the remainder waits with escalating unscheduled cost).
            admit = min(cfg.max_round_tasks, int(self.free_slots.sum()) + 64)
        else:
            admit = cfg.max_round_tasks
        pos, ready_ids = self._ready_prefix(admit)
        mover_ids = EMPTY_IDS
        # Not redundant with run()'s migration_round gate: straggler rounds
        # OR into the flag without consulting the backend. Seed semantics:
        # every solver-family backend feeds movers into the round (for
        # random_solver their presence even shifts the rng stream) and
        # clears the straggler set, but only migration-capable backends
        # later apply the mover columns; the two §6.1 heuristics do neither.
        degraded: Dict[int, float] = {}
        if migration_round and backend.selects_movers:
            if self.qos is not None:
                # Continuous controller: only QoS-degraded jobs' tasks are
                # migration candidates (the trigger window already debounced
                # them; healthy jobs are never churned).
                degraded = self.qos.degraded_jobs()
                mover_ids = (
                    self._select_movers(restrict_jobs=degraded)
                    if degraded
                    else EMPTY_IDS
                )
            else:
                mover_ids = self._select_movers()
            self._straggler_jobs.clear()
        if not len(ready_ids) and not len(mover_ids):
            # A migration round with zero eligible movers still samples the
            # migrated-percentage series (0%): dropping it silently would
            # desynchronise the series from the migration cadence.
            if migration_round and backend.supports_migration:
                self.metrics.migrated_pct_per_round.append(0.0)
                obs.gauge("sim.migrated_pct", 0.0)
                if self.qos is not None:
                    self._record_controller(0.0, len(degraded))
            return

        with obs.span(
            "sim.build_state", tasks=int(len(ready_ids) + len(mover_ids))
        ):
            state = self._build_round_state(
                ready_ids, mover_ids, t, with_latency=backend.needs_latency
            )
        M = state.n_machines
        ctx = RoundContext(
            rng=self.rng, task_counts=self.task_counts, n_ready=len(ready_ids)
        )
        # Continuous migration controller: (beta x mover-subset)
        # re-placement hypotheses plus an all-frozen baseline through the
        # what-if axis, pick the lowest true-cost outcome, and cap the
        # round's migrations at the preemption budget.
        ctrl_info = None
        if (
            migration_round
            and self.qos is not None
            and len(mover_ids)
            and backend.supports_whatif
        ):
            placement, ctrl_info = self._controller_place(
                state, ctx, mover_ids, degraded, n_ready=len(ready_ids), t=t
            )
        # What-if migration rounds: evaluate K preemption-aggressiveness
        # (beta) variants and apply the placement with the best true
        # (undiscounted) cost. Off by default; the single-solve path below
        # stays the bit-parity reference.
        elif (
            migration_round
            and cfg.whatif_betas
            and len(mover_ids)
            and backend.supports_whatif
        ):
            variants = [
                dataclasses.replace(cfg.params, beta_scale=b)
                for b in cfg.whatif_betas
            ]
            placement = backend.place_whatif(state, ctx, variants)
        else:
            placement = backend.place(state, ctx)
        algo_s = self._algo_s(placement.algo_s)
        self.metrics.algo_runtime_s.append(algo_s)
        self.metrics.rounds += 1
        obs.add("sim.rounds")

        with obs.span("sim.apply"):
            cols = np.asarray(placement.cols, np.int64)
            n_ready = len(ready_ids)
            rcols = cols[:n_ready]
            placed = (rcols >= 0) & (rcols < M)
            if placed.any():
                self._start_batch(ready_ids[placed], rcols[placed], t, algo_s)
                self.pending = drop_positions(self.pending, pos[placed])
            # Unplaced ready tasks stay pending (unscheduled aggregator).

            if not backend.supports_migration:
                # Solver baselines: mover columns are solved but never
                # applied, and no migration metrics accrue (seed semantics).
                return
            n_migrated = 0
            mig = None
            if len(mover_ids):
                mcols = cols[n_ready:]
                cur = self.tt.machine[mover_ids]
                mig = (mcols >= 0) & (mcols < M) & (mcols != cur)
                # col == unscheduled for a running task: keep it running
                # (eviction-to-idle is never profitable under Eq. 10 costs).
                n_migrated = int(mig.sum())
                if n_migrated:
                    # Migration: move without restart.
                    np.add.at(self.free_slots, cur[mig], 1)
                    np.subtract.at(self.task_counts, cur[mig], 1)
                    self.tt.machine[mover_ids[mig]] = mcols[mig]
                    np.subtract.at(self.free_slots, mcols[mig], 1)
                    np.add.at(self.task_counts, mcols[mig], 1)
                    self.metrics.tasks_migrated += n_migrated
                    obs.add("sim.tasks_migrated", n_migrated)
            if migration_round:
                # Every migration round records a sample — 0.0 when no
                # movers were eligible — so the series length tracks the
                # cadence.
                pct = (
                    100.0 * n_migrated / len(mover_ids) if len(mover_ids) else 0.0
                )
                self.metrics.migrated_pct_per_round.append(pct)
                obs.gauge("sim.migrated_pct", pct)
            if ctrl_info is not None:
                self._record_controller(
                    ctrl_info["improvement"], ctrl_info["n_degraded"]
                )
                if mig is not None and n_migrated:
                    # Hold down re-triggering while the moved jobs' perf
                    # settles at the new placement.
                    moved = np.unique(
                        self.jt.job_id[self.tt.job[mover_ids[mig]]]
                    )
                    for j in moved:
                        self.qos.migrated(int(j), float(t))

    def _record_controller(self, improvement: float, n_degraded: int) -> None:
        self.metrics.controller_improvement_per_round.append(float(improvement))
        self.metrics.degraded_jobs_per_round.append(float(n_degraded))
        self.metrics.controller_rounds += 1
        obs.add("controller.rounds")
        obs.gauge("sim.degraded_jobs", float(n_degraded))

    def _controller_place(self, state, ctx, mover_ids, degraded, n_ready, t=0.0):
        """One controller round: rank re-placement hypotheses, apply the
        budgeted best.

        Lane 0 freezes every mover (the no-migration baseline). The other
        lanes are the cross product of candidate beta scales
        (``whatif_betas``, defaulting to {0, configured beta}) and mover
        subsets (all degraded jobs' movers; the worst half by QoS sample
        when that is a strict subset). All lanes run through the backend's
        what-if axis; outcomes charge frozen rows their stay cost so totals
        are comparable. If no lane beats the baseline the round migrates
        nothing — the controller never churns on noise. When the chosen
        lane proposes more moves than ``migration_budget``, the
        lowest-improvement moves are reverted (slot-safely) to fit.
        """
        cfg = self.cfg
        T = state.n_tasks
        M = state.n_machines
        betas = list(
            dict.fromkeys(cfg.whatif_betas or (0.0, cfg.params.beta_scale))
        )
        # Mover-subset masks over the round's task rows (ready rows always
        # solve; only mover rows [n_ready:] are ever frozen).
        all_movers = np.ones(T, bool)
        frozen_all = all_movers.copy()
        frozen_all[n_ready:] = False
        subsets = [all_movers]
        if len(degraded) > 1:
            # Worst half of degraded jobs by last sample (lower = worse):
            # a cheaper hypothesis when only part of the degradation is
            # actionable.
            worst = sorted(degraded, key=degraded.get)
            worst = worst[: (len(worst) + 1) // 2]
            mover_jobs = self.jt.job_id[self.tt.job[mover_ids]]
            sub = all_movers.copy()
            sub[n_ready:] = np.isin(mover_jobs, np.asarray(worst, np.int64))
            if sub[n_ready:].any() and not sub[n_ready:].all():
                subsets.append(sub)
        variants = [cfg.params]  # lane 0: all movers frozen (params unused)
        masks = [frozen_all]
        for b in betas:
            vp = dataclasses.replace(cfg.params, beta_scale=b)
            for sub in subsets:
                variants.append(vp)
                masks.append(sub)
        res, algo_s = self.backend.whatif_result(
            state, ctx, variants, active_masks=np.stack(masks)
        )
        outcomes = res.lane_outcomes()
        best = int(np.argmin(outcomes))
        improvement = float(outcomes[0] - outcomes[best])
        if improvement <= 0.0:
            best, improvement = 0, 0.0
        cols = res.assigned[best, :T].astype(np.int64)
        # Frozen rows keep running where they are (col -1 == "no decision",
        # which the mover-apply step treats as stay).
        cols = np.where(masks[best], cols, -1)

        mcols = cols[n_ready:]  # view into cols — reverts write through
        cur = state.cur_machine[n_ready:]
        moves = (mcols >= 0) & (mcols < M) & (mcols != cur)
        n_moves = int(moves.sum())
        n_proposed, n_reverts = n_moves, 0
        if n_moves:
            # Post-application slot balance: placed columns debit, movers
            # staying put (unplaced columns) re-occupy their current slot.
            placedc = cols[(cols >= 0) & (cols < M)]
            free_after = state.free_slots.astype(np.int64) - np.bincount(
                placedc, minlength=M
            )
            mkeep = ~((mcols >= 0) & (mcols < M))
            if mkeep.any():
                np.subtract.at(free_after, cur[mkeep], 1)
            # Per-move true-cost improvement (stay minus move). The lane
            # solve minimizes *jittered* cost, so it proposes zero-gain
            # shuffles that churn tasks for nothing — and under a drifting
            # plane a stale zero-gain move is a loss by the next sample.
            # Revert non-improving moves first, then keep reverting
            # lowest-improvement moves down to the budget.
            imp = res.per_task_stay_cost[best, :T].astype(
                np.int64
            ) - res.per_task_true_cost[best, :T].astype(np.int64)
            cand = np.nonzero(moves)[0]  # mover-row offsets
            order = np.argsort(imp[n_ready + cand], kind="stable")
            for off in cand[order]:
                gain = int(imp[n_ready + off])
                if gain > 0 and n_moves <= cfg.migration_budget:
                    break  # ascending order: the rest improve and fit
                c = int(cur[off])
                # Revert only when the task's old slot is still free after
                # everything else applies — never oversubscribe a machine
                # whose reclaimed slot the solver already handed out.
                if free_after[c] >= 1:
                    free_after[c] -= 1
                    free_after[mcols[off]] += 1
                    cols[n_ready + off] = -1
                    n_moves -= 1
                    n_reverts += 1
        if obs.enabled():
            # Structured audit record: the controller's full decision for
            # this round.
            obs.add("controller.reverts", n_reverts)
            obs.audit_event(
                "controller_round",
                t=float(t),
                degraded_jobs={int(k): float(v) for k, v in degraded.items()},
                lanes=[
                    {
                        "lane": k,
                        "frozen_baseline": k == 0,
                        "beta_scale": float(variants[k].beta_scale),
                        "active_movers": int(masks[k][n_ready:].sum()),
                        "true_cost": int(outcomes[k]),
                    }
                    for k in range(len(variants))
                ],
                chosen_lane=best,
                improvement=float(improvement),
                budget=int(cfg.migration_budget),
                n_moves_proposed=n_proposed,
                n_reverts=n_reverts,
                n_moves_applied=n_moves,
                algo_s=float(algo_s),
            )
        placement = Placement(
            cols=cols, algo_s=algo_s, objective=int(outcomes[best])
        )
        return placement, {
            "improvement": improvement,
            "n_degraded": len(degraded),
        }

    # ------------------------------------------------------------------ #

    def _sample_perf(self, t: float) -> None:
        with obs.span("sim.perf_sample", t=float(t)):
            self._sample_perf_body(t)

    def _sample_perf_body(self, t: float) -> None:
        tt, jt = self.tt, self.jt
        n = tt.n
        if not n:
            return
        jdense = tt.job[:n]
        # Candidate mask over all tasks, in admission order — exactly the
        # seed's jobs-dict iteration order, so per-job sample means see the
        # same element order (float reductions match bit-for-bit).
        mask = (
            (~jt.done[jdense])
            & (jt.root_machine[jdense] >= 0)
            & (tt.task_idx[:n] != 0)
            & (tt.machine[:n] >= 0)
            & (tt.end_s[:n] > t)
        )
        if not mask.any():
            return
        ids = np.nonzero(mask)[0]
        jd = jdense[ids]
        roots = jt.root_machine[jd]
        machines = tt.machine[ids]
        jids = jt.job_id[jd]
        pidx = jt.perf_idx[jd]
        lat = self.plane.latency_pairs(roots, machines, int(t))
        step = np.clip(
            np.round(lat / perf_model.LUT_STEP_US), 0, perf_model.LUT_SIZE - 1
        ).astype(np.int64)
        perf = self.lut_np[pidx, step]
        # Job-level sample: mean predicted performance over its tasks
        # (normalised by the best achievable == 1.0 at same-machine RTT).
        # When jids is non-decreasing (the common case: job_ids assigned in
        # arrival order) each job's tasks form a contiguous run, and a slice
        # mean over the run is bit-identical to the masked mean (same values,
        # order, dtype) at O(T) instead of O(jobs * T).
        contiguous = bool(np.all(jids[1:] >= jids[:-1]))
        if contiguous:
            uniq, starts = np.unique(jids, return_index=True)
            bounds = np.append(starts, len(jids))
            samples = [
                (int(j), float(perf[bounds[k] : bounds[k + 1]].mean()))
                for k, j in enumerate(uniq)
            ]
        else:
            samples = [
                (int(j), float(perf[jids == j].mean())) for j in np.unique(jids)
            ]
        for j, sample in samples:
            self.metrics.record_perf_sample(j, sample)
            if self.straggler is not None and self.straggler.observe(j, sample):
                self._straggler_jobs.add(j)
                self.straggler.clear(j)
            if self.qos is not None:
                self.qos.observe(j, sample, float(t))


def simulate(
    workload,
    plane: LatencyPlane,
    config: SimConfig,
) -> SimMetrics:
    return Simulator(workload, plane, config).run()
