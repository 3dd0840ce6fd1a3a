"""Golden-reference simulator: the seed per-task-object event loop.

Port of `repro.core.reference_sim`: the original `simulator.Simulator`
implementation (per-`TaskRec` Python lists, per-round Python `for` loops),
kept as the semantic oracle for the vectorized structure-of-arrays engine
in `simulator.py`/`engine.py`. Tests assert the two produce bit-identical
`SimMetrics` at fixed seeds, and that this loop equals the reference's.
Its solves (auction and MCMF) run on ``SimConfig.device``.

Do not optimise this module: its value is that it spells the paper's §6
semantics one task at a time. New behaviour lands in the vectorized engine
first and is mirrored here only when the semantics themselves change.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.distributed.straggler import StragglerDetector

from . import auction, flow_network, mcmf, perf_model
from .latency import LatencyPlane
from .metrics import SimMetrics
from .scheduler_backend import solver_clock
from .policy import (
    RoundState,
    dense_costs,
    load_spreading_placement,
    random_placement,
)
from .simulator import JobRec, SimConfig, TaskRec
from .workload import Job, Workload


class ReferenceSimulator:
    """Per-object event loop (seed semantics); see module docstring."""

    def __init__(
        self,
        workload: Workload,
        plane: LatencyPlane,
        config: SimConfig,
    ):
        self.wl = workload
        self.topo = workload.topo
        self.plane = plane
        self.cfg = config
        self.device = resolve_device(config.device)
        self.rng = np.random.default_rng(config.seed)
        self.metrics = SimMetrics()
        self.lut = perf_model.perf_lut_table()
        self.lut_np = self.lut.numpy()

        M = self.topo.n_machines
        self.free_slots = np.full(M, self.topo.slots_per_machine, np.int32)
        self.task_counts = np.zeros(M, np.int64)  # for load-spreading
        self.jobs: Dict[int, JobRec] = {}
        self.pending_roots: List[TaskRec] = []
        self.pending: List[TaskRec] = []  # non-root tasks awaiting placement
        self.running: List[TaskRec] = []
        self.dead: set = set()  # failed machines
        self._failures = sorted(config.failures)
        self.straggler = (
            StragglerDetector(threshold=config.straggler_threshold)
            if config.straggler_threshold is not None
            else None
        )
        self._straggler_jobs: set = set()

    # ------------------------------------------------------------------ #

    def run(self) -> SimMetrics:
        cfg = self.cfg
        duration = self.wl.duration_s
        jobs_iter = iter(self.wl.jobs)
        next_job = next(jobs_iter, None)

        for t in range(0, duration, cfg.round_interval_s):
            # 1. Admit arrivals.
            while next_job is not None and next_job.arrival_s <= t:
                self._admit(next_job, t)
                next_job = next(jobs_iter, None)

            # 1b. Machine-removal events (fault tolerance).
            while self._failures and self._failures[0][0] <= t:
                _, machine = self._failures.pop(0)
                self._fail_machine(int(machine), t)

            # 2. Retire finished tasks / jobs.
            self._retire(t)

            # 3. Scheduling round.
            migration_round = (
                cfg.policy == "nomora"
                and cfg.params.preemption
                and t % cfg.migration_interval_s == 0
            )
            straggler_round = bool(self._straggler_jobs)
            if self.pending_roots or self.pending or migration_round or straggler_round:
                self._round(t, migration_round or straggler_round)

            # 4. Performance sampling.
            if t % cfg.perf_sample_interval_s == 0:
                self._sample_perf(t)

            # 5. Wait-time accrual.
            for task in self.pending:
                task.wait_s += cfg.round_interval_s

        return self.metrics

    # ------------------------------------------------------------------ #

    def _algo_s(self, measured: float) -> float:
        return measured if self.cfg.fixed_algo_s is None else self.cfg.fixed_algo_s

    def _admit(self, job: Job, t: float) -> None:
        tasks = [
            TaskRec(job_id=job.job_id, task_idx=i, submit_s=float(max(t, job.arrival_s)))
            for i in range(job.n_tasks)
        ]
        rec = JobRec(job=job, tasks=tasks)
        self.jobs[job.job_id] = rec
        self.pending_roots.append(tasks[0])
        self.pending.extend(tasks[1:])

    def _fail_machine(self, machine: int, t: float) -> None:
        """Machine removal: zero its capacity, re-queue its tasks (the
        paper's cluster-event handling; recovery = re-placement)."""
        if machine in self.dead:
            return
        self.dead.add(machine)
        self.free_slots[machine] = 0
        self.task_counts[machine] = 0
        still = []
        for task in self.running:
            if task.machine == machine:
                task.machine = -1
                task.start_s = -1.0
                task.end_s = -1.0
                task.wait_s = 0.0
                rec = self.jobs[task.job_id]
                if task.task_idx == 0:
                    rec.root_machine = -1
                    self.pending_roots.append(task)
                else:
                    self.pending.append(task)
            else:
                still.append(task)
        self.running = still

    def _retire(self, t: float) -> None:
        still = []
        for task in self.running:
            if task.end_s <= t:
                if task.machine not in self.dead:
                    self.free_slots[task.machine] += 1
                    self.task_counts[task.machine] -= 1
                self.metrics.response_time_s.append(task.end_s - task.submit_s)
            else:
                still.append(task)
        self.running = still
        for rec in self.jobs.values():
            if not rec.done and all(tk.end_s >= 0 and tk.end_s <= t for tk in rec.tasks):
                rec.done = True

    def _start_task(self, task: TaskRec, machine: int, t: float, algo_s: float) -> None:
        rec = self.jobs[task.job_id]
        task.machine = machine
        task.placed_s = t + algo_s
        task.start_s = t + algo_s
        task.end_s = task.start_s + rec.job.duration_s
        self.free_slots[machine] -= 1
        self.task_counts[machine] += 1
        self.running.append(task)
        self.metrics.tasks_placed += 1
        self.metrics.placement_latency_s.append(task.placed_s - task.submit_s)
        if task.task_idx == 0:
            rec.root_machine = machine

    def _round(self, t: float, migration_round: bool) -> None:
        cfg = self.cfg

        # Roots: immediate placement on any available machine (random).
        for root in list(self.pending_roots):
            free_m = np.nonzero(self.free_slots > 0)[0]
            if len(free_m) == 0:
                root.wait_s += cfg.round_interval_s
                continue
            m = int(self.rng.choice(free_m))
            self.pending_roots.remove(root)
            self._start_task(root, m, t, 0.0)

        if cfg.policy == "random":
            self._round_baseline(t, random=True)
        elif cfg.policy == "load_spreading":
            self._round_baseline(t, random=False)
        else:
            self._round_nomora(t, migration_round)

    def _baseline_costs(self, state: RoundState):
        """Fixed-cost (random) / task-count (load-spreading) matrices run
        through the same solver, mirroring Firmament baseline policies."""
        T, J, M = state.n_tasks, state.n_jobs, state.n_machines
        if self.cfg.policy == "random_solver":
            # Fixed cost + random tie-break jitter (a flat matrix makes any
            # assignment optimal; jitter picks one uniformly and keeps the
            # auction free of degenerate price wars).
            w_m = 100 + self.rng.integers(0, 10, size=(T, M)).astype(np.int64)
        else:  # spread_solver: prefer less-loaded machines
            w_m = 100 + np.broadcast_to(
                self.task_counts[None, :], (T, M)
            ).astype(np.int64)
        w = np.full((T, M + J), int(2**30), np.int64)
        w[:, :M] = w_m
        a = (self.cfg.params.omega * state.wait_s + self.cfg.params.gamma).astype(
            np.int64
        )
        w[np.arange(T), M + state.task_job] = a
        return w

    def _round_baseline(self, t: float, random: bool) -> None:
        # Baselines schedule whatever is pending whose root is placed; the
        # random policy uses fixed costs (schedule if idle), load-spreading
        # balances task counts (paper §6.1).
        ready = [
            task
            for task in self.pending
            if self.jobs[task.job_id].root_machine >= 0
        ][: self.cfg.max_round_tasks]
        if not ready:
            return
        with solver_clock(
            "solver.reference.baseline", random=bool(random)
        ) as clk:
            if random:
                cols = random_placement(self.rng, len(ready), self.free_slots)
            else:
                cols = load_spreading_placement(
                    self.task_counts, self.free_slots, len(ready)
                )
        algo_s = self._algo_s(clk.elapsed)
        self.metrics.algo_runtime_s.append(algo_s)
        self.metrics.rounds += 1
        for task, m in zip(ready, cols):
            if m >= 0:
                self.pending.remove(task)
                self._start_task(task, int(m), t, algo_s)

    def _build_round_state(
        self, ready: List[TaskRec], movers: List[TaskRec], t: float
    ) -> RoundState:
        tasks = ready + movers
        job_ids = sorted({task.job_id for task in tasks})
        job_local = {j: i for i, j in enumerate(job_ids)}
        root_machine = np.asarray(
            [self.jobs[j].root_machine for j in job_ids], np.int64
        )
        root_latency = np.stack(
            [self.plane.latency_from(int(m), int(t)) for m in root_machine]
        )
        free = self.free_slots.copy()
        for task in movers:  # movers' slots are reclaimable within the round
            free[task.machine] += 1
        return RoundState(
            task_job=np.asarray([job_local[task.job_id] for task in tasks], np.int64),
            perf_idx=np.asarray(
                [self.jobs[task.job_id].job.perf_idx for task in tasks], np.int64
            ),
            root_machine=root_machine,
            root_latency=root_latency,
            wait_s=np.asarray([task.wait_s for task in tasks], np.float32),
            run_s=np.asarray(
                [max(0.0, t - task.start_s) if task.start_s >= 0 else 0.0 for task in tasks],
                np.float32,
            ),
            cur_machine=np.asarray([task.machine for task in tasks], np.int64),
            free_slots=free,
        )

    def _round_nomora(self, t: float, migration_round: bool) -> None:
        cfg = self.cfg
        # Admit at most (free capacity + slack) tasks per round: admitting a
        # large backlog against a full cluster degenerates the auction into
        # unscheduled-price wars (Firmament likewise schedules what fits;
        # the remainder waits with escalating unscheduled cost).
        admit = min(
            cfg.max_round_tasks, int(self.free_slots.sum()) + 64
        )
        ready = [
            task
            for task in self.pending
            if self.jobs[task.job_id].root_machine >= 0
        ][:admit]
        movers: List[TaskRec] = []
        if migration_round:
            full = cfg.params.preemption and True
            # Root must be placed: a failed root means latency_from(-1)
            # would mis-price the mover (semantics fix mirrored from the
            # vectorized engine; the only deliberate divergence from seed).
            movers = [
                task
                for task in self.running
                if task.task_idx != 0
                and self.jobs[task.job_id].root_machine >= 0
                and (
                    task.job_id in self._straggler_jobs
                    or (full and not self._straggler_jobs)
                )
            ]
            # Bound the round size for tractability.
            movers = movers[: min(cfg.max_round_tasks, 512)]
            self._straggler_jobs.clear()
        if not ready and not movers:
            # A migration round with zero eligible movers still samples the
            # migrated-percentage series (0%) — mirrors the engine, keeping
            # the series aligned with the migration cadence. Solver
            # baselines never record migration metrics (their branch below
            # returns before the record, and the engine's backends report
            # supports_migration=False).
            if migration_round and cfg.policy not in (
                "random_solver",
                "spread_solver",
            ):
                self.metrics.migrated_pct_per_round.append(0.0)
            return

        state = self._build_round_state(ready, movers, t)
        if cfg.policy in ("random_solver", "spread_solver"):
            w = self._baseline_costs(state)
            with solver_clock(f"solver.reference.{cfg.policy}") as clk:
                res = auction.solve_transportation(
                    w,
                    state.free_slots.astype(np.int64),
                    state.n_machines,
                    state.n_machines + state.task_job.astype(np.int64),
                    slots_per_machine=self.topo.slots_per_machine,
                    exact=False,
                    device=self.device,
                )
            obs.add("auction.iterations", res.iterations)
            algo_s = self._algo_s(clk.elapsed)
            self.metrics.algo_runtime_s.append(algo_s)
            self.metrics.rounds += 1
            M = state.n_machines
            for task, col in zip(ready, res.assigned_col):
                if 0 <= int(col) < M:
                    self.pending.remove(task)
                    self._start_task(task, int(col), t, algo_s)
            return
        costs = dense_costs(state, self.topo, cfg.params, self.lut)

        with solver_clock(f"solver.reference.{cfg.solver}") as clk:
            if cfg.solver == "auction":
                M = state.n_machines
                res = auction.solve_transportation(
                    costs.w,
                    costs.col_capacity[:M],
                    M,
                    M + state.task_job.astype(np.int64),
                    slots_per_machine=self.topo.slots_per_machine,
                    tie_jitter=9,
                    exact=False,  # <=1 cost-unit/task slack; 450x fewer tie crawls
                    device=self.device,
                )
                cols = res.assigned_col
                obs.add("auction.iterations", res.iterations)
            else:
                g = flow_network.build_flow_graph(
                    state, self.topo, cfg.params, costs
                )
                fr = mcmf.min_cost_max_flow(
                    g.src, g.dst, g.cap, g.cost, g.source, g.sink, g.n_nodes,
                    device=self.device,
                )
                cols = flow_network.extract_assignment(g, fr.flow, state)
        algo_s = self._algo_s(clk.elapsed)
        self.metrics.algo_runtime_s.append(algo_s)
        self.metrics.rounds += 1

        M = state.n_machines
        tasks = ready + movers
        n_running = len(movers)
        n_migrated = 0
        for task, col in zip(tasks, cols):
            col = int(col)
            if task in self.pending:
                if 0 <= col < M:
                    self.pending.remove(task)
                    self._start_task(task, col, t, algo_s)
                # else stays pending (unscheduled aggregator)
            else:  # running mover
                if 0 <= col < M and col != task.machine:
                    # Migration: move without restart.
                    self.free_slots[task.machine] += 1
                    self.task_counts[task.machine] -= 1
                    task.machine = col
                    self.free_slots[col] -= 1
                    self.task_counts[col] += 1
                    n_migrated += 1
                    self.metrics.tasks_migrated += 1
                # col == unscheduled for a running task: keep it running
                # (eviction-to-idle is never profitable under Eq. 10 costs).
        if migration_round:
            # 0.0 when no movers were eligible — every migration round
            # contributes exactly one sample (engine parity).
            self.metrics.migrated_pct_per_round.append(
                100.0 * n_migrated / n_running if n_running else 0.0
            )

    # ------------------------------------------------------------------ #

    def _sample_perf(self, t: float) -> None:
        roots, machines, jids, pidx = [], [], [], []
        for rec in self.jobs.values():
            if rec.done or rec.root_machine < 0:
                continue
            for task in rec.tasks:
                if task.task_idx == 0 or task.machine < 0 or task.end_s <= t:
                    continue
                roots.append(rec.root_machine)
                machines.append(task.machine)
                jids.append(rec.job.job_id)
                pidx.append(rec.job.perf_idx)
        if not roots:
            return
        lat = self.plane.latency_pairs(np.asarray(roots), np.asarray(machines), int(t))
        step = np.clip(
            np.round(lat / perf_model.LUT_STEP_US), 0, perf_model.LUT_SIZE - 1
        ).astype(np.int64)
        perf = self.lut_np[np.asarray(pidx), step]
        jids = np.asarray(jids)
        for j in np.unique(jids):
            # Job-level sample: mean predicted performance over its tasks
            # (normalised by the best achievable == 1.0 at same-machine RTT).
            sample = float(perf[jids == j].mean())
            self.metrics.record_perf_sample(int(j), sample)
            if self.straggler is not None and self.straggler.observe(int(j), sample):
                self._straggler_jobs.add(int(j))
                self.straggler.clear(int(j))


def reference_simulate(
    workload: Workload,
    plane: LatencyPlane,
    config: SimConfig,
) -> SimMetrics:
    return ReferenceSimulator(workload, plane, config).run()
