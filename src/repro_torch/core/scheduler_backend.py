"""Pluggable per-round placement engines behind one `SchedulerBackend` API.

Port of `repro.core.scheduler_backend`. Every strategy is a backend with
one required entry point,

    backend.place(state: RoundState, ctx: RoundContext) -> Placement

plus optional axes declared by capability flags (``supports_window``,
``supports_whatif``, ``supports_serving``); calling an optional entry point
whose flag is False raises `BackendCapabilityError`. `Placement.algo_s` is
the backend-measured solver wall time through the one `solver_clock`, which
excludes cost-model construction: the fused ``auction`` backend
synchronises the device (``torch.cuda.synchronize``) before the clock
starts.

Backends in this package:

- `AuctionBackend` (``auction``) — the fused round on the device:
  `policy.device_round_costs` (task/job dims padded to power-of-two
  buckets) into `auction.solve_transportation_device`; on the card the
  costmap and auction_phase kernels run inside it. ``auction_host`` is the
  same solver fed by the numpy `dense_costs` reference.
- `WindowedAuctionBackend` (``auction_windowed``) — the same round math
  through the device-resident `core.round_program.RoundProgram`: `place`
  is an R=1 window (bit-identical to ``auction``), `place_window` runs R
  staged rounds with one read back, `place_whatif` / `whatif_result` run K
  parameter and mover-mask lanes of one round (the migration controller's
  what-if axis).
- `RandomBackend` / `LoadSpreadingBackend` (``random``/``load_spreading``)
  — the paper §6.1 heuristics.
- `MCMFBackend` (``mcmf``) — the paper-faithful Quincy flow network
  (`flow_network`) solved by successive shortest paths (`mcmf`), its
  Bellman-Ford on the device.
- `RandomSolverBackend` / `SpreadSolverBackend` — Firmament-style
  baselines: fixed/load-derived costs through the auction engine.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device

from . import auction, flow_network, mcmf, perf_model
from .policy import (
    INF_COST,
    MAX_MACHINE_COST,
    PolicyParams,
    RoundState,
    dense_costs,
    device_round_costs,
    load_spreading_placement,
    random_placement,
)
from .topology import Topology


class _SolverClock:
    """Elapsed-time handle yielded by `solver_clock`."""

    __slots__ = ("elapsed",)

    def __init__(self) -> None:
        self.elapsed = 0.0

    def per_round(self, n_rounds: int) -> float:
        """Amortised per-round time for fused multi-round dispatches."""
        return self.elapsed / max(int(n_rounds), 1)


@contextlib.contextmanager
def solver_clock(name: str, **span_args):
    """The one ``algo_s`` measurement point shared by every backend.

    Wraps the timed region in an ``obs.span`` (zero-cost when telemetry
    is disabled) and exposes the measured wall time as ``clk.elapsed``
    after the block exits. Callers must perform any device sync *before*
    entering (``torch.cuda.synchronize()`` after the cost build) so the
    clock covers solver work only.
    """
    clk = _SolverClock()
    with obs.span(name, **span_args):
        t0 = time.perf_counter()
        try:
            yield clk
        finally:
            clk.elapsed = time.perf_counter() - t0


@dataclasses.dataclass
class RoundContext:
    """Simulator-side inputs a backend may need beyond the RoundState."""

    rng: np.random.Generator  # shared simulator stream (random baselines)
    task_counts: np.ndarray  # (M,) running tasks per machine (spreading)
    n_ready: int  # state's first n_ready tasks are pending; the rest migrate


@dataclasses.dataclass
class Placement:
    """One round's decision: column per task + the measured solver time."""

    cols: np.ndarray  # (T,) machine id, >= M unscheduled, -1 no decision
    algo_s: float
    objective: Optional[int] = None  # solver objective (cost-model backends)


class BackendCapabilityError(NotImplementedError):
    """An optional `SchedulerBackend` entry point was invoked on a backend
    whose capability flag (``supports_window`` / ``supports_whatif`` /
    ``supports_serving``) is False."""


class SchedulerBackend:
    """Strategy interface for one scheduling round.

    Required: `place`. Optional axes are declared by the ``supports_*``
    capability flags below and default to raising `BackendCapabilityError`
    — callers branch on the flags, never on ``hasattr``.
    """

    name: str = "abstract"
    #: Whether RoundState.root_latency must be populated (cost-model paths).
    needs_latency: bool = True
    #: Whether round admission is capped at free slots + slack (solver
    #: paths; a big backlog against a full cluster degenerates the auction
    #: into unscheduled-price wars).
    caps_admission: bool = True
    #: Whether the backend can re-place running tasks (preemption arcs):
    #: gates periodic migration rounds and the application of mover columns.
    supports_migration: bool = False
    #: Whether straggler/migration rounds feed movers into this backend's
    #: RoundState at all. Solver baselines select movers (their presence
    #: changes the solve and, for random costs, the rng stream — seed
    #: semantics) even though their mover columns are never applied.
    selects_movers: bool = False
    #: Whether `place_window` exists: R staged rounds in one fused dispatch.
    supports_window: bool = False
    #: Whether `place_whatif` / `whatif_result` exist: K parameter (and
    #: mover-mask) variants of one round in one vmapped dispatch.
    supports_whatif: bool = False
    #: Whether the backend can run a long-lived serving loop with a pinned
    #: shape bucket (`pin_serving` / `warm_serving`). True for pure-host
    #: backends; False for the per-round ``auction`` device path, whose
    #: bucket tracks the live task count.
    supports_serving: bool = False

    def place(self, state: RoundState, ctx: RoundContext) -> Placement:
        raise NotImplementedError

    # ------------------------- optional axes ------------------------- #

    def place_window(
        self, states, ctx: Optional[RoundContext] = None, *, chain: bool = False
    ):
        raise BackendCapabilityError(
            f"backend {self.name!r} has no window axis (supports_window=False)"
        )

    def place_whatif(
        self, state: RoundState, ctx: RoundContext, variants
    ) -> Placement:
        raise BackendCapabilityError(
            f"backend {self.name!r} has no what-if axis (supports_whatif=False)"
        )

    def whatif_result(
        self, state: RoundState, ctx: RoundContext, variants, active_masks=None
    ):
        raise BackendCapabilityError(
            f"backend {self.name!r} has no what-if axis (supports_whatif=False)"
        )

    def pin_serving(self, n_tasks: int, n_jobs: int) -> None:
        """Fix the compiled shapes a serving loop will run under.

        Host backends compile nothing; their pin is a no-op.
        """
        if not self.supports_serving:
            raise BackendCapabilityError(
                f"backend {self.name!r} cannot serve (supports_serving=False)"
            )

    def warm_serving(self, free_slots: np.ndarray, root_latency=None) -> None:
        """Run the pinned serving path once, ahead of the loop
        (results-harmless). No-op on host backends."""
        if not self.supports_serving:
            raise BackendCapabilityError(
                f"backend {self.name!r} cannot serve (supports_serving=False)"
            )


class RandomBackend(SchedulerBackend):
    name = "random"
    needs_latency = False
    caps_admission = False
    supports_serving = True  # pure host: nothing compiles

    def place(self, state: RoundState, ctx: RoundContext) -> Placement:
        with solver_clock("solver.random") as clk:
            cols = random_placement(ctx.rng, state.n_tasks, state.free_slots)
        return Placement(cols=cols, algo_s=clk.elapsed)


class LoadSpreadingBackend(SchedulerBackend):
    name = "load_spreading"
    needs_latency = False
    caps_admission = False
    supports_serving = True  # pure host: nothing compiles

    def place(self, state: RoundState, ctx: RoundContext) -> Placement:
        with solver_clock("solver.load_spreading") as clk:
            cols = load_spreading_placement(
                ctx.task_counts, state.free_slots, state.n_tasks
            )
        return Placement(cols=cols, algo_s=clk.elapsed)


class _SolverBaselineBackend(SchedulerBackend):
    """Fixed-cost (random) / task-count (load-spreading) matrices run
    through the same auction engine, on ``device``, mirroring Firmament
    baseline policies (the paper's Fig. 6 compares *solver* runtimes)."""

    needs_latency = False
    selects_movers = True  # movers enter the solve; columns never applied
    supports_serving = True  # nothing to pin

    def __init__(self, params: PolicyParams, topo: Topology, *, device="cuda"):
        self.params = params
        self.topo = topo
        self.device = resolve_device(device)

    def _machine_costs(self, state: RoundState, ctx: RoundContext) -> np.ndarray:
        raise NotImplementedError

    def place(self, state: RoundState, ctx: RoundContext) -> Placement:
        T, J, M = state.n_tasks, state.n_jobs, state.n_machines
        w = np.full((T, M + J), int(INF_COST), np.int64)
        w[:, :M] = self._machine_costs(state, ctx)
        a = (self.params.omega * state.wait_s + self.params.gamma).astype(
            np.int64
        )
        w[np.arange(T), M + state.task_job] = a
        with solver_clock(f"solver.{self.name}") as clk:
            res = auction.solve_transportation(
                w,
                state.free_slots.astype(np.int64),
                M,
                M + state.task_job.astype(np.int64),
                slots_per_machine=self.topo.slots_per_machine,
                exact=False,
                device=self.device,
            )
        obs.add("auction.iterations", res.iterations)
        return Placement(
            cols=np.asarray(res.assigned_col, np.int64),
            algo_s=clk.elapsed,
            objective=res.total_cost,
        )


class RandomSolverBackend(_SolverBaselineBackend):
    name = "random_solver"

    def _machine_costs(self, state: RoundState, ctx: RoundContext) -> np.ndarray:
        # Fixed cost + random tie-break jitter (a flat matrix makes any
        # assignment optimal; jitter picks one uniformly and keeps the
        # auction free of degenerate price wars).
        return 100 + ctx.rng.integers(
            0, 10, size=(state.n_tasks, state.n_machines)
        ).astype(np.int64)


class SpreadSolverBackend(_SolverBaselineBackend):
    name = "spread_solver"

    def _machine_costs(self, state: RoundState, ctx: RoundContext) -> np.ndarray:
        return 100 + np.broadcast_to(
            ctx.task_counts[None, :], (state.n_tasks, state.n_machines)
        ).astype(np.int64)


class AuctionBackend(SchedulerBackend):
    """NoMora cost model + auction solver (fused on the device, or fed by
    the host reference).

    ``fused=True`` (the default, name ``auction``) runs the whole round —
    costmap, rack reduce, thresholds, preemption discount, value scaling,
    auction — as torch tensor code on ``device``, padding the varying dims
    to power-of-two buckets; on the card the costmap and auction_phase CUDA
    kernels carry it. ``fused=False`` (name ``auction_host``) is the numpy
    `dense_costs` + `solve_transportation` path, its phase also on
    ``device``. Both give bit-identical placements. (The reference calls
    the flag ``device``; here ``device`` is the torch device.)
    """

    supports_migration = True
    selects_movers = True

    def __init__(
        self,
        params: PolicyParams,
        topo: Topology,
        lut_table=None,
        *,
        fused: bool = True,
        device="cuda",
        tie_jitter: int = 9,
        exact: bool = False,
    ):
        self.params = params
        self.topo = topo
        self.device = resolve_device(device)
        lut = perf_model.perf_lut_table() if lut_table is None else lut_table
        self.lut = torch.as_tensor(lut, dtype=torch.float32).to(self.device)
        self.fused = fused
        self.tie_jitter = tie_jitter
        self.exact = exact
        self.name = "auction" if fused else "auction_host"
        self.supports_serving = not fused

    def place(self, state: RoundState, ctx: RoundContext) -> Placement:
        if not self.fused:
            costs = dense_costs(state, self.topo, self.params, self.lut)
            M = state.n_machines
            with solver_clock("solver.auction_host") as clk:
                res = auction.solve_transportation(
                    costs.w,
                    costs.col_capacity[:M],
                    M,
                    M + state.task_job.astype(np.int64),
                    slots_per_machine=self.topo.slots_per_machine,
                    tie_jitter=self.tie_jitter,
                    exact=self.exact,
                    device=self.device,
                )
            obs.add("auction.iterations", res.iterations)
            return Placement(
                cols=np.asarray(res.assigned_col, np.int64),
                algo_s=clk.elapsed,
                objective=res.total_cost,
            )

        # Fused device round. Synchronising after the cost build keeps
        # algo_s solve-only, comparable with every host-side backend and
        # the paper's Fig. 6 measurement points.
        w_m, a, _, _, _ = device_round_costs(
            state,
            self.topo,
            self.params,
            self.lut,
            n_pad_tasks=auction._bucket(state.n_tasks),
            n_pad_jobs=auction._bucket(state.n_jobs, 8),
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if obs.enabled():
            # Bucket pad waste: padded rows solved beyond the real tasks.
            obs.add(
                "auction.pad_waste_tasks",
                auction._bucket(state.n_tasks) - state.n_tasks,
            )
        with solver_clock("solver.auction") as clk:
            # Host-side cost bound: machine arcs are <= 10000 by
            # construction, the unscheduled column is known from the
            # (host) wait times.
            a_max = int(self.params.omega * float(state.wait_s.max(initial=0.0))
                        + self.params.gamma) + 1
            res = auction.solve_transportation_device(
                w_m,
                a,
                state.n_tasks,
                state.free_slots,
                state.n_machines,
                state.task_job,
                slots_per_machine=self.topo.slots_per_machine,
                tie_jitter=self.tie_jitter,
                exact=self.exact,
                cost_bound=max(MAX_MACHINE_COST, a_max),
            )
        obs.add("auction.iterations", res.iterations)
        return Placement(
            cols=np.asarray(res.assigned_col, np.int64),
            algo_s=clk.elapsed,
            objective=res.total_cost,
        )


class WindowedAuctionBackend(AuctionBackend):
    """NoMora round through the device-resident `RoundProgram`.

    The same cost model and auction solver as ``auction``, but the whole
    round — cost build, value prep, solve, objective — runs in the window
    program, whose round-invariant inputs (perf LUT, tie-jitter matrix) and
    state stay on the device across calls. Entry points:

    - `place` — `SchedulerBackend` contract, one round per call (an R=1
      window): bit-identical placements to ``auction``. ``algo_s`` covers
      cost build plus solve (they are one program, as in the reference)
      and ends after the host read of the columns.
    - `place_window` — R rounds with no host read between them; per-round
      results are bit-identical to R sequential `place` calls. ``chain``
      threads slot consumption through the window on the device (round r+1
      sees round r's placements). Each `Placement` reports the window's
      time over R.
    - `place_whatif` — K `PolicyParams` variants of one round, returning
      the placement of the variant with the lowest *true* (undiscounted)
      cost; `whatif_result` returns all K lanes (with per-lane mover
      masks) for the migration controller.

    Serving (``supports_serving``): `pin_serving` fixes a bucket floor so
    every round of a long-lived loop re-enters one program and its carry
    regardless of the live-task count, and `warm_serving` runs it once.
    """

    supports_window = True
    supports_whatif = True

    def __init__(self, params: PolicyParams, topo: Topology, lut_table=None, *,
                 device="cuda", tie_jitter: int = 9, exact: bool = False):
        super().__init__(params, topo, lut_table, fused=True, device=device,
                         tie_jitter=tie_jitter, exact=exact)
        self.name = "auction_windowed"
        self.supports_serving = True  # buckets pin via pin_serving
        self._programs: dict = {}  # (Tp, Jp, chain) -> RoundProgram
        self._states: dict = {}  # (Tp, Jp, chain) -> DeviceRoundState
        self._pin = (0, 0)  # serving bucket floor (Tp, Jp); (0, 0) = unpinned

    def pin_serving(self, n_tasks: int, n_jobs: int) -> None:
        """Pin the (task, job) bucket floor for long-lived serving: every
        later `_program` lookup rounds up to at least this bucket, so rounds
        with any live-task count <= the pin re-enter the SAME program and
        carry. Rounds that exceed the pin fall onto a larger bucket."""
        self._pin = (
            auction._bucket(max(int(n_tasks), 1)),
            auction._bucket(max(int(n_jobs), 1), 8),
        )

    def warm_serving(self, free_slots: np.ndarray, root_latency=None) -> None:
        """Run the pinned R=1 window program on a synthetic round (see
        `RoundProgram.warmup`) so the serving loop's first real decision
        finds everything built. Results-harmless: the warmup carry is
        discarded, and exogenous windows never read carried occupancy."""
        _key, prog = self._program(max(self._pin[0], 1), max(self._pin[1], 1))
        prog.warmup(np.asarray(free_slots), root_latency=root_latency)

    def _program(self, n_tasks: int, n_jobs: int, *, chain: bool = False):
        from .round_program import RoundProgram

        key = (
            max(auction._bucket(n_tasks), self._pin[0]),
            max(auction._bucket(n_jobs, 8), self._pin[1]),
            chain,
        )
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = RoundProgram(
                self.topo,
                self.params,
                self.lut,
                n_pad_tasks=key[0],
                n_pad_jobs=key[1],
                slots_per_machine=self.topo.slots_per_machine,
                tie_jitter=self.tie_jitter,
                exact=self.exact,
                chain_slots=chain,
                device=self.device,
            )
        return key, prog

    def _state_for(self, key, prog, free_slots):
        """Per-bucket persistent carry, built on first use. The entry is
        *popped*: if `advance` raises (iteration cap, convergence) the
        next call on this bucket starts from a fresh carry; the caller
        re-caches the advanced state on success."""
        st = self._states.pop(key, None)
        if st is None:
            st = prog.init_state(free_slots)
        return st

    def place(self, state: RoundState, ctx: RoundContext) -> Placement:
        from .round_program import stack_round_states

        key, prog = self._program(state.n_tasks, state.n_jobs)
        window = stack_round_states(
            [state], n_pad_tasks=prog.n_pad_tasks, n_pad_jobs=prog.n_pad_jobs,
            exact=self.exact,
        )
        dstate = self._state_for(key, prog, state.free_slots)
        with solver_clock("solver.auction_windowed") as clk:
            dstate, res = prog.advance(dstate, window)
        self._states[key] = dstate
        return Placement(
            cols=res.round_cols(0),
            algo_s=clk.elapsed,
            objective=res.round_objective(0),
        )

    def place_window(
        self, states, ctx: Optional[RoundContext] = None, *, chain: bool = False
    ):
        """Solve R staged rounds with one read back.

        ``chain=False``: every round uses its own ``free_slots`` exactly as
        R sequential `place` calls would (bit-identical). ``chain=True``:
        round 0 starts from ``states[0].free_slots`` and later rounds'
        ``free_slots`` fields are per-round *deltas* on the device-carried
        occupancy (see `round_program.RoundProgram`). Returns a list of
        `Placement`.
        """
        from .round_program import stack_round_states

        if not states:
            return []
        key, prog = self._program(
            max(s.n_tasks for s in states),
            max(s.n_jobs for s in states),
            chain=chain,
        )
        window = stack_round_states(
            states, n_pad_tasks=prog.n_pad_tasks, n_pad_jobs=prog.n_pad_jobs,
            exact=self.exact,
        )
        if chain:
            # Round 0's row becomes the delta on the freshly-seeded carry.
            dstate = prog.init_state(states[0].free_slots)
            window.free_slots[0] = 0
        else:
            dstate = self._state_for(key, prog, states[0].free_slots)
        with solver_clock(
            "solver.auction_windowed.window", rounds=len(states), chain=chain
        ) as clk:
            dstate, res = prog.advance(dstate, window)
        algo_s = clk.per_round(len(states))
        if not chain:
            # Chained windows seed a fresh carry per call; caching theirs
            # would pin device buffers nothing reads again.
            self._states[key] = dstate
        return [
            Placement(cols=res.round_cols(r), algo_s=algo_s,
                      objective=res.round_objective(r))
            for r in range(len(states))
        ]

    def place_whatif(self, state: RoundState, ctx: RoundContext, variants) -> Placement:
        """One round under K `PolicyParams` variants; returns the placement
        of the variant with the lowest true (undiscounted) cost. With a
        single variant this is `place` under that variant's params, bit for
        bit."""
        _key, prog = self._program(state.n_tasks, state.n_jobs)
        variants = list(variants)
        with solver_clock("solver.auction_windowed.whatif", lanes=len(variants)) as clk:
            res = prog.what_if(state, variants)
        best = res.best_variant()
        return Placement(
            cols=res.variant_cols(best),
            algo_s=clk.elapsed,
            objective=int(res.per_task_cost[best].astype(np.int64).sum()),
        )

    def whatif_result(self, state: RoundState, ctx: RoundContext, variants,
                      active_masks=None):
        """The raw what-if axis for the migration controller: K
        (PolicyParams, mover-mask) lanes of one round, returning the full
        `WhatIfResult` (placements, true costs, stay costs) and the lanes'
        wall time — the controller ranks lanes and applies budgets on the
        host."""
        _key, prog = self._program(state.n_tasks, state.n_jobs)
        variants = list(variants)
        with solver_clock("solver.auction_windowed.whatif", lanes=len(variants)) as clk:
            res = prog.what_if(state, variants, active_masks=active_masks)
        return res, clk.elapsed


class MCMFBackend(SchedulerBackend):
    """Paper-faithful Quincy flow network + SSP MCMF (the oracle solver):
    host costs and graph, the Bellman-Ford on ``device``."""

    name = "mcmf"
    supports_migration = True
    selects_movers = True
    supports_serving = True  # no shape to pin

    def __init__(self, params: PolicyParams, topo: Topology, lut_table=None, *,
                 device="cuda"):
        self.params = params
        self.topo = topo
        self.lut = perf_model.perf_lut_table() if lut_table is None else lut_table
        self.device = resolve_device(device)

    def place(self, state: RoundState, ctx: RoundContext) -> Placement:
        costs = dense_costs(state, self.topo, self.params, self.lut)
        with solver_clock("solver.mcmf") as clk:
            g = flow_network.build_flow_graph(state, self.topo, self.params, costs)
            fr = mcmf.min_cost_max_flow(
                g.src, g.dst, g.cap, g.cost, g.source, g.sink, g.n_nodes,
                device=self.device,
            )
            cols = flow_network.extract_assignment(g, fr.flow, state)
        return Placement(
            cols=np.asarray(cols, np.int64),
            algo_s=clk.elapsed,
            objective=int(fr.total_cost),
        )


BACKEND_NAMES = (
    "auction",
    "auction_windowed",
    "auction_host",
    "mcmf",
    "random",
    "load_spreading",
    "random_solver",
    "spread_solver",
)


def make_backend(
    name: str,
    params: PolicyParams,
    topo: Topology,
    lut_table=None,
    *,
    device="cuda",
) -> SchedulerBackend:
    """Instantiate a backend by name (see BACKEND_NAMES)."""
    if name == "random":
        return RandomBackend()
    if name == "load_spreading":
        return LoadSpreadingBackend()
    if name == "random_solver":
        return RandomSolverBackend(params, topo, device=device)
    if name == "spread_solver":
        return SpreadSolverBackend(params, topo, device=device)
    if name == "auction":
        return AuctionBackend(params, topo, lut_table, fused=True, device=device)
    if name == "auction_windowed":
        return WindowedAuctionBackend(params, topo, lut_table, device=device)
    if name == "auction_host":
        return AuctionBackend(params, topo, lut_table, fused=False, device=device)
    if name == "mcmf":
        return MCMFBackend(params, topo, lut_table, device=device)
    raise KeyError(f"unknown scheduler backend {name!r}; one of {BACKEND_NAMES}")


def backend_for_config(cfg, topo: Topology, lut_table=None) -> SchedulerBackend:
    """Resolve a SimConfig to a backend on ``cfg.device``: explicit
    ``cfg.backend`` wins, otherwise the (policy, solver) pair maps onto a
    name."""
    if getattr(cfg, "backend", None):
        name = cfg.backend
    else:
        name = {
            "random": "random",
            "load_spreading": "load_spreading",
            "random_solver": "random_solver",
            "spread_solver": "spread_solver",
            "nomora": "auction" if cfg.solver == "auction" else "mcmf",
        }[cfg.policy]
    return make_backend(name, cfg.params, topo, lut_table, device=cfg.device)
