"""Multi-scenario sweep runner: (policy x seed x scenario) grids.

Port of `repro.core.sweep`. The cells' rounds run on ``run_sweep``'s
``device`` (default ``"cuda"``), which is a run argument, not part of the
`SweepSpec`: saved results stay byte-compatible with the reference's, so
one merge applies to both. Pool workers are spawned (a forked child
cannot use a CUDA context its parent created) and each resolves the
device itself.

Runs the vectorized simulator over a full evaluation grid against one
shared cluster: the topology and base `LatencyPlane` are built once per
process and reused by every cell (scenarios that perturb latency derive a
plane copy, cached per scenario), workloads are synthesized once per
(seed, scenario) and reused across policies. This is the harness behind
`benchmarks/sweep_bench.py` and `examples/sweep_cluster.py`.

Cells are independent, so `run_sweep(spec, workers=N)` shards the grid
over a ``multiprocessing`` spawn pool: each worker rebuilds its shared
objects from the spec (cached per process), and results merge back
deterministically in `SweepSpec.cells()` grid order — byte-identical to a
sequential run when `fixed_algo_s` pins solver wall time (only the
per-cell `wall_s` stamps differ).

Multi-host partitioning: ``run_sweep(spec, shard=(i, n))`` runs only the
``i``-th of ``n`` contiguous, deterministic slices of `SweepSpec.cells()`
(balanced like ``np.array_split``, so each (scenario, seed) cache group
stays on one host where possible). Each shard saves its own JSON;
`merge_sweep_results` (or `load_sweep_result` + merge) recombines the
shards into the full grid, cell-for-cell identical to the single-host
`run_sweep` output for the same spec (summaries are bit-identical under
`fixed_algo_s`; only wall-clock stamps differ).

A policy axis entry may select a scheduler backend per cell with a
``policy:backend`` suffix — e.g. ``"nomora:mcmf"`` or
``"nomora:auction_host"`` (see `scheduler_backend.BACKEND_NAMES`); bare
names keep the default backend mapping. Cell identity is the typed
`CellSpec` (`SweepSpec.cells()` emits them); the colon string survives
only as `CellSpec.label` / `CellSpec.parse` and in saved-JSON
`SweepCell.policy` fields.

Results serialise to JSON (`SweepResult.to_jsonable` / `save`) so runs at
different scales or commits stay comparable.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import multiprocessing
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch import obs

from .latency import LatencyPlane
from .scenarios import Scenario, get_scenario
from .simulator import SimConfig, Simulator
from .topology import Topology
from .trace import synth_trace
from .workload import synth_workload

DEFAULT_POLICIES = ("random", "load_spreading", "nomora")


def _scrub(x):
    """NaN/inf -> None so saved sweeps are strict JSON."""
    if isinstance(x, dict):
        return {k: _scrub(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_scrub(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """Typed identity of one sweep grid cell.

    ``policy`` is the bare policy name; an explicit scheduler backend
    (the old ``"policy:backend"`` suffix) lives in ``backend``. `label`
    renders the legacy colon form (used in progress lines and saved
    JSON); `parse` accepts it.
    """

    scenario: str
    seed: int
    policy: str
    backend: Optional[str] = None

    @property
    def label(self) -> str:
        """Legacy ``policy[:backend]`` string form of the policy axis."""
        return f"{self.policy}:{self.backend}" if self.backend else self.policy

    @classmethod
    def parse(cls, scenario: str, seed: int, policy_label: str) -> "CellSpec":
        """Build from the legacy ``policy[:backend]`` string label."""
        base, backend = split_policy(policy_label)
        return cls(scenario=scenario, seed=int(seed), policy=base, backend=backend)


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One sweep grid: cluster shape + the (policy x seed x scenario) axes."""

    n_machines: int = 256
    machines_per_rack: int = 16
    racks_per_pod: int = 4
    slots_per_machine: int = 4
    duration_s: int = 420
    target_utilisation: float = 0.6
    policies: Tuple[str, ...] = DEFAULT_POLICIES
    seeds: Tuple[int, ...] = (0,)
    scenarios: Tuple[str, ...] = ("baseline",)
    plane_seed: int = 42
    # Pin solver wall time in the metrics (0.0 => fully deterministic cells;
    # None => measured, as in production replays).
    fixed_algo_s: Optional[float] = None

    def topology(self) -> Topology:
        return Topology(
            n_machines=self.n_machines,
            machines_per_rack=self.machines_per_rack,
            racks_per_pod=self.racks_per_pod,
            slots_per_machine=self.slots_per_machine,
        )

    def cells(self) -> List[CellSpec]:
        """Typed grid cells, scenario-major, then seed, then policy —
        workloads and planes are cached at the outer levels. Policy-axis
        entries may carry the legacy ``policy:backend`` suffix; it is
        parsed into `CellSpec.backend` here."""
        return [
            CellSpec.parse(scenario, seed, policy)
            for scenario in self.scenarios
            for seed in self.seeds
            for policy in self.policies
        ]


@dataclasses.dataclass
class SweepCell:
    scenario: str
    seed: int
    policy: str
    summary: Dict[str, float]
    wall_s: float
    # Per-cell telemetry counter deltas (repro_torch.obs), captured when
    # telemetry is enabled in the executing process; None otherwise (and
    # in pre-telemetry saved sweeps). Only *deterministic* counters are
    # recorded (``jit.*`` kernel build accounting is excluded), so the cell's
    # telemetry is identical whether the cell ran in a full single-host
    # sweep, a worker pool, or an (i, n) shard — merge-safe exactly like
    # the summaries. NOTE: spawn-pool workers re-read ``REPRO_OBS`` from
    # the environment; a programmatic ``obs.set_enabled(True)`` in the
    # parent does not reach ``workers > 1`` cells.
    telemetry: Optional[Dict[str, float]] = None


@dataclasses.dataclass
class SweepResult:
    spec: SweepSpec
    cells: List[SweepCell]
    wall_s: float = 0.0
    # (i, n) when this result holds shard i of an n-way partition of the
    # grid; None for a full (single-host or merged) result.
    shard: Optional[Tuple[int, int]] = None

    def cell(self, scenario: str, seed: int, policy: str) -> SweepCell:
        for c in self.cells:
            if (c.scenario, c.seed, c.policy) == (scenario, seed, policy):
                return c
        raise KeyError((scenario, seed, policy))

    def to_jsonable(self) -> Dict:
        return _scrub(
            {
                "spec": dataclasses.asdict(self.spec),
                "wall_s": self.wall_s,
                "shard": list(self.shard) if self.shard is not None else None,
                "cells": [dataclasses.asdict(c) for c in self.cells],
            }
        )

    @classmethod
    def from_jsonable(cls, d: Dict) -> "SweepResult":
        spec_d = dict(d["spec"])
        for k in ("policies", "seeds", "scenarios"):
            spec_d[k] = tuple(spec_d[k])
        shard = d.get("shard")
        return cls(
            spec=SweepSpec(**spec_d),
            cells=[SweepCell(**c) for c in d["cells"]],
            wall_s=d.get("wall_s", 0.0),
            shard=tuple(shard) if shard is not None else None,
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_jsonable(), f, indent=2, sort_keys=True)
            f.write("\n")

    def table(self, metric: str = "avg_app_perf_area") -> str:
        """Plain-text (scenario x policy) table of `metric`, seed-averaged."""
        lines = [f"{'scenario':18s} " + " ".join(f"{p:>16s}" for p in self.spec.policies)]
        for scenario in self.spec.scenarios:
            vals = []
            for policy in self.spec.policies:
                per_seed = [
                    c.summary.get(metric, float("nan"))
                    for c in self.cells
                    if c.scenario == scenario and c.policy == policy
                ]
                vals.append(sum(per_seed) / max(len(per_seed), 1))
            lines.append(
                f"{scenario:18s} " + " ".join(f"{v:16.2f}" for v in vals)
            )
        return "\n".join(lines)


def _workload_for(spec: SweepSpec, topo: Topology, scenario: Scenario, seed: int):
    # Dict-literal merge: scenario overrides win (dict(k=..., **{...}) would
    # raise on a duplicate key like target_utilisation).
    kwargs = {
        "target_utilisation": spec.target_utilisation,
        **scenario.workload_kwargs,
    }
    if scenario.trace_kwargs is not None:
        # Trace-replay scenario: a chunked cursor (re-iterable across the
        # policy cells that share it) instead of a materialized Workload.
        return synth_trace(
            topo,
            duration_s=spec.duration_s,
            seed=seed,
            **{**kwargs, **scenario.trace_kwargs},
        )
    return synth_workload(topo, duration_s=spec.duration_s, seed=seed, **kwargs)


def split_policy(policy: str) -> Tuple[str, Optional[str]]:
    """Parse a ``policy`` / ``policy:backend`` cell label.

    .. deprecated:: the colon string is a legacy spelling kept for saved
       sweeps and `SweepSpec.policies` entries; new code should carry the
       typed `CellSpec` (whose `parse`/`label` round-trip this form).
    """
    base, _, backend = policy.partition(":")
    return base, (backend or None)


# Per-process caches: workers (and repeated sequential sweeps) rebuild the
# shared cluster objects once per spec, not once per cell. Every input is
# derived deterministically from the hashable frozen spec, so cached and
# fresh objects are interchangeable.


@functools.lru_cache(maxsize=2)
def _base_plane(spec: SweepSpec) -> LatencyPlane:
    return LatencyPlane.synthesize(
        spec.topology(), duration_s=spec.duration_s, seed=spec.plane_seed
    )


@functools.lru_cache(maxsize=4)
def _scenario_plane(spec: SweepSpec, scenario_name: str) -> LatencyPlane:
    scenario = get_scenario(scenario_name)
    return scenario.plane(_base_plane(spec), spec.duration_s)


@functools.lru_cache(maxsize=2)
def _scenario_workload(spec: SweepSpec, scenario_name: str, seed: int):
    """A `Workload`, or a re-iterable trace cursor for trace scenarios."""
    scenario = get_scenario(scenario_name)
    return _workload_for(spec, spec.topology(), scenario, seed)


def _run_cell(args: Tuple[SweepSpec, CellSpec, str]) -> SweepCell:
    """One grid cell, rebuildable in any process (multiprocessing target)."""
    spec, cell, device = args
    scenario = get_scenario(cell.scenario)
    topo = spec.topology()
    plane = _scenario_plane(spec, cell.scenario)
    wl = _scenario_workload(spec, cell.scenario, cell.seed)
    cfg = SimConfig(
        policy=cell.policy,
        backend=cell.backend,
        params=scenario.policy_params(),
        seed=cell.seed,
        fixed_algo_s=spec.fixed_algo_s,
        device=device,
        **scenario.sim_config_kwargs(topo, spec.duration_s, cell.seed),
    )
    counters_before = obs.counters() if obs.enabled() else None
    t0 = time.perf_counter()
    with obs.span(
        "sweep.cell", scenario=cell.scenario, seed=cell.seed, policy=cell.label
    ):
        metrics = Simulator(wl, plane, cfg).run()
    return SweepCell(
        scenario=cell.scenario,
        seed=cell.seed,
        policy=cell.label,  # saved-JSON schema keeps the string form
        summary=metrics.summary(),
        wall_s=time.perf_counter() - t0,
        telemetry=(
            obs.counters_since(counters_before)
            if counters_before is not None
            else None
        ),
    )


def shard_cells(
    cells: List[CellSpec], shard: Tuple[int, int]
) -> List[CellSpec]:
    """Deterministic contiguous slice ``i`` of an ``n``-way partition.

    Balanced like ``np.array_split`` (sizes differ by at most one), so
    shard boundaries and the concatenation order are pure functions of
    (len(cells), n) and concatenating shards 0..n-1 reproduces ``cells``.
    """
    i, n = shard
    if n <= 0 or not 0 <= i < n:
        raise ValueError(f"shard must be (i, n) with 0 <= i < n, got {shard}")
    q, r = divmod(len(cells), n)
    lo = i * q + min(i, r)
    hi = lo + q + (1 if i < r else 0)
    return cells[lo:hi]


def run_sweep(
    spec: SweepSpec,
    *,
    progress: Optional[Callable[[str], None]] = None,
    workers: int = 1,
    shard: Optional[Tuple[int, int]] = None,
    device: str = "cuda",
) -> SweepResult:
    """Run every (scenario, seed, policy) cell of `spec` and collect
    `SimMetrics.summary()` per cell.

    ``workers > 1`` partitions the cells over a ``multiprocessing`` spawn
    pool (cells are independent); results stream back and merge in
    `spec.cells()` grid order regardless of completion order. The spawn
    context avoids forking a process with a live CUDA context; each worker
    pays one torch import (and, on the card, its own context and kernel
    loads) on startup, amortised across its share of the grid.

    ``shard=(i, n)`` runs only the ``i``-th of ``n`` deterministic
    contiguous slices of the grid (multi-host partitioning; composes with
    ``workers``). Recombine the per-shard results with
    `merge_sweep_results`, which reproduces the single-host grid exactly.
    """
    say = progress or (lambda _msg: None)
    t_sweep = time.perf_counter()
    cell_keys = spec.cells()
    if shard is not None:
        cell_keys = shard_cells(cell_keys, shard)
    jobs = [(spec, cell, device) for cell in cell_keys]
    cells: List[SweepCell] = []
    try:
        if workers > 1 and len(jobs) > 1:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(processes=min(workers, len(jobs))) as pool:
                # imap preserves submission order => deterministic merge.
                # Grid order is policy-minor, so policy-sized chunks keep
                # each (scenario, seed) group — and its cached plane and
                # workload — on a single worker.
                for cell in pool.imap(
                    _run_cell, jobs, chunksize=max(1, len(spec.policies))
                ):
                    cells.append(cell)
                    _say_cell(say, cell)
        else:
            for job in jobs:
                cells.append(_run_cell(job))
                _say_cell(say, cells[-1])
    finally:
        # Planes/workloads can reach GBs at Google-trace scale; scope the
        # per-process reuse to this run (workers free theirs at pool exit).
        _base_plane.cache_clear()
        _scenario_plane.cache_clear()
        _scenario_workload.cache_clear()
    return SweepResult(
        spec=spec, cells=cells, wall_s=time.perf_counter() - t_sweep,
        shard=tuple(shard) if shard is not None else None,
    )


def merge_sweep_results(results: List[SweepResult]) -> SweepResult:
    """Recombine `run_sweep(spec, shard=(i, n))` outputs into the full grid.

    Requires one result per shard of a single n-way partition of one spec
    (duplicates, gaps, or mixed specs raise). The merged cell list is in
    `spec.cells()` grid order — cell-for-cell identical to the single-host
    `run_sweep(spec)` output (bit-identical summaries under
    ``fixed_algo_s``); the merged ``wall_s`` is the sum over shards.
    """
    if not results:
        raise ValueError("no results to merge")
    spec = results[0].spec
    for r in results[1:]:
        if r.spec != spec:
            raise ValueError("cannot merge results from different specs")
    if any(r.shard is None for r in results):
        raise ValueError("merge inputs must be sharded results (shard=(i, n))")
    n = results[0].shard[1]
    seen = sorted(r.shard[0] for r in results)
    if any(r.shard[1] != n for r in results) or seen != list(range(n)):
        raise ValueError(
            f"shards must cover 0..{n - 1} exactly once, got "
            f"{sorted(r.shard for r in results)}"
        )
    ordered = sorted(results, key=lambda r: r.shard[0])
    cells = [c for r in ordered for c in r.cells]
    keys = [CellSpec.parse(c.scenario, c.seed, c.policy) for c in cells]
    if keys != spec.cells():
        raise ValueError("merged cells do not reproduce the spec grid")
    return SweepResult(
        spec=spec, cells=cells, wall_s=sum(r.wall_s for r in results), shard=None
    )


def load_sweep_result(path: str) -> SweepResult:
    """Load a saved `SweepResult` (e.g. one shard's JSON) for merging."""
    with open(path) as f:
        return SweepResult.from_jsonable(json.load(f))


def _say_cell(say: Callable[[str], None], cell: SweepCell) -> None:
    say(
        f"[sweep] {cell.scenario}/{cell.seed}/{cell.policy}: "
        f"perf_area={cell.summary['avg_app_perf_area']:.1f}% "
        f"placed={int(cell.summary['tasks_placed'])} "
        f"({cell.wall_s:.2f}s)"
    )
