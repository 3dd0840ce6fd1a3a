"""Trace-scale replay: Google cluster-trace ingestion + chunked synthesis.

Port of `repro.core.trace` (numpy, unchanged; tests pin every cursor to
the original window for window).

The paper's headline numbers replay 24h of the Google-2011 cluster trace on
12,500 machines. `workload.synth_workload` materializes every `Job` up
front, which is fine at sweep scale but not for multi-week replays (and a
real trace's *event list* — ~100M task events — must never be resident).
This module provides workload-shaped **cursors** instead: objects exposing
``topo``, ``duration_s`` and a re-iterable ``jobs`` property that yields
`workload.Job` records lazily in arrival order, so the simulator admits
from a stream and only one time window of jobs is ever materialized.

Two sources:

- `synth_trace` -> `SyntheticTraceCursor`: a deterministic trace-scale
  synthesizer emitting the same statistical marginals as
  `workload.synth_workload` (heavy-tailed task counts and durations,
  standing services at t=0, Poisson dynamic arrivals thinned to a slot
  utilisation target) in **chunked time windows**. Window ``w`` derives
  its own `np.random.default_rng((seed, _WINDOW_TAG, w))` stream, so the
  job stream is a pure function of (params, window_s) and replaying any
  sub-range of windows is deterministic without generating the prefix.
- `CsvTraceCursor`: reads the Google cluster-data v2 ``task_events``
  table (CSV or CSV.gz, the published column order) and aggregates it
  into jobs with O(jobs) — not O(events) — state: per job id it keeps
  (first SUBMIT time, max task index, last terminal-event time). Job ids
  are renumbered densely in arrival order; single-task jobs are dropped
  (paper §6) and each job gets a deterministic perf function drawn from
  the paper's application mix by hashing the original job id.

`materialize(cursor)` collects a cursor into a plain `workload.Workload`
for exact-equivalence tests and small-scale runs.
"""

from __future__ import annotations

import csv
import dataclasses
import gzip
import io
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs

from .perf_model import APP_MODEL_INDEX
from .topology import Topology
from .workload import (
    DEFAULT_MIX,
    Job,
    Workload,
    _sample_duration,
    _sample_n_tasks,
    _sample_perf_idx,
)

# Google cluster-data v2 ``task_events`` schema (column order is fixed by
# the published trace; there is no header row).
TASK_EVENTS_COLUMNS = (
    "time_us",
    "missing_info",
    "job_id",
    "task_index",
    "machine_id",
    "event_type",
    "user",
    "scheduling_class",
    "priority",
    "cpu_request",
    "memory_request",
    "disk_request",
    "different_machines_restriction",
)
COL_TIME, COL_JOB_ID, COL_TASK_INDEX, COL_EVENT_TYPE = 0, 2, 3, 5

# Event types (cluster-data v2 documentation).
EVENT_SUBMIT = 0
EVENT_SCHEDULE = 1
EVENT_EVICT = 2
EVENT_FAIL = 3
EVENT_FINISH = 4
EVENT_KILL = 5
EVENT_LOST = 6
TERMINAL_EVENTS = (EVENT_FAIL, EVENT_FINISH, EVENT_KILL, EVENT_LOST)

# rng stream tags (seed sequences keep window/probe/standing streams apart).
_WINDOW_TAG = 0x5772
_STANDING_TAG = 0x57A2
_PROBE_TAG = 0x5B0B
_OPENLOOP_TAG = 0x0917


def _splitmix64_int(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _hash_perf_idx(job_id: int, seed: int, mix=DEFAULT_MIX) -> int:
    """Deterministic perf-function draw from `mix` by hashing a job id."""
    u = _splitmix64_int(job_id ^ (seed * 0x100000001B3)) / 2**64
    acc = 0.0
    total = sum(p for _, p in mix)
    for name, p in mix:
        acc += p / total
        if u < acc:
            return APP_MODEL_INDEX[name]
    return APP_MODEL_INDEX[mix[-1][0]]


# --------------------------------------------------------------------- #
# Synthetic trace-scale cursor


@dataclasses.dataclass
class SyntheticTraceCursor:
    """Chunked, deterministic Google-shaped job stream (workload-shaped).

    ``jobs`` is a property returning a *fresh* generator on each access,
    so one cursor can back every policy cell of a sweep. ``n_jobs_hint``
    / ``n_tasks_hint`` are preallocation estimates for the simulator's
    SoA tables (which grow on demand, so the hints only affect
    reallocation count, never correctness).
    """

    topo: Topology
    duration_s: int
    seed: int = 0
    window_s: int = 3600
    target_utilisation: float = 0.60
    standing_fraction: float = 0.35
    arrival_span: float = 0.9  # dynamic arrivals land in [0, span * duration)
    mix: Tuple = DEFAULT_MIX

    def __post_init__(self) -> None:
        if self.window_s <= 0:
            raise ValueError("window_s must be positive")
        slot_seconds = (
            self.topo.n_machines * self.topo.slots_per_machine * self.duration_s
        )
        budget = self.target_utilisation * slot_seconds
        self._standing_budget = budget * self.standing_fraction
        # Expected per-job slot-second consumption, from a fixed probe
        # stream (same formula as synth_workload's estimate).
        rng = np.random.default_rng((self.seed, _PROBE_TAG))
        probe_tasks = _sample_n_tasks(rng, 256)
        probe_dur = _sample_duration(rng, 256)
        self._mean_cons = float(
            np.mean(probe_tasks * np.minimum(probe_dur, self.duration_s / 2))
        )
        span = max(1.0, self.arrival_span * self.duration_s)
        self._rate = (budget - self._standing_budget) / max(
            self._mean_cons, 1.0
        ) / span  # dynamic jobs per second

    # ------------------------------------------------------------------ #

    @property
    def n_windows(self) -> int:
        return -(-self.duration_s // self.window_s)

    @property
    def n_jobs_hint(self) -> int:
        standing = int(self._standing_budget / max(self._mean_cons, 1.0)) + 1
        dynamic = int(self._rate * self.arrival_span * self.duration_s)
        return max(4, standing + dynamic)

    @property
    def n_tasks_hint(self) -> int:
        # E[n_tasks] of _sample_n_tasks ~ exp(1.1 + 0.9^2/2) + 1 ~ 5.5.
        return max(8, int(self.n_jobs_hint * 5.5))

    def _standing_jobs(self) -> List[Job]:
        rng = np.random.default_rng((self.seed, _STANDING_TAG))
        jobs: List[Job] = []
        used = 0.0
        while used < self._standing_budget:
            n_tasks = int(_sample_n_tasks(rng, 1)[0])
            jobs.append(
                Job(
                    job_id=-1,  # renumbered on yield
                    arrival_s=0.0,
                    n_tasks=n_tasks,
                    duration_s=float(self.duration_s),
                    perf_idx=int(_sample_perf_idx(rng, 1, self.mix)[0]),
                )
            )
            used += n_tasks * self.duration_s
        return jobs

    def _window_jobs(self, w: int) -> List[Job]:
        """Dynamic arrivals inside window ``w`` (arrival-sorted)."""
        lo = w * self.window_s
        hi = min(lo + self.window_s, self.duration_s)
        span_hi = self.arrival_span * self.duration_s
        lo_f, hi_f = float(lo), min(float(hi), span_hi)
        if hi_f <= lo_f:
            return []
        rng = np.random.default_rng((self.seed, _WINDOW_TAG, w))
        n = int(rng.poisson(self._rate * (hi_f - lo_f)))
        if n == 0:
            return []
        arrivals = np.sort(rng.uniform(lo_f, hi_f, size=n))
        n_tasks = _sample_n_tasks(rng, n)
        durs = _sample_duration(rng, n)
        perf = _sample_perf_idx(rng, n, self.mix)
        return [
            Job(
                job_id=-1,
                arrival_s=float(arrivals[i]),
                n_tasks=int(n_tasks[i]),
                duration_s=float(min(durs[i], self.duration_s - arrivals[i])),
                perf_idx=int(perf[i]),
            )
            for i in range(n)
        ]

    def windows(self) -> Iterator[Tuple[int, int, List[Job]]]:
        """Yield ``(t_lo, t_hi, jobs)`` chunks with dense arrival-order
        job ids; only one window's jobs are alive at a time."""
        next_id = 0
        for w in range(self.n_windows):
            lo = w * self.window_s
            hi = min(lo + self.window_s, self.duration_s)
            with obs.span("trace.window", window=w, t_lo=lo, t_hi=hi):
                jobs = self._window_jobs(w)
                if w == 0:
                    jobs = self._standing_jobs() + jobs
                for job in jobs:
                    job.job_id = next_id
                    next_id += 1
                obs.add("trace.jobs_streamed", len(jobs))
            yield lo, hi, jobs

    @property
    def jobs(self) -> Iterator[Job]:
        for _lo, _hi, jobs in self.windows():
            yield from jobs


def synth_trace(
    topo: Topology,
    duration_s: int,
    *,
    seed: int = 0,
    window_s: int = 3600,
    target_utilisation: float = 0.60,
    standing_fraction: float = 0.35,
    mix=DEFAULT_MIX,
) -> SyntheticTraceCursor:
    """A deterministic trace-scale job stream with Google-trace marginals.

    The counterpart of `workload.synth_workload` for replays too large to
    materialize: arrival/duration/task-count streams are emitted in
    ``window_s`` chunks, each a pure function of ``(seed, window index)``.
    """
    return SyntheticTraceCursor(
        topo=topo,
        duration_s=duration_s,
        seed=seed,
        window_s=window_s,
        target_utilisation=target_utilisation,
        standing_fraction=standing_fraction,
        mix=mix,
    )


# --------------------------------------------------------------------- #
# Open-loop serving cursor


@dataclasses.dataclass
class OpenLoopCursor:
    """Open-loop Poisson arrival stream for the serving harness.

    Unlike `SyntheticTraceCursor` — which *closes the loop* by thinning
    arrivals to hit a slot-utilisation target — an open-loop stream offers
    jobs at a fixed ``rate_jobs_s`` regardless of what the scheduler keeps
    up with; that is the load model under which per-decision placement
    latency and the saturation knee are meaningful (`core/serving.py`).
    Per-job marginals (task counts, durations, perf mix) reuse the same
    samplers as `synth_trace`, with durations scaled by
    ``duration_scale`` so saturation sweeps can reach the knee on small
    clusters without changing the distribution *shape*. Durations are NOT
    clamped to the horizon: jobs admitted near ``duration_s`` keep their
    natural length and drain afterwards.

    Determinism matches the windowed contract: window ``w`` draws from
    ``np.random.default_rng((seed, _OPENLOOP_TAG, w))``, so the stream is
    a pure function of (params, window index) and replaying any sub-range
    needs no prefix generation.
    """

    topo: Topology
    duration_s: int  # arrival horizon: no arrivals at t >= duration_s
    rate_jobs_s: float = 1.0
    seed: int = 0
    window_s: int = 60
    duration_scale: float = 1.0
    mix: Tuple = DEFAULT_MIX

    def __post_init__(self) -> None:
        if self.window_s <= 0:
            raise ValueError("window_s must be positive")
        if self.rate_jobs_s < 0:
            raise ValueError("rate_jobs_s must be non-negative")

    @property
    def n_windows(self) -> int:
        return -(-self.duration_s // self.window_s)

    @property
    def n_jobs_hint(self) -> int:
        return int(self.rate_jobs_s * self.duration_s * 1.2) + 4

    @property
    def n_tasks_hint(self) -> int:
        # E[n_tasks] of _sample_n_tasks ~ 5.5 (see SyntheticTraceCursor).
        return max(8, int(self.n_jobs_hint * 5.5))

    def _window_jobs(self, w: int) -> List[Job]:
        lo = float(w * self.window_s)
        hi = float(min(lo + self.window_s, self.duration_s))
        if hi <= lo:
            return []
        rng = np.random.default_rng((self.seed, _OPENLOOP_TAG, w))
        n = int(rng.poisson(self.rate_jobs_s * (hi - lo)))
        if n == 0:
            return []
        arrivals = np.sort(rng.uniform(lo, hi, size=n))
        n_tasks = _sample_n_tasks(rng, n)
        durs = _sample_duration(rng, n)
        perf = _sample_perf_idx(rng, n, self.mix)
        return [
            Job(
                job_id=-1,
                arrival_s=float(arrivals[i]),
                n_tasks=int(n_tasks[i]),
                duration_s=float(max(1.0, durs[i] * self.duration_scale)),
                perf_idx=int(perf[i]),
            )
            for i in range(n)
        ]

    def windows(self) -> Iterator[Tuple[int, int, List[Job]]]:
        """Yield ``(t_lo, t_hi, jobs)`` chunks with dense arrival-order
        job ids (same contract as `SyntheticTraceCursor.windows`)."""
        next_id = 0
        for w in range(self.n_windows):
            lo = w * self.window_s
            hi = min(lo + self.window_s, self.duration_s)
            with obs.span("trace.window", window=w, t_lo=lo, t_hi=hi):
                jobs = self._window_jobs(w)
                for job in jobs:
                    job.job_id = next_id
                    next_id += 1
                obs.add("trace.jobs_streamed", len(jobs))
            yield lo, hi, jobs

    @property
    def jobs(self) -> Iterator[Job]:
        for _lo, _hi, jobs in self.windows():
            yield from jobs


def open_loop_trace(
    topo: Topology,
    duration_s: int,
    rate_jobs_s: float,
    *,
    seed: int = 0,
    window_s: int = 60,
    duration_scale: float = 1.0,
    mix=DEFAULT_MIX,
) -> OpenLoopCursor:
    """Fixed-rate Poisson job stream (serving-mode load generator)."""
    return OpenLoopCursor(
        topo=topo,
        duration_s=duration_s,
        rate_jobs_s=rate_jobs_s,
        seed=seed,
        window_s=window_s,
        duration_scale=duration_scale,
        mix=mix,
    )


# --------------------------------------------------------------------- #
# Google cluster-data v2 ingestion


def _open_trace(path: str) -> io.TextIOBase:
    if str(path).endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "r", encoding="utf-8")


@dataclasses.dataclass
class _JobAgg:
    submit_us: int
    max_task_index: int = 0
    end_us: int = -1


def read_task_events(
    paths: Sequence[str],
    *,
    trace_duration_s: Optional[int] = None,
    min_tasks: int = 2,
    mix=DEFAULT_MIX,
    seed: int = 0,
) -> List[Job]:
    """Aggregate cluster-data v2 ``task_events`` shards into `Job` records.

    Streams rows (never holding the event list) and keeps one `_JobAgg`
    per job id: first SUBMIT timestamp, max task index, last terminal
    event. Jobs are returned arrival-sorted with densely renumbered ids;
    jobs with fewer than ``min_tasks`` tasks are dropped (the paper drops
    single-task jobs) and jobs that never finish run to ``trace_duration_s``
    (default: the last event seen).
    """
    jobs_agg: Dict[int, _JobAgg] = {}
    last_us = 0
    for path in paths:
        with _open_trace(path) as f:
            for row in csv.reader(f):
                if not row or not row[COL_TIME]:
                    continue
                t_us = int(row[COL_TIME])
                jid = int(row[COL_JOB_ID])
                ev = int(row[COL_EVENT_TYPE])
                last_us = max(last_us, t_us)
                agg = jobs_agg.get(jid)
                if ev == EVENT_SUBMIT:
                    if agg is None:
                        jobs_agg[jid] = agg = _JobAgg(submit_us=t_us)
                    else:
                        agg.submit_us = min(agg.submit_us, t_us)
                    agg.max_task_index = max(
                        agg.max_task_index, int(row[COL_TASK_INDEX])
                    )
                elif ev in TERMINAL_EVENTS and agg is not None:
                    agg.end_us = max(agg.end_us, t_us)
    trace_end_s = (
        float(trace_duration_s) if trace_duration_s is not None else last_us / 1e6
    )
    jobs: List[Job] = []
    for jid, agg in jobs_agg.items():
        n_tasks = agg.max_task_index + 1
        if n_tasks < min_tasks:
            continue
        arrival_s = agg.submit_us / 1e6
        end_s = agg.end_us / 1e6 if agg.end_us >= 0 else trace_end_s
        jobs.append(
            Job(
                job_id=jid,  # original id until the dense renumber below
                arrival_s=arrival_s,
                n_tasks=n_tasks,
                duration_s=max(1.0, end_s - arrival_s),
                perf_idx=_hash_perf_idx(jid, seed, mix),
            )
        )
    jobs.sort(key=lambda j: (j.arrival_s, j.job_id))
    for i, job in enumerate(jobs):
        job.job_id = i
    return jobs


@dataclasses.dataclass
class CsvTraceCursor:
    """Workload-shaped cursor over cluster-data v2 ``task_events`` files.

    The event files are parsed once, on first access; the aggregated
    O(jobs) list (which the parse materializes anyway) is cached so the
    re-iterable ``jobs`` property does not re-read GBs of CSV for every
    sweep cell sharing the cursor.
    """

    topo: Topology
    duration_s: int
    paths: Tuple[str, ...]
    min_tasks: int = 2
    mix: Tuple = DEFAULT_MIX
    seed: int = 0
    _jobs_cache: Optional[List[Job]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def n_jobs_hint(self) -> int:
        # Exact: the parse is cached, and the simulator needs it right
        # after the hint anyway (one allocation, no growth).
        return len(self._read())

    @property
    def n_tasks_hint(self) -> int:
        return sum(j.n_tasks for j in self._read())

    def _read(self) -> List[Job]:
        if self._jobs_cache is None:
            with obs.span("trace.csv_read", n_files=len(self.paths)):
                self._jobs_cache = read_task_events(
                    self.paths,
                    trace_duration_s=self.duration_s,
                    min_tasks=self.min_tasks,
                    mix=self.mix,
                    seed=self.seed,
                )
            obs.add("trace.jobs_streamed", len(self._jobs_cache))
        return self._jobs_cache

    @property
    def jobs(self) -> Iterator[Job]:
        yield from self._read()


def materialize(cursor) -> Workload:
    """Collect a cursor into a plain `Workload` (tests / small replays)."""
    return Workload(
        jobs=list(cursor.jobs), duration_s=cursor.duration_s, topo=cursor.topo
    )
