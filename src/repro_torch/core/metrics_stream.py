"""Mergeable streaming metric accumulators for trace-scale replays.

Port of `repro.core.metrics_stream` (numpy, unchanged; tests pin it to the
original).

`metrics.SimMetrics` keeps every per-sample series as a Python list and the
full per-job performance history as dict-of-lists; at the paper's replay
scale (12,500 machines, 24h, ~10^6 placements and ~10^4 jobs sampled every
15s) those series dominate peak RSS. This module provides bounded-memory
drop-in accumulators behind the *same* mutation surface the simulator uses
(``.append`` / ``.extend`` on the series attributes, ``record_perf_sample``)
and the same ``summary()`` key set, so sweeps and benchmarks read identical
schemas from exact and streaming runs.

Accumulators (all O(1) or O(bins) memory, all with a deterministic state):

- `Welford`: numerically stable streaming mean/variance. ``merge`` uses the
  symmetric pooled form, so a two-way merge is bitwise commutative.
- `P2Quantile`: the classic P² marker estimator (Jain & Chlamtac 1985) —
  O(1) memory, good on smooth distributions, **not** mergeable; provided
  for single-stream use and as the paper-adjacent reference estimator.
- `LogHistogram`: log-spaced fixed-bin histogram. Mergeable by integer
  count addition (exactly order-invariant) with a documented worst-case
  relative quantile error `QUANTILE_RTOL` for values in
  [`HIST_LO`, `HIST_HI`]; exact zero counting and exact min/max.
- `ReservoirSample`: bounded uniform sample (Algorithm R) with a seeded
  generator; used for per-job distributional spot checks.
- `StreamSeries`: the list stand-in (`append`/`extend`/`merge`/`summary`).
- `StreamingSimMetrics`: the `SimMetrics` stand-in (select it with
  ``SimConfig(streaming_metrics=True)``); per-job performance state is two
  flat arrays (count, running mean) indexed by job id plus optional
  bounded reservoirs, never a per-sample history.

Tolerance contract (the reference's tests/test_metrics_stream.py): quantile estimates lie
within ``QUANTILE_RTOL`` relative error of the *bracketing order
statistics* of the exact data (``np.percentile`` with ``method='lower'`` /
``'higher'``); means/variances match numpy within float tolerance; merges
of the same samples in any shard order yield identical quantiles/counts/
max and means equal to ~1e-9 relative.
"""

from __future__ import annotations

import bisect
import copy
import math
from typing import Dict, Iterable, Optional

import numpy as np

from .metrics import SUMMARY_SERIES, cdf_area

# Log-histogram domain: covers microsecond latencies through multi-week
# response times (seconds) and percent metrics with ~1.4%-wide bins.
HIST_LO = 1e-9
HIST_HI = 1e15
HIST_BINS = 4096
_LOG_LO = math.log(HIST_LO)
_LOG_SPAN = math.log(HIST_HI) - _LOG_LO
_BIN_W = _LOG_SPAN / HIST_BINS
# Worst-case relative error of a histogram quantile vs the order statistic
# it targets: one full bin width in log space, exp(_BIN_W) - 1 ~ 1.36%.
QUANTILE_RTOL = math.expm1(_BIN_W)


class Welford:
    """Streaming mean/variance (Welford); ``merge`` is swap-commutative."""

    __slots__ = ("count", "mean", "_m2")

    def __init__(self) -> None:
        self.count = 0
        self.mean = 0.0
        self._m2 = 0.0

    def add(self, x: float) -> None:
        self.count += 1
        delta = x - self.mean
        self.mean += delta / self.count
        self._m2 += delta * (x - self.mean)

    def add_many(self, xs: np.ndarray) -> None:
        xs = np.asarray(xs, np.float64)
        if xs.size == 0:
            return
        other = Welford()
        other.count = int(xs.size)
        other.mean = float(xs.mean())
        other._m2 = float(((xs - other.mean) ** 2).sum())
        self.merge(other)

    def merge(self, other: "Welford") -> None:
        if other.count == 0:
            return
        if self.count == 0:
            self.count, self.mean, self._m2 = other.count, other.mean, other._m2
            return
        n = self.count + other.count
        delta = other.mean - self.mean
        # Symmetric pooled mean: bitwise identical under operand swap
        # (float + and * are commutative), unlike mean + delta*nb/n.
        mean = (self.count * self.mean + other.count * other.mean) / n
        self._m2 += other._m2 + delta * delta * (self.count * other.count / n)
        self.count, self.mean = n, mean

    @property
    def var(self) -> float:
        return self._m2 / self.count if self.count else float("nan")

    @property
    def std(self) -> float:
        return math.sqrt(self.var) if self.count else float("nan")


class P2Quantile:
    """P² single-quantile estimator: 5 markers, O(1) memory, no merge.

    Accurate on smooth distributions (the classic use); adversarial
    two-point or heavy-atom streams can defeat it — use `LogHistogram`
    when a bound is needed (and always for shard merges).
    """

    def __init__(self, p: float) -> None:
        if not 0.0 < p < 1.0:
            raise ValueError(f"p must be in (0, 1), got {p}")
        self.p = p
        self.count = 0
        self._q: list = []  # marker heights
        self._n = [0, 1, 2, 3, 4]  # marker positions
        self._np = [0.0, 2 * p, 4 * p, 2 + 2 * p, 4.0]  # desired positions
        self._dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]

    def add(self, x: float) -> None:
        self.count += 1
        if len(self._q) < 5:
            bisect.insort(self._q, float(x))
            return
        q, n = self._q, self._n
        if x < q[0]:
            q[0] = float(x)
            k = 0
        elif x >= q[4]:
            q[4] = float(x)
            k = 3
        else:
            k = next(i for i in range(4) if q[i] <= x < q[i + 1])
        for i in range(k + 1, 5):
            n[i] += 1
        for i in range(5):
            self._np[i] += self._dn[i]
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1) or (
                d <= -1.0 and n[i - 1] - n[i] < -1
            ):
                s = 1 if d > 0 else -1
                cand = self._parabolic(i, s)
                if not q[i - 1] < cand < q[i + 1]:
                    cand = self._linear(i, s)
                q[i] = cand
                n[i] += s

    def _parabolic(self, i: int, s: int) -> float:
        q, n = self._q, self._n
        return q[i] + s / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + s) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - s) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, s: int) -> float:
        q, n = self._q, self._n
        return q[i] + s * (q[i + s] - q[i]) / (n[i + s] - n[i])

    @property
    def value(self) -> float:
        if not self._q:
            return float("nan")
        if self.count <= 5:
            k = min(len(self._q) - 1, max(0, round(self.p * (len(self._q) - 1))))
            return self._q[k]
        return self._q[2]


class LogHistogram:
    """Log-spaced histogram: mergeable, order-invariant, bounded error.

    Positive magnitudes land in `HIST_BINS` geometric bins over
    [`HIST_LO`, `HIST_HI`] (values outside saturate into the edge bins);
    zeros are counted exactly; negatives go into a mirrored lazily
    allocated table. `quantile` returns the geometric midpoint of the bin
    holding the target order statistic, clamped to the exact [min, max] —
    within `QUANTILE_RTOL` relative of that order statistic for in-range
    values. Merging adds integer counts: exactly order-invariant.
    """

    __slots__ = ("count", "zero_count", "min", "max", "_pos", "_neg")

    def __init__(self) -> None:
        self.count = 0
        self.zero_count = 0
        self.min = math.inf
        self.max = -math.inf
        self._pos: Optional[np.ndarray] = None
        self._neg: Optional[np.ndarray] = None

    @staticmethod
    def _bins(mag: np.ndarray) -> np.ndarray:
        idx = np.floor((np.log(mag) - _LOG_LO) / _BIN_W).astype(np.int64)
        return np.clip(idx, 0, HIST_BINS - 1)

    @staticmethod
    def _rep(idx: np.ndarray) -> np.ndarray:
        return np.exp(_LOG_LO + (np.asarray(idx, np.float64) + 0.5) * _BIN_W)

    def add_many(self, xs: np.ndarray) -> None:
        xs = np.asarray(xs, np.float64).ravel()
        if xs.size == 0:
            return
        self.count += int(xs.size)
        self.min = min(self.min, float(xs.min()))
        self.max = max(self.max, float(xs.max()))
        self.zero_count += int((xs == 0.0).sum())
        pos = xs[xs > 0.0]
        if pos.size:
            if self._pos is None:
                self._pos = np.zeros(HIST_BINS, np.int64)
            np.add.at(self._pos, self._bins(pos), 1)
        neg = xs[xs < 0.0]
        if neg.size:
            if self._neg is None:
                self._neg = np.zeros(HIST_BINS, np.int64)
            np.add.at(self._neg, self._bins(-neg), 1)

    def add(self, x: float) -> None:
        self.add_many(np.asarray([x]))

    def merge(self, other: "LogHistogram") -> None:
        self.count += other.count
        self.zero_count += other.zero_count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        for attr in ("_pos", "_neg"):
            theirs = getattr(other, attr)
            if theirs is not None:
                mine = getattr(self, attr)
                if mine is None:
                    setattr(self, attr, theirs.copy())
                else:
                    mine += theirs

    def quantile(self, q: float) -> float:
        """Estimate of the order statistic at percentile ``q`` in [0, 100]."""
        if self.count == 0:
            return float("nan")
        rank = q / 100.0 * (self.count - 1)
        k = int(np.clip(round(rank), 0, self.count - 1))
        # Terminal ranks are tracked exactly (and the edge bins saturate,
        # so the histogram alone could not recover them).
        if k == 0:
            return self.min
        if k == self.count - 1:
            return self.max
        vals, cnts = [], []
        if self._neg is not None:
            nz = np.nonzero(self._neg)[0][::-1]  # most negative first
            vals.append(-self._rep(nz))
            cnts.append(self._neg[nz])
        if self.zero_count:
            vals.append(np.zeros(1))
            cnts.append(np.asarray([self.zero_count]))
        if self._pos is not None:
            nz = np.nonzero(self._pos)[0]
            vals.append(self._rep(nz))
            cnts.append(self._pos[nz])
        vals = np.concatenate(vals)
        cum = np.cumsum(np.concatenate(cnts))
        v = float(vals[np.searchsorted(cum, k + 1)])
        return float(np.clip(v, self.min, self.max))


class ReservoirSample:
    """Bounded uniform sample of a stream (Algorithm R, seeded)."""

    __slots__ = ("k", "count", "values", "_rng")

    def __init__(self, k: int, seed: int = 0) -> None:
        self.k = int(k)
        self.count = 0
        self.values: list = []
        self._rng = np.random.default_rng(seed)

    def add(self, x: float) -> None:
        self.count += 1
        if len(self.values) < self.k:
            self.values.append(float(x))
        else:
            j = int(self._rng.integers(0, self.count))
            if j < self.k:
                self.values[j] = float(x)

    def merge(self, other: "ReservoirSample") -> None:
        """Approximate merged sample: draw k from the pooled reservoirs,
        weighted by stream sizes (a spot-check aid, not an estimator)."""
        if other.count == 0:
            return
        if self.count == 0:
            self.count, self.values = other.count, list(other.values)
            return
        pool = np.asarray(self.values + list(other.values))
        w = np.concatenate(
            [
                np.full(len(self.values), self.count / len(self.values)),
                np.full(len(other.values), other.count / len(other.values)),
            ]
        )
        n = min(self.k, len(pool))
        idx = self._rng.choice(len(pool), size=n, replace=False, p=w / w.sum())
        self.values = [float(pool[i]) for i in idx]
        self.count += other.count


class StreamSeries:
    """List stand-in: ``append``/``extend`` sink with streaming summaries."""

    __slots__ = ("_welford", "_hist")

    def __init__(self) -> None:
        self._welford = Welford()
        self._hist = LogHistogram()

    def append(self, x: float) -> None:
        self._welford.add(float(x))
        self._hist.add(float(x))

    def extend(self, xs: Iterable[float]) -> None:
        arr = np.asarray(xs if isinstance(xs, np.ndarray) else list(xs), np.float64)
        self._welford.add_many(arr)
        self._hist.add_many(arr)

    def merge(self, other: "StreamSeries") -> None:
        self._welford.merge(other._welford)
        self._hist.merge(other._hist)

    def __len__(self) -> int:
        return self._welford.count

    @property
    def count(self) -> int:
        return self._welford.count

    @property
    def mean(self) -> float:
        return self._welford.mean if self._welford.count else float("nan")

    @property
    def var(self) -> float:
        return self._welford.var

    @property
    def min(self) -> float:
        return self._hist.min if self.count else float("nan")

    @property
    def max(self) -> float:
        return self._hist.max if self.count else float("nan")

    def quantile(self, q: float) -> float:
        return self._hist.quantile(q)

    def summary(self, ps=(50, 90, 99)) -> Dict[str, float]:
        """Same keys (and empty-series shape) as `metrics.percentiles`."""
        if self.count == 0:
            return {f"p{p}": float("nan") for p in ps} | {
                "max": float("nan"),
                "mean": float("nan"),
            }
        out = {f"p{p}": self.quantile(p) for p in ps}
        out["max"] = self.max
        out["mean"] = self.mean
        return out


# Per-job state arrays are indexed directly by workload job id; both the
# synthesizers and the trace reader emit dense ids, so this stays O(jobs).
_MAX_JOB_ID = 50_000_000


class StreamingSimMetrics:
    """`SimMetrics` stand-in with bounded memory (same summary schema).

    Series attributes are `StreamSeries` (the simulator's ``append`` /
    ``extend`` calls stream straight into the accumulators); per-job
    performance is a running (count, mean) pair per job id plus an
    optional bounded `ReservoirSample` (``reservoir_k > 0``) instead of
    the exact per-sample history.
    """

    def __init__(self, reservoir_k: int = 0, seed: int = 0) -> None:
        self.algo_runtime_s = StreamSeries()
        self.placement_latency_s = StreamSeries()
        self.response_time_s = StreamSeries()
        self.migrated_pct_per_round = StreamSeries()
        self.controller_improvement_per_round = StreamSeries()
        self.degraded_jobs_per_round = StreamSeries()
        self.tasks_placed = 0
        self.tasks_migrated = 0
        self.rounds = 0
        self.controller_rounds = 0
        self.reservoir_k = int(reservoir_k)
        self._seed = int(seed)
        self._job_count = np.zeros(0, np.int64)
        self._job_mean = np.zeros(0, np.float64)
        self._reservoirs: Dict[int, ReservoirSample] = {}

    # ------------------------------------------------------------------ #

    def _ensure_jobs(self, max_job_id: int) -> None:
        if max_job_id >= _MAX_JOB_ID:
            raise ValueError(
                f"job id {max_job_id} too large for dense per-job state; "
                "renumber trace job ids densely (core.trace does this)"
            )
        if max_job_id < len(self._job_count):
            return
        new = max(64, len(self._job_count) * 2, max_job_id + 1)
        count = np.zeros(new, np.int64)
        mean = np.zeros(new, np.float64)
        count[: len(self._job_count)] = self._job_count
        mean[: len(self._job_mean)] = self._job_mean
        self._job_count, self._job_mean = count, mean

    def record_perf_sample(self, job_id: int, perf: float) -> None:
        self._ensure_jobs(job_id)
        c = self._job_count[job_id] + 1
        self._job_count[job_id] = c
        self._job_mean[job_id] += (perf - self._job_mean[job_id]) / c
        if self.reservoir_k:
            res = self._reservoirs.get(job_id)
            if res is None:
                res = self._reservoirs[job_id] = ReservoirSample(
                    self.reservoir_k, seed=(self._seed << 32) ^ job_id
                )
            res.add(perf)

    def record_perf_bulk(self, job_ids: np.ndarray, values: np.ndarray) -> None:
        """One sample per distinct job (a perf-sampling round), vectorized."""
        job_ids = np.asarray(job_ids, np.int64)
        if job_ids.size == 0:
            return
        self._ensure_jobs(int(job_ids.max()))
        c = self._job_count[job_ids] + 1
        self._job_count[job_ids] = c
        self._job_mean[job_ids] += (values - self._job_mean[job_ids]) / c
        if self.reservoir_k:
            for j, v in zip(job_ids.tolist(), np.asarray(values).tolist()):
                res = self._reservoirs.get(j)
                if res is None:
                    res = self._reservoirs[j] = ReservoirSample(
                        self.reservoir_k, seed=(self._seed << 32) ^ j
                    )
                res.add(v)

    def job_reservoir(self, job_id: int) -> Optional[ReservoirSample]:
        return self._reservoirs.get(job_id)

    def job_averages(self) -> np.ndarray:
        sampled = self._job_count > 0
        return self._job_mean[sampled]

    # ------------------------------------------------------------------ #

    def merge(self, other: "StreamingSimMetrics") -> None:
        """Fold another shard's accumulators in (order-invariant up to
        float summation in the means; quantiles/counts/max exact)."""
        for _name, attr in SUMMARY_SERIES:
            getattr(self, attr).merge(getattr(other, attr))
        self.tasks_placed += other.tasks_placed
        self.tasks_migrated += other.tasks_migrated
        self.rounds += other.rounds
        self.controller_rounds += other.controller_rounds
        if len(other._job_count):
            self._ensure_jobs(len(other._job_count) - 1)
            oc = np.zeros_like(self._job_count)
            om = np.zeros_like(self._job_mean)
            oc[: len(other._job_count)] = other._job_count
            om[: len(other._job_mean)] = other._job_mean
            tot = self._job_count + oc
            nz = tot > 0
            self._job_mean[nz] = (
                self._job_count[nz] * self._job_mean[nz] + oc[nz] * om[nz]
            ) / tot[nz]
            self._job_count = tot
        for j, res in other._reservoirs.items():
            mine = self._reservoirs.get(j)
            if mine is None:
                # Copy, not alias: later adds into the merged object must
                # not mutate the source shard's reservoir (or its rng).
                self._reservoirs[j] = copy.deepcopy(res)
            else:
                mine.merge(res)

    def summary(self) -> Dict[str, float]:
        ja = self.job_averages()
        out = {
            "avg_app_perf_area": cdf_area(ja),
            "jobs_measured": float(len(ja)),
            "tasks_placed": float(self.tasks_placed),
            "tasks_migrated": float(self.tasks_migrated),
            "rounds": float(self.rounds),
            "controller_rounds": float(self.controller_rounds),
        }
        for name, attr in SUMMARY_SERIES:
            for k, v in getattr(self, attr).summary().items():
                out[f"{name}_{k}"] = v
        return out
