"""Evaluation metrics (paper §6).

- average application performance: per job, the mean over measurement
  intervals of the (normalised) predicted performance under the measured
  latency; aggregated across jobs as a CDF whose enclosed area (y-axis,
  CDF, y=1 line) the paper reports. That area equals 100 x the mean of the
  per-job averages (a vertical CDF at x=100% gives area 100%).
- algorithm runtime: wall time of the solver per scheduling round.
- task placement latency: submission -> placement, including round runtime.
- task response time: submission -> completion.
- migrated tasks: % of running tasks migrated per round (preemption mode).

`SimMetrics` keeps exact per-sample series (lists) — the reference for
parity tests and small replays. At trace scale those series dominate peak
RSS; select `metrics_stream.StreamingSimMetrics` instead (same mutation
surface and ``summary()`` schema, bounded memory, documented quantile
tolerance) via ``SimConfig(streaming_metrics=True)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

#: The shared ``summary()`` schema: (summary-key prefix, accumulator
#: attribute) pairs iterated by BOTH `SimMetrics.summary` and
#: `metrics_stream.StreamingSimMetrics.summary` — the two classes are
#: drop-ins for each other, and routing both through this one constant
#: (plus `SUMMARY_SCALARS`) pins the key-set contract structurally
#: (tests/test_obs.py asserts the emitted key sets stay identical).
SUMMARY_SERIES: Tuple[Tuple[str, str], ...] = (
    ("algo_runtime_s", "algo_runtime_s"),
    ("placement_latency_s", "placement_latency_s"),
    ("response_time_s", "response_time_s"),
    ("migrated_pct", "migrated_pct_per_round"),
    ("controller_improvement", "controller_improvement_per_round"),
    ("degraded_jobs", "degraded_jobs_per_round"),
)

#: Scalar summary keys shared by both metrics classes.
SUMMARY_SCALARS: Tuple[str, ...] = (
    "avg_app_perf_area",
    "jobs_measured",
    "tasks_placed",
    "tasks_migrated",
    "rounds",
    "controller_rounds",
)


def cdf_area(per_job_perf: np.ndarray) -> float:
    """Paper Fig. 5 area metric, in percent (== 100 * mean performance)."""
    if len(per_job_perf) == 0:
        return 0.0
    return float(100.0 * np.mean(np.clip(per_job_perf, 0.0, 1.0)))


def percentiles(values, ps=(50, 90, 99)) -> Dict[str, float]:
    v = np.asarray(list(values), dtype=np.float64)
    if v.size == 0:
        # Same key set as the populated branch (schema stability: summary
        # consumers and the streaming drop-in must see identical keys
        # whether or not the series ever received a sample).
        return {f"p{p}": float("nan") for p in ps} | {
            "max": float("nan"),
            "mean": float("nan"),
        }
    out = {f"p{p}": float(np.percentile(v, p)) for p in ps}
    out["max"] = float(v.max())
    out["mean"] = float(v.mean())
    return out


@dataclasses.dataclass
class SimMetrics:
    """Accumulators filled by the simulator; summarised for benchmarks."""

    per_job_perf: Dict[int, List[float]] = dataclasses.field(default_factory=dict)
    algo_runtime_s: List[float] = dataclasses.field(default_factory=list)
    placement_latency_s: List[float] = dataclasses.field(default_factory=list)
    response_time_s: List[float] = dataclasses.field(default_factory=list)
    migrated_pct_per_round: List[float] = dataclasses.field(default_factory=list)
    # Migration-controller quality series (empty unless the continuous
    # controller runs): per controller round, the predicted true-cost
    # improvement of the chosen lane over the all-frozen baseline, and the
    # number of QoS-degraded jobs the round considered.
    controller_improvement_per_round: List[float] = dataclasses.field(
        default_factory=list
    )
    degraded_jobs_per_round: List[float] = dataclasses.field(default_factory=list)
    tasks_placed: int = 0
    tasks_migrated: int = 0
    rounds: int = 0
    controller_rounds: int = 0

    def record_perf_sample(self, job_id: int, perf: float) -> None:
        self.per_job_perf.setdefault(job_id, []).append(perf)

    def job_averages(self) -> np.ndarray:
        return np.asarray(
            [np.mean(v) for v in self.per_job_perf.values() if len(v)], np.float64
        )

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
            for k, v in percentiles(getattr(self, attr)).items():
                out[f"{name}_{k}"] = v
        return out
