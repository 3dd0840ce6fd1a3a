"""Straggler mitigation at the cluster-scheduling level.

The paper's own mechanism — migrate a task whose *predicted* performance
under current latency drops — is the straggler response: rather than
duplicating work (MapReduce-style speculation), NoMora moves the task to a
placement whose expected performance is higher (paper §7: "migration can
be triggered only if the application performance drops below a certain
threshold").

`StragglerDetector` implements that trigger: it watches per-job predicted
performance samples and flags jobs whose EWMA stays below `threshold` for
`patience` consecutive samples; the simulator then schedules a migration
round restricted to those jobs' tasks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch import obs


@dataclasses.dataclass
class StragglerDetector:
    threshold: float = 0.85  # predicted normalised performance
    patience: int = 3
    alpha: float = 0.5  # EWMA factor
    _ewma: Dict[int, float] = dataclasses.field(default_factory=dict)
    _below: Dict[int, int] = dataclasses.field(default_factory=dict)

    def observe(self, job_id: int, perf: float) -> bool:
        """Record a sample; True if the job is now flagged as straggling."""
        prev = self._ewma.get(job_id, perf)
        ew = self.alpha * perf + (1 - self.alpha) * prev
        self._ewma[job_id] = ew
        if ew < self.threshold:
            self._below[job_id] = self._below.get(job_id, 0) + 1
        else:
            self._below[job_id] = 0
        return self._below[job_id] >= self.patience

    def flagged(self) -> List[int]:
        return [j for j, n in self._below.items() if n >= self.patience]

    def clear(self, job_id: int) -> None:
        """Reset a flagged job's trigger state (identical observe/flagged
        behaviour to a zeroed counter, but without retaining the key)."""
        self._below.pop(job_id, None)
        self._ewma.pop(job_id, None)

    def forget(self, job_id: int) -> None:
        """Drop all state for a finished job. Without this, multi-week
        streaming replays accumulate one EWMA + counter entry per job ever
        sampled — unbounded growth the bounded-metrics path is supposed to
        rule out (the simulator calls this as jobs complete)."""
        self._ewma.pop(job_id, None)
        self._below.pop(job_id, None)


@dataclasses.dataclass
class QoSTracker:
    """QoS trigger window with hysteresis for the migration controller.

    Distinct from `StragglerDetector` (EWMA + patience, flags jobs for a
    dedicated straggler round): this is the *continuous* controller's
    degradation signal. A job becomes degraded after ``window`` consecutive
    raw samples below ``threshold`` — a single bad sample never triggers a
    migration — and clears only once a sample reaches ``threshold +
    clear_margin``: inside the hysteresis band the job keeps its current
    state, so a job oscillating around the threshold doesn't flap between
    migrate/don't-migrate every sample. After the controller migrates a
    job, a ``hold_s`` hold-down suppresses re-triggering while the moved
    tasks' performance settles at the new placement.
    """

    threshold: float = 0.9
    window: int = 2
    clear_margin: float = 0.02
    hold_s: float = 0.0
    _below: Dict[int, int] = dataclasses.field(default_factory=dict)
    _degraded: Dict[int, float] = dataclasses.field(default_factory=dict)
    _hold_until: Dict[int, float] = dataclasses.field(default_factory=dict)

    def observe(self, job_id: int, perf: float, t: float) -> bool:
        """Record a raw perf sample; True if the job is degraded."""
        hold = self._hold_until.get(job_id)
        if hold is not None:
            if t < hold:
                return False
            del self._hold_until[job_id]
        if perf < self.threshold:
            n = self._below.get(job_id, 0) + 1
            self._below[job_id] = n
            if n >= self.window:
                if job_id not in self._degraded:
                    # A job *entering* the degraded set is one QoS trigger
                    # (refreshing the sample of an already-degraded job
                    # is not).
                    obs.add("qos.triggers")
                self._degraded[job_id] = perf
        elif perf >= self.threshold + self.clear_margin:
            self._below.pop(job_id, None)
            self._degraded.pop(job_id, None)
        # else: hysteresis band — keep the current state either way.
        return job_id in self._degraded

    def degraded_jobs(self) -> Dict[int, float]:
        """{job_id: last below-threshold sample} for degraded jobs (the
        sample doubles as a severity key — lower is worse)."""
        return dict(self._degraded)

    def migrated(self, job_id: int, t: float) -> None:
        """The controller moved this job: reset and hold down."""
        self._below.pop(job_id, None)
        self._degraded.pop(job_id, None)
        if self.hold_s > 0:
            self._hold_until[job_id] = t + self.hold_s

    def forget(self, job_id: int) -> None:
        self._below.pop(job_id, None)
        self._degraded.pop(job_id, None)
        self._hold_until.pop(job_id, None)
