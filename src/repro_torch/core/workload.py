"""Cluster workload synthesis (paper §6 "Cluster workloads", DESIGN.md D2).

The paper replays 24h of the Google-2011 trace (12,500 machines), drops
single-task jobs, and augments each job with a latency->performance
prediction function: 50% Memcached, 25% STRADS, 25% TensorFlow (Spark's
near-flat profile excluded as "not challenging").

The raw trace is not available offline, so we synthesize a workload with
the published marginals of that trace (Reiss et al., SoCC'12):
  - heavy-tailed task counts (most jobs small, rare very wide jobs),
  - heavy-tailed durations (median minutes; a standing population of
    long-running services that span the whole trace, set up at t=0),
  - Poisson arrivals thinned to a target slot utilisation.
Every divergence is recorded in DESIGN.md D2; all paper claims are
validated as *relative* improvements on this stand-in.

The perf-function mix is extended (DESIGN.md §3 Arch-applicability) with an
optional `ml_arch` label per job so the launcher can schedule the assigned
LM architectures as jobs: train jobs map to the TensorFlow-sync profile,
serve jobs to Memcached, sequential-scan (SSM/hybrid) training to STRADS.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .perf_model import APP_MODEL_INDEX
from .topology import Topology

# Paper §6 mix: 50% Memcached / 25% STRADS / 25% TensorFlow.
DEFAULT_MIX = (
    ("memcached", 0.50),
    ("strads", 0.25),
    ("tensorflow", 0.25),
)


@dataclasses.dataclass
class Job:
    job_id: int
    arrival_s: float
    n_tasks: int  # includes the root task (task 0)
    duration_s: float
    perf_idx: int  # index into perf_model.APP_MODEL_LIST
    ml_arch: Optional[str] = None  # set when the job is an LM workload


@dataclasses.dataclass
class Workload:
    jobs: List[Job]
    duration_s: int
    topo: Topology

    @property
    def n_tasks_total(self) -> int:
        return sum(j.n_tasks for j in self.jobs)


def _sample_n_tasks(rng: np.random.Generator, size: int) -> np.ndarray:
    """>=2 tasks (single-task jobs are excluded per the paper), heavy tail."""
    raw = np.exp(rng.normal(1.1, 0.9, size=size))
    return np.clip(np.round(raw).astype(np.int64) + 1, 2, 200)


def _sample_duration(rng: np.random.Generator, size: int) -> np.ndarray:
    """Heavy-tailed durations (seconds), median ~5 minutes."""
    return np.clip(np.exp(rng.normal(np.log(300.0), 1.2, size=size)), 30.0, None)


def _sample_perf_idx(rng: np.random.Generator, size: int, mix=DEFAULT_MIX) -> np.ndarray:
    names = [n for n, _ in mix]
    probs = np.asarray([p for _, p in mix])
    probs = probs / probs.sum()
    draw = rng.choice(len(names), size=size, p=probs)
    idx = np.asarray([APP_MODEL_INDEX[n] for n in names])
    return idx[draw]


def synth_workload(
    topo: Topology,
    duration_s: int,
    *,
    seed: int = 0,
    target_utilisation: float = 0.60,
    standing_fraction: float = 0.35,
    mix=DEFAULT_MIX,
) -> Workload:
    """Synthesize a Google-shaped workload for `duration_s` seconds.

    `target_utilisation` is the fraction of machine-slot-seconds consumed;
    `standing_fraction` of that budget goes to long-running services that
    arrive at t=0 and span the whole trace (the paper notes long-running
    jobs "set up at the beginning of the trace" constrain placements).
    """
    rng = np.random.default_rng(seed)
    slot_seconds = topo.n_machines * topo.slots_per_machine * duration_s
    budget = target_utilisation * slot_seconds

    jobs: List[Job] = []
    job_id = 0

    # Standing services.
    standing_budget = budget * standing_fraction
    used = 0.0
    while used < standing_budget:
        n_tasks = int(_sample_n_tasks(rng, 1)[0])
        jobs.append(
            Job(
                job_id=job_id,
                arrival_s=0.0,
                n_tasks=n_tasks,
                duration_s=float(duration_s),
                perf_idx=int(_sample_perf_idx(rng, 1, mix)[0]),
            )
        )
        used += n_tasks * duration_s
        job_id += 1

    # Dynamic arrivals (Poisson in time, thinned to the remaining budget).
    dyn_budget = budget - used
    used_dyn = 0.0
    # Expected per-job consumption for a rough arrival-rate estimate.
    probe_tasks = _sample_n_tasks(rng, 256)
    probe_dur = _sample_duration(rng, 256)
    mean_cons = float(np.mean(probe_tasks * np.minimum(probe_dur, duration_s / 2)))
    est_jobs = max(4, int(dyn_budget / max(mean_cons, 1.0)))
    arrivals = np.sort(rng.uniform(0, duration_s * 0.9, size=est_jobs * 2))
    for arr in arrivals:
        if used_dyn >= dyn_budget:
            break
        n_tasks = int(_sample_n_tasks(rng, 1)[0])
        dur = float(min(_sample_duration(rng, 1)[0], duration_s - arr))
        jobs.append(
            Job(
                job_id=job_id,
                arrival_s=float(arr),
                n_tasks=n_tasks,
                duration_s=dur,
                perf_idx=int(_sample_perf_idx(rng, 1, mix)[0]),
            )
        )
        used_dyn += n_tasks * dur
        job_id += 1

    jobs.sort(key=lambda j: j.arrival_s)
    for i, j in enumerate(jobs):
        j.job_id = i
    return Workload(jobs=jobs, duration_s=duration_s, topo=topo)


# --- ML-architecture job mapping (DESIGN.md §3) -----------------------------

ARCH_PROFILE = {
    # dense / MoE synchronous training ~ TensorFlow-sync profile (Eq. 5)
    "train": "tensorflow",
    # serving (decode/prefill) ~ request-response Memcached profile (Eq. 2)
    "serve": "memcached",
    # SSM/hybrid sequential-scan training ~ STRADS star profile (Eq. 3)
    "scan_train": "strads",
    # throughput-bound batch/preproc ~ Spark profile (Eq. 4)
    "batch": "spark",
}


def ml_job(
    job_id: int,
    arch: str,
    kind: str,
    n_hosts: int,
    duration_s: float,
    arrival_s: float = 0.0,
) -> Job:
    """An LM workload as a NoMora job (root = coordinator host)."""
    return Job(
        job_id=job_id,
        arrival_s=arrival_s,
        n_tasks=n_hosts,
        duration_s=duration_s,
        perf_idx=APP_MODEL_INDEX[ARCH_PROFILE[kind]],
        ml_arch=arch,
    )
