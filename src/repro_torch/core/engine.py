"""Structure-of-arrays task state for the vectorized simulator engine.

The seed simulator kept one Python `TaskRec` object per task and walked
Python lists every round (retire, wait accrual, ready scans), which caps
replay size far below the paper's 12,500-machine / multi-week traces. Here
task state lives in parallel numpy arrays indexed by a dense *task id*
assigned in admission order (jobs in arrival order, tasks in task-index
order inside a job), so every per-round loop becomes a masked vector op
and queues become int64 id arrays.

Keeping ids in admission order is load-bearing for golden parity with the
reference engine: `np.nonzero` over a task mask then yields exactly the
iteration order of the seed's ``for rec in jobs: for task in rec.tasks``
loops, so metric append order (and hence `SimMetrics` content) matches
bit-for-bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

EMPTY_IDS = np.empty(0, np.int64)


def _init_columns(table) -> None:
    """Allocate a table's column arrays from its ``_FILLS`` spec."""
    for name, (fill, dtype) in table._FILLS.items():
        setattr(table, name, np.full(table.capacity, fill, dtype))


def _grow_columns(table, min_capacity: int) -> None:
    """Double a SoA table's column arrays (shared by Task/JobTable).

    Admitted rows are copied; fresh rows get the column's sentinel fill
    from ``_FILLS`` — the single source of truth for column layout."""
    new = max(min_capacity, table.capacity * 2, 64)
    for name, (fill, dtype) in table._FILLS.items():
        arr = np.full(new, fill, dtype)
        arr[: table.n] = getattr(table, name)[: table.n]
        setattr(table, name, arr)
    table.capacity = new


@dataclasses.dataclass
class TaskTable:
    """Parallel per-task arrays (capacity grows by doubling on demand).

    ``n`` counts admitted tasks; rows ``>= n`` are unused capacity. Size
    the initial capacity to ``workload.n_tasks_total`` when it is known
    (one allocation); trace cursors with unknown totals pass an estimate
    (`n_tasks_hint`) and the table doubles as admission outruns it. Float
    columns are float64 so arithmetic matches the seed engine's Python
    floats exactly; ``job`` holds the *dense* job index (admission order),
    not the workload's ``job_id``.
    """

    capacity: int
    n: int = 0
    job: np.ndarray = None  # (N,) int64 dense job index
    task_idx: np.ndarray = None  # (N,) int64; 0 == root
    submit_s: np.ndarray = None  # (N,) float64
    machine: np.ndarray = None  # (N,) int64; -1 == unplaced
    start_s: np.ndarray = None  # (N,) float64; -1 == not started
    placed_s: np.ndarray = None  # (N,) float64; -1 == never placed
    end_s: np.ndarray = None  # (N,) float64; -1 == not finished
    wait_s: np.ndarray = None  # (N,) float64

    # Column layout: name -> (sentinel fill for unused rows, dtype).
    _FILLS = {
        "job": (0, np.int64),
        "task_idx": (0, np.int64),
        "submit_s": (0.0, np.float64),
        "machine": (-1, np.int64),
        "start_s": (-1.0, np.float64),
        "placed_s": (-1.0, np.float64),
        "end_s": (-1.0, np.float64),
        "wait_s": (0.0, np.float64),
    }

    def __post_init__(self):
        _init_columns(self)

    def append_job(self, job_dense: int, n_tasks: int, submit_s: float) -> np.ndarray:
        """Admit one job's tasks; returns their dense task ids (root first)."""
        lo, hi = self.n, self.n + n_tasks
        if hi > self.capacity:
            _grow_columns(self, hi)
        ids = np.arange(lo, hi, dtype=np.int64)
        self.job[lo:hi] = job_dense
        self.task_idx[lo:hi] = np.arange(n_tasks)
        self.submit_s[lo:hi] = submit_s
        self.n = hi
        return ids

    def requeue(self, ids: np.ndarray) -> None:
        """Reset placement state for failure re-queue (seed semantics:
        machine/start/end back to -1, wait restarts from zero)."""
        self.machine[ids] = -1
        self.start_s[ids] = -1.0
        self.end_s[ids] = -1.0
        self.wait_s[ids] = 0.0

    def start(
        self, ids: np.ndarray, machines: np.ndarray, t: float, algo_s: float,
        duration_s: np.ndarray,
    ) -> None:
        """Vectorized `_start_task` for a batch: place `ids` on `machines`."""
        when = float(t) + float(algo_s)
        self.machine[ids] = machines
        self.placed_s[ids] = when
        self.start_s[ids] = when
        self.end_s[ids] = when + duration_s


@dataclasses.dataclass
class JobTable:
    """Parallel per-job arrays, indexed densely in admission order
    (capacity grows by doubling, like `TaskTable`)."""

    capacity: int
    n: int = 0
    job_id: np.ndarray = None  # (J,) int64 workload job_id
    duration_s: np.ndarray = None  # (J,) float64
    perf_idx: np.ndarray = None  # (J,) int64
    arrival_s: np.ndarray = None  # (J,) float64 workload arrival time
    root_machine: np.ndarray = None  # (J,) int64; -1 == root unplaced
    done: np.ndarray = None  # (J,) bool, sticky
    unfinished: np.ndarray = None  # (J,) int64 tasks not yet completed

    # Column layout: name -> (sentinel fill for unused rows, dtype).
    _FILLS = {
        "job_id": (0, np.int64),
        "duration_s": (0.0, np.float64),
        "perf_idx": (0, np.int64),
        "arrival_s": (0.0, np.float64),
        "root_machine": (-1, np.int64),
        "done": (False, bool),
        "unfinished": (0, np.int64),
    }

    def __post_init__(self):
        _init_columns(self)

    def append(
        self,
        job_id: int,
        duration_s: float,
        perf_idx: int,
        n_tasks: int,
        arrival_s: float = 0.0,
    ) -> int:
        j = self.n
        if j >= self.capacity:
            _grow_columns(self, j + 1)
        self.job_id[j] = job_id
        self.duration_s[j] = duration_s
        self.perf_idx[j] = perf_idx
        self.arrival_s[j] = arrival_s
        self.unfinished[j] = n_tasks
        self.n = j + 1
        return j


def take_ready(
    queue: np.ndarray, ready_mask: np.ndarray, limit: int
) -> tuple[np.ndarray, np.ndarray]:
    """First `limit` queue positions where `ready_mask` holds.

    Returns (positions-into-queue, ids), both in queue order — the array
    analogue of the seed's ``[t for t in pending if ready(t)][:limit]``.
    """
    pos = np.nonzero(ready_mask)[0][:limit]
    return pos, queue[pos]


def drop_positions(queue: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Remove queue entries at `pos`, preserving order of the rest."""
    if len(pos) == 0:
        return queue
    keep = np.ones(len(queue), bool)
    keep[pos] = False
    return queue[keep]
