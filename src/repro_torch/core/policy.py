"""NoMora scheduling policy (paper §5.2) + baseline policies (§6.1), in PyTorch.

Port of `repro.core.policy`. The policy's cost model, per round:

  d_{t,m}   = round2sig(1 / p(max latency(M_root, M_m))) * 100      (Eq. 6)
  c_{t,r}   = max_{m in r} d_{t,m}                                  (Eq. 8)
  b_t       = max_r c_{t,r}                                         (Eq. 9)
  a_t       = omega * wait_time + gamma                             (Eq. 10)
  preemption: the running task's arc to its current machine is discounted
  by beta (accumulated runtime), Eq. 7.

The cheapest path from task t to machine m costs

  w(t,m) = d    if d <= p_m          (direct preference arc)
         = c_r  elif c_r <= p_r      (via rack aggregator)
         = b_t  otherwise            (via cluster aggregator)

Two interchangeable paths build the (T, M+J) matrix, as in the reference:

- `dense_costs` — the host reference: numpy end to end, with the costmap
  through its plain version on CPU tensors.
- `cost_round_step` / `device_round_costs` / `dense_costs_device` — the
  round on a torch device: costmap (the CUDA kernel on the card) → rack max
  (Eq. 8) → p_m/p_r/b thresholds → preemption discount (Eq. 7) →
  unscheduled costs (Eq. 10). `device_round_costs` pads the task and job
  dims to the caller's buckets; the device is the LUT's.

Numerics are the reference's bit for bit: int32 wherever it is int32, the
scalar parameters as float32 tensors, ``omega * wait_s + gamma`` as two
eager ops (no fused multiply-add), ``.to(torch.int32)`` truncating like
``astype``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.costmap import ops as costmap_ops

from . import perf_model
from .topology import Topology

INF_COST = np.int32(2**30)  # "no arc"

# NoMora machine-arc costs are bounded by construction: perf is clipped to
# >= 1e-2, so cost = round(10/p)*10 <= 10000 (perf_model.perf_to_cost).
# The single source for every host-side float32-exactness guard.
MAX_MACHINE_COST = 10_000


@dataclasses.dataclass(frozen=True)
class PolicyParams:
    """Cost-model parameters (paper §5.2 / §6)."""

    p_m: int = 105  # machine-arc preference threshold
    p_r: int = 110  # rack-arc preference threshold
    omega: float = 1.0  # wait-time escalation factor (per second)
    gamma: int = 1001  # unscheduled offset, > any arc cost (paper §6)
    preemption: bool = False
    beta_scale: float = 100.0 / 3600.0  # cost points per second already run
    unsched_capacity: Optional[int] = None  # None => N_i


@dataclasses.dataclass
class RoundState:
    """One scheduling round's inputs (non-root tasks whose root is placed).

    Host numpy arrays; the device paths upload what they need.
    """

    task_job: np.ndarray  # (T,) round-local job index 0..J-1
    perf_idx: np.ndarray  # (T,) perf-model index per task
    root_machine: np.ndarray  # (J,) machine of each job's root
    root_latency: np.ndarray  # (J, M) RTT us from each root to every machine
    wait_s: np.ndarray  # (T,) task wait time alpha
    run_s: np.ndarray  # (T,) accumulated runtime beta (running tasks)
    cur_machine: np.ndarray  # (T,) current machine or -1
    free_slots: np.ndarray  # (M,) slots available to this round

    @property
    def n_tasks(self) -> int:
        return int(self.task_job.shape[0])

    @property
    def n_jobs(self) -> int:
        return int(self.root_machine.shape[0])

    @property
    def n_machines(self) -> int:
        return int(self.free_slots.shape[0])


def _rack_pad(n_machines: int, per_rack: int) -> int:
    return -(-n_machines // per_rack) * per_rack


@dataclasses.dataclass
class DenseCosts:
    """w(t, col): columns = machines ++ per-job unscheduled aggregators.

    numpy arrays from `dense_costs`, torch tensors from `dense_costs_device`.
    """

    w: np.ndarray  # (T, M+J) int32; INF_COST where no arc
    col_capacity: np.ndarray  # (M+J,) int32
    d: np.ndarray  # (T, M) machine arc costs (pre-threshold), for tests
    c_rack: np.ndarray  # (T, R)
    b: np.ndarray  # (T,)
    a: np.ndarray  # (T,) unscheduled costs


def machine_costs(
    lut_table: torch.Tensor,
    perf_idx: np.ndarray,
    task_root_latency: np.ndarray,
) -> np.ndarray:
    """d_{t,m} for every task x machine (Eq. 6), on the CPU plain path."""
    return costmap_ops.costmap(
        lut_table.cpu(),
        torch.from_numpy(np.ascontiguousarray(perf_idx, np.int32)),
        torch.from_numpy(np.ascontiguousarray(task_root_latency, np.float32)),
    ).numpy()


def dense_costs(
    state: RoundState,
    topo: Topology,
    params: PolicyParams,
    lut_table: Optional[torch.Tensor] = None,
) -> DenseCosts:
    """Materialise the collapsed NoMora cost matrix for one round (numpy)."""
    if lut_table is None:
        lut_table = perf_model.perf_lut_table()
    T, J, M = state.n_tasks, state.n_jobs, state.n_machines

    # Eq. 6 per task: latency row is the task's job's root row.
    task_lat = state.root_latency[state.task_job]  # (T, M)
    d = machine_costs(lut_table, state.perf_idx, task_lat)  # (T, M) int32

    # Eq. 8: worst machine per rack (pad partial racks with 0 so max ignores).
    per_rack = topo.machines_per_rack
    Mp = _rack_pad(M, per_rack)
    d_pad = np.zeros((T, Mp), np.int32)
    d_pad[:, :M] = d
    c_rack = d_pad.reshape(T, Mp // per_rack, per_rack).max(axis=2)  # (T, R)
    b = c_rack.max(axis=1)  # (T,) Eq. 9

    rack_of_m = np.arange(M) // per_rack
    c_for_m = c_rack[:, rack_of_m]  # (T, M)
    w_m = np.where(
        d <= params.p_m, d, np.where(c_for_m <= params.p_r, c_for_m, b[:, None])
    ).astype(np.int32)

    # Preemption (Eq. 7): discount the running task's current machine by beta.
    if params.preemption:
        running = state.cur_machine >= 0
        if running.any():
            disc = np.maximum(
                1,
                w_m[running, state.cur_machine[running]]
                - (state.run_s[running] * params.beta_scale).astype(np.int64),
            ).astype(np.int32)
            w_m[running, state.cur_machine[running]] = disc

    # Eq. 10 unscheduled-aggregator columns (one per job; own-job only).
    a = (params.omega * state.wait_s + params.gamma).astype(np.int32)
    w_u = np.full((T, J), INF_COST, np.int32)
    w_u[np.arange(T), state.task_job] = a

    w = np.concatenate([w_m, w_u], axis=1)

    tasks_per_job = np.bincount(state.task_job, minlength=J).astype(np.int32)
    unsched_cap = (
        tasks_per_job
        if params.unsched_capacity is None
        else np.minimum(tasks_per_job, params.unsched_capacity).astype(np.int32)
    )
    col_capacity = np.concatenate([state.free_slots.astype(np.int32), unsched_cap])
    return DenseCosts(w=w, col_capacity=col_capacity, d=d, c_rack=c_rack, b=b, a=a)


# --- Cost pipeline on a torch device ---------------------------------------


def apply_preemption_discount(w_m, cur_machine, run_s, preemption, beta_scale):
    """Eq. 7: discount each running task's current-machine arc by beta.

    One write per row at (t, cur), so the write has no conflicts; ``w_m``
    is updated in place (it is the caller's fresh threshold output).
    ``beta_scale`` is a float32 tensor; ``preemption`` a Python bool.
    """
    if not preemption:
        return w_m
    T = cur_machine.shape[0]
    t_ids = torch.arange(T, device=w_m.device)
    running = cur_machine >= 0
    cur_safe = torch.where(running, cur_machine, 0).long()
    beta_pts = (run_s * beta_scale).to(torch.int32)
    cur_w = w_m[t_ids, cur_safe]
    disc = torch.clamp(cur_w - beta_pts, min=1)
    w_m[t_ids, cur_safe] = torch.where(running, disc, cur_w)
    return w_m


def cost_round_step(
    lut_table,  # (n_models, LUT_SIZE) f32
    task_job,  # (T,) i32
    perf_idx,  # (T,) i32
    root_latency,  # (J, M) f32
    wait_s,  # (T,) f32
    run_s,  # (T,) f32
    cur_machine,  # (T,) i32; -1 = not running
    p_m: int,
    p_r: int,
    omega,  # f32 0-dim tensor
    gamma,  # f32 0-dim tensor
    preemption: bool,
    beta_scale,  # f32 0-dim tensor
    *,
    per_rack: int,
):
    """Cost-model round step: Eqs. 6-10, ``inputs -> (w_m, a, d, c_rack, b)``.

    All tensors on one device. Bit-compatible with the numpy `dense_costs`
    ops: int32/float32 exactly as the host path computes them, so
    padded-then-sliced outputs match the host reference bit for bit.
    """
    T = task_job.shape[0]
    M = root_latency.shape[1]
    device = root_latency.device

    task_lat = root_latency.index_select(0, task_job.long())  # (T, M) gather
    d = costmap_ops.costmap(lut_table, perf_idx, task_lat)  # (T, M) i32

    # Eq. 8: worst machine per rack (pad partial racks with 0; real costs
    # are >= 100 so the padding never wins the max).
    Mp = _rack_pad(M, per_rack)
    d_pad = d
    if Mp != M:
        d_pad = torch.zeros((T, Mp), dtype=torch.int32, device=device)
        d_pad[:, :M] = d
    c_rack = d_pad.view(T, Mp // per_rack, per_rack).amax(dim=2)  # (T, R)
    b = c_rack.amax(dim=1)  # (T,) Eq. 9

    rack_of_m = torch.arange(M, device=device) // per_rack
    c_for_m = c_rack.index_select(1, rack_of_m)  # (T, M)
    w_m = torch.where(
        d <= p_m, d, torch.where(c_for_m <= p_r, c_for_m, b[:, None])
    ).to(torch.int32)

    w_m = apply_preemption_discount(w_m, cur_machine, run_s, preemption, beta_scale)

    # Eq. 10 unscheduled cost per task (two eager ops: no fused multiply-add).
    a = (omega * wait_s + gamma).to(torch.int32)
    return w_m, a, d, c_rack, b


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def device_round_costs(
    state: RoundState,
    topo,
    params: PolicyParams,
    lut_table: torch.Tensor,
    *,
    n_pad_tasks: Optional[int] = None,
    n_pad_jobs: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Round cost build on ``lut_table``'s device: (w_m, a, d, c_rack, b).

    ``n_pad_tasks`` / ``n_pad_jobs`` pad the varying round dimensions to
    fixed buckets (rows >= T are garbage and must be masked inactive
    downstream). With no padding the outputs have exact (T, ...) shapes and
    are bit-identical to the host `dense_costs` fields.
    """
    device = lut_table.device
    T, J, M = state.n_tasks, state.n_jobs, state.n_machines
    Tp = T if n_pad_tasks is None else max(n_pad_tasks, T)
    Jp = J if n_pad_jobs is None else max(n_pad_jobs, J)

    task_job = np.zeros(Tp, np.int32)
    task_job[:T] = state.task_job
    perf_idx = np.zeros(Tp, np.int32)
    perf_idx[:T] = state.perf_idx
    wait_s = np.zeros(Tp, np.float32)
    wait_s[:T] = state.wait_s
    run_s = np.zeros(Tp, np.float32)
    run_s[:T] = state.run_s
    cur = np.full(Tp, -1, np.int32)
    cur[:T] = state.cur_machine
    root_lat = np.zeros((Jp, M), np.float32)
    root_lat[:J] = state.root_latency

    def up(x):
        return torch.from_numpy(x).to(device)

    return cost_round_step(
        lut_table,
        up(task_job),
        up(perf_idx),
        up(root_lat),
        up(wait_s),
        up(run_s),
        up(cur),
        int(params.p_m),
        int(params.p_r),
        _f32(params.omega, device),
        _f32(params.gamma, device),
        bool(params.preemption),
        _f32(params.beta_scale, device),
        per_rack=topo.machines_per_rack,
    )


def dense_costs_device(
    state: RoundState,
    topo,
    params: PolicyParams,
    lut_table: Optional[torch.Tensor] = None,
    *,
    device="cuda",
) -> DenseCosts:
    """Device twin of `dense_costs`: same fields, torch tensors on ``device``.

    The parity reference API: every field is bit-identical to the numpy
    path. The scheduler's round uses `device_round_costs` +
    `auction.solve_transportation_device` directly.
    """
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    if lut_table is None:
        lut_table = perf_model.perf_lut_table()
    lut_table = lut_table.to(device)
    T, J = state.n_tasks, state.n_jobs
    w_m, a, d, c_rack, b = device_round_costs(state, topo, params, lut_table)
    tj = torch.from_numpy(np.asarray(state.task_job, np.int64)).to(device)
    w_u = torch.full((T, J), int(INF_COST), dtype=torch.int32, device=device)
    w_u[torch.arange(T, device=device), tj] = a
    w = torch.cat([w_m, w_u], dim=1)
    tasks_per_job = torch.zeros(J, dtype=torch.int32, device=device).index_add_(
        0, tj, torch.ones(T, dtype=torch.int32, device=device)
    )
    unsched_cap = (
        tasks_per_job
        if params.unsched_capacity is None
        else torch.clamp(tasks_per_job, max=params.unsched_capacity).to(torch.int32)
    )
    col_capacity = torch.cat(
        [torch.from_numpy(state.free_slots.astype(np.int32)).to(device), unsched_cap]
    )
    return DenseCosts(w=w, col_capacity=col_capacity, d=d, c_rack=c_rack, b=b, a=a)


# --- Baseline policies (paper §6.1) ----------------------------------------


# Crossover between the seed per-task numpy scan (O(T*M) C-speed ops, wins
# on small rounds) and the tree/heap paths (O(M + T log M) Python-level
# ops, win once T*M is large). Both branches are bit-identical; parity
# tests force each explicitly.
DENSE_SCAN_OPS = 1 << 16


def random_placement(
    rng: np.random.Generator,
    n_tasks: int,
    free_slots: np.ndarray,
    *,
    dense_scan_ops: int = DENSE_SCAN_OPS,
) -> np.ndarray:
    """Random policy: tasks always schedule if resources are idle.

    Returns machine per task (-1 if the cluster is full). Sampling is uniform
    over free *slots*, updating availability as tasks land.

    Draw-for-draw identical to the seed per-task loop (one bounded
    ``rng.integers`` per placement with a shrinking bound): the bounds are
    deterministic, so all T draws batch into one generator call (numpy's
    bounded-integer routine consumes the stream per element exactly like T
    scalar calls, asserted in tests/test_policy.py). Selection of the k-th
    free slot then runs the seed cumsum scan for small rounds and a Fenwick
    tree (built in log M vectorised passes, O(log M) per draw) once T*M
    would dominate — the Google-trace regime (12,500 machines, 1k-task
    rounds) where the seed loop's O(T*M) was the bottleneck.
    """
    free = free_slots.astype(np.int64)
    out = np.full(n_tasks, -1, np.int64)
    total = int(free.sum())
    n = min(n_tasks, total)
    if n == 0:
        return out
    # Bounds shrink by exactly one per draw (every draw places a task).
    ks = rng.integers(0, np.arange(total, total - n, -1))
    M = len(free)

    if n * M <= dense_scan_ops:  # seed scan: C-speed cumsum per draw
        freec = free.copy()
        for t in range(n):
            m = int(np.searchsorted(np.cumsum(freec), int(ks[t]), side="right"))
            out[t] = m
            freec[m] -= 1
        return out

    # Fenwick tree over per-machine free-slot counts; selecting the k-th
    # free slot in machine order matches searchsorted(cumsum, k, 'right').
    size = 1
    while size < M:
        size *= 2
    tree_np = np.zeros(size + 1, np.int64)
    tree_np[1 : M + 1] = free
    step = 1
    while step < size:  # pairwise build: log M vectorised adds
        idx = np.arange(2 * step, size + 1, 2 * step)
        tree_np[idx] += tree_np[idx - step]
        step *= 2
    tree = tree_np.tolist()  # python ints: ~10x faster scalar indexing
    for t in range(n):
        rem = int(ks[t])
        pos = 0
        bit = size
        while bit:
            nxt = pos + bit
            if nxt <= size and tree[nxt] <= rem:
                rem -= tree[nxt]
                pos = nxt
            bit >>= 1
        out[t] = pos  # largest prefix <= k => machine owning slot k
        i = pos + 1
        while i <= size:
            tree[i] -= 1
            i += i & -i
    return out


def load_spreading_placement(
    task_counts: np.ndarray,
    free_slots: np.ndarray,
    n_tasks: int,
    *,
    dense_scan_ops: int = DENSE_SCAN_OPS,
) -> np.ndarray:
    """Load-spreading policy: each task goes to the least-loaded machine.

    Small rounds run the seed per-task masked argmin (C-speed over M);
    large rounds switch to a heap — O(M + T log M) instead of O(T*M),
    bit-identical output: (count, machine) tuples pop in the same order
    argmin ties break (lowest machine id among minima), and each machine
    keeps exactly one live heap entry so there is no stale state to
    reconcile.
    """
    free = free_slots.astype(np.int64).copy()
    out = np.full(n_tasks, -1, np.int64)
    n = min(n_tasks, int(free.sum()))

    if n * len(free) <= dense_scan_ops:  # seed scan
        counts = task_counts.astype(np.int64).copy()
        for t in range(n_tasks):
            avail = free > 0
            if not avail.any():
                break
            masked = np.where(avail, counts, np.iinfo(np.int64).max)
            m = int(np.argmin(masked))
            out[t] = m
            counts[m] += 1
            free[m] -= 1
        return out

    heap = [
        (int(task_counts[m]), m) for m in range(len(free)) if free[m] > 0
    ]
    heapq.heapify(heap)
    for t in range(n_tasks):
        if not heap:
            break
        c, m = heapq.heappop(heap)
        out[t] = m
        free[m] -= 1
        if free[m] > 0:
            heapq.heappush(heap, (c + 1, m))
    return out
