"""Epsilon-scaling auction solver for the collapsed NoMora instance, in PyTorch.

Port of `repro.core.auction`. The NoMora flow network reduces to a
transportation problem: assign each task one unit to a machine slot or to
its job's unscheduled aggregator. It is solved with Bertsekas' auction in
the "similar objects" form (Bertsekas & Castanon 1989): one price per
machine slot, machines offer their cheapest slot, and the runner-up offer
may be the same machine's second-cheapest slot. A single forward phase
from zero prices with eps = 1 on integer-valued float32 (scaled values
< 2^24) gives bit-identical results to the reference.

The phase (the reference's `auction_phase_step`, a ``jax.lax.while_loop``
of Jacobi iterations: bid, conflict resolution, updates) is the
`auction_phase` op: on the card one persistent CUDA launch per solve
(``csrc/auction_phase.cu``), on CPU tensors the step-wise loop of
`repro_torch.kernels.auction_phase.ref`. Both solve paths below,
host costs in (`solve_transportation`) and cost tensors already on the
device (`solve_transportation_device`), go through it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels.auction_phase import ops as phase_ops
from repro_torch.kernels.auction_phase.ref import PRICE_LOCK

from .policy import INF_COST

NEG_VALUE = float(-(2.0**40))  # value of a forbidden column
_F32_EXACT = 2**24  # |ints| exactly representable in float32


def _bucket(n: int, lo: int = 8) -> int:
    """Power-of-two padding bucket with floor ``lo`` (the reference's
    buckets, so padded shapes and the jitter matrix match it)."""
    b = lo
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class AuctionResult:
    assigned_col: np.ndarray  # (T,) machine id, or the task's unsched column
    total_cost: int
    iterations: int
    prices: object  # (M, S) final slot prices (scaled units), array or tensor


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def solve_transportation(
    w: np.ndarray,  # (T, C) int costs, INF_COST = forbidden; C = M + J
    machine_capacity: np.ndarray,  # (M,) slots per machine
    n_machines: int,
    task_job_col: np.ndarray,  # (T,) column id (>= M) of each task's unsched agg
    *,
    slots_per_machine: int | None = None,
    eps: float = 1.0,
    max_iters_per_phase: int = 500_000,
    tie_jitter: int = 0,
    exact: bool = True,
    device="cuda",
) -> AuctionResult:
    """Min-cost assignment of tasks to machine slots / unscheduled.

    Host costs in, the phase on ``device``. `exact=True` scales costs by
    (T+1) so eps=1 pins the true optimum; `exact=False` (the scheduler
    default) runs on unscaled costs, suboptimal by <= 1 unit per task.
    `tie_jitter` > 0 adds the deterministic per-(task, machine) jitter of
    `_jitter_device` (hashed on the CPU) to machine costs.
    """
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    T, C = w.shape
    if tie_jitter > 0 and T > 0:
        M_ = n_machines
        w = w.copy()
        jit = _jitter_device(_bucket(T), M_, tie_jitter, "cpu")[:T].numpy().astype(np.int64)
        mcols = w[:, :M_]
        w[:, :M_] = np.where(mcols < int(INF_COST), mcols + jit, mcols)
    M = n_machines
    if T == 0:
        return AuctionResult(
            assigned_col=np.zeros((0,), np.int64),
            total_cost=0,
            iterations=0,
            prices=np.zeros((M, int(slots_per_machine or 1)), np.float32),
        )
    if not (task_job_col.min() >= M and task_job_col.max() < C):
        raise ValueError("task_job_col must index the unscheduled columns [M, C)")

    S = int(slots_per_machine or max(1, int(machine_capacity.max(initial=1))))
    Tp = _bucket(T)
    scale = (T + 1) if exact else 1

    w_m = w[:, :M].astype(np.int64)
    finite = w_m < int(INF_COST)
    max_cost = int(np.max(np.where(finite, w_m, 0), initial=1))
    max_unsched = int(np.max(w[np.arange(T), task_job_col]))
    if max(max_cost, max_unsched) * scale * 4 >= _F32_EXACT:
        raise ValueError(
            f"scaled costs exceed float32-exact range: "
            f"{max(max_cost, max_unsched)} * {scale} * 4 >= 2^24"
        )

    vm = np.where(finite, (-w_m * scale).astype(np.float32), np.float32(NEG_VALUE))
    vu = (-w[np.arange(T), task_job_col].astype(np.int64) * scale).astype(np.float32)

    vm_p = np.full((Tp, M), np.float32(NEG_VALUE), np.float32)
    vm_p[:T] = vm
    vu_p = np.zeros((Tp,), np.float32)
    vu_p[:T] = vu
    jobcol_p = np.full((Tp,), M, np.int32)
    jobcol_p[:T] = task_job_col
    active = np.zeros((Tp,), bool)
    active[:T] = True

    # Zero initial prices; slots beyond a machine's capacity are locked.
    price0 = np.zeros((M, S), np.float32)
    locked = np.arange(S)[None, :] >= machine_capacity[:, None]
    price0[locked] = PRICE_LOCK

    def up(x):
        return torch.from_numpy(x).to(device)

    price, _, assigned, iters = phase_ops.auction_phase(
        up(price0), up(vm_p), up(vu_p), up(jobcol_p), up(active), eps, max_iters_per_phase,
    )
    if iters >= max_iters_per_phase:
        raise RuntimeError(f"auction hit the iteration cap ({max_iters_per_phase})")

    assigned_np = assigned[:T].cpu().numpy()
    if (assigned_np < 0).any():
        raise RuntimeError("auction did not converge: unassigned tasks remain")
    col = assigned_np.astype(np.int64)
    costs = w[np.arange(T), col].astype(np.int64)
    return AuctionResult(
        assigned_col=col,
        total_cost=int(costs.sum()),
        iterations=iters,
        prices=price.cpu().numpy(),
    )


_M32 = (1 << 32) - 1
_JITTER_ROWS = 256  # rows of the jitter matrix hashed at a time (int64 temporaries)


def _limbs_times(ids: torch.Tensor, k: int):
    """(hi, lo) 32-bit halves of ``ids * k mod 2^64`` for 0 <= ids < 2^30:
    every int64 intermediate stays below 2^63."""
    lo = ids * (k & _M32)
    hi = (ids * (k >> 32) + (lo >> 32)) & _M32
    return hi, lo & _M32


@functools.lru_cache(maxsize=8)
def _jitter_device(n_rows: int, n_cols: int, tie_jitter: int, device: str) -> torch.Tensor:
    """Deterministic per-(task, machine) tie jitter in [0, tie_jitter), int32,
    computed on ``device`` and cached per padded round shape. The
    reference's hash (``h = t * 0x9E3779B97F4A7C15 + m * 0xBF58476D1CE4E5B9``
    mod 2^64, ``h ^= h >> 29``, ``h % tie_jitter``) runs on 32-bit halves held
    in int64 (the logical shift and the unsigned remainder written out), so
    host and device rounds place identically bit for bit; on the card a
    bucket seen for the first time costs no host hashing and no upload of
    the (n_rows, n_cols) matrix."""
    out = torch.zeros((n_rows, n_cols), dtype=torch.int32, device=device)
    if tie_jitter <= 0:
        return out
    cols = torch.arange(n_cols, dtype=torch.int64, device=device)
    m_hi, m_lo = _limbs_times(cols, 0xBF58476D1CE4E5B9)
    rows = torch.arange(n_rows, dtype=torch.int64, device=device)[:, None]
    for r0 in range(0, n_rows, _JITTER_ROWS):
        t_hi, t_lo = _limbs_times(rows[r0 : r0 + _JITTER_ROWS], 0x9E3779B97F4A7C15)
        lo = t_lo + m_lo
        hi = (t_hi + m_hi + (lo >> 32)) & _M32
        lo = lo & _M32
        # h ^= h >> 29, on the halves
        lo, hi = lo ^ (((lo >> 29) | (hi << 3)) & _M32), hi ^ (hi >> 29)
        # h % tie_jitter, h = hi * 2^32 + lo
        out[r0 : r0 + _JITTER_ROWS] = (hi * ((1 << 32) % tie_jitter) + lo) % tie_jitter
    return out


# --- Round on a device: cost tensors in, assignment out ---------------------


def prepare_values_step(
    w_m,  # (Tp, M) i32 machine costs (INF_COST = no arc)
    a,  # (Tp,) i32 unscheduled costs
    jit_m,  # (Tp, M) i32 tie jitter
    active,  # (Tp,) bool
    capacity,  # (M,) i32 free slots
    scale: int,  # (T+1) in exact mode, else 1
    n_slots: int,
):
    """Solver-value prep: jitter, value scaling, zero-start prices."""
    device = w_m.device
    finite = w_m < int(INF_COST)
    wj = torch.where(finite, w_m + jit_m, w_m)  # int32; bound-checked by caller
    neg = _f32(NEG_VALUE, device)
    vm = torch.where(finite & active[:, None], (-(wj * scale)).to(torch.float32), neg)
    vu = torch.where(active, (-(a * scale)).to(torch.float32), _f32(0.0, device))
    slot_iota = torch.arange(n_slots, device=device)[None, :]
    price0 = torch.where(
        slot_iota >= capacity[:, None], _f32(PRICE_LOCK, device), _f32(0.0, device)
    )
    return vm, vu, price0, wj


def assignment_cost_step(wj, a, assigned, active):
    """Per-task chosen arc cost (jittered machine cols / unsched), (Tp,) i32.

    Returned unsummed: the host accumulates in int64.
    """
    M = wj.shape[1]
    rows = torch.arange(wj.shape[0], device=wj.device)
    mcost = wj[rows, torch.clamp(assigned, 0, M - 1).long()]
    per_task = torch.where(assigned < M, mcost, a)
    return torch.where(active, per_task, 0)


def solve_transportation_device(
    w_m: torch.Tensor,  # (Tp, M) i32 device machine costs, rows >= n_tasks junk
    a: torch.Tensor,  # (Tp,) i32 device unscheduled costs
    n_tasks: int,  # actual task count T <= Tp
    machine_capacity: np.ndarray,  # (M,) host slots per machine
    n_machines: int,
    task_job: np.ndarray,  # (T,) host round-local job index
    *,
    slots_per_machine: int | None = None,
    eps: float = 1.0,
    max_iters_per_phase: int = 500_000,
    tie_jitter: int = 0,
    exact: bool = True,
    cost_bound: int | None = None,
) -> AuctionResult:
    """`solve_transportation` on cost tensors already on their device.

    The (Tp, M) machine-cost matrix stays on ``w_m``'s device; only O(T)
    results come back. ``cost_bound`` is a host-known upper bound on any
    finite cost (pre-jitter) that keeps the float32-exactness check free of
    a device sync.
    """
    device = w_m.device
    T = n_tasks
    M = n_machines
    Tp = int(w_m.shape[0])
    S = int(slots_per_machine or max(1, int(np.max(machine_capacity, initial=1))))
    if T == 0:
        return AuctionResult(
            assigned_col=np.zeros((0,), np.int64),
            total_cost=0,
            iterations=0,
            prices=np.zeros((M, S), np.float32),
        )
    scale = (T + 1) if exact else 1
    if cost_bound is None:
        wm = w_m[:T].cpu().numpy()
        cost_bound = int(
            max(
                np.max(np.where(wm < INF_COST, wm, 0), initial=1),
                np.max(a[:T].cpu().numpy()),
            )
        )
    if (cost_bound + max(tie_jitter - 1, 0)) * scale * 4 >= _F32_EXACT:
        raise ValueError(
            f"scaled costs exceed float32-exact range: "
            f"{cost_bound} * {scale} * 4 >= 2^24"
        )

    jobcol_p = np.full((Tp,), M, np.int32)
    jobcol_p[:T] = M + task_job
    active = np.zeros((Tp,), bool)
    active[:T] = True
    active_dev = torch.from_numpy(active).to(device)

    vm, vu, price0, wj = prepare_values_step(
        w_m,
        a,
        _jitter_device(Tp, M, tie_jitter, str(device)),
        active_dev,
        torch.from_numpy(machine_capacity.astype(np.int32)).to(device),
        scale,
        S,
    )
    price, _, assigned, iters = phase_ops.auction_phase(
        price0,
        vm,
        vu,
        torch.from_numpy(jobcol_p).to(device),
        active_dev,
        eps,
        max_iters_per_phase,
    )
    if iters >= max_iters_per_phase:
        raise RuntimeError(f"auction hit the iteration cap ({max_iters_per_phase})")
    assigned_np = assigned[:T].cpu().numpy()
    if (assigned_np < 0).any():
        raise RuntimeError("auction did not converge: unassigned tasks remain")
    total_cost = int(
        assignment_cost_step(wj, a, assigned, active_dev).cpu().numpy()
        .astype(np.int64)
        .sum()
    )
    return AuctionResult(
        assigned_col=assigned_np.astype(np.int64),
        total_cost=total_cost,
        iterations=iters,
        prices=price,  # left on the device
    )
