"""Epsilon-scaling auction solver for the collapsed NoMora instance, in PyTorch.

Port of `repro.core.auction`. The NoMora flow network reduces to a
transportation problem: assign each task one unit to a machine slot or to
its job's unscheduled aggregator. It is solved with Bertsekas' auction in
the "similar objects" form (Bertsekas & Castanon 1989): one price per
machine slot, machines offer their cheapest slot, and the runner-up offer
may be the same machine's second-cheapest slot. A single forward phase
from zero prices with eps = 1 on integer-valued float32 (scaled values
< 2^24) gives bit-identical results to the reference.

Each Jacobi iteration of `auction_phase_step`:
  1. `bid_top2` over the (T, M) value matrix (the CUDA kernel on the card),
     merged with the task's own unscheduled offer;
  2. conflict resolution, max bid per machine with ties to the lowest task
     id, by one of two bit-identical strategies chosen by shape as in the
     reference: a (T, T) dominance table when T*T <= 4*M, else a segment
     max/min over machines (`scatter_reduce`);
  3. slot price / owner / assignment updates.

The reference's ``jax.lax.while_loop`` is a host loop here: it tests "any
active task unassigned and it < max_iters" once per iteration (one device
sync) and counts iterations exactly as the reference does. The reference's
out-of-bounds ``mode="drop"`` scatters become writes into a sink row (the
working price/owner tables carry one extra row, never read) or a sink
element of a (T+1,) mark buffer.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels.auction_bid import ops as bid_ops

from .policy import INF_COST

NEG_VALUE = float(-(2.0**40))  # value of a forbidden column
PRICE_LOCK = float(2.0**40)  # price of a slot beyond a machine's capacity
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


def auction_phase_step(
    price,  # (M, S) f32 slot prices (scaled integer units)
    values_m,  # (T, M) f32 scaled values (-cost), NEG_VALUE forbidden
    value_u,  # (T,) f32 scaled value of the task's own unscheduled column
    job_col,  # (T,) i32 column id of the task's unscheduled aggregator
    active,  # (T,) bool real (non-padding) tasks
    eps,  # f32 0-dim tensor
    max_iters: int,
):
    """Auction phase: ``(price0, values, ...) -> (price, owner, assigned, iters)``.

    All tensors on one device; ``iters`` is a Python int.
    """
    device = values_m.device
    T, M = values_m.shape
    S = price.shape[1]
    m_ids = torch.arange(M, dtype=torch.int32, device=device)
    m_long = m_ids.long()
    t_ids = torch.arange(T, dtype=torch.int32, device=device)
    slot_iota = torch.arange(S, device=device)[None, :]
    lock = _f32(PRICE_LOCK, device)
    no_bid = _f32(-1.0, device)
    t_sink = torch.full((M,), T, dtype=torch.int32, device=device)

    # Row M of the working tables is the sink for masked writes.
    price = torch.cat([price, torch.zeros((1, S), dtype=torch.float32, device=device)])
    owner = torch.full((M + 1, S), -1, dtype=torch.int32, device=device)
    assigned = torch.where(active, -1, 0).to(torch.int32)

    it = 0
    while it < max_iters and bool(((assigned < 0) & active).any()):
        unassigned = (assigned < 0) & active

        # Per-machine cheapest and second-cheapest slot (first index on ties).
        live = price[:M]
        price1, slot1 = torch.min(live, dim=1)  # (M,)
        price2 = torch.where(slot_iota == slot1[:, None], lock, live).amin(dim=1)

        best_m, best_v, second_v = bid_ops.bid_top2(values_m, price1, price2)
        bm = best_m.long()

        # Merge the task's own unscheduled offer (price pinned at 0).
        u_better = value_u > best_v
        second_for_machine = torch.maximum(second_v, value_u)
        bids_unsched = unassigned & u_better
        bids_machine = unassigned & ~u_better

        # Machine bid level: beat the runner-up offer by eps.
        bid_level = price1[bm] + (best_v - second_for_machine) + eps
        bids = torch.where(bids_machine, bid_level, no_bid)

        evict_mark = torch.zeros(T + 1, dtype=torch.bool, device=device)
        if T * T <= 4 * M:
            # T-space: a (T, T) same-machine dominance table.
            same_m = bm[:, None] == bm[None, :]
            dominated = (bids[None, :] > bids[:, None]) | (
                (bids[None, :] == bids[:, None]) & (t_ids[None, :] < t_ids[:, None])
            )
            loses = (same_m & dominated).any(dim=1)
            winner = bids_machine & ~loses
            win_slot_t = slot1[bm]
            evicted_t = torch.where(winner, owner[bm, win_slot_t], -1)

            # Per-machine winners are unique; losers write to the sink row.
            win_m_t = torch.where(winner, bm, M)
            price.index_put_((win_m_t, win_slot_t), bids)
            owner.index_put_((win_m_t, win_slot_t), t_ids)

            # Evictees are disjoint from winners; -1 goes to the sink T.
            evict_mark[torch.where(evicted_t >= 0, evicted_t, T).long()] = True
            assigned = torch.where(evict_mark[:T], -1, assigned)
            assigned = torch.where(winner, best_m, assigned)
            assigned = torch.where(bids_unsched, job_col, assigned)
        else:
            # M-space: two-pass segment reduction over machines. Empty
            # segments keep -inf (jax's segment_max identity), so only
            # machines that somebody bid on can have a winner.
            win_bid = torch.full((M,), float("-inf"), device=device).scatter_reduce(
                0, bm, bids, "amax", include_self=False
            )
            has_winner = win_bid >= 0
            is_winner_cand = bids_machine & (bids == win_bid[bm])
            win_task = t_sink.scatter_reduce(
                0, bm, torch.where(is_winner_cand, t_ids, T), "amin", include_self=False
            )
            win_task = torch.where(has_winner, win_task, 0)
            win_slot = slot1

            evicted = torch.where(has_winner, owner[m_long, win_slot], -1)

            win_m = torch.where(has_winner, m_long, M)
            price.index_put_((win_m, win_slot), win_bid)
            owner.index_put_((win_m, win_slot), win_task)

            evict_mark[torch.where(evicted >= 0, evicted, T).long()] = True

            # Winner marks (each task bids on one machine: no duplicates
            # outside the sink).
            win_tgt = torch.where(has_winner, win_task, T).long()
            win_mark = torch.zeros(T + 1, dtype=torch.bool, device=device)
            win_mark[win_tgt] = True
            win_col = torch.zeros(T + 1, dtype=torch.int32, device=device)
            win_col[win_tgt] = m_ids + 1

            assigned = torch.where(evict_mark[:T], -1, assigned)
            assigned = torch.where(win_mark[:T], win_col[:T] - 1, assigned)
            assigned = torch.where(bids_unsched, job_col, assigned)
        it += 1
    return price[:M], owner[:M], assigned, it


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
    `_jitter_matrix_np` to machine costs.
    """
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    T, C = w.shape
    if tie_jitter > 0 and T > 0:
        M_ = n_machines
        w = w.copy()
        jit = _jitter_matrix_np(T, M_, tie_jitter).astype(np.int64)
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

    price, _, assigned, iters = auction_phase_step(
        up(price0), up(vm_p), up(vu_p), up(jobcol_p), up(active),
        _f32(eps, device), max_iters_per_phase,
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


# --- Round on a device: cost tensors in, assignment out ---------------------


def _jitter_matrix_np(n_rows: int, n_cols: int, tie_jitter: int) -> np.ndarray:
    """Deterministic per-(task, machine) tie jitter in [0, tie_jitter).

    The reference's hash, for both solve paths, so host and device rounds
    place identically bit for bit.
    """
    tt = np.arange(n_rows, dtype=np.uint64)[:, None]
    mm = np.arange(n_cols, dtype=np.uint64)[None, :]
    h = tt * np.uint64(0x9E3779B97F4A7C15) + mm * np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(29)
    return (h % np.uint64(tie_jitter)).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _jitter_device(n_rows: int, n_cols: int, tie_jitter: int, device: str) -> torch.Tensor:
    """Jitter matrix on ``device``, cached per padded round shape: one
    upload per bucket, not per round."""
    if tie_jitter <= 0:
        return torch.zeros((n_rows, n_cols), dtype=torch.int32, device=device)
    return torch.from_numpy(_jitter_matrix_np(n_rows, n_cols, tie_jitter)).to(device)


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
    price, _, assigned, iters = auction_phase_step(
        price0,
        vm,
        vu,
        torch.from_numpy(jobcol_p).to(device),
        active_dev,
        _f32(eps, device),
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
