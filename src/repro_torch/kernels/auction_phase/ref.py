"""The auction solver's Jacobi phase as a step-wise host loop (any device).

Port of the reference's `auction_phase_step` (`repro.core.auction`), whose
``jax.lax.while_loop`` becomes a host loop here: it tests "any active task
unassigned and it < max_iters" once per iteration (one device sync) and
counts iterations exactly as the reference does. Each iteration:

  1. `bid_top2` over the (T, M) value matrix (the bid kernel on the card),
     merged with the task's own unscheduled offer;
  2. conflict resolution, max bid per machine with ties to the lowest task
     id, by one of two bit-identical strategies chosen by shape as in the
     reference: a (T, T) dominance table when T*T <= 4*M, else a segment
     max/min over machines (`scatter_reduce`);
  3. slot price / owner / assignment updates.

The reference's out-of-bounds ``mode="drop"`` scatters become writes into a
sink row (the working price/owner tables carry one extra row, never read)
or a sink element of a (T+1,) mark buffer. This is the plain version the
persistent CUDA kernel (``csrc/auction_phase.cu``) is held to, and the path
CPU tensors take.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.auction_bid import ops as bid_ops

PRICE_LOCK = float(2.0**40)  # price of a slot beyond a machine's capacity


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def auction_phase_ref(
    price,  # (M, S) f32 slot prices (scaled integer units)
    values_m,  # (T, M) f32 scaled values (-cost), NEG_VALUE forbidden
    value_u,  # (T,) f32 scaled value of the task's own unscheduled column
    job_col,  # (T,) i32 column id of the task's unscheduled aggregator
    active,  # (T,) bool real (non-padding) tasks
    eps: float,
    max_iters: int,
    *,
    return_bidder_rows: bool = False,
):
    """``(price0, values, ...) -> (price, owner, assigned, iters)``.

    All tensors on one device; ``iters`` is a Python int. With
    ``return_bidder_rows`` a fifth value: the unassigned active tasks summed
    over the iterations (the rows that bid).
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
    eps = _f32(eps, device)
    t_sink = torch.full((M,), T, dtype=torch.int32, device=device)

    # Row M of the working tables is the sink for masked writes.
    price = torch.cat([price, torch.zeros((1, S), dtype=torch.float32, device=device)])
    owner = torch.full((M + 1, S), -1, dtype=torch.int32, device=device)
    assigned = torch.where(active, -1, 0).to(torch.int32)

    it = bidder_rows = 0
    while it < max_iters:
        unassigned = (assigned < 0) & active
        n_bidders = int(unassigned.sum())
        if n_bidders == 0:
            break
        bidder_rows += n_bidders

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
    out = (price[:M], owner[:M], assigned, it)
    return out + (bidder_rows,) if return_bidder_rows else out
