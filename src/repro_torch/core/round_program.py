"""Device-resident round program: a window of scheduling rounds, what-if lanes.

Port of `repro.core.round_program`. The reference keeps the round state
resident on its device and advances it with one ``jax.lax.scan`` over a
**window** of rounds, and fans one round out over K parameter variants with
``jax.vmap``. Here the same state lives in torch tensors on one device and:

- `DeviceRoundState` — the fixed-shape carry: free slots, last-round slot
  prices, last-round assignment.
- `RoundWindow` — one window's exogenous inputs, stacked ``(R, ...)`` on
  the bucketed shapes ``(Tp, Jp)`` shared by every round of the window
  (built by `stack_round_states` from per-round `policy.RoundState`
  records; device-resident latency rows are copied on the device).
- `RoundProgram.advance` — the scan becomes a Python loop over the R
  rounds on device tensors, the carry rebuilt each round. Each round runs
  the port's step functions (`policy.cost_round_step` → Eq. 7 preemption
  discount → `auction.prepare_values_step` → the `auction_phase` op →
  `auction.assignment_cost_step`, plus the stay cost); on the card that is
  the costmap and auction_phase CUDA kernels. No round waits for the host:
  the window's assignments, costs and iteration counts come back in one
  transfer at the end, as the reference's one dispatch does.
- `RoundProgram.what_if` — the reference vmaps the round over K
  `PolicyParams` variants with per-lane **mover masks**; a vmapped
  ``while_loop`` freezes lanes that have finished, so every lane runs
  exactly its standalone solve. Here each lane is one launch of the
  persistent auction-phase kernel with the lane's own values, mask and free
  slots, the results stacked to the reference's (K, Tp) shapes. Rows masked
  out of a lane are frozen in place: they keep their current machine (its
  slot is re-debited from the lane's free slots on the device) and
  contribute their *stay* cost to the lane outcome.

Slot-accounting modes (``chain_slots``):

- ``False`` (exogenous): round ``r`` uses ``window.free_slots[r]`` exactly
  as a sequential caller would pass it — bit-identical to R independent
  `AuctionBackend.place` calls.
- ``True`` (chained): the carry's free slots advance on the device — round
  ``r`` uses ``carry + window.free_slots[r]`` (the row is an exogenous
  *delta*) and round ``r``'s placements are debited before round ``r+1``.
  Bit-identical to a sequential loop that does the same slot accounting on
  the host between `place` calls.

Bit-parity contract: for identical per-round inputs, every round's
assignment, iteration count and objective equal the per-round
`policy.device_round_costs` + `auction.solve_transportation_device` path
and the reference's program bit for bit (int32 and float32 throughout, the
same jitter hash, zero-start prices).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.kernels.auction_phase import ops as phase_ops

from . import auction, perf_model, policy
from .policy import MAX_MACHINE_COST, PolicyParams, RoundState, _f32


@dataclasses.dataclass
class DeviceRoundState:
    """Fixed-shape device-resident carry of a window.

    ``free_slots`` is the live cluster occupancy (advanced on the device
    under ``chain_slots=True``); ``prices`` / ``assigned`` are the last
    round's final slot prices and assignment (diagnostics: the next round's
    solve never reads them, by the zero-start-price requirement).
    """

    free_slots: torch.Tensor  # (M,) i32
    prices: torch.Tensor  # (M, S) f32
    assigned: torch.Tensor  # (Tp,) i32; -1 = no decision


@dataclasses.dataclass
class RoundWindow:
    """One window's stacked exogenous inputs (host-built, fixed shapes).

    ``free_slots`` rows are absolute per-round slot vectors under
    ``chain_slots=False`` and per-round *deltas* under ``chain_slots=True``.
    ``scale`` is the per-round auction cost scale ((T+1) exact, else 1).
    ``root_latency`` is numpy, or a tensor already on the program's device
    (`DeviceLatencyOracle` rows). ``n_tasks`` / ``wait_max`` stay on the
    host for result slicing and the float32-exactness guard.
    """

    task_job: np.ndarray  # (R, Tp) i32
    perf_idx: np.ndarray  # (R, Tp) i32
    root_latency: object  # (R, Jp, M) f32, numpy or a device tensor
    wait_s: np.ndarray  # (R, Tp) f32
    run_s: np.ndarray  # (R, Tp) f32
    cur_machine: np.ndarray  # (R, Tp) i32
    active: np.ndarray  # (R, Tp) bool
    free_slots: np.ndarray  # (R, M) i32 (absolute, or deltas when chained)
    scale: np.ndarray  # (R,) i32
    n_tasks: Tuple[int, ...]  # host: real task count per round
    wait_max: Tuple[float, ...]  # host: max wait_s per round (cost bound)

    @property
    def n_rounds(self) -> int:
        return int(self.task_job.shape[0])


@dataclasses.dataclass
class WindowResult:
    """Host view of one `advance` window (padded rows still present)."""

    assigned: np.ndarray  # (R, Tp) i32
    iterations: np.ndarray  # (R,) i32
    per_task_cost: np.ndarray  # (R, Tp) i32 (jittered, discounted)
    per_task_true_cost: np.ndarray  # (R, Tp) i32 (no jitter, no discount)
    n_tasks: Tuple[int, ...]

    def round_cols(self, r: int) -> np.ndarray:
        """Round ``r``'s assignment for its real tasks, (T_r,) int64."""
        return self.assigned[r, : self.n_tasks[r]].astype(np.int64)

    def round_objective(self, r: int) -> int:
        """Round ``r``'s solver objective (jittered units, int64 on host)."""
        return int(self.per_task_cost[r].astype(np.int64).sum())

    def round_true_cost(self, r: int) -> int:
        return int(self.per_task_true_cost[r].astype(np.int64).sum())


@dataclasses.dataclass
class WhatIfResult:
    """K what-if variants of one round."""

    assigned: np.ndarray  # (K, Tp) i32
    iterations: np.ndarray  # (K,) i32
    per_task_cost: np.ndarray  # (K, Tp) i32
    per_task_true_cost: np.ndarray  # (K, Tp) i32
    # Undiscounted cost of every task *staying put* (running tasks on
    # their current machine, pending tasks unscheduled) — the comparison
    # baseline for masked lanes and the controller's improvement ranking.
    per_task_stay_cost: np.ndarray  # (K, Tp) i32
    n_tasks: int
    # The per-lane mover masks the lanes ran under (None without explicit
    # masks); frozen rows' `assigned` is meaningless.
    active_masks: Optional[np.ndarray] = None  # (K, Tp) bool

    @property
    def true_costs(self) -> np.ndarray:
        """(K,) total undiscounted cost per variant — the migration
        controller's ranking key ("pick a better placement")."""
        return self.per_task_true_cost.astype(np.int64).sum(axis=1)

    def lane_outcomes(self) -> np.ndarray:
        """(K,) total true cost of each lane's *overall* outcome: solved
        rows contribute their placement's true cost, frozen rows their
        stay cost. Comparable across lanes with different mover masks
        (every lane sums over the same task set)."""
        T = self.n_tasks
        true_c = self.per_task_true_cost[:, :T].astype(np.int64)
        stay_c = self.per_task_stay_cost[:, :T].astype(np.int64)
        if self.active_masks is None:
            return true_c.sum(axis=1)
        masks = self.active_masks[:, :T]
        return np.where(masks, true_c, stay_c).sum(axis=1)

    def best_variant(self) -> int:
        """Lowest true-cost variant (ties -> lowest index, deterministic)."""
        return int(np.argmin(self.true_costs))

    def variant_cols(self, k: int) -> np.ndarray:
        return self.assigned[k, : self.n_tasks].astype(np.int64)


def stack_round_states(
    states: Sequence[RoundState],
    *,
    n_pad_tasks: int,
    n_pad_jobs: int,
    exact: bool = False,
) -> RoundWindow:
    """Pad each round to the window's (Tp, Jp) bucket and stack along R.

    Mirrors `policy.device_round_costs`'s padding exactly (task_job/perf
    pads to 0, cur_machine to -1, latency rows to 0) so real rows are
    bit-identical to the per-round path regardless of bucket size.

    Latency rows held as tensors (`DeviceLatencyOracle`) stay on their
    device: they are copied into a device buffer, never through the host.
    They may carry MORE rows than the round has jobs (a pinned oracle pads
    its output to a fixed job bucket); whatever is there is copied, up to
    the window bucket. Rows past the round's real jobs are never indexed by
    a real task (task_job < n_jobs), so they are as inert as zero padding.
    """
    R = len(states)
    if R == 0:
        raise ValueError("empty round window")
    Tp, Jp = n_pad_tasks, n_pad_jobs
    M = states[0].n_machines
    device_latency = isinstance(states[0].root_latency, torch.Tensor)
    out = RoundWindow(
        task_job=np.zeros((R, Tp), np.int32),
        perf_idx=np.zeros((R, Tp), np.int32),
        root_latency=None if device_latency else np.zeros((R, Jp, M), np.float32),
        wait_s=np.zeros((R, Tp), np.float32),
        run_s=np.zeros((R, Tp), np.float32),
        cur_machine=np.full((R, Tp), -1, np.int32),
        active=np.zeros((R, Tp), bool),
        free_slots=np.zeros((R, M), np.int32),
        scale=np.ones((R,), np.int32),
        n_tasks=tuple(s.n_tasks for s in states),
        wait_max=tuple(float(s.wait_s.max(initial=0.0)) for s in states),
    )
    for r, s in enumerate(states):
        T, J = s.n_tasks, s.n_jobs
        if T > Tp or J > Jp or s.root_latency.shape[0] > Jp:
            raise ValueError(
                f"round {r} ({T} tasks, {J} jobs, "
                f"{s.root_latency.shape[0]} latency rows) exceeds the "
                f"window bucket ({Tp}, {Jp})"
            )
        if s.n_machines != M:
            raise ValueError("all rounds in a window must share the cluster")
        out.task_job[r, :T] = s.task_job
        out.perf_idx[r, :T] = s.perf_idx
        if not device_latency:
            out.root_latency[r, : s.root_latency.shape[0]] = s.root_latency
        out.wait_s[r, :T] = s.wait_s
        out.run_s[r, :T] = s.run_s
        out.cur_machine[r, :T] = s.cur_machine
        out.active[r, :T] = True
        out.free_slots[r] = s.free_slots.astype(np.int32)
        out.scale[r] = np.int32(T + 1 if exact else 1)
    if device_latency:
        rl = torch.zeros((R, Jp, M), dtype=torch.float32,
                         device=states[0].root_latency.device)
        for r, s in enumerate(states):
            rl[r, : s.root_latency.shape[0]].copy_(s.root_latency)
        out.root_latency = rl
    return out


class RoundProgram:
    """The window program for one (Tp, Jp, M) bucket on one device.

    Holds the device-resident round-invariant inputs (perf LUT, tie-jitter
    matrix); `advance` consumes and returns a `DeviceRoundState`,
    `what_if` fans one round out over K `PolicyParams` variants.
    """

    def __init__(
        self,
        topo,
        params: PolicyParams,
        lut_table: Optional[torch.Tensor] = None,
        *,
        n_pad_tasks: int,
        n_pad_jobs: int,
        slots_per_machine: Optional[int] = None,
        tie_jitter: int = 9,
        exact: bool = False,
        eps: float = 1.0,
        max_iters: int = 500_000,
        chain_slots: bool = False,
        device="cuda",
    ):
        self.topo = topo
        self.params = params
        self.device = resolve_device(device)
        self.n_pad_tasks = int(n_pad_tasks)
        self.n_pad_jobs = int(n_pad_jobs)
        self.n_machines = int(topo.n_machines)
        self.n_slots = int(slots_per_machine or topo.slots_per_machine)
        self.tie_jitter = int(tie_jitter)
        self.exact = bool(exact)
        self.eps = float(eps)
        self.max_iters = int(max_iters)
        self.chain_slots = bool(chain_slots)
        lut = perf_model.perf_lut_table() if lut_table is None else lut_table
        self.lut = torch.as_tensor(lut, dtype=torch.float32).to(self.device)
        # Device-resident, shape-keyed (and cached across programs of one
        # bucket): every round and every lane reads this one tensor.
        self.jitter = auction._jitter_device(
            self.n_pad_tasks, self.n_machines, self.tie_jitter, str(self.device)
        )

    # ------------------------------------------------------------------ #

    def init_state(self, free_slots: np.ndarray) -> DeviceRoundState:
        """Fresh device state from the host's slot-occupancy view."""
        return DeviceRoundState(
            free_slots=torch.from_numpy(np.asarray(free_slots).astype(np.int32)).to(
                self.device),
            prices=torch.zeros((self.n_machines, self.n_slots), dtype=torch.float32,
                               device=self.device),
            assigned=torch.full((self.n_pad_tasks,), -1, dtype=torch.int32,
                                device=self.device),
        )

    def warmup(self, free_slots: np.ndarray, root_latency=None) -> None:
        """Run the R=1 advance path once on a synthetic round.

        A serving loop wants its *first real decision* to find the kernels
        built and the bucket's tensors cached, so this runs one throwaway
        window — a single task of job 0 rooted on machine 0 with zero
        latency everywhere — through the full program. The warmup carry is
        discarded; under exogenous slot accounting (the serving mode) a
        round's ``free_slots`` comes from its window row, so nothing the
        warmup computed can leak into real results. ``root_latency``
        optionally substitutes the latency rows (e.g. a pinned
        `DeviceLatencyOracle.root_rows` output).
        """
        M = self.n_machines
        state = RoundState(
            task_job=np.zeros(1, np.int64),
            perf_idx=np.zeros(1, np.int64),
            root_machine=np.zeros(1, np.int64),
            root_latency=(
                np.zeros((1, M), np.float32) if root_latency is None else root_latency
            ),
            wait_s=np.zeros(1, np.float32),
            run_s=np.zeros(1, np.float32),
            cur_machine=np.full(1, -1, np.int64),
            free_slots=np.asarray(free_slots, np.int32),
        )
        window = stack_round_states(
            [state], n_pad_tasks=self.n_pad_tasks, n_pad_jobs=self.n_pad_jobs,
            exact=self.exact,
        )
        with obs.span("round_program.warmup", bucket_tasks=self.n_pad_tasks):
            self.advance(self.init_state(state.free_slots), window)

    def _round_body(self, free_slots, inputs, *, params: PolicyParams, scale: int,
                    stay_active=None):
        """One scheduling round on the device.

        Returns ``(price, assigned, iters, per_task_cost, per_task_true,
        per_task_stay)`` with ``iters`` a 0-dim int64 device tensor (nothing
        here waits for the device). The Eq. 7 preemption discount is applied
        *here*, on a copy of the undiscounted `policy.cost_round_step`
        output, so the true (performance-only) cost of every placement is
        available without a second cost build. ``per_task_stay`` is the
        undiscounted cost of every task staying put (running tasks on their
        current machine, pending tasks unscheduled), over ``stay_active``
        rows (default: the round's active rows) — what-if lanes pass the
        *unmasked* active set so frozen movers still report a stay cost.
        """
        task_job, perf_idx, root_lat, wait_s, run_s, cur_machine, active = inputs
        M = self.n_machines
        dev = self.device
        beta = _f32(params.beta_scale, dev)
        w_base, a, _d, _c_rack, _b = policy.cost_round_step(
            self.lut, task_job, perf_idx, root_lat, wait_s, run_s, cur_machine,
            int(params.p_m), int(params.p_r), _f32(params.omega, dev),
            _f32(params.gamma, dev), False,  # discount applied below, on a copy
            beta, per_rack=self.topo.machines_per_rack,
        )
        w_m = policy.apply_preemption_discount(
            w_base.clone(), cur_machine, run_s, bool(params.preemption), beta
        ) if params.preemption else w_base

        job_col = torch.where(active, M + task_job, M).to(torch.int32)
        vm, vu, price0, wj = auction.prepare_values_step(
            w_m, a, self.jitter, active, free_slots, scale, self.n_slots
        )
        price, _owner, assigned, iters = phase_ops.auction_phase(
            price0, vm, vu, job_col, active, self.eps, self.max_iters,
            iters_on_device=True,
        )
        per_task_cost = auction.assignment_cost_step(wj, a, assigned, active)
        per_task_true = auction.assignment_cost_step(w_base, a, assigned, active)
        stay_cols = torch.where(cur_machine >= 0, cur_machine, M + task_job).to(torch.int32)
        per_task_stay = auction.assignment_cost_step(
            w_base, a, stay_cols, active if stay_active is None else stay_active
        )
        return price, assigned, iters, per_task_cost, per_task_true, per_task_stay

    def _debit(self, machines, mask):
        """(M,) int32 count of ``mask`` rows per machine of ``machines``
        (clipped to [0, M); duplicate-safe)."""
        M = self.n_machines
        return torch.zeros((M,), dtype=torch.int32, device=self.device).index_add_(
            0, torch.clamp(machines, 0, M - 1).long(), mask.to(torch.int32)
        )

    def _consumed(self, assigned, active):
        """(M,) slots debited by one round's placements."""
        placed = active & (assigned >= 0) & (assigned < self.n_machines)
        return self._debit(assigned, placed)

    # ------------------------------------------------------------------ #

    def _check_cost_bound(
        self, window: RoundWindow, variants: Optional[Sequence[PolicyParams]] = None
    ) -> None:
        """Host-side float32-exactness guard (no device sync), mirroring
        `auction.solve_transportation_device`'s check — per round, and per
        what-if variant when ``variants`` is given."""
        for params in variants if variants is not None else (self.params,):
            for r in range(window.n_rounds):
                a_max = int(params.omega * window.wait_max[r] + params.gamma) + 1
                bound = max(MAX_MACHINE_COST, a_max)
                scale = int(window.scale[r])
                if (bound + max(self.tie_jitter - 1, 0)) * scale * 4 >= auction._F32_EXACT:
                    raise ValueError(
                        f"scaled costs exceed float32-exact range in round {r}: "
                        f"{bound} * {scale} * 4 >= 2^24"
                    )

    def _window_upload_bytes(self, window: RoundWindow) -> int:
        """Host bytes `_window_arrays` ships to the device for this window.

        Device-resident latency rows (`DeviceLatencyOracle` path) are
        already on the device, so only numpy-held fields count."""
        total = 0
        for field in (
            window.task_job, window.perf_idx, window.root_latency,
            window.wait_s, window.run_s, window.cur_machine,
            window.active, window.free_slots, window.scale,
        ):
            if isinstance(field, np.ndarray):
                total += field.nbytes
        return total

    def _window_arrays(self, window: RoundWindow):
        """The window's per-round inputs on the device (scale stays host)."""

        def up(x):
            return torch.as_tensor(x).to(self.device)

        return (
            up(window.task_job), up(window.perf_idx), up(window.root_latency),
            up(window.wait_s), up(window.run_s), up(window.cur_machine),
            up(window.active), up(window.free_slots),
        )

    def _read(self, iters, *blocks):
        """One device-to-host transfer of every result of a window or a
        what-if: the (n,) iteration counts and (n, Tp) int32 blocks."""
        n = len(iters)
        flat = torch.cat(
            [torch.stack(iters).to(torch.int32)]
            + [torch.stack(b).reshape(-1) for b in blocks]
        ).cpu().numpy()
        out = [flat[:n]]
        for k in range(len(blocks)):
            out.append(flat[n + k * n * self.n_pad_tasks:
                            n + (k + 1) * n * self.n_pad_tasks].reshape(n, self.n_pad_tasks))
        return out

    def _record_window_spans(self, t0_ns: int, window: RoundWindow,
                             iters_np: np.ndarray) -> None:
        """Per-round sub-slices of one window.

        As in the reference, the window is one unit of work: its rounds
        are not clocked one by one (no round waits for the host). The
        window's wall time is split across rounds in proportion to each
        round's auction iteration count and recorded as synthetic
        sub-slices nested inside one ``round_program.advance`` span.
        """
        t1_ns = time.perf_counter_ns()
        R = window.n_rounds
        total_ns = t1_ns - t0_ns
        obs.record_span(
            "round_program.advance",
            t0_ns,
            total_ns,
            {"rounds": R, "bucket_tasks": self.n_pad_tasks,
             "bucket_jobs": self.n_pad_jobs},
        )
        iters = iters_np.astype(np.int64).reshape(-1)[:R]
        obs.add("window.rounds", R)
        obs.add("auction.iterations", int(iters.sum()))
        obs.add("auction.pad_waste_tasks", sum(self.n_pad_tasks - T for T in window.n_tasks))
        weights = np.maximum(iters.astype(np.float64), 1.0)
        edges = t0_ns + np.round(
            np.cumsum(np.concatenate([[0.0], weights])) / weights.sum() * total_ns
        ).astype(np.int64)
        for r in range(R):
            obs.record_span(
                "round_program.round",
                int(edges[r]),
                int(edges[r + 1] - edges[r]),
                {"round": r, "iterations": int(iters[r]), "n_tasks": window.n_tasks[r]},
                depth=1,
            )

    def advance(
        self, state: DeviceRoundState, window: RoundWindow
    ) -> Tuple[DeviceRoundState, WindowResult]:
        """Run the window's rounds through the device-resident state.

        The R rounds are launched back to back with no host read between
        them; the results come back in one transfer. Host-side validation
        (iteration caps, convergence, float32 cost bounds) happens around
        the rounds, never between them.
        """
        self._check_cost_bound(window)
        telemetry = obs.enabled()
        if telemetry:
            obs.add("h2d.upload_bytes", self._window_upload_bytes(window))
            t0_ns = time.perf_counter_ns()
        arrs = self._window_arrays(window)
        slots = arrs[7]
        free = state.free_slots
        price, assigned = state.prices, state.assigned
        iters, assigned_l, cost_l, true_l = [], [], [], []
        for r in range(window.n_rounds):
            inputs = tuple(x[r] for x in arrs[:7])
            free_slots = free + slots[r] if self.chain_slots else slots[r]
            price, assigned, it, cost, true_cost, _stay = self._round_body(
                free_slots, inputs, params=self.params, scale=int(window.scale[r])
            )
            free = free_slots - self._consumed(assigned, inputs[6])
            iters.append(it)
            assigned_l.append(assigned)
            cost_l.append(cost)
            true_l.append(true_cost)
        iters_np, assigned_np, cost_np, true_np = self._read(iters, assigned_l, cost_l, true_l)
        if telemetry:
            self._record_window_spans(t0_ns, window, iters_np)
        if int(iters_np.max(initial=0)) >= self.max_iters:
            raise RuntimeError(
                f"auction hit the iteration cap ({self.max_iters}) inside the window"
            )
        for r, T in enumerate(window.n_tasks):
            if (assigned_np[r, :T] < 0).any():
                raise RuntimeError(
                    f"auction did not converge in round {r}: unassigned tasks remain"
                )
        new_state = DeviceRoundState(free_slots=free, prices=price, assigned=assigned)
        return new_state, WindowResult(
            assigned=assigned_np,
            iterations=iters_np,
            per_task_cost=cost_np,
            per_task_true_cost=true_np,
            n_tasks=window.n_tasks,
        )

    def what_if(
        self,
        state: RoundState,
        variants: Sequence[PolicyParams],
        active_masks: Optional[np.ndarray] = None,
    ) -> WhatIfResult:
        """Evaluate K candidate parameterisations of one round.

        Each variant's placement is bit-identical to running that round
        through the per-round pipeline with the variant's `PolicyParams`
        (one solve per lane, as the reference's vmapped loop freezes
        finished lanes). Rank variants with `WhatIfResult.true_costs` —
        total cost with no preemption discount and no tie jitter.

        ``active_masks`` (K, T) bool — optional per-lane mover masks: rows
        masked False are frozen on their current machine for that lane
        (slot re-debited on the device, stay cost reported). An all-True
        lane is bit-identical to the unmasked path. Rank masked lanes with
        `WhatIfResult.lane_outcomes`.
        """
        if not variants:
            raise ValueError("what_if needs at least one PolicyParams variant")
        window = stack_round_states(
            [state], n_pad_tasks=self.n_pad_tasks, n_pad_jobs=self.n_pad_jobs,
            exact=self.exact,
        )
        self._check_cost_bound(window, variants)
        K = len(variants)
        T = window.n_tasks[0]
        M = self.n_machines
        masks = np.ones((K, self.n_pad_tasks), bool)
        if active_masks is not None:
            active_masks = np.asarray(active_masks, bool)
            if active_masks.shape[0] != K or active_masks.shape[1] > self.n_pad_tasks:
                raise ValueError(
                    f"active_masks shape {active_masks.shape} does not match "
                    f"{K} variants / bucket {self.n_pad_tasks}"
                )
            masks[:, : active_masks.shape[1]] = active_masks
        scale = int(window.scale[0])
        arrs = self._window_arrays(window)
        inputs = tuple(x[0] for x in arrs[:7])
        free_slots = arrs[7][0]
        active, cur_machine = inputs[6], inputs[5]
        masks_dev = torch.from_numpy(masks).to(self.device)
        if obs.enabled():
            obs.add("h2d.upload_bytes", self._window_upload_bytes(window))
            obs.add("whatif.lanes", K)
        with obs.span("round_program.whatif", lanes=K, n_tasks=T):
            iters, assigned_l, cost_l, true_l, stay_l = [], [], [], [], []
            for k, params in enumerate(variants):
                # Frozen movers (active rows masked out of this lane) keep
                # running where they are: re-debit their current machine's
                # slot (the host reclaimed it when nominating them as
                # movers) and solve the round for the remaining rows only.
                lane_active = active & masks_dev[k]
                frozen = active & ~masks_dev[k]
                keeps = frozen & (cur_machine >= 0) & (cur_machine < M)
                free_lane = free_slots - self._debit(cur_machine, keeps)
                _price, assigned, it, cost, true_cost, stay = self._round_body(
                    free_lane, inputs[:6] + (lane_active,), params=params, scale=scale,
                    stay_active=active,
                )
                iters.append(it)
                assigned_l.append(assigned)
                cost_l.append(cost)
                true_l.append(true_cost)
                stay_l.append(stay)
            iters_np, assigned_np, cost_np, true_np, stay_np = self._read(
                iters, assigned_l, cost_l, true_l, stay_l
            )
        if obs.enabled():
            obs.add("auction.iterations", int(iters_np.astype(np.int64).sum()))
        if int(iters_np.max(initial=0)) >= self.max_iters:
            raise RuntimeError(
                f"auction hit the iteration cap ({self.max_iters}) in a what-if lane"
            )
        if ((assigned_np[:, :T] < 0) & masks[:, :T]).any():
            raise RuntimeError(
                "auction did not converge in a what-if lane: unassigned tasks remain"
            )
        return WhatIfResult(
            assigned=assigned_np,
            iterations=iters_np,
            per_task_cost=cost_np,
            per_task_true_cost=true_np,
            per_task_stay_cost=stay_np,
            n_tasks=T,
            active_masks=masks if active_masks is not None else None,
        )
