"""Device-resident latency oracle: per-round incremental plane updates.

Port of `repro.core.latency_device`. The simulator needs (J, M)
root-to-machine RTT rows every scheduling round. Rebuilding them on the host
in numpy (`LatencyPlane.latency_rows`) and shipping J*M floats per round is
the host work the windowed round program exists to avoid. This oracle uses
the plane's hash-derived pair structure to keep the per-round upload tiny
and constant-size:

- *static per root* (uploaded once per (machine, regime-epoch), LRU-cached):
  the decomposition ``(sel, coeff)`` from `LatencyPlane.row_decomposition` —
  int32 flat indices into the per-second series column plus float32 pair
  coefficients;
- *per second* (the only recurring upload): the flattened series column
  ``series[:, :, t]`` (N_TIERS * TRACES_PER_TIER = 24 floats) and the rack
  hotspot multipliers (n_racks floats, all-ones when no hotspot is active).

On the device the row is the same pure-f32 product chain as the host path:
``(series_t[sel] * coeff) * max(mult_a, mult_b)`` with the same-machine
override, as plain torch gathers and products (`_rows`). There is no add,
so nothing can be contracted into an FMA, and host and device round
identically: the tests pin them bit for bit.

Memory: a decomposition is 2 * M * 4 bytes (100 KB at the paper's 12,500
machines), so a full LRU of ``_DECOMP_CACHE_MAX`` = 4,096 entries holds
about 410 MB on the card.

Upload accounting is kept in `stats()` (the reference's keys and values),
so a replay can show that the plane updates stay incremental (per-round
floats ~ 24 + n_racks + J, not J * M).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

from . import auction
from .latency import SAME_MACHINE_RTT_US, TRACES_PER_TIER, LatencyPlane
from .topology import N_TIERS

# Per-(machine, epoch) decompositions are 2*M entries each; 4096 of them
# covers every root of a 4k-machine cluster across a regime shift.
_DECOMP_CACHE_MAX = 4096


def _rows(sel, coeff, roots, series_t, rack_mult, rack_of):
    """(Jp, M) f32 RTT rows from per-root decompositions.

    Same operation order as the host path: gather * coeff, then the hotspot
    multiplier, then the same-machine override.
    """
    lat = series_t[sel.long()] * coeff  # (Jp, M)
    rack_of_l = rack_of.long()
    mult = torch.maximum(
        rack_mult[rack_of_l][None, :], rack_mult[rack_of_l[roots.long()]][:, None]
    )
    lat = lat * mult
    same = torch.arange(rack_of.shape[0], dtype=torch.int32, device=lat.device)[None, :] == (
        roots[:, None]
    )
    return torch.where(same, torch.tensor(SAME_MACHINE_RTT_US, dtype=torch.float32,
                                          device=lat.device), lat)


class DeviceLatencyOracle:
    """Incremental device-side view of a (possibly dynamic) LatencyPlane."""

    def __init__(self, plane: LatencyPlane, *, device="cuda"):
        self.plane = plane
        self.device = resolve_device(device)
        self._rack_of = torch.from_numpy(
            np.asarray(plane.topo.rack_of(np.arange(plane.topo.n_machines)), np.int32)
        ).to(self.device)
        self._ones_mult = torch.ones(plane.topo.n_racks, dtype=torch.float32,
                                     device=self.device)
        # (machine, epoch) -> (sel_dev, coeff_dev), LRU.
        self._decomp: "OrderedDict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]]" = (
            OrderedDict()
        )
        self._second: Optional[Tuple[int, torch.Tensor, torch.Tensor]] = None
        # Upload accounting for the device-residency gate.
        self.round_uploads = 0
        self.uploaded_floats = 0
        self.decomp_builds = 0
        self.decomp_hits = 0  # LRU cache hits (no host->device upload)
        self.decomp_floats = 0
        self.rows_served = 0  # (root, M) rows produced on device
        # Serving mode pins the padded job bucket so `root_rows` keeps one
        # shape across ticks with varying live-job counts (0 = off).
        self._pin_jobs = 0

    # ------------------------------------------------------------------ #

    def _up(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _decomposition(self, machine: int, epoch: int):
        key = (machine, epoch)
        hit = self._decomp.get(key)
        if hit is not None:
            self._decomp.move_to_end(key)
            self.decomp_hits += 1
            return hit
        sel, coeff = self.plane.row_decomposition(machine, epoch)
        dev = (self._up(sel), self._up(coeff))
        self._decomp[key] = dev
        self.decomp_builds += 1
        self.decomp_floats += 2 * sel.shape[0]
        while len(self._decomp) > _DECOMP_CACHE_MAX:
            self._decomp.popitem(last=False)
        return dev

    def _second_arrays(self, t: int):
        """Per-second upload: 24-float series column + rack multipliers."""
        tt = self.plane._time_index(t)
        if self._second is not None and self._second[0] == tt:
            return self._second[1], self._second[2]
        col = np.ascontiguousarray(
            self.plane.series[:, :, tt].reshape(N_TIERS * TRACES_PER_TIER)
        )
        series_t = self._up(col)
        rmult = self.plane.rack_multipliers(t)
        mult_dev = self._ones_mult if rmult is None else self._up(rmult)
        self.round_uploads += 1
        self.uploaded_floats += col.shape[0] + (
            0 if rmult is None else rmult.shape[0]
        )
        self._second = (tt, series_t, mult_dev)
        return series_t, mult_dev

    # ------------------------------------------------------------------ #

    def pin_jobs(self, n_jobs: int) -> None:
        """Pin the padded job bucket of every later ``root_rows`` call.

        With a pin in place, ``root_rows`` pads to (at least) the pinned
        bucket and returns the **unsliced** ``(jp, M)`` block, so a serving
        loop sees one row shape whatever its live-job count. Padding rows
        repeat root 0 and are inert — ``stack_round_states`` accepts rows
        beyond ``n_jobs`` and no task ever indexes them
        (``task_job < n_jobs``).
        """
        self._pin_jobs = auction._bucket(max(int(n_jobs), 1), lo=8)

    def root_rows(self, machines: Sequence[int], t) -> torch.Tensor:
        """(J, M) float32 RTT rows on the oracle's device, bit-identical to
        ``plane.latency_rows(machines, t)``.

        When :meth:`pin_jobs` is active the result is the full padded
        ``(jp, M)`` block instead (rows past ``n_jobs`` are padding)."""
        roots = np.asarray(machines, np.int64).reshape(-1)
        n_jobs = roots.shape[0]
        epoch = self.plane.regime_epoch(t)
        series_t, mult_dev = self._second_arrays(t)
        jp = max(auction._bucket(n_jobs, lo=8), self._pin_jobs)
        padded = np.empty(jp, np.int64)
        padded[:n_jobs] = roots
        padded[n_jobs:] = roots[0] if n_jobs else 0
        decomps = [self._decomposition(int(m), epoch) for m in padded]
        sel = torch.stack([d[0] for d in decomps])
        coeff = torch.stack([d[1] for d in decomps])
        roots_dev = self._up(padded.astype(np.int32))
        self.uploaded_floats += jp  # root index vector
        self.rows_served += n_jobs
        rows = _rows(sel, coeff, roots_dev, series_t, mult_dev, self._rack_of)
        # Stays on the device: `stack_round_states` copies device rows into
        # a device buffer, so the (J, M) block never lands on the host.
        if self._pin_jobs:
            return rows  # fixed (jp, M)
        return rows[:n_jobs]

    def stats(self) -> dict:
        """Upload accounting (floats shipped host->device)."""
        n_machines = self.plane.topo.n_machines
        return {
            "round_uploads": self.round_uploads,
            "uploaded_floats": self.uploaded_floats,
            "decomp_builds": self.decomp_builds,
            "decomp_hits": self.decomp_hits,
            "decomp_floats": self.decomp_floats,
            "rows_served": self.rows_served,
            # What a host rebuild would have shipped: every served row is
            # M floats.
            "naive_floats": self.rows_served * n_machines,
            "floats_per_round": (
                self.uploaded_floats / self.round_uploads if self.round_uploads else 0.0
            ),
        }
