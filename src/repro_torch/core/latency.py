"""Network latency measurement plane (paper §5.1, §6).

Stands in for PTPmesh/Pingmesh/NetNORAD: provides, at one-second cadence,
the most recently measured RTT between any machine pair. The paper drives
its simulator from 18 week-long cloud latency traces [41], assigning the
lowest-valued traces to same-rack pairs (GCE), intermediate to same-pod
(Azure) and the largest to inter-pod pairs (EC2), scaled per pair by
U(0.5,1) in-rack and U(0.8,1.2) intra/inter-pod, with a small constant for
same-machine pairs. Those traces are not available offline, so we synthesize
statistically-similar series per tier (lognormal AR(1) body + diurnal
modulation + congestion spikes) and apply the paper's assignment recipe
verbatim (DESIGN.md D3).

Beyond the static synthesis, the plane supports *dynamic events* layered on
the tier series (`LatencyEvents`), modeling the time-varying conditions the
paper's migration controller reacts to (§7, Fig. 2):

- `DriftingHotspot` — a congestion hotspot pinned to a window of racks whose
  position drifts over time; every pair with an endpoint in a hot rack sees
  its RTT multiplied. Multiplicative-only on purpose: the device-resident
  oracle (`latency_device.DeviceLatencyOracle`) reproduces the same float32
  products bit for bit (no fused multiply-add reassociation is possible in
  a pure product chain).
- `RegimeSchedule` — at each shift time a random fraction of pairs re-rolls
  its trace assignment (Fig. 2: restarted VMs land in different latency
  regimes). Deterministic per pair: re-rolls derive from the same splitmix64
  pair hash under a per-shift salt.
- spike storms (`SpikeStormSpec` + `overlay_spike_storms`) — long-tail
  storm overlays (expovariate inter-arrival, Pareto amplitude, expovariate
  duration) baked *additively into the series at synthesis time*, so the
  per-second device update remains the 24-float series column.

All pair RTTs are computed in float32 end to end (`series * coeff * mult`,
each factor f32): the canonical host path (`latency_rows`) and the device
oracle round identically, which is what lets tests pin them bit-identical.

Memory is O(tiers x traces x T), never O(n_machines^2): per-pair trace ids
and scaling coefficients are derived from a splitmix64 hash of the
(unordered) machine pair, so a 12,500-machine cluster needs no pair state.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Optional, Tuple

import numpy as np
from scipy.signal import lfilter  # AR(1) as an IIR filter (vectorised)

from .topology import (
    N_TIERS,
    TIER_INTER_POD,
    TIER_POD,
    TIER_RACK,
    TIER_SAME_MACHINE,
    Topology,
)

TRACES_PER_TIER = 6  # paper: 6 traces per tier (GCE / Azure / EC2)
SAME_MACHINE_RTT_US = 2.0  # paper: "a small constant" for intra-host latency
# `matrix()` materializes O(M^2) floats; beyond this it refuses and points
# callers at the O(pairs) `latency_pairs` / O(M) `latency_from` APIs.
MAX_MATRIX_MACHINES = 4096

# Tier RTT parameters (us) matched to the cloud ranges reported in the
# paper's measurement study [41] and the Azure numbers it cites from [45]:
# rack tens of us, pod ~100-250us, inter-pod up to ~500us.
TIER_BASE_US = {TIER_RACK: 35.0, TIER_POD: 140.0, TIER_INTER_POD: 320.0}
TIER_SIGMA = {TIER_RACK: 0.18, TIER_POD: 0.22, TIER_INTER_POD: 0.28}
# Per-pair scaling coefficient ranges (paper §6).
TIER_COEFF = {
    TIER_RACK: (0.5, 1.0),
    TIER_POD: (0.8, 1.2),
    TIER_INTER_POD: (0.8, 1.2),
}

# Spike overlay shape shared by the static synthesis and the storm overlay.
_SPIKE_SPAN_S = 120
_SPIKE_TAU_S = 30.0


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (vectorised)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _pair_hash(a: np.ndarray, b: np.ndarray, seed: int) -> np.ndarray:
    lo = np.minimum(a, b).astype(np.uint64)
    hi = np.maximum(a, b).astype(np.uint64)
    return _splitmix64(lo * np.uint64(0x100000001B3) + hi + np.uint64(seed))


def synth_tier_series(
    rng: np.ndarray,
    tier: int,
    duration_s: int,
    n_traces: int = TRACES_PER_TIER,
) -> np.ndarray:
    """Synthesize (n_traces, duration_s) RTT series (us) for one tier.

    Lognormal AR(1) body around the tier base, diurnal modulation (the paper's
    motivation: UK-South Sunday-evening vs Monday-day differ), and sparse
    congestion spikes with exponential decay (cf. Fig. 2 variability).
    """
    base = TIER_BASE_US[tier]
    sigma = TIER_SIGMA[tier]
    t = np.arange(duration_s, dtype=np.float64)
    spike_off = np.arange(_SPIKE_SPAN_S)
    spike_decay = np.exp(-spike_off / _SPIKE_TAU_S)
    out = np.empty((n_traces, duration_s), dtype=np.float32)
    for i in range(n_traces):
        # Per-trace level offset: separates "different VM placements"
        # (Fig. 2: restarted VMs see different latency regimes).
        level = rng.uniform(0.75, 1.35)
        rho = 0.995
        innov = rng.normal(0.0, sigma * np.sqrt(1 - rho**2), size=duration_s)
        innov[0] = rng.normal(0.0, sigma)
        s = lfilter([1.0], [1.0, -rho], innov)
        diurnal = 1.0 + 0.12 * np.sin(2 * np.pi * (t / 86400.0) + rng.uniform(0, 2 * np.pi))
        series = base * level * np.exp(s) * diurnal
        # Congestion spikes: ~6 events/hour, amplitude Pareto, decay ~30s.
        # Scatter-add over the (event, offset) grid: np.add.at iterates the
        # flattened index array in row-major order, so overlapping spikes
        # accumulate per element in event order — bit-identical to the
        # per-event loop it replaces, without the Python-level iteration.
        n_events = rng.poisson(duration_s / 600.0)
        if n_events:
            starts = rng.integers(0, duration_s, size=n_events)
            amps = base * rng.pareto(2.5, size=n_events) * 2.0
            idx = starts[:, None] + spike_off[None, :]
            valid = idx < duration_s
            contrib = amps[:, None] * spike_decay[None, :]
            np.add.at(series, idx[valid], contrib[valid])
        out[i] = series.astype(np.float32)
    return out


@dataclasses.dataclass(frozen=True)
class DriftingHotspot:
    """A rack-pinned congestion hotspot whose position drifts over time.

    Active in [start_s, end_s); at second t the hot window covers
    ``width_racks`` racks starting at ``rack0 + drift_racks_per_s * (t -
    start_s)`` (floored, wrapped around the rack ring). Every pair with an
    endpoint in a hot rack sees its RTT multiplied by ``multiplier``.
    """

    start_s: float
    end_s: float
    rack0: int = 0
    drift_racks_per_s: float = 0.0
    width_racks: int = 1
    multiplier: float = 3.0

    def hot_racks(self, t: float, n_racks: int) -> np.ndarray:
        lead = int(np.floor(self.rack0 + self.drift_racks_per_s * (t - self.start_s)))
        return (lead + np.arange(self.width_racks)) % n_racks


@dataclasses.dataclass(frozen=True)
class RegimeSchedule:
    """Trace-assignment re-rolls at fixed shift times (Fig. 2 VM restarts).

    After the k-th shift time, each pair independently (probability
    ``frac``, from the pair hash under a per-shift salt) re-rolls which of
    the tier's traces it follows. Coefficients stay put — the *regime*
    changes, not the pair's identity.
    """

    times: Tuple[float, ...] = ()
    frac: float = 0.5


@dataclasses.dataclass(frozen=True)
class LatencyEvents:
    """Dynamic-event bundle layered on a synthesized plane."""

    hotspots: Tuple[DriftingHotspot, ...] = ()
    regime: Optional[RegimeSchedule] = None


@dataclasses.dataclass(frozen=True)
class SpikeStormSpec:
    """Long-tail spike storms baked into the tier series at synthesis time.

    Storm onsets arrive with expovariate inter-arrival (``storms_per_hour``),
    last an expovariate duration and add a Pareto-amplitude exponentially
    decaying overlay to the first ``traces`` traces of each tier in
    ``tiers`` (pairs hashed onto the remaining traces stay calm — the
    hot/cold contrast migration needs).
    """

    storms_per_hour: float = 6.0
    mean_duration_s: float = 90.0
    amp_scale: float = 1.5
    tiers: Tuple[int, ...] = (TIER_POD, TIER_INTER_POD)
    traces: int = 3
    seed: int = 0


def overlay_spike_storms(series: np.ndarray, spec: SpikeStormSpec) -> np.ndarray:
    """Return a copy of ``series`` with the storm overlay added.

    Additive at synthesis time on purpose: the per-round device update
    stays the plain series column, and the float32 pair computation stays
    a pure product (bit-reproducible on device).
    """
    out = series.copy()
    duration_s = series.shape[-1]
    rng = np.random.default_rng(spec.seed)
    n = min(spec.traces, series.shape[1])
    for tier in spec.tiers:
        base = TIER_BASE_US[tier]
        t = rng.exponential(3600.0 / spec.storms_per_hour)
        while t < duration_s:
            dur = max(5, int(rng.exponential(spec.mean_duration_s)))
            amp = base * spec.amp_scale * (1.0 + rng.pareto(1.8))
            st = int(t)
            end = min(st + dur, duration_s)
            decay = np.exp(-np.arange(end - st) / max(dur / 3.0, 1.0))
            out[tier, :n, st:end] += (amp * decay).astype(np.float32)
            t += rng.exponential(3600.0 / spec.storms_per_hour)
    return out


@dataclasses.dataclass
class LatencyPlane:
    """Most-recent-RTT oracle for machine pairs, one sample per second."""

    topo: Topology
    series: np.ndarray  # (N_TIERS, TRACES_PER_TIER, T) us
    seed: int = 0
    events: LatencyEvents = dataclasses.field(default_factory=LatencyEvents)
    # A replay asking for t >= duration_s is a configuration bug (the plane
    # would silently restart from t=0, corrupting any dynamic-scenario
    # result); opt into wrap-around explicitly if cyclic replay is meant.
    allow_wrap: bool = False

    @classmethod
    def synthesize(
        cls,
        topo: Topology,
        duration_s: int,
        seed: int = 0,
        events: Optional[LatencyEvents] = None,
        storms: Optional[SpikeStormSpec] = None,
        allow_wrap: bool = False,
    ) -> "LatencyPlane":
        rng = np.random.default_rng(seed)
        series = np.zeros((N_TIERS, TRACES_PER_TIER, duration_s), np.float32)
        series[TIER_SAME_MACHINE, :, :] = SAME_MACHINE_RTT_US
        for tier in (TIER_RACK, TIER_POD, TIER_INTER_POD):
            series[tier] = synth_tier_series(rng, tier, duration_s)
        if storms is not None:
            series = overlay_spike_storms(series, storms)
        return cls(
            topo=topo,
            series=series,
            seed=seed,
            events=events or LatencyEvents(),
            allow_wrap=allow_wrap,
        )

    @property
    def duration_s(self) -> int:
        return self.series.shape[-1]

    def _time_index(self, t) -> int:
        tt = int(t)
        if 0 <= tt < self.duration_s:
            return tt
        if self.allow_wrap:
            return tt % self.duration_s
        raise ValueError(
            f"latency plane queried at t={tt} outside its synthesized "
            f"duration [0, {self.duration_s}); a wrap-around here would "
            "silently replay stale measurements — synthesize a longer "
            "plane or pass allow_wrap=True for deliberate cyclic replay"
        )

    # ------------------------------------------------------------------ #
    # Dynamic events

    def regime_epoch(self, t) -> int:
        """Number of regime shifts at or before second ``t``."""
        regime = self.events.regime
        if regime is None or not regime.times:
            return 0
        return bisect.bisect_right(regime.times, float(t))

    def rack_multipliers(self, t) -> Optional[np.ndarray]:
        """(n_racks,) float32 hotspot multiplier at second ``t``.

        None when the plane has no hotspots configured (callers skip the
        multiply entirely); all-ones when hotspots exist but none is
        active at ``t`` (multiplying by 1.0f is a bitwise no-op, so the
        host and device paths stay aligned either way).
        """
        if not self.events.hotspots:
            return None
        n_racks = self.topo.n_racks
        mult = np.ones(n_racks, np.float32)
        for h in self.events.hotspots:
            if not (h.start_s <= t < h.end_s):
                continue
            racks = h.hot_racks(t, n_racks)
            mult[racks] = np.maximum(mult[racks], np.float32(h.multiplier))
        return mult

    # ------------------------------------------------------------------ #
    # Pair identity (hash-derived, O(1) state)

    def _pair_fields(self, a, b, epoch: int = 0):
        """(trace_id, u) for machine pairs; deterministic, symmetric.

        ``epoch`` applies that many regime shifts: at each shift a
        ``regime.frac`` fraction of pairs re-rolls its trace id under a
        per-shift salt (coefficients are untouched).
        """
        a = np.asarray(a)
        b = np.asarray(b)
        h = _pair_hash(a, b, self.seed)
        trace_id = (h >> np.uint64(32)) % np.uint64(TRACES_PER_TIER)
        u = (h & np.uint64(0xFFFFFFFF)).astype(np.float64) / 2**32
        regime = self.events.regime
        if epoch and regime is not None:
            for s in range(1, epoch + 1):
                hs = _pair_hash(a, b, self.seed + 0x9E3779B9 * s)
                reroll = (hs & np.uint64(0xFFFF)).astype(np.float64) / 65536.0
                new_trace = (hs >> np.uint64(32)) % np.uint64(TRACES_PER_TIER)
                trace_id = np.where(reroll < regime.frac, new_trace, trace_id)
        return trace_id.astype(np.int64), u

    def _coeff(self, tiers: np.ndarray, u: np.ndarray) -> np.ndarray:
        """Per-pair scaling coefficient, rounded once to float32 so the
        subsequent products are pure f32 chains (device-reproducible)."""
        lo = np.ones_like(u)
        hi = np.ones_like(u)
        for tier, (c_lo, c_hi) in TIER_COEFF.items():
            m = tiers == tier
            lo[m] = c_lo
            hi[m] = c_hi
        return (lo + u * (hi - lo)).astype(np.float32)

    def row_decomposition(self, machine: int, epoch: int = 0):
        """Static per-root decomposition for the device oracle.

        Returns ``(sel, coeff)`` with ``sel`` (M,) int32 flat indices into
        the flattened per-second series column ``series[:, :, t].ravel()``
        and ``coeff`` (M,) float32, such that
        ``series[:, :, t].ravel()[sel] * coeff`` reproduces
        `latency_rows([machine], t)` (before the hotspot multiplier and
        same-machine override). Valid until the regime epoch changes.
        """
        topo = self.topo
        others = np.arange(topo.n_machines)
        tiers = topo.tier_from(machine)
        trace_id, u = self._pair_fields(
            np.full_like(others, machine), others, epoch
        )
        coeff = self._coeff(tiers, u)
        sel = (tiers * TRACES_PER_TIER + trace_id).astype(np.int32)
        return sel, coeff

    # ------------------------------------------------------------------ #
    # RTT lookups (all float32; `latency_rows` is the canonical form)

    def latency_rows(self, machines, t) -> np.ndarray:
        """RTT (us) from each of ``machines`` to every machine at second
        ``t``, shape (len(machines), M) float32.

        THE canonical pair computation — `latency_from` / `latency_pairs` /
        `latency_pair` and the device oracle all reduce to the same f32
        ``series * coeff [* hotspot]`` product chain this evaluates.
        """
        tt = self._time_index(t)
        epoch = self.regime_epoch(t)
        topo = self.topo
        roots = np.asarray(machines, np.int64).reshape(-1)
        others = np.arange(topo.n_machines, dtype=np.int64)
        A = np.broadcast_to(roots[:, None], (len(roots), topo.n_machines))
        B = np.broadcast_to(others[None, :], A.shape)
        rack_a, rack_b = topo.rack_of(A), topo.rack_of(B)
        same = A == B
        tiers = np.full(A.shape, TIER_INTER_POD, np.int64)
        tiers[topo.pod_of(A) == topo.pod_of(B)] = TIER_POD
        tiers[rack_a == rack_b] = TIER_RACK
        tiers[same] = TIER_SAME_MACHINE
        trace_id, u = self._pair_fields(A, B, epoch)
        coeff = self._coeff(tiers, u)
        lat = self.series[tiers, trace_id, tt] * coeff
        rmult = self.rack_multipliers(t)
        if rmult is not None:
            lat = lat * np.maximum(rmult[rack_a], rmult[rack_b])
        lat[same] = SAME_MACHINE_RTT_US
        return lat

    def latency_from(self, machine: int, t: int) -> np.ndarray:
        """RTT (us) from `machine` to every machine at second `t`."""
        return self.latency_rows([machine], t)[0]

    def latency_pairs(self, a: np.ndarray, b: np.ndarray, t: int) -> np.ndarray:
        """RTT (us) for machine pairs (a[i], b[i]) at second `t` (vectorised)."""
        tt = self._time_index(t)
        epoch = self.regime_epoch(t)
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        topo = self.topo
        same = a == b
        rack_a, rack_b = topo.rack_of(a), topo.rack_of(b)
        tiers = np.full(a.shape, TIER_INTER_POD, np.int64)
        tiers[topo.pod_of(a) == topo.pod_of(b)] = TIER_POD
        tiers[rack_a == rack_b] = TIER_RACK
        tiers[same] = TIER_SAME_MACHINE
        trace_id, u = self._pair_fields(a, b, epoch)
        coeff = self._coeff(tiers, u)
        lat = self.series[tiers, trace_id, tt] * coeff
        rmult = self.rack_multipliers(t)
        if rmult is not None:
            lat = lat * np.maximum(rmult[rack_a], rmult[rack_b])
        lat[same] = SAME_MACHINE_RTT_US
        return lat

    def latency_pair(self, a: int, b: int, t: int) -> float:
        if a == b:
            return SAME_MACHINE_RTT_US
        # O(1): singleton pair through the same vectorised computation
        # (the old path materialized a full O(M) tier row per lookup).
        return float(self.latency_pairs(np.asarray([a]), np.asarray([b]), t)[0])

    def matrix(self, t: int, max_machines: int = MAX_MATRIX_MACHINES) -> np.ndarray:
        """Full RTT matrix at second `t` (small clusters / tests only).

        O(M^2) memory and time — a 12,500-machine matrix is 1.25GB of
        float64 per call, which silently sinks trace-scale replays.
        Guarded: raise ``max_machines`` explicitly if a dense matrix is
        truly intended; otherwise use `latency_pairs` (vectorised pair
        lookups) or `latency_from` (one row).
        """
        n = self.topo.n_machines
        if n > max_machines:
            raise ValueError(
                f"LatencyPlane.matrix is O(M^2) and n_machines={n} exceeds "
                f"max_machines={max_machines}; use latency_pairs(a, b, t) "
                "for pair lookups or latency_from(m, t) for one row "
                "(pass max_machines explicitly to override)"
            )
        return self.latency_rows(np.arange(n), t)

    def default_latency(self, tiers: np.ndarray) -> np.ndarray:
        """Topology-derived fallback when measurements are unavailable."""
        out = np.full(np.shape(tiers), SAME_MACHINE_RTT_US, np.float32)
        for tier, base in TIER_BASE_US.items():
            out = np.where(np.asarray(tiers) == tier, base, out)
        return out
