"""Scenario presets for multi-configuration simulator runs.

Port of `repro.core.scenarios`. A `Scenario` bundles the
workload-independent perturbations a run or sweep cell replays under:
machine-failure bursts (the paper's cluster events), latency hotspots
(Fig. 2's VM-placement latency regimes, exaggerated into a congestion
event), preemption/migration settings, straggler-detection thresholds
(§7), and the time-varying latency events the migration controller reacts
to (drifting rack hotspots, regime shifts, spike storms). Scenarios are
declarative and deterministic: every random choice (which machines fail,
which traces run hot) derives from the scenario seed, so a (policy x seed
x scenario) cell is reproducible bit for bit, and the same name builds the
same plane and config here and in the reference.

Not ported yet: the reference's ``google_trace`` preset (a chunked
trace-cursor replay with streaming metrics, ROADMAP module item M7) and
its serving presets (``SERVING_PRESETS``, module item M9); asking for
either raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from .latency import (
    DriftingHotspot,
    LatencyEvents,
    LatencyPlane,
    RegimeSchedule,
    SpikeStormSpec,
    overlay_spike_storms,
)
from .policy import PolicyParams
from .topology import TIER_INTER_POD, TIER_POD, Topology


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named perturbation bundle for a sweep cell."""

    name: str
    description: str
    # synth_workload overrides (e.g. target_utilisation).
    workload_kwargs: Mapping = dataclasses.field(default_factory=dict)
    # SimConfig field overrides (e.g. migration_interval_s).
    config_kwargs: Mapping = dataclasses.field(default_factory=dict)
    # PolicyParams field overrides (e.g. preemption).
    params_kwargs: Mapping = dataclasses.field(default_factory=dict)
    # Machine-failure bursts: at each time fraction, remove failure_frac
    # of the machines (sampled without replacement from the still-alive set).
    failure_burst_at: Tuple[float, ...] = ()
    failure_frac: float = 0.0
    # Latency hotspot: scale `hotspot_traces` of the per-tier trace pool in
    # `hotspot_tiers` by `hotspot_scale` inside the [lo, hi) duration
    #-fraction window. Pairs hashed onto the scaled traces run hot; the
    # rest keep the baseline series (hot/cold contrast is the point).
    hotspot_tiers: Tuple[int, ...] = ()
    hotspot_scale: float = 1.0
    hotspot_traces: int = 3
    hotspot_window: Tuple[float, float] = (0.0, 1.0)
    # Straggler mitigation threshold (requires preemption to act).
    straggler_threshold: Optional[float] = None
    # -------- dynamic latency events (time-varying plane, §7) -------- #
    # Drifting rack hotspots: each mapping is DriftingHotspot kwargs in
    # duration fractions — `window` (start, end fractions), `rack0_frac`
    # (starting rack as a fraction of the rack count), and
    # `drift_racks_per_run` (fraction of the rack ring traversed over the
    # full replay), plus the literal `width_racks` / `multiplier` fields.
    dynamic_hotspots: Tuple[Mapping, ...] = ()
    # Regime shifts: at each duration fraction, `regime_frac` of pairs
    # re-roll their trace assignment (Fig. 2 VM-restart regimes).
    regime_shift_at: Tuple[float, ...] = ()
    regime_frac: float = 0.5
    # Long-tail spike storms baked into the tier series (SpikeStormSpec
    # kwargs; seeded from the plane seed x scenario name).
    spike_storms: Optional[Mapping] = None

    # ------------------------------------------------------------------ #

    def failures(
        self, topo: Topology, duration_s: int, seed: int
    ) -> Tuple[Tuple[int, int], ...]:
        """Deterministic ((t, machine), ...) failure events for SimConfig."""
        if not self.failure_burst_at or self.failure_frac <= 0.0:
            return ()
        # zlib.crc32 is stable across processes (str hash is salted).
        rng = np.random.default_rng((seed, zlib.crc32(self.name.encode())))
        per_burst = max(1, int(round(self.failure_frac * topo.n_machines)))
        alive = np.arange(topo.n_machines)
        events = []
        for frac in self.failure_burst_at:
            t = int(frac * duration_s)
            victims = rng.choice(alive, size=min(per_burst, len(alive)), replace=False)
            alive = np.setdiff1d(alive, victims)
            events.extend((t, int(m)) for m in victims)
        return tuple(events)

    @property
    def is_dynamic(self) -> bool:
        """True when the scenario layers time-varying latency events."""
        return bool(
            self.dynamic_hotspots or self.regime_shift_at or self.spike_storms
        )

    def plane(self, base: LatencyPlane, duration_s: int) -> LatencyPlane:
        """The scenario's latency plane: `base` itself when unperturbed
        (planes are shared across sweep cells), else a copy with the
        static hotspot traces scaled and/or dynamic events attached."""
        static = bool(self.hotspot_tiers) and self.hotspot_scale != 1.0
        if not static and not self.is_dynamic:
            return base
        series = base.series
        if static:
            series = series.copy()
            lo = int(self.hotspot_window[0] * duration_s)
            hi = int(self.hotspot_window[1] * duration_s)
            n = min(self.hotspot_traces, series.shape[1])
            for tier in self.hotspot_tiers:
                series[tier, :n, lo:hi] *= self.hotspot_scale
        if self.spike_storms is not None:
            spec = SpikeStormSpec(
                seed=base.seed ^ zlib.crc32(self.name.encode()),
                **self.spike_storms,
            )
            series = overlay_spike_storms(series, spec)
        n_racks = base.topo.n_racks
        hotspots = []
        for kw in self.dynamic_hotspots:
            kw = dict(kw)
            w_lo, w_hi = kw.pop("window")
            rack0 = int(kw.pop("rack0_frac", 0.0) * n_racks)
            drift = kw.pop("drift_racks_per_run", 0.0) * n_racks
            start_s, end_s = w_lo * duration_s, w_hi * duration_s
            hotspots.append(
                DriftingHotspot(
                    start_s=start_s,
                    end_s=end_s,
                    rack0=rack0,
                    drift_racks_per_s=drift / max(duration_s, 1),
                    **kw,
                )
            )
        regime = None
        if self.regime_shift_at:
            regime = RegimeSchedule(
                times=tuple(f * duration_s for f in self.regime_shift_at),
                frac=self.regime_frac,
            )
        return LatencyPlane(
            topo=base.topo,
            series=series,
            seed=base.seed,
            events=LatencyEvents(hotspots=tuple(hotspots), regime=regime),
            allow_wrap=base.allow_wrap,
        )

    def sim_config_kwargs(self, topo: Topology, duration_s: int, seed: int) -> Dict:
        """SimConfig kwargs (minus policy/seed) for this scenario."""
        out = dict(self.config_kwargs)
        out["failures"] = self.failures(topo, duration_s, seed)
        if self.straggler_threshold is not None:
            out["straggler_threshold"] = self.straggler_threshold
        return out

    def policy_params(self, **base) -> PolicyParams:
        """PolicyParams with the scenario's overrides applied over `base`."""
        return PolicyParams(**{**base, **self.params_kwargs})


SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            name="baseline",
            description="Google-shaped synthetic trace, no perturbations",
        ),
        Scenario(
            name="preemption",
            description="periodic migration rounds (paper Fig. 7/9, beta=0)",
            params_kwargs={"preemption": True, "beta_scale": 0.0},
            config_kwargs={"migration_interval_s": 30},
        ),
        Scenario(
            name="failure_bursts",
            description="2% of machines fail at t=1/3 and t=2/3 (cluster events)",
            failure_burst_at=(1.0 / 3.0, 2.0 / 3.0),
            failure_frac=0.02,
        ),
        Scenario(
            name="straggler_heavy",
            description="hot traces all run + straggler-triggered migration (§7)",
            params_kwargs={"preemption": True, "beta_scale": 0.0},
            config_kwargs={"migration_interval_s": 10_000_000},  # stragglers only
            straggler_threshold=0.9,
            hotspot_tiers=(TIER_POD, TIER_INTER_POD),
            hotspot_scale=3.0,
        ),
        Scenario(
            name="hotspot_latency",
            description="4x latency on half the pod/inter-pod traces mid-run",
            hotspot_tiers=(TIER_POD, TIER_INTER_POD),
            hotspot_scale=4.0,
            hotspot_window=(0.3, 0.8),
        ),
        Scenario(
            name="drifting_hotspot",
            description=(
                "rack-pinned congestion hotspot drifting across the full "
                "rack ring mid-run (PTPmesh-style moving congestion)"
            ),
            dynamic_hotspots=(
                {
                    "window": (0.1, 0.9),
                    "rack0_frac": 0.0,
                    "drift_racks_per_run": 1.0,  # full ring traversal
                    "width_racks": 2,
                    "multiplier": 4.0,
                },
            ),
            params_kwargs={"preemption": True, "beta_scale": 0.0},
            config_kwargs={"migration_interval_s": 15},
        ),
        Scenario(
            name="regime_shifts",
            description=(
                "half of all pairs re-roll their latency trace at t=1/3 "
                "and t=2/3 (Fig. 2 VM-restart regimes)"
            ),
            regime_shift_at=(1.0 / 3.0, 2.0 / 3.0),
            regime_frac=0.5,
            params_kwargs={"preemption": True, "beta_scale": 0.0},
            config_kwargs={"migration_interval_s": 15},
        ),
        Scenario(
            name="spike_storms",
            description=(
                "long-tail expovariate spike storms on half the pod/"
                "inter-pod traces (heavy-tailed congestion events)"
            ),
            spike_storms={
                "storms_per_hour": 30.0,
                "mean_duration_s": 60.0,
                "amp_scale": 2.0,
            },
            params_kwargs={"preemption": True, "beta_scale": 0.0},
            config_kwargs={"migration_interval_s": 15},
        ),
    )
}


#: Reference presets this package does not have yet, with the ROADMAP.md
#: module-queue item that ports each.
NOT_PORTED = {
    "google_trace": "ROADMAP.md module queue item M7 (trace replay, streaming metrics)",
}


def get_scenario(name: str) -> Scenario:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"scenario {name!r} is not ported to repro_torch yet: {NOT_PORTED[name]}"
        )
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: {sorted(SCENARIOS)}"
        ) from None


def get_serving_preset(name: str):
    """The reference's serving presets arrive with `core.serving`."""
    raise NotImplementedError(
        "serving presets are not ported to repro_torch yet: ROADMAP.md module "
        "queue item M9 (serving and sweeps)"
    )


def __getattr__(name: str):
    if name == "SERVING_PRESETS":
        get_serving_preset(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
