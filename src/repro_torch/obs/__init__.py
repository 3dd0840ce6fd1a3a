"""`repro_torch.obs` — zero-cost-when-disabled scheduler telemetry.

Port of `repro.obs` without the jax compile listener (``jit_compiles``)
and, for now, without the Chrome-trace exporter. Public surface (all
no-ops while disabled; enable with ``REPRO_OBS=1`` or `set_enabled(True)`):

    from repro_torch import obs

    with obs.span("sim.round", t=t):          # nested wall-clock slices
        ...
    obs.add("auction.iterations", iters)      # accumulating counters
    obs.gauge("sim.queue_depth", depth)       # timestamped gauge tracks
"""

from .spans import (  # noqa: F401
    MAX_AUDIT_EVENTS,
    MAX_SPANS,
    MAX_TRACK_SAMPLES,
    NONDETERMINISTIC_PREFIXES,
    SpanRecord,
    Telemetry,
    add,
    audit_event,
    counters,
    counters_since,
    deterministic_counters,
    enabled,
    gauge,
    get,
    record_span,
    reset,
    scope,
    set_enabled,
    span,
)

__all__ = [
    "Telemetry",
    "SpanRecord",
    "enabled",
    "set_enabled",
    "get",
    "reset",
    "span",
    "record_span",
    "add",
    "gauge",
    "audit_event",
    "counters",
    "counters_since",
    "deterministic_counters",
    "scope",
    "NONDETERMINISTIC_PREFIXES",
    "MAX_SPANS",
    "MAX_TRACK_SAMPLES",
    "MAX_AUDIT_EVENTS",
]
