"""`repro_torch.obs` — zero-cost-when-disabled scheduler telemetry.

Port of `repro.obs`. Public surface (all no-ops while disabled; enable
with ``REPRO_OBS=1`` or `set_enabled(True)`):

    from repro_torch import obs

    with obs.span("sim.round", t=t):          # nested wall-clock slices
        ...
    obs.add("auction.iterations", iters)      # accumulating counters
    obs.gauge("sim.queue_depth", depth)       # timestamped gauge tracks
    obs.audit_event("controller_round", ...)  # structured audit records

    obs.export.save_chrome_trace("trace.json")        # open in Perfetto
    obs.export.save_audit_jsonl("audit.jsonl")

``jit_compiles()`` counts kernel builds and library loads (`kernels.build`).
While a `torch.profiler` records, each span is also a range named
``repro_torch.<name>`` in its trace, telemetry on or off (`spans`).
"""

from . import export  # noqa: F401

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
    jit_compiles,
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
    "jit_compiles",
    "scope",
    "export",
    "NONDETERMINISTIC_PREFIXES",
    "MAX_SPANS",
    "MAX_TRACK_SAMPLES",
    "MAX_AUDIT_EVENTS",
]
