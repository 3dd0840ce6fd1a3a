"""Thread-safe telemetry registry: nestable spans, counters, gauge tracks.

The scheduler's measurement plane, ported from `repro.obs.spans`. One
module-level `Telemetry` registry collects:

- **spans** — nested wall-clock slices (``with obs.span("sim.round")``),
  recorded on exit as ``(name, t0_ns, dur_ns, depth, tid, args)``. Nesting
  is per-thread (a ``threading.local`` stack); `record_span` additionally
  lets device-window callers reconstruct per-round sub-slices from scan
  metadata after the fact.
- **counters** — monotonically accumulated floats keyed by dotted name
  (``auction.iterations``, ``h2d.upload_bytes``, ``qos.triggers``, ...).
- **gauge tracks** — timestamped (t_ns, value) samples per track
  (queue depth, free slots, migrated %).
- **audit events** — structured dicts (the migration controller's
  per-round decision record).

Two sinks, two clocks. The registry stamps spans with
``time.perf_counter_ns`` (`SpanRecord.t0_ns`, relative to
`Telemetry.epoch_ns` in the Chrome export). While a `torch.profiler`
records, every `span` is also a ``torch.profiler.record_function`` range
named ``repro_torch.<name>``, opened and closed with it: the profiler
stamps the range on its own clock, the one its CUDA kernels and runtime
calls carry, so a span lies beside the device work it launched. The
profiler sink needs no telemetry, so that a trace taken with telemetry off
(the benchmark's traced runs) still holds the ranges.

Zero-cost-when-disabled contract: every public entry point checks one
module-level boolean first and returns a shared no-op (`_NULL_SPAN`) or
falls through without touching the registry; `span` then checks the
profiler's flag. The flag defaults to the ``REPRO_OBS`` environment
variable (off unless set to something truthy);
tests and benchmarks flip it programmatically via `set_enabled`. Note
that ``multiprocessing`` *spawn* workers (the sweep pool) re-read the
environment variable — a programmatic `set_enabled(True)` in the parent
does not propagate; export ``REPRO_OBS=1`` for multi-process telemetry.

Buffers are bounded (`MAX_SPANS` etc.); overflow increments
``dropped_spans`` / ``dropped_samples`` / ``dropped_audit`` rather than
silently truncating. `repro_torch.obs.export` maps the registry onto
Chrome trace events.

Compiles: this package's only compiles are kernel builds.
`kernels/build.py` adds one to ``jit.backend_compiles`` for each nvcc
build and for each library it loads into the process (never for one
already loaded), so `jit_compiles` reads 0 growth on a warm path.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

from torch.autograd import profiler as _profiler

#: Prefix of a span's range in a `torch.profiler` trace.
PROFILER_PREFIX = "repro_torch."

#: Counter-name prefixes excluded from deterministic snapshots:
#: process-warm-up accounting (kernel builds and loads), not simulation work.
NONDETERMINISTIC_PREFIXES: Tuple[str, ...] = ("jit.",)

# Buffer bounds: ~100 bytes/span puts a 7200-round replay (a handful of
# spans + gauges per round) around 10 MB — far below the trace-scale RSS
# gates. A runaway producer hits the cap and the drop counters, not OOM.
MAX_SPANS = 1_000_000
MAX_TRACK_SAMPLES = 1_000_000
MAX_AUDIT_EVENTS = 100_000


class SpanRecord(NamedTuple):
    name: str
    t0_ns: int  # perf_counter_ns at entry
    dur_ns: int
    depth: int  # nesting depth at entry (0 = top level) on its thread
    tid: int  # thread ident
    args: Optional[Dict[str, Any]]


class _NullSpan:
    """Shared no-op context manager returned while telemetry is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def _profiler_range(name: str):
    """The span's range in the `torch.profiler` trace being recorded."""
    return _profiler.record_function(PROFILER_PREFIX + name)


class _Span:
    """Live span handle; records itself into the registry on exit, and
    opens and closes its profiler range while a profiler records."""

    __slots__ = ("_tel", "name", "args", "_t0_ns", "_range")

    def __init__(self, tel: "Telemetry", name: str, args):
        self._tel = tel
        self.name = name
        self.args = args
        self._range = None

    def __enter__(self) -> "_Span":
        self._tel._stack().append(self)
        if _profiler._is_profiler_enabled:
            self._range = _profiler_range(self.name).__enter__()
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        stack = self._tel._stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:  # mis-nested exit (e.g. generator GC order): recover
            try:
                stack.remove(self)
            except ValueError:
                pass
        self._tel._append_span(
            SpanRecord(
                self.name,
                self._t0_ns,
                t1 - self._t0_ns,
                len(stack),
                threading.get_ident(),
                self.args,
            )
        )
        return False


class Telemetry:
    """One process's telemetry registry (spans/counters/tracks/audit)."""

    def __init__(
        self,
        *,
        max_spans: int = MAX_SPANS,
        max_track_samples: int = MAX_TRACK_SAMPLES,
        max_audit_events: int = MAX_AUDIT_EVENTS,
    ):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.max_spans = max_spans
        self.max_track_samples = max_track_samples
        self.max_audit_events = max_audit_events
        self.reset()

    # -------------------------------------------------------------- #

    def reset(self) -> None:
        """Drop all recorded telemetry and restart the trace epoch."""
        with self._lock:
            self.epoch_ns = time.perf_counter_ns()
            self.spans: List[SpanRecord] = []
            self.counters: Dict[str, float] = {}
            self.tracks: Dict[str, List[Tuple[int, float]]] = {}
            self.audit: List[Dict[str, Any]] = []
            self.dropped_spans = 0
            self.dropped_samples = 0
            self.dropped_audit = 0
            self._n_track_samples = 0

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -------------------------------------------------------------- #

    def span(self, name: str, args: Optional[Dict[str, Any]] = None) -> _Span:
        return _Span(self, name, args)

    def _append_span(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped_spans += 1
                return
            self.spans.append(rec)

    def record_span(
        self,
        name: str,
        t0_ns: int,
        dur_ns: int,
        args: Optional[Dict[str, Any]] = None,
        depth: int = 0,
    ) -> None:
        """Record a span from externally measured timestamps (scan-metadata
        reconstruction of per-round sub-slices inside one device window)."""
        self._append_span(
            SpanRecord(name, int(t0_ns), int(dur_ns), depth,
                       threading.get_ident(), args)
        )

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def gauge(self, track: str, value: float, t_ns: Optional[int] = None) -> None:
        if t_ns is None:
            t_ns = time.perf_counter_ns()
        with self._lock:
            if self._n_track_samples >= self.max_track_samples:
                self.dropped_samples += 1
                return
            self.tracks.setdefault(track, []).append((int(t_ns), float(value)))
            self._n_track_samples += 1

    def audit_event(self, kind: str, **fields: Any) -> None:
        with self._lock:
            if len(self.audit) >= self.max_audit_events:
                self.dropped_audit += 1
                return
            self.audit.append({"kind": kind, **fields})

    # -------------------------------------------------------------- #

    def counters_snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.counters)

    def counters_since(self, before: Dict[str, float]) -> Dict[str, float]:
        """Deterministic counter deltas accumulated since ``before`` (a
        `counters_snapshot`). Warm-up counters
        (`NONDETERMINISTIC_PREFIXES`) are excluded."""
        now = self.counters_snapshot()
        out = {}
        for k, v in now.items():
            d = v - before.get(k, 0.0)
            if d:
                out[k] = d
        return deterministic_counters(out)


def deterministic_counters(counters: Dict[str, float]) -> Dict[str, float]:
    """Drop counters whose value depends on process warm-up state."""
    return {
        k: v
        for k, v in counters.items()
        if not k.startswith(NONDETERMINISTIC_PREFIXES)
    }


# ------------------------------------------------------------------ #
# Module-level state + public API (re-exported by repro_torch.obs).

_enabled = os.environ.get("REPRO_OBS", "0").strip().lower() not in (
    "", "0", "false", "no", "off",
)
_telemetry = Telemetry()


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Flip telemetry collection for this process (tests/benchmarks)."""
    global _enabled
    _enabled = bool(on)


def get() -> Telemetry:
    return _telemetry


def reset() -> None:
    _telemetry.reset()


def span(name: str, **args: Any):
    """A span: in the registry while telemetry is enabled, in the trace
    while a `torch.profiler` records (``repro_torch.<name>``), else the
    shared no-op."""
    if not _enabled:
        return _profiler_range(name) if _profiler._is_profiler_enabled else _NULL_SPAN
    return _telemetry.span(name, args or None)


def record_span(name, t0_ns, dur_ns, args=None, depth=0) -> None:
    if not _enabled:
        return
    _telemetry.record_span(name, t0_ns, dur_ns, args, depth)


def add(name: str, value: float = 1.0) -> None:
    if not _enabled:
        return
    _telemetry.add(name, value)


def gauge(track: str, value: float, t_ns: Optional[int] = None) -> None:
    if not _enabled:
        return
    _telemetry.gauge(track, value, t_ns)


def audit_event(kind: str, **fields: Any) -> None:
    if not _enabled:
        return
    _telemetry.audit_event(kind, **fields)


def counters() -> Dict[str, float]:
    return _telemetry.counters_snapshot()


def counters_since(before: Dict[str, float]) -> Dict[str, float]:
    return _telemetry.counters_since(before)


def jit_compiles() -> float:
    """Current ``jit.backend_compiles`` count: kernel builds and library
    loads (0.0 if telemetry is off or nothing was built or loaded).
    Serving-mode warm-path gates snapshot this after warmup and assert it
    stays flat."""
    return _telemetry.counters_snapshot().get("jit.backend_compiles", 0.0)


@contextlib.contextmanager
def scope(reset_registry: bool = True) -> Iterator[Telemetry]:
    """Temporarily enable telemetry (benchmark `telemetry` sections)."""
    prev = _enabled
    set_enabled(True)
    if reset_registry:
        _telemetry.reset()
    try:
        yield _telemetry
    finally:
        set_enabled(prev)
