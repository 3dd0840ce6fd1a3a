"""The program's own spans in a traced run, and the device time each one
launched.

While a `torch.profiler` records, every span of the port's telemetry
(`repro_torch.obs.span`) is a ``record_function`` range named
``repro_torch.<name>``, telemetry on or off, so the traced window holds them
among its host events (`harness.trace.Trace.host_ops`), on the clock of the
CUDA runtime calls and the device operations. A device operation belongs to
a span when the runtime call that enqueued it started inside a range of that
name, on any thread: a train step's backward, say, is launched from
autograd's device thread while the calling thread waits inside the step's
``lm.train.backward``.

`harness.trace.read` keeps each event's name and interval, not the
profiler's correlation ids, so each enqueuing call is paired with its
operation by order, kind by kind: the port runs on the current stream of
one card, whose operations run in the order they were enqueued. The
trace's start times keep that order nearly but not wholly: on an H100, a
copy can carry a start before the kernel enqueued ahead of it, and 30-106
of a window's 71,000-857,000 kernels start before their predecessor.
Pairing kind by kind keeps the copies and sets from shifting the kernels'
pairs; two kernels swapped move device time between spans only at a
range's edge. A trace can open with calls whose operations the profiler
did not record; those are left out (`ProgramTrace.dropped`). `read` gives
nothing where the pairing cannot hold:

- an operation of a kind outnumbers its calls (a launch path that
  `ENQUEUE` does not name, such as ``cudaGraphLaunch``);
- more than `MAX_UNANSWERED` calls are left over;
- an operation starts more than `CLOCK_SLACK_NS` before its call.

Held against the profiler's correlation ids on an H100 (40 s windows),
the pairing gave each span of the training and long-prompt cells the same
device time (two runs each); in the chat cell each span within 0.006% in
three runs and, in a fourth, the dispatch 0.348 s against 0.345 s (0.9%)
and the experts within 0.011%.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

PREFIX = "repro_torch."

#: Runtime and driver calls that enqueue one device operation, by kind.
ENQUEUE = {"kernel": ("cudaLaunch", "cuLaunch"), "memcpy": ("cudaMemcpy", "cuMemcpy"),
           "memset": ("cudaMemset", "cuMemset")}

#: Calls a trace may open with that no recorded operation answers (0-17 on
#: an H100).
MAX_UNANSWERED = 64

#: How far an operation may start before its call on the trace's clock.
#: The profiler maps the device's timestamps onto the host's clock, and the
#: two drift apart: paired by correlation id, an operation started up to
#: 10.8 ms before its call in a 40 s window on an H100.
CLOCK_SLACK_NS = 100_000_000


def op_kind(name: str) -> str:
    """A device operation's kind, by the names the profiler gives copies
    and sets."""
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def call_kind(name: str) -> Optional[str]:
    """The kind of operation a host call enqueues, or None."""
    for kind, prefixes in ENQUEUE.items():
        if name.startswith(prefixes):
            return kind
    return None


def _inside(t: np.ndarray, intervals: List[Tuple[int, int]]) -> np.ndarray:
    """Which of the times ``t`` lie inside one of ``intervals``."""
    if not intervals:
        return np.zeros(t.shape, dtype=bool)
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    starts, ends = np.asarray(merged, dtype=np.int64).T
    i = np.searchsorted(starts, t, side="right") - 1
    return (i >= 0) & (t <= ends[np.maximum(i, 0)])


@dataclasses.dataclass
class ProgramTrace:
    ranges: Dict[str, List[Tuple[int, int]]]  # span name -> (start, end) ns of its ranges
    call_ns: np.ndarray  # start of each paired enqueuing call, host clock
    op_s: np.ndarray  # device seconds of the operation it enqueued
    dropped: Dict[str, int]  # kind -> calls left out at the start

    def count(self, name: str) -> int:
        """How many ranges the span ``name`` has in the trace."""
        return len(self.ranges.get(name, ()))

    def device_s(self, name: str, within: Optional[str] = None) -> float:
        """Device seconds of the operations enqueued inside a range of
        ``name`` (and inside one of ``within``, where given)."""
        hit = _inside(self.call_ns, self.ranges.get(name, []))
        if within is not None:
            hit &= _inside(self.call_ns, self.ranges.get(within, []))
        return float(self.op_s[hit].sum())


def read(trace) -> Optional[ProgramTrace]:
    """The program's spans and the enqueuing calls paired with their
    device operations, from a `harness.trace.Trace`; None where the trace
    has no device operation (no card) or the pairing does not hold."""
    if trace is None or not trace.device_ops:
        return None
    ranges: Dict[str, List[Tuple[int, int]]] = {}
    calls: Dict[str, List[int]] = {k: [] for k in ENQUEUE}  # starts, kind by kind
    for name, s, e in trace.host_ops:
        if name.startswith(PREFIX):
            ranges.setdefault(name[len(PREFIX):], []).append((s, e))
        else:
            kind = call_kind(name)
            if kind is not None:
                calls[kind].append(s)
    ops: Dict[str, List[Tuple[int, float]]] = {k: [] for k in ENQUEUE}
    for name, s, e in trace.device_ops:  # sorted by start: the stream's order
        ops[op_kind(name)].append((s, (e - s) / 1e9))
    extra = {k: len(calls[k]) - len(ops[k]) for k in ENQUEUE}
    if min(extra.values()) < 0 or sum(extra.values()) > MAX_UNANSWERED:
        return None
    call_ns = np.fromiter((s for k in ENQUEUE for s in calls[k][extra[k]:]), np.int64)
    op_start = np.fromiter((s for k in ENQUEUE for s, _ in ops[k]), np.int64)
    if np.any(op_start < call_ns - CLOCK_SLACK_NS):
        return None
    op_s = np.fromiter((d for k in ENQUEUE for _, d in ops[k]), np.float64)
    return ProgramTrace(ranges, call_ns, op_s, {k: n for k, n in extra.items() if n})


def of(run) -> Optional[ProgramTrace]:
    """`read` of the run's trace, once for all its readers."""
    if "program_trace" not in run.facts:
        run.facts["program_trace"] = read(run.trace_data)
    return run.facts["program_trace"]


def ms_per(run, name: str, per: Optional[int] = None) -> Optional[float]:
    """Device milliseconds launched inside the ranges of ``name``, over
    ``per`` (default: over those ranges); None where the trace holds no
    such range (no card, or a program without the span) or `read` gave
    nothing."""
    pt = of(run)
    if pt is None or not pt.count(name):
        return None
    per = pt.count(name) if per is None else per
    return 1e3 * pt.device_s(name) / per if per else None
