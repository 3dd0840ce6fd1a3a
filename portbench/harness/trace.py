"""Reading a `torch.profiler` trace from its own events.

The read follows the port's `tools/profile_read.py` and `chip_smoke.py`'s
``_train_profile``: it walks ``prof.profiler.kineto_results.events()``
(the trace's own events; ``key_averages()`` first builds a Python event
tree, tens of seconds for a large trace, and gives the same sums). Device
operations are the CUDA events with a duration (kernels, copies, sets),
less the user annotations that the profiler mirrors onto the device's
timeline. The benchmark's own spans (`torch.profiler.record_function`
ranges named ``portbench.*``) are read from the host's side.

Busy time is the union of the device operations' intervals, so that two
operations that overlap count once.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

SPAN_PREFIX = "portbench."

Interval = Tuple[str, int, int]  # (name, start ns, end ns)


@dataclasses.dataclass
class Trace:
    device_ops: List[Interval]  # sorted by start
    spans: List[Interval]  # the benchmark's spans, sorted by start
    host_ops: List[Interval]  # every other host event

    def ops_named(self, part: str) -> List[Interval]:
        return [op for op in self.device_ops if part in op[0]]

    def spans_named(self, name: str) -> List[Interval]:
        return [s for s in self.spans if s[0] == SPAN_PREFIX + name]

    def busy(self, t0: int, t1: int) -> List[Tuple[int, int]]:
        """The union of device intervals within [t0, t1], merged."""
        merged: List[List[int]] = []
        for _, s, e in self.device_ops:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self, t0: int, t1: int) -> float:
        return sum(e - s for s, e in self.busy(t0, t1)) / 1e9

    def within(self, ops: List[Interval], t0: int, t1: int) -> List[Interval]:
        """Those of ``ops`` that start within [t0, t1]."""
        return [op for op in ops if t0 <= op[1] <= t1]


def read(prof) -> Trace:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, spans, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if dur > 0 and not e.is_user_annotation() and not name.startswith(SPAN_PREFIX):
                dev.append((name, start, start + dur))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, start, start + dur))
        else:
            host.append((name, start, start + dur))
    for lst in (dev, spans, host):
        lst.sort(key=lambda x: x[1])
    return Trace(dev, spans, host)


def top_ops(trace: Trace, t0: int, t1: int, n: int = 10) -> List[List]:
    """The device operations that took most time in [t0, t1]: [name, s]."""
    by = collections.Counter()
    for name, s, e in trace.within(trace.device_ops, t0, t1):
        by[name[:120]] += (e - s) / 1e9
    return [[k, v] for k, v in by.most_common(n)]


def idle_gaps(trace: Trace, t0: int, t1: int, n: int = 10) -> List[List]:
    """The ``n`` longest idle gaps of the device in [t0, t1], each named by
    the benchmark span and the innermost host event at its midpoint:
    [name, s]."""
    busy = trace.busy(t0, t1)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, reverse=True)[:n]
    if not gaps:
        return []

    def arrays(ivs):
        if not ivs:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return (np.fromiter((x[1] for x in ivs), np.int64, len(ivs)),
                np.fromiter((x[2] for x in ivs), np.int64, len(ivs)))

    hs, he = arrays(trace.host_ops)
    ss, se = arrays(trace.spans)
    out = []
    for length, a, b in gaps:
        mid = (a + b) // 2
        label = []
        inside = np.nonzero((ss <= mid) & (se >= mid))[0]
        if inside.size:
            i = inside[np.argmin(se[inside] - ss[inside])]
            label.append(trace.spans[i][0])
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        if inside.size:
            i = inside[np.argmin(he[inside] - hs[inside])]
            label.append(trace.host_ops[i][0])
        out.append([" > ".join(label) or "(no host event)", length / 1e9])
    return out


def assign(ops: List[Interval], spans: List[Interval]) -> Dict[int, List[Interval]]:
    """The ops that start within each span, by the span's index."""
    out: Dict[int, List[Interval]] = {i: [] for i in range(len(spans))}
    starts = np.fromiter((s[1] for s in spans), np.int64, len(spans))
    ends = np.fromiter((s[2] for s in spans), np.int64, len(spans))
    for op in ops:
        i = int(np.searchsorted(starts, op[1], side="right")) - 1
        if i >= 0 and op[1] <= ends[i]:
            out[i].append(op)
    return out


def idle_share_pct(run) -> Optional[float]:
    """The share (%) of the traced window in which no operation ran on the
    device: 1 - the union of device intervals over the window."""
    tr, w = run.trace_data, run.facts.get("window_ns")
    if tr is None or w is None:
        return None
    return 100.0 * (1.0 - tr.busy_s(*w) / ((w[1] - w[0]) / 1e9))


def window(trace: Trace) -> Optional[Tuple[int, int]]:
    """The traced window: the benchmark's ``window`` span."""
    w = trace.spans_named("window")
    return (w[0][1], w[0][2]) if w else None
