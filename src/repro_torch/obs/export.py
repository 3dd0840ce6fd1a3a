"""Telemetry exporters: Chrome trace-event JSON (Perfetto), audit JSONL.

Port of `repro.obs.export` (pure Python, unchanged: the same registry
gives the same JSON).

`to_chrome_trace` maps the registry onto the Chrome trace-event format
(the JSON flavour Perfetto and chrome://tracing both load):

- every closed span becomes a complete slice (``"ph": "X"``) with
  microsecond ``ts``/``dur`` relative to the registry epoch; slice
  nesting in the viewer is derived purely from ts/dur containment per
  thread track, so the simulator's round spans show up as top-level
  slices with solver/build/apply phases nested inside;
- every gauge track becomes a counter series (``"ph": "C"``) — queue
  depth, free slots, migrated %, ... render as stacked counter tracks;
- process/thread metadata events label the tracks.

`validate_chrome_trace` is the schema gate the acceptance test (and CI)
runs over an exported replay: structural checks per event plus a
per-thread proper-nesting check over the X slices.

`save_audit_jsonl` writes the migration controller's structured audit
events one JSON object per line.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Set

from . import spans as _spans

#: One synthetic pid for the whole process: traces stay byte-comparable
#: across runs (a real os.getpid() would differ every run).
_PID = 1

_VALID_PH = {"X", "C", "M", "i", "I"}
#: Slack (µs) for the nesting check: ns->µs float rounding can shift a
#: child's edge past its parent's by well under a microsecond.
_NEST_EPS_US = 0.01


def _json_safe(v: Any) -> Any:
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    try:  # numpy scalars
        return v.item()
    except AttributeError:
        return str(v)


def to_chrome_trace(tel: Optional[_spans.Telemetry] = None) -> Dict[str, Any]:
    """Registry -> Chrome trace-event JSON document (Perfetto-loadable)."""
    tel = tel if tel is not None else _spans.get()
    with tel._lock:
        span_records = list(tel.spans)
        tracks = {k: list(v) for k, v in tel.tracks.items()}
        counters = dict(tel.counters)
        epoch = tel.epoch_ns
    # Dense thread ids in order of first appearance: stable, readable
    # thread tracks instead of raw 64-bit idents.
    tid_map: Dict[int, int] = {}
    events: List[Dict[str, Any]] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": _PID,
            "tid": 0,
            "args": {"name": "repro scheduler"},
        }
    ]
    for rec in span_records:
        tid = tid_map.setdefault(rec.tid, len(tid_map))
        ev: Dict[str, Any] = {
            "name": rec.name,
            "cat": rec.name.split(".", 1)[0],
            "ph": "X",
            "ts": (rec.t0_ns - epoch) / 1e3,
            "dur": rec.dur_ns / 1e3,
            "pid": _PID,
            "tid": tid,
        }
        if rec.args:
            ev["args"] = _json_safe(rec.args)
        events.append(ev)
    for tid, dense in tid_map.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": _PID,
                "tid": dense,
                "args": {"name": f"sim-{dense}" if dense else "sim-main"},
            }
        )
    for track in sorted(tracks):
        for t_ns, value in tracks[track]:
            events.append(
                {
                    "name": track,
                    "ph": "C",
                    "ts": (t_ns - epoch) / 1e3,
                    "pid": _PID,
                    "tid": 0,
                    "args": {"value": value},
                }
            )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "counters": {k: counters[k] for k in sorted(counters)},
            "dropped_spans": tel.dropped_spans,
            "dropped_samples": tel.dropped_samples,
        },
    }


def save_chrome_trace(path: str, tel: Optional[_spans.Telemetry] = None) -> Dict:
    doc = to_chrome_trace(tel)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return doc


def validate_chrome_trace(doc: Any) -> List[str]:
    """Structural schema check; returns a list of problems (empty = valid)."""
    problems: List[str] = []
    if isinstance(doc, list):  # the bare-array flavour is also legal
        events = doc
    elif isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level 'traceEvents' missing or not a list"]
    else:
        return ["trace document is neither an object nor an event array"]

    slices: Dict[tuple, List[tuple]] = {}
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            problems.append(f"{where}: bad ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing name")
        if not isinstance(ev.get("pid"), int):
            problems.append(f"{where}: missing integer pid")
        if ph in ("X", "C", "i", "I"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"{where}: {ev.get('name')}: bad ts {ts!r}")
                continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: {ev.get('name')}: bad dur {dur!r}")
                continue
            if "tid" not in ev:
                problems.append(f"{where}: X slice without tid")
                continue
            slices.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ev["ts"]), float(dur), ev["name"])
            )
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                isinstance(v, (int, float)) for v in args.values()
            ):
                problems.append(
                    f"{where}: counter {ev.get('name')!r} needs numeric args"
                )

    # Proper nesting per thread track: a slice must either start after the
    # enclosing slice ends, or end within it.
    for key, evs in slices.items():
        evs.sort(key=lambda e: (e[0], -e[1]))
        stack: List[tuple] = []
        for ts, dur, name in evs:
            while stack and ts >= stack[-1][0] - _NEST_EPS_US:
                stack.pop()
            if stack and ts + dur > stack[-1][0] + _NEST_EPS_US:
                problems.append(
                    f"track {key}: slice {name!r} [{ts:.3f}, {ts + dur:.3f}] "
                    f"overlaps enclosing {stack[-1][1]!r} ending {stack[-1][0]:.3f}"
                )
                continue
            stack.append((ts + dur, name))
    return problems


def counter_track_names(doc: Dict[str, Any]) -> Set[str]:
    """Distinct counter-track names in an exported trace document."""
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return {ev["name"] for ev in events if ev.get("ph") == "C"}


def slice_names(doc: Dict[str, Any]) -> Set[str]:
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return {ev["name"] for ev in events if ev.get("ph") == "X"}


def save_audit_jsonl(path: str, tel: Optional[_spans.Telemetry] = None) -> int:
    """Write the audit log one JSON object per line; returns the count."""
    tel = tel if tel is not None else _spans.get()
    with tel._lock:
        records = [dict(r) for r in tel.audit]
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(_json_safe(rec)))
            f.write("\n")
    return len(records)
