"""Chrome/Perfetto trace-event serialization and multi-process merge
(port of `mpisppy_tpu/telemetry/export.py`).

Output is the Chrome trace-event JSON object format
({"traceEvents": [...]}), which https://ui.perfetto.dev and
chrome://tracing open.  Each track (hub, every spoke) renders as its
own process row through "M" process_name metadata.  Every recorder
stamps CLOCK_MONOTONIC, so events of several processes share one time
base.  The event category is the JAX package's, so traces of both
packages open side by side.
"""

from __future__ import annotations

import json
import os

_CAT = "mpisppy_tpu"


def chrome_events(tracer):
    """A tracer's retained records as Chrome trace events, after the
    process_name metadata of each row."""
    events = [{"ph": "M", "name": "process_name", "pid": tracer._pid,
               "tid": 0, "args": {"name": tracer.main_label}}]
    for label, pid in tracer._tracks.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": label}})
    for rec in tracer.records():
        kind = rec[0]
        if kind == "X":
            _, name, pid, tid, ts, dur, args = rec
            e = {"ph": "X", "cat": _CAT, "name": name, "pid": pid,
                 "tid": tid, "ts": ts, "dur": dur}
        elif kind == "i":
            _, name, pid, tid, ts, args = rec
            e = {"ph": "i", "s": "p", "cat": _CAT, "name": name,
                 "pid": pid, "tid": tid, "ts": ts}
        else:  # "C"
            _, name, pid, ts, values = rec
            events.append({"ph": "C", "cat": _CAT, "name": name,
                           "pid": pid, "tid": 0, "ts": ts,
                           "args": values})
            continue
        if args:
            e["args"] = args
        events.append(e)
    return events


def write_trace(path, events):
    """Atomic write of one trace file."""
    payload = {"traceEvents": list(events), "displayTimeUnit": "ms"}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)
    return path


def load_trace_events(path):
    """Events of a trace file; [] for a missing or corrupt file (a
    process killed mid-write must not take the merge down)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return []
    if isinstance(data, dict):
        return data.get("traceEvents", [])
    return data if isinstance(data, list) else []


def merge_traces(out_path, event_lists=(), trace_files=()):
    """Merge in-memory event lists and trace files into one timeline
    file: metadata first, so every row is named before its first
    event, then the rest by timestamp."""
    merged = []
    for evs in event_lists:
        merged.extend(evs)
    for p in trace_files:
        merged.extend(load_trace_events(p))
    meta = [e for e in merged if e.get("ph") == "M"]
    rest = sorted((e for e in merged if e.get("ph") != "M"),
                  key=lambda e: e.get("ts", 0))
    return write_trace(out_path, meta + rest)
