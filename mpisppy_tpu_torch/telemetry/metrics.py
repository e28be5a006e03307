"""Metrics registry: counters, gauges, histograms and a bounded event
log, with JSONL snapshots and Prometheus text exposition (port of
`mpisppy_tpu/telemetry/metrics.py`).

Hot-path contract: instrument handles are looked up once (get-or-create
by name) and then `inc` / `set` / `observe` are plain updates.  On a
disabled registry the same lookups return shared null singletons whose
methods are no-ops, so callers hold one handle and never branch.

Counters and histograms are exact under concurrent updates: the
wheel's threads mode bumps them from the hub thread and every spoke
thread, and a bare `+= n` can lose an increment there, so each
instrument updates under its own lock.  A gauge is one assignment.

Like the tracer, this module imports neither torch nor jax, so no
metric call can wait for the device.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import threading
import time

# exponential seconds-scale buckets: 10 us .. 2 min (solve phases span
# ~100 us CPU-test solves to minutes-long certified re-solves)
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 1.0, 5.0, 30.0,
                   120.0)


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = float(v)


class Histogram:
    __slots__ = ("count", "total", "min", "max", "buckets",
                 "bucket_counts", "_lock")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.buckets = tuple(buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._lock = threading.Lock()

    def observe(self, v):
        v = float(v)
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):
            if v <= b:
                i = j
                break
        with self._lock:
            self.count += 1
            self.total += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            self.bucket_counts[i] += 1

    @property
    def mean(self):
        return self.total / self.count if self.count else None

    def summary(self):
        return {"count": self.count, "sum": self.total,
                "min": self.min, "max": self.max, "mean": self.mean}


class _NullCounter:
    __slots__ = ()
    value = 0

    def inc(self, n=1):
        pass


class _NullGauge:
    __slots__ = ()
    value = 0.0

    def set(self, v):
        pass


class _NullHistogram:
    __slots__ = ()
    count = 0
    total = 0.0
    min = None
    max = None
    mean = None

    def observe(self, v):
        pass

    def summary(self):
        return {"count": 0, "sum": 0.0, "min": None, "max": None,
                "mean": None}


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


def _json_safe(obj):
    """Recursively replace non-finite floats (inf bounds, NaN poisons)
    with None so snapshot lines stay strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def _prom_name(name):
    """Prometheus metric names admit [a-zA-Z0-9_:] only."""
    return re.sub(r"[^a-zA-Z0-9_:]", "_", name)


class MetricsRegistry:
    def __init__(self, enabled=True, max_events=4096):
        self.enabled = bool(enabled)
        self._counters = {}
        self._gauges = {}
        self._histograms = {}
        # bounded: a spoke posting NaN at every step (one reject event
        # per read) must not grow host memory without bound
        self._events = collections.deque(maxlen=max_events)

    # -- instruments (get-or-create; setdefault keeps races benign) -------
    def counter(self, name):
        if not self.enabled:
            return NULL_COUNTER
        c = self._counters.get(name)
        return c if c is not None else self._counters.setdefault(
            name, Counter())

    def gauge(self, name):
        if not self.enabled:
            return NULL_GAUGE
        g = self._gauges.get(name)
        return g if g is not None else self._gauges.setdefault(
            name, Gauge())

    def histogram(self, name, buckets=DEFAULT_BUCKETS):
        if not self.enabled:
            return NULL_HISTOGRAM
        h = self._histograms.get(name)
        return h if h is not None else self._histograms.setdefault(
            name, Histogram(buckets))

    # -- event log --------------------------------------------------------
    def event(self, name, **args):
        """Append a timestamped record to the bounded event log."""
        if self.enabled:
            self._events.append(
                dict({"ts": time.time(), "event": name}, **args))

    def events(self, name=None):
        evs = list(self._events)
        if name is not None:
            evs = [e for e in evs if e["event"] == name]
        return evs

    # -- export -----------------------------------------------------------
    def snapshot(self):
        """One JSON-safe snapshot of everything."""
        return _json_safe({
            "ts": time.time(),
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {k: h.summary()
                           for k, h in self._histograms.items()},
            "events": list(self._events),
        })

    def write_jsonl(self, path):
        """Append one snapshot line (a run's successive snapshots
        accumulate; readers take the last line for finals)."""
        line = json.dumps(self.snapshot())
        with open(path, "a") as f:
            f.write(line + "\n")
        return path

    def prometheus_text(self):
        """Text exposition format: counters and gauges directly,
        histograms as cumulative `le` buckets plus _sum and _count."""
        out = []
        for k, c in sorted(self._counters.items()):
            n = _prom_name(k)
            out.append(f"# TYPE {n} counter")
            out.append(f"{n} {c.value}")
        for k, g in sorted(self._gauges.items()):
            n = _prom_name(k)
            out.append(f"# TYPE {n} gauge")
            v = g.value
            out.append(f"{n} {v if math.isfinite(v) else 'NaN'}")
        for k, h in sorted(self._histograms.items()):
            n = _prom_name(k)
            out.append(f"# TYPE {n} histogram")
            cum = 0
            for b, cnt in zip(h.buckets, h.bucket_counts):
                cum += cnt
                out.append(f'{n}_bucket{{le="{b}"}} {cum}')
            cum += h.bucket_counts[-1]
            out.append(f'{n}_bucket{{le="+Inf"}} {cum}')
            out.append(f"{n}_sum {h.total}")
            out.append(f"{n}_count {h.count}")
        return "\n".join(out) + "\n"

    def write_prometheus(self, path):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.prometheus_text())
        os.replace(tmp, path)
        return path
