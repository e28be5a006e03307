"""Span tracing over monotonic clocks into a bounded ring buffer (port
of `mpisppy_tpu/telemetry/tracer.py`).

* Recording a span costs one `time.monotonic_ns()` call on enter and
  one slot assignment on exit: no lock, no allocation beyond the
  record tuple.
* The buffer is bounded: a preallocated slot list indexed by an
  `itertools.count()` sequence (one C-level call, so concurrent spoke
  threads never tear or lose an index); old records are overwritten
  once the capacity wraps, and `dropped` counts them.
* Timestamps are CLOCK_MONOTONIC nanoseconds, system-wide on Linux, so
  traces recorded by separate processes merge onto one timeline
  (export.merge_traces).
* Imports neither torch nor jax: a tracer call never waits for the
  device.

Records are tuples (kind first):
    ("X", name, pid, tid, ts_us, dur_us, args)   complete span
    ("i", name, pid, tid, ts_us, args)           instant event
    ("C", name, pid, ts_us, values)              counter sample

`pid` is the Chrome-trace row id: os.getpid() for the main track and a
synthetic id per named track (each in-process spoke renders as its own
process row).
"""

from __future__ import annotations

import itertools
import os
import threading
import time


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_pid", "_args", "_t0")

    def __init__(self, tracer, name, pid, args):
        self._tracer = tracer
        self._name = name
        self._pid = pid
        self._args = args

    def __enter__(self):
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.monotonic_ns()
        self._tracer._append(
            ("X", self._name, self._pid, threading.get_native_id(),
             self._t0 // 1000, (t1 - self._t0) // 1000, self._args))
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


class _TrackScope:
    """Thread-local track push/pop: spans recorded inside a spoke's step
    land on that spoke's row without a track argument at every call
    site."""

    __slots__ = ("_tracer", "_label")

    def __init__(self, tracer, label):
        self._tracer = tracer
        self._label = label

    def __enter__(self):
        tls = self._tracer._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        stack.append(self._label)
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._tls.stack.pop()
        return False


class Tracer:
    """Bounded trace recorder (see the module docstring)."""

    enabled = True

    def __init__(self, capacity=65536, main_label="hub"):
        self.capacity = max(int(capacity), 16)
        self._slots = [None] * self.capacity
        self._seq = itertools.count()
        self._pid = os.getpid()
        self.main_label = main_label
        # track label -> synthetic row pid; insertion-ordered so the
        # merged trace shows spokes in wiring order
        self._tracks = {}
        self._tracks_lock = threading.Lock()
        self._tls = threading.local()

    def set_main_label(self, label):
        self.main_label = label

    # -- track (row) management ------------------------------------------
    def track(self, label):
        """Scope: spans and events recorded inside land on `label`'s
        row.  label=None is the main (hub) row."""
        return _TrackScope(self, label)

    def _track_pid(self, track):
        if track is None:
            stack = getattr(self._tls, "stack", None)
            track = stack[-1] if stack else None
        if track is None:
            return self._pid
        pid = self._tracks.get(track)
        if pid is None:
            with self._tracks_lock:
                pid = self._tracks.setdefault(
                    track, self._pid * 1000 + 1 + len(self._tracks))
        return pid

    # -- recording --------------------------------------------------------
    def _append(self, rec):
        i = next(self._seq)
        self._slots[i % self.capacity] = (i, rec)

    def span(self, name, track=None, args=None):
        return _Span(self, name, self._track_pid(track), args)

    def instant(self, name, track=None, args=None):
        self._append(("i", name, self._track_pid(track),
                      threading.get_native_id(),
                      time.monotonic_ns() // 1000, args))

    def counter(self, name, values, track=None):
        """Chrome counter sample ("C"): values is {series: number}."""
        self._append(("C", name, self._track_pid(track),
                      time.monotonic_ns() // 1000, dict(values)))

    def record_span(self, name, t0_ns, t1_ns, track=None, args=None):
        """Record an interval the caller timed itself (solve_loop's own
        wall accounting)."""
        self._append(("X", name, self._track_pid(track),
                      threading.get_native_id(), t0_ns // 1000,
                      max(t1_ns - t0_ns, 0) // 1000, args))

    # -- drain ------------------------------------------------------------
    def records(self):
        """Snapshot of the retained records in emission order."""
        live = [s for s in self._slots if s is not None]
        live.sort(key=lambda t: t[0])
        return [rec for _, rec in live]

    @property
    def emitted(self):
        live = [s[0] for s in self._slots if s is not None]
        return max(live) + 1 if live else 0

    @property
    def dropped(self):
        """Records overwritten after the ring wrapped."""
        return max(0, self.emitted - self.capacity)


class NullTracer:
    """Disabled-mode stand-in: every operation is a no-op and span()
    returns the shared NULL_SPAN (no allocation on the hot path)."""

    enabled = False
    capacity = 0
    main_label = "off"
    _tracks = {}
    _pid = 0

    def set_main_label(self, label):
        pass

    def track(self, label):
        return NULL_SPAN

    def span(self, name, track=None, args=None):
        return NULL_SPAN

    def instant(self, name, track=None, args=None):
        pass

    def counter(self, name, values, track=None):
        pass

    def record_span(self, name, t0_ns, t1_ns, track=None, args=None):
        pass

    def records(self):
        return []

    emitted = 0
    dropped = 0


NULL_TRACER = NullTracer()
