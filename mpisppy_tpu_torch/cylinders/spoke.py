"""Spoke base classes (port of `mpisppy_tpu/cylinders/spoke.py`).

Every spoke exposes one unit of work as `step()`: read fresh hub data,
do a batched solve pass, post results.  The threads mode loops
`main()` = `while not killed: step()`; the interleaved mode calls
`step()` from the hub between hub iterations.  The converger spoke
types drive the hub's window wiring.

Windows carry host float64 vectors; a spoke turns them back into
tensors of its batch's dtype on its device where it solves.  With
telemetry on, each step is a `<class>.step` span on the spoke's own
trace row (`timed_step`), and each bound a spoke posts sets its
wheel.slice_bound.<track> gauge.

Fault injection (`resilience/chaos.py`, inert unless the spoke options
carry "chaos" or MPISPPY_TPU_CHAOS is set): each hub read ticks the
spoke's step clock (crash, hard exit, hang), and each post may be
NaN-poisoned, delayed, dropped or corrupted.  `algo_state` /
`restore_algo_state` carry a spoke's algorithm state across a restart.
"""

from __future__ import annotations

import enum
import os
import time

import numpy as np
import torch

from ..device import host
from ..resilience.chaos import ChaosInjector
from .spcommunicator import SPCommunicator, Window


class ConvergerSpokeType(enum.Enum):
    OUTER_BOUND = 1
    INNER_BOUND = 2
    W_GETTER = 3
    NONANT_GETTER = 4


class Spoke(SPCommunicator):
    converger_spoke_types = ()
    converger_spoke_char = "?"

    def __init__(self, spbase_object, options=None):
        super().__init__(spbase_object, options=options)
        self.pair = None           # WindowPair, set by the hub
        self.last_hub_id = 0
        self._killed = False
        self.chaos = ChaosInjector.from_options(self.options.get("chaos"))
        # bound spokes re-post their bound at this cadence so that the
        # to_hub write_id keeps advancing (a liveness signal)
        self.heartbeat_interval = float(
            self.options.get("heartbeat_interval", 1.0))
        self._last_heartbeat = 0.0

    # -- hub traffic ------------------------------------------------------
    def spoke_to_hub(self, values):
        """Post this spoke's vector (through the chaos write hooks)."""
        values = self.chaos.poison(values)
        self.chaos.pre_write()
        fate = self.chaos.write_fate()
        if fate == "drop":
            return
        if fate == "corrupt":
            corrupt = getattr(self.pair.to_hub, "corrupt_next_write", None)
            if corrupt is not None:
                corrupt()
        self.pair.to_hub.write(values)
        self._c_writes.inc()

    def spoke_from_hub(self):
        """(data, is_new): the latest hub vector; is_new iff the
        write_id advanced since the last read and the snapshot passed
        payload validation.  Each call is one tick of the chaos step
        clock."""
        self.chaos.step_tick()
        win = self.pair.to_spoke
        rc = getattr(win, "read_checked", None)
        if rc is None:
            data, wid = win.read()
            ok = True
        else:
            data, wid, ok, _reason = rc()
        self._c_reads.inc()
        if wid == Window.KILL:
            self._killed = True
            return data, False
        if not ok:                     # a corrupt snapshot counts as stale
            self._c_stale.inc()
            return data, False
        is_new = wid > self.last_hub_id
        if not is_new:
            self._c_stale.inc()
        self.last_hub_id = max(self.last_hub_id, wid)
        return data, is_new

    def got_kill_signal(self):
        if not self._killed:
            self._killed = self.pair.to_spoke.write_id == Window.KILL
        return self._killed

    def get_serial_number(self):
        wid = self.pair.to_spoke.write_id
        return 0 if wid == Window.KILL else wid

    # -- work unit --------------------------------------------------------
    def step(self):
        """One unit of spoke work; truthy iff fresh data was consumed
        (the threads loop backs off after a no-op step)."""
        raise NotImplementedError

    def timed_step(self):
        """step() under a span on this spoke's own trace track, so each
        spoke renders as its own row of the merged timeline.  Just
        step() when telemetry is off."""
        tel = self.telemetry
        if not tel.enabled:
            return self.step()
        tr = tel.tracer
        with tr.track(self.telemetry_track):
            with tr.span(f"{type(self).__name__}.step"):
                return self.step()

    def _heartbeat(self):
        """Keep the to_hub write_id advancing; bound spokes re-post."""

    # -- ensemble state ---------------------------------------------------
    def algo_state(self):
        """npz-safe dict of this spoke's algorithm state: host arrays,
        scalars or None."""
        state = {"last_hub_id": self.last_hub_id}
        opt = self.opt
        if getattr(opt, "_x_warm", None) is not None:
            state["x_warm"] = host(opt._x_warm)
        if getattr(opt, "_y_warm", None) is not None:
            state["y_warm"] = host(opt._y_warm)
        for k, (xw, yw) in (getattr(opt, "_named_warm", None) or {}).items():
            state[f"named_warm.{k}.x"] = host(xw)
            state[f"named_warm.{k}.y"] = host(yw)
        return state

    def restore_algo_state(self, state):
        """Inverse of algo_state: arrays become tensors of the batch's
        dtype on the optimizer's device; missing keys keep their
        defaults."""
        if "last_hub_id" in state:
            self.last_hub_id = int(state["last_hub_id"])
        opt = self.opt

        def dev(a):
            return torch.as_tensor(np.asarray(a), device=opt.device).to(
                opt.batch.c.dtype)
        if "x_warm" in state and hasattr(opt, "_x_warm"):
            opt._x_warm = dev(state["x_warm"])
        if "y_warm" in state and hasattr(opt, "_y_warm"):
            opt._y_warm = dev(state["y_warm"])
        named = {}
        for k in state:
            if k.startswith("named_warm.") and k.endswith(".x"):
                name = k[len("named_warm."):-len(".x")]
                yk = f"named_warm.{name}.y"
                if yk in state:
                    named[name] = (dev(state[k]), dev(state[yk]))
        if named and hasattr(opt, "_named_warm"):
            opt._named_warm.update(named)

    def main(self):
        """The threads-mode loop."""
        while not self.got_kill_signal():
            did = False
            if self.get_serial_number() != 0:
                did = self.timed_step()
            now = time.time()
            if now - self._last_heartbeat >= self.heartbeat_interval:
                self._last_heartbeat = now
                self._heartbeat()
            if not did:
                time.sleep(1e-3)       # nothing fresh: do not busy-spin


class _BoundSpoke(Spoke):
    """A spoke that sends a scalar bound; options["trace_prefix"]
    writes its bound trace as a CSV."""

    def __init__(self, spbase_object, options=None):
        super().__init__(spbase_object, options=options)
        self.bound = (np.inf if self._is_inner_like()
                      else -np.inf) * (1 if self.opt.is_minimizing else -1)
        self._got_bound = False
        self._trace_path = None
        prefix = self.options.get("trace_prefix")
        if prefix is not None:
            self._trace_path = f"{prefix}_{type(self).__name__}.csv"
            os.makedirs(os.path.dirname(self._trace_path) or ".",
                        exist_ok=True)
            with open(self._trace_path, "w") as f:
                f.write("time,bound\n")
            self._t0 = time.time()

    def _is_inner_like(self):
        return ConvergerSpokeType.INNER_BOUND in self.converger_spoke_types

    def send_length(self):
        return 1

    def update_if_improving(self, candidate):
        """Keep and send the bound if it improves; True iff strictly
        better."""
        if not self._improves(candidate):
            return False
        better = self._strictly_better(candidate)
        if better or not self._got_bound:
            self.bound = float(candidate)
            self._got_bound = True
            self.spoke_to_hub([self.bound])
            self._append_trace(self.bound)
            return bool(better)
        return False

    def _improves(self, candidate):
        return candidate is not None and np.isfinite(candidate)

    def _strictly_better(self, candidate):
        if self.opt.is_minimizing:
            return (candidate < self.bound if self._is_inner_like()
                    else candidate > self.bound)
        return (candidate > self.bound if self._is_inner_like()
                else candidate < self.bound)

    def _heartbeat(self):
        """Re-post the current bound under a fresh write_id (the hub's
        update is idempotent)."""
        if self._got_bound:
            self.spoke_to_hub([self.bound])

    def spoke_to_hub(self, values):
        """A bound post also sets this spoke's bound-progression gauge
        (wheel.slice_bound.<track>, read by telemetry.wheel_counters),
        keyed by its trace track."""
        super().spoke_to_hub(values)
        if self.telemetry.enabled and len(values) \
                and np.isfinite(values[0]):
            track = self.telemetry_track or type(self).__name__
            self.telemetry.gauge(
                f"wheel.slice_bound.{track}").set(float(values[0]))

    def _append_trace(self, value):
        if self._trace_path is None:
            return
        with open(self._trace_path, "a") as f:
            f.write(f"{time.time() - self._t0},{value}\n")

    def algo_state(self):
        state = super().algo_state()
        state["bound"] = float(self.bound)
        state["got_bound"] = bool(self._got_bound)
        return state

    def restore_algo_state(self, state):
        super().restore_algo_state(state)
        if "bound" in state:
            self.bound = float(state["bound"])
        if "got_bound" in state:
            self._got_bound = bool(state["got_bound"])


class _SKSpoke(_BoundSpoke):
    """A bound spoke that receives one (S*K,) hub vector."""

    def receive_length(self):
        b = self.opt.batch
        return b.num_scens * b.num_nonants

    def _reshape_SK(self, data):
        """(S, K) view of a flattened hub vector."""
        b = self.opt.batch
        return np.asarray(data).reshape(-1, b.num_nonants)[:b.num_scens]


class _BoundWSpoke(_SKSpoke):
    """Bound spoke that receives the hub's W (flattened (S*K,))."""

    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,
                             ConvergerSpokeType.W_GETTER)

    @property
    def localWs(self):
        """Pure read of the hub's latest W (does not consume the
        freshness flag; step loops use fresh_Ws)."""
        data, _ = self.pair.to_spoke.read()
        return self._reshape_SK(data)

    def fresh_Ws(self):
        """(W (S, K), is_new)"""
        data, is_new = self.spoke_from_hub()
        return self._reshape_SK(data), is_new


class _BoundNonantSpoke(_SKSpoke):
    """Bound spoke that receives the hub's nonant values (flattened
    (S*K,))."""

    def fresh_nonants(self):
        data, is_new = self.spoke_from_hub()
        return self._reshape_SK(data), is_new

    @property
    def localnonants(self):
        """Pure read (does not consume the freshness flag)."""
        data, _ = self.pair.to_spoke.read()
        return self._reshape_SK(data)


class InnerBoundNonantSpoke(_BoundNonantSpoke):
    """Inner-bound spoke on the hub's nonants; keeps the incumbent
    first-stage solution."""

    converger_spoke_types = (ConvergerSpokeType.INNER_BOUND,
                             ConvergerSpokeType.NONANT_GETTER)

    def __init__(self, spbase_object, options=None):
        super().__init__(spbase_object, options=options)
        self.best_solution = None      # (K,) or (S, K) incumbent nonants

    def update_if_improving(self, candidate, solution=None):
        # record the incumbent before posting the bound: in threads
        # mode the hub may read the window between the post and a later
        # assignment and pair the new bound with a stale solution
        if (solution is not None and self._improves(candidate)
                and (self._strictly_better(candidate)
                     or not self._got_bound)):
            self.best_solution = np.asarray(solution)
        return super().update_if_improving(candidate)

    def algo_state(self):
        state = super().algo_state()
        if self.best_solution is not None:
            state["best_solution"] = np.asarray(self.best_solution)
        return state

    def restore_algo_state(self, state):
        super().restore_algo_state(state)
        if "best_solution" in state:
            self.best_solution = np.asarray(state["best_solution"])


class OuterBoundNonantSpoke(_BoundNonantSpoke):
    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,
                             ConvergerSpokeType.NONANT_GETTER)
