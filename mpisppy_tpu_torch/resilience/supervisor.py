"""SpokeSupervisor — process supervision for the multiproc wheel (port
of `mpisppy_tpu/resilience/supervisor.py`).

The multiproc mode (`cylinders/proc.py`) runs each spoke as its own OS
process attached to the hub's mmap seqlock windows.  The hub's
`SpokeHandle.step()` is a no-op, so without supervision a crashed spoke
would go unnoticed and a hung one would produce nothing.  The
supervisor:

  * **death detection** via `Popen.poll()` each supervision interval
    (the hub calls `poll()` from `sync()` every iteration; a throttle
    keeps the cost bounded);
  * **hang detection** via window `write_id` staleness — the spoke's
    own bound writes are the heartbeat (bound spokes re-post their
    current bound on a timer precisely so the id keeps advancing, see
    `cylinders/spoke.py`), monotone by the seqlock protocol
    (`runtime/exchange.cpp`);
  * **escalated kills** SIGTERM -> SIGKILL with a deadline for hung
    children;
  * **restarts** from the declarative spec with capped exponential
    backoff — the fresh process re-attaches to the existing window
    files and re-acquires warm state from the hub's last W/nonant
    write (attach never resets the files, `cylinders/spcommunicator`);
  * **permanent pruning** into the hub's `_mark_spoke_failed` path
    once the restart budget is exhausted, so the wheel finishes on the
    hub's own valid bounds;
  * **exit reporting** — every nonzero exit code plus the tail of the
    incarnation's log file is kept and surfaced in the hub's final
    report instead of being silently discarded.

Options (read from the hub's options dict):
  supervise_interval        min seconds between polls        (1.0)
  spoke_hang_timeout        stale-window seconds -> hung     (300.0)
  spoke_max_restarts        restarts before pruning          (2)
  spoke_restart_backoff     first backoff seconds, doubling  (0.5)
  spoke_restart_backoff_cap backoff ceiling seconds          (30.0)
  spoke_term_deadline       SIGTERM grace before SIGKILL     (5.0)
"""

from __future__ import annotations

import os
import signal
import time

from .. import global_toc
from .. import telemetry as _telemetry

LIVE, WAITING, STOPPED, FAILED = "live", "waiting", "stopped", "failed"


def restart_delay(n, backoff, cap):
    """Capped exponential backoff before the n-th restart (n >= 1)."""
    return min(backoff * 2.0 ** (n - 1), cap)


def _log_tail(proc, max_lines=15):
    lp = getattr(proc, "log_path", None)
    if lp and os.path.exists(lp):
        try:
            with open(lp) as f:
                return "".join(f.readlines()[-max_lines:])
        except OSError:
            pass
    return ""


class SpokeSupervisor:
    def __init__(self, hub, specs, workdir, options=None, spawn_fn=None):
        if spawn_fn is None:
            from ..cylinders.proc import spawn_spoke as spawn_fn
        self.hub = hub
        self.handles = hub.spokes          # SpokeHandle per spoke
        self.specs = list(specs)
        self.workdir = workdir
        self._spawn = spawn_fn
        o = dict(options or {})
        self.interval = float(o.get("supervise_interval", 1.0))
        self.hang_timeout = float(o.get("spoke_hang_timeout", 300.0))
        self.max_restarts = int(o.get("spoke_max_restarts", 2))
        self.backoff = float(o.get("spoke_restart_backoff", 0.5))
        self.backoff_cap = float(o.get("spoke_restart_backoff_cap", 30.0))
        self.term_deadline = float(o.get("spoke_term_deadline", 5.0))
        n = len(self.specs)
        self.state = [STOPPED] * n
        self.restarts = [0] * n            # incarnations beyond the first
        self._next_restart = [0.0] * n
        self._last_wid = [None] * n
        self._last_progress = [0.0] * n
        self._last_poll = 0.0
        self._shutting_down = False
        self.killed_by_us = set()
        # run-level counters (resilience.wheel_counters)
        self.spoke_restarts = 0
        self.spokes_failed = 0
        self.exit_reports = []             # dicts: spoke/rc/log_tail/...
        # lifecycle events land in the shared telemetry event log /
        # metrics (no-ops when telemetry is off); tolerate bare fake
        # hubs in tests that lack a .telemetry attribute
        self._tel = getattr(hub, "telemetry", None) or _telemetry.get()

    # -- lifecycle --------------------------------------------------------
    def start(self):
        for i in range(len(self.specs)):
            self._spawn_incarnation(i, first=True)
        return self

    def _spawn_incarnation(self, i, first=False):
        tag = str(i) if first else f"{i}r{self.restarts[i]}"
        p = self._spawn(self.specs[i], self.workdir, tag)
        self.handles[i].proc = p
        self.state[i] = LIVE
        self._last_wid[i] = None
        self._last_progress[i] = time.monotonic()
        self._tel.event("supervisor.spawn", spoke=i,
                        incarnation=self.restarts[i],
                        pid=getattr(p, "pid", None))

    # -- supervision (hub thread, called from Hub.sync) -------------------
    def poll(self, force=False):
        now = time.monotonic()
        if self._shutting_down or (not force
                                   and now - self._last_poll < self.interval):
            return
        self._last_poll = now
        for i, h in enumerate(self.handles):
            if self.state[i] == WAITING:
                if now >= self._next_restart[i]:
                    self._spawn_incarnation(i)
                continue
            if self.state[i] != LIVE:
                continue
            rc = h.proc.poll()
            if rc is not None:
                if rc == 0:
                    # clean early exit (e.g. the spoke saw a stale kill
                    # flag): not a failure, just out of the wheel
                    self.state[i] = STOPPED
                    continue
                self._record_exit(i, rc)
                self._on_down(i, f"exited rc={rc}")
                continue
            # hang detection: the spoke's to_hub write_id is its
            # heartbeat; no advance within the timeout => hung
            wid = self.hub.pairs[i].to_hub.write_id
            if wid != self._last_wid[i]:
                self._last_wid[i] = wid
                self._last_progress[i] = now
            self._tel.gauge(f"supervisor.heartbeat_age.spoke{i}").set(
                now - self._last_progress[i])
            if wid == self._last_wid[i] \
                    and now - self._last_progress[i] > self.hang_timeout:
                self._kill_escalating(i)
                rc = h.proc.poll()
                self._record_exit(i, rc, hung=True)
                self._on_down(
                    i, f"hung: no window write for "
                       f"{now - self._last_progress[i]:.1f}s")

    def _kill_escalating(self, i):
        """SIGTERM, wait out the deadline, then SIGKILL."""
        p = self.handles[i].proc
        self.killed_by_us.add(p.pid)
        try:
            self._tel.event("supervisor.sigterm", spoke=i, pid=p.pid)
            p.send_signal(signal.SIGTERM)
            p.wait(timeout=self.term_deadline)
        except Exception:
            try:
                self._tel.event("supervisor.sigkill", spoke=i, pid=p.pid)
                p.kill()
                p.wait(timeout=self.term_deadline)
            except Exception:      # pragma: no cover - unkillable child
                pass

    def _record_exit(self, i, rc, hung=False):
        self.exit_reports.append({
            "spoke": i,
            "name": self.handles[i].spoke_name,
            "incarnation": self.restarts[i],
            "rc": rc,
            "hung": hung,
            "log_tail": _log_tail(self.handles[i].proc),
        })

    def _on_down(self, i, reason):
        h = self.handles[i]
        if self.restarts[i] < self.max_restarts:
            self.restarts[i] += 1
            self.spoke_restarts += 1
            delay = restart_delay(self.restarts[i], self.backoff,
                                  self.backoff_cap)
            self._next_restart[i] = time.monotonic() + delay
            self.state[i] = WAITING
            self._tel.event("supervisor.restart", spoke=i, reason=reason,
                            incarnation=self.restarts[i], delay=delay)
            self._tel.counter("supervisor.restarts").inc()
            global_toc(f"WARNING: spoke {i} ({h.spoke_name}) {reason}; "
                       f"restart {self.restarts[i]}/{self.max_restarts} "
                       f"in {delay:.2f}s")
        else:
            self.state[i] = FAILED
            self.spokes_failed += 1
            self._tel.event("supervisor.prune", spoke=i, reason=reason,
                            restarts=self.restarts[i])
            self._tel.counter("supervisor.spokes_failed").inc()
            tail = self.exit_reports[-1]["log_tail"] if self.exit_reports \
                else ""
            self.hub._mark_spoke_failed(i, RuntimeError(
                f"{reason} after {self.restarts[i]} restart(s); "
                f"log tail:\n{tail}"))

    # -- shutdown (after hub.send_terminate) ------------------------------
    def shutdown(self, timeout=120.0):
        """Wait for live children to exit on the kill signal; escalate
        stragglers; collect exit reports for any nonzero rc."""
        self._shutting_down = True
        for i, h in enumerate(self.handles):
            if self.state[i] != LIVE or h.proc is None:
                continue
            try:
                h.proc.wait(timeout=timeout)
            except Exception:
                global_toc(f"spoke {i} still busy {timeout:.0f}s after "
                           "the kill signal; terminating it")
                self._kill_escalating(i)
            rc = h.proc.poll()
            if rc is not None and rc != 0 \
                    and h.proc.pid not in self.killed_by_us:
                self._record_exit(i, rc)
            self.state[i] = STOPPED

    def kill_all(self):
        """Last-resort cleanup: nothing may outlive the wheel."""
        self._shutting_down = True
        for h in self.handles:
            p = getattr(h, "proc", None)
            if p is not None and p.poll() is None:
                self.killed_by_us.add(p.pid)
                p.kill()
