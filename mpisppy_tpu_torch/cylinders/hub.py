"""Hub classes (port of `mpisppy_tpu/cylinders/hub.py`).

The hub runs the main algorithm (PH), pushes W and nonant vectors to
the spokes, pulls their bounds, tracks BestInnerBound and
BestOuterBound, and decides gap-based termination (rel_gap, abs_gap,
max_stalled_iters).  Each incoming bound is screened
(`resilience.bounds.BoundGuard`) and each window read validated; a
spoke that fails, or exceeds its budget of rejected bounds or corrupt
reads, is pruned from the wheel and the run goes on without it.

Telemetry: rejected bounds and corrupt reads are counted
(window.bound_rejects, wheel.corrupt_reads) and logged as events, each
improvement of a best bound sets the hub.best_outer / hub.best_inner
gauges and a hub.bounds counter sample on the trace, and each
`PHHub.sync()` is a hub.sync span.

`APHHub` runs APH (`opt/aph.py`) behind PHHub's wire protocol;
`LShapedHub` runs L-shaped (`opt/lshaped.py`), sends its candidate x̂
to nonant spokes and feeds no W spokes.

An extension of the hub optimizer with `attach_spoke` is wired to each
spoke that `provides_cuts` (the cross-scenario cut spoke and its
extension).  `window_path_prefix` puts the windows in mmap files
(`<prefix><i>.to_spoke` / `.to_hub`, the native seqlock), which spoke
processes attach to in multiproc mode; there `supervisor` (set by the
wheel, `resilience/supervisor.py`) is polled at every sync.
"""

from __future__ import annotations

import collections

import numpy as np

from .. import global_toc
from ..device import host
from ..resilience.bounds import BoundGuard
from .spcommunicator import SPCommunicator, WindowPair
from .spoke import ConvergerSpokeType


class Hub(SPCommunicator):
    def __init__(self, spbase_object, spokes=(), options=None):
        super().__init__(spbase_object, options=options)
        self.spokes = list(spokes)
        self.pairs = []
        if self.opt.is_minimizing:
            self.BestInnerBound = np.inf
            self.BestOuterBound = -np.inf
            self._ib_better = lambda new, old: new < old
            self._ob_better = lambda new, old: new > old
        else:
            self.BestInnerBound = -np.inf
            self.BestOuterBound = np.inf
            self._ib_better = lambda new, old: new > old
            self._ob_better = lambda new, old: new < old
        # screen trace state
        self.print_init = True
        self.latest_ib_char = None
        self.latest_ob_char = None
        # stall tracking
        self.stalled_iter_cnt = 0
        self.last_gap = float("inf")
        self.best_nonant_solution = None   # incumbent (K,) or (S, K)
        # interleaved mode: the hub steps the spokes inside sync();
        # threads mode clears this and the spokes loop in their threads
        self.drive_spokes_inline = True
        # a spoke whose step raises is removed from the wheel.  Spoke
        # threads report failures through this deque, drained on the
        # hub thread (the wiring sets must not change under iteration)
        self.failed_spokes = []
        self._failed_queue = collections.deque()
        # (name, message) of each spoke whose final pass raised: the
        # wheel's bounds stand without it, but a caller must be able to
        # see that a pass failed
        self.finalize_failures = []
        # multiproc mode: the process supervisor (set by the wheel,
        # polled from sync()) and the nonzero exits it collected
        self.supervisor = None
        self.spoke_exit_reports = []
        self._bound_guard = (
            BoundGuard(rtol=self.options.get("bound_cross_rtol", 1e-2))
            if self.options.get("bound_guard", True) else None)
        self._max_bound_rejects = int(
            self.options.get("max_bound_rejects", 25))
        self._max_corrupt_reads = int(
            self.options.get("max_corrupt_reads", 10))
        # bound-progression and reject telemetry (no-ops when off)
        self._c_rejects = self.telemetry.counter("window.bound_rejects")
        self._c_corrupt = self.telemetry.counter("wheel.corrupt_reads")
        self._g_outer = self.telemetry.gauge("hub.best_outer")
        self._g_inner = self.telemetry.gauge("hub.best_inner")

    def _spoke_name(self, i):
        # a multiproc SpokeHandle carries the spoke class's name
        sp = self.spokes[i]
        return getattr(sp, "spoke_name", type(sp).__name__)

    def _mark_spoke_failed(self, i, exc):
        """Prune spoke i out of every wiring set (hub thread only)."""
        sp = self.spokes[i]
        if getattr(sp, "_failed", False):
            return
        sp._failed = True
        for idx_set in (self.outerbound_idx, self.innerbound_idx,
                        self.w_idx, self.nonant_idx_set):
            idx_set.discard(i)
        self.has_outerbound_spokes = bool(self.outerbound_idx)
        self.has_innerbound_spokes = bool(self.innerbound_idx)
        name = self._spoke_name(i)
        self.failed_spokes.append((name, str(exc)))
        global_toc(f"WARNING: spoke {name} failed and "
                   f"was removed from the wheel: {exc}")

    def report_spoke_failure(self, spoke, exc):
        """Thread-safe failure report, applied on the hub thread by
        _drain_failures."""
        self._failed_queue.append((spoke, exc))

    def _drain_failures(self):
        while True:
            try:
                spoke, exc = self._failed_queue.popleft()
            except IndexError:
                break
            try:
                i = self.spokes.index(spoke)
            except ValueError:
                continue
            if not getattr(spoke, "_failed", False):
                self._mark_spoke_failed(i, exc)

    def _step_spokes(self):
        for i, sp in enumerate(self.spokes):
            if getattr(sp, "_failed", False):
                continue
            try:
                sp.timed_step()
            except Exception as e:
                self._mark_spoke_failed(i, e)

    # -- wiring -----------------------------------------------------------
    def wire_spokes(self):
        self.outerbound_idx, self.innerbound_idx = set(), set()
        self.w_idx, self.nonant_idx_set = set(), set()
        self.spoke_chars = {}
        self.pairs = []
        bkw = self.options.get("window_backend_kwargs") or {}
        prefix = self.options.get("window_path_prefix")
        for i, sp in enumerate(self.spokes):
            for cst in sp.converger_spoke_types:
                if cst == ConvergerSpokeType.OUTER_BOUND:
                    self.outerbound_idx.add(i)
                elif cst == ConvergerSpokeType.INNER_BOUND:
                    self.innerbound_idx.add(i)
                elif cst == ConvergerSpokeType.W_GETTER:
                    self.w_idx.add(i)
                elif cst == ConvergerSpokeType.NONANT_GETTER:
                    self.nonant_idx_set.add(i)
            self.spoke_chars[i] = sp.converger_spoke_char
            pair = WindowPair(
                hub_length=sp.receive_length(),
                spoke_length=sp.send_length(),
                backend=self.options.get("window_backend", "python"),
                path_prefix=None if prefix is None else f"{prefix}{i}",
                backend_kwargs=bkw.get(i))
            sp.pair = pair
            self.pairs.append(pair)
        self._spoke_read_ids = np.zeros(len(self.spokes), np.int64)
        self.bound_rejects = np.zeros(len(self.spokes), np.int64)
        self.corrupt_reads = np.zeros(len(self.spokes), np.int64)
        self.has_outerbound_spokes = bool(self.outerbound_idx)
        self.has_innerbound_spokes = bool(self.innerbound_idx)
        # wire extensions that consume a spoke's feed (the
        # cross-scenario cut extension reads its spoke's window)
        ext = getattr(self.opt, "extobject", None)
        if ext is not None:
            for e in [ext] + list(getattr(ext, "extensions", [])):
                if hasattr(e, "attach_spoke"):
                    for sp in self.spokes:
                        if getattr(sp, "provides_cuts", False):
                            e.attach_spoke(sp)

    # -- gaps -------------------------------------------------------------
    def compute_gaps(self):
        if self.opt.is_minimizing:
            abs_gap = self.BestInnerBound - self.BestOuterBound
        else:
            abs_gap = self.BestOuterBound - self.BestInnerBound
        if (np.isfinite(abs_gap) and np.isfinite(self.BestOuterBound)
                and self.BestOuterBound != 0):
            rel_gap = abs_gap / abs(self.BestOuterBound)
        else:
            rel_gap = float("inf")
        return abs_gap, rel_gap

    def determine_termination(self):
        o = self.options
        if not any(k in o for k in
                   ("rel_gap", "abs_gap", "max_stalled_iters")):
            return False
        abs_gap, rel_gap = self.compute_gaps()
        rel_ok = "rel_gap" in o and rel_gap <= o["rel_gap"]
        abs_ok = "abs_gap" in o and abs_gap <= o["abs_gap"]
        stalled = False
        if "max_stalled_iters" in o:
            if abs_gap < self.last_gap:
                self.last_gap = abs_gap
                self.stalled_iter_cnt = 0
            else:
                self.stalled_iter_cnt += 1
                stalled = self.stalled_iter_cnt >= o["max_stalled_iters"]
        if abs_ok:
            global_toc(f"Terminating: abs gap {abs_gap:12.4f}")
        if rel_ok:
            global_toc(f"Terminating: rel gap {rel_gap*100:12.3f}%")
        if stalled:
            global_toc(f"Terminating: stalled {self.stalled_iter_cnt} iters")
        return abs_ok or rel_ok or stalled

    def screen_trace(self):
        abs_gap, rel_gap = self.compute_gaps()
        src = ((self.latest_ob_char or " ")
               + " " + (self.latest_ib_char or " "))
        if self.print_init:
            global_toc(f'{"Iter.":>5s}  {"   "}  {"Best Bound":>14s}  '
                       f'{"Best Incumbent":>14s}  {"Rel. Gap":>12s}  '
                       f'{"Abs. Gap":>14s}')
            self.print_init = False
        global_toc(f"{self.current_iteration():5d}  {src}  "
                   f"{self.BestOuterBound:14.4f}  "
                   f"{self.BestInnerBound:14.4f}  "
                   f"{rel_gap*100:12.3f}%  {abs_gap:14.4f}")
        self.latest_ib_char = None
        self.latest_ob_char = None

    # -- bound intake -----------------------------------------------------
    def _accept_bound(self, kind, value, i):
        """Screen one incoming bound; on reject count it and, past the
        budget, prune the spoke.  True iff the bound may enter
        Best{Inner,Outer}Bound."""
        if self._bound_guard is None:
            return True
        ok, reason = self._bound_guard.check(
            kind, value, inner=self.BestInnerBound,
            outer=self.BestOuterBound,
            minimizing=self.opt.is_minimizing)
        if ok:
            return True
        self.bound_rejects[i] += 1
        self._c_rejects.inc()
        self.telemetry.event("hub.bound_reject", spoke=i, kind=kind,
                             reason=str(reason))
        n = int(self.bound_rejects[i])
        if n == 1 or n % 10 == 0:
            global_toc(f"WARNING: rejected bound from spoke {i} "
                       f"({self._spoke_name(i)}): {reason} "
                       f"[{n} rejected so far]")
        if (n >= self._max_bound_rejects
                and not getattr(self.spokes[i], "_failed", False)):
            self._mark_spoke_failed(i, RuntimeError(
                f"{n} rejected bounds (last: {reason})"))
        return False

    def _read_spoke_checked(self, i):
        """Validated read of spoke i's to_hub window: (data, write_id,
        ok).  A rejected snapshot counts into the spoke's corrupt-read
        budget; past it the spoke is pruned like a crashed one."""
        win = self.pairs[i].to_hub
        rc = getattr(win, "read_checked", None)
        if rc is None:
            data, wid = win.read()
            return data, wid, True
        data, wid, ok, reason = rc()
        if ok:
            return data, wid, True
        self.corrupt_reads[i] += 1
        self._c_corrupt.inc()
        self.telemetry.event("hub.corrupt_read", spoke=i,
                             reason=str(reason))
        n = int(self.corrupt_reads[i])
        if n == 1 or n % 10 == 0:
            global_toc(f"WARNING: rejected corrupt window read from "
                       f"spoke {i} ({self._spoke_name(i)}): {reason} "
                       f"[{n} rejected so far]")
        if (n >= self._max_corrupt_reads
                and not getattr(self.spokes[i], "_failed", False)):
            self._mark_spoke_failed(i, RuntimeError(
                f"{n} corrupt window reads (last: {reason})"))
        return data, wid, False

    def receive_outerbounds(self):
        for i in list(self.outerbound_idx):
            data, wid, ok = self._read_spoke_checked(i)
            self._c_reads.inc()
            if not ok:
                continue
            if wid > self._spoke_read_ids[i]:
                self._spoke_read_ids[i] = wid
                if self._accept_bound("outer", float(data[0]), i):
                    self.OuterBoundUpdate(float(data[0]), i)
            else:
                self._c_stale.inc()

    def receive_innerbounds(self):
        for i in list(self.innerbound_idx):
            data, wid, ok = self._read_spoke_checked(i)
            self._c_reads.inc()
            if not ok:
                continue
            if wid > self._spoke_read_ids[i]:
                self._spoke_read_ids[i] = wid
                if not self._accept_bound("inner", float(data[0]), i):
                    continue
                self.InnerBoundUpdate(float(data[0]), i)
                sol = getattr(self.spokes[i], "best_solution", None)
                if sol is not None and self.BestInnerBound == float(data[0]):
                    self.best_nonant_solution = sol
            else:
                self._c_stale.inc()

    def _record_bound(self, kind, value, gauge):
        """Bound progression: a gauge for the snapshots and a Chrome
        counter sample, so a trace viewer graphs hub.bounds over the run
        (finite values only: counter samples are numeric JSON)."""
        if self.telemetry.enabled and np.isfinite(value):
            gauge.set(value)
            self.telemetry.tracer.counter("hub.bounds", {kind: value})

    def OuterBoundUpdate(self, new_bound, idx=None, char="*"):
        if self._ob_better(new_bound, self.BestOuterBound):
            self.latest_ob_char = (self.spoke_chars.get(idx, char)
                                   if idx is not None else char)
            self.BestOuterBound = new_bound
            self._record_bound("outer", new_bound, self._g_outer)
        return self.BestOuterBound

    def InnerBoundUpdate(self, new_bound, idx=None, char="*"):
        if self._ib_better(new_bound, self.BestInnerBound):
            self.latest_ib_char = (self.spoke_chars.get(idx, char)
                                   if idx is not None else char)
            self.BestInnerBound = new_bound
            self._record_bound("inner", new_bound, self._g_inner)
        return self.BestInnerBound

    # -- outbound ---------------------------------------------------------
    def send_terminate(self):
        for pair in self.pairs:
            pair.to_spoke.send_kill()
            self._c_kills.inc()

    def hub_finalize(self):
        self._drain_failures()
        self.receive_outerbounds()
        self.receive_innerbounds()
        # nonzero spoke exits and their log tails (multiproc mode,
        # collected by the supervisor)
        for rep in self.spoke_exit_reports:
            how = "hung" if rep.get("hung") else f"rc={rep['rc']}"
            tail = rep.get("log_tail") or ""
            global_toc(
                f"WARNING: spoke {rep['spoke']} ({rep['name']}) "
                f"incarnation {rep['incarnation']} {how}"
                + (f"; log tail:\n{tail}" if tail.strip() else ""))
        global_toc("Statistics at termination")
        self.print_init = True
        self.screen_trace()

    def current_iteration(self):
        raise NotImplementedError

    def main(self):
        raise NotImplementedError


class PHHub(Hub):
    """PH as hub: sync() sends W and nonants and receives bounds;
    is_converged() seeds the outer bound with PH's trivial bound and
    applies gap termination."""

    def setup_hub(self):
        self.wire_spokes()

    def sync(self):
        with self.telemetry.span("hub.sync"):
            self._drain_failures()
            if self.supervisor is not None:
                self.supervisor.poll()
            self.send_ws()
            self.send_nonants()
            if self.drive_spokes_inline:
                self._step_spokes()
            self.receive_outerbounds()
            self.receive_innerbounds()

    def is_converged(self):
        if (not np.isfinite(self.BestOuterBound)
                and self.opt.trivial_bound is not None):
            self.OuterBoundUpdate(self.opt.trivial_bound, char="B")
        if not self.has_innerbound_spokes:
            if self.opt.conv is not None and \
                    self.opt.conv < self.options.get("convthresh", -1):
                return True
            return False
        self.screen_trace()
        return self.determine_termination()

    def current_iteration(self):
        st = self.opt.state
        return int(st.it) if st is not None else 0

    def main(self):
        return self.opt.ph_main(finalize=False)

    def _send(self, targets, t):
        """One device->host copy of `t`, written to every target."""
        if not targets:
            return
        flat = host(t).reshape(-1)
        for i in targets:
            self.pairs[i].to_spoke.write(flat)
            self._c_writes.inc()

    def send_nonants(self):
        """Push the current per-scenario nonant values."""
        st = self.opt.state
        if st is not None:
            self._send(self.nonant_idx_set, self.opt.batch.nonants(st.x))

    def send_ws(self):
        """Push the current W."""
        st = self.opt.state
        if st is not None:
            self._send(self.w_idx, st.W)


class APHHub(PHHub):
    """APH as hub: PHHub's wire protocol (APH mirrors its W and x into
    `opt.state` after every superstep); main() runs APH_main."""

    def main(self):
        return self.opt.APH_main(spcomm=self, finalize=False)


class LShapedHub(Hub):
    """L-shaped as hub: sends the candidate x̂ to nonant spokes (no W
    spokes), receives bounds, gap termination."""

    def setup_hub(self):
        self.wire_spokes()
        if self.w_idx:
            raise RuntimeError(
                "LShapedHub cannot feed W spokes (reference hub.py:628)")

    def sync(self, send_nonants=True):
        with self.telemetry.span("hub.sync"):
            self._drain_failures()
            if self.supervisor is not None:
                self.supervisor.poll()
            if send_nonants:
                self.send_nonants()
            if self.drive_spokes_inline:
                self._step_spokes()
            self.receive_outerbounds()
            self.receive_innerbounds()

    def is_converged(self):
        # the hub's own loop gives both bounds; spokes may improve the
        # inner one
        ob = self.opt.outer_bound
        if np.isfinite(ob):
            self.OuterBoundUpdate(ob, char="B")
        ib = self.opt.inner_bound
        if np.isfinite(ib):
            self.InnerBoundUpdate(ib, char="B")
        self.screen_trace()
        return self.determine_termination()

    def current_iteration(self):
        return self.opt.iter

    def main(self):
        return self.opt.lshaped_algorithm()

    def send_nonants(self):
        """Push the candidate x̂, replicated per scenario so that nonant
        spokes see the usual (S*K,) layout."""
        xhat = getattr(self.opt, "best_xhat", None)
        if xhat is None or not self.nonant_idx_set:
            return
        b = self.opt.batch
        flat = np.tile(np.asarray(xhat), (b.num_scens, 1)).reshape(-1)
        for i in self.nonant_idx_set:
            self.pairs[i].to_spoke.write(flat)
            self._c_writes.inc()
