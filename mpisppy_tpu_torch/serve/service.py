"""SolverService — a persistent in-process solver service (port of
`mpisppy_tpu/serve/service.py`).

The one-shot batch-job shape (`WheelSpinner` / driver scripts) pays
CUDA context creation, the kernel library's load and the occupancy
queries per invocation and exits.  This service keeps the process (and
its buckets' solvers and plans) alive and feeds it a queue of solve
requests, on the CUDA device unless `device="cpu"` is passed:

  client --submit()--> bounded queue --dispatch thread--> PH solves
          <--handle--                                      |
          <--poll/result (structured, never hangs) --------+

Dispatch (`_next_group`) pops the oldest request and COALESCES every
queued request in the same shape bucket (compile_cache.bucket_key)
with it, up to `serve_max_batch`.  A group of one runs exactly the
standalone `PH` path — the same superstep `PH.ph_main` runs, so the
result is bitwise identical (the api.py parity guarantee; on the card
too, since the reductions of the superstep add in a fixed order).  A
larger group runs Iter0 per request, then drives ALL requests through
ONE group superstep (`phbase.group_superstep`: one PDHG solve over
every request's scenarios, one chunk-kernel launch a chunk for the
group, each request's own x̄, W and conv) in lockstep, taking each
finished request's state out at ITS stopping iteration while the rest
keep iterating (finished requests keep computing inside the group —
wasted lanes, bounded by `serve_max_batch`, the price of one dispatch
per iteration for the whole group).  Requests whose operators cannot
share a group solve (different forms, or split deltas at different
coordinates; the bucket key normally keeps them apart) run one by
one.

Supervision mirrors resilience.SpokeSupervisor, adapted to a thread
worker: a crash (including injected `ChaosError` via
`options["chaos"]` — each dispatched group is one chaos "step", and
`crash_at_iter` counts dispatches) requeues the in-flight requests
(per-request attempt budget), restarts the dispatch thread after the
shared capped-exponential `restart_delay`, and fails the whole service
once the restart budget is spent — every queued request then gets a
structured FAILED result, and later submits are rejected.  A HUNG
worker (chaos `hang_at_step`) is covered by per-request deadlines:
`result()` is always time-bounded.

Options (all prefixed `serve_`):
  serve_max_queue       queue capacity, rejects beyond       (256)
  serve_max_inflight    queued+running admission cap         (32)
  serve_max_batch       max coalesced requests per dispatch  (8)
  serve_coalesce_window_s  batch-forming hold (seconds) while a
                        short group's bucket is still filling (0)
  serve_default_deadline  per-request seconds (None = none)  (None)
  serve_result_timeout  result() wait when no deadline       (600)
  serve_result_grace    extra result() wait past deadline    (30)
  serve_max_attempts    executions per request before FAILED (2)
  serve_max_restarts    worker restarts before service FAILED(2)
  serve_restart_backoff / serve_restart_backoff_cap          (0.1/5)
  serve_device          the device (overridden by `device=`) (the card)
plus the standard `telemetry` and `chaos` keys.

Metrics (doc/src/serve.md): serve.queue_depth gauge,
serve.batch_size / serve.request_seconds histograms,
serve.compile_cache.{hit,miss} / serve.requests.* /
serve.worker_restarts counters, serve.request + serve.dispatch spans.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from .. import global_toc
from .. import telemetry as _telemetry
from ..device import resolve_device
from ..resilience.chaos import ChaosError, ChaosInjector
from ..resilience.supervisor import restart_delay
from . import compile_cache as _cc
from .request import (FAILED, OK, QUEUED, RUNNING, RequestHandle,
                      SolveRequest, failed_result, rejected_result,
                      timeout_result)

# Process-wide device execution lock.  In-process replicas (the
# serve.replica.ReplicaSet) are separate fault domains but share ONE
# device and ONE host interpreter: two dispatch threads driving the
# solver's host loop at once would only interleave their launches on
# the card's one stream and contend for the GIL.  Real deployments give
# each replica its own process (serve/procpool.py); in-process replica
# sets serialize device execution instead — queueing, draining, health
# probing, and crash handling all stay concurrent.  Opt out with
# serve_backend_lock=False (single-replica deployments where the
# uncontended acquire is still ~free).
_BACKEND_LOCK = threading.Lock()


def stack_superstep_args(phs):
    """The group arguments of N same-bucket PH instances after their
    Iter0 (`phbase.GroupArgs`: every request's state, rho, bounds,
    tolerance, prep and batch stacked along the scenario axis) —
    exactly what `CompiledBucket.batched_superstep` runs.  Raises
    `phbase.GroupRefused` when their operators cannot share one
    solve."""
    from ..phbase import stack_group
    return stack_group(phs)


class SolverService:
    def __init__(self, options=None, cache=None, device=None):
        o = dict(options or {})
        self.device = resolve_device(
            device if device is not None else o.get("serve_device"))
        o["serve_device"] = str(self.device)
        self.options = o
        self.max_queue = int(o.get("serve_max_queue", 256))
        self.max_inflight = int(o.get("serve_max_inflight", 32))
        self.max_batch = int(o.get("serve_max_batch", 8))
        self.coalesce_window = float(
            o.get("serve_coalesce_window_s", 0.0) or 0.0)
        self.default_deadline = o.get("serve_default_deadline")
        self.result_timeout = float(o.get("serve_result_timeout", 600.0))
        self.result_grace = float(o.get("serve_result_grace", 30.0))
        self.max_attempts = int(o.get("serve_max_attempts", 2))
        self.max_restarts = int(o.get("serve_max_restarts", 2))
        self.backoff = float(o.get("serve_restart_backoff", 0.1))
        self.backoff_cap = float(o.get("serve_restart_backoff_cap", 5.0))
        self._tel = _telemetry.configure_from_options(o.get("telemetry"))
        self._chaos = ChaosInjector.from_options(o.get("chaos"))
        self.cache = cache if cache is not None else _cc.CompileCache(
            self._tel, device=self.device)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queue = deque()
        self._requests = {}           # id -> SolveRequest
        self._results = {}            # id -> result dict
        self._inflight = []           # requests popped, not yet finished
        self._processing = 0
        self._ids = itertools.count(1)
        self._dispatches = 0
        self._stopped = False
        self._draining = False        # drain(): admission closed
        self._failed = None           # terminal service failure reason
        self.restarts = 0
        self._worker = None
        self._started = time.monotonic()
        self.last_dispatch = None     # monotonic time of last dispatch
        # poison attribution: _executing names the ONE request whose
        # own per-request work (chaos tick, PH build, Iter0, single
        # solve) the worker is inside; a crash there is precisely that
        # request's fault and lands its id in crash_suspects (the
        # router's quarantine signal).  Crashes in group-wide phases
        # (batched lockstep, chaos step_tick) are ambiguous and charge
        # nobody — blaming the whole group would quarantine innocents.
        self._executing = None
        self.crash_suspects = set()
        # deficit round-robin across compile-cache buckets: the bucket
        # served by the previous dispatch group, and how many times the
        # DRR rotation had to pass over the queue head (the starvation-
        # averted signal the router aggregates)
        self._last_bucket = None
        self.bucket_starvation = 0
        self._backend_lock = (_BACKEND_LOCK
                              if o.get("serve_backend_lock", True)
                              else threading.Lock())

    # -- lifecycle --------------------------------------------------------
    def start(self):
        """Start the dispatch thread (idempotent)."""
        with self._lock:
            if self._failed is not None:
                return self
            running = self._worker is not None and self._worker.is_alive()
        if not running:
            # bound the shared artifact dir before this process
            # starts adding to it (no-op unless a limit is configured)
            _cc.prune_aot_dir(
                max_age_s=self.options.get("serve_aot_max_age_s"),
                max_total_bytes=self.options.get("serve_aot_max_bytes"))
            self._spawn_worker()
        return self

    def _spawn_worker(self):
        t = threading.Thread(target=self._worker_main,
                             name="serve-dispatch", daemon=True)
        self._worker = t
        t.start()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    def shutdown(self, timeout=60.0):
        """Drain: the worker finishes the queue, then exits.  Anything
        still queued after `timeout` is rejected."""
        with self._work:
            self._stopped = True
            self._work.notify_all()
        w = self._worker
        if w is not None and w.is_alive():
            w.join(timeout)
        with self._lock:
            for req in list(self._queue):
                self._finish_locked(req, rejected_result(req.id, "shutdown"))
            self._queue.clear()

    def drain(self, deadline=30.0, checkpoint_path=None):
        """Graceful drain: close admission immediately (submits reject
        with reason "draining"), let the worker flush the queue and
        in-flight work for up to `deadline` seconds, then stop it and
        checkpoint whatever could not finish (resilience/checkpoint.py
        drain format) so a restarted service `warm_from()`s the file
        and resubmits.  Leftover requests get a structured
        rejected("drained") result — never a hang."""
        with self._work:
            self._draining = True
            self._work.notify_all()
        self._tel.event("serve.drain", deadline=deadline)
        end = time.monotonic() + float(deadline)
        while time.monotonic() < end:
            with self._lock:
                if not self._queue and not self._inflight:
                    break
            time.sleep(0.02)
        with self._work:
            self._stopped = True
            self._work.notify_all()
        w = self._worker
        if w is not None and w.is_alive():
            w.join(max(0.0, end - time.monotonic()) + 1.0)
        with self._lock:
            leftovers = list(self._queue) + list(self._inflight)
            self._queue.clear()
        saved = None
        if checkpoint_path is not None and leftovers:
            from ..resilience.checkpoint import save_drain_checkpoint
            saved = save_drain_checkpoint(checkpoint_path, [
                {"id": req.id, "options": dict(req.options),
                 "scenario_names": req.scenario_names,
                 "model": req.model, "batch": req.batch}
                for req in leftovers])
            global_toc(f"serve: drained {len(leftovers)} request(s) to "
                       f"{saved}")
        for req in leftovers:
            self._finish(req, rejected_result(req.id, "drained"))
        self._tel.event("serve.drained", leftovers=len(leftovers),
                        checkpoint=str(saved))
        return {"drained": len(leftovers), "checkpoint": saved}

    def warm_from(self, path):
        """Resubmit the requests a previous incarnation drained to
        `path` (in their original submission order).  Returns a list of
        (saved_request_id, RequestHandle) pairs; saved deadlines are
        NOT carried over (absolute monotonic clocks do not survive a
        restart).

        A corrupted / truncated / wrong-format checkpoint produces a
        STRUCTURED error dict ({"status": "failed", "reason":
        "corrupt_drain_checkpoint", ...}) instead of an exception, and
        the whole file is validated BEFORE the first resubmit — a bad
        entry can never leave the service half-warmed.  The service
        keeps accepting either way."""
        from ..resilience.checkpoint import load_drain_checkpoint
        try:
            saved = load_drain_checkpoint(path, device="cpu")
        except Exception as exc:
            self._tel.event("serve.warm_from_rejected", path=str(path),
                            error=repr(exc))
            global_toc(f"WARNING: serve warm_from rejected {path}: "
                       f"{exc!r}")
            return {"status": FAILED,
                    "reason": "corrupt_drain_checkpoint",
                    "path": str(path), "error": repr(exc)}
        # validate every entry up front: raising mid-resubmit would
        # warm an arbitrary prefix and lose the rest
        required = ("id", "batch", "options", "scenario_names", "model")
        for pos, d in enumerate(saved):
            missing = [k for k in required
                       if not isinstance(d, dict) or k not in d]
            if missing:
                self._tel.event("serve.warm_from_rejected",
                                path=str(path), entry=pos)
                return {"status": FAILED,
                        "reason": "corrupt_drain_checkpoint",
                        "path": str(path),
                        "error": f"entry {pos} missing keys {missing}"}
        self.start()
        handles = []
        for d in saved:
            h = self.submit(d["batch"], options=d["options"],
                            scenario_names=d["scenario_names"],
                            model=d["model"])
            handles.append((d["id"], h))
        self._tel.event("serve.warm_from", path=str(path),
                        requests=len(handles))
        return handles

    # -- client API -------------------------------------------------------
    def submit(self, batch, options=None, scenario_names=None,
               deadline=None, model=None):
        """Enqueue one solve; returns a RequestHandle immediately.
        Admission control rejects (structured result, status
        "rejected") instead of blocking: full queue, inflight cap, a
        failed service, or a shut-down service."""
        now = time.monotonic()
        dl = deadline if deadline is not None else self.default_deadline
        with self._work:
            req = SolveRequest(
                id=next(self._ids), batch=batch,
                options=dict(options or {}),
                scenario_names=scenario_names, model=model,
                deadline=(now + float(dl)) if dl is not None else None,
                submitted=now)
            self._requests[req.id] = req
            reason = None
            if self._failed is not None:
                reason = "service_failed"
            elif self._stopped:
                reason = "shutdown"
            elif self._draining:
                reason = "draining"
            elif len(self._queue) >= self.max_queue:
                reason = "queue_full"
            elif len(self._queue) + self._processing >= self.max_inflight:
                reason = "max_inflight"
            if reason is not None:
                self._finish_locked(req, rejected_result(req.id, reason))
                return RequestHandle(req.id)
            self._queue.append(req)
            self._tel.counter("serve.requests.submitted").inc()
            self._tel.gauge("serve.queue_depth").set(len(self._queue))
            self._tel.event("serve.submit", request=req.id)
            self._work.notify()
        return RequestHandle(req.id)

    def poll(self, handle):
        """Current status string for the handle ("unknown" for an id
        this service never issued)."""
        with self._lock:
            req = self._requests.get(handle.id)
            return "unknown" if req is None else req.status

    def health(self):
        """One structured health snapshot — the router's probe input.
        `last_dispatch_age` is seconds since the worker last dispatched
        a group (since start() when it never has); a large age with a
        nonempty queue is the hang/slow signal, mirroring the wheel
        supervisor's write-id staleness heartbeat."""
        now = time.monotonic()
        with self._lock:
            ref = self.last_dispatch if self.last_dispatch is not None \
                else self._started
            return {
                "failed": self._failed,
                "draining": self._draining,
                "stopped": self._stopped,
                "queue_depth": len(self._queue),
                "inflight": len(self._inflight),
                "last_dispatch_age": now - ref,
                "restarts": self.restarts,
                "crash_suspects": set(self.crash_suspects),
                "bucket_starvation": self.bucket_starvation,
            }

    def result(self, handle, timeout=None):
        """Block for the result — ALWAYS time-bounded: by `timeout`,
        else by the request deadline + serve_result_grace, else by
        serve_result_timeout.  An expired wait returns a structured
        timeout snapshot WITHOUT finishing the request (a late
        completion still lands; ask again)."""
        req = self._requests.get(handle.id)
        if req is None:
            return {"status": "unknown", "request_id": handle.id}
        if timeout is None:
            if req.deadline is not None:
                timeout = max(req.deadline - time.monotonic(), 0.0) \
                    + self.result_grace
            else:
                timeout = self.result_timeout
        if not req.done.wait(timeout):
            return timeout_result(req, where="result_wait")
        return self._results[req.id]

    def solve(self, batch, options=None, scenario_names=None,
              deadline=None, timeout=None, model=None):
        """Synchronous convenience wrapper: submit + result.  On
        success the dict carries the same values `PH.ph_main` returns
        (PH.solution_dict keys)."""
        self.start()
        h = self.submit(batch, options, scenario_names=scenario_names,
                        deadline=deadline, model=model)
        return self.result(h, timeout=timeout)

    # -- completion bookkeeping -------------------------------------------
    def _finish_locked(self, req, res):
        if req.done.is_set():
            return
        if req.status == RUNNING:
            self._processing -= 1
        if req in self._inflight:
            self._inflight.remove(req)
        req.status = res["status"]
        self._results[req.id] = res
        req.done.set()
        self._tel.counter(f"serve.requests.{res['status']}").inc()
        self._tel.histogram("serve.request_seconds").observe(
            time.monotonic() - req.submitted)
        self._tel.event("serve.done", request=req.id,
                        status=res["status"])

    def _finish(self, req, res):
        with self._lock:
            self._finish_locked(req, res)

    # -- dispatch thread --------------------------------------------------
    def _worker_main(self):
        try:
            while True:
                group = self._next_group()
                if group is None:
                    return
                self._process_group(group)
        except Exception as exc:     # includes injected ChaosError
            self._on_worker_crash(exc)

    def _bucket(self, req):
        if req.bucket is None:
            req.bucket = _cc.bucket_key(req.batch, req.options,
                                        model=req.model,
                                        backend=self.device.type)
        return req.bucket

    def _next_group(self):
        """Form the next dispatch group by deficit round-robin across
        compile-cache buckets: the queued buckets (in arrival order)
        form a ring, and each dispatch serves the bucket after the one
        served last — so a hot bucket streaming same-shape requests
        can't starve an interleaved cold one.  Within the chosen
        bucket, up to max_batch requests coalesce in arrival order;
        queue order is preserved for the rest.  Every rotation that
        passes over the queue head counts in `bucket_starvation` (one
        head-of-line wait averted).  Returns None only on drained
        shutdown."""
        with self._work:
            while True:
                now = time.monotonic()
                for req in [r for r in self._queue if r.expired(now)]:
                    self._queue.remove(req)
                    self._finish_locked(
                        req, timeout_result(req, where="queued"))
                if not self._queue:
                    if self._stopped:
                        return None
                    self._work.wait(0.25)
                    continue
                order = []
                for r in self._queue:
                    b = self._bucket(r)
                    if b not in order:
                        order.append(b)
                pick = order[0]
                if len(order) > 1 and self._last_bucket is not None \
                        and self._last_bucket in order:
                    # the ring: first queued bucket after the last-
                    # served one; a bucket no longer queued forfeits
                    # its slot and the turn falls back to the queue
                    # head
                    i = order.index(self._last_bucket)
                    pick = order[(i + 1) % len(order)]
                if self.coalesce_window > 0.0 and not self._stopped:
                    # batch-forming window: requests arriving one at a
                    # time (e.g. over the wire) would otherwise
                    # dispatch as odd-width groups, each width a fresh
                    # trace — hold a short group open until max_batch
                    # fills or the window (from the group head's
                    # arrival) expires
                    matching = [r for r in self._queue
                                if self._bucket(r) == pick]
                    if len(matching) < self.max_batch:
                        hold = (matching[0].submitted
                                + self.coalesce_window) - now
                        if hold > 0:
                            self._work.wait(min(hold, 0.25))
                            continue
                break
            if pick != order[0]:
                self.bucket_starvation += 1
                self._tel.counter("serve.bucket_starvation").inc()
            self._last_bucket = pick
            group = []
            rest = []
            while self._queue:
                r = self._queue.popleft()
                if len(group) < self.max_batch \
                        and self._bucket(r) == pick:
                    group.append(r)
                else:
                    rest.append(r)
            self._queue.extend(rest)
            for r in group:
                r.status = RUNNING
                self._inflight.append(r)
            self._processing += len(group)
            self._tel.gauge("serve.queue_depth").set(len(self._queue))
        return group

    def _process_group(self, group):
        self._dispatches += 1
        self.last_dispatch = time.monotonic()
        # chaos: each dispatched group is one "step" (crash/hang from
        # step N on, replica_crash from dispatch N on); crash_at_iter
        # counts dispatches and fires EXACTLY once — the
        # restart-and-recover test shape; slow_replica sleeps here
        self._chaos.pre_dispatch()
        self._chaos.step_tick()
        self._chaos.hub_iter_tick(self._dispatches)
        self._tel.histogram("serve.batch_size").observe(len(group))
        try:
            with self._tel.span("serve.dispatch", batch=len(group)):
                self._execute_group(group)
        except ChaosError:
            raise
        except Exception as exc:     # model/solver bug: fail the group,
            for req in group:        # keep the service alive
                self._finish(req, failed_result(req.id, repr(exc)))
        # no inflight cleanup here: _finish_locked removes each request
        # as it reaches a terminal state, and a ChaosError propagating
        # past this frame MUST leave the group in _inflight so the
        # crash handler can requeue it

    def _on_worker_crash(self, exc):
        global_toc(f"WARNING: serve dispatch worker crashed: {exc!r}")
        self._tel.event("serve.worker_crash", error=repr(exc))
        with self._lock:
            suspect = self._executing
            self._executing = None
            if suspect is not None:
                self.crash_suspects.add(suspect)
            for req in list(self._inflight):
                # the ATTEMPT budget is charged only to the request the
                # worker was executing (the precise suspect) — innocents
                # coalesced into the group requeue freely; the restart
                # budget still bounds total crashes either way
                if req.id == suspect:
                    req.attempts += 1
                if req.attempts >= self.max_attempts:
                    self._finish_locked(req, failed_result(
                        req.id, f"worker crashed ({exc!r}) and the "
                                f"attempt budget ({self.max_attempts}) "
                                f"is spent", attempts=req.attempts))
                else:
                    self._processing -= 1
                    req.status = QUEUED
                    self._inflight.remove(req)
                    self._queue.appendleft(req)
            exhausted = self.restarts >= self.max_restarts
            if exhausted:
                self._failed = (f"worker crashed {self.restarts + 1} "
                                f"times (restart budget "
                                f"{self.max_restarts}): {exc!r}")
                for req in list(self._queue):
                    self._finish_locked(
                        req, failed_result(req.id, self._failed))
                self._queue.clear()
            else:
                self.restarts += 1
        if exhausted:
            self._tel.event("serve.worker_prune", error=repr(exc))
            global_toc(f"WARNING: serve service FAILED: {self._failed}")
            return
        delay = restart_delay(self.restarts, self.backoff,
                              self.backoff_cap)
        self._tel.counter("serve.worker_restarts").inc()
        self._tel.event("serve.worker_restart", incarnation=self.restarts,
                        delay=delay)
        global_toc(f"WARNING: serve worker restart "
                   f"{self.restarts}/{self.max_restarts} in {delay:.2f}s")
        time.sleep(delay)
        with self._lock:
            if self._stopped:
                return
        self._spawn_worker()

    # -- execution --------------------------------------------------------
    def _build_ph(self, req):
        from ..opt.ph import PH
        names = req.scenario_names
        if names is None:
            names = [f"scen{i}" for i in range(req.batch.num_scens)]
        return PH(dict(req.options), list(names), batch=req.batch,
                  device=self.device)

    def _execute_group(self, group):
        # serialize device execution across in-process services that
        # share one device (see _BACKEND_LOCK above); a crash
        # (ChaosError, poison) unwinding through here releases it
        with self._backend_lock:
            self._execute_group_locked(group)

    def _execute_group_locked(self, group):
        live = []
        for req in group:
            if req.expired():
                self._finish(req, timeout_result(req, where="dispatch"))
                continue
            self._executing = req.id   # precise poison attribution
            # poison_request chaos: raising HERE (not inside the try)
            # makes the poison a worker crash — exactly what a
            # deterministically-lethal request does to a real replica
            self._chaos.request_tick(req.options)
            try:
                with self._tel.span("serve.request", request=req.id):
                    ph = self._build_ph(req)
                    engine = self.cache.get(req.batch, req.options,
                                            model=req.model,
                                            backend=self.device.type)
                    ph.Iter0()
            except Exception as exc:  # e.g. certified-infeasible iter0
                self._finish(req, failed_result(req.id, repr(exc)))
                continue
            finally:
                self._executing = None
            live.append((req, ph))
        if not live:
            return
        if len(live) == 1:
            req, ph = live[0]
            self._executing = req.id
            try:
                self._run_single(req, ph)
            finally:
                self._executing = None
        else:
            # batched lockstep: a crash here is ambiguous (every
            # request is executing) — charge nobody
            self._run_batched(live, engine)

    def _run_single(self, req, ph):
        """One request: the standalone PH path itself.  `iterk_loop`
        drives the same superstep `PH.ph_main` runs, so this result is
        bitwise equal to a standalone run (tests/test_torch_serve_*).
        A deadline swaps in an equivalent loop with a per-iteration
        clock check."""
        if req.deadline is None:
            ph.iterk_loop()
        else:
            max_iters = int(ph.options.get("PHIterLimit", 100))
            convthresh = float(ph.options.get("convthresh", 1e-4))
            for k in range(int(ph.state.it) + 1, max_iters + 1):
                if req.expired():
                    self._finish(req, timeout_result(
                        req, where="iteration",
                        iterations=int(ph.state.it), conv=ph.conv))
                    return
                if ph.ph_iteration() < convthresh:
                    break
        self._finish_ok(req, ph)

    def _run_batched(self, live, engine):
        """Coalesced same-bucket requests in one group superstep,
        lockstep; each request leaves the group (its state taken out)
        at ITS stopping iteration, with its own iteration count and
        conv.  Requests that cannot share a solve run one by one."""
        import dataclasses

        from ..phbase import GroupRefused, unstack_state

        reqs = [req for req, _ in live]
        phs = [ph for _, ph in live]
        try:
            args = stack_superstep_args(phs)
        except GroupRefused as exc:
            global_toc(f"serve: group of {len(phs)} runs one by one "
                       f"({exc})")
            for req, ph in live:
                self._executing = req.id
                try:
                    self._run_single(req, ph)
                finally:
                    self._executing = None
            return
        exe = engine.batched_superstep(args)
        S = args.S
        limits = [int(ph.options.get("PHIterLimit", 100)) for ph in phs]
        threshes = [float(ph.options.get("convthresh", 1e-4))
                    for ph in phs]
        iters = [int(ph.state.it) for ph in phs]
        active = set(range(len(phs)))
        while active:
            state = exe(args)
            args = dataclasses.replace(args, state=state)
            convs = state.conv.tolist()
            now = time.monotonic()
            for i in sorted(active):
                iters[i] += 1
                req, ph = reqs[i], phs[i]
                if convs[i] < threshes[i] or iters[i] >= limits[i]:
                    ph.state = unstack_state(state, i, S)
                    ph.conv = float(convs[i])
                    active.discard(i)
                    self._finish_ok(req, ph)
                elif req.deadline is not None and now > req.deadline:
                    active.discard(i)
                    self._finish(req, timeout_result(
                        req, where="iteration", iterations=iters[i],
                        conv=float(convs[i])))

    def _finish_ok(self, req, ph):
        res = ph.solution_dict()
        res["status"] = OK
        res["request_id"] = req.id
        res["wall_s"] = time.monotonic() - req.submitted
        self._finish(req, res)
