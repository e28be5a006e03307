"""Router — the replica-set front door for the serve layer (a copy of
`mpisppy_tpu/serve/router.py`, with a `device` argument).

A torch-free traffic layer over `replica.ReplicaSet`: clients talk to
the router, the router talks to N supervised SolverService replicas
(each its own fault domain), and every production-robustness decision
lives here, above the solver:

  * **health-probed circuit breakers** — a three-state breaker per
    SLOT (closed / open / half-open), fed by the replica's telemetry
    counters through `SolverService.health()` (queue depth,
    last-dispatch age, terminal failure).  An open breaker sheds
    traffic; reopen probes follow the shared capped-backoff policy
    (`resilience.restart_delay`), and the breaker outlives the replica
    it judged: a replacement replica starts behind the still-open
    breaker and must pass a half-open probe to close it.
  * **hedged retries** — a request sitting unresolved past
    `router_hedge_threshold` is resubmitted to a second replica.
    Idempotency keys make this safe: duplicate completions resolve to
    ONE client result (first completion wins; the late twin is counted
    in `router.duplicate_completions`, never delivered).
  * **per-tenant token-bucket quotas** — `router_tenant_rate` /
    `router_tenant_burst` admission, structured `over_quota` rejects.
  * **brownout ladder** — sustained overload degrades in steps
    instead of collapsing: level 1 sheds hedges, level 2 widens the
    solve tolerance of ADMITTED requests (convthresh x factor + the
    `eps_ladder` knobs — same compile bucket, looser answers),
    level 3 rejects the lowest-priority tenants.  Every transition is
    a `router.brownout` telemetry event.
  * **replace-and-replay** — a failed replica is drained
    (`drain(deadline=)`, leftovers checkpointed), a fresh incarnation
    is started and `warm_from`s the checkpoint, and every unresolved
    request that was on the corpse is replayed through the idempotency
    table.  A **poison budget** stops hedge amplification: a request
    that was dispatched at `router_poison_budget` worker crashes is
    quarantined (structured `failed`/`quarantined` result) instead of
    being replayed into the next replica.

Layering (checked in tests/test_torch_no_jax.py): this module never
imports torch at module level — the router is pure Python over the
replica API, so the front door can run in a process that starts no
CUDA context until a replica dispatches.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import tempfile
import threading
import time
from typing import Any

from .. import global_toc
from .. import telemetry as _telemetry
from ..resilience.supervisor import restart_delay
from .request import (FAILED, OK, QUEUED, RUNNING, TIMEOUT,
                      RouterHandle, failed_result, rejected_result)

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class TokenBucket:
    """Per-tenant admission quota: `burst` tokens refilled at `rate`
    per second; one token per admitted request."""

    def __init__(self, rate, burst):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.stamp = time.monotonic()

    def take(self, now=None):
        now = time.monotonic() if now is None else now
        # clamp: a `now` captured before this bucket was lazily created
        # must not debit the fresh burst (negative elapsed)
        self.tokens = min(self.burst, self.tokens
                          + max(0.0, now - self.stamp) * self.rate)
        self.stamp = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class CircuitBreaker:
    """Three-state breaker for one replica SLOT.

    closed --[fail_threshold consecutive probe/request failures]--> open
    open   --[capped-backoff reopen timer]--> half_open
    half_open --[success]--> closed   /   --[failure]--> open (longer)

    The reopen backoff reuses the shared restart-pacing policy
    (`resilience.restart_delay`) keyed on how many times this slot has
    tripped, so a flapping replica earns progressively longer time-outs
    up to the cap."""

    def __init__(self, fail_threshold=3, backoff=0.25, backoff_cap=5.0,
                 on_transition=None):
        self.fail_threshold = int(fail_threshold)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.state = CLOSED
        self.failures = 0
        self.opens = 0                 # lifetime transitions to OPEN
        self.reopen_at = 0.0
        self.transitions = [(CLOSED, time.monotonic())]
        self._notify = on_transition or (lambda old, new: None)

    def _to(self, state, now):
        if state == self.state:
            return
        old, self.state = self.state, state
        self.transitions.append((state, now))
        self._notify(old, state)

    def allow(self, now=None):
        """May traffic flow to this slot right now?  Also advances
        open -> half_open when the reopen timer expires (the caller's
        probe/routing attempt IS the reopen probe)."""
        now = time.monotonic() if now is None else now
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if now >= self.reopen_at:
                self._to(HALF_OPEN, now)
                return True
            return False
        return True                    # HALF_OPEN: probes flow

    def record_success(self, now=None):
        now = time.monotonic() if now is None else now
        self.failures = 0
        if self.state == HALF_OPEN:
            self._to(CLOSED, now)

    def record_failure(self, now=None):
        now = time.monotonic() if now is None else now
        self.failures += 1
        if self.state == HALF_OPEN or (self.state == CLOSED
                                       and self.failures
                                       >= self.fail_threshold):
            self.trip(now)

    def trip(self, now=None):
        """Open immediately (replica death skips the failure count)."""
        now = time.monotonic() if now is None else now
        if self.state != OPEN:
            self.opens += 1
            self.reopen_at = now + restart_delay(
                self.opens, self.backoff, self.backoff_cap)
            self._to(OPEN, now)
        self.failures = 0

    def states_seen(self):
        return [s for s, _ in self.transitions]


@dataclasses.dataclass
class RouterRequest:
    """One client request in the router's table — possibly backed by
    several inner service requests over its life (hedge, replay,
    warm_from adoption)."""
    rid: int
    key: str                        # idempotency key (auto when absent)
    batch: Any
    options: dict
    scenario_names: Any
    model: str | None
    tenant: str
    priority: int
    deadline: float | None          # absolute monotonic
    submitted: float
    handles: list = dataclasses.field(default_factory=list)
    attempts: int = 0               # routings consumed
    hedged: bool = False
    hedge_shed: bool = False        # a brownout suppressed its hedge
    crash_count: int = 0            # worker crashes it was dispatched at
    status: str = QUEUED
    result: dict | None = None
    completions: int = 0            # terminal inner completions seen
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def expired(self, now):
        return self.deadline is not None and now > self.deadline


class Router:
    """The replica-set front door (see module docstring).

    Options (all prefixed `router_` unless noted):
      serve_replicas              replica count                    (2)
      router_hedge_threshold      seconds before hedging (None=off)(0.5)
      router_max_attempts         routings per request             (3)
      router_poison_budget        crashes before quarantine        (1)
      router_tenant_rate          tokens/s per tenant (None=off)   (None)
      router_tenant_burst         bucket depth                     (8)
      router_tick                 monitor loop period seconds      (0.02)
      router_probe_interval       health-probe period seconds      (0.05)
      router_breaker_failures     consecutive fails to open        (3)
      router_breaker_backoff(_cap) reopen probe pacing         (0.25/5)
      router_breaker_queue_depth  probe-fail queue depth           (64)
      router_breaker_stall_s      probe-fail dispatch age          (30)
      router_replace_stall_s      stalled-this-long => replace     (120)
      router_drain_deadline       corpse drain budget seconds      (1.0)
      router_result_timeout/grace result() bounds             (600/30)
      router_brownout_high/low    load fractions (escalate/relax) (.75/.25)
      router_brownout_sustain     consecutive evals to move        (2)
      router_brownout_interval    eval period seconds              (0.25)
      router_brownout_conv_factor level-2 convthresh widening      (10)
      router_brownout_min_priority level-3 admission floor         (1)
      router_checkpoint_dir       drain checkpoint dir         (tmpdir)
      serve_replica_mode          "thread" | "process"        ("thread")
      serve_device                the replicas' device     (the card)
    plus every serve_* key, forwarded to each replica's service.
    In "process" mode each slot is its own OS process
    (serve/procpool.py) — device execution parallelizes past the
    in-process `_BACKEND_LOCK`; everything above the replica surface
    (breakers, hedging, quotas, brownout, replace-and-replay, roll)
    is mode-blind."""

    def __init__(self, options=None, replica_set=None, device=None):
        o = dict(options or {})
        if device is not None:
            # the replicas' device (default: the CUDA device); a string
            # so that it crosses into process replicas' configs
            o["serve_device"] = str(device)
        self.options = o
        self.hedge_threshold = o.get("router_hedge_threshold", 0.5)
        self.max_attempts = int(o.get("router_max_attempts", 3))
        self.poison_budget = int(o.get("router_poison_budget", 1))
        self.tenant_rate = o.get("router_tenant_rate")
        self.tenant_burst = float(o.get("router_tenant_burst", 8))
        self.tick_interval = float(o.get("router_tick", 0.02))
        self.probe_interval = float(o.get("router_probe_interval", 0.05))
        self.breaker_failures = int(o.get("router_breaker_failures", 3))
        self.breaker_backoff = float(o.get("router_breaker_backoff", 0.25))
        self.breaker_backoff_cap = float(
            o.get("router_breaker_backoff_cap", 5.0))
        self.breaker_queue_depth = int(
            o.get("router_breaker_queue_depth", 64))
        self.breaker_stall_s = float(o.get("router_breaker_stall_s", 30.0))
        self.replace_stall_s = float(o.get("router_replace_stall_s", 120.0))
        self.drain_deadline = float(o.get("router_drain_deadline", 1.0))
        self.result_timeout = float(o.get("router_result_timeout", 600.0))
        self.result_grace = float(o.get("router_result_grace", 30.0))
        self.brownout_high = float(o.get("router_brownout_high", 0.75))
        self.brownout_low = float(o.get("router_brownout_low", 0.25))
        self.brownout_sustain = int(o.get("router_brownout_sustain", 2))
        self.brownout_interval = float(
            o.get("router_brownout_interval", 0.25))
        self.brownout_conv_factor = float(
            o.get("router_brownout_conv_factor", 10.0))
        self.brownout_min_priority = int(
            o.get("router_brownout_min_priority", 1))
        self.max_inflight = int(o.get("serve_max_inflight", 32))
        self._workdir = o.get("router_checkpoint_dir")
        self._tel = _telemetry.configure_from_options(o.get("telemetry"))
        if replica_set is None:
            mode = o.get("serve_replica_mode", "thread")
            if mode == "process":
                from .procpool import ProcReplicaSet
                replica_set = ProcReplicaSet(o)
            elif mode == "thread":
                from .replica import ReplicaSet
                replica_set = ReplicaSet(o)
            else:
                raise ValueError(
                    "serve_replica_mode must be 'thread' or "
                    f"'process', got {mode!r}")
        self.replica_set = replica_set
        self.breakers = [
            CircuitBreaker(self.breaker_failures, self.breaker_backoff,
                           self.breaker_backoff_cap,
                           on_transition=self._breaker_event(slot))
            for slot in range(len(replica_set))]
        self.brownout_level = 0
        self.brownout_transitions = []         # (level, monotonic)
        self._brownout_streak = 0
        self._last_brownout_eval = 0.0
        self._last_probe = 0.0
        self._lock = threading.RLock()
        self._replace_lock = threading.Lock()  # serialize _replace_slot
        self._rids = itertools.count(1)
        self._requests = {}            # rid -> RouterRequest (all)
        self._open = {}                # rid -> RouterRequest (unresolved)
        self._lingering = {}           # resolved but hedge-twin pending
        self._idempotency = {}         # key -> rid
        self._buckets = {}             # tenant -> TokenBucket
        self._suspects_seen = {}       # replica name -> counted ids
        self._starvation_seen = {}     # replica name -> counted total
        self._rr_offset = 0            # rotates equal-load pick ties
        self.counts = {}               # plain-int mirror of counters
        self.latencies = []            # ok-result router wall seconds
        self._monitor = None
        self._stopped = False
        self._started = False

    # -- small helpers ----------------------------------------------------
    def _count(self, name, n=1):
        self.counts[name] = self.counts.get(name, 0) + n
        self._tel.counter(f"router.{name}").inc(n)

    def _breaker_event(self, slot):
        def notify(old, new):
            self._tel.event("router.breaker", slot=slot, old=old, new=new)
            if new == OPEN:
                self._count("breaker_opens")
        return notify

    @property
    def workdir(self):
        if self._workdir is None:
            self._workdir = tempfile.mkdtemp(prefix="mpisppy_router_")
        return self._workdir

    # -- lifecycle --------------------------------------------------------
    def start(self):
        with self._lock:
            if self._started or self._stopped:
                return self
            self._started = True
        self.replica_set.start()
        t = threading.Thread(target=self._monitor_main,
                             name="serve-router", daemon=True)
        self._monitor = t
        t.start()
        return self

    def shutdown(self, timeout=30.0):
        with self._lock:
            self._stopped = True
        m = self._monitor
        if m is not None and m.is_alive():
            m.join(timeout)
        self.replica_set.shutdown(timeout=timeout)
        with self._lock:
            for rreq in list(self._open.values()):
                self._resolve_locked(
                    rreq, rejected_result(rreq.rid, "shutdown"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    # -- client API -------------------------------------------------------
    def submit(self, batch, options=None, scenario_names=None,
               deadline=None, model=None, tenant="default", priority=1,
               idempotency_key=None):
        """Enqueue one solve; returns a RouterHandle immediately.
        Rejections (over_quota, brownout_shed, shutdown, no_replica)
        are structured results, never exceptions or blocks.  A repeat
        `idempotency_key` returns the ORIGINAL request's handle — the
        dedup half of the exactly-once contract."""
        self.start()
        now = time.monotonic()
        with self._lock:
            if idempotency_key is not None \
                    and idempotency_key in self._idempotency:
                return RouterHandle(self._idempotency[idempotency_key])
            rid = next(self._rids)
            key = idempotency_key if idempotency_key is not None \
                else f"_auto{rid}"
            opts = dict(options or {})
            if self.brownout_level >= 2:
                opts = self._degrade_options(opts)
                self._count("degraded_requests")
            rreq = RouterRequest(
                rid=rid, key=key, batch=batch, options=opts,
                scenario_names=scenario_names, model=model,
                tenant=str(tenant), priority=int(priority),
                deadline=(now + float(deadline)) if deadline is not None
                else None,
                submitted=now)
            self._requests[rid] = rreq
            self._idempotency[key] = rid
            reason = None
            if self._stopped:
                reason = "shutdown"
            elif self.brownout_level >= 3 \
                    and rreq.priority < self.brownout_min_priority:
                reason = "brownout_shed"
                self._count("shed_requests")
            elif not self._admit_tenant(rreq.tenant, now):
                reason = "over_quota"
                self._count("over_quota")
            if reason is not None:
                self._resolve_locked(
                    rreq, rejected_result(rid, reason))
                return RouterHandle(rid)
            self._count("requests_submitted")
        # route BEFORE exposing the request to the monitor's scan: a
        # wire submit takes milliseconds, and a scan tick landing in
        # that window would see an empty handle list and "replay" a
        # request that was never routed — a duplicate execution
        self._route(rreq)
        with self._lock:
            if not rreq.done.is_set():
                self._open[rid] = rreq
        return RouterHandle(rid)

    def poll(self, handle):
        with self._lock:
            rreq = self._requests.get(handle.id)
            if rreq is None:
                return "unknown"
            if rreq.done.is_set():
                return rreq.status
        for replica, h in list(rreq.handles):
            if replica.poll(h) == RUNNING:
                return RUNNING
        return QUEUED

    def result(self, handle, timeout=None):
        """Block for the result — ALWAYS time-bounded, mirroring
        SolverService.result: by `timeout`, else the request deadline +
        grace, else router_result_timeout."""
        rreq = self._requests.get(handle.id)
        if rreq is None:
            return {"status": "unknown", "request_id": handle.id}
        if timeout is None:
            if rreq.deadline is not None:
                timeout = max(rreq.deadline - time.monotonic(), 0.0) \
                    + self.result_grace
            else:
                timeout = self.result_timeout
        if not rreq.done.wait(timeout):
            return {"status": TIMEOUT, "request_id": rreq.rid,
                    "where": "router_wait",
                    "wall_s": time.monotonic() - rreq.submitted}
        return rreq.result

    def solve(self, batch, options=None, **kwargs):
        timeout = kwargs.pop("timeout", None)
        h = self.submit(batch, options, **kwargs)
        return self.result(h, timeout=timeout)

    # -- admission --------------------------------------------------------
    def _admit_tenant(self, tenant, now):
        if self.tenant_rate is None:
            return True
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = self._buckets[tenant] = TokenBucket(
                self.tenant_rate, self.tenant_burst)
        return bucket.take(now)

    def _degrade_options(self, opts):
        """Brownout level >= 2: widen the solve tolerances of admitted
        requests.  convthresh scales by the brownout factor and the
        eps-ladder is engaged with loose knobs — both are
        host-side / traced-eps paths, so the degraded request stays in
        the SAME compile bucket as its full-accuracy twin."""
        o = dict(opts)
        o["convthresh"] = (float(o.get("convthresh", 1e-4))
                           * self.brownout_conv_factor)
        lad = o.get("eps_ladder")
        lad = dict(lad) if isinstance(lad, dict) else {}
        lad.setdefault("start", 1e-2)
        lad.setdefault("min", 1e-4)
        lad.setdefault("couple", 0.2)
        o["eps_ladder"] = lad
        return o

    # -- routing ----------------------------------------------------------
    def _pick_slot(self, exclude=()):
        """Deadline-aware least-loaded routing over allowed slots:
        breakers gate admission per slot, then the shallowest
        queue+inflight wins (the request waits the least there).
        Equal loads round-robin via a rotating scan offset — a fixed
        tie-break would dump every burst on slot 0, and uneven splits
        dispatch odd-width groups downstream (each width its own
        trace)."""
        now = time.monotonic()
        n = len(self.replica_set)
        with self._lock:
            off = self._rr_offset
            self._rr_offset = (off + 1) % max(n, 1)
        best, best_load = None, None
        for i in range(n):
            slot = (off + i) % n
            replica = self.replica_set[slot]
            if slot in exclude or replica.condemned or replica.failed:
                continue
            if not self.breakers[slot].allow(now):
                continue
            h = replica.health()
            load = h["queue_depth"] + h["inflight"]
            if best is None or load < best_load:
                best, best_load = slot, load
        return best

    def _route(self, rreq, exclude=(), hedge=False):
        """Submit (or resubmit) a router request to a replica.  Returns
        True when a slot accepted it; False leaves the request with its
        existing handles (the monitor retries next tick or resolves).
        Hedges do NOT consume the attempt budget — `attempts` bounds
        failure-driven replays (the ping-pong guard), and charging
        hedges against it would make an innocent request that hedged
        once unreplayable after a single crash-victim failure."""
        slot = self._pick_slot(exclude)
        if slot is None:
            return False
        replica = self.replica_set[slot]
        inner_deadline = None
        if rreq.deadline is not None:
            inner_deadline = max(rreq.deadline - time.monotonic(), 0.01)
        h = replica.submit(rreq.batch, rreq.options,
                           scenario_names=rreq.scenario_names,
                           deadline=inner_deadline, model=rreq.model)
        with self._lock:
            if not hedge:
                rreq.attempts += 1
            rreq.handles.append((replica, h))
            replica.assigned[h.id] = rreq.rid
        self._tel.event("router.route", request=rreq.rid,
                        replica=replica.name, hedge=hedge)
        return True

    # -- completion -------------------------------------------------------
    def _resolve_locked(self, rreq, res, replica=None):
        if rreq.done.is_set():
            self._count("duplicate_completions")
            return False
        res = dict(res)
        res["request_id"] = rreq.rid
        res["router_wall_s"] = time.monotonic() - rreq.submitted
        if replica is not None:
            res["replica"] = replica.name
        rreq.result = res
        rreq.status = res["status"]
        rreq.done.set()
        self._open.pop(rreq.rid, None)
        if rreq.handles:
            # hedge twins may still complete later: keep watching them
            # so duplicate completions are observed and counted
            self._lingering[rreq.rid] = rreq
        self._count(f"requests_{res['status']}")
        if res["status"] == OK:
            self.latencies.append(res["router_wall_s"])
        self._tel.event("router.done", request=rreq.rid,
                        status=res["status"])
        return True

    def _resolve(self, rreq, res, replica=None):
        with self._lock:
            return self._resolve_locked(rreq, res, replica)

    # -- monitor thread ---------------------------------------------------
    def _monitor_main(self):
        while True:
            with self._lock:
                if self._stopped:
                    return
            try:
                now = time.monotonic()
                self._probe_replicas(now)
                self._scan_requests(now)
                self._eval_brownout(now)
            except Exception as exc:   # pragma: no cover - belt+braces
                global_toc(f"WARNING: router monitor error: {exc!r}")
                self._tel.event("router.monitor_error", error=repr(exc))
            time.sleep(self.tick_interval)

    def _probe_replicas(self, now):
        if now - self._last_probe < self.probe_interval:
            return
        self._last_probe = now
        live = 0
        for slot, replica in enumerate(self.replica_set):
            br = self.breakers[slot]
            br.allow(now)              # advance open -> half_open
            if replica.condemned:
                continue
            h = replica.health()
            self._attribute_crashes(replica, h["crash_suspects"])
            self._note_starvation(replica, h)
            if h["failed"] is not None:
                br.trip(now)
                self._replace_slot(slot, reason=h["failed"])
                continue
            live += 1
            unhealthy = (
                h["queue_depth"] > self.breaker_queue_depth
                or (h["queue_depth"] > 0
                    and h["last_dispatch_age"] > self.breaker_stall_s))
            if unhealthy:
                br.record_failure(now)
            else:
                br.record_success(now)
            if h["queue_depth"] > 0 \
                    and h["last_dispatch_age"] > self.replace_stall_s:
                br.trip(now)
                self._replace_slot(
                    slot, reason=f"stalled {h['last_dispatch_age']:.1f}s")
        self._tel.gauge("router.replicas_live").set(live)

    def _note_starvation(self, replica, h):
        """Roll each replica's DRR rotation count (service-side
        `bucket_starvation`: dispatches where a colder bucket jumped
        the queue head) into the router-level `bucket_starvation`
        counter — deltas per replica NAME, so a replacement's fresh
        zero doesn't rewind the aggregate."""
        cur = int(h.get("bucket_starvation", 0) or 0)
        prev = self._starvation_seen.get(replica.name, 0)
        if cur > prev:
            self._count("bucket_starvation", cur - prev)
        self._starvation_seen[replica.name] = max(cur, prev)

    def _attribute_crashes(self, replica, suspects):
        """Feed a replica's crash_suspects (inner ids whose OWN
        execution killed the worker — service-side precise attribution)
        into router-request crash counts; a request charged with
        `poison_budget` crashes is quarantined: resolved with a
        structured failure, never hedged or replayed again."""
        with self._lock:
            seen = self._suspects_seen.setdefault(replica.name, set())
            fresh = set(suspects) - seen
            seen |= fresh
            for inner_id in fresh:
                rid = replica.assigned.get(inner_id)
                rreq = self._open.get(rid)
                if rreq is None:
                    continue
                rreq.crash_count += 1
                if rreq.crash_count >= self.poison_budget:
                    self._count("quarantined")
                    self._tel.event("router.quarantine", request=rid,
                                    crashes=rreq.crash_count)
                    self._resolve_locked(rreq, failed_result(
                        rid, "quarantined: this request's own "
                             f"execution crashed {rreq.crash_count} "
                             "worker(s) (poison budget "
                             f"{self.poison_budget})"))

    def _replace_slot(self, slot, reason=""):
        """The corpse path: quarantine poison suspects, drain the dead
        replica (leftovers checkpointed), start a fresh incarnation
        warmed from the checkpoint, adopt the warmed handles, and let
        the scan replay whatever is left without a live handle.
        Serialized across threads (monitor vs. roll()): a slot already
        condemned by the other caller is skipped, not replaced twice."""
        with self._replace_lock:
            return self._replace_slot_locked(slot, reason)

    def _replace_slot_locked(self, slot, reason=""):
        corpse = self.replica_set[slot]
        if corpse.condemned:
            return
        corpse.condemned = True
        self._tel.event("router.replica_down", slot=slot,
                        replica=corpse.name, reason=str(reason)[:500])
        global_toc(f"WARNING: router replacing replica {corpse.name}: "
                   f"{reason}")
        # poison attribution BEFORE replay: a quarantined request is
        # resolved here and never reaches the warm_from/re-route path
        self._attribute_crashes(corpse, corpse.health()["crash_suspects"])
        ckpt = os.path.join(self.workdir,
                            f"drain_{corpse.name}")
        fresh, drain_info, adopted = self.replica_set.replace(
            slot, drain_deadline=self.drain_deadline,
            checkpoint_path=ckpt)
        self._count("replica_restarts")
        self._tel.event("router.replica_replaced", slot=slot,
                        corpse=corpse.name, fresh=fresh.name,
                        drained=drain_info.get("drained", 0),
                        adopted=len(adopted))
        with self._lock:
            # re-bind warm_from resubmissions to their router requests
            for old_inner_id, new_h in adopted:
                rid = corpse.assigned.get(old_inner_id)
                rreq = self._open.get(rid)
                if rreq is None:
                    continue
                rreq.handles.append((fresh, new_h))
                fresh.assigned[new_h.id] = rid
            # drop every corpse handle; requests left bare get
            # re-routed by the scan (the replay half of exactly-once)
            for rreq in list(self._open.values()):
                rreq.handles = [(r, h) for r, h in rreq.handles
                                if r is not corpse]

    def roll(self, reason="rolling_restart", on_slot=None):
        """Zero-downtime rolling restart: condemn ONE slot at a time
        through the replace-and-replay machinery while the peers absorb
        traffic — in-flight requests on the condemned replica survive
        via warm_from adoption, bare-handle replay, and the idempotency
        table (re-submission of an already-rolled key returns the
        original handle).  Waits for each fresh incarnation to report
        healthy before condemning the next peer, so the set is never
        more than one replica down.  Returns the number of replicas
        replaced; counts `rolled_replicas` per slot."""
        self.start()
        rolled = 0
        for slot in range(len(self.replica_set)):
            self._replace_slot(slot, reason=reason)
            fresh = self.replica_set[slot]
            end = time.monotonic() + self.drain_deadline + 10.0
            while time.monotonic() < end:
                if fresh.health()["failed"] is None:
                    break
                time.sleep(self.tick_interval)
            rolled += 1
            self._count("rolled_replicas")
            self._tel.event("router.rolled_slot", slot=slot,
                            fresh=fresh.name)
            if on_slot is not None:
                on_slot(slot, fresh.name)
        return rolled

    def _scan_requests(self, now):
        with self._lock:
            open_reqs = list(self._open.values())
            lingering = list(self._lingering.values())
        for rreq in open_reqs:
            if rreq.done.is_set():
                continue
            self._scan_one(rreq, now)
        for rreq in lingering:
            self._scan_lingering(rreq)

    def _scan_one(self, rreq, now):
        for replica, h in list(rreq.handles):
            res = replica.peek(h)
            if res is None:
                continue
            st = res["status"]
            if st in (OK, TIMEOUT):
                if self._resolve(rreq, res, replica):
                    self.breakers[replica.slot].record_success(now)
                return
            # FAILED / REJECTED from a condemned replica: the
            # replacement path owns the replay — just drop the handle
            with self._lock:
                rreq.handles.remove((replica, h))
            if replica.condemned or replica.failed:
                continue
            if st == FAILED:
                self.breakers[replica.slot].record_failure(now)
            if rreq.attempts >= self.max_attempts:
                self._resolve(rreq, res, replica)
                return
        # deadline sweep: a request whose clock ran out while bouncing
        # between replicas resolves here instead of spinning forever
        if rreq.expired(now):
            self._resolve(rreq, {"status": TIMEOUT,
                                 "request_id": rreq.rid,
                                 "where": "router_deadline"})
            return
        if not rreq.handles:
            # replay: no live handle (replica died, or a healthy
            # replica failed/rejected it and attempts remain)
            if rreq.crash_count >= self.poison_budget:
                self._resolve(rreq, failed_result(
                    rreq.rid, "quarantined"))
                return
            if rreq.attempts >= self.max_attempts:
                self._resolve(rreq, failed_result(
                    rreq.rid, f"no replica could complete the request "
                              f"in {rreq.attempts} attempts"))
                return
            if self._route(rreq):
                self._count("replayed_requests")
            return
        self._maybe_hedge(rreq, now)

    def _maybe_hedge(self, rreq, now):
        if self.hedge_threshold is None or rreq.hedged \
                or len(rreq.handles) != 1 \
                or now - rreq.submitted <= float(self.hedge_threshold):
            return
        if self.brownout_level >= 1:
            if not rreq.hedge_shed:
                rreq.hedge_shed = True
                self._count("shed_hedges")
            return
        used = {replica.slot for replica, _ in rreq.handles}
        if self._route(rreq, exclude=used, hedge=True):
            rreq.hedged = True
            self._count("hedged_requests")

    def _scan_lingering(self, rreq):
        """Watch a resolved request's leftover hedge twins so duplicate
        completions are observed (and only counted, never delivered)."""
        for replica, h in list(rreq.handles):
            status = replica.poll(h)
            if status in (QUEUED, RUNNING):
                continue
            with self._lock:
                rreq.handles.remove((replica, h))
                if status == OK:
                    self._count("duplicate_completions")
        if not rreq.handles:
            with self._lock:
                self._lingering.pop(rreq.rid, None)

    # -- brownout ladder --------------------------------------------------
    def _eval_brownout(self, now):
        if now - self._last_brownout_eval < self.brownout_interval:
            return
        self._last_brownout_eval = now
        live = sum(1 for r in self.replica_set
                   if not (r.condemned or r.failed))
        capacity = max(1, live) * self.max_inflight
        with self._lock:
            load = len(self._open)
        frac = load / capacity
        if frac >= self.brownout_high:
            self._brownout_streak = max(1, self._brownout_streak + 1)
        elif frac <= self.brownout_low:
            self._brownout_streak = min(-1, self._brownout_streak - 1)
        else:
            self._brownout_streak = 0
        new = self.brownout_level
        if self._brownout_streak >= self.brownout_sustain \
                and self.brownout_level < 3:
            new = self.brownout_level + 1
        elif self._brownout_streak <= -self.brownout_sustain \
                and self.brownout_level > 0:
            new = self.brownout_level - 1
        if new != self.brownout_level:
            old, self.brownout_level = self.brownout_level, new
            self._brownout_streak = 0
            self.brownout_transitions.append((new, now))
            self._tel.event("router.brownout", old=old, new=new,
                            load_fraction=round(frac, 4))
            self._tel.gauge("router.brownout_level").set(new)
            global_toc(f"router brownout level {old} -> {new} "
                       f"(load {frac:.2f})")

    # -- introspection ----------------------------------------------------
    def latency_percentiles(self):
        """{p50, p99} over resolved-ok router wall times (None/None
        when nothing completed)."""
        with self._lock:
            lat = sorted(self.latencies)
        if not lat:
            return {"p50": None, "p99": None}
        def pct(p):
            i = min(len(lat) - 1, int(round(p * (len(lat) - 1))))
            return lat[i]
        return {"p50": pct(0.50), "p99": pct(0.99)}

    def _cache_stats_dicts(self):
        """Per-replica CompileCache stats through the duck-typed
        `cache_stats()` surface — works for thread replicas (a direct
        stats() call) and process replicas (the last health-reported
        dict) alike; a replica without the surface contributes
        nothing."""
        out = []
        for r in self.replica_set:
            fn = getattr(r, "cache_stats", None)
            if fn is None:
                continue
            try:
                out.append(fn())
            except Exception:          # pragma: no cover - dead worker
                out.append({})
        return out

    def stats(self):
        """One structured snapshot for tests / bench: counters,
        breaker state machines, brownout history, latencies."""
        from .compile_cache import merged_stats_dicts
        with self._lock:
            counts = dict(self.counts)
        extra = {}
        boot = getattr(self.replica_set, "boot_stats", None)
        if boot is not None:
            extra = boot()
        return {
            "counts": counts,
            "compile_cache": merged_stats_dicts(
                self._cache_stats_dicts()),
            "breakers": [{"slot": i, "state": b.state,
                          "opens": b.opens,
                          "states_seen": b.states_seen()}
                         for i, b in enumerate(self.breakers)],
            "brownout_level": self.brownout_level,
            "brownout_transitions": list(self.brownout_transitions),
            "replica_restarts": self.replica_set.replacements,
            "replicas": [r.name for r in self.replica_set],
            "replica_mode": self.options.get("serve_replica_mode",
                                             "thread"),
            **extra,
            **self.latency_percentiles(),
        }
