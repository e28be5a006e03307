"""Process-backed replica fleet: N OS processes past `_BACKEND_LOCK`
(port of `mpisppy_tpu/serve/procpool.py`).

In-process replicas (serve/replica.py) share one device and one host
interpreter, so every device execution serializes on
`service._BACKEND_LOCK` — N replicas buy fault isolation but zero
throughput.  This module gives the router the
SAME duck-typed replica surface (submit/poll/peek/health/drain/
warm_from/shutdown + slot/incarnation/name/condemned/assigned/failed)
backed by a `serve/procworker.py` child process per slot:

  * each worker owns its own interpreter and CUDA context on the same
    card (`serve_device`; the card time-slices between contexts) —
    the host work of solves on different slots runs in parallel on a
    multi-core host;
  * the parent talks to each worker over the serve/net wire protocol
    on a loopback socket through a pooled, pipelined `PooledClient`
    (persistent sockets, multiple in-flight frames);
  * workers boot warm: they `prewarm()` the shared
    `MPISPPY_TPU_COMPILE_CACHE_DIR/aot` artifact set (each bucket's
    route and kernel-variant picks, checked against the kernel library
    the parent built before spawning; no child runs nvcc), so a rolled
    or replaced incarnation serves its first request without
    recomputing them;
  * process DEATH (kill -9, OOM, a segfaulting native op) is a
    first-class health signal: `health()` checks the child's exit
    status before anything else, and a dead worker reports
    `failed="worker process died ..."` — which flows into the router's
    existing breaker → replace-and-replay path unchanged.  Escalation
    on shutdown mirrors the SpokeSupervisor poll/escalate discipline:
    cooperative verb → SIGTERM → SIGKILL.

Layering: torch-free at module level — the parent needs torch only to
build the kernel library before it spawns CUDA workers; only
`P.encode_batch` touches the batch.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import uuid

from .. import global_toc
from .net import protocol as P
from .net.client import ClientError, PooledClient
from .replica import _GLOBAL_CHAOS, _SLOT_CHAOS
from .request import RequestHandle

#: consecutive transport-failed health probes against a LIVE process
#: before the replica is declared unreachable (a wedged-but-breathing
#: worker must not dodge the breaker forever)
_PROBE_FAILURE_LIMIT = 5
#: health snapshots younger than this are served from cache — the
#: router probes on every submit pick, and every wire frame the parent
#: sends mid-solve steals CPU (and worker GIL) from the solve itself;
#: the DEATH check (waitpid) always runs fresh, so kill -9 detection
#: does not wait on this, and submit-burst routing accuracy comes from
#: the parent-side outstanding overlay, not snapshot freshness
_HEALTH_CACHE_S = 0.25

#: at most one bulk `peek_many` poll per ProcReplica per this window —
#: the router's scan peeks EVERY open request every tick, and
#: per-handle wire peeks at that cadence convoy the worker's GIL
#: against its own dispatch thread; one bulk frame per window replaces
#: them, and since that frame carries the done results themselves,
#: keeping the window near the scan tick keeps the completion tail
#: short without adding frames that carry nothing
_PEEK_CACHE_S = 0.02


def _repo_root():
    """The directory that makes `import mpisppy_tpu_torch` work in a
    child spawned from an arbitrary cwd."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _jsonable_options(options):
    """The subset of the options dict a worker can receive: config
    JSON crosses the process boundary, so non-JSON values (injected
    objects, callables) are dropped — loudly, they would silently
    change worker behavior otherwise."""
    out = {}
    for k, v in dict(options or {}).items():
        try:
            json.dumps(v)
        except (TypeError, ValueError):
            global_toc(f"WARNING: procpool dropping non-JSON option "
                       f"{k!r} ({type(v).__name__}) from worker config")
            continue
        out[k] = v
    return out


def _device_of(options):
    """The workers' device string: `serve_device`, default the card."""
    return str(options.get("serve_device") or "cuda")


def prebuild(device):
    """Build the chunk kernel's library in the parent before a CUDA
    worker spawns (the children load it by its source hash and never
    run nvcc)."""
    if device.startswith("cuda"):
        from ..ops import pdhg_chunk
        pdhg_chunk.build()


class ProcReplica:
    """One process-backed fault domain, duck-typed to replica.Replica.

    `name` is "p<slot>i<incarnation>" — the process fleet's analogue of
    the thread fleet's "r<slot>i<inc>" labels."""

    def __init__(self, slot, incarnation, options, chaos=None,
                 workdir=None, boot_timeout=180.0):
        self.slot = int(slot)
        self.incarnation = int(incarnation)
        self.name = f"p{self.slot}i{self.incarnation}"
        o = dict(options or {})
        o["chaos"] = dict(chaos or {})
        self.options = o
        self.workdir = workdir or tempfile.mkdtemp(
            prefix="mpisppy_procpool_")
        self.boot_timeout = float(boot_timeout)
        self.token = uuid.uuid4().hex
        self.condemned = False
        self.assigned = {}             # inner request id -> router rid
        self.proc = None
        self.pid = None
        self.port = None
        self.client = None
        self.boot_seconds = None       # worker-reported service boot
        self.spawn_seconds = None      # parent-observed spawn -> ready
        self.prewarm_loaded = 0
        self._logfile = None
        self._spawned_at = None
        self._dead_ids = itertools.count(-1, -1)
        self._health_lock = threading.Lock()
        self._last_health = None
        self._last_health_at = 0.0
        self._last_cache = {}
        self._probe_failures = 0
        self._death_reason = None
        self._peek_lock = threading.Lock()
        self._peek_live = set()        # ids whose done-ness we track
        self._fetched = {}             # id -> decoded result, un-peeked
        self._last_statuses_at = 0.0
        self._outstanding = 0          # submitted minus results fetched

    # -- lifecycle --------------------------------------------------------
    def spawn(self):
        """Fork the worker (non-blocking half of start: the set spawns
        every slot first, then waits on all — boots overlap)."""
        cfg = {
            "options": _jsonable_options(self.options),
            "token": self.token,
            "portfile": self._portfile,
            "device": _device_of(self.options),
        }
        cfgfile = os.path.join(self.workdir, f"cfg_{self.name}.json")
        with open(cfgfile, "w") as f:
            json.dump(cfg, f)
        try:
            os.remove(self._portfile)
        except OSError:
            pass
        env = dict(os.environ)
        env["PYTHONPATH"] = _repo_root() + os.pathsep \
            + env.get("PYTHONPATH", "")
        self._logfile = os.path.join(self.workdir,
                                     f"worker_{self.name}.log")
        log = open(self._logfile, "ab")
        self._spawned_at = time.monotonic()
        # stdin is the parent-liveness pipe: the worker hard-exits on
        # EOF there, so a crashed router never leaks worker processes
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mpisppy_tpu_torch.serve.procworker",
             cfgfile],
            stdin=subprocess.PIPE, stdout=log, stderr=log, env=env)
        log.close()
        self.pid = self.proc.pid
        return self

    @property
    def _portfile(self):
        return os.path.join(self.workdir, f"port_{self.name}.json")

    def _log_tail(self, n=2000):
        try:
            with open(self._logfile, "rb") as f:
                return f.read()[-n:].decode("utf-8", "replace")
        except OSError:
            return "<no worker log>"

    def wait_ready(self):
        """Block until the worker's portfile lands (atomic write: a
        visible file is a complete file), then connect.  A child that
        exits first raises with its log tail."""
        deadline = time.monotonic() + self.boot_timeout
        while True:
            if os.path.exists(self._portfile):
                break
            rc = self.proc.poll()
            if rc is not None:
                raise RuntimeError(
                    f"worker {self.name} exited rc={rc} before "
                    f"serving; log tail:\n{self._log_tail()}")
            if time.monotonic() > deadline:
                self.proc.kill()
                raise RuntimeError(
                    f"worker {self.name} failed to boot within "
                    f"{self.boot_timeout}s; log tail:\n"
                    f"{self._log_tail()}")
            time.sleep(0.02)
        with open(self._portfile) as f:
            info = json.load(f)
        self.port = int(info["port"])
        self.boot_seconds = info.get("boot_seconds")
        self.prewarm_loaded = int(info.get("prewarm_loaded", 0))
        self.spawn_seconds = time.monotonic() - self._spawned_at
        self.client = PooledClient(
            "127.0.0.1", self.port, token=self.token, pool_size=2,
            request_timeout=float(
                self.options.get("serve_result_timeout", 600.0)) + 30.0)
        return self

    def start(self):
        if self.proc is None:
            self.spawn()
        if self.client is None:
            self.wait_ready()
        return self

    # -- the router-facing replica surface --------------------------------
    def _dead_handle(self):
        """Submit against a dead worker must still return a handle (the
        router records it, then replace-and-replay picks the request
        up); negative ids poll "unknown" and peek None forever."""
        return RequestHandle(next(self._dead_ids))

    def submit(self, batch, options=None, scenario_names=None,
               deadline=None, model=None):
        try:
            resp, _ = self.client.call(
                "submit", P.encode_batch(batch), options=options,
                scenario_names=scenario_names, deadline=deadline,
                model=model)
        except (ConnectionError, ClientError, OSError):
            return self._dead_handle()
        hid = int(resp["result"]["handle"])
        with self._peek_lock:
            self._peek_live.add(hid)
            self._outstanding += 1
        return RequestHandle(hid)

    def poll(self, handle):
        if handle.id < 0:
            return "unknown"
        try:
            resp, _ = self.client.call("poll", handle=handle.id,
                                       timeout=10.0)
        except (ConnectionError, ClientError, OSError):
            return "unknown"
        return resp["result"]["state"]

    def _refresh_fetched(self, rid):
        """Pull every done result for this worker in ONE `peek_many`
        frame into `_fetched`, at most once per `_PEEK_CACHE_S`
        window.  One frame serves the router's whole scan tick —
        discovery and payload fetch combined — so a 16-request tick
        costs one round trip, not 16, and a completed group's tail is
        one frame, not one per request.  Returns True when `rid` is
        fetched."""
        now = time.monotonic()
        with self._peek_lock:
            if rid in self._fetched:
                return True
            self._peek_live.add(rid)
            if now - self._last_statuses_at < _PEEK_CACHE_S:
                return False
            self._last_statuses_at = now
            live = sorted(self._peek_live)
        try:
            resp, payload = self.client.call("peek_many",
                                             handles=live,
                                             timeout=30.0)
        except (ConnectionError, ClientError, OSError):
            return False
        r = resp["result"]
        off, fetched = 0, {}
        for hid, n in r["sizes"]:
            hid, n = int(hid), int(n)
            fetched[hid] = P.decode_result(r["results"][str(hid)],
                                           payload[off:off + n])
            off += n
        unknown = {int(u) for u in r.get("unknown") or ()}
        with self._peek_lock:
            for hid in list(fetched) + sorted(unknown):
                if hid in self._peek_live:
                    self._outstanding = max(0, self._outstanding - 1)
                self._peek_live.discard(hid)
            self._fetched.update(fetched)
            return rid in self._fetched

    def peek(self, handle):
        """Non-blocking terminal-result fetch, served from the bulk
        `_refresh_fetched` cache (see above)."""
        if handle.id < 0:
            return None
        with self._peek_lock:
            res = self._fetched.pop(handle.id, None)
        if res is not None:
            return res
        if not self._refresh_fetched(handle.id):
            return None
        with self._peek_lock:
            return self._fetched.pop(handle.id, None)

    def _dead_health(self, reason):
        return {
            "failed": reason, "draining": False, "stopped": True,
            "queue_depth": 0, "inflight": 0, "last_dispatch_age": 0.0,
            "restarts": 0, "crash_suspects": set(),
            "bucket_starvation": 0, "replica_mode": "process",
            "pid": self.pid, "cache": dict(self._last_cache),
        }

    def _with_outstanding(self, h, fresh):
        """Overlay the parent-side outstanding count (submits minus
        results fetched) onto a health snapshot so the router's load
        metric (`queue_depth + inflight`) tracks reality during a
        submit burst, when the wire snapshot is up to
        `_HEALTH_CACHE_S` stale.  Outstanding is an upper bound on the
        worker's true load, and a FRESH wire reading is a lower
        bound, so their max is safe; a STALE reading is neither — it
        can still show the previous burst's load and mis-route the
        whole next burst onto one worker (uneven splits dispatch
        odd-width groups downstream, and each width is its own
        trace) — so on the cached path outstanding replaces it."""
        with self._peek_lock:
            outstanding = self._outstanding
        if fresh:
            qd = int(h.get("queue_depth", 0) or 0)
            h["inflight"] = max(int(h.get("inflight", 0) or 0),
                                outstanding - qd)
        else:
            h["queue_depth"] = 0
            h["inflight"] = outstanding
        return h

    def health(self):
        """One probe, three layers: (1) the waitpid death check ALWAYS
        runs — kill -9 is detected on the next probe, not after a
        socket timeout; (2) fresh-enough snapshots are served from a
        tiny cache so per-submit picks don't convoy on a busy worker's
        wire RTT; (3) repeated transport failures against a LIVE
        process synthesize failure — wedged != healthy."""
        rc = self.proc.poll() if self.proc is not None else None
        if rc is not None:
            if self._death_reason is None:
                self._death_reason = (
                    f"worker process died (pid {self.pid}, rc={rc})")
            return self._dead_health(self._death_reason)
        now = time.monotonic()
        with self._health_lock:
            if self._last_health is not None \
                    and now - self._last_health_at < _HEALTH_CACHE_S:
                return self._with_outstanding(
                    dict(self._last_health,
                         crash_suspects=set(
                             self._last_health["crash_suspects"])),
                    fresh=False)
        try:
            resp, _ = self.client.call("health", timeout=10.0)
        except (ConnectionError, ClientError, OSError) as exc:
            with self._health_lock:
                self._probe_failures += 1
                n = self._probe_failures
            if n >= _PROBE_FAILURE_LIMIT:
                return self._dead_health(
                    f"worker unreachable ({n} consecutive probe "
                    f"failures: {exc})")
            if self._last_health is not None:
                return self._with_outstanding(
                    dict(self._last_health,
                         crash_suspects=set(
                             self._last_health["crash_suspects"])),
                    fresh=False)
            return self._dead_health(f"worker not answering: {exc}")
        h = dict(resp["result"])
        h["crash_suspects"] = set(h.get("crash_suspects") or ())
        with self._health_lock:
            self._probe_failures = 0
            self._last_health = h
            self._last_health_at = time.monotonic()
            self._last_cache = dict(h.get("cache") or {})
        return self._with_outstanding(
            dict(h, crash_suspects=set(h["crash_suspects"])),
            fresh=True)

    def cache_stats(self):
        """The worker's CompileCache.stats() as last reported over the
        health wire (the cache object never leaves the worker)."""
        with self._health_lock:
            return dict(self._last_cache)

    @property
    def failed(self):
        return self.health()["failed"] is not None

    def drain(self, deadline=1.0, checkpoint_path=None):
        if self.proc is not None and self.proc.poll() is not None:
            # a corpse has nothing to flush and nothing to checkpoint;
            # the router replays its requests from its own table
            return {"drained": 0, "checkpoint": None}
        try:
            resp, _ = self.client.call(
                "drain", deadline=deadline,
                checkpoint_path=checkpoint_path,
                timeout=float(deadline) + 30.0)
        except (ConnectionError, ClientError, OSError):
            return {"drained": 0, "checkpoint": None}
        return dict(resp["result"])

    def warm_from(self, path):
        try:
            resp, _ = self.client.call("warm_from", path=str(path),
                                       timeout=60.0)
        except (ConnectionError, ClientError, OSError) as exc:
            return {"status": "failed",
                    "reason": "worker_unreachable", "error": repr(exc)}
        r = resp["result"]
        if "adopted" in r:
            adopted = [(sid, RequestHandle(int(hid)))
                       for sid, hid in r["adopted"]]
            # adopted requests are load this parent now owns: count
            # them like submits so routing sees them and the peek
            # fetch decrements them symmetrically
            with self._peek_lock:
                for _sid, h in adopted:
                    if h.id not in self._peek_live:
                        self._peek_live.add(h.id)
                        self._outstanding += 1
            return adopted
        return r.get("error")

    def shutdown(self, timeout=5.0):
        """Cooperative verb → SIGTERM → SIGKILL, the SpokeSupervisor
        escalation ladder, each rung bounded by a slice of `timeout`."""
        proc = self.proc
        if proc is None:
            return
        slice_s = max(0.2, float(timeout) / 3.0)
        if proc.poll() is None:
            try:
                self.client.call("shutdown", timeout=slice_s)
            except (ConnectionError, ClientError, OSError):
                pass
            try:
                proc.wait(timeout=slice_s)
            except subprocess.TimeoutExpired:
                pass
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=slice_s)
            except subprocess.TimeoutExpired:
                pass
        if proc.poll() is None:
            proc.kill()
            try:
                proc.wait(timeout=slice_s)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass
        if self.client is not None:
            self.client.close()
        if proc.stdin is not None:
            try:
                proc.stdin.close()
            except OSError:
                pass


class ProcReplicaSet:
    """The process fleet behind the router — replica.ReplicaSet's
    surface (slots, incarnations, chaos targeting, replace) over
    ProcReplica workers.

    Chaos targeting reuses the thread fleet's rules verbatim
    (replica._SLOT_CHAOS / _GLOBAL_CHAOS): slot-targeted keys reach
    only the chaos slot's FIRST incarnation, `poison_request` arms
    every worker.  The chaos config rides the worker's options JSON —
    the injector fires inside the child, so `replica_crash` there is a
    real process exit."""

    def __init__(self, options=None, n_replicas=None):
        o = dict(options or {})
        self.options = o
        self.n = int(n_replicas if n_replicas is not None
                     else o.get("serve_replicas", 2))
        if self.n < 1:
            raise ValueError(f"serve_replicas must be >= 1, got {self.n}")
        chaos = dict(o.get("chaos") or {})
        self.chaos_slot = int(chaos.pop("chaos_replica", 0))
        self.chaos = chaos
        self.boot_timeout = float(o.get("serve_proc_boot_timeout", 180.0))
        self.workdir = o.get("serve_proc_workdir") or tempfile.mkdtemp(
            prefix="mpisppy_procpool_")
        self.incarnations = [0] * self.n
        self.replacements = 0
        self.replicas = [self._build(slot) for slot in range(self.n)]
        self._started = False

    def _chaos_for(self, slot, incarnation):
        cfg = {k: self.chaos[k] for k in _GLOBAL_CHAOS if k in self.chaos}
        if slot == self.chaos_slot and incarnation == 0:
            cfg.update({k: self.chaos[k] for k in _SLOT_CHAOS
                        if k in self.chaos})
        return cfg

    def _build(self, slot):
        inc = self.incarnations[slot]
        return ProcReplica(slot, inc, self.options,
                           chaos=self._chaos_for(slot, inc),
                           workdir=self.workdir,
                           boot_timeout=self.boot_timeout)

    def start(self):
        """Spawn EVERY worker first, then wait on all — N boots cost
        max(boot), not sum(boot)."""
        if self._started:
            return self
        prebuild(_device_of(self.options))
        for r in self.replicas:
            if r.proc is None:
                r.spawn()
        for r in self.replicas:
            if r.client is None:
                r.wait_ready()
        self._started = True
        return self

    def __iter__(self):
        return iter(self.replicas)

    def __len__(self):
        return self.n

    def __getitem__(self, slot):
        return self.replicas[slot]

    def replace(self, slot, drain_deadline=1.0, checkpoint_path=None):
        """Mirror ReplicaSet.replace over processes: drain the corpse
        (a DEAD process drains to nothing — the router replays from its
        own table), kill it, boot a fresh incarnation (prewarmed from
        the shared artifact dir), warm it from the drain checkpoint
        when one was written."""
        corpse = self.replicas[slot]
        corpse.condemned = True
        drain_info = corpse.drain(deadline=drain_deadline,
                                  checkpoint_path=checkpoint_path)
        corpse.shutdown(timeout=max(1.0, drain_deadline))
        self.incarnations[slot] += 1
        self.replacements += 1
        fresh = self._build(slot).start()
        self.replicas[slot] = fresh
        adopted = []
        saved = drain_info.get("checkpoint")
        if saved:
            out = fresh.warm_from(saved)
            if isinstance(out, list):
                adopted = out
        return fresh, drain_info, adopted

    def boot_stats(self):
        """Fleet boot economics: parent-observed spawn-to-ready seconds
        per live replica, and the total artifacts the workers
        prewarmed."""
        spawns = [r.spawn_seconds for r in self.replicas
                  if r.spawn_seconds is not None]
        return {"proc_boot_seconds": spawns,
                "prewarm_loaded": sum(r.prewarm_loaded
                                      for r in self.replicas)}

    def shutdown(self, timeout=5.0):
        deadline = time.monotonic() + float(timeout)
        for r in self.replicas:
            r.shutdown(timeout=max(0.5, deadline - time.monotonic()))
