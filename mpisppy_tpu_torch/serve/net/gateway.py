"""Gateway — the threaded socket server in front of the serve router
(a copy of `mpisppy_tpu/serve/net/gateway.py`, with a `device`
argument for the router it builds).

Everything behind the socket already exists (service, router, replica
sets): the gateway
is deliberately a THIN edge — it authenticates a bearer token to a
tenant id, decodes the frame, and forwards into `serve/router.py`'s
`Router`, whose per-tenant quotas, brownout ladder, hedged retries,
idempotency table, circuit breakers and replace-and-replay machinery
all come for free.  The gateway's own job is exactly four things:

  * **wire <-> structured translation** — protocol frames in, router
    calls out; structured rejects come back as wire error codes
    (protocol.ERROR_CODES, one namespace for both layers);
  * **authentication** — `gateway_tokens` maps bearer token -> tenant
    id; with no table configured the gateway runs OPEN and every
    caller is tenant "default" (tests, single-user dev loops).  Open
    mode is LOOPBACK-ONLY: binding a non-loopback host without a token
    table raises unless `gateway_open_non_loopback` is explicitly set.
    The fleet-lifecycle verbs (`drain`/`roll`) are additionally gated
    behind `gateway_admin_tokens` — a tenant bearer token must not be
    able to drain admission or restart the fleet out from under the
    other tenants;
  * **edge accounting** — `gateway.requests`, `gateway.rejects.<code>`,
    `gateway.bytes_in/out` counters and the
    `gateway.active_connections` gauge (telemetry.gateway_counters());
  * **fleet lifecycle** — `drain()` closes admission at the edge, and
    `roll()` performs a zero-downtime rolling restart: one replica at
    a time is condemned through the router's replace-and-replay path
    while its peers absorb traffic, in-flight requests surviving via
    the idempotency table (`Router.roll`).

Threading model: one accept loop thread plus one thread per client
connection, each handling that connection's frames sequentially (the
protocol is strictly request/response per connection; concurrency
comes from concurrent connections).  `result` waits are time-bounded
by the router's own clamps, so a connection thread can never hang
forever on a dead request.

Layering (checked in tests/test_torch_no_jax.py): torch-free at
module level, like router.py — the gateway binds, accepts, and
authenticates in a process that starts no CUDA context until a replica
dispatches.
"""

from __future__ import annotations

import socket
import threading
import time

from ... import global_toc
from ... import telemetry as _telemetry
from ..request import REJECTED, RouterHandle
from . import protocol as P


class Gateway:
    """The network front door (see module docstring).

    Options (all prefixed `gateway_` unless noted):
      gateway_tokens        {bearer token: tenant id} (None = open)
      gateway_admin_tokens  bearer tokens allowed to drain/roll; when
                            unset, drain/roll are open-mode-only (any
                            authenticated deployment refuses them)
      gateway_open_non_loopback  allow open mode (no token table) on
                            a non-loopback bind (default False: raise)
      gateway_max_payload   per-frame payload cap bytes      (256 MiB)
      gateway_idle_timeout  close an idle connection after    (300 s)
      gateway_result_cap    hard cap on one result() wait     (600 s)
      gateway_backlog       listen() backlog                    (64)
    plus every router_*/serve_* key, forwarded to the Router when the
    gateway builds its own (`router=None`)."""

    def __init__(self, options=None, router=None,
                 host="127.0.0.1", port=0, device=None):
        o = dict(options or {})
        self.options = o
        self.host = host
        self.port = int(port)
        self.tokens = o.get("gateway_tokens")      # None => open mode
        admins = o.get("gateway_admin_tokens")
        self.admin_tokens = None if admins is None else set(admins)
        if self.tokens is None and not self._loopback(host) \
                and not o.get("gateway_open_non_loopback"):
            raise ValueError(
                f"refusing open (unauthenticated) mode on non-loopback "
                f"bind {host!r}: configure gateway_tokens, or set "
                f"gateway_open_non_loopback=True to override")
        self.max_payload = int(o.get("gateway_max_payload",
                                     P.DEFAULT_MAX_PAYLOAD))
        self.idle_timeout = float(o.get("gateway_idle_timeout", 300.0))
        self.result_cap = float(o.get("gateway_result_cap", 600.0))
        self.backlog = int(o.get("gateway_backlog", 64))
        self._tel = _telemetry.configure_from_options(o.get("telemetry"))
        self._own_router = router is None
        if router is None:
            from ..router import Router
            router = Router(o, device=device)
        self.router = router
        self._listener = None
        self._accept_thread = None
        self._conn_threads = []
        self._lock = threading.Lock()
        self._stopped = False
        self._draining = False
        self._active_connections = 0
        self.counts = {}               # plain-int mirror of counters
        self.rolls = 0

    @staticmethod
    def _loopback(host):
        # NB: "" binds INADDR_ANY — emphatically not loopback
        return host in ("localhost", "::1") \
            or str(host).startswith("127.")

    # -- accounting helpers ------------------------------------------------
    def _count(self, name, n=1):
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n
        self._tel.counter(f"gateway.{name}").inc(n)

    def _reject(self, code):
        with self._lock:
            by = self.counts.setdefault("rejects_by_code", {})
            by[code] = by.get(code, 0) + 1
        self._tel.counter(f"gateway.rejects.{code}").inc()

    def _set_active(self, delta):
        with self._lock:
            self._active_connections += delta
            n = self._active_connections
        self._tel.gauge("gateway.active_connections").set(n)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Bind + listen + start the accept loop (idempotent).  Binds
        port 0 to an ephemeral port; read `self.address` after."""
        with self._lock:
            if self._listener is not None or self._stopped:
                return self
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((self.host, self.port))
            sock.listen(self.backlog)
            sock.settimeout(0.25)
            self._listener = sock
            self.port = sock.getsockname()[1]
        self.router.start()
        t = threading.Thread(target=self._accept_main,
                             name="serve-gateway-accept", daemon=True)
        self._accept_thread = t
        t.start()
        self._tel.event("gateway.start", host=self.host, port=self.port)
        global_toc(f"gateway listening on {self.host}:{self.port}")
        return self

    @property
    def address(self):
        return (self.host, self.port)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    def shutdown(self, timeout=10.0):
        """Stop accepting, close every connection, and (when the
        gateway built its own router) shut the router down too."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            listener = self._listener
            threads = list(self._conn_threads)
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass
        at = self._accept_thread
        if at is not None and at.is_alive():
            at.join(timeout)
        for t in threads:
            t.join(max(0.1, timeout / max(len(threads), 1)))
        if self._own_router:
            self.router.shutdown(timeout=timeout)
        self._tel.event("gateway.shutdown")

    def drain(self, deadline=5.0):
        """Close admission at the edge: new submit/solve frames reject
        with code "draining" while poll/result/health keep flowing, and
        the call blocks until the router's open-request table empties
        (or `deadline` passes).  Returns {"drained_open": n} with the
        number of requests still open when the deadline hit."""
        self._draining = True
        self._tel.event("gateway.drain", deadline=deadline)
        end = time.monotonic() + float(deadline)
        while time.monotonic() < end:
            with self.router._lock:
                if not self.router._open:
                    break
            time.sleep(0.02)
        with self.router._lock:
            left = len(self.router._open)
        self._count("drains")
        return {"drained_open": left}

    def roll(self):
        """Zero-downtime rolling restart of the whole replica set, one
        slot at a time through the router's replace-and-replay
        machinery (Router.roll); peers absorb traffic and in-flight
        requests survive via the idempotency table.  Emits a
        `gateway.roll_slot` event per replaced slot (the trail) and
        counts `gateway.rolls` once per completed roll."""
        t0 = time.monotonic()
        rolled = self.router.roll(
            on_slot=lambda slot, name: self._tel.event(
                "gateway.roll_slot", slot=slot, fresh=name))
        self.rolls += 1
        self._count("rolls")
        self._tel.event("gateway.rolled", replicas=rolled,
                        wall_s=round(time.monotonic() - t0, 4))
        return rolled

    # -- connection handling ----------------------------------------------
    def _accept_main(self):
        while True:
            with self._lock:
                if self._stopped:
                    return
            try:
                conn, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return                 # listener closed under us
            t = threading.Thread(target=self._conn_main,
                                 args=(conn, addr),
                                 name="serve-gateway-conn", daemon=True)
            with self._lock:
                # prune finished handlers so a long-running gateway
                # doesn't hold one Thread object per connection EVER
                # accepted (and shutdown's join budget stays honest)
                self._conn_threads = [
                    c for c in self._conn_threads if c.is_alive()]
                self._conn_threads.append(t)
            t.start()

    def _conn_main(self, conn, addr):
        self._set_active(+1)
        conn.settimeout(self.idle_timeout)
        try:
            while not self._stopped:
                try:
                    header, payload = P.read_message(
                        conn, max_payload=self.max_payload,
                        on_bytes=lambda n: self._count("bytes_in", n))
                except P.ProtocolError as exc:
                    # a torn frame poisons the stream position: answer
                    # once, then close — the client reconnects clean
                    # (_error_frame counts the reject — exactly once)
                    self._safe_send(conn, P.pack_message(
                        self._error_frame(P.E_BAD_FRAME, str(exc))))
                    return
                except socket.timeout:
                    return             # idle connection reaped
                if header is None:
                    return             # clean EOF
                self._count("requests")
                resp_header, resp_payload = self._dispatch(
                    header, payload)
                if "seq" in header:
                    # pipelined clients (net/client.PooledClient) stamp
                    # a per-connection sequence number; echoing it lets
                    # them cross-check FIFO response matching
                    resp_header["seq"] = header["seq"]
                n = self._safe_send(
                    conn, P.pack_message(resp_header, resp_payload))
                self._count("bytes_out", n)
        except (ConnectionError, OSError):
            pass                       # peer went away mid-write
        finally:
            self._set_active(-1)
            try:
                conn.close()
            except OSError:
                pass

    def _safe_send(self, conn, data):
        try:
            conn.sendall(data)
            return len(data)
        except (ConnectionError, OSError):
            return 0

    # -- request dispatch --------------------------------------------------
    def _error_frame(self, code, message, **extra):
        self._reject(code)
        hdr = {"kind": "response", "ok": False, "error_code": code,
               "error": str(message)[:2000]}
        hdr.update(extra)
        return hdr

    def _ok_frame(self, verb, result=None, payload=b"", **extra):
        hdr = {"kind": "response", "ok": True, "verb": verb,
               "error_code": None}
        if result is not None:
            hdr["result"] = result
        hdr.update(extra)
        return hdr, payload

    def _authenticate(self, header):
        """Bearer token -> tenant id, or None when unauthorized.  With
        no token table the gateway is OPEN: every caller is tenant
        "default" (the router's quotas then see one tenant).  An admin
        token authenticates even without a tenant-table row (tenant
        "admin") — operators don't need a quota bucket to drain."""
        tok = header.get("token")
        if self.admin_tokens is not None and tok in self.admin_tokens:
            return (self.tokens or {}).get(tok, "admin")
        if self.tokens is None:
            return "default"
        return self.tokens.get(tok)

    def _is_admin(self, header):
        """May this caller drain/roll the fleet?  With an admin table:
        only its tokens.  Without one: only open mode (dev loop) —
        an authenticated multi-tenant deployment that configured no
        admin tokens has NO wire path to drain/roll (operators hold
        the Gateway object and call .drain()/.roll() directly)."""
        if self.admin_tokens is not None:
            return header.get("token") in self.admin_tokens
        return self.tokens is None

    def _dispatch(self, header, payload):
        verb = header.get("verb")
        if verb not in P.VERBS or not hasattr(self, f"_verb_{verb}"):
            # the second clause: protocol.VERBS also names replica-
            # worker verbs (peek/warm_from/shutdown) the gateway does
            # not serve — a structured reject, not E_INTERNAL
            return self._error_frame(P.E_BAD_VERB,
                                     f"unknown verb {verb!r}"), b""
        tenant = self._authenticate(header)
        if tenant is None:
            return self._error_frame(
                P.E_UNAUTHORIZED, "bearer token not recognized"), b""
        try:
            return getattr(self, f"_verb_{verb}")(header, payload,
                                                  tenant)
        except P.ProtocolError as exc:
            return self._error_frame(P.E_BAD_PAYLOAD, str(exc)), b""
        except Exception as exc:       # pragma: no cover - belt+braces
            global_toc(f"WARNING: gateway handler error: {exc!r}")
            self._tel.event("gateway.handler_error", verb=verb,
                            error=repr(exc))
            return self._error_frame(P.E_INTERNAL, repr(exc)), b""

    # -- verbs -------------------------------------------------------------
    def _submit_inner(self, header, payload, tenant):
        """Shared by submit and solve: decode + forward to the router.
        Returns (handle, reject_code_or_None)."""
        if self._draining:
            return None, P.E_DRAINING
        try:
            batch = P.decode_batch(payload)
        except Exception as exc:
            raise P.ProtocolError(f"undecodable batch payload: {exc!r}")
        h = self.router.submit(
            batch,
            options=header.get("options") or {},
            scenario_names=header.get("scenario_names"),
            deadline=header.get("deadline"),
            model=header.get("model"),
            tenant=tenant,
            priority=int(header.get("priority", 1)),
            idempotency_key=header.get("idempotency_key"))
        # structured rejects surface immediately as wire error codes
        # (resolved-at-submit requests have their result already)
        rreq = self.router._requests.get(h.id)
        if rreq is not None and rreq.done.is_set() \
                and rreq.status == REJECTED:
            code = rreq.result.get("reason", REJECTED)
            self._reject(code)
            return h, code
        return h, None

    def _verb_submit(self, header, payload, tenant):
        h, code = self._submit_inner(header, payload, tenant)
        if h is None:
            return self._error_frame(code, "gateway is draining"), b""
        result = {"handle": h.id}
        if code is not None:
            result["rejected"] = code
        return self._ok_frame("submit", result)

    def _verb_poll(self, header, payload, tenant):
        h = RouterHandle(int(header.get("handle", -1)))
        status = self.router.poll(h)
        if status == "unknown":
            return self._error_frame(
                P.E_UNKNOWN_HANDLE, f"no request {h.id}"), b""
        return self._ok_frame("poll", {"handle": h.id,
                                       "state": status})

    def _verb_result(self, header, payload, tenant):
        h = RouterHandle(int(header.get("handle", -1)))
        if self.router._requests.get(h.id) is None:
            return self._error_frame(
                P.E_UNKNOWN_HANDLE, f"no request {h.id}"), b""
        timeout = header.get("timeout")
        timeout = self.result_cap if timeout is None \
            else min(float(timeout), self.result_cap)
        res = self.router.result(h, timeout=timeout)
        return self._result_frame("result", res)

    def _verb_solve(self, header, payload, tenant):
        h, code = self._submit_inner(header, payload, tenant)
        if h is None:
            return self._error_frame(code, "gateway is draining"), b""
        timeout = header.get("timeout")
        timeout = self.result_cap if timeout is None \
            else min(float(timeout), self.result_cap)
        res = self.router.result(h, timeout=timeout)
        return self._result_frame("solve", res, handle=h.id)

    def _result_frame(self, verb, res, **extra):
        """A terminal result as a wire frame: non-ok statuses carry
        their reject/failure reason as `error_code` (counted), but the
        frame is still ok=True — the REQUEST failed, not the wire."""
        code = None
        if res.get("status") != "ok":
            code = res.get("reason", res.get("status"))
            code = "quarantined" if isinstance(code, str) \
                and code.startswith("quarantined") else code
            self._reject(str(code))
        scalars, payload = P.encode_result(res)
        hdr, payload = self._ok_frame(verb, scalars, payload,
                                      **extra)
        hdr["error_code"] = None if code is None else str(code)
        return hdr, payload

    def _verb_health(self, header, payload, tenant):
        stats = P.jsonable(self.router.stats())
        stats["gateway"] = {
            "active_connections": self._active_connections,
            "draining": self._draining,
            "rolls": self.rolls,
            "counts": P.jsonable(dict(self.counts)),
        }
        return self._ok_frame("health", stats)

    def _verb_drain(self, header, payload, tenant):
        if not self._is_admin(header):
            return self._error_frame(
                P.E_UNAUTHORIZED,
                "drain requires a gateway_admin_tokens token"), b""
        out = self.drain(deadline=float(header.get("deadline", 5.0)))
        return self._ok_frame("drain", out)

    def _verb_roll(self, header, payload, tenant):
        if not self._is_admin(header):
            return self._error_frame(
                P.E_UNAUTHORIZED,
                "roll requires a gateway_admin_tokens token"), b""
        rolled = self.roll()
        return self._ok_frame("roll", {"rolled": rolled})
