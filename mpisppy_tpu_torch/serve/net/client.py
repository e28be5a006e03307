"""Blocking wire-protocol client for the serve gateway (a copy of
`mpisppy_tpu/serve/net/client.py`).

One `Client` wraps one TCP connection and speaks `protocol`'s framed
request/response exchange: `submit / poll / result / solve / health /
drain / roll`.  Failure handling is deliberately boring:

  * **connect timeout** and **request timeout** bound every socket
    operation (`socket.create_connection(timeout=)`, `settimeout`);
  * a torn connection (ConnectionError / OSError / mid-frame EOF)
    triggers **capped-jitter reconnect** built on the shared
    `resilience.restart_delay` pacing policy, then ONE resend of the
    in-flight request.  Every submit/solve carries an idempotency key
    (auto-generated uuid when the caller gave none), so a resend after
    a half-delivered request is deduplicated server-side — the wire
    half of the exactly-once contract;
  * a `result` wait stretches the socket timeout to the request's own
    timeout plus a grace, so slow solves aren't misread as dead peers.
    With `timeout=None` the server blocks up to ITS cap
    (`gateway_result_cap`, 600 s default), so the socket stretches to
    the client's `result_cap` mirror of that value — leaving it at
    `request_timeout` would misread every solve slower than 60 s as a
    transport failure and burn the reconnect budget on a healthy
    request.

Layering: no torch at module level, like `protocol` (checked in
tests/test_torch_no_jax.py).
"""

from __future__ import annotations

import itertools
import random
import socket
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass

from ... import telemetry as _telemetry
from ...resilience import restart_delay
from . import protocol as P


@dataclass(frozen=True)
class NetHandle:
    """A submitted request as seen from the client side: the router's
    handle id plus the idempotency key the client stamped on it (the
    key is what survives a reconnect; the id is what poll/result
    use)."""
    id: int
    idempotency_key: str


class ClientError(RuntimeError):
    """The server answered with ok=False: carries the wire error code
    (protocol.ERROR_CODES) as `.code`."""

    def __init__(self, code, message):
        super().__init__(f"[{code}] {message}")
        self.code = code


class Client:
    """Blocking gateway client (see module docstring)."""

    def __init__(self, host, port, token="", connect_timeout=5.0,
                 request_timeout=60.0, result_cap=600.0,
                 reconnect_backoff=0.05, reconnect_cap=2.0,
                 max_reconnects=8, jitter_seed=None,
                 max_payload=P.DEFAULT_MAX_PAYLOAD):
        self.host = host
        self.port = int(port)
        self.token = token
        self.connect_timeout = float(connect_timeout)
        self.request_timeout = float(request_timeout)
        # mirror of the server's gateway_result_cap: how long a
        # result/solve with timeout=None may legitimately block
        self.result_cap = float(result_cap)
        self.reconnect_backoff = float(reconnect_backoff)
        self.reconnect_cap = float(reconnect_cap)
        self.max_reconnects = int(max_reconnects)
        self.max_payload = int(max_payload)
        self._rng = random.Random(jitter_seed)
        self._sock = None
        self.reconnects = 0            # lifetime count (tests/bench)

    # -- connection management --------------------------------------------
    def _connect(self):
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout)
        sock.settimeout(self.request_timeout)
        self._sock = sock
        return sock

    def _ensure(self):
        return self._sock if self._sock is not None else self._connect()

    def _drop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self):
        self._drop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- request core ------------------------------------------------------
    def _request(self, header, payload=b"", timeout=None):
        """One framed exchange, with reconnect-and-resend on transport
        failure.  Safe to resend because every mutating verb carries an
        idempotency key.  Returns (response_header, response_payload);
        raises ClientError on an ok=False response, ConnectionError
        when the reconnect budget is spent."""
        attempt = 0
        while True:
            try:
                sock = self._ensure()
                if timeout is not None:
                    sock.settimeout(float(timeout))
                try:
                    P.write_message(sock, header, payload)
                    resp, rpayload = P.read_message(
                        sock, max_payload=self.max_payload)
                finally:
                    if timeout is not None:
                        sock.settimeout(self.request_timeout)
                if resp is None:
                    raise P.ProtocolError("server closed the connection")
            except (ConnectionError, OSError, P.ProtocolError) as exc:
                self._drop()
                attempt += 1
                self.reconnects += 1
                if attempt > self.max_reconnects:
                    raise ConnectionError(
                        f"gateway unreachable after {attempt - 1} "
                        f"reconnect(s): {exc}") from exc
                # capped exponential backoff with full jitter: the
                # shared restart pacing policy scaled by U(0.5, 1)
                delay = restart_delay(attempt, self.reconnect_backoff,
                                      self.reconnect_cap)
                time.sleep(delay * (0.5 + 0.5 * self._rng.random()))
                continue
            if not resp.get("ok", False):
                raise ClientError(resp.get("error_code", P.E_INTERNAL),
                                  resp.get("error", ""))
            return resp, rpayload

    def _header(self, verb, **fields):
        hdr = {"kind": "request", "verb": verb, "token": self.token}
        hdr.update({k: v for k, v in fields.items() if v is not None})
        return hdr

    # -- verbs -------------------------------------------------------------
    def submit(self, batch, options=None, scenario_names=None,
               deadline=None, model=None, priority=None,
               idempotency_key=None):
        """Enqueue one solve; returns a NetHandle immediately.  An
        immediately-rejected request still gets a handle — `result`
        reports the structured rejection."""
        key = idempotency_key or f"net-{uuid.uuid4().hex}"
        hdr = self._header(
            "submit", options=options, scenario_names=scenario_names,
            deadline=deadline, model=model, priority=priority,
            idempotency_key=key)
        resp, _ = self._request(hdr, P.encode_batch(batch))
        return NetHandle(int(resp["result"]["handle"]), key)

    def poll(self, handle):
        resp, _ = self._request(self._header("poll", handle=handle.id))
        return resp["result"]["state"]

    def _wire_timeout(self, timeout):
        """Socket wait for a blocking result exchange: the request's
        own timeout + grace, or — with timeout=None, where the SERVER
        decides when to answer (up to gateway_result_cap) — the
        client's result_cap mirror + grace."""
        cap = self.result_cap if timeout is None else float(timeout)
        return cap + 10.0

    def result(self, handle, timeout=None):
        """Block for the structured result dict (arrays restored
        bit-exact from the npz payload).  The socket wait stretches to
        `timeout` + grace (or `result_cap` + grace when timeout is
        None) so a slow solve isn't misread as a dead peer."""
        wire_timeout = self._wire_timeout(timeout)
        resp, payload = self._request(
            self._header("result", handle=handle.id, timeout=timeout),
            timeout=wire_timeout)
        return P.decode_result(resp["result"], payload)

    def solve(self, batch, options=None, timeout=None, **kwargs):
        """submit + result in one exchange (one frame each way)."""
        key = kwargs.pop("idempotency_key", None) \
            or f"net-{uuid.uuid4().hex}"
        hdr = self._header("solve", options=options, timeout=timeout,
                           idempotency_key=key, **kwargs)
        resp, payload = self._request(hdr, P.encode_batch(batch),
                                      timeout=self._wire_timeout(timeout))
        return P.decode_result(resp["result"], payload)

    def health(self):
        resp, _ = self._request(self._header("health"))
        return resp["result"]

    def drain(self, deadline=5.0):
        resp, _ = self._request(
            self._header("drain", deadline=deadline),
            timeout=float(deadline) + 10.0)
        return resp["result"]

    def roll(self, timeout=120.0):
        """Ask the gateway for a zero-downtime rolling restart of the
        whole replica set; blocks until every slot has been replaced."""
        resp, _ = self._request(self._header("roll"), timeout=timeout)
        return resp["result"]["rolled"]


# -- pooled, pipelined client ----------------------------------------------

class _Pending:
    """One in-flight exchange on a pooled connection: the request (kept
    for resend-after-reconnect), the per-connection sequence number it
    was stamped with, and the slots its response (or transport error)
    lands in."""

    __slots__ = ("header", "payload", "seq", "event", "resp_header",
                 "resp_payload", "error")

    def __init__(self, header, payload):
        self.header = header
        self.payload = payload
        self.seq = None
        self.event = threading.Event()
        self.resp_header = None
        self.resp_payload = b""
        self.error = None


class _PooledConn:
    """One persistent socket carrying multiple in-flight requests.

    The server handles a connection's frames strictly in order
    (gateway._conn_main and procworker loop one frame at a time), so
    responses come back FIFO: a deque of pending exchanges matches them
    without ids.  Each request is additionally stamped with a
    per-connection `seq` that the server echoes — a cheap cross-check
    that the FIFO assumption holds; a mismatch kills the connection
    rather than mis-delivering a frame.

    Thread model: any caller thread may `send` (serialized by `_wlock`);
    ONE reader thread drains responses.  `fail()` is idempotent and
    callable from any of them — it marks the conn dead, errors out
    every pending exchange, and closes the socket (which also unblocks
    the reader)."""

    def __init__(self, host, port, connect_timeout, max_payload,
                 on_dead=None):
        self.sock = socket.create_connection(
            (host, port), timeout=connect_timeout)
        # the reader owns all receives and blocks indefinitely; request
        # timeouts are enforced by the caller's event wait, not the
        # socket, so a slow solve can't tear a shared connection down
        self.sock.settimeout(None)
        self.max_payload = int(max_payload)
        self._on_dead = on_dead
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pending = deque()
        self._seq = itertools.count(1)
        self.alive = True
        self.last_used = time.monotonic()
        self._reader = threading.Thread(
            target=self._reader_main, name="net-pool-reader", daemon=True)
        self._reader.start()

    def inflight(self):
        with self._plock:
            return len(self._pending)

    def send(self, pending):
        """Stamp, register, and write one exchange.  Raises on a torn
        write (after failing the connection)."""
        err = None
        with self._wlock:
            if not self.alive:
                raise ConnectionError("connection already failed")
            hdr = dict(pending.header)
            pending.seq = hdr["seq"] = next(self._seq)
            with self._plock:
                self._pending.append(pending)
            self.last_used = time.monotonic()
            try:
                P.write_message(self.sock, hdr, pending.payload)
            except (ConnectionError, OSError, P.ProtocolError) as exc:
                err = exc
        if err is not None:
            self.fail(err)
            raise ConnectionError(f"write failed: {err}") from err

    def _reader_main(self):
        try:
            while True:
                resp, payload = P.read_message(
                    self.sock, max_payload=self.max_payload)
                if resp is None:
                    raise P.ProtocolError("server closed the connection")
                with self._plock:
                    if not self._pending:
                        raise P.ProtocolError("unsolicited response")
                    pending = self._pending.popleft()
                if resp.get("seq") not in (None, pending.seq):
                    raise P.ProtocolError(
                        f"response seq {resp.get('seq')} != "
                        f"expected {pending.seq}")
                pending.resp_header = resp
                pending.resp_payload = payload
                self.last_used = time.monotonic()
                pending.event.set()
        except (ConnectionError, OSError, P.ProtocolError) as exc:
            self.fail(exc)

    def fail(self, exc):
        """Tear down: error out every in-flight exchange exactly once."""
        with self._plock:
            if not self.alive:
                return
            self.alive = False
            doomed = list(self._pending)
            self._pending.clear()
        for p in doomed:
            p.error = exc
            p.event.set()
        try:
            self.sock.close()
        except OSError:
            pass
        if self._on_dead is not None:
            self._on_dead(self)

    def close(self):
        self.fail(ConnectionError("client closed"))


class PooledClient:
    """Pooled, pipelined wire-protocol client: up to `pool_size`
    persistent connections, each carrying multiple in-flight requests
    (the Router's per-replica transport — one submit need not wait for
    a neighbor's solve).  Same failure discipline as `Client`:
    transport errors trigger capped-jitter reconnect + resend (safe —
    every mutating verb carries an idempotency key upstream), counted
    in `reconnects`/`resends` and the `client.reconnects` /
    `client.resends` / `client.idle_reaped` telemetry counters.
    Connections idle past `idle_timeout` with nothing in flight are
    reaped at the next checkout."""

    def __init__(self, host, port, token="", pool_size=2,
                 connect_timeout=5.0, request_timeout=60.0,
                 max_retries=4, reconnect_backoff=0.05,
                 reconnect_cap=1.0, idle_timeout=30.0, jitter_seed=None,
                 max_payload=P.DEFAULT_MAX_PAYLOAD):
        self.host = host
        self.port = int(port)
        self.token = token
        self.pool_size = max(1, int(pool_size))
        self.connect_timeout = float(connect_timeout)
        self.request_timeout = float(request_timeout)
        self.max_retries = int(max_retries)
        self.reconnect_backoff = float(reconnect_backoff)
        self.reconnect_cap = float(reconnect_cap)
        self.idle_timeout = float(idle_timeout)
        self.max_payload = int(max_payload)
        self._rng = random.Random(jitter_seed)
        self._lock = threading.Lock()
        self._conns = []
        self._closed = False
        self.reconnects = 0
        self.resends = 0
        self.idle_reaped = 0

    # -- pool management ---------------------------------------------------
    def _on_dead(self, conn):
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)

    def _checkout(self):
        """A live connection: reap idle ones, reuse the least-loaded,
        dial when the pool has room (or everything died)."""
        now = time.monotonic()
        with self._lock:
            if self._closed:
                raise ConnectionError("client closed")
            live = [c for c in self._conns if c.alive]
            reap = [c for c in live
                    if c.inflight() == 0
                    and now - c.last_used > self.idle_timeout]
            for c in reap:
                live.remove(c)
                self._conns.remove(c)
                self.idle_reaped += 1
                _telemetry.get().counter("client.idle_reaped").inc()
            self._conns = [c for c in self._conns if c.alive]
            if live and (len(live) >= self.pool_size
                         or min(c.inflight() for c in live) == 0):
                conn = min(live, key=lambda c: c.inflight())
            else:
                # dial INSIDE the lock: concurrent first callers must
                # pipeline onto the one connection being established,
                # not each dial their own past pool_size
                conn = _PooledConn(self.host, self.port,
                                   self.connect_timeout,
                                   self.max_payload,
                                   on_dead=self._on_dead)
                self._conns.append(conn)
        for c in reap:
            c.close()
        return conn

    def close(self):
        with self._lock:
            self._closed = True
            conns = list(self._conns)
            self._conns = []
        for c in conns:
            c.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- request core ------------------------------------------------------
    def call(self, verb, payload=b"", timeout=None, **fields):
        """One pipelined exchange: returns (response_header,
        response_payload).  Raises ClientError on ok=False,
        ConnectionError when the retry budget is spent."""
        header = {"kind": "request", "verb": verb, "token": self.token}
        header.update({k: v for k, v in fields.items() if v is not None})
        wait = float(timeout) if timeout is not None \
            else self.request_timeout
        attempt = 0
        while True:
            pending = _Pending(header, payload)
            try:
                conn = self._checkout()
                conn.send(pending)
            except (ConnectionError, OSError) as exc:
                pending.error = exc
            else:
                if not pending.event.wait(wait):
                    # the conn may be healthy but the server silent
                    # past the deadline: kill it (pipelined neighbors
                    # resend) rather than risk mismatched frames later
                    conn.fail(socket.timeout(
                        f"no response within {wait}s"))
            if pending.error is not None:
                attempt += 1
                self.reconnects += 1
                _telemetry.get().counter("client.reconnects").inc()
                if attempt > self.max_retries:
                    raise ConnectionError(
                        f"peer unreachable after {attempt - 1} "
                        f"retry(ies): {pending.error}") from pending.error
                self.resends += 1
                _telemetry.get().counter("client.resends").inc()
                delay = restart_delay(attempt, self.reconnect_backoff,
                                      self.reconnect_cap)
                time.sleep(delay * (0.5 + 0.5 * self._rng.random()))
                continue
            resp = pending.resp_header
            if not resp.get("ok", False):
                raise ClientError(resp.get("error_code", P.E_INTERNAL),
                                  resp.get("error", ""))
            return resp, pending.resp_payload
