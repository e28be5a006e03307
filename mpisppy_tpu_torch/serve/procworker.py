"""Process-replica worker entrypoint: one SolverService per OS process
(port of `mpisppy_tpu/serve/procworker.py`).

`python -m mpisppy_tpu_torch.serve.procworker <cfg.json>` boots a
`SolverService` in THIS process and serves it over the serve/net wire
protocol on a loopback socket — the out-of-process half of
`serve_replica_mode="process"`.  The parent (serve/procpool.py) never
shares an interpreter with the worker: each worker owns its own CUDA
context on the card, so N workers' host work runs in parallel instead
of convoying on the in-process `_BACKEND_LOCK`.

Boot sequence (the order matters):

  1. read the config JSON (options, token, portfile path, device);
  2. start the parent watchdog: the parent holds our stdin open, so
     EOF there means the parent is gone and we hard-exit — no orphan
     workers accumulating after a crashed router;
  3. open the device: on CUDA, refuse to start unless the chunk
     kernel's library is built (the parent builds it before spawning;
     a worker never runs nvcc), then create the context;
  4. build + start the service on that device, `prewarm()` the shared
     artifact dir (`MPISPPY_TPU_COMPILE_CACHE_DIR/aot`, inherited env)
     so the first request of every previously-seen shape runs warm;
  5. bind 127.0.0.1:0, then atomically write the portfile — the parent
     polls for it; a complete portfile means "ready to serve".

Wire surface: the replica verbs (`submit/poll/peek/peek_many/statuses/
health/drain/warm_from/shutdown`), one frame in → one frame out per connection in
FIFO order (so the parent's pipelined PooledClient can match responses
without ids; the `seq` header is echoed as a cross-check).  Responses
reuse the gateway's frame shapes.

Layering: module-level imports are stdlib + serve/net/protocol +
serve/request only — torch loads when `main()` opens the device,
never at import time.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time

from .net import protocol as P
from .request import RequestHandle

#: the verbs this worker serves (a subset of protocol.VERBS plus the
#: replica-only ones the gateway rejects)
WORKER_VERBS = ("submit", "poll", "peek", "peek_many", "statuses",
                "health", "drain", "warm_from", "shutdown")


class WorkerServer:
    """The in-process half of one process replica: a SolverService
    behind a loopback wire endpoint (see module docstring)."""

    def __init__(self, options=None, token="", host="127.0.0.1",
                 max_payload=P.DEFAULT_MAX_PAYLOAD, device=None):
        self.options = dict(options or {})
        self.device = device
        self.token = token
        self.host = host
        self.max_payload = int(max_payload)
        self.service = None
        self.port = None
        self.boot_seconds = None
        self.prewarm_loaded = 0
        self._sock = None
        self._stopped = False
        self._done = threading.Event()

    # -- lifecycle --------------------------------------------------------
    def start(self):
        """Build + start the service (heavy: first torch import),
        prewarm the artifact set, then open the loopback endpoint."""
        t0 = time.monotonic()
        from . import compile_cache as _cc
        from .service import SolverService
        self.service = SolverService(self.options,
                                     device=self.device).start()
        if self.options.get("serve_prewarm", True):
            self.prewarm_loaded = _cc.prewarm()
        self.boot_seconds = time.monotonic() - t0
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.host, 0))
        sock.listen(64)
        self._sock = sock
        self.port = sock.getsockname()[1]
        threading.Thread(target=self._accept_main,
                         name="procworker-accept", daemon=True).start()
        return self

    def wait(self):
        """Block until a shutdown verb lands (the worker main loop)."""
        while not self._done.wait(0.5):
            pass

    def stop(self):
        self._stopped = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._done.set()

    # -- connection handling ----------------------------------------------
    def _accept_main(self):
        while not self._stopped:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return                 # listener closed: shutting down
            threading.Thread(target=self._conn_main, args=(conn,),
                             name="procworker-conn", daemon=True).start()

    def _conn_main(self, conn):
        """One connection's frames, strictly in order — the FIFO
        contract the parent's pipelined client relies on."""
        try:
            while not self._stopped:
                header, payload = P.read_message(
                    conn, max_payload=self.max_payload)
                if header is None:
                    return             # clean EOF
                try:
                    resp, rpayload = self._dispatch(header, payload)
                except P.ProtocolError as exc:
                    resp, rpayload = self._error(
                        P.E_BAD_PAYLOAD, str(exc))
                except Exception as exc:
                    resp, rpayload = self._error(P.E_INTERNAL,
                                                 repr(exc))
                if "seq" in header:
                    resp["seq"] = header["seq"]
                conn.sendall(P.pack_message(resp, rpayload))
        except (P.ProtocolError, ConnectionError, OSError):
            pass                       # torn stream: client reconnects
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- frames ------------------------------------------------------------
    def _error(self, code, message):
        return {"kind": "response", "ok": False, "error_code": code,
                "error": str(message)[:2000]}, b""

    def _ok(self, verb, result=None, payload=b""):
        hdr = {"kind": "response", "ok": True, "verb": verb,
               "error_code": None}
        if result is not None:
            hdr["result"] = result
        return hdr, payload

    def _dispatch(self, header, payload):
        verb = header.get("verb")
        if verb not in WORKER_VERBS:
            return self._error(P.E_BAD_VERB, f"unknown verb {verb!r}")
        if header.get("token") != self.token:
            return self._error(P.E_UNAUTHORIZED,
                               "worker token mismatch")
        return getattr(self, f"_verb_{verb}")(header, payload)

    # -- verbs -------------------------------------------------------------
    def _verb_submit(self, header, payload):
        batch = P.decode_batch(payload)
        h = self.service.submit(
            batch, options=header.get("options"),
            scenario_names=header.get("scenario_names"),
            deadline=header.get("deadline"),
            model=header.get("model"))
        return self._ok("submit", {"handle": h.id})

    def _verb_poll(self, header, payload):
        h = RequestHandle(int(header.get("handle", -1)))
        return self._ok("poll", {"state": self.service.poll(h)})

    def _verb_peek(self, header, payload):
        """Non-blocking terminal-result fetch, mirroring
        replica.Replica.peek: {"pending": true} until the inner request
        is done, then the encoded result (npz payload, bit-exact)."""
        rid = int(header.get("handle", -1))
        req = self.service._requests.get(rid)
        if req is None or not req.done.is_set():
            return self._ok("peek", {"pending": True})
        res = self.service._results.get(rid)
        if res is None:                # finished-but-unrecorded race
            return self._ok("peek", {"pending": True})
        scalars, rpayload = P.encode_result(res)
        return self._ok("peek", {"pending": False,
                                 "result": scalars}, rpayload)

    def _verb_peek_many(self, header, payload):
        """Bulk terminal-result fetch: every done handle's result in
        ONE frame.  When a group of 8 completes, per-handle peeks cost
        8 round trips of pure tail latency (the device is idle by
        then); this returns the whole group at once.  Payload is the
        per-result npz blobs concatenated, with `sizes` ([rid, nbytes]
        in payload order) as the slicing map."""
        done, sizes, blobs, unknown = {}, [], [], []
        for rid in header.get("handles") or ():
            rid = int(rid)
            req = self.service._requests.get(rid)
            if req is None:
                unknown.append(rid)    # caller stops tracking it
                continue
            if not req.done.is_set():
                continue
            res = self.service._results.get(rid)
            if res is None:            # finished-but-unrecorded race
                continue
            scalars, rpayload = P.encode_result(res)
            done[str(rid)] = scalars
            sizes.append([rid, len(rpayload)])
            blobs.append(rpayload)
        return self._ok("peek_many", {"results": done, "sizes": sizes,
                                      "unknown": unknown},
                        b"".join(blobs))

    def _verb_statuses(self, header, payload):
        """Bulk done-ness check: ONE frame answers the router's whole
        scan tick.  Per-handle `peek`s at scan cadence would mean
        hundreds of frames per second, each waking a connection thread
        that contends the GIL against the dispatch thread's
        per-iteration host work — the convoy shows up directly as
        solve throughput."""
        out = {}
        for rid in header.get("handles") or ():
            req = self.service._requests.get(int(rid))
            if req is None:
                out[str(rid)] = "unknown"
            else:
                out[str(rid)] = "done" if req.done.is_set() \
                    else "pending"
        return self._ok("statuses", {"statuses": out})

    def _verb_health(self, header, payload):
        h = dict(self.service.health())
        # sets are not JSON: the parent-side ProcReplica restores this
        h["crash_suspects"] = sorted(h.get("crash_suspects") or ())
        h["replica_mode"] = "process"
        h["pid"] = os.getpid()
        h["cache"] = self.service.cache.stats()
        h["prewarm_loaded"] = self.prewarm_loaded
        h["boot_seconds"] = self.boot_seconds
        return self._ok("health", h)

    def _verb_drain(self, header, payload):
        info = self.service.drain(
            deadline=float(header.get("deadline", 1.0)),
            checkpoint_path=header.get("checkpoint_path"))
        ckpt = info.get("checkpoint")
        return self._ok("drain", {
            "drained": int(info.get("drained", 0)),
            "checkpoint": None if ckpt is None else str(ckpt)})

    def _verb_warm_from(self, header, payload):
        out = self.service.warm_from(header.get("path"))
        if isinstance(out, list):
            return self._ok("warm_from", {
                "adopted": [[int(sid), int(h.id)] for sid, h in out]})
        return self._ok("warm_from", {"error": P.jsonable(out)})

    def _verb_shutdown(self, header, payload):
        timeout = float(header.get("timeout", 5.0))

        def _finish():
            time.sleep(0.05)           # let the reply frame flush
            try:
                self.service.shutdown(timeout=timeout)
            finally:
                self.stop()

        threading.Thread(target=_finish, name="procworker-shutdown",
                         daemon=True).start()
        return self._ok("shutdown", {"stopping": True})


def _open_device(device):
    """The worker's torch.device; a CUDA worker refuses to start
    without the parent's kernel library, then opens its context."""
    import torch

    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import pdhg_chunk
        if not pdhg_chunk.library_path().exists():
            raise RuntimeError(
                "the chunk kernel's library is not built "
                f"({pdhg_chunk.library_path()}): the parent builds it "
                "before spawning (procpool.prebuild)")
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    return dev


def _watch_parent():
    """Hard-exit when the parent disappears: the parent holds our stdin
    pipe open for our whole life, so EOF means it's gone.  `os._exit`
    on purpose — an orphan must not linger to flush anything."""
    try:
        sys.stdin.buffer.read()
    except Exception:
        pass
    os._exit(2)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 1:
        print("usage: python -m mpisppy_tpu_torch.serve.procworker "
              "<cfg.json>", file=sys.stderr)
        return 2
    with open(argv[0]) as f:
        cfg = json.load(f)
    threading.Thread(target=_watch_parent, name="procworker-watchdog",
                     daemon=True).start()
    device = _open_device(cfg.get("device") or "cuda")
    server = WorkerServer(cfg.get("options") or {},
                          token=cfg.get("token", ""), device=device)
    server.start()
    portfile = cfg["portfile"]
    tmp = portfile + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"port": server.port, "pid": os.getpid(),
                   "boot_seconds": server.boot_seconds,
                   "prewarm_loaded": server.prewarm_loaded}, f)
    os.replace(tmp, portfile)
    server.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
