"""Client API for the serve layer: submit / poll / result handles plus
a synchronous solve() wrapper over a process-global front door (port
of `mpisppy_tpu/serve/api.py`).

The front door is a `Router` (serve/router.py) over a replica set —
circuit breakers, hedged retries, tenant quotas, and brownout
degradation all live behind these same five calls.  By default the
router runs ONE replica (`serve_replicas=1`), which behaves exactly
like the old direct-SolverService wiring; pass `serve_replicas >= 2`
in options to get real fault isolation.  Replicas are in-process
threads by default; `serve_replica_mode="process"` backs each slot
with its own OS process (serve/procpool.py) so device execution
parallelizes past the in-process `_BACKEND_LOCK` — same five calls,
same results (batch=1 stays bitwise-equal to `PH.ph_main`).

IMPORT CONTRACT: importing this module touches neither torch nor the
service machinery — clients embed it for free (checked in
tests/test_torch_no_jax.py, the telemetry-guard pattern).  The heavy
imports happen inside `start_service` on first use.  The replicas run
on the CUDA device unless `start_service(device="cpu")` says otherwise.

    from mpisppy_tpu_torch.serve import api

    api.start_service({"serve_replicas": 1}, device="cpu")
    h = api.submit(batch, {"defaultPHrho": 1.0})  # returns instantly
    api.poll(h)                                    # "queued"/"running"/...
    res = api.result(h, timeout=60)                # structured, never hangs

    res = api.solve(batch, opts)                   # submit+result in one
    # res["conv"], res["eobj"], res["trivial_bound"]: the same values
    # PH.ph_main returns (bitwise identical at batch=1)
"""

from __future__ import annotations

import threading

from .request import (RequestHandle,  # noqa: F401  (re-export)
                      RouterHandle)   # noqa: F401

_router = None
_lock = threading.Lock()


def start_service(options=None, device=None):
    """Start (or return) the process-global Router.  `options` and
    `device` only apply when the router is first created;
    `serve_replicas` defaults to 1 here (the single-replica router is
    behaviourally the old direct service, plus admission/deadline
    uniformity)."""
    global _router
    with _lock:
        if _router is None:
            from .router import Router
            o = dict(options or {})
            o.setdefault("serve_replicas", 1)
            _router = Router(o, device=device)
    return _router.start()


def get_service():
    """The process-global router, or None if never started."""
    return _router


def submit(batch, options=None, **kwargs):
    """Enqueue a solve on the global router; returns a RouterHandle."""
    return start_service().submit(batch, options, **kwargs)


def poll(handle):
    r = _router
    if r is None:
        return "unknown"
    return r.poll(handle)


def result(handle, timeout=None):
    r = _router
    if r is None:
        return {"status": "unknown", "request_id": handle.id}
    return r.result(handle, timeout=timeout)


def solve(batch, options=None, **kwargs):
    """Synchronous convenience wrapper: the result dict carries the
    same solution values as `PH.ph_main` (see PH.solution_dict)."""
    return start_service().solve(batch, options, **kwargs)


def shutdown_service(timeout=60.0):
    """Drain and stop the global router (a later call starts a fresh
    one)."""
    global _router
    with _lock:
        r, _router = _router, None
    if r is not None:
        r.shutdown(timeout)


def start_gateway(options=None, host="127.0.0.1", port=0, device=None):
    """Start a network `Gateway` (serve/net/) over the process-global
    router — the socket front door to the same five calls.  The
    gateway does NOT own the router: `shutdown_service()` still owns
    its lifecycle, and a gateway shutdown only closes the socket edge.
    Returns the started Gateway; read `.address` for the bound
    (host, port)."""
    from .net.gateway import Gateway
    return Gateway(options, router=start_service(options, device=device),
                   host=host, port=port).start()
