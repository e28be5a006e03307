"""Solver-as-a-service on the card (port of `mpisppy_tpu/serve/`).

Modules:

  * `compile_cache` — shape buckets: one canonical solver per (model,
    scenario count, stage dims, operator form and delta pattern,
    dtype, device, solver config) bucket, the route and kernel variant
    each group width takes, and their on-disk artifacts
    (magic + header JSON + CRC32 + fingerprint), which a cold process
    loads instead of recomputing;
  * `service` — SolverService: bounded queue, admission control,
    deadline handling (structured timeout results, never a hang), a
    dispatch loop that coalesces same-bucket requests into ONE group
    solve (one chunk-kernel launch a chunk for the whole group), and
    supervised, chaos-injectable worker restarts;
  * `replica` — Replica/ReplicaSet: N supervised services as isolated
    fault domains on one device, with slot-targeted chaos and
    replace-and-warm_from;
  * `procpool`/`procworker` — ProcReplica/ProcReplicaSet: the same
    replica surface backed by one OS process per slot
    (`serve_replica_mode="process"`), each with its own CUDA context,
    talking the serve/net wire protocol over loopback;
  * `router` — the replica-set front door: health-probed circuit
    breakers, hedged retries made safe by idempotency keys, per-tenant
    token-bucket quotas, a brownout ladder, and replace-and-replay of
    requests stranded on a dead replica;
  * `api` — submit/poll/result handles + synchronous solve() over a
    process-global router (serve_replicas=1 by default);
  * `request` — request/result envelope types.

Importing this package, `api`, `request`, `router`, `replica`,
`net.protocol` or `net.client` never imports torch (checked in
tests/test_torch_no_jax.py): a front-door process starts no CUDA
context until a replica dispatches.  Services run on the CUDA device
unless the caller passes `device="cpu"`.
"""

from .api import (RequestHandle, RouterHandle, get_service,  # noqa: F401
                  poll, result, shutdown_service, solve,
                  start_service, submit)

__all__ = [
    "RequestHandle", "RouterHandle", "SolverService", "CompileCache",
    "bucket_key", "Router", "Replica", "ReplicaSet", "ProcReplica",
    "ProcReplicaSet", "CircuitBreaker", "TokenBucket", "get_service",
    "poll", "result", "shutdown_service", "solve", "start_service",
    "submit",
]


def __getattr__(name):
    # lazy heavyweights: SolverService/CompileCache pull in the solver
    # stack (and torch) — resolved only when actually used.
    # Router/Replica are themselves torch-free but construct services,
    # so they stay lazy for symmetry.
    if name == "SolverService":
        from .service import SolverService
        return SolverService
    if name in ("CompileCache", "bucket_key"):
        from . import compile_cache as _cc
        return getattr(_cc, name)
    if name in ("Router", "CircuitBreaker", "TokenBucket"):
        from . import router as _router
        return getattr(_router, name)
    if name in ("Replica", "ReplicaSet"):
        from . import replica as _replica
        return getattr(_replica, name)
    if name in ("ProcReplica", "ProcReplicaSet"):
        from . import procpool as _procpool
        return getattr(_procpool, name)
    raise AttributeError(name)
