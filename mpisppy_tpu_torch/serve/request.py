"""Request/result envelope types for the serve layer (a copy of
`mpisppy_tpu/serve/request.py`).

Deliberately free of torch (like telemetry/): clients import these
through `serve.api` without starting a CUDA context.  A request moves
through

    QUEUED -> RUNNING -> {OK, TIMEOUT, FAILED}
           -> REJECTED (admission control, never entered the queue)

and every terminal transition produces a STRUCTURED result dict (never
an exception into the dispatch thread, never a hang for the client):
the `status` key always holds one of the constants below, and on
success the remaining keys are exactly `PH.solution_dict()` — the same
values `PH.ph_main` returns.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

QUEUED = "queued"
RUNNING = "running"
OK = "ok"
TIMEOUT = "timeout"
REJECTED = "rejected"
FAILED = "failed"

TERMINAL = (OK, TIMEOUT, REJECTED, FAILED)


@dataclasses.dataclass(frozen=True)
class RequestHandle:
    """Opaque ticket returned by submit(); poll/result take it back."""
    id: int


@dataclasses.dataclass(frozen=True)
class RouterHandle:
    """Opaque ticket returned by Router.submit() (serve/router.py).
    Distinct from RequestHandle on purpose: one router request may map
    to SEVERAL inner service requests over its life (hedges, replays,
    warm_from adoptions), and only the router may translate between
    the two id spaces."""
    id: int


@dataclasses.dataclass
class SolveRequest:
    """One queued solve: the batch + options the client handed in,
    plus the service-side bookkeeping (deadline is ABSOLUTE monotonic
    seconds; bucket is filled lazily at dispatch time)."""
    id: int
    batch: Any
    options: dict
    scenario_names: Any = None
    model: str | None = None
    deadline: float | None = None
    submitted: float = 0.0
    bucket: Any = None
    attempts: int = 0
    status: str = QUEUED
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def expired(self, now=None):
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) > self.deadline


def _base(req_id, status, **kw):
    d = {"status": status, "request_id": req_id}
    d.update(kw)
    return d


def timeout_result(req, where, **kw):
    """Deadline exceeded — `where` says at which stage (queued /
    dispatch / iteration / result_wait) the clock ran out."""
    return _base(req.id, TIMEOUT, where=where,
                 wall_s=time.monotonic() - req.submitted, **kw)


def rejected_result(req_id, reason):
    return _base(req_id, REJECTED, reason=reason)


def failed_result(req_id, reason, **kw):
    return _base(req_id, FAILED, reason=reason, **kw)
