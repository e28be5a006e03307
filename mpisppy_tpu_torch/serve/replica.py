"""Replica — one supervised SolverService as an isolated fault domain
(a copy of `mpisppy_tpu/serve/replica.py`).

The single in-process `SolverService` (serve/service.py) is the whole
blast radius: one worker crash, hang, or poison request takes every
tenant down with it.  This module splits the service tier into N
independent fault domains:

  * each `Replica` owns its OWN SolverService — its own dispatch
    thread, its own bounded queue, its own CompileCache handle, its
    own chaos injector — so nothing short of the process dying can
    couple two replicas' failures;
  * a `ReplicaSet` owns the slots: it builds the initial replicas,
    targets chaos at exactly one slot (`chaos_replica`), and replaces
    a dead replica with a fresh incarnation whose injected fault is
    CLEARED (a transient fault does not follow the slot) — only
    `poison_request` survives replacement, because poison follows the
    request, not the replica.

Layering: this module imports no torch at module level (checked in
tests/test_torch_no_jax.py) and is driven only by serve/router.py; the
heavy service machinery loads on first replica construction.  The
replicas of a set run on one device (`serve_device` in the options,
default the CUDA device), their device work serialized by the
service's `_BACKEND_LOCK`.
"""

from __future__ import annotations

import time

# chaos keys that target ONE slot's FIRST incarnation only: the fault
# is an event that happened to that replica, not a property of the slot
_SLOT_CHAOS = ("replica_crash", "slow_replica", "crash_at_step",
               "crash_at_iter", "hang_at_step", "dispatch_delay_s")
# chaos keys that arm EVERY replica, every incarnation: the fault
# travels with the request, so a hedge or replay re-triggers it
_GLOBAL_CHAOS = ("poison_request",)


class Replica:
    """One fault domain: a SolverService plus the set bookkeeping.

    `name` is "r<slot>i<incarnation>" — stable across the replica's
    life, unique across replacements, and the label every router
    telemetry event carries."""

    def __init__(self, slot, incarnation, options, chaos=None):
        from .service import SolverService
        self.slot = int(slot)
        self.incarnation = int(incarnation)
        self.name = f"r{self.slot}i{self.incarnation}"
        o = dict(options or {})
        o["chaos"] = dict(chaos or {})
        # each replica gets its own compile-cache handle (cache=None:
        # the service builds one) — a wedged or corrupted cache dies
        # with its replica instead of poisoning the peers
        self.service = SolverService(o)
        self.condemned = False        # router: replacement in progress
        self.assigned = {}            # inner request id -> router rid

    # -- service passthrough ---------------------------------------------
    def start(self):
        self.service.start()
        return self

    def submit(self, batch, options=None, scenario_names=None,
               deadline=None, model=None):
        return self.service.submit(batch, options,
                                   scenario_names=scenario_names,
                                   deadline=deadline, model=model)

    def poll(self, handle):
        return self.service.poll(handle)

    def peek(self, handle):
        """Non-blocking terminal-result fetch: the result dict when the
        inner request is done, else None (never a timeout snapshot —
        the router's monitor loop polls, it does not wait)."""
        req = self.service._requests.get(handle.id)
        if req is None or not req.done.is_set():
            return None
        return self.service._results.get(handle.id)

    def health(self):
        return self.service.health()

    def cache_stats(self):
        """This replica's CompileCache.stats() dict — the duck-typed
        surface Router.stats() merges (process replicas report the same
        dict over the wire, so the router never touches a cache
        object)."""
        return self.service.cache.stats()

    @property
    def failed(self):
        return self.service._failed is not None

    def drain(self, deadline=1.0, checkpoint_path=None):
        return self.service.drain(deadline=deadline,
                                  checkpoint_path=checkpoint_path)

    def warm_from(self, path):
        return self.service.warm_from(path)

    def shutdown(self, timeout=5.0):
        self.service.shutdown(timeout=timeout)


class ReplicaSet:
    """The N slots behind the router.

    Chaos targeting: `options["chaos"]` may carry the serve-replica
    fault keys plus `chaos_replica` (default 0) naming the slot they
    hit.  Slot-targeted keys reach only that slot's FIRST incarnation;
    `poison_request` arms every replica (see module docstring)."""

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
        self.incarnations = [0] * self.n
        self.replacements = 0
        self.replicas = [self._build(slot) for slot in range(self.n)]

    def _chaos_for(self, slot, incarnation):
        cfg = {k: self.chaos[k] for k in _GLOBAL_CHAOS if k in self.chaos}
        if slot == self.chaos_slot and incarnation == 0:
            cfg.update({k: self.chaos[k] for k in _SLOT_CHAOS
                        if k in self.chaos})
        return cfg

    def _build(self, slot):
        inc = self.incarnations[slot]
        return Replica(slot, inc, self.options,
                       chaos=self._chaos_for(slot, inc))

    def start(self):
        for r in self.replicas:
            r.start()
        return self

    def __iter__(self):
        return iter(self.replicas)

    def __len__(self):
        return self.n

    def __getitem__(self, slot):
        return self.replicas[slot]

    def replace(self, slot, drain_deadline=1.0, checkpoint_path=None):
        """Swap the slot's corpse for a fresh incarnation: drain the
        old service (leftovers checkpointed when a path is given),
        build + start the replacement, and warm it from the drain file
        when one was written.  Returns (new_replica, drain_info,
        adopted) where `adopted` is warm_from's (old_inner_id, handle)
        list — the router re-binds those to its own request table."""
        corpse = self.replicas[slot]
        corpse.condemned = True
        drain_info = corpse.drain(deadline=drain_deadline,
                                  checkpoint_path=checkpoint_path)
        corpse.shutdown(timeout=drain_deadline)
        self.incarnations[slot] += 1
        self.replacements += 1
        fresh = self._build(slot).start()
        self.replicas[slot] = fresh
        adopted = []
        saved = drain_info.get("checkpoint")
        if saved:
            out = fresh.warm_from(saved)
            # a corrupt drain file yields a structured error dict; the
            # replacement still goes live empty and the router replays
            # through its own table instead
            if isinstance(out, list):
                adopted = out
        return fresh, drain_info, adopted

    def shutdown(self, timeout=5.0):
        deadline = time.monotonic() + float(timeout)
        for r in self.replicas:
            r.shutdown(timeout=max(0.1, deadline - time.monotonic()))
