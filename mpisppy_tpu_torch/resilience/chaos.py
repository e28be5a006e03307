"""Fault injection ("chaos") layer (port of
`mpisppy_tpu/resilience/chaos.py`, whole: the same config keys, the
same fates, the same MPISPPY_TPU_CHAOS override).

Deterministic injectors that exercise every degradation path of the
wheel end to end: a spoke that crashes (softly or via a hard
`os._exit`, the SIGKILL stand-in), hangs, poisons its published bound
with NaN, or delays its window writes; plus a hub-side crash-at-iter
used by the checkpoint/resume tests.

Configuration comes from the owner's options dict under the "chaos"
key (JSON-serializable, so it crosses the multiproc spec boundary in
`cylinders/proc.py` untouched), optionally overridden by the
`MPISPPY_TPU_CHAOS` environment variable (a JSON dict — for manual
chaos runs against an unmodified driver).

Injection points (all no-ops when unconfigured; the streaming, shard
store and serve ticks wait for the port of those layers, ROADMAP.md
queue A items 12 and 13):
  * `Spoke.spoke_from_hub` calls `step_tick()` once per read — the
    spoke-side step clock (crash_at_step / hang_at_step /
    hard_exit).
  * `Spoke.spoke_to_hub` routes outgoing vectors through
    `poison()` (nan_bound) and `pre_write()` (delay_write_s).
  * `PHBase.iterk_loop` calls `hub_iter_tick(k)` after the iter-k
    checkpoint is written (crash_at_iter).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

ENV_VAR = "MPISPPY_TPU_CHAOS"


class ChaosError(RuntimeError):
    """An injected failure (never raised outside chaos runs)."""


class DeviceLossError(ChaosError):
    """An injected loss of the slice's device(s).

    Unlike a soft crash, the hardware is gone: SliceSupervisor treats
    this as unrestartable and prunes the slice immediately (skipping
    the restart budget), which triggers the elastic reslice path."""


class ChaosInjector:
    """One injector instance per owning cylinder; all state local.

    Config keys (all optional):
      crash_at_step: int   raise ChaosError on the N-th step tick
      hard_exit: bool      crash via os._exit(13) instead of raising
                           (no cleanup/atexit — the SIGKILL analog)
      hang_at_step: int    stop making progress on the N-th tick
                           (sleep loop; the process stays alive but
                           its window writes go stale)
      nan_bound: bool      replace every outgoing vector with NaN
      delay_write_s: float sleep before every outgoing write
      crash_at_iter: int   hub-side: raise ChaosError at PH iter N
                           (after that iteration's checkpoint)
      device_loss: int     raise DeviceLossError on the N-th step tick
                           (unrestartable: the supervisor prunes the
                           slice and reslices without burning restarts)
      corrupt_window: int  from the N-th outgoing write on, corrupt
                           the posted payload (checksum stays that of
                           the true values, so read_checked rejects)
      partition_slice: int from the N-th outgoing write on, silently
                           drop every write (the slice looks
                           partitioned away: its write_id goes stale
                           and hang pruning fires)
      block_build_fail: int streaming: fail the first N source block
                           builds (retry/backoff tests)
      io_delay: float      shard store: sleep before every shard read
                           attempt (slow-storage injection — feeds the
                           store.read_wait_seconds telemetry)
      io_error: int        shard store: raise OSError on the first N
                           shard read attempts (TRANSIENT — the
                           store's capped-backoff retry must recover
                           without quarantining anything)
      shard_corrupt: ids   shard store: flip payload bytes of these
                           shard ids after every disk read (int or
                           list).  The stored CRC stays HONEST (it
                           covers the true bytes), so read_checked's
                           checksum validation — not value hygiene —
                           must reject the shard; persistent, so the
                           retry budget exhausts and the shard is
                           quarantined
      shard_missing: ids   shard store: reads of these shard ids raise
                           FileNotFoundError (int or list; persistent
                           -> quarantine, like shard_corrupt)
      replica_crash: int   serve replica: raise ChaosError on EVERY
                           dispatch from the N-th on (exhausts the
                           service's worker-restart budget so the
                           whole replica fails closed — the router's
                           replace-and-replay path)
      slow_replica: float  serve replica: sleep this many seconds
                           before every dispatch (injected dispatch
                           latency — the hedged-retry trigger)
      poison_request: bool serve: a request whose options carry
                           `chaos_poison` crashes whichever replica
                           dispatches it (deterministically, every
                           time) — the router's poison budget must
                           quarantine it instead of hedge-amplifying
                           the crash across the replica set
    """

    HARD_EXIT_CODE = 13

    def __init__(self, config=None):
        self.config = dict(config or {})
        self.steps = 0
        self.writes = 0
        self.builds = 0
        self.shard_reads = 0

    @classmethod
    def from_options(cls, config=None):
        """Merge the options-dict config with the env override (env
        wins; an unset env and empty config yield an inert injector).
        """
        merged = dict(config or {})
        env = os.environ.get(ENV_VAR)
        if env:
            try:
                merged.update(json.loads(env))
            except ValueError:
                pass
        return cls(merged)

    @property
    def active(self):
        return bool(self.config)

    # -- spoke-side -------------------------------------------------------
    def step_tick(self):
        """Advance the spoke step clock; crash or hang on schedule."""
        if not self.config:
            return
        self.steps += 1
        c = self.config
        if c.get("hang_at_step") and self.steps >= int(c["hang_at_step"]):
            # stay alive but stop all progress: the supervisor must
            # notice via write_id staleness, not process death
            while True:          # pragma: no cover - killed externally
                time.sleep(0.25)
        if c.get("device_loss") and self.steps >= int(c["device_loss"]):
            raise DeviceLossError(
                f"injected device loss at step {self.steps}")
        if c.get("crash_at_step") and self.steps >= int(c["crash_at_step"]):
            if c.get("hard_exit"):
                # no cleanup, no atexit, nonzero rc — the in-process
                # stand-in for SIGKILL-ing the spoke
                os._exit(self.HARD_EXIT_CODE)
            raise ChaosError(
                f"injected spoke crash at step {self.steps}")
        if c.get("replica_crash") and self.steps >= int(c["replica_crash"]):
            raise ChaosError(
                f"injected replica crash at dispatch {self.steps}")

    # -- serve-side -------------------------------------------------------
    def pre_dispatch(self):
        """Injected dispatch latency (slow_replica): the serve dispatch
        thread sleeps before executing each group, so queued requests
        age past the router's hedge threshold while the replica stays
        alive and healthy-looking."""
        d = float(self.config.get("slow_replica", 0) or 0)
        if d > 0:
            time.sleep(d)

    def request_tick(self, options):
        """Poison-request injection: when poison_request is armed, a
        request whose options carry `chaos_poison` crashes the
        dispatching worker — every time, on every replica it is
        (re)tried on.  Only a router-level poison budget stops the
        blast radius."""
        if self.config.get("poison_request") \
                and (options or {}).get("chaos_poison"):
            raise ChaosError("injected poison request")

    def poison(self, values):
        """NaN-poison an outgoing vector (bound hygiene tests)."""
        if self.config.get("nan_bound"):
            return np.full_like(np.asarray(values, np.float64), np.nan)
        return values

    def pre_write(self):
        d = float(self.config.get("delay_write_s", 0) or 0)
        if d > 0:
            time.sleep(d)

    def write_fate(self):
        """"ok" | "drop" | "corrupt" for the next outgoing write.

        partition_slice drops writes (the slice goes silent — its
        heartbeat id stops advancing), corrupt_window flips the posted
        payload under an honest checksum so payload validation, not
        value hygiene, must catch it.  Both apply from the N-th write
        on, so heartbeat re-posts keep feeding the corrupt-read budget
        until the hub prunes the slice."""
        if not self.config:
            return "ok"
        self.writes += 1
        c = self.config
        if (c.get("partition_slice")
                and self.writes >= int(c["partition_slice"])):
            return "drop"
        if (c.get("corrupt_window")
                and self.writes >= int(c["corrupt_window"])):
            return "corrupt"
        return "ok"

    # -- streaming-side ---------------------------------------------------
    def block_build_tick(self):
        """Fail the first N scenario-block builds (streaming retry
        tests); the retry wrapper re-enters here on each attempt."""
        n = self.config.get("block_build_fail")
        if not n:
            return
        self.builds += 1
        if self.builds <= int(n):
            raise ChaosError(
                f"injected block build failure {self.builds}/{int(n)}")

    # -- shard-store-side -------------------------------------------------
    @staticmethod
    def _sid_set(v):
        """Normalize an id config value (int or iterable) to a set."""
        if v is None:
            return set()
        if isinstance(v, (int, float)):
            return {int(v)}
        return {int(s) for s in v}

    def shard_read_tick(self, sid):
        """One shard read ATTEMPT (the store's retry loop re-enters
        here per attempt): injected storage latency (io_delay), a
        transient I/O fault for the first `io_error` attempts, and the
        persistent missing-file fault for `shard_missing` ids."""
        if not self.config:
            return
        self.shard_reads += 1
        c = self.config
        d = float(c.get("io_delay", 0) or 0)
        if d > 0:
            time.sleep(d)
        if int(sid) in self._sid_set(c.get("shard_missing")):
            raise FileNotFoundError(
                f"injected missing shard {int(sid)}")
        n = c.get("io_error")
        if n and self.shard_reads <= int(n):
            raise OSError(
                f"injected io error on shard read "
                f"{self.shard_reads}/{int(n)}")

    def corrupt_shard_bytes(self, sid, data):
        """Flip the LAST byte of a shard file image when `sid` is in
        shard_corrupt — always inside the payload region, so the
        header parses but the HONEST stored CRC (computed over the
        true bytes) no longer matches: checksum validation, not value
        hygiene, must catch it."""
        if int(sid) not in self._sid_set(self.config.get("shard_corrupt")):
            return data
        if not data:
            return data
        return data[:-1] + bytes([data[-1] ^ 0xFF])

    # -- hub-side ---------------------------------------------------------
    def hub_iter_tick(self, k):
        """Crash the hub's PH loop at iteration k (checkpoint tests)."""
        at = self.config.get("crash_at_iter")
        if at is not None and int(k) == int(at):
            raise ChaosError(f"injected hub crash at iter {k}")
