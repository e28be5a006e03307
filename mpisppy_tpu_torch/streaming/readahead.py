"""Bounded readahead over a ShardStore and the ShardSource adapter
(port of `mpisppy_tpu/streaming/readahead.py`).

`ReadaheadCache` is the storage analog of ScenarioStream's double
buffer: one daemon reader pulls upcoming shard ids off a bounded
prefetch queue and parks validated batches in a small LRU, so the
shards of a block are (ideally) resident when the stream worker
gathers it.  Measured, not assumed:

  * `store.readahead_hits` / `store.readahead_misses` — was the shard
    known to the prefetcher when demanded?
  * `store.readahead_hit_rate` — the running hit fraction;
  * `store.read_wait_seconds` — seconds the demanding thread blocked
    per shard fetch.

`ShardSource` adapts a ShardStore to the ScenarioSource protocol: it
substitutes quarantined seed indices, groups the served indices by
shard, reads every shard through the cache (and so through
`ShardStore.read_checked`), gathers each shard's part and concatenates
them block-uniform.  Its `block_with_indices` returns the indices
actually served, so the stream absorbs substituted blocks under the
right rows.  Blocks are batches of CPU tensors.
"""

from __future__ import annotations

import collections
import threading
import time

import numpy as np

from .. import telemetry as _telemetry
from .source import ScenarioSource, gather_block
from .store import (QuarantinedCorpusError, ShardQuarantinedError,
                    ShardStore, ShardStoreError, concat_blocks)


class ReadaheadCache:
    """Depth-bounded prefetch queue + LRU of validated shard batches,
    serviced by ONE daemon reader (the store's reads are serialized by
    construction, matching its thread-safety contract).

    `schedule(sids)` is the best-effort HINT path (drops work past the
    depth cap rather than queueing unboundedly); `get(sid)` is the
    DEMAND path (enqueues unconditionally and blocks until the read
    lands).  Read errors are cached as poisoned entries, re-raised to
    the demander, and dropped — a later substitution pass never sees a
    stale failure."""

    def __init__(self, store, depth=4, capacity=None, telemetry=None):
        self.store = store
        self.depth = max(1, int(depth))
        self.capacity = (int(capacity) if capacity
                         else max(2 * self.depth, 8))
        self._tel = (telemetry if telemetry is not None
                     else _telemetry.get())
        self._cond = threading.Condition()
        self._queue = collections.deque()
        self._pending = set()          # queued or in-flight shard ids
        self._cache = collections.OrderedDict()  # sid -> (kind, value)
        self._closed = False
        self.hits = 0
        self.misses = 0
        self.wait_seconds = 0.0
        self._thread = threading.Thread(
            target=self._run, name="shard-readahead", daemon=True)
        self._thread.start()

    # -- reader thread ----------------------------------------------------
    def _run(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if self._closed:
                    return
                sid = self._queue.popleft()
            try:
                entry = ("ok", self.store.read_checked(sid))
            except BaseException as e:     # noqa: BLE001 - relayed
                entry = ("err", e)
            with self._cond:
                self._cache[sid] = entry
                self._cache.move_to_end(sid)
                # LRU-evict, but never a shard someone still awaits
                while len(self._cache) > self.capacity:
                    for old in self._cache:
                        if old != sid:
                            del self._cache[old]
                            break
                    else:
                        break
                self._pending.discard(sid)
                self._cond.notify_all()

    # -- hint path --------------------------------------------------------
    def schedule(self, sids):
        """Queue upcoming shard ids for prefetch; silently drops the
        tail past the depth cap (a hint is best-effort — demand reads
        bypass the cap)."""
        with self._cond:
            if self._closed:
                return
            for sid in sids:
                sid = int(sid)
                if sid in self._cache or sid in self._pending:
                    continue
                if len(self._pending) >= self.depth:
                    break
                self._pending.add(sid)
                self._queue.append(sid)
            self._cond.notify_all()

    # -- demand path ------------------------------------------------------
    def get(self, sid):
        """Return shard `sid`'s validated batch, blocking until the
        reader lands it.  Counts a HIT when the shard was already
        known to the prefetcher (resident or in flight) — the signal
        that the hint pipeline saw this demand coming."""
        sid = int(sid)
        t0 = time.monotonic()
        with self._cond:
            if sid in self._cache or sid in self._pending:
                self.hits += 1
                hit = True
            else:
                self.misses += 1
                hit = False
            while True:
                entry = self._cache.get(sid)
                if entry is not None:
                    break
                if self._closed:
                    raise ShardStoreError(
                        "readahead cache closed while a demand read "
                        f"for shard {sid} was outstanding")
                if sid not in self._pending:
                    self._pending.add(sid)
                    self._queue.append(sid)
                self._cond.notify_all()
                self._cond.wait()
            kind, value = entry
            self._cache.move_to_end(sid)
            if kind == "err":
                del self._cache[sid]
        waited = time.monotonic() - t0
        self.wait_seconds += waited
        if self._tel.enabled:
            r = self._tel.registry
            r.counter("store.readahead_hits" if hit
                      else "store.readahead_misses").inc()
            r.gauge("store.readahead_hit_rate").set(self.hit_rate)
            r.histogram("store.read_wait_seconds").observe(waited)
        if kind == "err":
            raise value
        return value

    @property
    def hit_rate(self):
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def stats(self):
        return {
            "readahead_hits": int(self.hits),
            "readahead_misses": int(self.misses),
            "readahead_hit_rate": float(self.hit_rate),
            "read_wait_seconds": float(self.wait_seconds),
            "readahead_depth": int(self.depth),
        }

    def close(self):
        with self._cond:
            self._closed = True
            self._queue.clear()
            self._pending.clear()
            self._cond.notify_all()
        self._thread.join(timeout=5.0)


class ShardSource(ScenarioSource):
    """ScenarioSource over an on-disk shard corpus.

    Block service pipeline (all host-side, runs on the stream worker):
      1. `substitute_quarantined` — indices in quarantined shards are
         deterministically resampled from healthy ones;
      2. group the served indices by shard, `schedule` them all, then
         `get` each (validated, readahead-overlapped);
      3. `gather_block` each shard's contribution, `concat_blocks`
         into ONE block-uniform batch.
    A shard quarantined MID-block restarts the pipeline from the
    ORIGINAL index set against the grown quarantine set — substitution
    is a pure function of (indices, quarantine set), which is what
    makes a crash-resumed run (quarantine set restored from the
    storage cursor) replay identical blocks."""

    def __init__(self, store, depth=4, name=None, telemetry=None,
                 **store_kw):
        if not isinstance(store, ShardStore):
            store = ShardStore(store, telemetry=telemetry, **store_kw)
        self.store = store
        self.name = str(name if name is not None else store.model)
        self.total_scens = int(store.total_scens)
        self.readahead = ReadaheadCache(store, depth=depth,
                                        telemetry=telemetry)

    # -- ScenarioSource protocol ------------------------------------------
    def block_with_indices(self, indices):
        orig = np.sort(np.asarray(indices, dtype=np.int64))
        if orig.size == 0:
            raise ValueError("empty scenario block")
        if orig[0] < 0 or orig[-1] >= self.total_scens:
            raise IndexError(
                f"block indices out of range [0, {self.total_scens})")
        store = self.store
        for _ in range(store.n_shards + 1):
            served = store.substitute_quarantined(orig)
            sids = np.unique(served // store.shard_width)
            self.readahead.schedule(int(s) for s in sids)
            parts = []
            try:
                for sid in sids:
                    sid = int(sid)
                    shard = self.readahead.get(sid)
                    lo, _hi = store.shard_range(sid)
                    local = served[served // store.shard_width
                                   == sid] - lo
                    parts.append(gather_block(shard, local))
            except ShardQuarantinedError:
                continue       # re-substitute against the grown set
            return served, concat_blocks(parts)
        raise QuarantinedCorpusError(
            "block service could not converge: every substitution "
            "round quarantined another shard")

    def block(self, indices):
        return self.block_with_indices(indices)[1]

    def note_upcoming(self, indices):
        """Readahead hint: schedule the shards the NEXT block will
        demand.  Substitution runs in dry-run mode (count=False) so
        the hint path never double-counts resampled indices."""
        idx = np.sort(np.asarray(indices, dtype=np.int64))
        if idx.size == 0:
            return
        served = self.store.substitute_quarantined(idx, count=False)
        self.readahead.schedule(
            int(s) for s in np.unique(served // self.store.shard_width))

    def names(self, indices):
        fmt = self.store.meta.get("name_format")
        if fmt:
            return [fmt.format(i=int(i), i1=int(i) + 1)
                    for i in np.asarray(indices)]
        return super().names(indices)

    def stats(self):
        out = self.store.stats()
        out.update(self.readahead.stats())
        return out

    def close(self):
        self.readahead.close()
