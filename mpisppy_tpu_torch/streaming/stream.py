"""ScenarioStream — double-buffered block builds and transfers (port
of `mpisppy_tpu/streaming/stream.py`).

One daemon worker thread turns index sets into ready-to-solve blocks:

    prefetch(indices)   enqueue a block build (non-blocking)
    next_block()        blocking take of the oldest prefetched block
                        -> (indices, block)

The worker runs `source.block(indices)` (host tensors, the models'
numpy RNG) and then the caller's `transfer`.  StreamingPH hands in a
`BlockTransfer`, so block i+1's build and its host-to-card copy overlap
block i's solve.  A bounded output queue (depth 2) keeps at most two
blocks in flight.  Blocks come out in prefetch order, which makes a
streamed run a pure function of its prefetch sequence.

The copy to the card (`BlockTransfer`) runs on a CUDA stream of its
own, from pinned host memory with `non_blocking=True`, and records an
event.  `next_block` makes the consumer's current stream wait on that
event before anything touches the block, and calls `record_stream` on
the block's tensors for the consumer's stream, so the caching
allocator does not hand their memory to the copy stream again while a
solve still reads them.  A block read before its copy ends would be a
silent wrong answer.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from .. import telemetry as _telemetry


class StreamClosed(RuntimeError):
    pass


def _map_tensors(batch, fn):
    """The ScenarioBatch with `fn` applied to every tensor (its
    operator's and its tree's too)."""
    from ..ir import SplitA

    moved = {}
    for f in batch._TENSORS:
        v = getattr(batch, f)
        if v is None:
            continue
        if isinstance(v, SplitA):
            v = dataclasses.replace(v, **{k: fn(t) for k, t in
                                          v._fields().items()})
        else:
            v = fn(v)
        moved[f] = v
    tree = dataclasses.replace(batch.tree, node_of=fn(batch.tree.node_of),
                               prob=fn(batch.tree.prob))
    return dataclasses.replace(batch, tree=tree, **moved)


def batch_tensors(batch):
    """Every tensor of a ScenarioBatch, in a list."""
    out = []
    _map_tensors(batch, lambda t: out.append(t) or t)
    return out


class _InFlight:
    """A block whose copy to the card was issued on the transfer stream
    and may not have finished; `ready()` orders the consumer after it."""

    def __init__(self, block, event, device):
        self.block = block
        self.event = event
        self.device = device

    def ready(self):
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(self.event)
        for t in batch_tensors(self.block):
            t.record_stream(cur)
        return self.block


class BlockTransfer:
    """The host-to-device move of a stream's blocks.  `prepare` (e.g.
    padding to the block width) runs on the host first.  On CUDA the
    copy is asynchronous on a stream of this object's own; on the CPU
    the block is returned as it is.  A block whose tensors are not on
    the host is refused: the worker thread builds on the host only."""

    def __init__(self, device, prepare=None):
        self.device = torch.device(device)
        self.prepare = prepare
        self._stream = None
        self.copies = 0

    def __call__(self, block):
        if self.prepare is not None:
            block = self.prepare(block)
        if self.device.type != "cuda":
            return block.to(self.device)
        if any(t.device.type != "cpu" for t in batch_tensors(block)):
            raise RuntimeError(
                "BlockTransfer moves host-built blocks only: a source "
                "must build its blocks on the CPU")
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self._stream):
            moved = _map_tensors(
                block, lambda t: t.pin_memory().to(self.device,
                                                   non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        self.copies += 1
        return _InFlight(moved, event, self.device)


class ScenarioStream:
    """Prefetching block pipeline over a ScenarioSource."""

    def __init__(self, source, transfer=None, max_prefetch=2,
                 telemetry=None):
        self.source = source
        self.transfer = transfer
        self._tel = (telemetry if telemetry is not None
                     else _telemetry.get())
        self._in = queue.Queue()
        self._out = queue.Queue(maxsize=max(int(max_prefetch), 1))
        self._closed = False
        self.blocks_loaded = 0
        self.scenarios_streamed = 0
        self.prefetch_wait_s = 0.0
        self._worker = threading.Thread(
            target=self._run, name=f"scenario-stream-{source.name}",
            daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._in.get()
            if item is None:
                self._out.put(None)
                return
            indices = item
            try:
                # served-indices protocol: a quarantining ShardSource
                # may substitute unreadable indices, and the consumer
                # absorbs the block under the indices actually served
                fn = getattr(self.source, "block_with_indices", None)
                if fn is not None:
                    indices, block = fn(indices)
                else:
                    block = self.source.block(indices)
                if self.transfer is not None:
                    block = self.transfer(block)
                self._out.put((indices, block, None))
            except BaseException as e:  # surfaced on next_block()
                self._out.put((indices, None, e))

    def prefetch(self, indices):
        """Enqueue a block build; returns at once.  Blocks are built in
        prefetch order."""
        if self._closed:
            raise StreamClosed("stream is closed")
        self._in.put(np.asarray(indices, dtype=np.int64))

    def next_block(self):
        """Blocking take of the oldest prefetched block.  The seconds
        spent blocked accumulate in `prefetch_wait_s`
        (stream.prefetch_wait_seconds); a worker-side failure is raised
        here."""
        if self._closed:
            raise StreamClosed("stream is closed")
        t0 = time.monotonic()
        item = self._out.get()
        wait = time.monotonic() - t0
        if item is None:
            raise StreamClosed("stream worker exited")
        indices, block, err = item
        if err is not None:
            raise err
        if isinstance(block, _InFlight):
            block = block.ready()
        self.prefetch_wait_s += wait
        self.blocks_loaded += 1
        self.scenarios_streamed += int(indices.size)
        if self._tel.enabled:
            r = self._tel.registry
            r.counter("stream.blocks_loaded").inc()
            r.counter("stream.scenarios_streamed").inc(int(indices.size))
            r.histogram("stream.prefetch_wait_seconds").observe(wait)
        return indices, block

    def close(self):
        """Stop the worker (idempotent); pending prefetches are
        abandoned."""
        if self._closed:
            return
        self._closed = True
        self._in.put(None)

    def stats(self):
        return {
            "blocks_loaded": int(self.blocks_loaded),
            "scenarios_streamed": int(self.scenarios_streamed),
            "prefetch_wait_seconds": float(self.prefetch_wait_s),
        }

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
