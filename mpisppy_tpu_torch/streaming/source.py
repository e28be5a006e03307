"""ScenarioSource — the seed-indexed scenario factory protocol (port of
`mpisppy_tpu/streaming/source.py`).

Scenario i's data is a pure function of its global index i (the
models draw it from `RandomState(i + seedoffset)`), so any subset of
the universe can be built from its index set alone:

  * `ScenarioSource`  — abstract: `block(indices) -> ScenarioBatch`
    holding exactly those scenarios, with block-uniform probabilities
    (each block is a valid sampled batch on its own);
  * `GeneratorSource` — wraps an index-parameterized builder (the
    models' `scenario_block`); the S-scenario tensor never exists;
  * `BatchSource`     — gathers blocks out of an already-built batch
    (aircond's coupled tree, and streamed-vs-resident tests).

Blocks are built on the host: every source here yields batches of CPU
tensors, and the move to the card is the stream's job
(`stream.BlockTransfer`).  `RetryingSource` retries transient build
failures with the capped, jittered backoff of the supervisor ladder.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import host


class ScenarioSource:
    """Protocol: build scenario blocks of a fixed universe on demand.
    `total_scens` is the universe size S; `block(indices)` returns a
    ScenarioBatch of exactly those scenarios with probabilities that
    sum to one over the block."""

    name = "source"
    total_scens = 0

    def block(self, indices):
        raise NotImplementedError

    def names(self, indices):
        """Scenario names of an index set (default: the batch's own)."""
        return list(self.block(np.asarray(indices)).tree.scen_names)


def _check_range(idx, total):
    if idx.size == 0:
        raise ValueError("empty scenario block")
    if idx.min() < 0 or idx.max() >= total:
        raise IndexError(f"block indices out of range [0, {total})")


class GeneratorSource(ScenarioSource):
    """A source over an index-parameterized builder `block_fn(indices)
    -> ScenarioBatch`.  Blocks are pure functions of the index set,
    the property checkpoint/resume and the parity tests rely on."""

    def __init__(self, name, total_scens, block_fn, name_fn=None):
        self.name = name
        self.total_scens = int(total_scens)
        self._block_fn = block_fn
        self._name_fn = name_fn

    def block(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        _check_range(idx, self.total_scens)
        return self._block_fn(idx)

    def names(self, indices):
        if self._name_fn is not None:
            return [self._name_fn(int(i)) for i in np.asarray(indices)]
        return super().names(indices)


def gather_block(batch, indices):
    """The scenarios `indices` of a built ScenarioBatch, on its device:
    probabilities renormalized to the block (computed in float64, as
    the JAX package does, then stored in the batch's probability
    dtype), tree nodes relabeled to the block's own compact node ids.
    A shared (1, M, N) matrix passes through unreplicated, and a
    SplitA gathers only its per-scenario delta values (the shared block
    and coordinates serve every block as they are); stage_cost_c
    gathers on its scenario axis 1."""
    from ..ir import ScenarioBatch, SplitA, TreeInfo

    idx_np = np.asarray(indices, dtype=np.int64)
    dev = batch.device
    idx = torch.from_numpy(idx_np).to(dev)
    A = batch.A
    if isinstance(A, SplitA):
        A = dataclasses.replace(A, vals=A.vals[idx])
    elif not batch.shared_A:
        A = A[idx]
    tree = batch.tree
    node_sub = host(tree.node_of)[idx_np]
    uniq, inv = np.unique(node_sub, return_inverse=True)
    prob_sub = host(tree.prob).astype(np.float64)[idx_np]
    tot = prob_sub.sum()
    prob_sub = (prob_sub / tot if tot > 0
                else np.full(idx_np.size, 1.0 / idx_np.size))
    sub_tree = TreeInfo(
        node_of=torch.from_numpy(
            inv.reshape(node_sub.shape).astype(np.int64)).to(dev),
        prob=torch.from_numpy(prob_sub).to(dev, tree.prob.dtype),
        num_nodes=int(uniq.size),
        stage_of=tree.stage_of,
        nonant_names=tree.nonant_names,
        scen_names=(tuple(tree.scen_names[int(i)] for i in idx_np)
                    if tree.scen_names else ()))

    def take(t):
        return None if t is None else t[idx]

    return ScenarioBatch(
        c=take(batch.c), qdiag=take(batch.qdiag), A=A,
        row_lo=take(batch.row_lo), row_hi=take(batch.row_hi),
        lb=take(batch.lb), ub=take(batch.ub),
        obj_const=take(batch.obj_const),
        nonant_idx=batch.nonant_idx,
        integer_mask=take(batch.integer_mask),
        tree=sub_tree,
        stage_cost_c=(batch.stage_cost_c[:, idx]
                      if batch.stage_cost_c is not None else None),
        var_prob=take(batch.var_prob),
        var_names=batch.var_names,
        model_meta=batch.model_meta)


class BatchSource(ScenarioSource):
    """A source over a built ScenarioBatch: blocks are gathered copies
    of its tensors (build the batch with `device="cpu"` to keep blocks
    on the host).  The adapter for models whose universe is one coupled
    object (aircond's tree) and the reference source of parity tests."""

    def __init__(self, batch, name="batch"):
        self.name = name
        self.batch = batch
        self.total_scens = int(batch.num_scens)

    def block(self, indices):
        idx = np.asarray(indices, dtype=np.int64)
        _check_range(idx, self.total_scens)
        return gather_block(self.batch, idx)

    def names(self, indices):
        names = self.batch.tree.scen_names
        return [names[int(i)] for i in np.asarray(indices)]


class SourceBuildError(RuntimeError):
    """A scenario block could not be built within the retry budget.
    Carries the index set, the attempt count, the last underlying error
    and the per-attempt `retry_state` ({"attempt", "error", "delay"})
    that RetryingSource walked."""

    def __init__(self, message, indices=None, attempts=0, last_error=None,
                 retry_state=()):
        super().__init__(message)
        self.indices = (tuple(int(i) for i in np.asarray(indices).ravel())
                        if indices is not None else ())
        self.attempts = int(attempts)
        self.last_error = last_error
        self.retry_state = tuple(dict(r) for r in retry_state)


def backoff_delay(attempt, backoff, backoff_cap, jitter=0.0, rng=None):
    """The supervisor's restart-ladder value for `attempt`, spread by a
    multiplicative +/- `jitter` and re-capped.  The one backoff policy
    of RetryingSource and the shard store's read retries."""
    from ..resilience.supervisor import restart_delay
    base = restart_delay(attempt, backoff, backoff_cap)
    if jitter <= 0 or rng is None:
        return base
    spread = base * rng.uniform(-jitter, jitter)
    return min(backoff_cap, max(0.0, base + spread))


class RetryingSource(ScenarioSource):
    """Retry-with-capped-backoff wrapper for transient block build
    failures.  Blocks are pure functions of their index set, so a retry
    is always safe; after `retries` failed re-attempts a structured
    SourceBuildError surfaces.  An error that carries
    `non_retryable = True` (a corpus past its quarantine budget)
    propagates at once.  Every retry increments the
    `stream.source_retries` counter, a give-up `stream.source_giveups`."""

    def __init__(self, source, retries=2, backoff=0.05, backoff_cap=5.0,
                 chaos=None, jitter=0.25, jitter_seed=None):
        import random
        self.inner = source
        self.name = source.name
        self.total_scens = int(source.total_scens)
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.chaos = chaos             # block_build_fail injection point
        self.jitter = float(jitter)
        self._rng = random.Random(jitter_seed)
        self.retry_log = []

    def _delay(self, attempt):
        return backoff_delay(attempt, self.backoff, self.backoff_cap,
                             self.jitter, self._rng)

    def _with_retries(self, fn, indices):
        import time

        from .. import telemetry as _telemetry

        log_start = len(self.retry_log)
        last = None
        for attempt in range(1, self.retries + 2):
            try:
                if self.chaos is not None:
                    self.chaos.block_build_tick()
                return fn()
            except Exception as e:
                if getattr(e, "non_retryable", False):
                    raise
                last = e
                if attempt > self.retries:
                    break
                delay = self._delay(attempt)
                self.retry_log.append(
                    {"attempt": attempt, "error": str(e), "delay": delay})
                _telemetry.get().counter("stream.source_retries").inc()
                time.sleep(delay)
        _telemetry.get().counter("stream.source_giveups").inc()
        raise SourceBuildError(
            f"scenario block build failed after {self.retries} "
            f"retr{'y' if self.retries == 1 else 'ies'}: {last}",
            indices=indices, attempts=self.retries + 1,
            last_error=last, retry_state=self.retry_log[log_start:])

    def block(self, indices):
        return self._with_retries(lambda: self.inner.block(indices),
                                  indices)

    def block_with_indices(self, indices):
        """The served-indices protocol of a quarantining ShardSource,
        passed through with retries."""
        fn = getattr(self.inner, "block_with_indices", None)
        if fn is None:
            return (np.asarray(indices, dtype=np.int64),
                    self.block(indices))
        return self._with_retries(lambda: fn(indices), indices)

    def note_upcoming(self, indices):
        """Readahead hint pass-through (best effort, no retries)."""
        fn = getattr(self.inner, "note_upcoming", None)
        if fn is not None:
            fn(indices)

    def close(self):
        fn = getattr(self.inner, "close", None)
        if fn is not None:
            fn()

    def names(self, indices):
        return self.inner.names(indices)


def source_for_module(module, num_scens, cfg=None):
    """A ScenarioSource for a model module: its own
    `scenario_source(num_scens, cfg)` hook (farmer, uc, aircond), else
    the full batch built once on the host through `build_batch` and
    wrapped in a BatchSource."""
    cfg = dict(cfg or {})
    hook = getattr(module, "scenario_source", None)
    if hook is not None:
        return hook(num_scens, cfg)
    from ..confidence_intervals.ciutils import sample_batch
    batch = sample_batch(module, num_scens, cfg.get("start_seed", 0),
                         cfg, {}, device="cpu")
    return BatchSource(batch, name=getattr(module, "__name__", "batch"))
