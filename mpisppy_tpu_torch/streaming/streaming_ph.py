"""StreamingPH — minibatch randomized PH over a ScenarioSource (port of
`mpisppy_tpu/streaming/streaming_ph.py`).

Randomized PH converges when each iteration updates only a sampled
block of scenarios against the current consensus; adaptive-sampling PH
grows the sample with a statistical gap estimate and stops when the
BM/BPL rule certifies it.  This driver composes both over the streaming
stack:

  * the card holds one block of `block_width` scenarios, the power of
    two `ops.pdhg.width_bucket(stream_block_size)`; peak scenario
    residency on the card never exceeds it;
  * the full-universe state (W (S, K), the last nonant values, the
    solved mask, warm starts) lives on the host in numpy;
  * each superstep takes the prefetched block (its host build and its
    copy to the card overlapped the previous solve), draws and
    prefetches the next one, solves the block's PH subproblems against
    the host W and the global consensus x̄, then applies the randomized
    W / x̄ correction on the host for the sampled rows only;
  * every `stream_check_every` supersteps the consensus candidate is
    scored by `ciutils.gap_estimators` on a fresh estimator sample
    (a disjoint seed region, as in SeqSampling) and fed to the
    `SamplingRule`: stop certified, or grow the active sample.

The next block is drawn at the start of superstep k and certification
(RNG-free, cursor driven) runs inside the superstep, so the checkpoint
written after superstep k holds the post-draw RNG state, the pending
index set and the post-certification cursors: a resumed run
re-prefetches the pending block and replays superstep k+1 onward.

The JAX class places each block on a `ScenarioMesh`; the port runs on
one device, and the block's move to the card is `stream.BlockTransfer`
(its own CUDA stream, pinned memory, an event the solve waits on).
Two-stage sources only: the per-block node relabeling of
`gather_block` breaks cross-block node identity for multistage trees,
so the constructor refuses them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import global_toc
from ..confidence_intervals import ciutils
from ..confidence_intervals.seqsampling import SamplingRule
from ..device import host, resolve_device
from ..ir import pad_scenarios
from ..ops.pdhg import reprep_row_bounds, width_bucket
from ..phbase import PHBase, PHState, _active_fraction, \
    ph_objective_arrays
from .sampler import AdaptiveSampler
from .stream import BlockTransfer, ScenarioStream


class _StreamCertifier:
    """ph_converger-API adapter: converged once the certification step
    (run inside ph_iteration, so before the checkpoint) has recorded a
    certified CI."""

    def __init__(self, sph):
        self.sph = sph

    def is_converged(self):
        return self.sph.certified is not None


class StreamingPH(PHBase):
    """Randomized PH with adaptive sampling over a ScenarioSource.

    Options (beyond PHBase's):
      stream_block_size   — real scenarios per sampled block (default 64)
      stream_seed         — sampler RNG seed; the gap estimator's seed
                            region is stream_seed + 10_000_000
      stream_check_every  — supersteps between gap certifications (5)
      stream_warm_bytes   — host warm-start store budget (default 1 GiB;
                            0 disables block warm starts)
      stopping_criterion  — "BM" (default) or "BPL"
      BM_*/BPL_*/n0min    — SamplingRule knobs (seqsampling.py)
      source_retries      — wrap the source in a RetryingSource

    `device` (default: the CUDA device) is where blocks are solved.
    """

    def __init__(self, options, source, module=None, extensions=None,
                 extension_kwargs=None, device=None):
        dev = resolve_device(device)
        o = dict(options or {})
        # the certified rule is the stopping criterion; PH's consensus
        # threshold would otherwise end the loop uncertified
        o.setdefault("convthresh", 0.0)
        retries = int(o.get("source_retries", 0))
        if retries > 0:
            from ..resilience.chaos import ChaosInjector
            from .source import RetryingSource
            source = RetryingSource(
                source, retries=retries,
                backoff=float(o.get("source_backoff", 0.05)),
                backoff_cap=float(o.get("source_backoff_cap", 5.0)),
                chaos=ChaosInjector.from_options(o.get("chaos")),
                jitter=float(o.get("source_jitter", 0.25)),
                jitter_seed=o.get("source_jitter_seed"))
        self.source = source
        self.module = module
        self.total_scens = int(source.total_scens)
        block = max(1, min(int(o.get("stream_block_size", 64)),
                           self.total_scens))
        self.block_width = width_bucket(block, floor=1)

        self.rule = SamplingRule(
            o, stochastic_sampling=bool(o.get("stochastic_sampling",
                                              False)),
            stopping_criterion=o.get("stopping_criterion", "BM"))
        self.sampler = AdaptiveSampler(
            self.rule, self.total_scens, block_size=block,
            seed=int(o.get("stream_seed", 0)))

        # template block: scenarios [0, block) padded to the block
        # width; it defines every per-superstep shape (solver, rho)
        tmpl_idx = np.arange(block)
        raw = source.block(tmpl_idx)
        if raw.tree.num_nodes > 1:
            raise NotImplementedError(
                "StreamingPH consensus is two-stage (root node) only: "
                "block-local node relabeling breaks cross-block node "
                "identity for multistage trees")
        tmpl = pad_scenarios(raw, self.block_width)
        super().__init__(o, list(source.names(tmpl_idx)), batch=tmpl,
                         extensions=extensions,
                         extension_kwargs=extension_kwargs, device=dev)

        K = self.batch.num_nonants
        S = self.total_scens
        hdt = host(tmpl.c).dtype
        self._host_dtype = hdt
        self.W_host = np.zeros((S, K), hdt)       # full-S dual weights
        self.x_na_host = np.zeros((S, K), hdt)    # last nonant values
        self.solved = np.zeros(S, bool)           # ever-solved mask
        self.xbar_host = np.zeros(K, hdt)         # root consensus
        self._rho_host = float(self.options.get("defaultPHrho", 1.0))
        warm_bytes = int(self.options.get("stream_warm_bytes", 1 << 30))
        need = (S * (self.batch.num_vars + self.batch.num_rows)
                * hdt.itemsize)
        self._warm_host = (
            (np.zeros((S, self.batch.num_vars), hdt),
             np.zeros((S, self.batch.num_rows), hdt))
            if 0 < need <= warm_bytes else None)

        self._check_every = max(1, int(
            self.options.get("stream_check_every", 5)))
        self._est_seed = int(self.options.get("stream_seed", 0)) \
            + 10_000_000
        self._est_history = []
        self.certified = None
        self._pending_indices = None
        self._cur_prob = None
        self.peak_block_scens = 0
        self.convobject = _StreamCertifier(self)
        self.transfer = BlockTransfer(
            self.device,
            prepare=lambda blk: pad_scenarios(blk, self.block_width))
        self.stream = ScenarioStream(source, transfer=self.transfer,
                                     telemetry=self._tel)

    # -- storage plumbing --------------------------------------------------
    def _shard_store(self):
        """The ShardStore behind this run's source (through retry
        wrappers), or None for generator and batch sources."""
        src = self.source
        for _ in range(8):
            store = getattr(src, "store", None)
            if store is not None:
                return store
            inner = getattr(src, "inner", None)
            if inner is None:
                return None
            src = inner
        return None

    def _prefetch(self, indices):
        """Prefetch an index set, hinting the source's readahead first."""
        hint = getattr(self.source, "note_upcoming", None)
        if hint is not None:
            hint(indices)
        self.stream.prefetch(indices)

    def check_W_bound_supported(self):
        raise NotImplementedError(
            "W-based Lagrangian bounds are not valid under randomized "
            "PH: the host-resident W is updated block-wise against a "
            "SAMPLED consensus, so the prob-weighted W does not "
            "telescope to zero over the universe; the certified BM/BPL "
            "gap CI is the streaming bound")

    # -- per-block machinery ----------------------------------------------
    def _block_prep(self, blk):
        """Prep of one padded block.  A shared-A source (uncertainty in
        the row bounds only, uc's wind) reuses the template prep's
        scaling and norm and rescales the row bounds; others rebuild
        through `_build_prep`."""
        if blk.shared_A and self.batch.shared_A:
            dt = self.prep.row_lo.dtype
            return reprep_row_bounds(self.prep, blk.row_lo.to(dt),
                                     blk.row_hi.to(dt))
        return self._build_prep(hot=self.solver.hot_dtype, batch=blk)

    def _block_warm(self, idx):
        if self._warm_host is None:
            return None, None
        b = idx.size
        x0 = np.zeros((self.block_width, self.batch.num_vars),
                      self._host_dtype)
        y0 = np.zeros((self.block_width, self.batch.num_rows),
                      self._host_dtype)
        x0[:b] = self._warm_host[0][idx]
        y0[:b] = self._warm_host[1][idx]
        dt = self.batch.c.dtype
        return (torch.from_numpy(x0).to(self.device, dt),
                torch.from_numpy(y0).to(self.device, dt))

    def _absorb_block(self, idx, blk, res):
        """Scatter a solved block's results into the host-resident
        full-S state (pads sliced off)."""
        b = idx.size
        self.x_na_host[idx] = host(blk.nonants(res.x)).astype(
            self._host_dtype)[:b]
        self.solved[idx] = True
        if self._warm_host is not None:
            self._warm_host[0][idx] = host(res.x).astype(
                self._host_dtype)[:b]
            self._warm_host[1][idx] = host(res.y).astype(
                self._host_dtype)[:b]
        self.peak_block_scens = max(self.peak_block_scens,
                                    int(blk.num_scens))
        self._cur_prob = host(blk.prob)

    def _recompute_consensus(self):
        """Root consensus: the mean nonant value over every solved
        scenario of the active prefix (uniform-probability sources)."""
        act = np.flatnonzero(self.solved[:self.sampler.active_n])
        if act.size:
            self.xbar_host = self.x_na_host[act].mean(axis=0)

    def _host_conv(self):
        """Streamed convergence metric: the mean over solved active
        scenarios of ||x_na - x̄||_1 / K."""
        act = np.flatnonzero(self.solved[:self.sampler.active_n])
        if not act.size:
            return float("inf")
        K = max(self.batch.num_nonants, 1)
        d = np.abs(self.x_na_host[act] - self.xbar_host[None, :])
        return float(d.sum(axis=1).mean() / K)

    def _xbar_rows(self, n):
        dt = self.batch.c.dtype
        return torch.from_numpy(np.ascontiguousarray(
            self.xbar_host)).to(self.device, dt)[None, :].expand(
                n, self.batch.num_nonants)

    def _install_state(self, res, blk, it):
        dt = self.batch.c.dtype
        x_na = blk.nonants(res.x)
        self.state = PHState(
            x=res.x, y=res.y, W=torch.zeros_like(x_na),
            xbar=self._xbar_rows(x_na.shape[0]),
            xsqbar=torch.zeros_like(x_na),
            obj=res.obj, dual_obj=res.dual_obj,
            conv=torch.tensor(self.conv, dtype=dt),
            it=int(it), solve_iters=res.iters,
            active_frac=_active_fraction(blk, res.converged),
            solve_restarts=torch.sum(res.restarts))

    def _install_resumed_state(self, it):
        """A minimal PHState after a stream-checkpoint restore (the
        block state on the card is transient; only `it` and `conv` feed
        the loop); load_stream_checkpoint calls this."""
        b = self.batch
        dt, dev = b.c.dtype, self.device
        S, N, M, K = b.num_scens, b.num_vars, b.num_rows, b.num_nonants

        def z(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        self.state = PHState(
            x=z(S, N), y=z(S, M), W=z(S, K), xbar=self._xbar_rows(S),
            xsqbar=z(S, K), obj=z(S), dual_obj=z(S),
            conv=torch.tensor(self.conv, dtype=dt), it=int(it))

    def Eobjective(self, objs):
        """Sampled E[objective] with the probabilities of the block the
        objs came from."""
        p = self._cur_prob
        if p is not None and p.shape[0] == objs.shape[0]:
            return torch.sum(torch.as_tensor(p).to(objs.device, objs.dtype)
                             * objs)
        return super().Eobjective(objs)

    # -- Iter0: sweep the initial active sample ---------------------------
    def Iter0(self):
        self._ext("pre_iter0")
        n0 = self.sampler.active_n
        bsz = self.sampler.block_size
        global_toc(f"StreamingPH Iter0: sweeping {n0} of "
                   f"{self.total_scens} scenarios in blocks of {bsz}")
        chunks = [np.arange(i, min(i + bsz, n0))
                  for i in range(0, n0, bsz)]
        self._prefetch(chunks[0])
        dual_sum = 0.0
        res = blk = None
        for j in range(len(chunks)):
            if j + 1 < len(chunks):
                self._prefetch(chunks[j + 1])
            idx, blk = self.stream.next_block()
            res = self.solve_loop(
                warm=False, batch=blk, prep=self._block_prep(blk),
                eps=self.superstep_eps,
                dtiming=self.options.get("display_timing"))
            self._absorb_block(idx, blk, res)
            dual_sum += float(np.sum(host(res.dual_obj)[:idx.size]))
        self._recompute_consensus()
        act = np.flatnonzero(self.solved)
        self.W_host[act] = self._rho_host * (
            self.x_na_host[act] - self.xbar_host[None, :])
        self.conv = self._host_conv()
        # sampled trivial bound: the mean no-penalty dual objective over
        # the swept sample, an estimate of the full-S trivial bound
        self.trivial_bound = dual_sum / max(n0, 1)
        self.best_bound = self.trivial_bound
        self._install_state(res, blk, it=0)
        self._pending_indices = self.sampler.draw_block()
        self._prefetch(self._pending_indices)
        global_toc(f"StreamingPH Iter0 sampled trivial bound = "
                   f"{self.trivial_bound:.6g}, conv = {self.conv:.6g}")
        if self._tel.enabled:
            self._tel.event("stream.iter0",
                            trivial_bound=self.trivial_bound,
                            active_n=n0, conv=self.conv)
        self._ext("post_iter0")
        return self.trivial_bound

    # -- one randomized superstep -----------------------------------------
    def ph_iteration(self):
        self._ext("pre_solve_loop")
        t0 = time.time()
        k = int(self.state.it) + 1
        idx, blk = self.stream.next_block()   # drawn last superstep
        # draw and prefetch superstep k+1's block now, so its build and
        # copy overlap this solve; growth from this superstep's
        # certification takes effect at k+2
        self._pending_indices = self.sampler.draw_block()
        self._prefetch(self._pending_indices)

        b = idx.size
        dt = self.batch.c.dtype
        W_blk = np.zeros((self.block_width, self.batch.num_nonants),
                         self._host_dtype)
        W_blk[:b] = self.W_host[idx]
        c_eff, q_eff = ph_objective_arrays(
            blk, torch.from_numpy(W_blk).to(self.device, dt), self.rho,
            self._xbar_rows(self.block_width),
            W_on=self.W_on, prox_on=self.prox_on)
        x0, y0 = self._block_warm(idx)
        res = self.solve_loop(
            c=c_eff, qdiag=q_eff, warm=False, batch=blk,
            prep=self._block_prep(blk), x0=x0, y0=y0,
            eps=self.superstep_eps)
        self._absorb_block(idx, blk, res)
        # randomized PH correction: consensus over all solved active
        # scenarios, dual update for the sampled rows only
        self._recompute_consensus()
        self.W_host[idx] += self._rho_host * (
            self.x_na_host[idx] - self.xbar_host[None, :])
        self.conv = self._host_conv()
        self._install_state(res, blk, it=k)
        if self._ladder is not None:
            self._ladder_eps = min(
                self._ladder_eps,
                max(self._ladder["min"],
                    self._ladder["couple"] * self.conv))
        wall = time.time() - t0
        tel = self._tel
        if tel.enabled:
            r = tel.registry
            r.counter("ph.iterations").inc()
            r.counter("stream.supersteps").inc()
            r.histogram("ph.iteration_seconds").observe(wall)
            r.gauge("ph.conv").set(self.conv)
        self._ext("post_solve_loop")
        # certification runs inside the superstep (before iterk_loop's
        # checkpoint), so a resume replays it with the same cursors
        if (self.module is not None and self.certified is None
                and k % self._check_every == 0):
            self._certify_step()
        return self.conv

    # -- certification (the BM/BPL stopping rule) -------------------------
    def _certify_step(self):
        nk = int(self.sampler.active_n)
        xhat = self.xbar_host.copy()
        try:
            est = ciutils.gap_estimators(
                xhat, self.module, num_scens=nk, seed=self._est_seed,
                cfg=self.options, device=self.device)
        except RuntimeError as e:
            global_toc(f"stream certify: candidate evaluation failed "
                       f"({e}); continuing")
            return False
        self._est_seed = int(est["seed"])
        # quarantined-corpus accounting: resampled (lost) mass widens
        # the gap estimate before the stopping rule sees it
        store = self._shard_store()
        q_frac = float(store.quarantined_frac) if store is not None \
            else 0.0
        debit = ciutils.debit_quarantined_mass(est, q_frac)
        G, s = float(est["G"]), float(est["std"])
        self._est_history.append([nk, G, s])
        self._last_zhats = float(est["zhats"])
        stop = self.sampler.observe(G, s)
        global_toc(f"stream certify: n={nk} G={G:.6g} s={s:.6g} "
                   f"stop={stop} active_n={self.sampler.active_n}"
                   + (f" quarantine_debit={debit:.6g}" if debit else ""))
        if self._tel.enabled:
            self._tel.event("stream.certify", n=nk, G=G, s=s,
                            stop=bool(stop), quarantine_debit=debit)
        if stop:
            self.certified = {
                "G": G, "s": s, "num_scens": nk,
                "CI": [0.0, self.rule.ci_upper(s) + debit],
                "zhats": self._last_zhats,
                "T": int(self.sampler.est_rounds),
                "criterion": self.rule.stopping_criterion,
                "quarantined_frac": q_frac,
                "gap_debit": debit,
            }
            return True
        return False

    # -- checkpointing (resilience/checkpoint.py stream format) -----------
    def _save_checkpoint(self, path):
        from ..resilience.checkpoint import save_stream_checkpoint
        save_stream_checkpoint(path, self)

    def restore_run_checkpoint(self, path):
        from ..resilience.checkpoint import load_stream_checkpoint
        load_stream_checkpoint(path, self)
        # blocks are pure functions of their index set: re-issuing the
        # pending prefetch rebuilds the block the crashed run had in
        # flight (the storage cursor was restored first)
        self._prefetch(self._pending_indices)
        global_toc(f"StreamingPH resumed from {path} at superstep "
                   f"{int(self.state.it)} "
                   f"(active_n={self.sampler.active_n})")
        return self.trivial_bound

    # -- driver -----------------------------------------------------------
    def post_loops(self):
        """Sampled E[f(xhat)]: the last certification's zhats when one
        ran, else the last block's sampled objective.  Denouements are
        skipped: the resident block is a sample, not the universe."""
        if self.certified is not None:
            return float(self.certified["zhats"])
        if getattr(self, "_last_zhats", None) is not None:
            return float(self._last_zhats)
        return float(self.Eobjective(self.state.obj))

    def stream_main(self, finalize=True):
        """Iter0 sweep -> randomized supersteps -> certified stop.
        `options["resume_from"]` naming a stream checkpoint replaces
        Iter0 and replays the trajectory from it."""
        resume = self.options.get("resume_from")
        from ..resilience.checkpoint import checkpoint_exists
        try:
            if resume is not None and checkpoint_exists(resume):
                trivial = self.restore_run_checkpoint(resume)
            else:
                trivial = self.Iter0()
            self.iterk_loop()
        finally:
            self.close()
        if finalize:
            eobj = self.post_loops()
            ci = self.certified["CI"] if self.certified else None
            global_toc(f"StreamingPH done: conv={self.conv:.4e} "
                       f"E[obj]~{eobj:.6g} certified_CI={ci}")
            return self.conv, eobj, trivial
        return self.conv, None, trivial

    def close(self):
        """Stop the stream worker and a shard source's readahead."""
        self.stream.close()
        closer = getattr(self.source, "close", None)
        if closer is not None:
            closer()

    def stream_stats(self):
        """Streaming run facts for bench rows and callers."""
        st = self.stream.stats()
        steps = int(self.state.it) if self.state is not None else 0
        out = {
            "sampled_scenarios": int(self.sampler.active_n),
            "total_scens": int(self.total_scens),
            "block_width": int(self.block_width),
            "peak_block_scens": int(self.peak_block_scens),
            "supersteps": steps,
            "blocks_per_superstep": st["blocks_loaded"] / max(steps, 1),
            "sample_growth_events": int(self.sampler.growth_events),
            "ci_gap": (list(self.certified["CI"])
                       if self.certified else None),
            "certified": self.certified,
            "est_history": list(self._est_history),
            **st,
        }
        src_stats = getattr(self.source, "stats", None)
        if src_stats is not None:
            out["storage"] = src_stats()
        return out
