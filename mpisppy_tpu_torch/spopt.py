"""SPOpt — the solve engine (port of `mpisppy_tpu/spopt.py`).

One `solve_loop` call is one batched PDHG solve over all scenarios.
PH's W and prox terms, the Lagrangian W-only objective and xhat fixings
arrive as tensor arguments.  Expectations are probability-weighted sums
over the scenario axis.

`_build_prep` takes the JAX package's three routes
(`spopt.py:118-140`): a batch born split-native gets the split prep;
a dense batch that declares its matrix-uncertainty coordinates
(`model_meta["A_delta_idx"]`) gets the delta-split prep with one shared
scaling unless `no_split_prep` is set; anything else gets the dense
per-scenario prep, with one column scaling for all scenarios where a
subclass sets `_shared_cols` (the extensive form).
`pdhg_sparse_threshold` turns a split prep's shared block sparse.

`evaluate_candidates` screens k candidates in one solve over the xhat
system tiled k-fold along the scenario axis.

With `pdhg_compact_threshold` > 0, an uncapped `solve_loop` (Iter0,
the Lagrangian bound) goes through `PDHGSolver.solve_compacted`,
and `pdhg_stats()` reports the segment trajectory and the FLOPs the
narrower slabs did not spend.  `options["telemetry"]` configures the
process-global telemetry handle (`telemetry/`): solve spans, solve and
certify counters, the PDHG work counters and the MFU gauges.

Differences from the JAX package, each on purpose:
* `_certified_resolve` runs its float64 re-solve on the batch's own
  device — the CUDA kernel has a float64 entry point and the matmul
  route runs in any dtype — where the JAX package moves it to the host
  CPU.
* The norm estimates of the preps built here (the xhat reduced system,
  the f64 certify prep) start from a torch.Generator draw, not the JAX
  PRNGKey(0) draw, so they differ slightly (ROADMAP queue C).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import global_toc
from . import telemetry as _telemetry
from .ir import (SparseSplitA, SplitA, bmatvec, delta_idx, shared_density,
                 sparsify_split)
from .ops import pdhg as _pdhg
from .ops.pdhg import (HOT_DTYPES, PDHGSolver, _cast_A, _gather_prep,
                       prepare_batch, prepare_batch_split,
                       prepare_split_native, reprep_row_bounds,
                       round_to_dtype)
from .spbase import SPBase
from .utils import mfu as _mfu


class SPOpt(SPBase):
    # subclasses whose solves need one column scaling for every scenario
    # (consensus / EF solves) set this, so the batch is prepared once
    _shared_cols = False
    # subclasses that index prep.A as a dense array opt out of the
    # delta-split prep
    _use_split_prep = True

    def __init__(self, *args, prep=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.solver = PDHGSolver.from_options(self.options)
        if prep is not None:
            # a PreparedBatch over the SAME batch (e.g. converted from
            # the JAX package by convert.prep_from_arrays)
            self.prep = prep.map(lambda t: t.to(self.device))
        else:
            global_toc("Preparing batch (Ruiz scaling + ||A|| estimate)")
            self.prep = self._build_prep(hot=self.solver.hot_dtype)
        # density of the shared block the prep carries (None for a
        # prep that is not split): the FLOP accounting and pdhg_stats
        self._shared_nnz_frac = (shared_density(self.prep.A)
                                 if isinstance(self.prep.A, SplitA)
                                 else None)
        self._sparse_matvecs = 0
        self._x_warm = None
        self._y_warm = None
        self._named_warm = {}
        self._solve_times = []
        self._flops = 0.0
        self._solve_wall = 0.0
        self._certify_wall = 0.0
        self._kernel_iters = 0
        self._restarts_total = 0
        self._active_fraction = 1.0
        self._flops_saved = 0.0     # FLOPs compaction did not spend
        self._active_traj = []      # the last compacted solve's segments
        self._promotions = 0
        # the options value configures the process-global handle; with
        # telemetry off every instrument below is a null no-op
        self._tel = _telemetry.configure_from_options(
            self.options.get("telemetry"))
        # dynamic solver tolerance, rounded to the batch dtype
        self.solver_eps = round_to_dtype(self.solver.eps,
                                         self.batch.c.dtype)
        self._solver64 = None
        self._promoted_cache = None
        self._np_cache = {}

    def _build_prep(self, hot=None, batch=None):
        """Ruiz scaling + ||A|| estimate over the batch constraint data,
        in the hot dtype's compute precision when `hot` applies, by the
        route the batch selects (split-native, delta-split unless
        `no_split_prep`, or dense).  With a solver sparse_threshold, a
        split prep whose shared block is sparse enough becomes a
        SparseSplitA (Ruiz scaling keeps the zero pattern, so the
        density after scaling is the structural one).

        batch: prepare another ScenarioBatch than self.batch by the same
        routing (the streaming layer's sampled blocks)."""
        b = self.batch if batch is None else batch
        A, row_lo, row_hi = b.A, b.row_lo, b.row_hi
        pair = self.solver._hot_pair(b.c.dtype) if hot else None
        if pair is not None:
            compute = pair[1]
            A, row_lo, row_hi = (_cast_A(A, compute), row_lo.to(compute),
                                 row_hi.to(compute))
        delta = delta_idx(b)
        if b.split_A:
            # born split-native: the split prep is the only prep
            prep = prepare_split_native(A, row_lo, row_hi)
        elif (delta is not None and self._use_split_prep
                and not b.shared_A
                and not self.options.get("no_split_prep")):
            # one shared scaling: satisfies _shared_cols as well
            prep = prepare_batch_split(A, delta[0], delta[1], row_lo,
                                       row_hi)
        else:
            prep = prepare_batch(A, row_lo, row_hi,
                                 shared_cols=self._shared_cols)
        if self.solver.sparse_threshold > 0.0 \
                and isinstance(prep.A, SplitA):
            spA = sparsify_split(prep.A, self.solver.sparse_threshold)
            if spA is not prep.A:
                prep = dataclasses.replace(prep, A=spA)
        return prep

    @staticmethod
    def _prep_density(prep):
        """FLOP discount for the matvec model: a sparse shared block
        does ~density x the dense work; other preps pay full price."""
        if isinstance(prep.A, SparseSplitA):
            return float(prep.A.shared_nnz_frac)
        return 1.0

    def _account(self, prep, it_n, S=None):
        """FLOPs and sparse-matvec count of `it_n` inner iterations
        over `prep` (spopt.py:293-303)."""
        b = self.batch
        self._flops += _mfu.pdhg_flops(
            it_n, b.num_scens if S is None else S, b.num_rows, b.num_vars,
            self.solver.check_every, density=self._prep_density(prep))
        if isinstance(prep.A, SparseSplitA):
            # two shared-block products (forward + transpose) per inner
            # iteration go through torch's sparse product
            self._sparse_matvecs += 2 * it_n

    def _promoted_pair(self):
        """The full-precision (solver, prep) pair used once a solve's
        tolerance crosses the hot dtype's eps floor (built lazily)."""
        if self._promoted_cache is None:
            self._promoted_cache = (self.solver.clone(hot_dtype=None),
                                    self._build_prep(hot=None))
        return self._promoted_cache

    def active_solver_prep(self, eps=None, count=True):
        """(solver, prep) for a solve at tolerance `eps`: the configured
        pair until `eps` crosses the hot dtype's floor, then the
        promoted full-precision pair."""
        e = float(self.solver_eps if eps is None else eps)
        if not self.solver.wants_promotion(e):
            return self.solver, self.prep
        if count:
            self._promotions += 1
            if self._tel.enabled:
                self._tel.registry.counter("pdhg.promotions").inc()
        return self._promoted_pair()

    # -- hot path ---------------------------------------------------------
    def solve_loop(self, c=None, qdiag=None, lb=None, ub=None,
                   warm=True, dtiming=False, certify=False, eps=None,
                   iters_cap=None, batch=None, prep=None, x0=None,
                   y0=None):
        """Solve every scenario subproblem (batched).  c/qdiag/lb/ub
        override the batch's own tensors.

        warm: True/False for the default warm-start cache, or a string
        tag for a named cache.  certify: False, True (refine every
        unconverged prob>0 scenario in float64) or "feas" (refine only
        primal-infeasible ones).  An uncapped solve goes through
        `solve_compacted` when the solver's compact_threshold is set.

        batch/prep: solve another ScenarioBatch than self.batch (the
        streaming layer's sampled blocks).  A block solve brings its own
        prep, takes its warm start from x0/y0 only and neither reads
        nor writes the instance's warm caches (they are shaped for
        self.batch); certify is refused on it.  With an explicit prep
        the solve runs on the configured solver (no hot-dtype
        promotion: the caller chose the prep's dtype).
        x0/y0: an explicit warm start; overrides the warm cache.
        Returns the ops.pdhg.SolveResult."""
        if batch is not None:
            if prep is None:
                raise ValueError(
                    "solve_loop(batch=...) requires an explicit prep "
                    "for the block's constraint data")
            if certify:
                raise ValueError(
                    "certify is not supported on block solves "
                    "(batch=...): _certified_resolve scatters into "
                    "self.batch-shaped results")
        b = self.batch if batch is None else batch
        t0 = time.time()
        tel = self._tel
        tn0 = time.monotonic_ns() if tel.enabled else 0
        if batch is not None:
            cache = (x0, y0)
        elif isinstance(warm, str):
            cache = self._named_warm.get(warm, (None, None))
        else:
            cache = (self._x_warm, self._y_warm) if warm else (None, None)
            if x0 is not None or y0 is not None:
                cache = (x0, y0)
        eps_arg = self.solver_eps if eps is None else eps
        if prep is not None:
            solver = self.solver
        else:
            solver, prep = self.active_solver_prep(eps_arg)
        args = (prep,
                b.c if c is None else c,
                b.qdiag if qdiag is None else qdiag,
                b.lb if lb is None else lb,
                b.ub if ub is None else ub)
        kw = dict(obj_const=b.obj_const, x0=cache[0], y0=cache[1],
                  eps=eps_arg)
        n_live = max(int(torch.sum(b.prob > 0)), 1)
        # compaction applies to uncapped solves only: an iters_cap
        # caller is screening and owns its budget
        if solver.compact_threshold > 0.0 and iters_cap is None:
            traj = []
            res = solver.solve_compacted(*args, **kw, probs=b.prob,
                                         on_segment=traj.append)
            self._active_traj = traj
            self._active_fraction = (traj[-1]["active"] / n_live
                                     if traj else 0.0)
            # FLOPs the compacted segments did not spend on the rows
            # the full-width solve would have carried
            dens = self._prep_density(prep)
            saved = sum(
                _mfu.pdhg_flops(t["seg_iters"], b.num_scens - t["width"],
                                b.num_rows, b.num_vars,
                                solver.check_every, density=dens)
                for t in traj if t["width"] < b.num_scens)
            self._flops_saved += saved
        else:
            res = solver.solve(*args, **kw, iters_cap=iters_cap)
            saved = 0.0
            self._active_fraction = float(
                torch.sum(~res.converged & (b.prob > 0))) / n_live
        it_n = int(res.iters)
        rst_n = int(torch.sum(res.restarts))
        # net of the compaction savings: `saved` is work not done
        self._account(prep, it_n, S=b.num_scens)
        self._flops -= saved
        self._kernel_iters += it_n
        self._restarts_total += rst_n
        if certify:
            select = None
            if certify == "feas":
                select = res.pres >= 10 * float(self.solver_eps)
            res = self._certified_resolve(res, c, qdiag, lb, ub,
                                          select=select)
        # block solves never touch the self.batch-shaped caches
        if batch is None and isinstance(warm, str):
            self._named_warm[warm] = (res.x, res.y)
        elif batch is None and warm:
            self._x_warm = res.x
            self._y_warm = res.y
        _sync(res.x)
        dt = time.time() - t0
        self._solve_wall += dt
        if tel.enabled:
            self._record_solve(prep, it_n, rst_n, saved, dt, tn0, n_live)
        if dtiming or self.options.get("display_timing"):
            self._solve_times.append(dt)
            global_toc(f"solve_loop: {dt*1e3:8.1f} ms, iters={it_n}, "
                       f"conv={int(torch.sum(res.converged))}"
                       f"/{b.num_scens}")
        return res

    def _record_solve(self, prep, it_n, rst_n, saved, dt, tn0, n_live):
        """The telemetry of one solve_loop call (telemetry on only)."""
        tel, b = self._tel, self.batch
        tel.tracer.record_span("solve.loop", tn0, time.monotonic_ns())
        r = tel.registry
        r.counter("solve.calls").inc()
        r.counter("solve.kernel_iters").inc(it_n)
        r.histogram("solve.seconds").observe(dt)
        r.counter("pdhg.inner_iters_total").inc(it_n)
        r.counter("pdhg.restarts_total").inc(rst_n)
        r.gauge("pdhg.active_fraction").set(self._active_fraction)
        r.gauge("pdhg.active_scenarios").set(self._active_fraction
                                             * n_live)
        if saved:
            r.counter("pdhg.flops_saved").inc(saved)
        if isinstance(prep.A, SparseSplitA):
            r.counter("pdhg.sparse_matvecs").inc(2 * it_n)
        if rst_n:
            # mean restart cycle length in inner iterations: the
            # iterate-steps of the batch over the cycles they split into
            r.event("pdhg.restart", count=rst_n,
                    mean_cycle=it_n * b.num_scens / max(
                        rst_n + b.num_scens, 1),
                    iters=it_n)
        _mfu.record_to_registry(r, self._flops, self._solve_wall,
                                kernel_iters=self._kernel_iters,
                                device=self.device,
                                dtype=self._kernel_dtype())

    # -- certified fallback ----------------------------------------------
    def _certified_resolve(self, res, c=None, qdiag=None, lb=None,
                           ub=None, A=None, row_lo=None, row_hi=None,
                           obj_const=None, prep_key="_prep64",
                           select=None):
        """Re-solve unconverged prob>0 scenarios in float64, warm-started
        from the fast solve, and scatter the refined solutions back.
        The float64 solve runs on the batch's device.

        A/row_lo/row_hi/obj_const override the batch constraint data
        (the xhat path passes its reduced system); prep_key names the
        cached full-batch float64 prep for that A."""
        b = self.batch
        live = b.prob > 0
        pick = ~res.converged if select is None else select
        idx = torch.nonzero(pick & live).flatten()
        if idx.numel() == 0:
            return res
        t_cert = time.time()
        f64 = torch.float64

        def sub(t, default):
            return (default if t is None else t).to(f64)[idx]

        A = b.A if A is None else A
        row_lo = b.row_lo if row_lo is None else row_lo
        row_hi = b.row_hi if row_hi is None else row_hi
        cert_iters = int(self.options.get(
            "certify_max_iters", max(self.solver.max_iters, 100000)))
        if self._solver64 is None or \
                self._solver64.max_iters != cert_iters:
            # hot_dtype pinned off: the certified verdict is the point
            self._solver64 = self.solver.clone(max_iters=cert_iters,
                                               hot_dtype=None)
        full = self._np_cache.get(prep_key)
        if full is None:
            if isinstance(A, SplitA):
                # split-native constraint data: the f64 prep stays
                # split too (the dense (S, M, N) tensor may not fit)
                full = prepare_split_native(A.astype(f64), row_lo.to(f64),
                                            row_hi.to(f64))
            else:
                full = prepare_batch(A.to(f64), row_lo.to(f64),
                                     row_hi.to(f64),
                                     shared_cols=self._shared_cols)
            self._np_cache[prep_key] = full
        # shared leaves (a shared A, a SplitA's shared block and its
        # scalings) serve every straggler as they are; row bounds may
        # be call-specific (xhat candidates shift them): rebuild the
        # scaled fields from the raw bounds
        prep64 = reprep_row_bounds(_gather_prep(full, idx),
                                   row_lo.to(f64)[idx],
                                   row_hi.to(f64)[idx])
        r64 = self._solver64.solve(
            prep64, sub(c, b.c), sub(qdiag, b.qdiag), sub(lb, b.lb),
            sub(ub, b.ub), obj_const=sub(obj_const, b.obj_const),
            x0=res.x.to(f64)[idx], y0=res.y.to(f64)[idx],
            eps=float(self.solver_eps))
        self._account(prep64, int(r64.iters), S=idx.numel())
        dt_cert = time.time() - t_cert
        self._certify_wall += dt_cert
        if self._tel.enabled:
            r = self._tel.registry
            r.counter("solve.certify_calls").inc()
            r.counter("solve.certify_scenarios").inc(int(idx.numel()))
            r.histogram("solve.certify_seconds").observe(dt_cert)
        n_ok = int(torch.sum(r64.converged))
        if n_ok < idx.numel():
            global_toc(f"WARNING: f64 fallback left {idx.numel() - n_ok} "
                       f"scenario(s) unconverged")

        def scat(a, a64):
            out = a.clone()
            out[idx] = a64.to(a.dtype)
            return out

        restarts = res.restarts.clone()
        restarts[idx] += r64.restarts.to(restarts.dtype)
        return dataclasses.replace(
            res, x=scat(res.x, r64.x), y=scat(res.y, r64.y),
            obj=scat(res.obj, r64.obj),
            dual_obj=scat(res.dual_obj, r64.dual_obj),
            pres=scat(res.pres, r64.pres), dres=scat(res.dres, r64.dres),
            gap=scat(res.gap, r64.gap),
            converged=scat(res.converged, r64.converged),
            restarts=restarts)

    def clear_warmstart(self):
        self._x_warm = None
        self._y_warm = None
        self._named_warm = {}

    # -- expectations -------------------------------------------------
    def Eobjective(self, objs):
        """E[objective] over scenarios (reference spopt.py:310)."""
        return torch.sum(self.batch.prob * objs)

    def Ebound(self, dual_objs, converged=None):
        """Expected outer bound from per-scenario dual objectives; an
        uncertified prob>0 scenario contributes -inf when `converged`
        is given."""
        vals = self.batch.prob * dual_objs
        if converged is not None:
            bad = (~converged) & (self.batch.prob > 0)
            vals = torch.where(bad, float("-inf"), vals)
        return torch.sum(vals)

    def reset_solve_stats(self):
        """Zero the FLOP/wall accumulators."""
        self._flops = 0.0
        self._solve_wall = 0.0
        self._certify_wall = 0.0
        self._kernel_iters = 0
        self._solve_times = []
        self._restarts_total = 0
        self._flops_saved = 0.0
        self._active_traj = []
        self._active_fraction = 1.0
        self._promotions = 0
        self._sparse_matvecs = 0

    def _kernel_dtype(self):
        """dtype the hot-loop matvecs execute in, as a name."""
        dt = self.batch.c.dtype
        if self.solver.hot_dtype is not None:
            dt = HOT_DTYPES[self.solver.hot_dtype][0]
        return str(dt).replace("torch.", "")

    def pdhg_stats(self):
        """Adaptive-work counters since the last reset, with the
        process-wide chunk counts of the matmul and consensus routes
        (`ops.pdhg.matmul_chunks`, `consensus_chunks`)."""
        return {
            "matmul_chunks": int(_pdhg.matmul_chunks),
            "consensus_chunks": int(_pdhg.consensus_chunks),
            "inner_iters": int(self._kernel_iters),
            "restarts_total": int(self._restarts_total),
            "flops_saved": float(self._flops_saved),
            "active_fraction_final": float(self._active_fraction),
            "active_fraction_traj": list(self._active_traj),
            "hot_dtype": self.solver.hot_dtype,
            "promotions_total": int(self._promotions),
            "sparse_matvecs": int(self._sparse_matvecs),
            "shared_nnz_frac": self._shared_nnz_frac,
        }

    def solve_stats(self):
        """Accumulated kernel FLOPs, wall-clock and MFU across solve_loop
        calls, with the device they ran on (utils/mfu.py: the peak is
        the card's, at the dtype the hot-loop matvecs run in)."""
        dev = self.device
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        dt = self._kernel_dtype()
        u = _mfu.mfu(self._flops, self._solve_wall, dev, dtype=dt)
        _mfu.record_to_registry(self._tel.registry, self._flops,
                                self._solve_wall,
                                kernel_iters=self._kernel_iters,
                                device=dev, dtype=dt)
        return {
            "flops": self._flops,
            "solve_wall_s": self._solve_wall,
            "certify_wall_s": self._certify_wall,
            "mfu": u,
            "dtype": dt,
            "device": name,
        }

    def _feasible(self, res, tol=None):
        """(S,) bool: the primal residual under `tol` (default 10x the
        dynamic solver eps)."""
        return res.pres < (tol or 10 * float(self.solver_eps))

    def feas_prob(self, res, tol=None):
        """Probability mass of scenarios whose primal residual is under
        `tol` (default 10x the dynamic solver eps)."""
        ok = self._feasible(res, tol)
        return float(torch.sum(torch.where(ok, self.batch.prob, 0.0)))

    def infeas_prob(self, res, tol=None):
        return 1.0 - self.feas_prob(res, tol)

    @property
    def is_lp(self):
        """True when every subproblem is an LP (no quadratic term)."""
        hit = self._np_cache.get("_is_lp")
        if hit is None:
            hit = not bool(torch.any(self.batch.qdiag != 0))
            self._np_cache["_is_lp"] = hit
        return hit

    def valid_Ebound(self, res):
        """Outer bound that is always valid: for LPs with finite boxes
        the dual objective is an exact Lagrangian value at any iterate;
        otherwise uncertified scenarios are masked to -inf."""
        if self.is_lp and self.all_bounds_finite:
            return self.Ebound(res.dual_obj)
        return self.Ebound(res.dual_obj, converged=res.converged)

    def check_W_bound_supported(self):
        """W-based Lagrangian bounds are valid because the probability-
        weighted W sums to zero per node.  Under variable_probability
        the x̄ weights differ from the scenario probabilities, that sum
        no longer telescopes, and such a bound would be wrong: raise
        (spopt.py:669-677 of the JAX package)."""
        if self.batch.var_prob is not None:
            raise NotImplementedError(
                "W-based Lagrangian bounds are not valid under "
                "variable_probability (prob-weighted W no longer "
                "telescopes to zero per node); use the EF consensus "
                "solve or Iter0's W-free bound instead")

    @property
    def all_bounds_finite(self):
        hit = self._np_cache.get("_bounds_finite")
        if hit is None:
            hit = bool(torch.all(torch.isfinite(self.batch.lb))
                       and torch.all(torch.isfinite(self.batch.ub)))
            self._np_cache["_bounds_finite"] = hit
        return hit

    def avg_min_max(self, vals):
        """Prob>0-masked average, min and max of a per-scenario
        quantity (reference spopt.py:469)."""
        mask = (self.batch.prob > 0).cpu().numpy()
        v = (vals.detach().cpu().numpy() if torch.is_tensor(vals)
             else np.asarray(vals))[mask]
        return float(np.mean(v)), float(np.min(v)), float(np.max(v))

    # -- xhat evaluation (reduced second-stage solve) ---------------------
    # The fixed nonant columns are ELIMINATED (row bounds -= A_na @ v,
    # objective constant += c_na @ v) and the reduced problem is solved
    # with its own Ruiz prep, its row bounds widened by a relative
    # feastol ("xhat_feastol") — see the JAX package's block comment.

    @staticmethod
    def _shift_and_widen_rows(prep, row_lo, row_hi, shift, ftol):
        """Shift the row bounds by the fixed-column contribution, widen
        them by the feastol slack and rebuild the scaled prep bounds."""
        slack = ftol * (1.0 + torch.abs(shift))
        rlo = row_lo - shift
        rhi = row_hi - shift
        rlo = torch.where(torch.isfinite(rlo),
                          rlo - slack - ftol * (1.0 + torch.abs(rlo)), rlo)
        rhi = torch.where(torch.isfinite(rhi),
                          rhi + slack + ftol * (1.0 + torch.abs(rhi)), rhi)
        return reprep_row_bounds(prep, rlo, rhi), rlo, rhi

    def _xhat_cache(self, upto_stage=None):
        key = ("xhat_red", upto_stage)
        hit = self._np_cache.get(key)
        if hit is not None:
            return hit
        b = self.batch
        na = b.nonant_idx.cpu().numpy()
        pos = np.arange(na.size)
        if upto_stage is not None:
            stage = np.asarray(b.tree.stage_of)
            pos = np.flatnonzero(stage <= upto_stage)
            na = na[pos]
        nai = torch.as_tensor(na, dtype=torch.long, device=self.device)
        delta = delta_idx(b)
        if b.split_A:
            # split-native: the reduced system exists only if every
            # scenario-varying entry sits in an eliminated column
            # (farmer: the yields multiply the nonant acreages); then
            # A_red is the shared matrix with the nonant columns zeroed,
            # and the per-scenario part lives in the A_na shift, a
            # SplitA over the reduced (Kf-wide) column space
            cols_np = b.A.cols.cpu().numpy()
            if not np.all(np.isin(cols_np, na)):
                raise NotImplementedError(
                    "xhat evaluation on a split-native batch requires "
                    "all A-delta columns to be eliminated (nonant) "
                    "columns; this batch has deltas in kept columns")
            pos_of = np.zeros(b.num_vars, np.int64)
            pos_of[na] = np.arange(na.size)
            A_na = SplitA(shared=b.A.shared[:, nai], rows=b.A.rows,
                          cols=torch.as_tensor(pos_of[cols_np],
                                               dtype=torch.int32,
                                               device=self.device),
                          vals=b.A.vals)
            A_red = b.A.shared[None].clone()
        elif (delta is not None and not b.shared_A
                and not self.options.get("no_split_prep")
                and np.all(np.isin(np.asarray(delta[1]), na))):
            # every scenario-varying entry sits in an eliminated column,
            # so the reduced system is scenario-independent: stored
            # (1, M, N), its solves take the shared form
            A_na = b.A[:, :, nai]                  # (S, M, Kf)
            A_red = b.A[0:1].clone()
        else:
            A_na = b.A[:, :, nai]                  # (S, M, Kf)
            A_red = b.A.clone()
        A_red[:, :, nai] = 0.0
        c_na = b.c[:, nai]
        q_na = b.qdiag[:, nai]

        def zero_na(t):
            t = t.clone()
            t[:, nai] = 0.0
            return t

        c_red, q_red = zero_na(b.c), zero_na(b.qdiag)
        lb_red, ub_red = zero_na(b.lb), zero_na(b.ub)
        prep = prepare_batch(A_red, b.row_lo, b.row_hi)
        # FeasibilityTol analog, scaled to the accuracy of the solves
        # that generate candidates
        gen_eps = max(self.solver.eps,
                      float(self.options.get("superstep_eps") or 0.0))
        ftol = float(self.options.get(
            "xhat_feastol", min(1e-3, 3.0 * gen_eps)))

        def impl(vals, x0, y0, eps):
            vals2 = torch.atleast_2d(vals).to(b.c.dtype).expand(
                b.num_scens, na.size)
            shift = bmatvec(A_na, vals2)
            prep2, rlo, rhi = self._shift_and_widen_rows(
                prep, b.row_lo, b.row_hi, shift, ftol)
            oc = (b.obj_const + torch.sum(c_na * vals2, dim=1)
                  + 0.5 * torch.sum(q_na * vals2 * vals2, dim=1))
            return self.solver._solve_impl(
                prep2, c_red, q_red, lb_red, ub_red, oc, x0, y0,
                None, eps), (rlo, rhi, oc)

        hit = {"na": na, "pos": pos, "A_na": A_na, "A_red": A_red,
               "prep": prep, "c_red": c_red,
               "q_red": q_red, "lb_red": lb_red, "ub_red": ub_red,
               "impl": impl, "ftol": ftol}
        self._np_cache[key] = hit
        return hit

    def evaluate_xhat(self, nonant_values, upto_stage=None, tol=None,
                      warm="xhat_eval", certify="auto"):
        """Expected objective with nonants fixed to a candidate — the
        implementable inner bound.  Returns (Eobj, feasible).
        certify="auto" runs the float64 fallback only when the fast
        solve fails the feasibility check."""
        t0 = time.time()
        cache = self._xhat_cache(upto_stage)
        b = self.batch
        vals = nonant_values if torch.is_tensor(nonant_values) \
            else torch.as_tensor(np.array(nonant_values))
        vals = vals.to(self.device)[
            ..., torch.as_tensor(cache["pos"], device=self.device)]
        x0, y0 = self._named_warm.get(warm, (None, None))
        if x0 is None:
            x0 = torch.zeros_like(b.c)
            y0 = torch.zeros_like(b.row_lo)
        res, (rlo, rhi, oc) = cache["impl"](vals, x0, y0, self.solver_eps)
        self._account(cache["prep"], int(res.iters))
        if certify == "auto":
            certify = not (self.feas_prob(res, tol=tol) > 1.0 - 1e-6)
        if certify:
            # re-solve every scenario that fails the feasibility test,
            # not only the unconverged ones: below the loop dtype's eps
            # floor (f32: 1.19e-5) a solve converges with a primal
            # residual above the test's 10 x solver_eps, and skipping it
            # left such candidates infeasible however often they were
            # evaluated (ROADMAP.md §C)
            res = self._certified_resolve(
                res, c=cache["c_red"], qdiag=cache["q_red"],
                lb=cache["lb_red"], ub=cache["ub_red"],
                A=cache["A_red"], row_lo=rlo, row_hi=rhi,
                obj_const=oc, prep_key=("_prep64_xhat", upto_stage),
                select=~res.converged | ~self._feasible(res, tol))
        self._named_warm[warm] = (res.x, res.y)
        feas = self.feas_prob(res, tol=tol) > 1.0 - 1e-6
        eobj = float(self.Eobjective(res.obj))
        self._solve_wall += time.time() - t0
        return eobj, feas


    def evaluate_candidates(self, candidates, tol=None,
                            warm="xhat_candidates", eps=None,
                            iters_cap=None, return_mass=False):
        """Evaluate k candidates (k, K) in one stacked solve: the
        reduced xhat system tiled k-fold along the scenario axis
        (spopt.py:876-1000 of the JAX package).  Returns (Eobjs (k,),
        feas (k,)) as numpy arrays, and with return_mass each
        candidate's feasible probability mass.

        A screening pass: no f64 certify, feasibility by the primal
        residual under `tol`.  eps / iters_cap loosen and cap this solve
        alone (ranking callers such as uc.one_opt_commitment)."""
        cands = np.asarray(candidates)
        k, _ = cands.shape
        b = self.batch
        S_all = b.num_scens
        cache = self._xhat_cache(None)
        tkey = ("xhat_stack", k)
        # one live stack only: each holds a k-fold tiling of the
        # per-scenario arrays, so a stack for another k is dropped
        for stale in [key for key in self._np_cache
                      if isinstance(key, tuple) and key
                      and key[0] == "xhat_stack" and key != tkey]:
            del self._np_cache[stale]
        stack = self._np_cache.get(tkey)
        if stack is None:
            def tile(a):
                # shared leaves (leading dim 1) serve every candidate;
                # a SplitA tiles its per-scenario values only
                if isinstance(a, SplitA):
                    return dataclasses.replace(a, vals=tile(a.vals))
                if a.shape[0] == 1 and S_all > 1:
                    return a
                return a.repeat((k,) + (1,) * (a.dim() - 1))

            prep = cache["prep"]
            nai = torch.as_tensor(cache["na"], dtype=torch.long,
                                  device=self.device)
            stack = {
                "A_na": tile(cache["A_na"]),
                "c_na": tile(b.c[:, nai]), "q_na": tile(b.qdiag[:, nai]),
                "c_red": tile(cache["c_red"]),
                "q_red": tile(cache["q_red"]),
                "lb_red": tile(cache["lb_red"]),
                "ub_red": tile(cache["ub_red"]),
                "row_lo": tile(b.row_lo), "row_hi": tile(b.row_hi),
                "obj_const": tile(b.obj_const), "prob": tile(b.prob),
                "prep": prep.map(tile)}
            self._np_cache[tkey] = stack
        t0 = time.time()
        x0, y0 = self._named_warm.get(warm, (None, None))
        if x0 is None or x0.shape[0] != k * S_all:
            x0 = torch.zeros_like(stack["c_red"])
            y0 = torch.zeros_like(stack["row_lo"])
        eps = (self.solver_eps if eps is None
               else round_to_dtype(eps, b.c.dtype))
        vals2 = torch.as_tensor(cands, device=self.device).to(
            b.c.dtype).repeat_interleave(S_all, dim=0)     # (k*S, K)
        shift = bmatvec(stack["A_na"], vals2)
        prep2, _, _ = self._shift_and_widen_rows(
            stack["prep"], stack["row_lo"], stack["row_hi"], shift,
            cache["ftol"])
        # at UC's full width each (k*S, M) buffer is ~0.6 GB: free the
        # temporaries before the solve allocates its own
        del shift
        oc = (stack["obj_const"]
              + torch.sum(stack["c_na"] * vals2, dim=1)
              + 0.5 * torch.sum(stack["q_na"] * vals2 * vals2, dim=1))
        del vals2
        res = self.solver._solve_impl(
            prep2, stack["c_red"], stack["q_red"], stack["lb_red"],
            stack["ub_red"], oc, x0, y0, None, eps, iters_cap)
        del prep2
        objs = torch.sum((stack["prob"] * res.obj).reshape(k, S_all),
                         dim=1)
        self._account(stack["prep"], int(res.iters), S=k * S_all)
        self._named_warm[warm] = (res.x, res.y)
        tol = tol or 10 * float(self.solver_eps)
        ok = (res.pres < tol).reshape(k, S_all).cpu().numpy()
        _sync(res.x)
        self._solve_wall += time.time() - t0
        prob = b.prob.cpu().numpy()
        feas = np.all(ok | ~(prob > 0)[None, :], axis=1)
        objs = objs.cpu().numpy()
        if return_mass:
            mass = (ok * prob[None, :]).sum(axis=1) / max(prob.sum(),
                                                          1e-12)
            return objs, feas, mass
        return objs, feas

    # -- nonant fixing (reference spopt.py:592-740 _fix_nonants) ----------
    def fixed_nonant_bounds(self, values, upto_stage=None):
        """(lb, ub) that pin the nonant slots to `values`: (K,) for all
        scenarios alike, or (S, K) per scenario.  upto_stage: pin only
        the slots whose stage is at most upto_stage (reference
        xhat_eval.py:326 fix_nonants_upto_stage)."""
        b = self.batch
        na = b.nonant_idx
        vals = torch.as_tensor(values, device=self.device).to(b.lb.dtype)
        if vals.dim() == 1:
            vals = vals[None, :].expand(b.num_scens, b.num_nonants)
        if upto_stage is not None:
            keep = torch.as_tensor(np.asarray(b.tree.stage_of)
                                   <= upto_stage, device=self.device)
            lo = torch.where(keep[None, :], vals, b.lb[:, na])
            hi = torch.where(keep[None, :], vals, b.ub[:, na])
        else:
            lo = hi = vals
        lb, ub = b.lb.clone(), b.ub.clone()
        lb[:, na] = lo
        ub[:, na] = hi
        return lb, ub


def _sync(t):
    """Wait for the device work that produces `t` (timing boundary)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
