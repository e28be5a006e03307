"""ExtensiveFormMIP — EF solves with integer variables (port of
`mpisppy_tpu/opt/mip.py`).

The reference hands the EF to a commercial branch-and-cut solver.
Here, as in the JAX package, it is LP relaxation plus progressive
fix-and-round, every LP a batched PDHG solve (the chunk kernel on the
card for the per-scenario solves, the consensus route for the coupled
ones).

Method — three-phase LP diving with strong rounding:

  0. the consensus LP relaxation -> a valid outer bound.
  Phase Z (gating binaries): strong-round the binaries that gate a
     nonant column (raising the binary loosens a row that constrains
     the column: the big-M setup-forcing pattern), by cost-weighted
     fractionality, each by solving the EF with the binary fixed at 0
     and at 1 and keeping the cheaper feasible direction.
  Phase A (coupled): dive on the integer nonant columns over the
     consensus EF: bulk-fix every one within `int_tol` of an integer,
     then strong-round the most fractional one.  A nonant fix covers
     every scenario of its tree node.
  Bridge: pin the continuous nonants at their consensus values; the EF
     then separates by scenario.
  Phase B (separable): batched per-scenario dives: every scenario
     bulk-fixes its near-integral variables and strong-rounds its most
     fractional one, all at once (floor and ceil in one stacked
     launch).
  3. a final solve with every integer fixed gives the integer-feasible
     incumbent; (incumbent - bound)/|incumbent| is a true gap.

The 1-opt / 2-opt refinement re-tests fixed binaries in stacked
8-wide launches.  Ties on degenerate faces are broken by a relative
cost perturbation drawn from `np.random.RandomState(seed)` on the
host (so the fix order is the JAX package's); reported objectives use
the true costs.  The refinement skips a pass already proved clean at
the same fixing by a SHA-1 digest of the host float64 bounds.

The bookkeeping (bounds, masks, decisions) is numpy on the host, as in
the JAX package; the solves and the row-violation test run on the
batch's device.  Golden: sizes-3's incumbent is 220000 at 2
significant figures (reference mpisppy/tests/test_ef_ph.py:137).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from .. import global_toc
from ..device import host
from ..ops.pdhg import ConsensusSpec
from .ef import ExtensiveForm


class ExtensiveFormMIP(ExtensiveForm):
    _needs_dense_A = True   # the dive indexes A by scenario
    _use_split_prep = False  # _lp_multi tiles prep.A as a dense array

    def __init__(self, options, all_scenario_names, **kwargs):
        super().__init__(options, all_scenario_names, **kwargs)
        if not bool(torch.any(self.batch.integer_mask)):
            raise ValueError("batch has no integer variables; use "
                             "ExtensiveForm")
        self._np_dtype = host(self.batch.c[:1, :1]).dtype

    def _t(self, a, dtype=None):
        """A host array as a tensor on the batch's device."""
        return torch.as_tensor(np.asarray(a), device=self.device,
                               dtype=dtype)

    # -- one consensus LP solve under the current fixing bounds -------------
    def _lp(self, c_s, lb, ub, x0=None, y0=None, consensus=True,
            eps=None, certify=True, max_iters=None):
        """c_s, lb, ub: host arrays.  eps: a loose tolerance for the
        dive's probes (they compare objectives, they publish no bound);
        certify=False skips the f64 fallback, which only the
        bound-carrying solves (root, bridge, final) take."""
        b = self.batch
        p = host(b.prob)[:, None]
        solver = (self.solver if certify
                  else self._dive_solver(max_iters))
        pt = b.prob[:, None]
        res = solver.solve(
            self.prep, self._t(c_s * p), b.qdiag * pt, self._t(lb),
            self._t(ub), obj_const=b.obj_const * b.prob,
            x0=x0, y0=y0,
            consensus=self.consensus if consensus else None,
            eps=eps)
        if not certify:
            return res
        if not bool(torch.all(res.converged)):
            f64 = torch.float64
            kw = dict(
                c=self._t(np.asarray(c_s, np.float64) * p),
                qdiag=b.qdiag.to(f64) * pt.to(f64),
                lb=self._t(lb, f64), ub=self._t(ub, f64),
                obj_const=b.obj_const.to(f64) * b.prob.to(f64))
            if consensus:
                res = self._certified_ef_resolve(res, **kw)
            else:
                res = self._certified_resolve(res, **kw)
        return res

    def _dive_solver(self, max_iters=None):
        """The probes' solver: the same knobs with a capped iteration
        budget (an infeasible probe never converges) and hot_dtype
        pinned off (probes feed prune/accept decisions)."""
        if max_iters is None:
            max_iters = int(self.options.get("mip_dive_max_iters",
                                             60000))
        key = ("_dive_solver", max_iters)
        s = self._np_cache.get(key)
        if s is None:
            s = self.solver.clone(max_iters=max_iters, hot_dtype=None)
            self._np_cache[key] = s
        return s

    # -- k bound-variants of the same EF in one stacked launch --------------
    def _lp_multi(self, c_s, bounds, x0=None, y0=None, consensus=True,
                  eps=None, max_iters=None):
        """Solve k variants of the (consensus or separable) EF that
        differ only in their bounds in one launch: the batch tiled
        k-fold along the scenario axis, each copy's tree nodes offset so
        that the k EFs stay decoupled, and the norm, steps and verdict
        taken per copy (`ConsensusSpec.num_copies`).  A stacked launch
        runs to the max of the variants' iteration counts.

        bounds: list of (lb, ub) host arrays.  x0/y0: one warm start
        shared by every variant.  Returns k SolveResult views sliced
        back to (S, ...)."""
        k = len(bounds)
        if k == 1:
            return [self._lp(c_s, bounds[0][0], bounds[0][1], x0=x0,
                             y0=y0, consensus=consensus, eps=eps,
                             certify=False, max_iters=max_iters)]
        b = self.batch
        S = b.num_scens
        key = ("mip_stack", k, bool(consensus))
        st = self._np_cache.get(key)
        if st is None:
            def tile(a):
                return a.repeat((k,) + (1,) * (a.dim() - 1))
            p = b.prob[:, None]
            st = {"prep": self.prep.map(tile),
                  "qdiag": tile(b.qdiag * p),
                  "obj_const": tile(b.obj_const * b.prob),
                  "consensus": None}
            if consensus:
                node_of = host(b.tree.node_of)
                offs = np.concatenate(
                    [node_of + i * b.tree.num_nodes for i in range(k)],
                    axis=0)
                st["consensus"] = ConsensusSpec(
                    node_of=self._t(offs, torch.long),
                    nonant_idx=b.nonant_idx,
                    num_nodes=k * b.tree.num_nodes,
                    # per-copy norms and verdicts: an infeasible probe
                    # must not pollute its siblings' step sizes
                    num_copies=k)
            self._np_cache[key] = st
        dt = self._np_dtype
        p_np = host(b.prob)[:, None]
        c_t = self._t(np.tile(np.asarray(c_s * p_np, dt), (k, 1)))
        lb_t = self._t(np.concatenate(
            [np.asarray(lo, dt) for lo, _ in bounds], axis=0))
        ub_t = self._t(np.concatenate(
            [np.asarray(hi, dt) for _, hi in bounds], axis=0))
        x0_t = None if x0 is None else x0.repeat(k, 1)
        y0_t = None if y0 is None else y0.repeat(k, 1)
        res = self._dive_solver(max_iters).solve(
            st["prep"], c_t, st["qdiag"], lb_t, ub_t,
            obj_const=st["obj_const"], x0=x0_t, y0=y0_t,
            consensus=st["consensus"], eps=eps)

        def view(i):
            sl = slice(i * S, (i + 1) * S)
            return dataclasses.replace(
                res, x=res.x[sl], y=res.y[sl], obj=res.obj[sl],
                dual_obj=res.dual_obj[sl], pres=res.pres[sl],
                dres=res.dres[sl], gap=res.gap[sl],
                converged=res.converged[sl])

        return [view(i) for i in range(k)]

    def _row_viol(self, res):
        """(S,) max per-row relative constraint violation in user space,
        in float64 on the batch's device.  The kernel's pres normalizes
        by the largest scaled bound over all rows, which can hide a
        large violation on a small-scale row; dive decisions need the
        componentwise test.  A row's violation is relative to its
        operand magnitude sum |a_j x_j|."""
        b = self.batch
        f64 = torch.float64
        A = self._np_cache.get("_A64")
        if A is None:
            A = b.A.to(f64)
            self._np_cache["_A64"] = A
        x = res.x.to(f64) if torch.is_tensor(res.x) else self._t(
            res.x, f64)
        Ax = torch.einsum("smn,sn->sm", A, x)
        mag = torch.einsum("smn,sn->sm", torch.abs(A), torch.abs(x))
        lo, hi = b.row_lo.to(f64), b.row_hi.to(f64)
        zero = torch.zeros_like(Ax)
        vlo = torch.where(torch.isfinite(lo), torch.clamp(lo - Ax, min=0.0)
                          / (1.0 + torch.abs(lo) + mag), zero)
        vhi = torch.where(torch.isfinite(hi), torch.clamp(Ax - hi, min=0.0)
                          / (1.0 + torch.abs(hi) + mag), zero)
        return host(torch.amax(torch.maximum(vlo, vhi), dim=1))

    # Branch decisions tell structural infeasibility (an unservable
    # demand shows as O(1) relative violation) from solver noise (a
    # converged scaled-eps solve can carry ~1e-4 relative violations on
    # big-M rows).
    VIOL_TOL = 1e-3

    def _dive_feasible(self, res):
        return (bool(torch.all(res.converged))
                and float(np.max(self._row_viol(res))) < self.VIOL_TOL)

    def solve_mip(self, int_tol=1e-4, perturb=1e-7, max_rounds=None,
                  verbose=False, seed=0, dive_eps=None):
        """Two-phase LP-diving MIP solve.  Returns a dict with:
          incumbent  — objective of the integer-feasible solution
          bound      — root LP relaxation bound (valid outer bound)
          gap        — |incumbent - bound| / |incumbent|
          x          — (S, N) solution (integer slots integral)
          rounds, lp_solves — dive statistics
        Raises RuntimeError if no integer-feasible point is found
        (both strong-rounding directions infeasible).

        dive_eps (option "mip_dive_eps", default max(1e-4, solver
        eps)): tolerance of the DIVE solves — branch probes compare
        objectives, they don't publish bounds, so they run loose and
        uncertified; only the root relaxation (outer bound) and the
        final fixed-integer solve (incumbent) run at the certified
        tolerance (VERDICT r3 item 5)."""
        b = self.batch
        imask = host(b.integer_mask).copy()
        live = host(b.prob) > 0
        imask[~live] = False          # padding scenarios: don't dive
        lb = host(b.lb).astype(np.float64).copy()
        ub = host(b.ub).astype(np.float64).copy()
        dt = self._np_dtype
        S, N = lb.shape
        if dive_eps is None:
            dive_eps = float(self.options.get(
                "mip_dive_eps", max(1e-4, float(self.solver_eps))))

        # deterministic tie-breaking perturbation on integer columns
        # (relative, so scale-free); reported objectives use the TRUE c
        c_s = host(b.c).astype(np.float64).copy()
        if perturb:
            rng = np.random.RandomState(seed)
            pert = perturb * (1.0 + np.abs(c_s)) * rng.rand(*c_s.shape)
            c_s = c_s + np.where(imask, pert, 0.0)
        c_s = c_s.astype(dt)

        # a nonant column is ONE shared variable per tree node: any fix
        # must cover every member scenario or the kernel's synchronized
        # members would diverge (ops/pdhg.ConsensusSpec invariant)
        na = host(b.nonant_idx)
        col_to_k = {int(col): k for k, col in enumerate(na)}
        node_of = host(b.tree.node_of)
        na_cols = np.zeros(N, bool)
        na_cols[na] = True

        def fix_at(lb_a, ub_a, si, vi, val):
            k = col_to_k.get(int(vi))
            if k is None:
                lb_a[si, vi] = ub_a[si, vi] = val
            else:
                members = node_of[:, k] == node_of[si, k]
                lb_a[members, vi] = ub_a[members, vi] = val

        # the REPORTED outer bound comes from the root relaxation under
        # the TRUE c: the perturbed-c dual objective is only valid for
        # the original problem up to O(perturb)*|c.x|, which could in
        # principle exceed the true optimum by that epsilon
        res_true = self._lp(host(b.c).astype(dt), lb.astype(dt),
                            ub.astype(dt))
        if not self._dive_feasible(res_true):
            raise RuntimeError("EF LP relaxation infeasible/unsolved")
        root_bound = float(np.sum(host(res_true.dual_obj)))
        # the dive itself runs on the perturbed c_s (tie-breaking);
        # warm-started from the true-c vertex this re-solve is cheap
        res = self._lp(c_s, lb.astype(dt), ub.astype(dt),
                       x0=res_true.x, y0=res_true.y,
                       eps=dive_eps, certify=False)
        if not self._dive_feasible(res):
            res = res_true

        max_rounds = max_rounds or (int(np.sum(imask)) + 20)
        state = {"res": res, "lp_solves": 2, "rounds": 0}

        # gating binaries: binary b loosens row m for other columns when
        # raising b raises the slack (A[s,m,b] < 0 against a finite hi,
        # or > 0 against a finite lo) and the row also touches a nonant
        A_np = host(b.A)
        hi_fin = np.isfinite(host(b.row_hi))           # (S, M)
        lo_fin = np.isfinite(host(b.row_lo))
        row_has_na = np.any(A_np[:, :, na] != 0, axis=2)     # (S, M)
        loosens = ((A_np < 0) & (hi_fin & row_has_na)[:, :, None]) | \
                  ((A_np > 0) & (lo_fin & row_has_na)[:, :, None])
        is_binary = imask & (host(b.lb) == 0) & (
            host(b.ub) == 1)
        gating = is_binary & np.any(loosens, axis=1) & ~na_cols[None, :]
        # a positive-cost binary gating a SHARED variable equals that
        # variable's support indicator at any optimum, so its value is
        # common to the gated nonant's whole tree node: map each gating
        # column to the first nonant slot it gates and broadcast fixes
        # over that node's members (cuts the phase-Z round count by S).
        # Soundness requires the loosening rows to couple the binary to
        # nonant columns EXCLUSIVELY — if those rows also involve
        # scenario-local columns, the support-indicator equality is not
        # implied and a broadcast could cut off the optimum, so such a
        # binary is fixed per-scenario instead.  Broadcasting also
        # requires every gated nonant slot to share one node structure
        # (so "the node's members" is well-defined).
        gate_k = {}
        for j in np.flatnonzero(np.any(gating, axis=0)):
            rows_m = np.any(loosens[:, :, j], axis=0)        # (M,)
            cols_touched = np.any(A_np[:, rows_m, :] != 0,
                                  axis=(0, 1))               # (N,)
            cols_touched[j] = False
            if not (cols_touched & na_cols).any():
                continue
            if (cols_touched & ~na_cols).any():
                continue                  # scenario-local coupling
            ks = [col_to_k[int(cc)]
                  for cc in np.flatnonzero(cols_touched & na_cols)]
            if all(np.array_equal(node_of[:, ks[0]], node_of[:, k2])
                   for k2 in ks[1:]):
                gate_k[int(j)] = ks[0]

        def fix_gating(lb_a, ub_a, si, vi, val):
            k = gate_k.get(int(vi))
            if k is None:
                lb_a[si, vi] = ub_a[si, vi] = val
            else:
                members = node_of[:, k] == node_of[si, k]
                lb_a[members, vi] = ub_a[members, vi] = val

        lb0 = host(b.lb).astype(np.float64)
        ub0 = host(b.ub).astype(np.float64)
        bulk_fixed = np.zeros_like(imask)

        def near_integral(v, unfixed):
            """Integrality test scaled to SOLVER NOISE: the kernel's
            accuracy on a value of size |v| is ~eps*|v| (plus slack for
            distance-to-vertex exceeding the KKT residual), so a
            14499.99 read of a true 14500 counts as integral without a
            fixed absolute tol strong-branching noise on every
            large-magnitude integer — while a true .5-fractional at
            that magnitude is NOT swallowed (measured: a
            value-relative int_tol*(1+|v|) test fixed genuine
            fractionals and drove the dive into infeasible corners)."""
            r = np.round(v)
            frac = np.abs(v - r)
            # noise scale follows the accuracy the dive ACTUALLY solves
            # at (dive_eps), floored at the certified eps
            noise = max(float(self.solver_eps), 0.1 * dive_eps)
            atol = int_tol + 100.0 * noise * (1.0 + np.abs(v))
            return r, frac, unfixed & (frac <= np.minimum(atol, 0.4))

        def coupled_dive(mask, phase, weight=None, fixer=None):
            """Sequential strong-rounding dive over `mask` columns at
            the consensus level.  weight: optional (S, N) priority
            multiplier on fractionality.  fixer: bound-fixing fn
            (defaults to the nonant-aware fix_at).  Bulk fixes are
            tentative: on a dead end they are released once and
            re-derived around the strong fixes."""
            fixer = fixer or fix_at
            retried = False
            skip_bulk = False
            while True:
                res = state["res"]
                x = host(res.x).astype(np.float64)
                unfixed = mask & (lb != ub)
                if not unfixed.any():
                    return
                state["rounds"] += 1
                if state["rounds"] > max_rounds:
                    raise RuntimeError(
                        f"dive did not finish in {max_rounds} rounds "
                        f"(phase {phase})")
                v = np.where(unfixed, x, 0.0)
                r, frac, integral = near_integral(v, unfixed)
                if skip_bulk:
                    # a release without suppressing re-bulk-fixing
                    # would just re-derive the same dead end
                    integral &= False
                if integral.any():
                    rv = np.clip(r, lb, ub)
                    lb[integral] = rv[integral]
                    ub[integral] = rv[integral]
                    bulk_fixed[integral] = True
                still = unfixed & ~integral
                if not still.any():
                    state["res"] = self._lp(
                        c_s, lb.astype(dt), ub.astype(dt),
                        x0=res.x, y0=res.y, eps=dive_eps, certify=False)
                    state["lp_solves"] += 1
                    # bulk fixes are only kept if the re-solve stays
                    # feasible — a wrongly swallowed fractional shows
                    # up here, not at the next strong branch
                    if not self._dive_feasible(state["res"]) \
                            and bulk_fixed.any() and not retried:
                        lb[bulk_fixed] = lb0[bulk_fixed]
                        ub[bulk_fixed] = ub0[bulk_fixed]
                        bulk_fixed[:] = False
                        retried = True
                        skip_bulk = True
                        state["res"] = self._lp(
                            c_s, lb.astype(dt), ub.astype(dt),
                            eps=dive_eps, certify=False)
                        state["lp_solves"] += 1
                        if verbose:
                            global_toc(f"MIP dive {phase}: bulk fixes "
                                       f"broke feasibility — released")
                    continue
                score = frac if weight is None else frac * weight
                flat = np.argmax(np.where(still, score, -1.0))
                si, vi = np.unravel_index(flat, frac.shape)
                # both strong-rounding directions probed in ONE stacked
                # launch (the phase-B floor/ceil-batch trick at the
                # consensus level — VERDICT r3 item 5)
                dirs, dbounds = [], []
                for d in (np.floor(x[si, vi]), np.ceil(x[si, vi])):
                    if d < lb[si, vi] - 1e-9 or d > ub[si, vi] + 1e-9:
                        continue
                    lb2, ub2 = lb.copy(), ub.copy()
                    fixer(lb2, ub2, si, vi, d)
                    dirs.append(d)
                    dbounds.append((lb2.astype(dt), ub2.astype(dt)))
                cands = (self._lp_multi(c_s, dbounds, x0=res.x,
                                        y0=res.y, eps=dive_eps)
                         if dbounds else [])
                state["lp_solves"] += len(dbounds)
                best = None
                for d, cand in zip(dirs, cands):
                    feas = self._dive_feasible(cand)
                    if verbose:
                        global_toc(
                            f"  branch ({si},{vi})={d:g}: feas={feas} "
                            f"pres={float(np.max(host(cand.pres))):.2e} "
                            f"conv={int(np.sum(host(cand.converged)))} "
                            f"obj={float(np.sum(host(cand.obj))):.6g}")
                    if not feas:
                        continue
                    obj = float(np.sum(host(cand.obj)))
                    if best is None or obj < best[0]:
                        best = (obj, d, cand)
                if best is None:
                    if bulk_fixed.any() and not retried:
                        # release tentative bulk fixes, keep strong ones
                        lb[bulk_fixed] = lb0[bulk_fixed]
                        ub[bulk_fixed] = ub0[bulk_fixed]
                        bulk_fixed[:] = False
                        retried = True
                        skip_bulk = True
                        state["res"] = self._lp(
                            c_s, lb.astype(dt), ub.astype(dt),
                            x0=res.x, y0=res.y, eps=dive_eps,
                            certify=False)
                        state["lp_solves"] += 1
                        if verbose:
                            global_toc(f"MIP dive {phase}: dead end — "
                                       f"released bulk fixes")
                        continue
                    if gate_k.pop(int(vi), None) is not None:
                        # the node-broadcast fix was the culprit (the
                        # support-indicator equality held structurally
                        # but the dive's earlier fixes made it binding
                        # scenario-asymmetrically): demote this binary
                        # to per-scenario fixing and re-probe
                        if verbose:
                            global_toc(f"MIP dive {phase}: dead end — "
                                       f"col {vi} demoted to "
                                       f"per-scenario fixing")
                        continue
                    raise RuntimeError(
                        f"both strong-rounding directions infeasible "
                        f"at scenario {si}, col {vi} (phase {phase})")
                retried = False
                skip_bulk = False
                _, d, state["res"] = best
                fixer(lb, ub, si, vi, d)
                if verbose:
                    global_toc(
                        f"MIP dive {phase} round {state['rounds']}: "
                        f"fixed ({si},{vi})={d:g}, "
                        f"{int(np.sum(mask & (lb != ub)))} left, "
                        f"obj~{best[0]:.6g}")

        def refine_binaries(mask, fixer, phase):
            """1-opt / 2-opt re-testing of fixed BINARY decisions with
            all of them integral: the greedy decided each binary while
            later ones were still fractional (their cost amortized to
            ~nothing), so flips and open/close swaps are re-evaluated
            by one warm consensus LP each (the continuous rest
            re-optimizes exactly).  Measured: recovers ~0.7% on
            sizes-3 (setup binaries) and ~11% on sslp_5_25_50
            (facility-open nonants)."""
            cols = np.flatnonzero(np.any(mask, axis=0))
            if cols.size == 0:
                return

            def rep_scen(vi):
                return int(np.flatnonzero(mask[:, vi])[0])

            # accept threshold scaled to the dive solves' accuracy so
            # loose-eps objective noise can't fake an improvement
            accept = max(1e-7, 0.3 * dive_eps)
            # fingerprint digests of the bound-fixing at which a pass
            # proved "no improvement": a pass re-entered at an
            # UNCHANGED fixing (the sweep loop does this after the
            # other pass improves and then cleans) is a pure duplicate
            # — skip it.  Measured: removes ~1/3 of sizes-3 refine
            # wall.  Digest, not raw bytes: lb/ub are S*N*8 bytes.
            clean = {}

            def _fp(tag):
                h = hashlib.sha1(lb.tobytes())
                h.update(ub.tobytes())
                return (tag, h.hexdigest())
            # refinement probes share the dive iteration cap: a flip
            # whose probe can't converge inside it counts as
            # not-improving.  (Tighter caps were measured to reject
            # winning flips on sizes-3 — the golden's 225000 rounding
            # boundary leaves <0.05% slack.)
            refine_cap = int(self.options.get(
                "mip_refine_max_iters",
                self.options.get("mip_dive_max_iters", 60000)))
            screen_cap = max(2000, refine_cap // 10)
            # ranked-chunk verification: candidates are verified at
            # the full cap in screened-rank order, one 8-wide launch
            # at a time, stopping at the first launch that yields an
            # improvement — a mis-ranked winner is never LOST, it
            # just costs another launch.  mip_verify_chunks bounds how
            # many launches a NO-improvement scan pays before trusting
            # the screen's "nothing here" (budget-capped either way);
            # measured on sizes-3, winners rank in the top launch or
            # the second.
            verify_chunks = int(self.options.get("mip_verify_chunks", 3))

            def flip_bounds(flips):
                lb2, ub2 = lb.copy(), ub.copy()
                for si, vi, nv in flips:
                    fixer(lb2, ub2, si, vi, nv)
                return lb2.astype(dt), ub2.astype(dt)

            def _stacked_probe(flips_list, cap):
                """Evaluate flip variants in fixed-width-8 stacked
                launches at iteration cap `cap`; returns [(obj, feas,
                res)] aligned with flips_list.  A stacked launch runs
                to its SLOWEST member, so the cap is the cost lever."""
                out = []
                for i0 in range(0, len(flips_list), 8):
                    chunk = flips_list[i0:i0 + 8]
                    state["lp_solves"] += len(chunk)
                    pads = [flip_bounds(f) for f in chunk]
                    while len(pads) < 8:
                        pads.append(pads[-1])
                    rs = self._lp_multi(
                        c_s, pads,
                        x0=state["res"].x, y0=state["res"].y,
                        eps=dive_eps, max_iters=cap)
                    for r in rs[:len(chunk)]:
                        out.append((float(np.sum(host(r.obj))),
                                    self._dive_feasible(r), r))
                return out

            def refine_pass(tag, gen_candidates):
                """Shared screen -> ranked-chunk-verify -> apply-best
                body for the 1-opt and 2-opt passes.  Stage 1 ranks
                every candidate with short-cap launches (ranking needs
                relative order only; feasibility at the short cap is
                not trusted either way).  Stage 2 verifies at the full
                refine cap in rank order, 8 per launch, early-stopping
                at the first launch containing an improvement.
                Measured one-stage alternatives on sizes-3: serial
                LP-per-candidate 72 s; full-cap launches of ALL
                candidates ~115 s (a stacked launch runs to its
                slowest member); this pass keeps the same incumbent at
                a fraction of either."""
                nonlocal budget
                improved_any = False
                while budget > 0:
                    if clean.get(_fp(tag)):
                        return improved_any
                    cands = gen_candidates()
                    if not cands:
                        return improved_any
                    cur = float(np.sum(host(state["res"].obj)))
                    if len(cands) > 8:
                        # screens are the cheap stage: charge budget
                        # per LAUNCH (the full-cap verifies below
                        # charge per candidate)
                        budget -= (len(cands) + 7) // 8
                        screened = _stacked_probe(cands, screen_cap)
                        order = np.argsort([o for o, _, _ in screened])
                        cands = [cands[i] for i in order]
                    best = None
                    for ci in range(0, min(len(cands),
                                           8 * verify_chunks), 8):
                        if budget <= 0 and ci:
                            break
                        chunk = cands[ci:ci + 8]
                        budget -= len(chunk)
                        for f, (obj, feas, r) in zip(
                                chunk,
                                _stacked_probe(chunk, refine_cap)):
                            if not feas:
                                continue
                            if obj < cur - accept * (1 + abs(cur)) \
                                    and (best is None or obj < best[0]):
                                best = (obj, f, r)
                        if best is not None:
                            break   # improvement in this launch
                    if best is None:
                        clean[_fp(tag)] = True
                        return improved_any
                    obj, f, r = best
                    for si, vi, nv in f:
                        fixer(lb, ub, si, vi, nv)
                    state["res"] = r
                    improved_any = True
                    if verbose:
                        global_toc(f"MIP dive {phase} {tag}(batch): "
                                   f"{[(v, nv) for _, v, nv in f]}, "
                                   f"obj~{obj:.6g}")
                return improved_any

            def gen_one_opt():
                """Single flips of every fixed binary."""
                flips = []
                for vi in cols:
                    si = rep_scen(vi)
                    if lb[si, vi] == ub[si, vi]:
                        flips.append([(si, vi, 1.0 - lb[si, vi])])
                return flips

            def gen_two_opt():
                """Open/close swaps single flips cannot reach (closing
                alone is infeasible, opening alone is pure cost; the
                swap can still be net cheaper)."""
                pairs = []
                for vi in cols:
                    si = rep_scen(vi)
                    if lb[si, vi] != ub[si, vi] or lb[si, vi] != 1:
                        continue
                    for vj in cols:
                        sj = rep_scen(vj)
                        if vj == vi or lb[sj, vj] != ub[sj, vj] \
                                or lb[sj, vj] != 0:
                            continue
                        pairs.append([(si, vi, 0.0), (sj, vj, 1.0)])
                return pairs

            improved = True
            sweep = 0
            budget = 12 * max(cols.size, 1)
            while improved and sweep < 4 and budget > 0:
                improved = False
                sweep += 1
                # 1-opt: re-test each decision with all binaries fixed
                if refine_pass("1-opt", gen_one_opt):
                    improved = True
                if not improved and refine_pass("2-opt", gen_two_opt):
                    improved = True

        # ---- Phase Z: gating binaries, costliest first -----------------
        if gating.any():
            coupled_dive(gating, "Z",
                         weight=1.0 + np.abs(host(b.c).astype(np.float64)),
                         fixer=fix_gating)
            refine_binaries(gating, fix_gating, "Z")
        # ---- Phase A: integer nonants over the consensus EF ------------
        na_int = imask & na_cols[None, :]
        coupled_dive(na_int, "A")
        na_bin = na_int & is_binary
        if na_bin.any():
            refine_binaries(na_bin, fix_at, "A")
        res = state["res"]
        lp_solves = state["lp_solves"]
        rounds = state["rounds"]

        # ---- Bridge: pin continuous nonants at consensus values --------
        cont_na = (~imask) & na_cols[None, :] & live[:, None]
        if cont_na.any():
            # ONE certified tight re-solve before pinning: the dive ran
            # loose (dive_eps), and pins at 1e-4-accurate values can
            # make the fully-fixed final system infeasible at the
            # certified tolerance
            res = self._lp(c_s, lb.astype(dt), ub.astype(dt),
                           x0=res.x, y0=res.y)
            lp_solves += 1
            x = host(res.x).astype(np.float64)
            pin = np.clip(x, lb, ub)
            lb = np.where(cont_na, pin, lb)
            ub = np.where(cont_na, pin, ub)

        # ---- Phase B: per-scenario integers, batched parallel dives ----
        b_mask = imask & ~na_cols[None, :]
        bx, by = res.x, res.y
        # bulk fixes are TENTATIVE in phase B: rounding a near-integral
        # value pins it to the wrong integer when later strong fixes
        # shift the vertex; on a dead end (both directions infeasible)
        # the affected scenario's bulk fixes are released and re-derived
        bulk_fixed[:] = False           # phase-B scope only
        retried = np.zeros(S, bool)
        # released scenarios skip re-bulk-fixing until a strong fix
        # lands (else a release just re-derives the same dead end)
        no_bulk = np.zeros(S, bool)
        while True:
            unfixed = b_mask & (lb != ub)
            if not unfixed.any():
                break
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError(f"dive did not finish in "
                                   f"{max_rounds} rounds (phase B)")
            # fresh independent solve under current bounds
            res = self._lp(c_s, lb.astype(dt), ub.astype(dt),
                           x0=bx, y0=by, consensus=False,
                           eps=dive_eps, certify=False)
            lp_solves += 1
            bx, by = res.x, res.y
            # scenarios whose system went infeasible under bulk fixes:
            # release those fixes before branching anything
            scen_bad = ((self._row_viol(res) >= self.VIOL_TOL)
                        | ~host(res.converged)) & live
            fixable = scen_bad & bulk_fixed.any(axis=1) & ~retried
            if fixable.any():
                rel = fixable[:, None] & bulk_fixed
                lb = np.where(rel, lb0, lb)
                ub = np.where(rel, ub0, ub)
                bulk_fixed &= ~rel
                retried |= fixable
                no_bulk |= fixable
                if verbose:
                    global_toc(f"MIP dive B round {rounds}: "
                               f"{int(np.sum(fixable))} scenario(s) "
                               f"infeasible under bulk fixes — "
                               f"released")
                continue
            if scen_bad.any():
                bad = int(np.flatnonzero(scen_bad)[0])
                xb = host(res.x).astype(np.float64)[bad]
                Axb = host(b.A).astype(np.float64)[bad] @ xb
                lo_b = host(b.row_lo).astype(np.float64)[bad]
                hi_b = host(b.row_hi).astype(np.float64)[bad]
                vb = np.maximum(
                    np.where(np.isfinite(lo_b), lo_b - Axb, 0),
                    np.where(np.isfinite(hi_b), Axb - hi_b, 0))
                wr = int(np.argmax(vb))
                raise RuntimeError(
                    f"phase-B subproblem infeasible at scenario {bad} "
                    f"(viol={float(self._row_viol(res)[bad]):.3e}, "
                    f"tol={self.VIOL_TOL:.1e}) with no bulk fixes to release; "
                    f"worst row {wr}: Ax={Axb[wr]:.4f} "
                    f"lo={lo_b[wr]:.4f} hi={hi_b[wr]:.4f}")
            x = host(res.x).astype(np.float64)
            v = np.where(unfixed, x, 0.0)
            r, frac, integral = near_integral(v, unfixed)
            integral &= ~no_bulk[:, None]
            # setups first, quantities second (same reasoning as phase
            # Z): while a scenario still has unfixed binaries, don't
            # bulk-lock its general integers — their relaxation values
            # assume amortized setup costs and overspend on setups
            bin_col = np.any(is_binary, axis=0)
            open_bin = (unfixed & is_binary).any(axis=1)
            integral &= ~(open_bin[:, None] & ~bin_col[None, :])
            # and strong-branch binaries before quantities
            frac = np.where(
                open_bin[:, None] & ~bin_col[None, :], 0.0, frac)
            if integral.any():
                rv = np.clip(r, lb, ub)
                lb = np.where(integral, rv, lb)
                ub = np.where(integral, rv, ub)
                bulk_fixed |= integral
            still = unfixed & ~integral
            if not still.any():
                continue
            # every scenario strong-rounds its own most fractional var
            pick = np.argmax(np.where(still, frac, -1.0), axis=1)  # (S,)
            has = still[np.arange(S), pick]
            vals = x[np.arange(S), pick]
            lo_d, hi_d = np.floor(vals), np.ceil(vals)
            # floor-batch + ceil-batch in ONE stacked launch (the two
            # directions share the while_loop, paying max not sum)
            rows = np.flatnonzero(has)
            dbounds, dvs = [], []
            for dvals in (lo_d, hi_d):
                lb2, ub2 = lb.copy(), ub.copy()
                dv = np.clip(dvals[rows], lb[rows, pick[rows]],
                             ub[rows, pick[rows]])
                lb2[rows, pick[rows]] = dv
                ub2[rows, pick[rows]] = dv
                dbounds.append((lb2.astype(dt), ub2.astype(dt)))
                dvs.append(dv)
            cands = self._lp_multi(c_s, dbounds, x0=bx, y0=by,
                                   consensus=False, eps=dive_eps)
            lp_solves += 2
            branches = []
            for cand, dv in zip(cands, dvs):
                feas = ((self._row_viol(cand) < self.VIOL_TOL)
                        & host(cand.converged))
                branches.append((host(cand.obj).astype(np.float64),
                                 feas, dv, rows))
            (obj_lo, feas_lo, dv_lo, rows), (obj_hi, feas_hi, dv_hi, _) \
                = branches
            neither = has & ~(feas_lo | feas_hi)
            if neither.any():
                release = neither & bulk_fixed.any(axis=1) & ~retried
                if not release.any():
                    bad = int(np.flatnonzero(neither)[0])
                    raise RuntimeError(
                        f"both strong-rounding directions infeasible "
                        f"at scenario {bad}, col {int(pick[bad])}: "
                        f"v={vals[bad]:.6f} "
                        f"viol(parent)="
                        f"{float(self._row_viol(res)[bad]):.3e} "
                        f"tol={self.VIOL_TOL:.1e}")
                # release the dead-ended scenarios' bulk fixes and
                # re-derive them around the strong fixes kept so far
                rel = release[:, None] & bulk_fixed
                lb = np.where(rel, lb0, lb)
                ub = np.where(rel, ub0, ub)
                bulk_fixed &= ~rel
                retried |= release
                no_bulk |= release
                if verbose:
                    global_toc(f"MIP dive B round {rounds}: released "
                               f"bulk fixes of "
                               f"{int(np.sum(release))} scenario(s)")
                continue
            retried[:] = False
            take_lo = feas_lo & ((obj_lo <= obj_hi) | ~feas_hi)
            choice = np.where(take_lo, lo_d, hi_d)
            keep = has & ~neither
            rows = np.flatnonzero(keep)
            dv = np.clip(choice[rows], lb[rows, pick[rows]],
                         ub[rows, pick[rows]])
            lb[rows, pick[rows]] = dv
            ub[rows, pick[rows]] = dv
            no_bulk[rows] = False
            if verbose:
                global_toc(f"MIP dive B round {rounds}: fixed "
                           f"{rows.size} scenario vars, "
                           f"{int(np.sum(b_mask & (lb != ub)))} left")

        # ---- final solve under full fixing, TRUE objective -------------
        final = self._lp(host(b.c).astype(dt), lb.astype(dt),
                         ub.astype(dt), x0=bx, y0=by, consensus=False)
        lp_solves += 1
        # acceptance is the honest user-space row-violation test (the
        # reported `viol` honesty metric); a hard-to-converge but
        # primal-feasible final system is a valid incumbent
        if float(np.max(self._row_viol(final)[live])) >= self.VIOL_TOL:
            raise RuntimeError("fixed-integer final LP infeasible")
        x = host(final.x).astype(np.float64)
        x = np.where(imask, np.clip(np.round(x), lb, ub), x)
        p = host(b.prob).astype(np.float64)
        incumbent = float(np.sum(
            p * (np.einsum("sn,sn->s", host(b.c).astype(np.float64), x)
                 + 0.5 * np.einsum(
                     "sn,sn->s", host(b.qdiag).astype(np.float64), x * x)
                 + host(b.obj_const).astype(np.float64))))
        gap = abs(incumbent - root_bound) / max(abs(incumbent), 1e-9)
        self._result = final
        # honesty metric: worst relative row violation of the SNAPPED
        # integer solution (the FeasibilityTol analog; first-order
        # kernel, so looser than a simplex basis would give)
        import dataclasses as _dc
        snapped = _dc.replace(final, x=self._t(np.asarray(x, dt)))
        viol = float(np.max(self._row_viol(snapped)))
        # the k-fold tiled probe stacks (_lp_multi) are per-run scratch
        # holding k copies of the constraint tensor — release them (the
        # same accretion rule spopt.evaluate_candidates enforces)
        for key in [k2 for k2 in self._np_cache
                    if isinstance(k2, tuple) and k2
                    and k2[0] == "mip_stack"]:
            del self._np_cache[key]
        return {"incumbent": incumbent, "bound": root_bound, "gap": gap,
                "x": x, "viol": viol, "rounds": rounds,
                "lp_solves": lp_solves}
