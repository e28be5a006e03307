"""Batched first-order LP/QP solver, restarted PDHG (port of
`mpisppy_tpu/ops/pdhg.py`, dense per-scenario A).

Problem form (per scenario):

    minimize    c @ x + 0.5 * qdiag @ (x*x)
    subject to  row_lo <= A @ x <= row_hi
                lb <= x <= ub

Chambolle-Pock iterations with Ruiz equilibration, a power-iteration
estimate of ||A||_2, KKT-triggered adaptive restarts (or the fixed
cadence), primal-weight rebalancing and per-scenario convergence
freezing — the JAX solver's algorithm, step for step.  The JAX
`lax.while_loop` is a Python loop here with one host sync per KKT
check; every inner iteration chunk between checks is one launch of the
hand-written CUDA kernel `ops.pdhg_chunk.fused_chunk`; the primal box
projection and the dual prox (`_proj_box`, `_dual_prox`) live beside
its plain twin in `ops/pdhg_chunk.py`, the only place the port runs
them.

Not ported yet (ROADMAP queue A): `ConsensusSpec`, `solve_compacted`,
the SplitA preps, the sparse shared block and the `MPISPPY_TPU_PDHG`
environment overlay.  Each raises
NotImplementedError where it would be selected.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from .. import not_ported
from ..ir import bmatvec as _Ax
from ..ir import bmatvec_t as _ATy
from .pdhg_chunk import _proj_box, fused_chunk

# hot_dtype knob -> (storage dtype, compute dtype) for the inner loop;
# "bf16x" stores A in bfloat16 and does all arithmetic in float32 (the
# chunk kernel converts A once per chunk, as it enters registers)
HOT_DTYPES = {
    "f32": (torch.float32, torch.float32),
    "bf16x": (torch.bfloat16, torch.float32),
}

def eps_floor(dtype):
    """Tightest tolerance `dtype` arithmetic can express (100 ulp)."""
    return 100.0 * float(torch.finfo(dtype).eps)


@dataclasses.dataclass(frozen=True)
class PreparedBatch:
    """Scaled constraint data, computed once per ScenarioBatch."""
    A: Any        # (S, M, N) scaled: D_r @ A @ D_c
    row_lo: Any   # (S, M) scaled: D_r * row_lo
    row_hi: Any   # (S, M)
    d_row: Any    # (S, M) row scaling D_r
    d_col: Any    # (S, N) col scaling D_c
    anorm: Any    # (S,) ||A_scaled||_2 estimate

    def map(self, fn):
        """A PreparedBatch with `fn` applied to every tensor."""
        return PreparedBatch(**{f.name: fn(getattr(self, f.name))
                                for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class SolveResult:
    x: Any          # (S, N) primal solution (unscaled)
    y: Any          # (S, M) row duals (unscaled)
    obj: Any        # (S,) primal objective (incl. obj_const)
    dual_obj: Any   # (S,) dual objective estimate (incl. obj_const)
    pres: Any       # (S,) relative primal residual (inf-norm)
    dres: Any       # (S,) relative dual residual (inf-norm)
    gap: Any        # (S,) relative primal-dual gap
    converged: Any  # (S,) bool
    iters: int      # iterations used (max across batch)
    restarts: Any = 0  # (S,) int restart events per scenario


# --------------------------------------------------------------------------
# scaling
# --------------------------------------------------------------------------

def _ruiz(A, n_iter=10, eps=1e-12):
    """Ruiz equilibration: (A_scaled, d_row, d_col) with
    A_scaled = diag(d_row) @ A @ diag(d_col), rows/cols ~unit inf-norm."""
    S, M, N = A.shape
    dr = torch.ones((S, M), dtype=A.dtype, device=A.device)
    dc = torch.ones((S, N), dtype=A.dtype, device=A.device)
    for _ in range(n_iter):
        absA = torch.abs(A)
        rmax = torch.amax(absA, dim=2)                  # (S, M)
        cmax = torch.amax(absA, dim=1)                  # (S, N)
        sr = torch.where(rmax <= eps, 1.0,
                         1.0 / torch.sqrt(torch.clamp(rmax, min=eps)))
        sc = torch.where(cmax <= eps, 1.0,
                         1.0 / torch.sqrt(torch.clamp(cmax, min=eps)))
        A = A * sr[:, :, None] * sc[:, None, :]
        dr = dr * sr
        dc = dc * sc
    return A, dr, dc


def _power_iteration(A, iters=40, seed=0, v0=None):
    """||A||_2 per scenario via power iteration on A^T A.  The start
    vector is a normal draw from a torch.Generator seeded `seed` on A's
    device, or `v0` (S, N) when given (tests pass the JAX package's
    PRNGKey(0) draw to compare norms)."""
    S, M, N = A.shape
    if v0 is None:
        gen = torch.Generator(device=A.device).manual_seed(int(seed))
        v = torch.randn((S, N), generator=gen, dtype=A.dtype,
                        device=A.device)
    else:
        v = torch.as_tensor(np.array(v0), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-30)
        v = _ATy(A, _Ax(A, v))
    av = _Ax(A, v / (torch.linalg.vector_norm(v, dim=1, keepdim=True)
                     + 1e-30))
    return torch.linalg.vector_norm(av, dim=1)


def _scale_rows(r, d_row):
    return torch.where(torch.isfinite(r), r * d_row, r)


def prepare_batch(A, row_lo, row_hi, ruiz_iters=10, v0=None):
    """One-time per-batch preprocessing (scale + norm estimate) on the
    device of A."""
    if A.dim() != 3 or A.shape[0] != row_lo.shape[0]:
        raise not_ported("a shared-A / SplitA prep (prepare_batch takes a "
                         "dense per-scenario (S, M, N) A)", 1)
    As, d_row, d_col = _ruiz(A, n_iter=ruiz_iters)
    anorm = _power_iteration(As, v0=v0)
    return PreparedBatch(
        A=As,
        row_lo=_scale_rows(row_lo, d_row),
        row_hi=_scale_rows(row_hi, d_row),
        d_row=d_row,
        d_col=d_col,
        # floor at 1: an all-zero A would otherwise blow up the steps
        anorm=torch.clamp(anorm, min=1.0),
    )


def reprep_row_bounds(prep: PreparedBatch, row_lo, row_hi):
    """Rebuild a prep's scaled row bounds from new RAW bounds (valid
    while the constraint operator is unchanged)."""
    return dataclasses.replace(prep,
                               row_lo=_scale_rows(row_lo, prep.d_row),
                               row_hi=_scale_rows(row_hi, prep.d_row))


def _unscale_A(A, dr, dc):
    """User-space view of a scaled dense constraint operator."""
    return A / dr[:, :, None] / dc[:, None, :]


# --------------------------------------------------------------------------
# core iteration pieces (all batched over leading S axis)
# --------------------------------------------------------------------------

def _residuals(x, y, c, qdiag, A, row_lo, row_hi, lb, ub):
    """KKT residuals + gap, all relative, inf-norms, batched
    (ops/pdhg.py:371-427 of the JAX package; PDLP convention)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    Ax = _Ax(A, x)
    pviol = torch.clamp(torch.maximum(row_lo - Ax, Ax - row_hi), min=0.0)
    pviol = torch.where(torch.isfinite(pviol), pviol, zero)
    hi_fin = torch.isfinite(row_hi)
    lo_fin = torch.isfinite(row_lo)
    rhs_scale = 1.0 + torch.amax(
        torch.where(hi_fin, torch.abs(row_hi), zero)
        + torch.where(lo_fin, torch.abs(row_lo), zero), dim=1)
    pres = torch.amax(pviol, dim=1) / rhs_scale

    grad = c + qdiag * x
    r = grad + _ATy(A, y)
    rpos = torch.clamp(r, min=0.0)
    rneg = torch.clamp(r, max=0.0)
    lb_fin = torch.isfinite(lb)
    ub_fin = torch.isfinite(ub)
    dviol = torch.where(lb_fin, zero, rpos) + torch.where(ub_fin, zero, -rneg)
    at_lb = x <= lb + 1e-9 * (1 + torch.abs(lb))
    at_ub = x >= ub - 1e-9 * (1 + torch.abs(ub))
    interior = ~(at_lb | at_ub)
    dviol = torch.maximum(dviol, torch.where(interior, torch.abs(r), zero))
    obj_scale = 1.0 + torch.amax(torch.abs(c), dim=1)
    dres = torch.amax(dviol, dim=1) / obj_scale

    qxx = torch.sum(qdiag * x * x, dim=1)
    pobj = torch.sum(c * x, dim=1) + 0.5 * qxx
    ysup = torch.where(y > 0,
                       torch.where(hi_fin, y * row_hi, zero),
                       torch.where(lo_fin, y * row_lo, zero))
    rc = (torch.where(lb_fin, rpos * lb, zero)
          + torch.where(ub_fin, rneg * ub, zero))
    dobj = (-0.5 * qxx - torch.sum(ysup, dim=1) + torch.sum(rc, dim=1))
    gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))
    return pres, dres, gap, pobj, dobj


class PDHGSolver:
    """Restarted PDHG solver over a ScenarioBatch (dense A).  Typical
    use is through SPOpt.solve_loop, which supplies PH-modified
    objectives as plain tensors."""

    def __init__(self, max_iters=20000, eps=1e-6, check_every=40,
                 restart_every=16, omega0=1.0, use_pallas="auto",
                 pallas_tile=8, pallas_interpret=False,
                 restart_mode="adaptive", restart_beta_sufficient=0.2,
                 restart_beta_necessary=0.8, compact_threshold=0.0,
                 hot_dtype=None, sparse_threshold=0.0):
        # restart_every is in units of check_every inner iterations:
        # the forced cycle cap under "adaptive", the policy under "fixed"
        self.max_iters = int(max_iters)
        self.eps = float(eps)
        self.check_every = int(check_every)
        self.restart_every = int(restart_every)
        self.omega0 = float(omega0)
        if restart_mode not in ("adaptive", "fixed"):
            raise ValueError(
                f"restart_mode must be 'adaptive' or 'fixed', "
                f"got {restart_mode!r}")
        self.restart_mode = str(restart_mode)
        self.restart_beta_sufficient = float(restart_beta_sufficient)
        self.restart_beta_necessary = float(restart_beta_necessary)
        if float(compact_threshold) > 0.0:
            raise not_ported("pdhg_compact_threshold (solve_compacted)", 3)
        self.compact_threshold = 0.0
        # use_pallas / pallas_tile / pallas_interpret configure the TPU
        # kernel's tiling and are accepted for option compatibility
        # only: every inner chunk here goes through the CUDA kernel
        # (or its twin on CPU tensors), whatever they say
        self.use_pallas = use_pallas
        self.pallas_tile = int(pallas_tile)
        self.pallas_interpret = bool(pallas_interpret)
        if hot_dtype in (None, "", "none", "off", "f64", "float64"):
            hot_dtype = None
        elif hot_dtype not in HOT_DTYPES:
            raise ValueError(
                f"hot_dtype must be one of {sorted(HOT_DTYPES)} (or "
                f"None/'f64' for full precision), got {hot_dtype!r}")
        self.hot_dtype = hot_dtype
        if float(sparse_threshold) > 0.0:
            raise not_ported("pdhg_sparse_threshold (SparseSplitA)", 1)
        self.sparse_threshold = 0.0

    @classmethod
    def from_options(cls, options):
        """Build a solver from an SPBase-style options dict (the pdhg_*
        keys), with the JAX package's names and defaults."""
        if os.environ.get("MPISPPY_TPU_PDHG"):
            raise not_ported("the MPISPPY_TPU_PDHG option overlay", 5)
        o = dict(options or {})
        return cls(
            max_iters=int(o.get("pdhg_max_iters", 20000)),
            eps=float(o.get("pdhg_eps", 1e-6)),
            check_every=int(o.get("pdhg_check_every", 40)),
            restart_every=int(o.get("pdhg_restart_every", 16)),
            use_pallas=o.get("pdhg_use_pallas", "auto"),
            pallas_tile=int(o.get("pdhg_pallas_tile", 8)),
            pallas_interpret=bool(o.get("pdhg_pallas_interpret", False)),
            restart_mode=str(o.get("pdhg_restart_mode", "adaptive")),
            restart_beta_sufficient=float(
                o.get("pdhg_restart_beta_sufficient", 0.2)),
            restart_beta_necessary=float(
                o.get("pdhg_restart_beta_necessary", 0.8)),
            compact_threshold=float(o.get("pdhg_compact_threshold", 0.0)),
            hot_dtype=o.get("pdhg_hot_dtype"),
            sparse_threshold=float(o.get("pdhg_sparse_threshold", 0.0)))

    def config_key(self):
        """Hashable construction-time config (what `_solve_impl` reads)."""
        return (self.max_iters, self.eps, self.check_every,
                self.restart_every, self.omega0, self.use_pallas,
                self.pallas_tile, self.pallas_interpret,
                self.restart_mode, self.restart_beta_sufficient,
                self.restart_beta_necessary, self.compact_threshold,
                self.hot_dtype, self.sparse_threshold)

    def clone(self, **overrides):
        """A new solver with this one's full config, selected fields
        overridden."""
        cfg = dict(
            max_iters=self.max_iters, eps=self.eps,
            check_every=self.check_every,
            restart_every=self.restart_every, omega0=self.omega0,
            use_pallas=self.use_pallas, pallas_tile=self.pallas_tile,
            pallas_interpret=self.pallas_interpret,
            restart_mode=self.restart_mode,
            restart_beta_sufficient=self.restart_beta_sufficient,
            restart_beta_necessary=self.restart_beta_necessary,
            compact_threshold=self.compact_threshold,
            hot_dtype=self.hot_dtype,
            sparse_threshold=self.sparse_threshold)
        cfg.update(overrides)
        return type(self)(**cfg)

    # -- mixed precision ---------------------------------------------------
    def hot_eps_floor(self):
        """Tolerance floor of the hot dtype's compute precision (0.0
        when the hot loop runs full precision)."""
        if self.hot_dtype is None:
            return 0.0
        return eps_floor(HOT_DTYPES[self.hot_dtype][1])

    def wants_promotion(self, eps=None):
        """True when a solve at tolerance `eps` needs more precision
        than the hot dtype can express (the promotion rule)."""
        if self.hot_dtype is None:
            return False
        e = self.eps if eps is None else float(eps)
        return e < self.hot_eps_floor()

    def _hot_pair(self, caller_dtype):
        """(storage, compute) dtypes for the hot loop given the caller's
        dtype, or None when no downcast applies."""
        if self.hot_dtype is None:
            return None
        store, compute = HOT_DTYPES[self.hot_dtype]
        if caller_dtype == store and caller_dtype == compute:
            return None
        if torch.finfo(caller_dtype).bits < torch.finfo(compute).bits:
            return None     # never upcast the caller's data
        return store, compute

    # -- public ----------------------------------------------------------
    def solve(self, prep: PreparedBatch, c, qdiag, lb, ub,
              obj_const=None, x0=None, y0=None, consensus=None,
              eps=None, iters_cap=None) -> SolveResult:
        """Solve the batch.  c/qdiag/lb/ub are UNSCALED user-space
        (S, N) tensors; x0/y0 optional warm starts in user space; `eps`
        overrides the construction-time tolerance for this call."""
        S, N = c.shape
        M = prep.A.shape[1]
        if obj_const is None:
            obj_const = torch.zeros((S,), dtype=c.dtype, device=c.device)
        if x0 is None:
            x0 = torch.zeros((S, N), dtype=c.dtype, device=c.device)
        if y0 is None:
            y0 = torch.zeros((S, M), dtype=c.dtype, device=c.device)
        return self._solve_impl(prep, c, qdiag, lb, ub, obj_const, x0, y0,
                                consensus, eps, iters_cap)

    def solve_compacted(self, *args, **kwargs):
        raise not_ported("solve_compacted", 3)

    # -- impl --------------------------------------------------------
    def _solve_impl(self, prep, c, qdiag, lb, ub, obj_const, x0, y0,
                    consensus=None, eps=None, iters_cap=None):
        if consensus is not None:
            raise not_ported("ConsensusSpec", 4)
        dc, dr = prep.d_col, prep.d_row
        # scale into solver space, in the caller's precision
        cs = c * dc
        qs = qdiag * dc * dc
        lbs = torch.where(torch.isfinite(lb), lb / dc, lb)
        ubs = torch.where(torch.isfinite(ub), ub / dc, ub)
        xq = x0 / dc
        xs0 = _proj_box(torch.where(torch.isfinite(xq), xq, 0.0), lbs, ubs)
        ys0 = y0 / dr
        A, rlo, rhi = prep.A, prep.row_lo, prep.row_hi
        # mixed precision: the loop runs in the hot compute dtype; the
        # final verdict and the SolveResult are in the caller's dtype
        # (the *_f views)
        out_dt = cs.dtype
        hot = self._hot_pair(out_dt)
        cs_f, qs_f, lbs_f, ubs_f = cs, qs, lbs, ubs
        A_f, rlo_f, rhi_f = A, rlo, rhi
        if hot is not None:
            store, compute = hot
            cs, qs = cs.to(compute), qs.to(compute)
            lbs, ubs = lbs.to(compute), ubs.to(compute)
            xs0, ys0 = xs0.to(compute), ys0.to(compute)
            rlo, rhi = rlo.to(compute), rhi.to(compute)
            A = A.to(store)
        S = cs.shape[0]
        # clamp the tolerance to what the loop dtype can express; a
        # comparison of a tensor with a Python float rounds the float
        # to the tensor's dtype, as the JAX code's astype does
        floor = eps_floor(cs.dtype)
        if eps is None:
            eps = max(self.eps, floor)
            eps_out = eps
        else:
            eps_out = max(round_to_dtype(eps, out_dt), floor)
            eps = round_to_dtype(eps_out, cs.dtype)

        anorm = prep.anorm.to(cs.dtype)
        qmax = torch.amax(qs, dim=1)
        # the chunk kernel takes contiguous per-scenario tensors
        A = A.contiguous()
        kin = [t.contiguous() for t in (cs, qs, lbs, ubs, rlo, rhi)]
        # the KKT checks read A in the loop's compute dtype, cast up once
        # per solve when it is stored lower (jnp.einsum promotes bf16 x
        # f32 operands to f32 in the JAX package)
        A_kkt = A if A.dtype == cs.dtype else A.to(cs.dtype)

        def steps(x, y, omega, n):
            """n PDHG iterations in one kernel launch: final iterates +
            running sums."""
            sigma = 0.9 * omega / anorm
            tau = 0.9 / (omega * anorm + 0.9 * qmax)
            return fused_chunk(A, *kin, x.contiguous(), y.contiguous(),
                               tau.contiguous(), sigma.contiguous(), n)

        def kkt_score(x, y, data=None):
            if data is None:
                data = (cs, qs, A_kkt, rlo, rhi, lbs, ubs)
            pres, dres, gap, _, _ = _residuals(x, y, *data)
            return pres + dres + gap, pres, dres, gap

        ne = self.check_every
        n_outer = self.max_iters // ne
        cap_outer = n_outer if iters_cap is None else min(
            n_outer, (int(iters_cap) + ne - 1) // ne)

        dev = cs.device
        score0 = kkt_score(xs0, ys0)[0]
        x, y = xs0, ys0
        x_sum, y_sum = torch.zeros_like(xs0), torch.zeros_like(ys0)
        nsum = torch.zeros((S,), dtype=cs.dtype, device=dev)
        x_last, y_last = xs0, ys0
        omega = torch.full((S,), self.omega0, dtype=cs.dtype, device=dev)
        converged = torch.zeros((S,), dtype=torch.bool, device=dev)
        x_best, y_best = xs0, ys0
        cycle = torch.zeros((S,), dtype=torch.int32, device=dev)
        score_restart = score0
        score_cand_prev = torch.full((S,), float("inf"), dtype=cs.dtype,
                                     device=dev)
        restarts = torch.zeros((S,), dtype=torch.int32, device=dev)
        k = 0
        # one host sync per KKT check (the JAX while_loop's cond)
        while k < cap_outer and not bool(torch.all(converged)):
            xn, yn, xs, ys = steps(x, y, omega, ne)
            x_sum = x_sum + xs
            y_sum = y_sum + ys
            nsum = nsum + ne
            score_cur, pres, dres, gap = kkt_score(xn, yn)
            newly = (pres < eps) & (dres < eps) & (gap < eps)
            conv = converged | newly
            fresh = (newly & ~converged)[:, None]
            x_best = torch.where(fresh, xn, x_best)
            y_best = torch.where(fresh, yn, y_best)
            k += 1
            cycle = cycle + 1

            # restart candidate: the better of {current, cycle average}
            xa = x_sum / nsum[:, None]
            ya = y_sum / nsum[:, None]
            score_avg = kkt_score(xa, ya)[0]
            take_avg = (score_avg < score_cur)[:, None]
            xr = torch.where(take_avg, xa, xn)
            yr = torch.where(take_avg, ya, yn)
            score_cand = torch.minimum(score_avg, score_cur)

            if self.restart_mode == "adaptive":
                suff = score_cand <= (self.restart_beta_sufficient
                                      * score_restart)
                nec = ((score_cand
                        <= self.restart_beta_necessary * score_restart)
                       & (score_cand > score_cand_prev))
                do_restart = suff | nec | (cycle >= self.restart_every)
            else:
                do_restart = cycle >= self.restart_every
            do_restart = do_restart & ~conv

            # primal weight update (PDLP-style smoothing)
            dx = torch.linalg.vector_norm(xr - x_last, dim=1)
            dy = torch.linalg.vector_norm(yr - y_last, dim=1)
            ok = (dx > 1e-12) & (dy > 1e-12)
            ratio = torch.where(ok, dy / torch.clamp(dx, min=1e-12), 1.0)
            om_new = torch.where(
                ok, torch.exp(0.5 * torch.log(ratio)
                              + 0.5 * torch.log(omega)), omega)
            om_new = torch.clamp(om_new, 1e-4, 1e4)

            m = do_restart
            m2 = m[:, None]
            xr_ = torch.where(m2, xr, xn)
            yr_ = torch.where(m2, yr, yn)
            # freeze scenarios converged before this check
            cm = converged[:, None]
            x = torch.where(cm, x, xr_)
            y = torch.where(cm, y, yr_)
            x_sum = torch.where(m2, 0.0, x_sum)
            y_sum = torch.where(m2, 0.0, y_sum)
            nsum = torch.where(m, 0.0, nsum)
            x_last = torch.where(m2, xr, x_last)
            y_last = torch.where(m2, yr, y_last)
            omega = torch.where(m, om_new, omega)
            converged = conv
            cycle = torch.where(m, 0, cycle)
            score_restart = torch.where(m, score_cand, score_restart)
            # +inf at a restart so stagnation cannot fire on the new
            # cycle's first check
            score_cand_prev = torch.where(m, float("inf"), score_cand)
            restarts = restarts + m.to(torch.int32)

        cm = converged[:, None]
        x = torch.where(cm, x_best, x)
        y = torch.where(cm, y_best, y)
        if hot is not None:
            # final verdict in the caller's dtype: frozen scenarios keep
            # their hot-precision certificate, the recheck can only add
            x = x.to(out_dt)
            y = y.to(out_dt)
        # (a hot prep may be stored below the caller's precision: the
        # verdict promotes it, as jnp's type promotion does)
        _, pres, dres, gap = kkt_score(
            x, y, data=(cs_f, qs_f, A_f.to(out_dt), rlo_f.to(out_dt),
                        rhi_f.to(out_dt), lbs_f, ubs_f))
        # unscale
        xu = x * dc
        yu = y * dr
        pobj = (torch.sum(c * xu, dim=1)
                + 0.5 * torch.sum(qdiag * xu * xu, dim=1) + obj_const)
        rlo_u = torch.where(torch.isfinite(prep.row_lo),
                            prep.row_lo / dr, prep.row_lo)
        rhi_u = torch.where(torch.isfinite(prep.row_hi),
                            prep.row_hi / dr, prep.row_hi)
        dobj = _residuals(xu, yu, c, qdiag,
                          _unscale_A(prep.A, dr, dc).to(out_dt),
                          rlo_u, rhi_u, lb, ub)[4]
        return SolveResult(
            x=xu, y=yu, obj=pobj, dual_obj=dobj + obj_const,
            pres=pres, dres=dres, gap=gap,
            converged=converged | ((pres < eps_out) & (dres < eps_out)
                                   & (gap < eps_out)),
            iters=k * ne, restarts=restarts)


def round_to_dtype(v, dtype):
    """The Python float `v` rounded to `dtype`: the JAX package keeps
    tolerances as scalars of the batch dtype (jnp.asarray(v, dtype))."""
    return float(torch.tensor(float(v), dtype=dtype))
