"""FWPH — Frank-Wolfe Progressive Hedging (port of
`mpisppy_tpu/fwph/fwph.py`; Boland et al. 2018).

Per scenario a column bank of T hull vertices (a fixed-capacity
(S, T, N) array with an active mask; when full, the column of smallest
hull weight is overwritten) approximates the convex hull, and an inner
simplicial-decomposition loop alternates a vertex solve (the batched
PDHG LP with a linearized objective) with a hull QP.

The hull QP  min_{lam in simplex} f_s(V lam) + W.(V lam)_na
+ rho/2 ||(V lam)_na - xbar||^2  is solved in lifted (x, lam) space:
rows x - V lam = 0 and one simplex row, a diagonal prox on x.  It is
one batched (S, N+1, N+T) solve with its own prep, rebuilt each call
as in the JAX package; the bank bookkeeping (insertion, eviction, the
hull weights) stays on the host in numpy, exact.

The first vertex solve of each outer pass uses the pure Lagrangian
objective c + W, so its dual objective is the Lagrangian dual bound.

FWPH(options, ...).fwph_main() -> (conv, Eobj, dual_bound).  Options:
FW_iter_limit (default 2), FW_eps (default 1e-6), column_bank (T,
default 16), plus the PH options.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import global_toc
from ..device import host
from ..ops.pdhg import PDHGSolver, prepare_batch
from ..phbase import PHBase, compute_xbar, convergence_metric, update_W


class FWPH(PHBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        o = self.options
        self.fw_iter_limit = int(o.get("FW_iter_limit", 2))
        self.fw_eps = float(o.get("FW_eps", 1e-6))
        self.T = int(o.get("column_bank", 16))
        b = self.batch
        S, N = b.num_scens, b.num_vars
        self._V = np.zeros((S, self.T, N))
        self._active = np.zeros((S, self.T), bool)
        self._lam = np.zeros((S, self.T))
        self._qp_solver = PDHGSolver(
            max_iters=int(o.get("pdhg_max_iters", 20000)),
            eps=float(o.get("pdhg_eps", 1e-6)))
        self.dual_bound = None         # best (max for min-problems) so far
        self._dual_bounds = []         # one per outer pass
        self.sdm_early_stops = 0       # SDM passes ended by the Gamma test
        # the Gamma test is a Frank-Wolfe certificate for linear models
        self._qdiag_zero = not bool(torch.any(b.qdiag != 0))

    # -- column management -------------------------------------------------
    def _add_columns(self, x_new):
        """Insert one (S, N) vertex per scenario: into the first free
        slot, else over the column of least hull weight."""
        x_new = np.asarray(x_new)
        S = x_new.shape[0]
        free = ~self._active
        t = np.where(free.any(axis=1), np.argmax(free, axis=1),
                     np.argmin(self._lam, axis=1))
        rows = np.arange(S)
        self._V[rows, t] = x_new
        self._active[rows, t] = True
        self._lam[rows, t] = 0.0   # weight assigned by the next hull QP

    # -- hull QP in lifted (x, lam) space -----------------------------------
    def _hull_qp(self, W, xbar):
        """min c.x + W.x_na + rho/2||x_na - xbar||^2
        s.t. x = V lam, sum lam = 1, lam >= 0 (active columns only).
        Returns (x (S, N) numpy, lam (S, T) numpy)."""
        N = self.batch.num_vars
        A, row_lo, row_hi, c, q, lb, ub = hull_qp_arrays(
            self.batch, self._V, self._active, W, xbar, self.rho)
        prep = prepare_batch(A, row_lo, row_hi)
        res = self._qp_solver.solve(prep, c, q, lb, ub)
        x = host(res.x).astype(np.float64)
        return x[:, :N].copy(), x[:, N:].copy()

    # -- lifecycle pieces (spoke-steppable) ---------------------------------
    def fw_prep(self):
        """Iter0 and the column banks seeded with the wait-and-see
        vertices."""
        self.Iter0()
        self._add_columns(host(self.state.x))
        self._prepped = True

    def fwph_iteration(self):
        """One outer FWPH pass: the SDM inner loop, then the PH updates
        from the hull point.  Returns the convergence metric."""
        b = self.batch
        na = b.nonant_idx
        dt, dev = b.c.dtype, self.device
        st = self.state
        W, xbar = st.W, st.xbar
        x_qp = host(st.x).astype(np.float64)

        for t in range(self.fw_iter_limit):
            c_eff = b.c.clone()
            if t == 0:
                # the pure Lagrangian objective: a valid dual bound
                c_eff[:, na] += W
                res = self.solver.solve(
                    self.prep, c_eff, b.qdiag, self.lb_eff,
                    self.ub_eff, obj_const=b.obj_const,
                    x0=st.x, y0=st.y)
                self.check_W_bound_supported()
                db = float(self.valid_Ebound(res))
                self._dual_bounds.append(db)
                if self.dual_bound is None or db > self.dual_bound:
                    self.dual_bound = db
            else:
                # linearize the prox QP at the current hull point
                x_t = torch.as_tensor(x_qp, dtype=dt, device=dev)
                c_eff[:, na] += W + self.rho * (b.nonants(x_t) - xbar)
                res = self.solver.solve(
                    self.prep, c_eff, b.qdiag, self.lb_eff,
                    self.ub_eff, obj_const=b.obj_const)
                # SDM Gamma test: the Frank-Wolfe gap
                # c_lin.(x_hull - x_vertex) bounds the hull QP's
                # remaining improvement; valid for linear subproblems
                if self._qdiag_zero:
                    gap_s = np.einsum("sn,sn->s", host(c_eff),
                                      x_qp - host(res.x))
                    fw_gap = float(host(b.prob) @ gap_s)
                    scale = 1.0 + abs(float(self.Eobjective(
                        b.objective(x_t))))
                    if fw_gap <= self.fw_eps * scale:
                        self.sdm_early_stops += 1
                        break
            self._add_columns(host(res.x))
            x_qp, lam = self._hull_qp(W, xbar)
            self._lam = lam

        # PH updates from the hull point
        x_t = torch.as_tensor(x_qp, dtype=dt, device=dev)
        x_na = b.nonants(x_t)
        xbar, xsqbar = compute_xbar(b, x_na)
        W = update_W(W, self.rho, x_na, xbar)
        conv = float(convergence_metric(b, x_na, xbar))
        self.state = self.state.__class__(
            x=x_t, y=st.y, W=W, xbar=xbar, xsqbar=xsqbar,
            obj=b.objective(x_t), dual_obj=st.dual_obj,
            conv=torch.tensor(conv, device=dev), it=st.it + 1)
        self.conv = conv
        return conv

    # -- main loop (reference fwph.py:142-208) ------------------------------
    def fwph_main(self, finalize=True):
        if not getattr(self, "_prepped", False):
            self.fw_prep()
        max_iters = int(self.options.get("PHIterLimit", 50))
        convthresh = float(self.options.get("convthresh", 1e-4))
        conv = float("inf")
        for k in range(1, max_iters + 1):
            conv = self.fwph_iteration()
            self._ext("miditer")
            if k % 5 == 0 or k == 1:
                global_toc(f"FWPH iter {k:3d} conv={conv:.4e} "
                           f"dual_bound={self.dual_bound:.6g}")
            self._ext("enditer")
            if self.spcomm is not None:
                self.spcomm.sync()
                if self.spcomm.is_converged():
                    break
            if conv < convthresh:
                global_toc(f"FWPH converged at iter {k}")
                break
        self._ext("post_everything")
        if finalize:
            eobj = float(self.Eobjective(self.state.obj))
            return conv, eobj, self.dual_bound
        return conv, None, self.dual_bound


def hull_qp_arrays(b, V, active, W, xbar, rho):
    """The lifted hull QP of batch `b` over a column bank (V (S, T, N),
    active (S, T), host arrays), as tensors on b's device in b's dtype:
    (A (S, N+1, N+T), row_lo, row_hi, c, qdiag, lb, ub) over the
    variables [x (N) | lam (T)], with rows x - V lam = 0 and
    sum(active lam) = 1."""
    S, N = b.num_scens, b.num_vars
    T = V.shape[1]
    na = b.nonant_idx
    dt, dev = b.c.dtype, b.c.device
    Vt = torch.as_tensor(V, dtype=dt, device=dev)
    act = torch.as_tensor(active, device=dev).to(dt)
    A = torch.zeros((S, N + 1, N + T), dtype=dt, device=dev)
    A[:, :N, :N] = torch.eye(N, dtype=dt, device=dev)
    A[:, :N, N:] = -Vt.transpose(1, 2)
    A[:, N, N:] = act
    row_lo = torch.zeros((S, N + 1), dtype=dt, device=dev)
    row_lo[:, N] = 1.0
    lb = torch.zeros((S, N + T), dtype=dt, device=dev)
    ub = torch.zeros((S, N + T), dtype=dt, device=dev)
    lb[:, :N] = b.lb
    ub[:, :N] = b.ub
    ub[:, N:] = act
    c = torch.zeros((S, N + T), dtype=dt, device=dev)
    c[:, :N] = b.c
    c[:, na] += W - rho * xbar
    q = torch.zeros((S, N + T), dtype=dt, device=dev)
    q[:, na] = rho
    return A, row_lo, row_lo.clone(), c, q, lb, ub
