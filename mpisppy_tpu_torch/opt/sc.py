"""SchurComplement — a structured interior-point solve of the two-stage
EF (port of `mpisppy_tpu/opt/sc.py`).

A primal-dual log-barrier IPM on the consensus EF.  Per scenario s the
barrier Newton step reduces to an N x N SPD system
M_s = H_mu,s + A_s^T D_s A_s; with the columns split into the shared
first-stage block x (the nonant slots) and the recourse block y_s,

    [ Mxx_s  Mxy_s ] [dx ]   [ rx_s ]
    [ Myx_s  Myy_s ] [dy_s] = [ ry_s ]

every scenario's Myy is Cholesky-factored in one batched call
(`torch.linalg.cholesky_ex`, whose `info` is kept on the device and
checked after the loop: a factorization that fails raises instead of
leaving NaNs), and the K x K Schur
complement C = sum_s (Mxx_s - Mxy_s Myy_s^{-1} Myx_s) is a sum over
the scenario axis.  One K x K solve gives dx; batched back-substitution
gives every dy_s.

The JAX package does this in XLA, not in a Pallas kernel; here it is
torch.linalg on the batch's device.  The IPM always runs in float64
(a barrier method in float32 stalls far above the tolerance).  The
loop makes no host sync, so its iterations queue on the card.  The
iteration count is `sc_max_iter` (default 100, the JAX package's):
farmer S=100, cm=10 needs ~3,000 to come within 1e-6 of its optimum
in both packages.
Continuous problems only: an integer batch raises, as in the
reference.  Infinite bounds are replaced by +-1e8 (no barrier there in
effect); equality rows open to a 2e-7 box, which keeps M SPD.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import global_toc
from ..device import host
from ..spbase import SPBase

BIG = 1e8


class SchurComplement(SPBase):
    _needs_dense_A = True   # the KKT assembly indexes A by scenario

    def __init__(self, options, all_scenario_names, **kwargs):
        super().__init__(options, all_scenario_names, **kwargs)
        if bool(torch.any(self.batch.integer_mask)):
            raise RuntimeError(
                "SchurComplement handles continuous problems only "
                "(so does the reference, opt/sc.py:18-21)")
        o = self.options
        self.max_iter = int(o.get("sc_max_iter", 100))
        self.tol = float(o.get("sc_tol", 1e-7))
        self.mu0 = float(o.get("sc_mu0", 10.0))
        self.first_stage_solution = None
        self.objective = None

    def _arrays(self):
        b = self.batch
        f64 = torch.float64

        def fin(t, big):
            t = t.to(f64)
            return torch.where(torch.isfinite(t), t, big)

        lb, ub = fin(b.lb, -BIG), fin(b.ub, BIG)
        rlo, rhi = fin(b.row_lo, -BIG), fin(b.row_hi, BIG)
        eq = rhi - rlo < 1e-12
        rlo = torch.where(eq, rlo - 1e-7, rlo)
        rhi = torch.where(eq, rhi + 1e-7, rhi)
        p = b.prob.to(f64)[:, None]
        return b.c.to(f64) * p, b.qdiag.to(f64) * p, lb, ub, rlo, rhi

    def _ipm(self, c, q, lb, ub, rlo, rhi):
        b = self.batch
        S, N = c.shape
        K = b.num_nonants
        dev, f64 = c.device, torch.float64
        na_np = host(b.nonant_idx)
        na = torch.as_tensor(na_np, device=dev)
        rest = torch.as_tensor(np.setdiff1d(np.arange(N), na_np),
                               device=dev)
        A = b.A.to(f64)
        prob_mask = (b.tree.prob > 0)[:, None]
        eyeN = torch.eye(N, dtype=f64, device=dev)
        diag = torch.arange(N, device=dev)

        def clip(v, lo, hi):
            return torch.minimum(torch.maximum(v, lo), hi)

        # strictly interior start; the coupling Az = s is an equality of
        # the Newton system, so s need not start consistent
        z = clip(torch.zeros((S, N), dtype=f64, device=dev),
                 lb + 1e-1, ub - 1e-1)
        zx = torch.mean(z[:, na], dim=0)
        z[:, na] = zx[None, :].expand(S, K)
        s = clip(torch.einsum("smn,sn->sm", A, z), rlo + 1e-1, rhi - 1e-1)
        mu = torch.tensor(self.mu0, dtype=f64, device=dev)
        failed = torch.zeros((S,), dtype=torch.int32, device=dev)
        schur_failed = torch.zeros((), dtype=torch.bool, device=dev)

        def barrier_grad_hess(v, lo, hi, mu):
            g = -mu / (v - lo) + mu / (hi - v)
            h = mu / (v - lo) ** 2 + mu / (hi - v) ** 2
            return g, h

        def chol_solve(L, B):
            w = torch.linalg.solve_triangular(L, B, upper=False)
            return torch.linalg.solve_triangular(L.transpose(-1, -2), w,
                                                 upper=True)

        def max_step(v, dv, lo, hi):
            inf = torch.tensor(float("inf"), dtype=f64, device=dev)
            t_lo = torch.where(dv < 0, (lo - v) / dv, inf)
            t_hi = torch.where(dv > 0, (hi - v) / dv, inf)
            return torch.minimum(torch.min(t_lo), torch.min(t_hi))

        for _ in range(self.max_iter):
            gz, hz = barrier_grad_hess(z, lb, ub, mu)
            gs, hs = barrier_grad_hess(s, rlo, rhi, mu)
            # Newton-KKT of  min c.z + q/2 z^2 + B(z) + B(s)  s.t. Az = s:
            #   (Hz + A^T Hs A) dz = -(gz + A^T(gs + Hs r_eq)),
            #   ds = A dz + r_eq
            r_eq = torch.einsum("smn,sn->sm", A, z) - s
            grad = (c + q * z + gz
                    + torch.einsum("smn,sm->sn", A, gs + hs * r_eq))
            M = (A * hs[:, :, None]).transpose(1, 2) @ A
            M = M + eyeN[None] * 1e-10
            M[:, diag, diag] += q + hz
            # padding scenarios: the identity keeps Cholesky happy
            M = torch.where(prob_mask[:, :, None], M, eyeN[None])
            grad = torch.where(prob_mask, grad, 0.0)

            Mna = M[:, na]
            Mxx = Mna[:, :, na]                       # (S, K, K)
            Mxy = Mna[:, :, rest]                     # (S, K, N-K)
            Myy = M[:, rest][:, :, rest]              # (S, n2, n2)
            rx = -grad[:, na]
            ry = -grad[:, rest]

            L, info = torch.linalg.cholesky_ex(Myy)
            # a failed factorization is recorded on the device and
            # raised after the loop (no host sync per iteration)
            failed = torch.where(info != 0, info, failed)
            Yinv_yx = chol_solve(L, Mxy.transpose(1, 2))
            Yinv_ry = chol_solve(L, ry[:, :, None])[..., 0]
            # the Schur pieces summed over the live scenarios (padding
            # scenarios' unit boxes must not constrain the shared step)
            pmask3 = prob_mask[:, :, None]
            C = torch.sum(torch.where(pmask3, Mxx - Mxy @ Yinv_yx, 0.0),
                          dim=0)
            rhs = torch.sum(torch.where(
                prob_mask, rx - torch.einsum("skn,sn->sk", Mxy, Yinv_ry),
                0.0), dim=0)
            dx, info_c = torch.linalg.solve_ex(
                C + torch.eye(K, dtype=f64, device=dev) * 1e-12, rhs)
            schur_failed = schur_failed | (info_c != 0)
            dy = Yinv_ry - torch.einsum("snk,k->sn", Yinv_yx, dx)
            dz = torch.zeros_like(z)
            dz[:, na] = dx[None].expand(S, K)
            dz[:, rest] = dy
            dz = torch.where(prob_mask, dz, 0.0)
            ds = torch.einsum("smn,sn->sm", A, dz) + torch.where(
                prob_mask, r_eq, 0.0)

            # fraction-to-boundary step
            alpha = torch.clamp(0.995 * torch.minimum(
                max_step(z, dz, lb, ub), max_step(s, ds, rlo, rhi)),
                max=1.0)
            z = z + alpha * dz
            s = s + alpha * ds
            # strictly interior: compounding 0.995 steps can round an
            # iterate onto its bound, and 1/(z - lb) would be inf
            z = clip(z, lb + 1e-12 * (1 + torch.abs(lb)),
                     ub - 1e-12 * (1 + torch.abs(ub)))
            s = clip(s, rlo + 1e-12 * (1 + torch.abs(rlo)),
                     rhi - 1e-12 * (1 + torch.abs(rhi)))
            # shrink mu fast once the coupling is restored, slowly
            # while it is not
            feas = torch.max(torch.abs(torch.where(prob_mask, r_eq, 0.0)))
            mu = torch.clamp(mu * torch.where(feas < 1e-4, 0.5, 0.95),
                             min=1e-10)

        if bool(schur_failed):
            raise RuntimeError("SchurComplement: the K x K Schur "
                               "complement solve failed")
        if bool(torch.any(failed != 0)):
            bad = int(torch.nonzero(failed).flatten()[0])
            raise RuntimeError(
                f"SchurComplement: the Cholesky factorization of "
                f"scenario {bad}'s recourse block failed "
                f"(info={int(failed[bad])})")

        obj = torch.sum(torch.sum(c * z + 0.5 * q * z * z, dim=1)
                        + b.obj_const.to(f64) * b.tree.prob.to(f64))
        return z, obj

    def solve(self):
        """Reference API: SchurComplement.solve (opt/sc.py:89)."""
        z, obj = self._ipm(*self._arrays())
        self.objective = float(obj)
        self.first_stage_solution = host(z[0, self.batch.nonant_idx])
        global_toc(f"SchurComplement IPM: obj = {self.objective:.6g}")
        return self.objective, self.first_stage_solution
