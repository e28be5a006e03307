"""APH — Asynchronous Projective Hedging (port of
`mpisppy_tpu/opt/aph.py`; Eckstein/Watson/Woodruff projective
splitting).

Each iteration solves every scenario in one batched PDHG call, then
keeps the new (x, y) only for the `dispatch_frac` least-recently
dispatched scenarios; the rest contribute their stale values to the
averages, the asynchronous trajectory of the reference.  Skipping the
undispatched solves would change the cost, not the result, and the
JAX package does not skip them either.

Per iteration:
    solve:  x_s  <- argmin f_s(x) + W_s.x_na + rho/2 ||x_na - z_s||^2
    y_s   = W_s + rho (x_na - z)          (dispatched scenarios)
    xbar  = node-avg x_na ; ybar = node-avg y
    u_s   = x_na - xbar ;  v = ybar
    tau   = E_s[ ||u_s||^2 + ||v_s||^2 / gamma ]
    phi   = E_s[ (z - x_na).(W - y) ]
    theta = nu * phi / tau  if phi>0, tau>0 else 0
    W    += theta * u ;  z += theta * ybar / gamma
    conv  = ||u||/||W|| + ||v||/||z||

The first APH iteration starts from Iter0 with z := xbar, y := 0.
Options: APHgamma (default 1), APHnu (default 1), dispatch_frac
(default 1.0, synchronous), plus the PH options.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from .. import global_toc
from ..ir import node_segment_sum
from ..phbase import PHBase, compute_xbar


@dataclasses.dataclass(frozen=True)
class APHState:
    x: Any             # (S, N) last primal solutions (possibly stale)
    y: Any             # (S, M) row duals of the last dispatched solve
    y_na: Any          # (S, K) APH subgradients on the nonants
    W: Any             # (S, K)
    z: Any             # (S, K) consensus point (node-consistent)
    xbar: Any          # (S, K)
    xsqbar: Any        # (S, K)
    ybar: Any          # (S, K)
    obj: Any           # (S,)
    dual_obj: Any      # (S,)
    conv: Any          # ()
    theta: Any         # ()
    phi: Any           # ()
    tau: Any           # ()
    it: int
    last_dispatch: Any  # (S,) int32: the iteration each scenario last solved


def node_average(batch, v):
    """Node-conditional probability-weighted average of a (S, K)
    array."""
    tree = batch.tree
    p = tree.prob[:, None].to(v.dtype)
    _, segsum = node_segment_sum(tree.node_of, tree.num_nodes)
    wsum = torch.clamp(segsum(p.expand(v.shape)), min=1e-30)
    return segsum(p * v) / wsum


class APH(PHBase):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        o = self.options
        self.APHgamma = float(o.get("APHgamma", 1.0))
        self.APHnu = float(o.get("APHnu", 1.0))
        frac = float(o.get("dispatch_frac", 1.0))
        S = self.batch.num_scens
        self.n_dispatch = max(1, min(S, int(math.ceil(frac * S))))
        self.aph_state: APHState | None = None

    # -- one APH iteration ---------------------------------------------------
    def _aph_superstep(self, st: APHState, rho, lb, ub, eps):
        b = self.batch
        S = b.num_scens
        na = b.nonant_idx
        dev = self.device

        # dispatch: the n least-recently-dispatched scenarios; the
        # index breaks ties, so the key is unique and the rotation
        # deterministic
        key = st.last_dispatch * S + torch.arange(S, dtype=torch.int32,
                                                  device=dev)
        idx = torch.topk(-key, self.n_dispatch).indices
        mask = torch.zeros((S,), dtype=torch.bool, device=dev)
        mask[idx] = True

        # W.x + rho/2 ||x - z||^2: the prox is against z, not xbar
        c_eff = b.c.clone()
        c_eff[:, na] += st.W - rho * st.z
        q_eff = b.qdiag.clone()
        q_eff[:, na] += rho.expand(st.W.shape)
        res = self.solver._solve_impl(
            self.prep, c_eff, q_eff, lb, ub, b.obj_const, st.x, st.y,
            None, eps)

        m2 = mask[:, None]
        x = torch.where(m2, res.x, st.x)
        y_rows = torch.where(m2, res.y, st.y)
        x_na = b.nonants(x)
        y_na = torch.where(m2, st.W + rho * (x_na - st.z), st.y_na)

        xbar, xsqbar = compute_xbar(b, x_na)
        ybar = node_average(b, y_na)

        p = b.tree.prob
        u = x_na - xbar
        v = ybar
        pusq = torch.sum(p * torch.sum(u * u, dim=1))
        pvsq = torch.sum(p * torch.sum(v * v, dim=1))
        tau = pusq + pvsq / self.APHgamma
        phi = torch.sum(p * torch.sum((st.z - x_na) * (st.W - y_na), dim=1))
        theta = torch.where((tau > 0) & (phi > 0),
                            self.APHnu * phi / torch.clamp(tau, min=1e-30),
                            torch.zeros_like(tau))

        W = st.W + theta * u
        z = st.z + theta * ybar / self.APHgamma

        pwsq = torch.sum(p * torch.sum(W * W, dim=1))
        pzsq = torch.sum(p * torch.sum(z * z, dim=1))
        conv = (torch.sqrt(pusq) / torch.clamp(torch.sqrt(pwsq), min=1e-30)
                + torch.sqrt(pvsq) / torch.clamp(torch.sqrt(pzsq),
                                                 min=1e-30))
        it = st.it + 1
        return APHState(
            x=x, y=y_rows, y_na=y_na, W=W, z=z,
            xbar=xbar, xsqbar=xsqbar, ybar=ybar,
            obj=b.objective(x), dual_obj=res.dual_obj, conv=conv,
            theta=theta, phi=phi, tau=tau, it=it,
            last_dispatch=torch.where(mask, torch.full_like(
                st.last_dispatch, it), st.last_dispatch))

    # -- driver (reference APH_main, aph.py:820-922) ------------------------
    def APH_main(self, spcomm=None, finalize=True):
        if spcomm is not None:
            self.spcomm = spcomm
        self.Iter0()
        st0 = self.state
        b = self.batch
        dt = b.c.dtype
        S = b.num_scens

        def scalar(v):
            return torch.tensor(v, dtype=dt, device=self.device)

        # iteration-1 specials (reference aph.py:481-485): z := xbar,
        # y := 0; W carries Iter0's PH update
        self.aph_state = APHState(
            x=st0.x, y=st0.y, y_na=torch.zeros_like(st0.W), W=st0.W,
            z=st0.xbar, xbar=st0.xbar, xsqbar=st0.xsqbar,
            ybar=torch.zeros_like(st0.W), obj=st0.obj,
            dual_obj=st0.dual_obj, conv=scalar(float("inf")),
            theta=scalar(0.0), phi=scalar(0.0), tau=scalar(0.0), it=1,
            last_dispatch=torch.zeros((S,), dtype=torch.int32,
                                      device=self.device))

        max_iters = int(self.options.get("PHIterLimit", 100))
        convthresh = float(self.options.get("convthresh", 1e-4))
        for k in range(2, max_iters + 2):
            self.aph_state = self._aph_superstep(
                self.aph_state, self.rho, self.lb_eff, self.ub_eff,
                self.solver_eps)
            a = self.aph_state
            # mirrored into the PHState fields that spokes (the hub's
            # send_ws / send_nonants) and extensions read
            self.state = dataclasses.replace(
                self.state, x=a.x, y=a.y, W=a.W, xbar=a.xbar,
                xsqbar=a.xsqbar, obj=a.obj, dual_obj=a.dual_obj,
                conv=a.conv, it=a.it)
            self.conv = float(a.conv)
            self._ext("miditer")
            if k % 10 == 0 or k == 2:
                global_toc(f"APH iter {k:4d} conv={self.conv:.6e} "
                           f"theta={float(a.theta):.4g} "
                           f"phi={float(a.phi):.4g}")
            self._ext("enditer")
            if self.spcomm is not None:
                self.spcomm.sync()
                if self.spcomm.is_converged():
                    global_toc(f"APH terminated by hub at iter {k}")
                    break
            if self.conv < convthresh:
                global_toc(f"APH converged (conv={self.conv:.3e}) "
                           f"at iter {k}")
                break
            self._ext("enditer_after_sync")
        self._ext("post_everything")
        if finalize:
            eobj = self.post_loops()
            return self.conv, eobj, self.trivial_bound
        return self.conv, None, self.trivial_bound

    def aph_main(self, finalize=True):
        return self.APH_main(finalize=finalize)

    def root_z(self):
        """Root-node consensus point z (the APH candidate solution)."""
        return self.aph_state.z[0]
