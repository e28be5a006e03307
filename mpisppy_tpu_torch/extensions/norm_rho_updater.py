"""NormRhoUpdater — adaptive rho from primal/dual residual norms (port
of `mpisppy_tpu/extensions/norm_rho_updater.py`).

Residual balancing on PH's consensus split, per nonant slot with
probability-weighted norms:
    primal residual  r = sum_s p_s |x_s - xbar|
    dual residual    d = mean_s(rho) * sum_s p_s |xbar - xbar_prev|
rho is multiplied by `step` where the primal residual dominates by
`ratio`, divided where the dual one does.  The test runs on host
copies (x's nonants, x̄ and rho, (S, K) each); the new rho goes back to
the optimizer's device in the batch dtype, and the next superstep
receives it.

Options under options["norm_rho_options"]:
    ratio (default 10.0), step (default 2.0), rho_update_stop_iter,
    verbose
"""

from __future__ import annotations

import numpy as np
import torch

from .. import global_toc
from ..device import host
from .extension import Extension


class NormRhoUpdater(Extension):
    def __init__(self, ph):
        super().__init__(ph)
        o = ph.options.get("norm_rho_options") or {}
        self.ratio = float(o.get("ratio", 10.0))
        self.step = float(o.get("step", 2.0))
        self.stop_iter = o.get("rho_update_stop_iter")
        self.verbose = bool(o.get("verbose", False))
        self._xbar_prev = None

    def miditer(self):
        st = self.opt.state
        if st is None:
            return
        it = int(st.it)
        if self.stop_iter is not None and it > int(self.stop_iter):
            return
        b = self.opt.batch
        xbar = host(st.xbar)
        if self._xbar_prev is None:
            self._xbar_prev = xbar
            return
        p = host(b.prob)[:, None]
        x_na = host(b.nonants(st.x))
        # per-slot prob-weighted residuals (K,)
        prim = np.sum(p * np.abs(x_na - xbar), axis=0)
        rho_np = host(self.opt.rho)
        dual = np.mean(rho_np, axis=0) * np.sum(
            p * np.abs(xbar - self._xbar_prev), axis=0)
        self._xbar_prev = xbar

        up = prim > self.ratio * dual
        dn = dual > self.ratio * prim
        if up.any() or dn.any():
            factor = np.where(up, self.step,
                              np.where(dn, 1.0 / self.step, 1.0))
            new_rho = rho_np * factor[None, :]
            self.opt.rho = torch.as_tensor(
                new_rho, device=self.opt.device).to(b.c.dtype)
            if self.verbose:
                global_toc(f"NormRhoUpdater iter {it}: "
                           f"{int(up.sum())} slots up, "
                           f"{int(dn.sum())} down; "
                           f"mean rho {float(new_rho.mean()):.4g}")
