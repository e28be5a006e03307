"""NormRhoConverger (port of
`mpisppy_tpu/convergers/norm_rho_converger.py`).

Converged when the rho-weighted primal residual
    sum_s p_s || rho * (x_s - xbar) ||_1 / K
drops below options["norm_rho_converger_tol"] (default 1e-4): the dual
step PH is about to take.  Computed on host copies.
"""

from __future__ import annotations

import numpy as np

from .. import global_toc
from ..device import host
from .converger import Converger


class NormRhoConverger(Converger):
    def __init__(self, opt):
        super().__init__(opt)
        self.tol = float(opt.options.get("norm_rho_converger_tol", 1e-4))

    def is_converged(self):
        st = self.opt.state
        if st is None:
            return False
        b = self.opt.batch
        x_na = host(b.nonants(st.x))
        xbar = host(st.xbar)
        rho = host(self.opt.rho)
        p = host(b.prob)[:, None]
        val = float(np.sum(p * np.abs(rho * (x_na - xbar)))
                    / max(x_na.shape[1], 1))
        self.convergence_value = val
        if val < self.tol:
            global_toc(f"NormRhoConverger: {val:.3e} < {self.tol}")
            return True
        return False
