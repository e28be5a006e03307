"""PrimalDualConverger (port of
`mpisppy_tpu/convergers/primal_dual_converger.py`).

Tracks ||primal residual|| + ||dual residual|| where
    primal = sum_s p_s ||x_s - xbar||_1
    dual   = sum_s p_s ||rho*(xbar - xbar_prev)||_1
and converges below options["primal_dual_converger_options"]["tol"]
(default 1e-4).  Optionally appends the history to a CSV
("tracking_csv").  Computed on host copies.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from .. import global_toc
from ..device import host
from .converger import Converger


class PrimalDualConverger(Converger):
    def __init__(self, opt):
        super().__init__(opt)
        o = opt.options.get("primal_dual_converger_options") or {}
        self.tol = float(o.get("tol", 1e-4))
        self.csv_path = o.get("tracking_csv")
        self._xbar_prev = None
        self.history = []

    def is_converged(self):
        st = self.opt.state
        if st is None:
            return False
        b = self.opt.batch
        x_na = host(b.nonants(st.x))
        xbar = host(st.xbar)
        p = host(b.prob)[:, None]
        prim = float(np.sum(p * np.abs(x_na - xbar)))
        if self._xbar_prev is None:
            dual = float("inf")
        else:
            rho = host(self.opt.rho)
            dual = float(np.sum(p * np.abs(rho * (xbar - self._xbar_prev))))
        self._xbar_prev = xbar
        val = prim + dual
        self.convergence_value = val
        self.history.append((int(st.it), prim, dual))
        if self.csv_path:
            new = not os.path.exists(self.csv_path)
            with open(self.csv_path, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(["iteration", "primal", "dual"])
                w.writerow([int(st.it), prim, dual])
        if val < self.tol:
            global_toc(f"PrimalDualConverger: {prim:.3e}+{dual:.3e} "
                       f"< {self.tol}")
            return True
        return False
