"""FractionalConverger — fraction of integer nonants not yet agreed
(port of `mpisppy_tpu/convergers/fracintsnotconv.py`).

An integer slot agrees when every scenario's value is within
options["fracintsnotconv_tol"] (default 1e-4) of the slot's rounded
xbar.  Converged when the not-agreed fraction drops to
options["fracintsnotconv_thresh"] (default 0: all agree).  The test
runs on host copies of x's nonants and x̄.
"""

from __future__ import annotations

import numpy as np

from .. import global_toc
from ..device import host
from .converger import Converger


class FractionalConverger(Converger):
    def __init__(self, opt):
        super().__init__(opt)
        o = opt.options
        self.tol = float(o.get("fracintsnotconv_tol", 1e-4))
        self.thresh = float(o.get("fracintsnotconv_thresh", 0.0))
        b = opt.batch
        self._int_slot = host(b.integer_mask)[:, host(b.nonant_idx)]
        self._n_int = max(int(self._int_slot.any(axis=0).sum()), 1)

    def is_converged(self):
        st = self.opt.state
        if st is None:
            return False
        x_na = host(self.opt.batch.nonants(st.x))
        target = np.round(host(st.xbar))
        # a slot disagrees if any scenario's integer value strays
        bad = self._int_slot & (np.abs(x_na - target) > self.tol)
        frac = bad.any(axis=0).sum() / self._n_int
        self.convergence_value = float(frac)
        if frac <= self.thresh:
            global_toc(f"FractionalConverger: {frac:.3f} <= {self.thresh}")
            return True
        return False
