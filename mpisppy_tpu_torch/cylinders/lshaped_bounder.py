"""XhatLShapedInnerBound (port of
`mpisppy_tpu/cylinders/lshaped_bounder.py`): evaluates the L-shaped
hub's candidate x̂ (fixed nonants, one batched solve) and reports its
expected objective as an inner bound when it is feasible."""

from __future__ import annotations

import numpy as np

from .spoke import InnerBoundNonantSpoke


class XhatLShapedInnerBound(InnerBoundNonantSpoke):
    converger_spoke_char = "X"

    def step(self):
        nonants, is_new = self.fresh_nonants()
        if self._killed or not is_new:
            return False
        xhat = np.asarray(nonants)[0]   # the hub replicates x̂ per scenario
        eobj, feasible = self.opt.evaluate_xhat(xhat)
        if feasible:
            self.update_if_improving(eobj, solution=xhat)
        return True

    def finalize(self):
        return self.bound
