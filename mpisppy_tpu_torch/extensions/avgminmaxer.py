"""MinMaxAvg — print avg/min/max of a per-scenario quantity each
iteration (port of `mpisppy_tpu/extensions/avgminmaxer.py`).

options["avgminmax_name"] selects what to track: "objective" (default),
"conv" (per-scenario nonant deviation), or a nonant slot index.
"""

from __future__ import annotations

import numpy as np

from .. import global_toc
from ..device import host
from .extension import Extension


class MinMaxAvg(Extension):
    def __init__(self, ph):
        super().__init__(ph)
        self.compstr = ph.options.get("avgminmax_name", "objective")

    def _values(self):
        st = self.opt.state
        b = self.opt.batch
        if self.compstr == "objective":
            return host(st.obj)
        if self.compstr == "conv":
            x_na = host(b.nonants(st.x))
            return np.abs(x_na - host(st.xbar)).sum(axis=1)
        k = int(self.compstr)
        return host(b.nonants(st.x))[:, k]

    def _report(self, when):
        if self.opt.state is None:
            return
        avg, lo, hi = self.opt.avg_min_max(self._values())
        global_toc(f"MinMaxAvg[{self.compstr}] {when}: "
                   f"avg {avg:.6g}  min {lo:.6g}  max {hi:.6g}")

    def post_iter0(self):
        self._report("iter0")

    def enditer(self):
        self._report(f"iter {int(self.opt.state.it)}")
