"""Xhat sequential-looper inner-bound spoke (port of
`mpisppy_tpu/cylinders/xhatlooper_bounder.py`): like the shuffler but
walks the scenarios in their given order, `scen_limit` per pass."""

from __future__ import annotations

import numpy as np

from ..device import host
from ..utils.xhat_utils import (candidate_from_sources, full_source_map,
                                node_members, round_integer_nonants)
from .spoke import InnerBoundNonantSpoke


class XhatLooperInnerBound(InnerBoundNonantSpoke):
    converger_spoke_char = "X"

    def __init__(self, spbase_object, options=None):
        super().__init__(spbase_object, options=options)
        self.scen_limit = int(self.options.get("scen_limit", 3))
        self._next = 0
        self._node_of = host(self.opt.batch.tree.node_of)
        self._members = node_members(
            self._node_of[:self.opt.n_real_scens])

    def step(self):
        x_na, is_new = self.fresh_nonants()
        if self._killed or not is_new:
            return False
        x_na = np.asarray(x_na)
        n_real = self.opt.n_real_scens
        for _ in range(self.scen_limit):
            base = self._next % n_real
            self._next += 1
            srcs = full_source_map(self._node_of, base,
                                   members=self._members)
            cand = candidate_from_sources(x_na, self._node_of, srcs)
            cand = round_integer_nonants(self.opt.batch, cand)
            obj, feas = self.opt.evaluate_xhat(cand)
            if feas:
                self.update_if_improving(obj, solution=cand)
        return True
