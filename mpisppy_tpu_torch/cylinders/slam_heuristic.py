"""Slam heuristics (port of `mpisppy_tpu/cylinders/slam_heuristic.py`):
set every nonant to the elementwise max (or min) over the scenarios of
its tree node, round integers and evaluate."""

from __future__ import annotations

import numpy as np

from ..device import host
from ..utils.xhat_utils import node_members, round_integer_nonants
from .spoke import InnerBoundNonantSpoke


class _SlamHeuristic(InnerBoundNonantSpoke):
    _reduce = None  # np.max or np.min

    def __init__(self, spbase_object, options=None):
        super().__init__(spbase_object, options=options)
        n_real = self.opt.n_real_scens
        self._node_of = host(self.opt.batch.tree.node_of)[:n_real]
        self._members = node_members(self._node_of)

    def step(self):
        x_na, is_new = self.fresh_nonants()
        if self._killed or not is_new:
            return False
        x_na = np.asarray(x_na)[: self.opt.n_real_scens]
        # per-(node, slot) reduce over member scenarios, broadcast back;
        # all members of a node carry it at the same slots
        cand = np.empty_like(x_na)
        for n, mem in self._members.items():
            slots = np.where(self._node_of[mem[0]] == n)[0]
            sub = np.ix_(mem, slots)
            cand[sub] = type(self)._reduce(x_na[sub], axis=0,
                                           keepdims=True)
        # pad rows: scenario 0's candidate (probability 0)
        S = self.opt.batch.num_scens
        if S > cand.shape[0]:
            cand = np.vstack([cand] + [cand[:1]] * (S - cand.shape[0]))
        cand = round_integer_nonants(self.opt.batch, cand)
        obj, feas = self.opt.evaluate_xhat(cand)
        if feas:
            self.update_if_improving(obj, solution=cand)
        return True


class SlamMaxHeuristic(_SlamHeuristic):
    converger_spoke_char = "M"
    _reduce = staticmethod(np.max)


class SlamMinHeuristic(_SlamHeuristic):
    converger_spoke_char = "m"
    _reduce = staticmethod(np.min)
