"""Xhat shuffle-looper inner-bound spoke (port of
`mpisppy_tpu/cylinders/xhatshufflelooper_bounder.py`).

The incumbent finder: takes the hub's latest per-scenario nonants,
cycles through source scenarios in a shuffled order (Python's
`random.Random(42).sample`, so the order equals the JAX package's and
the reference's), builds an implementable candidate per tree node,
fixes the nonants and evaluates all scenarios in one batched solve.
"""

from __future__ import annotations

import random

import numpy as np

from ..device import host
from ..utils.xhat_utils import (candidate_from_sources, full_source_map,
                                node_members, round_integer_nonants)
from .spoke import InnerBoundNonantSpoke


class ScenarioCycler:
    """Walks a shuffled scenario list in epochs, reversing direction
    each epoch when `reverse` is set."""

    def __init__(self, shuffled, reverse=True):
        self._shuffled = list(shuffled)
        self._reverse = reverse
        self._pos = 0
        self._direction = 1
        self.best = None

    def get_next(self):
        if not self._shuffled:
            return None
        if self._pos >= len(self._shuffled) or self._pos < 0:
            self.begin_epoch()
        s = self._shuffled[self._pos]
        self._pos += self._direction
        return s

    def begin_epoch(self):
        if self._reverse:
            self._direction *= -1
        self._pos = (0 if self._direction > 0
                     else len(self._shuffled) - 1)


class XhatShuffleInnerBound(InnerBoundNonantSpoke):
    converger_spoke_char = "X"

    def __init__(self, spbase_object, options=None):
        super().__init__(spbase_object, options=options)
        self.random_seed = 42          # the reference's fixed seed
        rs = random.Random()
        rs.seed(self.random_seed)
        n_real = self.opt.n_real_scens
        shuffled = rs.sample(list(range(n_real)), n_real)
        self.cycler = ScenarioCycler(
            shuffled, reverse=self.options.get("reverse", True))
        self._node_of = host(self.opt.batch.tree.node_of)
        self._members = node_members(self._node_of[:n_real])
        self._last_nonants = None

    def step(self):
        x_na, is_new = self.fresh_nonants()
        if self._killed:
            return False
        if is_new:
            self._last_nonants = np.asarray(x_na)
        if self._last_nonants is None:
            return False
        base = self.cycler.get_next()
        if base is None:
            return False
        srcs = full_source_map(self._node_of, base, members=self._members)
        cand = candidate_from_sources(self._last_nonants, self._node_of,
                                      srcs)
        cand = round_integer_nonants(self.opt.batch, cand)
        obj, feas = self.opt.evaluate_xhat(cand)
        if feas and self.update_if_improving(obj, solution=cand):
            self.cycler.best = base
        return True

    def algo_state(self):
        state = super().algo_state()
        state["cycler_pos"] = int(self.cycler._pos)
        state["cycler_direction"] = int(self.cycler._direction)
        if self.cycler.best is not None:
            state["cycler_best"] = int(self.cycler.best)
        if self._last_nonants is not None:
            state["last_nonants"] = np.asarray(self._last_nonants)
        return state

    def restore_algo_state(self, state):
        super().restore_algo_state(state)
        if "cycler_pos" in state:
            self.cycler._pos = int(state["cycler_pos"])
        if "cycler_direction" in state:
            self.cycler._direction = int(state["cycler_direction"])
        if "cycler_best" in state:
            self.cycler.best = int(state["cycler_best"])
        if "last_nonants" in state:
            self._last_nonants = np.asarray(state["last_nonants"])
