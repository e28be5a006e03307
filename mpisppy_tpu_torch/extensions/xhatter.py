"""In-hub xhat extensions (port of `mpisppy_tpu/extensions/xhatter.py`).

An XhatBase-derived extension picks candidate first-stage solutions at
`miditer` / `post_everything`, evaluates them inside the optimizer and,
when one is feasible, publishes its expected objective as an inner
bound and records the incumbent.  Evaluation is
`utils.xhat_eval.calculate_incumbent`: one stacked screening solve of
k candidates x S scenarios (the chunk kernel's shared form where the
reduced system is scenario-independent, as on farmer), then the
winner's value through `SPOpt.evaluate_xhat`.  Publication goes to the
hub's InnerBoundUpdate when the optimizer runs as a hub, and to
`opt.best_inner_bound` always.  Candidates are built on host copies of
x's nonants and x̄.
"""

from __future__ import annotations

import numpy as np

from .. import global_toc
from ..device import host
from .extension import Extension


class XhatBase(Extension):
    """Shared candidate evaluation; the evaluation has no side effect
    on the PH state, so there is nothing to restore."""

    #: evaluate every `cycle` PH iterations
    cycle = 1

    def __init__(self, ph, options=None):
        super().__init__(ph)
        self.options = dict(options or {})
        self.cycle = int(self.options.get("cycle", self.cycle))
        self.best_inner_bound = np.inf if ph.is_minimizing else -np.inf
        self.best_nonants = None
        # mirrored onto the optimizer for writers and the wheel
        ph.best_inner_bound = self.best_inner_bound
        ph.best_inner_nonants = None

    # -- candidate supply (subclasses) -----------------------------------
    def candidates(self):
        """A (k, K) array of root-node candidate nonant vectors."""
        raise NotImplementedError

    # -- evaluation ------------------------------------------------------
    def _try_candidates(self):
        opt = self.opt
        if opt.state is None:
            return
        cands = np.atleast_2d(np.asarray(self.candidates()))
        if cands.size == 0:
            return
        from ..utils.xhat_eval import calculate_incumbent
        i, obj = calculate_incumbent(opt, cands)
        if i is None:
            return
        better = (obj < self.best_inner_bound if opt.is_minimizing
                  else obj > self.best_inner_bound)
        if better:
            self.best_inner_bound = obj
            self.best_nonants = cands[i]
            opt.best_inner_bound = obj
            opt.best_inner_nonants = cands[i]
            if opt.spcomm is not None and hasattr(opt.spcomm,
                                                 "InnerBoundUpdate"):
                opt.spcomm.InnerBoundUpdate(obj, char=self.char)

    char = "E"

    def miditer(self):
        if int(self.opt.state.it) % self.cycle == 0:
            self._try_candidates()

    def post_everything(self):
        self._try_candidates()
        if self.best_nonants is not None:
            global_toc(f"{type(self).__name__}: best inner bound "
                       f"{self.best_inner_bound:.6g}")


class XhatClosest(XhatBase):
    """Evaluate the scenario solution closest to xbar (squared distance
    to the root average).  options: {"n_candidates": int, "cycle":
    int}."""

    char = "C"

    def candidates(self):
        opt = self.opt
        st = opt.state
        x_na = host(opt.batch.nonants(st.x))[: opt.n_real_scens]
        xbar = host(st.xbar)[0]
        d = np.sum((x_na - xbar[None, :]) ** 2, axis=1)
        order = np.argsort(d)
        k = int(self.options.get("n_candidates", 1))
        return x_na[order[:k]]


class XhatXbar(XhatBase):
    """Evaluate the consensus average itself, integer slots rounded."""

    char = "X"

    def candidates(self):
        opt = self.opt
        xbar = host(opt.state.xbar)[0].copy()
        imask = host(opt.batch.integer_mask)[0, host(opt.batch.nonant_idx)]
        if imask.any():
            xbar[imask] = np.round(xbar[imask])
        return xbar[None, :]


class XhatLooper(XhatBase):
    """The scenarios' own solutions as candidates: one pass evaluates
    the next `scen_limit` scenario solutions in one stacked solve, and
    the walk position carries across calls so successive passes cover
    the scenario set cyclically.

    options: {"scen_limit": int (default 3), "cycle": int}.
    """

    char = "L"

    def __init__(self, ph, options=None):
        super().__init__(ph, options=options)
        self._pos = 0

    def candidates(self):
        opt = self.opt
        n = opt.n_real_scens
        k = min(int(self.options.get("scen_limit", 3)), n)
        x_na = host(opt.batch.nonants(opt.state.x))[:n]
        idx = (self._pos + np.arange(k)) % n
        self._pos = int((self._pos + k) % n)
        return x_na[idx]


class XhatSpecific(XhatBase):
    """Evaluate one named scenario's solution.
    options: {"xhat_scenario_name": str}."""

    char = "S"

    def candidates(self):
        opt = self.opt
        name = self.options.get("xhat_scenario_name",
                                opt.all_scenario_names[0])
        idx = opt.all_scenario_names.index(name)
        x_na = host(opt.batch.nonants(opt.state.x))
        return x_na[idx][None, :]
