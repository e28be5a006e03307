"""Sampled subtrees for multistage evaluation (port of
`mpisppy_tpu/confidence_intervals/sample_tree.py`; the reference's
mpisppy/confidence_intervals/sample_tree.py:18-313 SampleSubtree +
walking_tree_xhats).

For multistage CI estimation, candidates must be evaluated on FRESH
subtrees: given a multistage module (MULTISTAGE = True, build_batch
over branching_factors), `SampleSubtree` builds a new batch whose
stage-1..t decisions are pinned to the candidate and whose later-stage
branches are resampled via the module's seed kwarg.
"""

from __future__ import annotations

import inspect

import numpy as np

from ..utils.xhat_eval import Xhat_Eval


class SampleSubtree:
    def __init__(self, module, xhats, root_scen_inputs=None,
                 starting_stage=1, branching_factors=None, seed=0,
                 options=None, device=None):
        self.module = module
        self.xhats = np.asarray(xhats)
        self.stage = int(starting_stage)
        self.branching_factors = list(branching_factors or [3, 3])
        self.seed = int(seed)
        self.options = dict(options or {})
        self.EF_obj = None
        self.device = device

    def _build(self):
        kw = dict(self.module.kw_creator(self.options)) if hasattr(
            self.module, "kw_creator") else {}
        kw["branching_factors"] = tuple(self.branching_factors)
        sig = inspect.signature(self.module.build_batch)
        for s in ("seed", "seedoffset", "start_seed"):
            if s in sig.parameters:
                kw[s] = self.seed
                break
        if "device" in sig.parameters:
            kw["device"] = self.device
        return self.module.build_batch(**kw)

    def run(self):
        """Pin stages <= self.stage to the candidate, solve the
        remaining tree, return E[obj] (the reference solves the
        sub-EF; here it is one batched pinned solve)."""
        batch = self._build()
        names = list(batch.tree.scen_names)
        ev = Xhat_Eval(
            {"pdhg_eps": self.options.get("solver_eps", 1e-7),
             "pdhg_max_iters":
                 self.options.get("solver_max_iters", 100000)},
            names, batch=batch, device=batch.device)
        eobj, feas = ev.evaluate(self.xhats, upto_stage=self.stage)
        self.EF_obj = eobj
        return eobj, feas


def walking_tree_xhats(module, xhat_one, branching_factors, seed=0,
                       options=None, num_samples=3, device=None):
    """Evaluate a stage-1 candidate over several independently sampled
    trees (reference walking_tree_xhats builds xhats for every node;
    the fan-resampling here serves the same estimator role).  Returns
    the list of sampled-tree expected objectives."""
    vals = []
    for i in range(num_samples):
        st = SampleSubtree(module, xhat_one, starting_stage=1,
                           branching_factors=branching_factors,
                           seed=seed + 1000 * i, options=options,
                           device=device)
        eobj, feas = st.run()
        if feas:
            vals.append(eobj)
    return vals
