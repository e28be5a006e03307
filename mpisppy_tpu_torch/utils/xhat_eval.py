"""Xhat_Eval — candidate evaluation (port of
`mpisppy_tpu/utils/xhat_eval.py`).

Fix the nonants to a candidate, solve every scenario, return the
expected objective: an inner bound when feasible.  Fixing is an
elimination of the nonant columns (`SPOpt.evaluate_xhat`) and the
solve is one batched PDHG call; `SPOpt.evaluate_candidates` screens k
candidates in one stacked solve.
"""

from __future__ import annotations

import numpy as np

from ..spopt import SPOpt


class Xhat_Eval(SPOpt):
    """Standalone evaluator, constructed like SPOpt."""

    def evaluate(self, nonant_values, upto_stage=None, tol=None):
        """Expected objective with the nonants fixed to `nonant_values`
        ((K,) or (S, K)).  Returns (Eobj, feasible)."""
        return self.evaluate_xhat(nonant_values, upto_stage=upto_stage,
                                  tol=tol)

    def evaluate_one(self, nonant_values, scen_index):
        """One scenario's objective at a fixed candidate."""
        lb, ub = self.fixed_nonant_bounds(nonant_values)
        res = self.solve_loop(lb=lb, ub=ub, warm=False)
        return float(res.obj[scen_index])


def calculate_incumbent(ev: Xhat_Eval, candidates):
    """(index, Eobj) of the best feasible candidate, or (None, None).

    The stacked screening solve ranks all candidates in one launch;
    the winner's value is then certified by `evaluate_xhat` (f64
    fallback for stragglers).  If screening calls every candidate
    infeasible, the best-objective one still gets the certified
    check."""
    cands = np.asarray(candidates)
    objs, feas = ev.evaluate_candidates(cands)
    ranked = np.where(feas, objs, np.inf)
    i = int(np.argmin(ranked))
    if not np.isfinite(ranked[i]):
        i = int(np.argmin(objs))
    obj, ok = ev.evaluate_xhat(cands[i], certify="auto")
    if not ok:
        return None, None
    return i, float(obj)
