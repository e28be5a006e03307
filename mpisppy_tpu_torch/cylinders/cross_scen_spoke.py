"""Cross-scenario cut spoke (port of
`mpisppy_tpu/cylinders/cross_scen_spoke.py`; reference:
mpisppy/cylinders/cross_scen_spoke.py).

Receives the hub's nonant candidate, solves every scenario with the
nonants pinned (one batched call) and sends back an aggregate
optimality cut of the expected value function at that candidate:

    E[f](x)  >=  Eq + Egrad . (x_na - xhat)

where Eq = sum_s p_s q_s(xhat) and Egrad = sum_s p_s dq_s/dxhat (the
reduced costs at the pinned slots, free from the first-order solver).
The reference ships a per-scenario coefficient matrix; here the
aggregation happens in the spoke and the hub-side extension installs
one cut per pass.  A^T y goes through `ir.bmatvec_t`, so a dense,
shared or split A works.

Wire format to the hub: [Eq | Egrad (K,) | xhat (K,)] (length 2K+1).
"""

from __future__ import annotations

import numpy as np

from ..device import host
from ..ir import bmatvec_t
from .spoke import ConvergerSpokeType, _BoundNonantSpoke


class CrossScenarioCutSpoke(_BoundNonantSpoke):
    converger_spoke_types = (ConvergerSpokeType.NONANT_GETTER,)
    converger_spoke_char = "C"
    provides_cuts = True      # the hub wires attach_spoke extensions

    def send_length(self):
        K = self.opt.batch.num_nonants
        return 2 * K + 1

    def step(self):
        nonants, is_new = self.fresh_nonants()
        if self._killed or not is_new:
            return False
        b = self.opt.batch
        S = self.opt.n_real_scens
        # candidate: the prob-weighted average of the hub's
        # per-scenario nonants (they agree at consensus; early on this
        # is x̄)
        p = host(b.prob)[:, None]
        xhat = (p * np.asarray(nonants)).sum(axis=0) / p.sum()

        lb, ub = self.opt.fixed_nonant_bounds(xhat)
        res = self.opt.solve_loop(lb=lb, ub=ub, warm=True)
        q = host(res.obj)[:S]
        rc = host(b.c + b.qdiag * res.x + bmatvec_t(b.A, res.y))[:S]
        grad = rc[:, host(b.nonant_idx)]
        pr = host(b.prob)[:S]
        pr = pr / pr.sum()
        Eq = float(pr @ q)
        Egrad = pr @ grad
        self.spoke_to_hub(np.concatenate([[Eq], Egrad, xhat]))
        return True

    def finalize(self):
        return None
