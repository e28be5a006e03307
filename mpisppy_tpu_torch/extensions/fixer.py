"""Fixer — progressive variable fixing (port of
`mpisppy_tpu/extensions/fixer.py`).

A slot (scenario s, nonant k) is "ripe" when the cross-scenario spread
xsqbar - xbar^2 is below `boundtol` and, for integer slots, xbar is
within `boundtol` of an integer; after `nb` consecutive ripe iterations
the slot is pinned through `PHBase.fix_nonants` (the effective bounds
that each superstep receives).  The test runs on host copies of x̄ and
its square mean, one (S, K) copy each per iteration.

Options (options["fixeroptions"]):
    boundtol       ripeness tolerance (default 1e-2)
    nb             consecutive-iteration count to fix (default 3)
    fix_integers   fix integer-marked slots by rounding xbar (True)
    fix_continuous also fix continuous slots to xbar (False)
    unfix_on_drift release pinned slots under dual pressure (False):
                   the reduced cost of a pinned slot in the PH
                   subproblem, r = c_eff + q_eff*x + A'y, is the
                   objective pressure against the pin; a slot is
                   released when |r| > drift_W_factor * (1 + |c|)
    drift_W_factor see above (default 10.0)
    verbose
"""

from __future__ import annotations

import numpy as np

from .. import global_toc
from ..device import host
from ..ir import bmatvec_t
from .extension import Extension


class Fixer(Extension):
    def __init__(self, ph):
        super().__init__(ph)
        o = (ph.options.get("fixeroptions") or {})
        self.boundtol = float(o.get("boundtol", 1e-2))
        self.nb = int(o.get("nb", 3))
        self.fix_integers = bool(o.get("fix_integers", True))
        self.fix_continuous = bool(o.get("fix_continuous", False))
        self.unfix_on_drift = bool(o.get("unfix_on_drift", False))
        self.drift_W_factor = float(o.get("drift_W_factor", 10.0))
        self.verbose = bool(o.get("verbose", False))
        b = ph.batch
        S, K = b.num_scens, b.num_nonants
        self._count = np.zeros((S, K), np.int32)
        self._fixed = np.zeros((S, K), bool)
        self._fixed_vals = np.zeros((S, K), float)  # targets at fix time
        # which slots are integer-typed (per scenario x slot)
        self._int_slot = host(b.integer_mask)[:, host(b.nonant_idx)]

    def _ripe_and_target(self):
        st = self.opt.state
        xbar = host(st.xbar)
        spread = host(st.xsqbar) - xbar * xbar
        tight = spread < self.boundtol
        target = xbar.copy()
        ripe = np.zeros_like(tight)
        if self.fix_integers:
            rounded = np.round(xbar)
            near_int = np.abs(xbar - rounded) < self.boundtol
            ripe |= self._int_slot & tight & near_int
            target = np.where(self._int_slot, rounded, target)
        if self.fix_continuous:
            ripe |= (~self._int_slot) & tight
        return ripe, target

    def iter0(self):
        self.miditer(first=True)

    def post_iter0(self):
        self.iter0()

    def miditer(self, first=False):
        if self.opt.state is None:
            return
        ripe, target = self._ripe_and_target()
        self._count = np.where(ripe, self._count + 1, 0)
        newly = (self._count >= self.nb) & ~self._fixed
        if newly.any():
            # pin only the newly ripe slots: re-pinning a fixed slot to
            # a target from a drifted xbar would move a fixed variable
            self._fixed |= newly
            self._fixed_vals = np.where(newly, target, self._fixed_vals)
            self.opt.fix_nonants(newly, target)
            if self.verbose:
                global_toc(f"Fixer: fixed {int(newly.sum())} new slots "
                           f"({int(self._fixed.sum())} total)")
        elif self.unfix_on_drift and self._fixed.any():
            r_na = self._pinned_reduced_costs()
            b = self.opt.batch
            c_na = np.abs(host(b.c))[:, host(b.nonant_idx)]
            drift = self._fixed & (
                np.abs(r_na) > self.drift_W_factor * (1.0 + c_na))
            if drift.any():
                self._fixed &= ~drift
                self._count = np.where(drift, 0, self._count)
                self.opt.unfix_nonants(drift)
                if self.verbose:
                    global_toc(f"Fixer: unfixed {int(drift.sum())} slots")

    def _pinned_reduced_costs(self):
        """Reduced cost of each nonant slot in the PH subproblem at the
        current iterate: r = c_eff + q_eff*x + A'y on the nonant
        columns, (S, K) on the host.  A'y goes through `ir.bmatvec_t`,
        so every operator form (dense, shared, SplitA) is served."""
        opt = self.opt
        b = opt.batch
        st = opt.state
        na = b.nonant_idx
        c_eff = b.c.clone()
        c_eff[:, na] += st.W - opt.rho * st.xbar
        q_eff = b.qdiag.clone()
        q_eff[:, na] += opt.rho
        r = c_eff + q_eff * st.x + bmatvec_t(b.A, st.y)
        return host(r[:, na])

    def post_everything(self):
        global_toc(f"Fixer: {int(self._fixed.sum())} slots fixed at end "
                   f"(of {self._fixed.size})")
