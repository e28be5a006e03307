"""CrossScenarioExtension — the hub-side half of cross-scenario cuts
(port of `mpisppy_tpu/extensions/cross_scen_extension.py`; reference:
mpisppy/extensions/cross_scen_extension.py).

Needs a hub optimizer built over a batch augmented by
`utils.cross_scenario.add_cross_scenario_capacity` (an epigraph
variable eta approximating E[f](x) plus a buffer of inactive cut rows;
each scenario's objective is blended (1-w) f_s + w eta, which equals
E[f] at consensus with tight cuts).

Each sync, the extension reads the CrossScenarioCutSpoke's window and
installs the aggregate cut

    eta - Egrad . x_na >= Eq - Egrad . xhat

into the next free cut row of every scenario, then re-prepares the
constraint data (same shapes).  The hub wires the spoke in
(`Hub.wire_spokes`: spokes with `provides_cuts`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import global_toc
from ..ops.pdhg import prepare_batch
from ..utils.cross_scenario import cross_meta
from .extension import Extension


class CrossScenarioExtension(Extension):
    def __init__(self, ph):
        super().__init__(ph)
        if not getattr(ph.batch, "var_names", ()) or \
                ph.batch.var_names[-1] != "_eta_cross":
            raise RuntimeError(
                "CrossScenarioExtension needs a batch augmented by "
                "add_cross_scenario_capacity (eta column missing)")
        self._spoke = None          # wired by Hub.wire_spokes
        self._read_id = 0
        self.n_cuts = 0

    def attach_spoke(self, spoke):
        self._spoke = spoke

    def post_iter0(self):
        """Seed eta with a valid constant cut so that early bounds are
        not polluted by eta's -BIG box: one W-free solve of the base
        objective gives the wait-and-see bound WS <= min E[f], and
        eta >= WS is valid everywhere.  Also repairs the trivial bound
        that the blended Iter0 computed."""
        opt = self.opt
        b = opt.batch
        meta = cross_meta(b)
        # the eta column's objective coefficient is the blend weight w;
        # base c = c_blend / (1 - w) with the eta column zeroed
        w = float(b.c[0, meta["eta_col"]])
        c_base = b.c / max(1.0 - w, 1e-12)
        c_base[:, meta["eta_col"]] = 0.0
        res = opt.solver.solve(opt.prep, c_base, b.qdiag, b.lb, b.ub,
                               obj_const=b.obj_const / max(1.0 - w, 1e-12))
        ws = float(torch.sum(b.prob * res.dual_obj))
        K = b.num_nonants
        self._install_cut(ws, np.zeros(K), np.zeros(K))
        opt.trivial_bound = ws
        opt.best_bound = ws

    def _install_cut(self, Eq, Egrad, xhat):
        opt = self.opt
        b = opt.batch
        N = b.num_vars            # eta is column N-1
        meta = cross_meta(b)
        if self.n_cuts >= meta["max_cuts"]:
            global_toc("CrossScenario: cut buffer full; skipping")
            return
        r = meta["first_cut_row"] + self.n_cuts
        Egrad = np.asarray(Egrad, dtype=np.float64)
        row = np.zeros(N)
        row[b.nonant_idx.cpu().numpy()] = -Egrad
        row[N - 1] = 1.0
        A = b.A.clone()
        A[:, r, :] = torch.as_tensor(row, dtype=A.dtype, device=A.device)
        lo = b.row_lo.clone()
        lo[:, r] = Eq - float(Egrad @ np.asarray(xhat, dtype=np.float64))
        opt.batch = dataclasses.replace(b, A=A, row_lo=lo)
        # each cut rebuilds the dense prep, as the JAX package does
        opt.prep = prepare_batch(opt.batch.A, opt.batch.row_lo,
                                 opt.batch.row_hi)
        opt._promoted_cache = None
        self.n_cuts += 1

    def miditer(self):
        if self._spoke is None or self._spoke.pair is None:
            return
        data, wid = self._spoke.pair.to_hub.read()
        if wid <= self._read_id or wid < 0:
            return
        self._read_id = wid
        K = self.opt.batch.num_nonants
        Eq = float(data[0])
        Egrad = np.asarray(data[1:1 + K])
        xhat = np.asarray(data[1 + K:1 + 2 * K])
        self._install_cut(Eq, Egrad, xhat)
