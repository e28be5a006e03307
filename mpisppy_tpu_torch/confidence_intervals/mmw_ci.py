"""MMW confidence intervals (port of
`mpisppy_tpu/confidence_intervals/mmw_ci.py`; the reference's
mpisppy/confidence_intervals/mmw_ci.py:31-189 — Mak, Morton & Wood
gap confidence interval around a given xhat).

`num_batches` independent samples of `batch_size` scenarios each yield
gap estimates G_i with stds s_i; the one-sided (1-alpha) CI on the true
gap is  [0, Gbar + t_{alpha, nB-1} * sbar / sqrt(nB)]  where Gbar and
sbar aggregate over batches (reference mmw_ci.py:120-170).
"""

from __future__ import annotations

import importlib

import numpy as np

from .. import global_toc
from . import ciutils


class MMWConfidenceIntervals:
    def __init__(self, mname, options, xhat_one, num_batches,
                 batch_size=None, start=None, verbose=False,
                 mname_is_module=None, device=None):
        self.module = (mname if mname_is_module or not isinstance(
            mname, str) else importlib.import_module(mname))
        self.options = dict(options or {})
        self.xhat_one = np.asarray(xhat_one)
        self.num_batches = int(num_batches)
        self.batch_size = int(batch_size or
                              self.options.get("batch_size", 10))
        # start: first sampling seed; the reference uses num_scens of
        # the original problem so samples never overlap the training
        # scenarios (mmw_ci.py:87)
        self.start = int(start if start is not None
                         else self.options.get("start", 1000))
        self.verbose = verbose
        self.device = device
        self.result = None

    def run(self, confidence_level=0.95, objective_gap=False):
        Gs, stds, zhats, zstars = [], [], [], []
        seed = self.start
        for i in range(self.num_batches):
            est = ciutils.gap_estimators(
                self.xhat_one, self.module,
                solving_type=self.options.get("solving_type",
                                              "EF_2stage"),
                num_scens=self.batch_size, seed=seed,
                cfg=self.options, objective_gap=objective_gap,
                device=self.device)
            seed = est["seed"]
            Gs.append(est["G"])
            stds.append(est["std"])
            zhats.append(est["zhats"])
            zstars.append(est["zstar"])
            if self.verbose:
                global_toc(f"MMW batch {i}: G={est['G']:.6g} "
                           f"std={est['std']:.6g}")
        nB = self.num_batches
        Gbar = float(np.mean(Gs))
        # aggregate std over batches (reference mmw_ci.py:150): the
        # batch-mean estimator's std
        if nB > 1:
            sbar = float(np.std(Gs, ddof=1))
        else:
            sbar = float(stds[0] / np.sqrt(self.batch_size))
        tq = ciutils.t_quantile(confidence_level, max(nB - 1, 1))
        Gmax = Gbar + tq * sbar / np.sqrt(nB)
        self.result = {
            "gap_inner_bound": max(Gmax, 0.0),
            "gap_outer_bound": 0.0,
            "Gbar": Gbar, "std": sbar, "Glist": Gs,
            "zhat_bar": float(np.mean(zhats)),
            "zstar_bar": float(np.mean(zstars)),
        }
        global_toc(f"MMW: gap in [0, {Gmax:.6g}] at "
                   f"{confidence_level:.0%} (Gbar={Gbar:.6g})")
        return self.result
