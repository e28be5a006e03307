"""Diagnoser — per-iteration scenario dumps (port of
`mpisppy_tpu/extensions/diagnoser.py`).

Writes one CSV per call under
options["diagnoser_options"]["diagnoser_outdir"] with each scenario's
probability, objective and nonant deviation from x̄.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ..device import host
from .extension import Extension


class Diagnoser(Extension):
    def __init__(self, ph):
        super().__init__(ph)
        o = ph.options.get("diagnoser_options") or {}
        self.outdir = o.get("diagnoser_outdir", "diagnoser_out")

    def _dump(self, tag):
        st = self.opt.state
        if st is None:
            return
        os.makedirs(self.outdir, exist_ok=True)
        b = self.opt.batch
        obj = host(st.obj)
        prob = host(b.prob)
        x_na = host(b.nonants(st.x))
        dev = np.abs(x_na - host(st.xbar)).sum(axis=1)
        path = os.path.join(self.outdir, f"diag_iter{int(st.it)}_{tag}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["scenario", "prob", "objective", "nonant_dev_l1"])
            names = b.tree.scen_names or [
                str(i) for i in range(b.num_scens)]
            for i in range(self.opt.n_real_scens):
                w.writerow([names[i], prob[i], obj[i], dev[i]])

    def post_iter0(self):
        self._dump("iter0")

    def enditer(self):
        self._dump("enditer")
