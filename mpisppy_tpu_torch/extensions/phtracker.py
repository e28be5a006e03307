"""PHTracker — per-iteration tracking to CSVs and plots (port of
`mpisppy_tpu/extensions/phtracker.py`): bounds, gaps, x̄, mean |W|,
nonants and scenario costs, one CSV each in a per-cylinder folder,
with optional matplotlib plots (imported only when a plot is asked
for).  Each row is built from host copies of the state.

Options under options["phtracker_options"]:
    results_folder (default "phtracker_results")
    cylinder_name  (default: the hub or spoke class under a
                    WheelSpinner, else "hub"); each cylinder writes
                    into results_folder/<cylinder_name>/
    track_bounds / track_gaps / track_xbars / track_duals /
    track_nonants / track_scen_costs       (all default True)
    plot_bounds / plot_gaps / plot_xbars / plot_duals /
    plot_scen_costs                        (all default False):
    PNGs written at post_everything when matplotlib is installed
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ..device import host
from .extension import Extension


class PHTracker(Extension):
    def __init__(self, ph):
        super().__init__(ph)
        o = ph.options.get("phtracker_options") or {}
        self._root = o.get("results_folder", "phtracker_results")
        self._name = o.get("cylinder_name")
        self._folder = None
        self.track = {k: bool(o.get(f"track_{k}", True))
                      for k in ("bounds", "gaps", "xbars", "duals",
                                "nonants", "scen_costs")}
        self.plot = {k: bool(o.get(f"plot_{k}", False))
                     for k in ("bounds", "gaps", "xbars", "duals",
                               "scen_costs")}
        self._files = {}

    @property
    def folder(self):
        """Resolved lazily: extensions are constructed inside the
        optimizer's __init__, before the WheelSpinner attaches spcomm,
        so resolving the cylinder name there would put every cylinder
        in the same 'hub' folder."""
        if self._folder is None:
            name = self._name
            if name is None:
                spcomm = getattr(self.opt, "spcomm", None)
                name = (type(spcomm).__name__ if spcomm is not None
                        else "hub")
            self._folder = os.path.join(self._root, str(name))
            os.makedirs(self._folder, exist_ok=True)
        return self._folder

    def _w(self, name, header):
        if name not in self._files:
            path = os.path.join(self.folder, f"{name}.csv")
            # one file per run ("w"): appending across runs would
            # interleave iteration rows from different runs
            f = open(path, "w", newline="")
            w = csv.writer(f)
            w.writerow(header)
            self._files[name] = (f, w)
        return self._files[name][1]

    def _hub_bounds(self):
        hub = getattr(self.opt, "spcomm", None)
        ob = getattr(hub, "BestOuterBound", float("nan"))
        ib = getattr(hub, "BestInnerBound", float("nan"))
        return float(ob), float(ib)

    def _iteration_row(self):
        opt = self.opt
        st = opt.state
        it = int(st.it)
        K = opt.batch.num_nonants
        if self.track["bounds"]:
            ob, ib = self._hub_bounds()
            self._w("bounds", ["iteration", "outer", "inner", "conv"]
                    ).writerow([it, ob, ib, float(st.conv)])
        if self.track["gaps"]:
            ob, ib = self._hub_bounds()
            if np.isfinite(ob) and np.isfinite(ib):
                abs_gap = abs(ib - ob)
                rel_gap = (abs_gap / abs(ib) if abs(ib) > 0
                           else float("nan"))
            else:
                abs_gap = rel_gap = float("nan")
            self._w("gaps", ["iteration", "abs_gap", "rel_gap"]
                    ).writerow([it, abs_gap, rel_gap])
        if self.track["xbars"]:
            self._w("xbars", ["iteration"] + [f"x{k}" for k in range(K)]
                    ).writerow([it] + host(st.xbar[0]).tolist())
        if self.track["duals"]:
            Wbar = np.abs(host(st.W)).mean(axis=0)
            self._w("duals", ["iteration"] + [f"W{k}" for k in range(K)]
                    ).writerow([it] + Wbar.tolist())
        if self.track["nonants"]:
            x_na = host(opt.batch.nonants(st.x))
            row = [it] + x_na[: opt.n_real_scens].reshape(-1).tolist()
            self._w("nonants", ["iteration"] + [
                f"s{s}_x{k}" for s in range(opt.n_real_scens)
                for k in range(K)]).writerow(row)
        if self.track["scen_costs"]:
            obj = host(st.obj)[: opt.n_real_scens]
            self._w("scen_costs", ["iteration"] + [
                f"s{s}" for s in range(opt.n_real_scens)]
                ).writerow([it] + obj.tolist())
        for f, _ in self._files.values():
            f.flush()

    def post_iter0(self):
        self._iteration_row()

    def enditer(self):
        self._iteration_row()

    # -- plotting --------------------------------------------------------
    def _plot_csv(self, name, ylabel, series_limit=12):
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:                            # pragma: no cover
            return
        path = os.path.join(self.folder, f"{name}.csv")
        if not os.path.exists(path):
            return
        with open(path) as f:
            rows = list(csv.reader(f))
        if len(rows) < 2:
            return
        header, data = rows[0], np.array(
            [[float(v) for v in r] for r in rows[1:]])
        fig, ax = plt.subplots(figsize=(7, 4))
        for j in range(1, min(data.shape[1], series_limit + 1)):
            ax.plot(data[:, 0], data[:, j], label=header[j])
        ax.set_xlabel("iteration")
        ax.set_ylabel(ylabel)
        ax.legend(fontsize=7, ncol=2)
        fig.tight_layout()
        fig.savefig(os.path.join(self.folder, f"{name}.png"), dpi=100)
        plt.close(fig)

    def post_everything(self):
        for f, _ in self._files.values():
            f.close()
        self._files = {}
        for name, ylabel in (("bounds", "bound"), ("gaps", "gap"),
                             ("xbars", "xbar"), ("duals", "|W| mean"),
                             ("scen_costs", "scenario cost")):
            if self.plot.get(name, False):
                self._plot_csv(name, ylabel)
