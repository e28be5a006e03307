"""Gapper — per-iteration solver-tolerance schedule (port of
`mpisppy_tpu/extensions/mipgapper.py`).

The schedule sets the PDHG solver's relative-KKT tolerance from an
{iteration: eps} dict.  `solver_eps` is kept rounded to the batch dtype
(`ops.pdhg.round_to_dtype`), as SPOpt keeps it and as the JAX package
stores it (a 0-d array of the batch dtype), so an f32 run tests its
residuals against the same eps in both packages.

Options: options["gapperoptions"] = {"verbose": ..., "mipgapdict":
{iter: eps}}; iteration 0 applies from Iter0 on.
"""

from __future__ import annotations

from .. import global_toc
from ..ops.pdhg import round_to_dtype
from .extension import Extension


class Gapper(Extension):
    def __init__(self, ph):
        super().__init__(ph)
        o = ph.options.get("gapperoptions") or {}
        self.verbose = bool(o.get("verbose", False))
        self.mipgapdict = dict(o.get("mipgapdict") or {})

    def _apply(self, it):
        if it in self.mipgapdict:
            eps = float(self.mipgapdict[it])
            self.opt.solver_eps = round_to_dtype(eps,
                                                 self.opt.batch.c.dtype)
            if self.verbose:
                global_toc(f"Gapper: iter {it} -> solver eps {eps:g}")

    def pre_iter0(self):
        self._apply(0)

    def miditer(self):
        if self.opt.state is not None:
            self._apply(int(self.opt.state.it))
