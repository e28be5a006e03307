"""PH — the Progressive Hedging driver (port of
`mpisppy_tpu/opt/ph.py`).

ph_main runs Iter0 -> iterk_loop -> post_loops and returns
(conv, Eobj, trivial_bound).  With options["resume_from"] naming an
existing run checkpoint, the checkpoint replaces Iter0 and the loop
continues from its iteration; a missing file falls through to a fresh
start, so a driver may pass the path it writes with
options["run_checkpoint"] unconditionally.
"""

from __future__ import annotations

from .. import global_toc
from ..phbase import PHBase


class PH(PHBase):
    def ph_main(self, finalize=True):
        self.trivial_bound = None
        resume = self.options.get("resume_from")
        from ..resilience.checkpoint import checkpoint_exists
        if resume is not None and checkpoint_exists(resume):
            trivial = self.restore_run_checkpoint(resume)
        else:
            trivial = self.Iter0()
        self.iterk_loop()
        if finalize:
            eobj = self.post_loops()
            global_toc(f"PH done: conv={self.conv:.4e} Eobj={eobj:.6g} "
                       f"trivial_bound={trivial:.6g}")
            return self.conv, eobj, trivial
        return self.conv, None, trivial

    def solution_dict(self, finalize=True):
        """The `ph_main` return values as a structured dict."""
        eobj = self.post_loops() if finalize else None
        return {
            "conv": self.conv,
            "eobj": eobj,
            "trivial_bound": self.trivial_bound,
            "xbar": self.root_xbar().cpu().numpy(),
            "iterations": int(self.state.it),
            "solve_iters": int(self.state.solve_iters),
        }
