"""MultRhoUpdater — multiply rho when convergence stalls (port of
`mpisppy_tpu/extensions/mult_rho_updater.py`).

Options under options["mult_rho_options"]:
    convergence_tolerance (default 1e-4): only update while conv above it
    rho_update_stop_iteration / rho_update_start_iteration
    rho_multiplier (default 2.0)
"""

from __future__ import annotations

from .. import global_toc
from .extension import Extension


class MultRhoUpdater(Extension):
    def __init__(self, ph):
        super().__init__(ph)
        o = ph.options.get("mult_rho_options") or {}
        self.conv_tol = float(o.get("convergence_tolerance", 1e-4))
        self.stop_iter = o.get("rho_update_stop_iteration")
        self.start_iter = int(o.get("rho_update_start_iteration", 1) or 1)
        self.mult = float(o.get("rho_multiplier", 2.0))
        self._last_conv = None

    def miditer(self):
        st = self.opt.state
        if st is None:
            return
        it = int(st.it)
        if it < self.start_iter:
            return
        if self.stop_iter is not None and it > int(self.stop_iter):
            return
        conv = float(st.conv)
        if conv <= self.conv_tol:
            return
        if self._last_conv is not None and conv >= self._last_conv:
            # a new tensor: the next superstep receives it
            self.opt.rho = self.opt.rho * self.mult
            global_toc(f"MultRhoUpdater iter {it}: conv stalled at "
                       f"{conv:.3e}, rho *= {self.mult}")
        self._last_conv = conv
