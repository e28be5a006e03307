"""Gradient_extension — gradient-based rho (port of
`mpisppy_tpu/extensions/gradient_extension.py`, delegating to
`utils/gradient.py`).

Sets rho from gradient order statistics after Iter0 (when the nonant
spread is known) and optionally every `grad_rho_update_interval`
iterations; the (K,) rho computed on the host goes back to the
optimizer's device as an (S, K) tensor of the batch dtype.

Options under options["gradient_extension_options"]:
    grad_order_stat (default 0.5), grad_rho_relative_bound (1e3),
    grad_rho_update_interval (0 = Iter0 only)
"""

from __future__ import annotations

import numpy as np
import torch

from .. import global_toc
from ..utils.gradient import find_rho
from .extension import Extension


class Gradient_extension(Extension):
    def __init__(self, ph):
        super().__init__(ph)
        o = ph.options.get("gradient_extension_options") or {}
        self.order_stat = float(o.get("grad_order_stat", 0.5))
        self.rel_bound = float(o.get("grad_rho_relative_bound", 1e3))
        self.interval = int(o.get("grad_rho_update_interval", 0))

    def _apply(self):
        rho = find_rho(self.opt, order_stat=self.order_stat,
                       rel_bound=self.rel_bound)
        b = self.opt.batch
        self.opt.rho = torch.as_tensor(rho, device=self.opt.device).to(
            b.c.dtype)[None, :].expand(b.num_scens,
                                       b.num_nonants).contiguous()
        global_toc(f"Gradient rho set: mean {float(np.mean(rho)):.4g} "
                   f"max {float(np.max(rho)):.4g}")

    def post_iter0(self):
        self._apply()

    def miditer(self):
        if self.interval and self.opt.state is not None and \
                int(self.opt.state.it) % self.interval == 0:
            self._apply()
