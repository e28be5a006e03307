"""WXBarReader — warm-start PH from a W/x̄ snapshot (port of
`mpisppy_tpu/extensions/wxbarreader.py`).

options["init_W_fname"]: an .npz written by WXBarWriter (of either
package), installed right after Iter0.
"""

from __future__ import annotations

from ..utils.wxbarutils import read_W_and_xbar
from .extension import Extension


class WXBarReader(Extension):
    def __init__(self, ph):
        super().__init__(ph)
        self.fname = ph.options.get("init_W_fname")

    def post_iter0(self):
        if self.fname:
            read_W_and_xbar(self.fname, self.opt)
