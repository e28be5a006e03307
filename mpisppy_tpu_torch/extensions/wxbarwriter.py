"""WXBarWriter — write a W/x̄ snapshot during PH (port of
`mpisppy_tpu/extensions/wxbarwriter.py`).

options["W_fname"]: an .npz snapshot written atomically at every
iteration and at post_everything.  Full run checkpoints are
options["run_checkpoint"] (`resilience/checkpoint.py`).
"""

from __future__ import annotations

from ..utils.wxbarutils import write_W_and_xbar
from .extension import Extension


class WXBarWriter(Extension):
    def __init__(self, ph):
        super().__init__(ph)
        self.fname = ph.options.get("W_fname")

    def enditer(self):
        if self.fname and self.opt.state is not None:
            write_W_and_xbar(self.fname, self.opt)

    def post_everything(self):
        self.enditer()
