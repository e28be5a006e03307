"""Wtracker_extension — `utils.wtracker.WTracker` on the hook API (port
of `mpisppy_tpu/extensions/wtracker_extension.py`).

Options under options["wtracker_options"]:
    wlen (window length, default 10), stdevthresh,
    report_interval (report every k iterations; default only at end)
"""

from __future__ import annotations

from ..utils.wtracker import WTracker
from .extension import Extension


class Wtracker_extension(Extension):
    def __init__(self, ph):
        super().__init__(ph)
        o = ph.options.get("wtracker_options") or {}
        self.wtracker = WTracker(ph, wlen=o.get("wlen", 10))
        self.stdevthresh = o.get("stdevthresh")
        self.report_interval = o.get("report_interval")

    def enditer(self):
        self.wtracker.grab_local_Ws()
        if self.report_interval and self.opt.state is not None:
            if int(self.opt.state.it) % int(self.report_interval) == 0:
                self.wtracker.report_by_moving_stats(self.stdevthresh)

    def post_everything(self):
        self.wtracker.report_by_moving_stats(self.stdevthresh)
