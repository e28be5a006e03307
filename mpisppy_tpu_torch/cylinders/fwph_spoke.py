"""FrankWolfeOuterBound (port of `mpisppy_tpu/cylinders/fwph_spoke.py`):
an FWPH optimizer as an outer-bound cylinder.  Each step runs one FWPH
outer pass and posts the best dual bound so far; it consumes nothing
from the hub."""

from __future__ import annotations

from .spoke import ConvergerSpokeType, _BoundSpoke


class FrankWolfeOuterBound(_BoundSpoke):
    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,)
    converger_spoke_char = "F"

    def receive_length(self):
        return 1   # the hub pushes nothing this spoke reads

    def main(self):
        """Threads-mode loop without the base class's serial-number
        gate: the hub never writes to this spoke, so it produces bounds
        until it is killed."""
        while not self.got_kill_signal():
            self.step()

    def step(self):
        opt = self.opt
        if not getattr(opt, "_prepped", False):
            opt.fw_prep()
        opt.fwph_iteration()
        if opt.dual_bound is not None:
            self.update_if_improving(opt.dual_bound)
        return True

    def finalize(self):
        return self.bound
