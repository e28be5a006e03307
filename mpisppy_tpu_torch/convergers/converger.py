"""Converger base class (port of `mpisppy_tpu/convergers/converger.py`).

A converger is constructed with the optimizer and polled once per PH
iteration (`phbase.iterk_loop`); `is_converged()` returning True stops
the loop.  `convergence_value` holds the last computed metric.
"""

from __future__ import annotations


class Converger:
    def __init__(self, opt):
        self.opt = opt
        self.conv = None
        self.convergence_value = None

    def is_converged(self) -> bool:
        raise NotImplementedError
