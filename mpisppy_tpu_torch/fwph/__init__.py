"""Frank-Wolfe Progressive Hedging (port of `mpisppy_tpu/fwph/`)."""

from .fwph import FWPH  # noqa: F401
