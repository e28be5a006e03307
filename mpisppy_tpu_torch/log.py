"""Logging configuration (port of `mpisppy_tpu/log.py`).

`setup_logger` configures a named logger with a level, a file target
or the console, so each module (`mpisppy_tpu_torch.cylinders.hub`, ...)
can be tuned on its own.  `global_toc_logger` mirrors the package's
timestamped screen trace (`mpisppy_tpu_torch.global_toc`) into the
logging tree, for runs whose trace should land in a file.
Standard library only.
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s - %(levelname)s - %(name)s: %(message)s"


def setup_logger(name: str, out: str | None = None,
                 level=logging.INFO, fmt: str = _FORMAT,
                 mode: str = "w") -> logging.Logger:
    """Configure and return logger `name`.

    out: a file path, or None / "-" / "stdout" / "stderr" for the
    console.  Calling again with the same name replaces the handlers
    (one handler per named logger).
    """
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        try:
            h.close()
        except Exception:
            pass
    if out in (None, "-", "stdout"):
        handler = logging.StreamHandler(sys.stdout)
    elif out == "stderr":
        handler = logging.StreamHandler(sys.stderr)
    else:
        handler = logging.FileHandler(out, mode=mode)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(fmt))
    logger.addHandler(handler)
    return logger


def global_toc_logger(out: str | None = None, level=logging.INFO):
    """Route the package's global_toc trace into a logger as well."""
    from . import add_toc_sink

    logger = setup_logger("mpisppy_tpu_torch.toc", out=out, level=level,
                          fmt="%(message)s")
    add_toc_sink(lambda msg: logger.log(level, msg))
    return logger
