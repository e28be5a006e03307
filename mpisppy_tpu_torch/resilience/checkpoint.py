"""Atomic file writes (port of the part of
`mpisppy_tpu/resilience/checkpoint.py` that the W/x̄ snapshot uses).

Run checkpoints (`run_checkpoint`, `resume_from`) are not ported yet
(ROADMAP.md queue A item 6); they will extend this module.
"""

from __future__ import annotations

import os


def atomic_write(path, data):
    """Atomically write `data` (bytes) to `path` through a tmp file and
    os.replace: a reader, or a resume after a crash mid-write, never
    sees a torn file."""
    path = str(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path
