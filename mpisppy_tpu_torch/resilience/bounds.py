"""Bound hygiene at the hub's window-read boundary (port of
`mpisppy_tpu/resilience/bounds.py`, host numpy only).

A spoke's bound travels through a window as one float64.  The hub
screens every incoming bound: non-finite values are rejected, and so
is a bound that crosses the other side's best bound by more than a
relative tolerance (a valid outer bound never exceeds a valid
incumbent, for minimization).  A rejection drops the message and
counts against the spoke; past its budget the hub prunes the spoke.
Every window write is stamped with a CRC32 of its float64 payload,
which the reader checks (`PayloadGuard`).
"""

from __future__ import annotations

import zlib

import numpy as np


def payload_checksum(values) -> int:
    """CRC32 over the float64 byte image of a window payload."""
    arr = np.ascontiguousarray(values, dtype=np.float64)
    return zlib.crc32(arr.tobytes()) & 0xFFFFFFFF


class PayloadGuard:
    """Checks each `(data, write_id, checksum)` snapshot one reader
    takes of one window direction: the byte image must match the
    writer's checksum, and the write_id must never fall below the
    highest this reader has seen (the kill sentinel -1 is exempt)."""

    KILL = -1

    def __init__(self):
        self.max_wid = 0
        self.corrupt = 0

    def check(self, values, write_id, checksum):
        """(ok, reason) for one window snapshot."""
        wid = int(write_id)
        if wid == self.KILL:
            return True, None
        if wid < self.max_wid:
            self.corrupt += 1
            return False, (f"write_id regressed: {wid} after "
                           f"{self.max_wid}")
        self.max_wid = wid
        if checksum is not None and payload_checksum(values) != int(checksum):
            self.corrupt += 1
            return False, f"payload checksum mismatch at write_id {wid}"
        return True, None


class BoundGuard:
    """Validity check for one incoming scalar bound.  `rtol` scales the
    crossing tolerance by the magnitude of the bound compared against
    (floor 1.0), so eps-level crossings of loose solves pass."""

    def __init__(self, rtol: float = 1e-2):
        self.rtol = float(rtol)

    def check(self, kind: str, value: float, inner: float, outer: float,
              minimizing: bool):
        """(ok, reason) for one incoming bound of `kind` ("outer" or
        "inner") against the hub's best bounds (possibly +-inf)."""
        v = float(value)
        if not np.isfinite(v):
            return False, f"non-finite {kind} bound {v!r}"
        other = inner if kind == "outer" else outer
        if not np.isfinite(other):
            return True, None
        tol = self.rtol * max(1.0, abs(other))
        if minimizing:
            crossed = (v > other + tol if kind == "outer"
                       else v < other - tol)
        else:
            crossed = (v < other - tol if kind == "outer"
                       else v > other + tol)
        if crossed:
            side = "inner" if kind == "outer" else "outer"
            return False, (f"wrong-direction {kind} bound {v:.6g} "
                           f"crosses best {side} bound {other:.6g}")
        return True, None
