"""Resilience of the port's wheel (mirror of `mpisppy_tpu/resilience`).

Ported: `bounds` (payload checksums, `PayloadGuard`, `BoundGuard`), the
hub's window-read hygiene, and `checkpoint.atomic_write` (the W/x̄
files).  Not ported yet: the multiproc `SpokeSupervisor` (ROADMAP.md
queue A item 11), run checkpoints and the chaos injectors (item 6).
"""

from .bounds import BoundGuard, PayloadGuard, payload_checksum

__all__ = ["BoundGuard", "PayloadGuard", "payload_checksum"]
