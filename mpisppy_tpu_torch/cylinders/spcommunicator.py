"""Inter-cylinder communication (port of
`mpisppy_tpu/cylinders/spcommunicator.py`).

Cylinders are algorithms sharing one process: interleaved on one
device queue, or in host threads.  Each hub<->spoke direction is a
host mailbox, a float64 (length+1,) buffer whose last slot carries a
strictly increasing write_id (the reference's RMA window protocol):
readers tell fresh from stale data by the id, and write_id == -1 is
the kill signal.  Device tensors cross it as host float64 copies;
f32 and bf16 values round-trip through float64 exactly.

Backends: "python" (alias "seqlock") is the mailbox below; "native"
is the C++ seqlock (`runtime/exchange.cpp`, lock-free reads), in
memory or, with a path prefix, in mmap files that another process
attaches to (multiproc mode); names registered through
`register_window_backend` plug in behind the same contract.  Not
ported yet: the device-resident "device" / "collective" backends
(ROADMAP.md queue A item 13), which raise where selected.

Window traffic is counted in the telemetry registry (window.writes,
window.reads, window.stale_reads, window.kill_signals): each cylinder
binds its handles once, from `options["telemetry"]`, and they are
null no-ops when telemetry is off.
"""

from __future__ import annotations

import threading

import numpy as np

from .. import not_ported
from .. import telemetry as _telemetry
from ..resilience.bounds import PayloadGuard, payload_checksum


class Window:
    """One direction of a hub<->spoke pair: a (length+1,) float64
    buffer whose last slot is the write_id.

    * writes are atomic and carry a strictly increasing write_id;
    * `read()` returns (data copy, write_id);
    * write_id == -1 means terminate;
    * every write is stamped with a payload checksum, which
      `read_checked()` validates with this reader's `PayloadGuard`.
    """

    KILL = -1

    def __init__(self, length: int):
        self.length = int(length)
        self._buf = np.zeros(self.length + 1, dtype=np.float64)
        self._lock = threading.Lock()
        self._checksum = payload_checksum(self._buf[:-1])
        self._corrupt_next = False
        self._pguard = PayloadGuard()

    @property
    def write_id(self):
        with self._lock:
            return int(self._buf[-1])

    def corrupt_next_write(self):
        """Fault hook: the next write stores a perturbed payload under
        the checksum of the true values, so only payload validation can
        catch it."""
        self._corrupt_next = True

    def write(self, values, write_id=None):
        """Post `values` with the next (or the given) write_id."""
        values = np.asarray(values, dtype=np.float64)
        if values.shape != (self.length,):
            raise ValueError(
                f"window expects shape ({self.length},), got {values.shape}")
        chk = payload_checksum(values)
        if self._corrupt_next:
            self._corrupt_next = False
            values = values.copy()
            values[0] += 1.0
        with self._lock:
            new_id = int(self._buf[-1]) + 1 if write_id is None else write_id
            self._buf[:-1] = values
            self._buf[-1] = new_id
            self._checksum = chk
            return new_id

    def read(self):
        """(data copy, write_id): one atomic snapshot."""
        with self._lock:
            return self._buf[:-1].copy(), int(self._buf[-1])

    def read_checked(self):
        """(data, write_id, ok, reason): one snapshot, validated against
        the writer's checksum and this reader's highest write_id.
        Readers drop snapshots that are not ok."""
        with self._lock:
            data = self._buf[:-1].copy()
            wid = int(self._buf[-1])
            chk = self._checksum
        ok, reason = self._pguard.check(data, wid, chk)
        return data, wid, ok, reason

    def send_kill(self):
        with self._lock:
            self._buf[-1] = self.KILL

    def close(self):
        """Nothing to release (interface parity with other backends)."""


_WINDOW_BACKENDS: dict = {}
# backends of the JAX package that the port does not carry yet, with
# their ROADMAP.md queue A items
_UNPORTED_BACKENDS = {"device": 13, "collective": 13}


def register_window_backend(name, pair_factory):
    """Register `pair_factory(hub_length, spoke_length, **kwargs) ->
    (to_spoke, to_hub)` under `name` for WindowPair(backend=name)."""
    _WINDOW_BACKENDS[name] = pair_factory


class WindowPair:
    """The two windows of one hub<->spoke pair: hub-owned `to_spoke`
    and spoke-owned `to_hub`.  backend "python" / "seqlock" is the host
    mailbox; "native" the C++ seqlock, in the files
    `<path_prefix>.to_spoke` / `.to_hub` when a prefix is given (the
    creator owns and resets them; attach=True joins existing files, as
    a spoke process does, and must not reset them; the in-memory
    backends ignore the prefix); any other name
    resolves through the registered factories, which get
    `backend_kwargs`."""

    def __init__(self, hub_length: int, spoke_length: int,
                 backend: str = "python", path_prefix: str | None = None,
                 attach: bool = False,
                 backend_kwargs: dict | None = None):
        if backend == "native":
            from ..runtime import NativeWindow

            def pth(tag):
                return None if path_prefix is None \
                    else f"{path_prefix}.{tag}"
            self.to_spoke = NativeWindow(hub_length, path=pth("to_spoke"),
                                         reset=not attach)
            self.to_hub = NativeWindow(spoke_length, path=pth("to_hub"),
                                       reset=not attach)
            return
        if backend in ("python", "seqlock"):
            self.to_spoke = Window(hub_length)
            self.to_hub = Window(spoke_length)
            return
        factory = _WINDOW_BACKENDS.get(backend)
        if factory is None:
            if backend in _UNPORTED_BACKENDS:
                raise not_ported(f"window backend {backend!r}",
                                 _UNPORTED_BACKENDS[backend])
            raise RuntimeError(f"window backend {backend!r} is not "
                               "registered")
        self.to_spoke, self.to_hub = factory(
            hub_length, spoke_length, **(backend_kwargs or {}))


class SPCommunicator:
    """Base of Hub and Spoke: owns an optimization object (`opt`, an
    SPOpt subclass) and its window endpoints."""

    def __init__(self, spbase_object, options=None):
        self.opt = spbase_object
        self.options = dict(options or {})
        self.opt.spcomm = self
        # the process-global handle (shared with the optimizers when the
        # configs agree); its instruments are no-ops when it is off
        self.telemetry = _telemetry.configure_from_options(
            self.options.get("telemetry"))
        # the trace row of this cylinder's spans (None = the hub's main
        # row; WheelSpinner names each spoke's track)
        self.telemetry_track = None
        tel = self.telemetry
        self._c_writes = tel.counter("window.writes")
        self._c_reads = tel.counter("window.reads")
        self._c_stale = tel.counter("window.stale_reads")
        self._c_kills = tel.counter("window.kill_signals")

    def send_length(self) -> int:
        return 1

    def receive_length(self) -> int:
        return 1

    def finalize(self):
        """Last work after the kill signal."""
        return None
