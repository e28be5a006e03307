"""Build and ctypes bindings of the native exchange (port of
`mpisppy_tpu/runtime/native.py`).

`exchange.cpp` (the port's own copy) is compiled with g++ at first use
into `build/runtime/libexchange_<hash>.so` beside the repo's other
build outputs, the name keyed by a hash of the source and the flags
(an edited source rebuilds), written to a temporary name and moved in
place with os.replace, so concurrent processes never load a torn
library.  `build()` runs the compiler; a wheel builds once in the hub
process before spawning its spoke processes.

`NativeWindow` is the C++ seqlock window.  Unlike the JAX package it
never falls back: when the library cannot be built or loaded,
constructing a NativeWindow raises, and `available()` says whether the
compiled library loaded.  `PySeqlockWindow` is a numpy-over-mmap class
of its own with the same memory layout (a 24-byte {seq, write_id,
length} int64 header, then float64s), so processes using either class,
or either package's library, share one window file.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "exchange.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "runtime"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_error = None


def library_path() -> Path:
    """Where the built library lives: keyed by a hash of the source and
    the compiler flags."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libexchange_{h.hexdigest()[:16]}.so"


def build():
    """Compile exchange.cpp into the shared library (a no-op when the
    library of this source hash exists).  Returns its path; raises
    RuntimeError with g++'s stderr when the build fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {_SRC.name}: {e}")
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({proc.returncode}) building {_SRC.name}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    """The ctypes handle of the library (building it first), or None
    when it cannot be built or loaded (the reason in `_error`)."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError) as e:
            _error = str(e)
            return None
        lib.exch_create.restype = ctypes.c_void_p
        lib.exch_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int]
        lib.exch_close.argtypes = [ctypes.c_void_p]
        lib.exch_write.restype = ctypes.c_int64
        lib.exch_write.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_double),
                                   ctypes.c_int64, ctypes.c_int64]
        lib.exch_read.restype = ctypes.c_int64
        lib.exch_read.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_int64]
        lib.exch_write_id.restype = ctypes.c_int64
        lib.exch_write_id.argtypes = [ctypes.c_void_p]
        lib.exch_kill.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available():
    """True iff the compiled exchange library is loaded (built first
    when missing)."""
    return _load() is not None


class PySeqlockWindow:
    """Numpy-over-mmap seqlock with exchange.cpp's memory layout: int64
    {seq, write_id, length} header then `length` float64s.  Writers
    bump seq to odd, copy the payload, store the write_id (the next one
    when None; KILL=-1 from send_kill) and bump seq back to even;
    readers retry while seq is odd or moved under the copy."""

    KILL = -1
    _HDR = 24                       # 3 x int64, struct Header

    def __init__(self, length: int, path: str | None = None,
                 reset: bool = False):
        if length <= 0:
            raise ValueError("window length must be positive")
        self.length = int(length)
        nbytes = self._HDR + 8 * self.length
        self._fd = -1
        if path is None:
            self._mm = mmap.mmap(-1, nbytes)
            fresh = True
        else:
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
            st = os.fstat(fd).st_size
            fresh = st == 0
            if fresh:
                os.ftruncate(fd, nbytes)
            elif st != nbytes:
                # exch_create refuses a file whose size disagrees with
                # the requested length
                os.close(fd)
                raise RuntimeError("exch_create failed: length mismatch")
            self._mm = mmap.mmap(fd, nbytes)
            self._fd = fd
        self._hdr = np.frombuffer(self._mm, dtype=np.int64, count=3)
        self._data = np.frombuffer(self._mm, dtype=np.float64,
                                   count=self.length, offset=self._HDR)
        if not fresh and self._hdr[2] not in (0, self.length):
            raise RuntimeError("exch_create failed: length mismatch")
        if fresh or self._hdr[2] == 0 or reset:
            self._hdr[0] = 0
            self._hdr[1] = 0
            self._hdr[2] = self.length
        self._lock = threading.Lock()

    @property
    def write_id(self):
        return int(self._hdr[1])

    def write(self, values, write_id=None):
        values = np.ascontiguousarray(values, dtype=np.float64)
        if values.shape != (self.length,):
            raise ValueError(
                f"window expects shape ({self.length},), "
                f"got {values.shape}")
        with self._lock:
            s = int(self._hdr[0])
            self._hdr[0] = s + 1
            self._data[:] = values
            wid = (int(self._hdr[1]) + 1 if write_id is None
                   else int(write_id))
            self._hdr[1] = wid
            self._hdr[0] = s + 2
            return wid

    def read(self):
        while True:
            s0 = int(self._hdr[0])
            if s0 & 1:
                continue
            out = self._data.copy()
            wid = int(self._hdr[1])
            if int(self._hdr[0]) == s0:
                return out, wid

    def send_kill(self):
        with self._lock:
            self._hdr[1] = self.KILL

    def close(self):
        if getattr(self, "_mm", None) is not None:
            # drop the numpy views first: mmap.close raises BufferError
            # while buffer exports are alive
            self._hdr = None
            self._data = None
            self._mm.close()
            self._mm = None
            if self._fd >= 0:
                os.close(self._fd)
                self._fd = -1

    def __del__(self):                                  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeWindow:
    """The C++ seqlock window, with the contract of
    cylinders.spcommunicator.Window; pass `path` for a cross-process
    (mmap file) window.  Raises RuntimeError when the library cannot
    be built or loaded."""

    KILL = -1

    def __init__(self, length: int, path: str | None = None,
                 reset: bool = False):
        """reset=True reinitializes an existing mmap file (the owner
        passes it; attaching readers must not)."""
        lib = _load()
        if lib is None:
            raise RuntimeError(
                f"the native exchange library is unavailable: {_error}")
        self._lib = lib
        self.length = int(length)
        p = path.encode() if path is not None else None
        self._h = lib.exch_create(p, self.length, 1 if reset else 0)
        if not self._h:
            raise RuntimeError("exch_create failed")

    @property
    def write_id(self):
        return int(self._lib.exch_write_id(self._h))

    def write(self, values, write_id=None):
        values = np.ascontiguousarray(values, dtype=np.float64)
        if values.shape != (self.length,):
            raise ValueError(
                f"window expects shape ({self.length},), "
                f"got {values.shape}")
        wid = -1 if write_id is None else int(write_id)
        out = self._lib.exch_write(
            self._h, values.ctypes.data_as(
                ctypes.POINTER(ctypes.c_double)),
            self.length, wid)
        if out == -2:
            raise RuntimeError("native window length mismatch")
        return int(out)

    def read(self):
        out = np.empty(self.length, dtype=np.float64)
        wid = self._lib.exch_read(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            self.length)
        if wid == -2:
            raise RuntimeError("native window length mismatch")
        return out, int(wid)

    def send_kill(self):
        self._lib.exch_kill(self._h)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.exch_close(self._h)
            self._h = None

    def __del__(self):                                  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
