"""Fused PDHG iteration chunk: the CUDA kernel's wrapper, its plain
twin, the variant picker and the launch counters (port of
`mpisppy_tpu/ops/pallas_pdhg.py`).

`fused_chunk` runs `n_steps` PDHG iterations for the whole batch and
returns (x, y, x_sum, y_sum), the contract of the JAX package's
`fused_chunk` (without its TPU tiling arguments):

* on CUDA tensors it launches the hand-written kernel
  `csrc/pdhg_chunk.cu`, built with nvcc into a plain-C shared library
  on first use and loaded with ctypes — or raises;
* on CPU tensors it runs `fused_chunk_reference`, the same arithmetic
  as torch ops.  That is the only reason the twin is ever taken: there
  is no fallback from a failed launch and no move between devices.

A is stored in float32, float64 or bfloat16; the vectors and outputs
are float32 or float64, and a bfloat16 A goes with float32 vectors
(hot_dtype="bf16x": bf16 storage, f32 arithmetic).

`pick_variant` chooses the kernel's tile shape and where it reads A
from (registers, shared or global memory) from (M, N, dtype); it is
plain Python so that the CPU tests reach it.

`launches` counts kernel launches (never twin calls) and
`launch_shapes` counts them by (S, M, N, dtype of A), so a run can show
that its solves went through the kernel and with which shapes.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

#: number of CUDA kernel launches made by `fused_chunk` in this process
launches = 0
#: the same launches by (S, M, N, dtype name of A)
launch_shapes = collections.Counter()

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "pdhg_chunk.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB = None
_LIB_LOCK = threading.Lock()
_SMEM_OPTIN = None
# (dtype of A, dtype of the vectors) -> C entry point
_ENTRY = {(torch.float32, torch.float32): "pdhg_chunk_f32",
          (torch.float64, torch.float64): "pdhg_chunk_f64",
          (torch.bfloat16, torch.float32): "pdhg_chunk_bf16"}
_KIND = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_SOURCES = ("registers", "shared", "global")

#: per-block shared memory an H100 kernel may opt in to (bytes)
H100_SMEM_OPTIN = 232448


@dataclasses.dataclass(frozen=True)
class Variant:
    """One instantiation of the kernel: warp w owns `rows_per_thread`
    consecutive rows, lane l owns `vectors_per_lane` groups of 4
    consecutive columns; A is held in registers (one tile covers the
    whole matrix) or re-read per step from shared or global memory."""
    rows_per_thread: int
    vectors_per_lane: int
    warps: int
    source: str

    @property
    def tile_rows(self):
        return self.rows_per_thread * self.warps

    @property
    def tile_cols(self):
        return 128 * self.vectors_per_lane

    def smem_bytes(self, M, N, compute_bytes, storage_bytes):
        """Dynamic shared memory of one block (csrc `smem_bytes`): the
        state vectors and the (warps, N) reduction buffer, plus A itself
        when it is staged in shared memory."""
        mp = -(-M // self.tile_rows) * self.tile_rows
        np_ = -(-N // self.tile_cols) * self.tile_cols
        b = ((7 + self.warps) * np_ + 4 * mp) * compute_bytes
        if self.source == "shared":
            b += M * N * storage_bytes
        return b


# (rows per thread, column vectors per lane, warps) of the tile held in
# registers (64 x 128: farmer's M=61, N=120 at crops_multiplier=10) and
# of the tile that loops over larger shapes; csrc PDHG_F32_VARIANTS /
# PDHG_F64_VARIANTS instantiate exactly these
_REGISTER_TILE = (8, 1, 8)
_LOOP_TILE = (4, 1, 8)


def compute_dtype(dtype):
    """The arithmetic dtype for A stored in `dtype`."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


@functools.lru_cache(maxsize=None)
def pick_variant(M, N, dtype, smem_optin=H100_SMEM_OPTIN) -> Variant:
    """The kernel variant for an (S, M, N) A stored in `dtype`: the
    register tile when it covers M x N; else the looping tile with A in
    shared memory when it fits `smem_optin` bytes beside the state, else
    with A in global memory.  Raises ValueError when even the state
    vectors exceed the shared-memory limit."""
    if dtype not in _KIND:
        raise TypeError(f"pdhg_chunk: no kernel for A stored in {dtype}")
    cb, sb = compute_dtype(dtype).itemsize, dtype.itemsize
    v = Variant(*_REGISTER_TILE, "registers")
    if M > v.tile_rows or N > v.tile_cols:
        v = Variant(*_LOOP_TILE, "shared")
        if v.smem_bytes(M, N, cb, sb) > smem_optin:
            v = Variant(*_LOOP_TILE, "global")
    if v.smem_bytes(M, N, cb, sb) > smem_optin:
        raise ValueError(f"pdhg_chunk cannot launch at M={M}, N={N}: its "
                         f"state needs {v.smem_bytes(M, N, cb, sb)} bytes "
                         f"of shared memory, the limit is {smem_optin}")
    return v


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path() -> Path:
    """Where the built library lives: keyed by a hash of the source
    and the compiler flags, so an edited source rebuilds."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libpdhg_chunk_{h.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    """nvcc's output for the library (ptxas: registers, spills and
    shared memory of every instantiated kernel)."""
    return library_path().with_suffix(".log")


def build():
    """Compile the kernel source into the shared library (no-op when
    the library for this source hash exists).  Returns its path.
    Raises RuntimeError with nvcc's stderr when the build fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {_SRC.name}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}")
    build_log_path().write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load_library():
    """The ctypes handle of the built library (building it first)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            ptr = ctypes.c_void_p
            for name in _ENTRY.values():
                fn = getattr(lib, name)
                fn.argtypes = [ptr] * 15 + [ctypes.c_int] * 8 + [ptr]
                fn.restype = ctypes.c_int
            lib.pdhg_chunk_occupancy.argtypes = [ctypes.c_int] * 7
            lib.pdhg_chunk_occupancy.restype = ctypes.c_int
            lib.pdhg_chunk_smem_optin.argtypes = []
            lib.pdhg_chunk_smem_optin.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def smem_optin():
    """The current card's per-block shared-memory opt-in limit (bytes).
    Needs the CUDA library."""
    global _SMEM_OPTIN
    if _SMEM_OPTIN is None:
        got = load_library().pdhg_chunk_smem_optin()
        if got < 0:
            raise RuntimeError("pdhg_chunk: cannot query the CUDA device")
        _SMEM_OPTIN = got
    return _SMEM_OPTIN


def occupancy(M, N, dtype):
    """(variant, resident blocks per SM) of the kernel for an (S, M, N)
    A stored in `dtype` on the current card.  Needs the CUDA library."""
    v = pick_variant(M, N, dtype, smem_optin())
    got = load_library().pdhg_chunk_occupancy(
        _KIND[dtype], v.rows_per_thread, v.vectors_per_lane, v.warps,
        _SOURCES.index(v.source), int(M), int(N))
    if got < 0:
        raise RuntimeError(f"pdhg_chunk occupancy query failed: CUDA error "
                           f"{-got}")
    return v, got


def _check(A, cs, qs, lb, ub, rlo, rhi, x, y, tau, sigma, n_steps):
    ts = {"A": A, "cs": cs, "qs": qs, "lb": lb, "ub": ub, "rlo": rlo,
          "rhi": rhi, "x": x, "y": y, "tau": tau, "sigma": sigma}
    for k, t in ts.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"fused_chunk: {k} must be a tensor")
    if A.dim() != 3:
        raise ValueError(f"fused_chunk: A must be (S, M, N), got "
                         f"{tuple(A.shape)}")
    S, M, N = A.shape
    want = {"cs": (S, N), "qs": (S, N), "lb": (S, N), "ub": (S, N),
            "x": (S, N), "rlo": (S, M), "rhi": (S, M), "y": (S, M),
            "tau": (S,), "sigma": (S,)}
    for k, shp in want.items():
        if tuple(ts[k].shape) != shp:
            raise ValueError(f"fused_chunk: {k} must be {shp}, got "
                             f"{tuple(ts[k].shape)}")
    if A.dtype == torch.bfloat16:
        if cs.dtype != torch.float32:
            raise TypeError(f"fused_chunk: a bfloat16 A takes float32 "
                            f"vectors, got {cs.dtype}")
    elif A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_chunk: dtype must be float32 or float64 "
                        f"(or a bfloat16 A with float32 vectors), got "
                        f"{A.dtype}")
    dt = compute_dtype(A.dtype)
    dev = A.device
    for k, t in ts.items():
        if k != "A" and t.dtype != dt:
            raise TypeError(f"fused_chunk: {k} is {t.dtype}, A is "
                            f"{A.dtype}; all inputs must share one dtype")
        if t.device != dev:
            raise ValueError(f"fused_chunk: {k} is on {t.device}, A is on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"fused_chunk: {k} must be contiguous")
    if int(n_steps) != n_steps or n_steps < 0:
        raise ValueError(f"fused_chunk: n_steps must be a non-negative "
                         f"int, got {n_steps!r}")
    if max(S, M, N, n_steps) >= 2 ** 31:
        raise ValueError("fused_chunk: sizes must fit a 32-bit int")


def _proj_box(x, lb, ub):
    """clip(x, lb, ub) as min(max(x, lb), ub): exact with +-inf bounds
    (ops/pdhg.py `_proj_box` of the JAX package)."""
    return torch.minimum(torch.maximum(x, lb), ub)


def _dual_prox(v, sigma, lo, hi):
    """prox of the support function of [lo, hi]:
    v - sigma * proj_[lo,hi](v / sigma), safe with +-inf bounds
    (ops/pdhg.py `_dual_prox` of the JAX package)."""
    s2 = sigma[:, None]
    return v - s2 * _proj_box(v / s2, lo, hi)


def fused_chunk_reference(A, cs, qs, lb, ub, rlo, rhi, x, y, tau, sigma,
                          n_steps):
    """The plain torch-ops twin: the same arithmetic, in the same order,
    as `_chunk_kernel` (ops/pallas_pdhg.py:41-65 of the JAX package).
    A stored below the vectors' precision (bf16) is cast up once, as the
    Pallas body casts its VMEM tile."""
    A = A.to(cs.dtype)
    t2 = tau[:, None]
    xs = torch.zeros_like(x)
    ys = torch.zeros_like(y)
    for _ in range(int(n_steps)):
        grad = cs + qs * x + torch.einsum("smn,sm->sn", A, y)
        xn = _proj_box(x - t2 * grad, lb, ub)
        xt = 2.0 * xn - x
        v = y + sigma[:, None] * torch.einsum("smn,sn->sm", A, xt)
        yn = _dual_prox(v, sigma, rlo, rhi)
        x, y = xn, yn
        xs = xs + xn
        ys = ys + yn
    return x, y, xs, ys


def fused_chunk(A, cs, qs, lb, ub, rlo, rhi, x, y, tau, sigma, n_steps):
    """Run `n_steps` PDHG iterations for the whole batch (solver-space
    inputs; tau/sigma are per-scenario (S,) step sizes).  Returns
    (x, y, x_sum, y_sum) in the vectors' dtype."""
    _check(A, cs, qs, lb, ub, rlo, rhi, x, y, tau, sigma, n_steps)
    if A.device.type == "cpu":
        return fused_chunk_reference(A, cs, qs, lb, ub, rlo, rhi, x, y,
                                     tau, sigma, n_steps)
    if A.device.type != "cuda":
        raise ValueError(f"fused_chunk: unsupported device {A.device}")
    fn = getattr(load_library(), _ENTRY[(A.dtype, cs.dtype)])
    S, M, N = A.shape
    v = pick_variant(M, N, A.dtype, smem_optin())
    xo, xso = torch.empty_like(x), torch.empty_like(x)
    yo, yso = torch.empty_like(y), torch.empty_like(y)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(A.data_ptr(), cs.data_ptr(), qs.data_ptr(), lb.data_ptr(),
                ub.data_ptr(), rlo.data_ptr(), rhi.data_ptr(),
                x.data_ptr(), y.data_ptr(), tau.data_ptr(),
                sigma.data_ptr(), xo.data_ptr(), yo.data_ptr(),
                xso.data_ptr(), yso.data_ptr(), S, M, N, int(n_steps),
                v.rows_per_thread, v.vectors_per_lane, v.warps,
                _SOURCES.index(v.source), stream)
    if rc != 0:
        raise RuntimeError(
            f"pdhg_chunk kernel launch failed: CUDA error {rc} "
            f"(S={S}, M={M}, N={N}, dtype={A.dtype}, {v})")
    global launches
    launches += 1
    launch_shapes[(S, M, N, str(A.dtype).replace("torch.", ""))] += 1
    return xo, yo, xso, yso
