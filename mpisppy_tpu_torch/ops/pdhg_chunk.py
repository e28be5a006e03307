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

The operator A comes in one of three forms (`operator_form`), each
with its own plain version beside it:

* "dense": a per-scenario (S, M, N) tensor (`fused_chunk_reference`);
* "shared": one (1, M, N) matrix for every scenario
  (`fused_chunk_shared_reference`);
* "split": an `ir.SplitA`, a shared (M, N) block plus per-scenario
  deltas at (rows, cols) (`fused_chunk_split_reference`).

The kernel builds the same per-scenario tile from each form, so the
shared and split forms give the dense kernel's result on
`A.to_dense()` bit for bit.  A is stored in float32, float64 or
bfloat16; the vectors and outputs are float32 or float64, and a
bfloat16 A goes with float32 vectors (hot_dtype="bf16x": bf16 storage,
f32 arithmetic).

`pick_variant` chooses the kernel's tile shape and where it reads A
from (registers, shared or global memory) from (M, N, dtype), and
`pick_route` whether a solve's chunks go to the kernel at all: a shared
or split operator too large for a tile held in registers or shared
memory takes the solver's matmul route instead (`ops/pdhg.py`), since
the kernel's global-memory source would re-read the shared matrix once
per block per step.  Both are plain Python, so the CPU tests reach
them.

`launches` counts kernel launches (never plain-version calls) and
`launch_shapes` the same by (form, S, M, N, dtype of A), so a run can
show that its solves went through the kernel, in which forms and with
which shapes (`launches_by` sums them by form or dtype).  Both are
bumped under a lock: the wheel's spoke threads launch concurrently.
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

from ..ir import SparseSplitA, SplitA

#: number of CUDA kernel launches made by `fused_chunk` in this process
launches = 0
#: the same launches by (form, S, M, N, dtype name of A)
launch_shapes = collections.Counter()
# the wheel's threads mode launches from several host threads at once;
# a bare `+= 1` can lose counts there
_COUNT_LOCK = threading.Lock()

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
#: operator forms the kernel takes (csrc `Form`)
FORMS = ("dense", "shared", "split")

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

    def smem_bytes(self, M, N, compute_bytes, storage_bytes,
                   form="dense"):
        """Dynamic shared memory of one block (csrc `smem_bytes`): the
        state vectors and the (warps, N) reduction buffer, plus A itself
        when it is staged in shared memory, or the split form's
        per-thread delta patch beside a register tile."""
        mp = -(-M // self.tile_rows) * self.tile_rows
        np_ = -(-N // self.tile_cols) * self.tile_cols
        b = ((7 + self.warps) * np_ + 4 * mp) * compute_bytes
        if self.source == "shared":
            b += M * N * storage_bytes
        elif self.source == "registers" and form == "split":
            b += (32 * self.warps * self.rows_per_thread
                  * self.vectors_per_lane * 4 * compute_bytes)
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


def operator_form(A, S):
    """The form of a chunk operator for a batch of S scenarios:
    "dense" ((S, M, N) with S > 1), "shared" (any (1, M, N) tensor, S = 1
    included: the form follows the operator's shape, so a shared matrix
    beyond the tile takes the matmul route whatever number of scenarios
    is left to solve on it), "split" (a dense-shared SplitA) or "sparse"
    (a SparseSplitA, which only the matmul route takes)."""
    if isinstance(A, SparseSplitA):
        return "sparse"
    if isinstance(A, SplitA):
        return "split"
    if A.dim() == 3 and A.shape[0] == 1:
        return "shared"
    return "dense"


def pick_route(form, M, N, dtype, smem_optin=H100_SMEM_OPTIN):
    """"kernel" or "matmul": where a solve runs the chunks of an
    operator of `form` with M rows and N columns stored in `dtype`.  A
    dense per-scenario A takes the kernel whenever it can launch (any
    source of A); its state beyond the shared-memory limit takes the
    matmul route.  A shared or split A takes the kernel when
    `pick_variant` holds its tile in registers or shared memory, and
    the matmul route otherwise: there the kernel would read the shared
    matrix from device memory once per block per step (S x M x N x
    bytes a step), where a matrix product reuses it.  A sparse shared
    block always takes the matmul route (torch's sparse product)."""
    if form not in FORMS + ("sparse",):
        raise ValueError(f"pick_route: unknown operator form {form!r}")
    if form == "sparse":
        return "matmul"
    try:
        v = pick_variant(M, N, dtype, smem_optin)
    except ValueError:
        return "matmul"
    if form == "dense":
        return "kernel"
    return "kernel" if v.source in ("registers", "shared") else "matmul"


def launches_by(key):
    """Kernel launches in `launch_shapes` summed by "form", "dtype" or
    "form/dtype" (e.g. {"split/float32": 12})."""
    out = collections.Counter()
    for (form, _, _, _, dt), n in launch_shapes.items():
        out[{"form": form, "dtype": dt,
             "form/dtype": f"{form}/{dt}"}[key]] += n
    return dict(out)


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
            ptr, cint = ctypes.c_void_p, ctypes.c_int
            for name in _ENTRY.values():
                fn = getattr(lib, name)
                fn.argtypes = ([ptr] * 4 + [cint] * 2 + [ptr] * 14
                               + [cint] * 8 + [ptr])
                fn.restype = ctypes.c_int
            lib.pdhg_chunk_occupancy.argtypes = [ctypes.c_int] * 8
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


def occupancy(M, N, dtype, form="dense"):
    """(variant, resident blocks per SM) of the kernel for an (S, M, N)
    A of `form` stored in `dtype` on the current card.  Needs the CUDA
    library."""
    v = pick_variant(M, N, dtype, smem_optin())
    got = load_library().pdhg_chunk_occupancy(
        _KIND[dtype], FORMS.index(form), v.rows_per_thread,
        v.vectors_per_lane, v.warps, _SOURCES.index(v.source), int(M),
        int(N))
    if got < 0:
        raise RuntimeError(f"pdhg_chunk occupancy query failed: CUDA error "
                           f"{-got}")
    return v, got


def _check(A, cs, qs, lb, ub, rlo, rhi, x, y, tau, sigma, n_steps):
    """Validate the inputs; returns the operator's form."""
    ts = {"cs": cs, "qs": qs, "lb": lb, "ub": ub, "rlo": rlo, "rhi": rhi,
          "x": x, "y": y, "tau": tau, "sigma": sigma}
    for k, t in ts.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"fused_chunk: {k} must be a tensor")
    if cs.dim() != 2:
        raise ValueError(f"fused_chunk: cs must be (S, N), got "
                         f"{tuple(cs.shape)}")
    S = cs.shape[0]
    if isinstance(A, SparseSplitA):
        raise TypeError("fused_chunk: a SparseSplitA takes the solver's "
                        "matmul route, not the kernel")
    if isinstance(A, SplitA):
        for k in ("shared", "rows", "cols", "vals"):
            if not isinstance(getattr(A, k), torch.Tensor):
                raise TypeError(f"fused_chunk: A.{k} must be a tensor")
        if A.shared.dim() != 2 or A.rows.dim() != 1 \
                or A.cols.shape != A.rows.shape \
                or tuple(A.vals.shape) != (S, A.rows.shape[0]):
            raise ValueError("fused_chunk: a SplitA needs shared (M, N), "
                             "rows and cols (nnz,) and vals (S, nnz)")
        if A.rows.dtype != torch.int32 or A.cols.dtype != torch.int32:
            raise TypeError("fused_chunk: SplitA rows and cols must be "
                            "int32")
        if A.vals.dtype != A.shared.dtype:
            raise TypeError("fused_chunk: SplitA vals and shared must "
                            "share one dtype")
        ts.update(shared=A.shared, rows=A.rows, cols=A.cols, vals=A.vals)
    else:
        if not isinstance(A, torch.Tensor):
            raise TypeError("fused_chunk: A must be a tensor or a SplitA")
        if A.dim() != 3 or A.shape[0] not in (1, S):
            raise ValueError(f"fused_chunk: A must be (S, M, N) or "
                             f"(1, M, N), got {tuple(A.shape)}")
        ts["A"] = A
    form = operator_form(A, S)
    _, M, N = A.shape
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
        if k not in ("A", "shared", "vals", "rows", "cols") \
                and t.dtype != dt:
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
    return form


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


def fused_chunk_shared_reference(A, cs, qs, lb, ub, rlo, rhi, x, y, tau,
                                 sigma, n_steps):
    """The plain version of the shared form: one (1, M, N) A for every
    scenario, run as the dense plain version on its broadcast."""
    S = cs.shape[0]
    return fused_chunk_reference(A.expand((S,) + tuple(A.shape[1:])), cs,
                                 qs, lb, ub, rlo, rhi, x, y, tau, sigma,
                                 n_steps)


def fused_chunk_split_reference(A, cs, qs, lb, ub, rlo, rhi, x, y, tau,
                                sigma, n_steps):
    """The plain version of the split form: the dense plain version on
    `A.to_dense()`, the per-scenario matrices the kernel assembles in
    its tile."""
    return fused_chunk_reference(A.to_dense(), cs, qs, lb, ub, rlo, rhi,
                                 x, y, tau, sigma, n_steps)


#: each form's plain version
REFERENCE = {"dense": fused_chunk_reference,
             "shared": fused_chunk_shared_reference,
             "split": fused_chunk_split_reference}


def fused_chunk(A, cs, qs, lb, ub, rlo, rhi, x, y, tau, sigma, n_steps):
    """Run `n_steps` PDHG iterations for the whole batch (solver-space
    inputs; tau/sigma are per-scenario (S,) step sizes).  A is dense
    (S, M, N), shared (1, M, N) or a SplitA.  Returns (x, y, x_sum,
    y_sum) in the vectors' dtype."""
    form = _check(A, cs, qs, lb, ub, rlo, rhi, x, y, tau, sigma, n_steps)
    if A.device.type == "cpu":
        return REFERENCE[form](A, cs, qs, lb, ub, rlo, rhi, x, y, tau,
                               sigma, n_steps)
    if A.device.type != "cuda":
        raise ValueError(f"fused_chunk: unsupported device {A.device}")
    S, (_, M, N) = cs.shape[0], A.shape
    if pick_route(form, M, N, A.dtype, smem_optin()) != "kernel":
        raise ValueError(f"fused_chunk: a {form} A of {M} x {N} in "
                         f"{A.dtype} takes the solver's matmul route")
    fn = getattr(load_library(), _ENTRY[(A.dtype, cs.dtype)])
    v = pick_variant(M, N, A.dtype, smem_optin())
    if form == "split":
        ptrs = (A.shared.data_ptr(), A.rows.data_ptr(), A.cols.data_ptr(),
                A.vals.data_ptr())
        nnz = A.rows.shape[0]
    else:
        ptrs, nnz = (A.data_ptr(), None, None, None), 0
    xo, xso = torch.empty_like(x), torch.empty_like(x)
    yo, yso = torch.empty_like(y), torch.empty_like(y)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(*ptrs, nnz, FORMS.index(form), cs.data_ptr(),
                qs.data_ptr(), lb.data_ptr(), ub.data_ptr(),
                rlo.data_ptr(), rhi.data_ptr(), x.data_ptr(), y.data_ptr(),
                tau.data_ptr(), sigma.data_ptr(), xo.data_ptr(),
                yo.data_ptr(), xso.data_ptr(), yso.data_ptr(), S, M, N,
                int(n_steps), v.rows_per_thread, v.vectors_per_lane,
                v.warps, _SOURCES.index(v.source), stream)
    if rc != 0:
        raise RuntimeError(
            f"pdhg_chunk kernel launch failed: CUDA error {rc} "
            f"({form}, S={S}, M={M}, N={N}, dtype={A.dtype}, {v})")
    global launches
    with _COUNT_LOCK:
        launches += 1
        launch_shapes[(form, S, M, N,
                       str(A.dtype).replace("torch.", ""))] += 1
    return xo, yo, xso, yso
