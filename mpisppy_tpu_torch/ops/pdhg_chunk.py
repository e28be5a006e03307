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

The shared and split forms may also hold B matrices, one for each
request of a coalesced group (serve/): an `ir.GroupedA`, or a SplitA
whose shared block is (B, M, N), the S / B consecutive scenarios of a
request reading its matrix (one launch for the whole group; the kernel
reads matrix s / per_base, per_base = S for one matrix).  Their plain
versions loop over the group.

The kernel builds the same per-scenario tile from each form, so the
shared and split forms give the dense kernel's result on
`A.to_dense()` bit for bit.  A is stored in float32, float64 or
bfloat16; the vectors and outputs are float32 or float64, and a
bfloat16 A goes with float32 vectors (hot_dtype="bf16x": bf16 storage,
f32 arithmetic).

The kernel has two parts in one library: a tiled kernel that holds a
64 x 128 tile of A in registers (farmer's shapes), and a cluster kernel
for every larger shape, one scenario per thread-block cluster, with A
resident in its blocks' shared memory or streamed from device memory
once a step.  `pick_variant` chooses between them, and the cluster
size, from (S, M, N, dtype) and the card's occupancy; `pick_route`
whether a solve's chunks go to the kernel at all: a shared or split
operator that one block cannot hold beside its state takes the
solver's matmul route instead (`ops/pdhg.py`), where a matrix product
reuses it across scenarios.  Both are plain Python, so the CPU tests
reach them (with tables of the card's occupancy readings standing in
for its query).

`launches` counts kernel launches (never plain-version calls),
`launch_shapes` the same by (form, S, M, N, dtype of A) and
`variant_launches` by those and the source of A and cluster size,
`grouped_launches` the launches of a group of more than one matrix by
(form, S, M, N, dtype, matrices), so a run can show that its solves went through the kernel, in which forms,
with which shapes and through which of its two kernels (`launches_by`
sums them by form or dtype).  All are bumped under a lock: the wheel's
spoke threads launch concurrently.
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

from ..ir import GroupedA, SparseSplitA, SplitA, grouped_bases

#: number of CUDA kernel launches made by `fused_chunk` in this process
launches = 0
#: the same launches by (form, S, M, N, dtype name of A)
launch_shapes = collections.Counter()
#: the same launches by (form, S, M, N, dtype name of A, source of A,
#: cluster size): which kernel (the tiled one for "registers", the
#: cluster one otherwise) each went through
variant_launches = collections.Counter()
#: the launches whose shared or split form held more than one matrix,
#: by (form, S, M, N, dtype name of A, matrices)
grouped_launches = collections.Counter()
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
_SMS = None
# (dtype of A, dtype of the vectors) -> C entry point
_ENTRY = {(torch.float32, torch.float32): "pdhg_chunk_f32",
          (torch.float64, torch.float64): "pdhg_chunk_f64",
          (torch.bfloat16, torch.float32): "pdhg_chunk_bf16"}
_KIND = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
#: where the kernel holds A (csrc `Src`): the tiled kernel's register
#: tile, or the cluster kernel's band, resident in shared memory or
#: streamed from device memory once a pass
SOURCES = ("registers", "resident", "streamed")
#: operator forms the kernel takes (csrc `Form`)
FORMS = ("dense", "shared", "split")

#: per-block shared memory an H100 kernel may opt in to (bytes)
H100_SMEM_OPTIN = 232448
#: the cluster kernel's threads a block (csrc kClusterThreads) and
#: largest cluster (csrc kMaxCluster)
CLUSTER_THREADS = 256
MAX_CLUSTER = 16
#: a streamed stage holds up to this many bytes of whole rows (at least
#: one, at most STAGE_ROWS: csrc kStageRows), in a ring of STAGES stages
#: (csrc kStages): a pass costs 3-4 us a stage for 1 to 7 rows (NVIDIA
#: H100 80GB HBM3, aircondB's shape, tests/cluster_kernel_witness.py),
#: so the stages are as large as two blocks an SM allow, and one in
#: flight beside the one consumed hides the copy (rings of 3 or 4
#: stages of fewer rows were slower there)
STAGE_BYTES = 45 * 1024
STAGE_ROWS = 8
STAGES = 2
#: a cluster gives each block at least this many rows (one a warp)
MIN_BAND_ROWS = 8
#: what a step of a cluster of more than one block costs beyond its
#: band (two cluster barriers, the x~ gather, the peers' sums), in band
#: rows: fitted on an NVIDIA H100 80GB HBM3 (700 W) to the cluster
#: kernel's times over C = 1..16 (tests/cluster_kernel_witness.py; fits
#: of 33 to 97 rows across its shapes)
CLUSTER_STEP_ROWS = 64


def _r16(b):
    return -(-b // 16) * 16


@dataclasses.dataclass(frozen=True)
class Variant:
    """One launch of the kernel.  source "registers": the tiled kernel,
    one block per scenario, warp w owning `rows_per_thread` consecutive
    rows and lane l `vectors_per_lane` groups of 4 consecutive columns of
    a tile held in registers.  "resident" / "streamed": the cluster
    kernel, one scenario per cluster of `cluster` blocks, each block's
    band of rows held in its shared memory or streamed through a ring
    of STAGES stages of `stage_rows` rows."""
    source: str
    cluster: int = 1
    stage_rows: int = 0
    rows_per_thread: int = 8
    vectors_per_lane: int = 1
    warps: int = 8

    @property
    def tile_rows(self):
        return self.rows_per_thread * self.warps

    @property
    def tile_cols(self):
        return 128 * self.vectors_per_lane

    def smem_bytes(self, M, N, compute_bytes, storage_bytes,
                   form="dense"):
        """Dynamic shared memory of one block (csrc `smem_bytes` and
        `cluster_layout`).  Registers: the state over the padded tile,
        the (warps, N) reduction buffer, and the split form's per-thread
        delta patch.  Cluster: the streamed source's ring, x~ (N), the
        partial A^T y (max(N, threads)), the column slice's six vectors,
        the band's four, the streamed dot's (8, STAGE_ROWS) partials,
        and the resident source's band of A."""
        cb, sb = compute_bytes, storage_bytes
        if self.source == "registers":
            mp = -(-M // self.tile_rows) * self.tile_rows
            np_ = -(-N // self.tile_cols) * self.tile_cols
            b = ((7 + self.warps) * np_ + 4 * mp) * cb
            if form == "split":
                b += (32 * self.warps * self.rows_per_thread
                      * self.vectors_per_lane * 4 * cb)
            return b
        C = self.cluster
        nc, mb = -(-N // C), -(-M // C)
        b = 0
        if self.source == "streamed":
            b += STAGES * _r16(self.stage_rows * N * sb + 16)
        red = 8 * STAGE_ROWS if self.source == "streamed" else 0
        b += _r16((N + max(N, CLUSTER_THREADS) + 6 * nc + 4 * mb + red)
                  * cb)
        if self.source == "resident":
            b += _r16(mb * N * sb)
        return b


#: the tile held in registers (64 x 128: farmer's M=61, N=120 at
#: crops_multiplier=10); csrc PDHG_F32_VARIANTS / PDHG_F64_VARIANTS
#: instantiate exactly this one
REGISTER_TILE = Variant("registers")


def compute_dtype(dtype):
    """The arithmetic dtype for A stored in `dtype`."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _streamed(C, M, N, cb, sb, smem_optin):
    """The streamed variant at cluster size C: STAGES stages of whole
    rows up to STAGE_BYTES (1 to STAGE_ROWS rows), fewer rows while a
    block would exceed `smem_optin`; None when stages of one row do not
    fit."""
    for rows in range(max(1, min(STAGE_ROWS, STAGE_BYTES // (N * sb))),
                      0, -1):
        v = Variant("streamed", C, rows)
        if v.smem_bytes(M, N, cb, sb) <= smem_optin:
            return v
    return None


@functools.lru_cache(maxsize=None)
def pick_variant(S, M, N, dtype, smem_optin, n_sm, occupancy_of) -> Variant:
    """The kernel variant for S scenarios of an (M, N) A stored in
    `dtype` (the same for every form, so that the forms stay bit-equal):

    * the register tile when it covers M x N;
    * else the cluster kernel, A resident in its blocks' shared memory
      where a band fits beside the state at some cluster size, else
      streamed.  Cluster sizes run from 1 to min(MAX_CLUSTER, M //
      MIN_BAND_ROWS).  The smallest that fits where S clusters of it
      fill the card (S C >= n_sm) with two blocks or more an SM: there
      each block's step is bound by its own latency, which cluster
      traffic only lengthens.  Else the size that minimises rounds x
      (rows a block + CLUSTER_STEP_ROWS for C > 1), rounds = ceil(S /
      clusters held at once), ties to the smaller; the occupancy comes
      from `occupancy_of(variant, M, N, dtype)` -> (blocks per SM,
      clusters held at once): the card's query (`card_variant`), or a
      table of its readings in the CPU tests.

    Raises ValueError when no variant's state fits `smem_optin` bytes a
    block."""
    if dtype not in _KIND:
        raise TypeError(f"pdhg_chunk: no kernel for A stored in {dtype}")
    cb, sb = compute_dtype(dtype).itemsize, dtype.itemsize
    if M <= REGISTER_TILE.tile_rows and N <= REGISTER_TILE.tile_cols:
        need = REGISTER_TILE.smem_bytes(M, N, cb, sb)
        if need > smem_optin:
            raise ValueError(f"pdhg_chunk cannot launch at M={M}, N={N}: "
                             f"its state needs {need} bytes of shared "
                             f"memory, the limit is {smem_optin}")
        return REGISTER_TILE
    sizes = range(1, min(MAX_CLUSTER, max(1, M // MIN_BAND_ROWS)) + 1)
    pool = [Variant("resident", C) for C in sizes
            if Variant("resident", C).smem_bytes(M, N, cb, sb) <= smem_optin]
    if not pool:
        pool = [v for v in (_streamed(C, M, N, cb, sb, smem_optin)
                            for C in sizes) if v is not None]
    if not pool:
        raise ValueError(f"pdhg_chunk cannot launch at M={M}, N={N}: the "
                         f"cluster kernel's state needs more than "
                         f"{smem_optin} bytes of shared memory a block at "
                         f"every cluster size")
    best, best_cost = None, None
    for v in pool:
        blocks, held = occupancy_of(v, M, N, dtype)
        if held < 1:
            continue
        if best is None and S * v.cluster >= n_sm and blocks >= 2:
            return v
        rows = -(-M // v.cluster) + (CLUSTER_STEP_ROWS if v.cluster > 1
                                     else 0)
        cost = -(-S // held) * rows
        if best_cost is None or cost < best_cost:
            best, best_cost = v, cost
    if best is None:
        raise ValueError(f"pdhg_chunk cannot launch at M={M}, N={N}: no "
                         f"cluster size fits on the card")
    return best


def operator_form(A, S):
    """The form of a chunk operator for a batch of S scenarios:
    "dense" ((S, M, N) with S > 1), "shared" (any (1, M, N) tensor, S = 1
    included: the form follows the operator's shape, so a shared matrix
    beyond the tile takes the matmul route whatever number of scenarios
    is left to solve on it; and a coalesced group's GroupedA), "split"
    (a dense-shared SplitA) or "sparse" (a SparseSplitA, which only the
    matmul route takes)."""
    if isinstance(A, SparseSplitA):
        return "sparse"
    if isinstance(A, SplitA):
        return "split"
    if isinstance(A, GroupedA) or (A.dim() == 3 and A.shape[0] == 1):
        return "shared"
    return "dense"


def route_state_bytes(M, N, dtype):
    """The block state that the route rule charges beyond the register
    tile: 15 values a column over columns padded to 128 and 4 values a
    row over rows padded to 32, in the compute type (the state of the
    kernel's first shared-memory sources, kept as the rule's limit so
    that no route changed when the cluster kernel replaced them)."""
    cb = compute_dtype(dtype).itemsize
    return (15 * (-(-N // 128) * 128) + 4 * (-(-M // 32) * 32)) * cb


def pick_route(form, M, N, dtype, smem_optin=H100_SMEM_OPTIN):
    """"kernel" or "matmul": where a solve runs the chunks of an
    operator of `form` with M rows and N columns stored in `dtype`.  A
    shape within the register tile takes the kernel.  Beyond it: a dense
    per-scenario A takes the kernel while `route_state_bytes` fits
    `smem_optin`, the matmul route beyond; a shared or split A takes the
    kernel while one block holds its whole matrix beside that state, and
    the matmul route otherwise, where a matrix product reuses the
    shared matrix across scenarios.  A sparse shared block always takes
    the matmul route (torch's sparse product)."""
    if form not in FORMS + ("sparse",):
        raise ValueError(f"pick_route: unknown operator form {form!r}")
    if form == "sparse":
        return "matmul"
    if dtype not in _KIND:
        raise TypeError(f"pdhg_chunk: no kernel for A stored in {dtype}")
    cb, sb = compute_dtype(dtype).itemsize, dtype.itemsize
    if M <= REGISTER_TILE.tile_rows and N <= REGISTER_TILE.tile_cols:
        fits = REGISTER_TILE.smem_bytes(M, N, cb, sb) <= smem_optin
        return "kernel" if fits else "matmul"
    state = route_state_bytes(M, N, dtype)
    if form != "dense":
        state += M * N * sb
    return "kernel" if state <= smem_optin else "matmul"


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
                fn.argtypes = ([ptr] * 4 + [cint] * 3 + [ptr] * 14
                               + [cint] * 10 + [ptr])
                fn.restype = ctypes.c_int
            lib.pdhg_chunk_occupancy.argtypes = [cint] * 10 + [ptr]
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


def sm_count():
    """The current card's SM count."""
    global _SMS
    if _SMS is None:
        _SMS = torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    return _SMS


def variant_occupancy(v, M, N, dtype, form="dense"):
    """(blocks per SM, clusters held at once) of variant `v` of `form`
    at (M, N) in `dtype` on the current card: the CUDA occupancy
    queries (cudaOccupancyMaxActiveClusters for the cluster kernel; SMs
    x blocks per SM for the tiled one).  Needs the CUDA library."""
    out = (ctypes.c_int * 2)()
    rc = load_library().pdhg_chunk_occupancy(
        _KIND[dtype], FORMS.index(form), v.rows_per_thread,
        v.vectors_per_lane, v.warps, SOURCES.index(v.source), int(M),
        int(N), v.cluster, v.stage_rows, out)
    if rc != 0:
        raise RuntimeError(f"pdhg_chunk occupancy query failed: CUDA error "
                           f"{rc} ({v}, M={M}, N={N}, {dtype})")
    return out[0], out[1]


def card_variant(S, M, N, dtype):
    """pick_variant on the current card: its shared-memory limit, SM
    count and cluster occupancy."""
    return pick_variant(S, M, N, dtype, smem_optin(), sm_count(),
                        variant_occupancy)


def occupancy(S, M, N, dtype, form="dense"):
    """(variant, blocks per SM, clusters held at once) of the kernel
    for S scenarios of an (M, N) A of `form` stored in `dtype` on the
    current card.  Needs the CUDA library."""
    v = card_variant(S, M, N, dtype)
    return (v, *variant_occupancy(v, M, N, dtype, form))


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
        if A.shared.dim() not in (2, 3) or A.rows.dim() != 1 \
                or A.cols.shape != A.rows.shape \
                or tuple(A.vals.shape) != (S, A.rows.shape[0]) \
                or S % A.bases:
            raise ValueError("fused_chunk: a SplitA needs shared (M, N) "
                             "or (B, M, N) with B dividing S, rows and "
                             "cols (nnz,) and vals (S, nnz)")
        if A.rows.dtype != torch.int32 or A.cols.dtype != torch.int32:
            raise TypeError("fused_chunk: SplitA rows and cols must be "
                            "int32")
        if A.vals.dtype != A.shared.dtype:
            raise TypeError("fused_chunk: SplitA vals and shared must "
                            "share one dtype")
        ts.update(shared=A.shared, rows=A.rows, cols=A.cols, vals=A.vals)
    elif isinstance(A, GroupedA):
        if not isinstance(A.stack, torch.Tensor) or A.stack.dim() != 3 \
                or A.shape[0] != S:
            raise ValueError(f"fused_chunk: a GroupedA needs a (B, M, N) "
                             f"stack with B * per_base = S = {S}")
        ts["A"] = A.stack
    else:
        if not isinstance(A, torch.Tensor):
            raise TypeError("fused_chunk: A must be a tensor, a GroupedA "
                            "or a SplitA")
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


def _per_group(one, A, base_of, vectors, n_steps):
    """A grouped form's plain version: `one` (the single-matrix plain
    version) on each request's matrix `base_of(A, b)` and its rows of
    the vectors, the outputs stacked back in order."""
    S = vectors[0].shape[0]
    B = grouped_bases(A, S)
    pb = S // B
    outs = [one(base_of(A, b), *[v[b * pb:(b + 1) * pb] for v in vectors],
                n_steps) for b in range(B)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def fused_chunk_shared_reference(A, cs, qs, lb, ub, rlo, rhi, x, y, tau,
                                 sigma, n_steps):
    """The plain version of the shared form: one (1, M, N) A for every
    scenario, run as the dense plain version on its broadcast; a
    GroupedA runs that on each request's matrix."""
    vectors = (cs, qs, lb, ub, rlo, rhi, x, y, tau, sigma)
    if isinstance(A, GroupedA):
        return _per_group(fused_chunk_shared_reference, A,
                          lambda a, b: a.stack[b:b + 1], vectors, n_steps)
    S = cs.shape[0]
    return fused_chunk_reference(A.expand((S,) + tuple(A.shape[1:])),
                                 *vectors, n_steps)


def fused_chunk_split_reference(A, cs, qs, lb, ub, rlo, rhi, x, y, tau,
                                sigma, n_steps):
    """The plain version of the split form: the dense plain version on
    `A.to_dense()`, the per-scenario matrices the kernel assembles in
    its tile; a group's SplitA runs that on each request's part."""
    vectors = (cs, qs, lb, ub, rlo, rhi, x, y, tau, sigma)
    if A.bases > 1:
        pb = A.per_base
        return _per_group(
            fused_chunk_split_reference, A,
            lambda a, b: dataclasses.replace(
                a, shared=a.shared[b], vals=a.vals[b * pb:(b + 1) * pb]),
            vectors, n_steps)
    return fused_chunk_reference(A.to_dense(), *vectors, n_steps)


#: each form's plain version
REFERENCE = {"dense": fused_chunk_reference,
             "shared": fused_chunk_shared_reference,
             "split": fused_chunk_split_reference}


def _check_variant(v, M, N, dtype):
    """Raise ValueError unless variant `v` can launch at (M, N) in
    `dtype` on the current card."""
    if v.source not in SOURCES:
        raise ValueError(f"fused_chunk: unknown source {v.source!r}")
    cb, sb = compute_dtype(dtype).itemsize, dtype.itemsize
    if v.source == "registers":
        ok = (v == REGISTER_TILE and M <= v.tile_rows
              and N <= v.tile_cols)
    else:
        ok = 1 <= v.cluster <= MAX_CLUSTER and (
            v.source == "resident" or 1 <= v.stage_rows <= STAGE_ROWS)
    if not ok or v.smem_bytes(M, N, cb, sb, "split") > smem_optin():
        raise ValueError(f"fused_chunk: {v} cannot launch at M={M}, "
                         f"N={N} in {dtype}")


def fused_chunk(A, cs, qs, lb, ub, rlo, rhi, x, y, tau, sigma, n_steps,
                variant=None):
    """Run `n_steps` PDHG iterations for the whole batch (solver-space
    inputs; tau/sigma are per-scenario (S,) step sizes).  A is dense
    (S, M, N), shared (1, M, N), a GroupedA or a SplitA.  Returns (x, y, x_sum,
    y_sum) in the vectors' dtype.  `variant` (measurement and tests
    only) launches that variant instead of `pick_variant`'s, or raises
    when it cannot launch at these shapes."""
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
    if variant is None:
        v = card_variant(S, M, N, A.dtype)
    else:
        _check_variant(variant, M, N, A.dtype)
        v = variant
    if form == "split":
        ptrs = (A.shared.data_ptr(), A.rows.data_ptr(), A.cols.data_ptr(),
                A.vals.data_ptr())
        nnz = A.rows.shape[0]
    else:
        stack = A.stack if isinstance(A, GroupedA) else A
        ptrs, nnz = (stack.data_ptr(), None, None, None), 0
    # the shared and split forms read matrix s / per_base: per_base = S
    # for one matrix (the dense form does not read it)
    bases = grouped_bases(A, S)
    per_base = S // bases if form != "dense" else S
    xo, xso = torch.empty_like(x), torch.empty_like(x)
    yo, yso = torch.empty_like(y), torch.empty_like(y)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(*ptrs, nnz, FORMS.index(form), per_base, cs.data_ptr(),
                qs.data_ptr(), lb.data_ptr(), ub.data_ptr(),
                rlo.data_ptr(), rhi.data_ptr(), x.data_ptr(), y.data_ptr(),
                tau.data_ptr(), sigma.data_ptr(), xo.data_ptr(),
                yo.data_ptr(), xso.data_ptr(), yso.data_ptr(), S, M, N,
                int(n_steps), v.rows_per_thread, v.vectors_per_lane,
                v.warps, SOURCES.index(v.source), v.cluster, v.stage_rows,
                stream)
    if rc != 0:
        raise RuntimeError(
            f"pdhg_chunk kernel launch failed: CUDA error {rc} "
            f"({form}, S={S}, M={M}, N={N}, dtype={A.dtype}, {v})")
    global launches
    dname = str(A.dtype).replace("torch.", "")
    with _COUNT_LOCK:
        launches += 1
        launch_shapes[(form, S, M, N, dname)] += 1
        variant_launches[(form, S, M, N, dname, v.source, v.cluster)] += 1
        if form != "dense" and bases > 1:
            grouped_launches[(form, S, M, N, dname, bases)] += 1
    return xo, yo, xso, yso
