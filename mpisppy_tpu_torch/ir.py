"""Array problem IR (port of `mpisppy_tpu/ir.py`).

A scenario is lowered once to dense arrays

    minimize   c @ x + 0.5 * x @ diag(qdiag) @ x + obj_const
    subject to row_lo <= A @ x <= row_hi
               lb <= x <= ub

and S scenarios are stacked into a `ScenarioBatch` of tensors with a
leading scenario axis.  Dataclasses of tensors take the place of the
JAX pytrees.  A batch's constraint operator takes one of four forms:
dense per-scenario (S, M, N), shared (1, M, N), `SplitA` (a shared
(M, N) block plus a sparse per-scenario delta) and `SparseSplitA`
(the same with the shared block in sparse CSR storage).

Not ported yet (ROADMAP queue A): `stack_scenarios` and
`pad_scenarios`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from . import not_ported


@dataclasses.dataclass(frozen=True)
class TreeInfo:
    """Scenario-tree metadata for one batch (ir.py:41-67 of the JAX
    package).  node_of[s, j] is the global node id owning nonant slot j
    of scenario s; for a two-stage problem every entry is 0 (ROOT)."""

    node_of: Any            # (S, K) int64 tensor
    prob: Any               # (S,) float tensor
    num_nodes: int = 1
    stage_of: Any = None    # (K,) tuple of 1-based stages
    nonant_names: tuple = ()
    scen_names: tuple = ()

    def to(self, device):
        return dataclasses.replace(self, node_of=self.node_of.to(device),
                                   prob=self.prob.to(device))


@dataclasses.dataclass(frozen=True)
class ScenarioBatch:
    """A batch of S lowered scenario subproblems (leading axis =
    scenario), ir.py:77-187 of the JAX package.  A is the dense
    per-scenario (S, M, N) tensor, a shared (1, M, N) one or a
    SplitA."""

    c: Any          # (S, N)
    qdiag: Any      # (S, N)
    A: Any          # (S, M, N), (1, M, N) or SplitA
    row_lo: Any     # (S, M)
    row_hi: Any     # (S, M)
    lb: Any         # (S, N)
    ub: Any         # (S, N)
    obj_const: Any  # (S,)
    nonant_idx: Any  # (K,) int64
    integer_mask: Any  # (S, N) bool
    tree: TreeInfo
    stage_cost_c: Any = None   # (n_stages, S, N) or None
    var_names: tuple = ()
    model_meta: Any = None     # host-side metadata (numpy / python)

    _TENSORS = ("c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub",
                "obj_const", "nonant_idx", "integer_mask",
                "stage_cost_c")

    def to(self, device):
        """The same batch with every tensor on `device`."""
        moved = {f: getattr(self, f).to(device) for f in self._TENSORS
                 if getattr(self, f) is not None}
        return dataclasses.replace(self, tree=self.tree.to(device),
                                   **moved)

    @property
    def device(self):
        return self.c.device

    @property
    def num_scens(self):
        return self.c.shape[0]

    @property
    def shared_A(self):
        """True when ONE constraint matrix serves every scenario: A is
        stored (1, M, N) (ir.py:117-122 of the JAX package)."""
        return self.A.shape[0] == 1 and self.c.shape[0] > 1

    @property
    def split_A(self):
        """True when A is stored split-native (a SplitA): the form of
        instances whose dense (S, M, N) tensor cannot exist, such as
        true-size farmer (~288 GB dense in f32)."""
        return isinstance(self.A, SplitA)

    def densify(self):
        """The same batch with a dense per-scenario A, built from a
        shared or split one (ir.py:132-150).  Refuses to build more
        than 5e8 elements."""
        if self.split_A:
            S, M, N = self.A.shape
            if S * M * N > 500_000_000:
                raise MemoryError(
                    f"densify() of a split-native batch would build a "
                    f"{S}x{M}x{N} tensor; this code path (dense "
                    f"per-scenario A) does not support instances of "
                    f"this size")
            return dataclasses.replace(self, A=self.A.to_dense())
        if not self.shared_A:
            return self
        A = self.A.expand((self.num_scens,) + tuple(self.A.shape[1:]))
        return dataclasses.replace(self, A=A.contiguous())

    @property
    def num_vars(self):
        return self.c.shape[1]

    @property
    def num_rows(self):
        return self.A.shape[1]

    @property
    def num_nonants(self):
        return self.nonant_idx.shape[0]

    @property
    def prob(self):
        return self.tree.prob

    def nonants(self, x):
        """Extract nonant slots from a (..., N) solution -> (..., K)."""
        return x[..., self.nonant_idx]

    def objective(self, x):
        """Per-scenario objective value of a (S, N) point -> (S,)."""
        return (torch.sum(self.c * x, dim=-1)
                + 0.5 * torch.sum(self.qdiag * x * x, dim=-1)
                + self.obj_const)


@dataclasses.dataclass(frozen=True)
class SplitA:
    """A constraint batch in shared + sparse-delta form
    (ir.py:191-251 of the JAX package):

        A(s) = shared  +  scatter((rows, cols) -> vals[s])

    for families whose matrix uncertainty touches a few coordinates per
    scenario (farmer: the 2 * n_crops yield coefficients).  `shared`
    holds zeros at the delta positions, so the scatter adds without
    masking, and a repeated (row, col) pair sums its values.  The
    batched matvec is one (S, N) x (N, M) product plus an nnz-sized
    scatter."""

    shared: Any   # (M, N) scenario-independent part (0 at delta slots)
    rows: Any     # (nnz,) int32 row of each per-scenario entry
    cols: Any     # (nnz,) int32 column of each per-scenario entry
    vals: Any     # (S, nnz) per-scenario values at (rows, cols)

    @property
    def shape(self):
        return (self.vals.shape[0],) + tuple(self.shared.shape)

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def _fields(self):
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def to(self, device):
        """The same operator with every tensor on `device`."""
        return dataclasses.replace(
            self, **{k: v.to(device) for k, v in self._fields().items()})

    def astype(self, dt):
        """Cast the shared block and the per-scenario values (the hot
        loop's storage cast); the coordinates are untouched.
        Subclass-preserving."""
        return dataclasses.replace(self, shared=self.shared.to(dt),
                                   vals=self.vals.to(dt))

    def contiguous(self):
        return dataclasses.replace(
            self, **{k: v.contiguous() for k, v in self._fields().items()})

    def scale_shared(self, row_mult, col_mult):
        """diag(row_mult) @ shared @ diag(col_mult), in the storage that
        `shared` uses (dense here)."""
        return self.shared * row_mult[:, None] * col_mult[None, :]

    def shared_dense(self):
        """The shared block as a dense (M, N) tensor."""
        return self.shared

    def to_dense(self, dtype=None):
        """The dense (S, M, N) tensor, assembled in `dtype` (default:
        the storage dtype) as the JAX `.at[].add` does."""
        dt = self.dtype if dtype is None else dtype
        S, M, N = self.shape
        A = self.shared_dense().to(dt)[None].expand(S, M, N).clone()
        nnz = self.rows.shape[0]
        s_idx = torch.arange(S, device=A.device)[:, None].expand(S, nnz)
        A.index_put_((s_idx, self.rows.long()[None].expand(S, nnz),
                      self.cols.long()[None].expand(S, nnz)),
                     self.vals.to(dt), accumulate=True)
        return A

    def shared_matvec(self, x):
        """x @ shared.T: (S, N) -> (S, M)."""
        return x @ self.shared.T

    def shared_rmatvec(self, y):
        """y @ shared: (S, M) -> (S, N)."""
        return y @ self.shared


@dataclasses.dataclass(frozen=True)
class SparseSplitA(SplitA):
    """A SplitA whose shared block is a torch sparse CSR tensor
    (ir.py:256-300): its products go through torch's sparse matrix
    product, as the JAX package's BCOO block goes through
    jax.experimental.sparse, so a product costs nnz(shared) per
    scenario instead of M * N.  Built by `sparsify_split`.  torch's
    sparse product has no bfloat16 form on the CPU, so bf16 storage of
    the block is refused rather than cast."""

    def astype(self, dt):
        if dt == torch.bfloat16:
            raise _sparse_bf16_refused()
        return super().astype(dt)

    def contiguous(self):
        # a CSR tensor has no strides: only the dense fields
        return dataclasses.replace(self, rows=self.rows.contiguous(),
                                   cols=self.cols.contiguous(),
                                   vals=self.vals.contiguous())

    def scale_shared(self, row_mult, col_mult):
        sh = self.shared
        crow, col = sh.crow_indices(), sh.col_indices()
        row = torch.repeat_interleave(
            torch.arange(sh.shape[0], device=crow.device), crow.diff())
        data = sh.values() * row_mult[row] * col_mult[col]
        return torch.sparse_csr_tensor(crow, col, data, size=sh.shape,
                                       check_invariants=False)

    def shared_dense(self):
        return self.shared.to_dense()

    def shared_matvec(self, x):
        return (self.shared @ x.T).T

    def shared_rmatvec(self, y):
        return (self.shared.t() @ y.T).T

    @property
    def shared_nnz_frac(self):
        """Stored-element fraction of the shared block (what the
        sparse_threshold knob gates on)."""
        M, N = self.shared.shape
        return float(self.shared.values().numel()) / float(max(M * N, 1))


def _sparse_bf16_refused():
    return not_ported("bfloat16 storage of a sparse shared block "
                      "(SparseSplitA: torch's sparse product has no "
                      "bfloat16 form)", 1)


def shared_density(A):
    """Nonzero fraction of a SplitA's shared block (1.0 for other
    operators: a dense batched A never routes sparse)."""
    if isinstance(A, SparseSplitA):
        return A.shared_nnz_frac
    if not isinstance(A, SplitA):
        return 1.0
    return (float(torch.count_nonzero(A.shared))
            / float(max(A.shared.numel(), 1)))


def sparsify_split(A, threshold):
    """A dense-shared SplitA as a SparseSplitA when its shared block's
    density is below `threshold` (once per prep, ir.py:303-328).
    Returns `A` unchanged when the threshold is off (<= 0), the
    density is at or above it, or `A` is not a dense-shared SplitA."""
    if threshold is None or float(threshold) <= 0.0:
        return A
    if not isinstance(A, SplitA) or isinstance(A, SparseSplitA):
        return A
    if shared_density(A) >= float(threshold):
        return A
    if A.dtype == torch.bfloat16:
        raise _sparse_bf16_refused()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        sh = A.shared.to_sparse_csr()
    return SparseSplitA(shared=sh, rows=A.rows, cols=A.cols, vals=A.vals)


def delta_idx(batch):
    """The batch's declared sparse matrix-uncertainty coordinates
    (model_meta["A_delta_idx"] -> (rows, cols) numpy arrays), or None."""
    meta = batch.model_meta
    if not isinstance(meta, dict):
        return None
    return meta.get("A_delta_idx")


def bmatvec(A, x):
    """Batched A @ x: A (SA, M, N) with SA == S or SA == 1 (shared
    constraint matrix), or a SplitA; x (S, N) -> (S, M).  The SplitA
    form is the shared product plus an `index_add_` of the deltas; on
    CUDA `index_add_` adds a repeated index with atomics, in no fixed
    order, so such sums may differ by a few ulp from run to run."""
    if isinstance(A, SplitA):
        out = A.shared_matvec(x).contiguous()
        return out.index_add_(1, A.rows, A.vals * x[:, A.cols])
    if A.shape[0] == 1:
        return x @ A[0].T
    return torch.einsum("smn,sn->sm", A, x)


def bmatvec_t(A, y):
    """Batched A^T @ y: A (SA, M, N) or SplitA, y (S, M) -> (S, N)."""
    if isinstance(A, SplitA):
        out = A.shared_rmatvec(y).contiguous()
        return out.index_add_(1, A.cols, A.vals * y[:, A.rows])
    if A.shape[0] == 1:
        return y @ A[0]
    return torch.einsum("smn,sm->sn", A, y)


def node_segment_sum(node_of, num_nodes):
    """Per-(tree node, nonant slot) segment reduction (ir.py:412-436).

    The (node, slot) pair is one segment key (flatid = node_of * K +
    slot); a reduction over a (S, K) array scatter-adds into the
    num_nodes*K segments with `index_add_`, then gathers back to
    scenario layout.  Returns (flatid (S, K), segsum) where
    segsum(v: (S, K)) -> (S, K) holds each element's segment total.
    On CUDA `index_add_` accumulates with atomics, so the order of the
    floating-point additions may vary from run to run."""
    K = node_of.shape[1]
    cols = torch.arange(K, device=node_of.device).expand(node_of.shape)
    flatid = node_of.long() * K + cols
    fl = flatid.reshape(-1)
    size = int(num_nodes) * K

    def segsum(v):
        z = torch.zeros((size,), dtype=v.dtype, device=v.device)
        z.index_add_(0, fl, v.reshape(-1))
        return z[flatid]

    return flatid, segsum
