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
`stack_scenarios` stacks single-scenario batches (the
`scenario_creator` path) and `pad_scenarios` appends zero-probability
dummy scenarios.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
import weakref
from typing import Any

import numpy as np
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
    # (S, K) per-(scenario, nonant slot) averaging weights, the
    # variable_probability feature; None: the scenario probabilities
    var_prob: Any = None

    _TENSORS = ("c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub",
                "obj_const", "nonant_idx", "integer_mask",
                "stage_cost_c", "var_prob")

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
        return (self.vals.shape[0],) + tuple(self.shared.shape[-2:])

    @property
    def bases(self):
        """Shared blocks stored: 1 for a (M, N) block; B for a grouped
        (B, M, N) stack, one block per request of a coalesced group
        whose per_base consecutive scenarios share it."""
        return 1 if self.shared.dim() == 2 else self.shared.shape[0]

    @property
    def per_base(self):
        """Consecutive scenarios that read one shared block."""
        return self.vals.shape[0] // self.bases

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
        `shared` uses (dense here); a grouped block takes (B, M) and
        (B, N) multipliers, one row each."""
        if self.shared.dim() == 3:
            return self.shared * row_mult[:, :, None] * col_mult[:, None, :]
        return self.shared * row_mult[:, None] * col_mult[None, :]

    def shared_dense(self):
        """The shared block as a dense (M, N) tensor."""
        return self.shared

    def to_dense(self, dtype=None):
        """The dense (S, M, N) tensor, assembled in `dtype` (default:
        the storage dtype) as the JAX `.at[].add` does."""
        dt = self.dtype if dtype is None else dtype
        S, M, N = self.shape
        sh = self.shared_dense().to(dt)
        if sh.dim() == 3:
            A = sh.repeat_interleave(self.per_base, dim=0)
        else:
            A = sh[None].expand(S, M, N).clone()
        nnz = self.rows.shape[0]
        s_idx = torch.arange(S, device=A.device)[:, None].expand(S, nnz)
        A.index_put_((s_idx, self.rows.long()[None].expand(S, nnz),
                      self.cols.long()[None].expand(S, nnz)),
                     self.vals.to(dt), accumulate=True)
        return A

    def shared_matvec(self, x):
        """x @ shared.T: (S, N) -> (S, M); a grouped block is one batched
        product over its bases."""
        if self.shared.dim() == 3:
            return _grouped_matvec(self.shared, x)
        return x @ self.shared.T

    def shared_rmatvec(self, y):
        """y @ shared: (S, M) -> (S, N)."""
        if self.shared.dim() == 3:
            return _grouped_rmatvec(self.shared, y)
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


@dataclasses.dataclass(frozen=True)
class GroupedA:
    """The shared matrices of a coalesced group of B requests of one
    bucket (serve/; built by `phbase.stack_preps`): request b owns the
    `per_base` consecutive scenarios b * per_base .. and reads
    stack[b].  The grouping is stated, never read off a shape: a plain
    (SA, M, N) tensor is one shared matrix (SA = 1) or one matrix a
    scenario (SA = S)."""

    stack: Any     # (B, M, N) one matrix a request
    per_base: int  # scenarios of one request

    @property
    def bases(self):
        return self.stack.shape[0]

    @property
    def shape(self):
        return (self.bases * self.per_base,) + tuple(self.stack.shape[1:])

    @property
    def dtype(self):
        return self.stack.dtype

    @property
    def device(self):
        return self.stack.device

    def to(self, device):
        return dataclasses.replace(self, stack=self.stack.to(device))

    def astype(self, dt):
        return dataclasses.replace(self, stack=self.stack.to(dt))

    def contiguous(self):
        return dataclasses.replace(self, stack=self.stack.contiguous())


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


def _grouped_matvec(A, x):
    """x (S, N) against a grouped (B, M, N) stack whose S / B
    consecutive scenarios share one matrix: one batched product."""
    B, M, N = A.shape
    return torch.bmm(x.reshape(B, -1, N), A.transpose(1, 2)).reshape(-1, M)


def _grouped_rmatvec(A, y):
    B, M, N = A.shape
    return torch.bmm(y.reshape(B, -1, M), A).reshape(-1, N)


def grouped_bases(A, S):
    """Matrices stored by an operator of S scenarios: 1 for a shared
    matrix or a SplitA's (M, N) block, B for a GroupedA or a SplitA
    with a (B, M, N) block (a coalesced group), S for a dense batch."""
    if isinstance(A, (SplitA, GroupedA)):
        return A.bases
    return 1 if A.shape[0] == 1 else S


# index -> its collision-free layers on the card (see _ordered_index_add)
_LAYERS = {}


def _index_layers(index):
    """`index` split into layers in which no value repeats: layer j
    holds the j-th occurrence of every value, in the order of first
    appearance.  Cached for the life of the index tensor (one host copy
    a coordinate vector)."""
    key = id(index)
    hit = _LAYERS.get(key)
    if hit is not None and hit[0]() is index:
        return hit[1]
    ix = index.detach().cpu().long().numpy()
    seen = {}
    occ = np.empty(ix.shape[0], np.int64)
    for k, v in enumerate(ix.tolist()):
        occ[k] = seen.get(v, 0)
        seen[v] = occ[k] + 1
    layers = []
    for j in range(int(occ.max(initial=-1)) + 1):
        pos = np.nonzero(occ == j)[0]
        layers.append((torch.as_tensor(pos, device=index.device),
                       torch.as_tensor(ix[pos], device=index.device)))
    _LAYERS[key] = (weakref.ref(index, lambda _r, k=key: _LAYERS.pop(k,
                                                                     None)),
                    layers)
    return layers


def _ordered_index_add(out, index, src):
    """out[:, index[k]] += src[:, k] for every k.  On the CPU
    `index_add_` sums a repeated index in k order.  On CUDA `index_add_`
    adds a repeated index with atomics in no fixed order, so a sum could
    differ in its last bits from run to run; there the additions go
    layer by layer (`_index_layers`), each layer an `index_add_` without
    repeats, so that the card gives the same bits run after run (not
    necessarily the CPU's)."""
    if out.device.type != "cuda":
        return out.index_add_(1, index, src)
    layers = _index_layers(index)
    if len(layers) == 1:
        return out.index_add_(1, index, src)
    for pos, ix in layers:
        out.index_add_(1, ix, src[:, pos])
    return out


def bmatvec(A, x):
    """Batched A @ x: A (SA, M, N) with SA == S or SA == 1 (shared
    constraint matrix), a GroupedA (one batched product over its
    matrices) or a SplitA; x (S, N) -> (S, M).  The SplitA form is the
    shared product plus the deltas' ordered index add (the same bits
    run after run on CUDA too)."""
    if isinstance(A, SplitA):
        out = A.shared_matvec(x).contiguous()
        return _ordered_index_add(out, A.rows, A.vals * x[:, A.cols])
    if isinstance(A, GroupedA):
        return _grouped_matvec(A.stack, x)
    if A.shape[0] == 1:
        return x @ A[0].T
    return torch.einsum("smn,sn->sm", A, x)


def bmatvec_t(A, y):
    """Batched A^T @ y: A (SA, M, N), GroupedA or SplitA, y (S, M) ->
    (S, N)."""
    if isinstance(A, SplitA):
        out = A.shared_rmatvec(y).contiguous()
        return _ordered_index_add(out, A.cols, A.vals * y[:, A.rows])
    if isinstance(A, GroupedA):
        return _grouped_rmatvec(A.stack, y)
    if A.shape[0] == 1:
        return y @ A[0]
    return torch.einsum("smn,sm->sn", A, y)


def node_segment_sum(node_of, num_nodes):
    """Per-(tree node, nonant slot) segment reduction (ir.py:412-436).

    The (node, slot) pair is one segment key (flatid = node_of * K +
    slot); a reduction over a (S, K) array adds into the num_nodes*K
    segments, then gathers back to scenario layout.  Returns (flatid
    (S, K), segsum) where segsum(v: (S, K)) -> (S, K) holds each
    element's segment total.  On the CPU `index_add_` adds each
    segment's elements in scenario order.  On CUDA `index_add_` adds
    with atomics, in no fixed order; there the sum is `index_put_` with
    accumulate, which gives the same bits run after run on the card
    (measured), though not necessarily the CPU's order of addition."""
    K = node_of.shape[1]
    cols = torch.arange(K, device=node_of.device).expand(node_of.shape)
    flatid = node_of.long() * K + cols
    fl = flatid.reshape(-1)
    size = int(num_nodes) * K

    def segsum(v):
        z = torch.zeros((size,), dtype=v.dtype, device=v.device)
        if v.device.type == "cuda":
            z.index_put_((fl,), v.reshape(-1), accumulate=True)
        else:
            z.index_add_(0, fl, v.reshape(-1))
        return z[flatid]

    return flatid, segsum


def stack_scenarios(scens, scen_names=None):
    """Stack single-scenario batches (S=1 each, e.g. from
    `model.LinearModel.lower`) into one ScenarioBatch on their device
    (ir.py:439-501 of the JAX package).  All must share (num_rows,
    num_vars) and the nonant layout; the probabilities are divided by
    their total, which is summed on the host with `math.fsum` (the
    correctly rounded sum, so the result does not depend on the
    device's reduction order: S scenarios of probability 1/S stack to
    exactly the probabilities a vectorized builder writes)."""
    if not scens:
        raise ValueError("no scenarios to stack")
    first = scens[0]
    if any(s.num_vars != first.num_vars or s.num_rows != first.num_rows
           for s in scens):
        raise ValueError(
            "all scenarios in a batch must share (num_rows, num_vars); "
            "pad constraint rows with free bounds to equalize")
    # the consensus average pairs slot j across scenarios (reference
    # counterpart: _verify_nonant_lengths, spbase.py:150)
    ref_idx = first.nonant_idx.cpu()
    for s in scens[1:]:
        if not torch.equal(s.nonant_idx.cpu(), ref_idx):
            raise ValueError(
                "all scenarios must declare the same nonant variable "
                "layout (indices and order)")

    def cat(field, dim=0):
        return torch.cat([getattr(s, field) for s in scens], dim=dim)

    prob = torch.cat([s.tree.prob for s in scens])
    prob = prob / math.fsum(prob.tolist())
    names = tuple(scen_names) if scen_names is not None else tuple(
        n for s in scens for n in (s.tree.scen_names or ("?",) * s.num_scens))
    tree = TreeInfo(
        node_of=torch.cat([s.tree.node_of for s in scens]),
        prob=prob,
        num_nodes=max(s.tree.num_nodes for s in scens),
        stage_of=first.tree.stage_of,
        nonant_names=first.tree.nonant_names,
        scen_names=names)
    return ScenarioBatch(
        c=cat("c"), qdiag=cat("qdiag"), A=cat("A"),
        row_lo=cat("row_lo"), row_hi=cat("row_hi"),
        lb=cat("lb"), ub=cat("ub"), obj_const=cat("obj_const"),
        nonant_idx=first.nonant_idx,
        integer_mask=cat("integer_mask"),
        tree=tree,
        stage_cost_c=None if first.stage_cost_c is None
        else cat("stage_cost_c", dim=1),
        var_prob=None if first.var_prob is None else cat("var_prob"),
        var_names=first.var_names)


def pad_scenarios(batch: ScenarioBatch, to: int) -> ScenarioBatch:
    """The batch with `to - S` zero-probability dummy scenarios appended
    (ir.py:504-570 of the JAX package), for layouts that need a given
    scenario count.  Each pad is feasible by construction: free rows
    and a unit box.  Pads get their own dummy tree node, so they join
    no x̄ average (probability 0) and no EF consensus group.  A shared
    matrix serves the pads as it is; a SplitA gives them zero deltas
    (the shared matrix), harmless under free rows and probability 0."""
    S = batch.num_scens
    if to <= S:
        return batch
    padn = to - S

    def padfield(v, fill=0.0):
        pad = torch.full((padn,) + tuple(v.shape[1:]), fill,
                         dtype=v.dtype, device=v.device)
        return torch.cat([v, pad])

    tree = batch.tree
    new_tree = TreeInfo(
        node_of=padfield(tree.node_of, tree.num_nodes),
        prob=padfield(tree.prob, 0.0),
        num_nodes=tree.num_nodes + 1,
        stage_of=tree.stage_of,
        nonant_names=tree.nonant_names,
        scen_names=tree.scen_names + tuple(
            f"_pad{i}" for i in range(padn)))
    if isinstance(batch.A, SplitA):
        # dataclasses.replace keeps a SparseSplitA sparse
        A_pad = dataclasses.replace(batch.A, vals=padfield(batch.A.vals))
    else:
        A_pad = batch.A if batch.shared_A else padfield(batch.A)
    scc = batch.stage_cost_c
    return ScenarioBatch(
        c=padfield(batch.c),
        qdiag=padfield(batch.qdiag),
        A=A_pad,
        row_lo=padfield(batch.row_lo, -np.inf),
        row_hi=padfield(batch.row_hi, np.inf),
        lb=padfield(batch.lb),
        ub=padfield(batch.ub, 1.0),
        obj_const=padfield(batch.obj_const),
        nonant_idx=batch.nonant_idx,
        integer_mask=padfield(batch.integer_mask, False),
        tree=new_tree,
        stage_cost_c=None if scc is None else torch.cat(
            [scc, scc.new_zeros((scc.shape[0], padn, scc.shape[2]))], 1),
        var_prob=None if batch.var_prob is None
        else padfield(batch.var_prob, 0.0),
        var_names=batch.var_names,
        model_meta=batch.model_meta)
