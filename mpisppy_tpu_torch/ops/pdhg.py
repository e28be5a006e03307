"""Batched first-order LP/QP solver, restarted PDHG (port of
`mpisppy_tpu/ops/pdhg.py`).

Problem form (per scenario):

    minimize    c @ x + 0.5 * qdiag @ (x*x)
    subject to  row_lo <= A @ x <= row_hi
                lb <= x <= ub

Chambolle-Pock iterations with Ruiz equilibration, a power-iteration
estimate of ||A||_2, KKT-triggered adaptive restarts (or the fixed
cadence), primal-weight rebalancing and per-scenario convergence
freezing — the JAX solver's algorithm, step for step.  The JAX
`lax.while_loop` is a Python loop here with one host sync per KKT
check.

The constraint operator comes dense per scenario (S, M, N), shared
(1, M, N), or split (`ir.SplitA`, from the split preps
`prepare_batch_split` / `prepare_split_native`, or its sparse-shared
`SparseSplitA`).  Each inner iteration chunk between checks takes one
of two routes (`ops.pdhg_chunk.pick_route`, a function of the form and
the shape):
* the kernel: one launch of the hand-written CUDA kernel
  `ops.pdhg_chunk.fused_chunk`, in its dense, shared or split form;
* the matmul route, for a shared or split operator too large for the
  kernel's tile (true-size farmer) and for a sparse shared block: the
  JAX package's XLA body as torch ops, with the shared block in one
  large matrix product per matvec plus the delta `index_add_`.

A consensus solve (`ConsensusSpec`: the extensive form, each (tree
node, nonant slot) one variable shared by the node's scenarios) takes a
third route, `consensus_chunk`, whatever the operator's form: every
step segment-sums the gradient's nonant slots over the node members,
which couples the scenarios that the kernel keeps apart.  The JAX
package keeps these solves off its Pallas kernel for the same reason.

`PDHGSolver.solve_compacted` (opt-in through `compact_threshold`)
segments a solve on the host and gathers the unconverged scenarios into
a power-of-two width (`width_bucket`), so converged scenarios stop
paying for steps; the kernel then launches at the narrower width.
`PDHGSolver.from_options` overlays the MPISPPY_TPU_PDHG environment
variable on the options.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any

import numpy as np
import torch

from ..ir import GroupedA, SplitA, node_segment_sum
from ..ir import bmatvec as _Ax
from ..ir import bmatvec_t as _ATy
from ..utils.solver_spec import option_string_to_dict
from .pdhg_chunk import (H100_SMEM_OPTIN, _dual_prox, _proj_box,
                         fused_chunk, operator_form, pick_route, smem_optin)

# hot_dtype knob -> (storage dtype, compute dtype) for the inner loop;
# "bf16x" stores A in bfloat16 and does all arithmetic in float32 (the
# chunk kernel converts A once per chunk, as it enters registers)
HOT_DTYPES = {
    "f32": (torch.float32, torch.float32),
    "bf16x": (torch.bfloat16, torch.float32),
}

def eps_floor(dtype):
    """Tightest tolerance `dtype` arithmetic can express (100 ulp)."""
    return 100.0 * float(torch.finfo(dtype).eps)


@dataclasses.dataclass(frozen=True)
class PreparedBatch:
    """Scaled constraint data, computed once per ScenarioBatch.  A
    shared or split prep keeps one scaling for every scenario: A is
    (1, M, N) or a SplitA, d_row (1, M), d_col (1, N) and, for a shared
    A, anorm (1,)."""
    A: Any        # (S, M, N), (1, M, N), GroupedA or SplitA: D_r A D_c
    row_lo: Any   # (S, M) scaled: D_r * row_lo
    row_hi: Any   # (S, M)
    d_row: Any    # (S, M) or (1, M) row scaling D_r
    d_col: Any    # (S, N) or (1, N) col scaling D_c
    anorm: Any    # (S,) or (1,) ||A_scaled||_2 estimate

    def map(self, fn):
        """A PreparedBatch with `fn` applied to every field (a SplitA
        operator included: `fn` must accept it, as `.to` does)."""
        return PreparedBatch(**{f.name: fn(getattr(self, f.name))
                                for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class ConsensusSpec:
    """Nonanticipativity structure of an extensive-form (EF) solve
    (ops/pdhg.py:107-132 of the JAX package).  Each (tree node, nonant
    slot) is one variable shared by the node's member scenarios: the
    primal gradient is segment-summed over the members before each
    update (the adjoint of the broadcast), so the batched iteration
    solves the monolithic EF without building its matrix.  Needs one
    column scaling for all scenarios (prepare_batch(shared_cols=True)
    or a split prep).

    num_copies stacks that many independent EFs along the scenario
    axis: the norm estimate, step sizes, omega and the KKT verdict are
    taken per copy.  v0 is the (S, N) start vector of the EF's power
    iteration (the JAX package draws jax.random.normal(PRNGKey(0)));
    None draws `normal_draw` on the solve's device."""
    node_of: Any      # (S, K) node id per scenario per nonant slot
    nonant_idx: Any   # (K,) column indices of the nonant slots
    num_nodes: int = 1
    num_copies: int = 1
    v0: Any = None


@dataclasses.dataclass(frozen=True)
class SolveResult:
    x: Any          # (S, N) primal solution (unscaled)
    y: Any          # (S, M) row duals (unscaled)
    obj: Any        # (S,) primal objective (incl. obj_const)
    dual_obj: Any   # (S,) dual objective estimate (incl. obj_const)
    pres: Any       # (S,) relative primal residual (inf-norm)
    dres: Any       # (S,) relative dual residual (inf-norm)
    gap: Any        # (S,) relative primal-dual gap
    converged: Any  # (S,) bool
    iters: int      # iterations used (max across batch)
    restarts: Any = 0  # (S,) int restart events per scenario
    # (S,) KKT checks each scenario ran until it converged (all of them
    # when it did not); kept only when the solve is asked per scenario
    checks: Any = None


# --------------------------------------------------------------------------
# scaling
# --------------------------------------------------------------------------

def _ruiz(A, n_iter=10, eps=1e-12, shared_cols=False):
    """Ruiz equilibration: (A_scaled, d_row, d_col) with
    A_scaled = diag(d_row) @ A @ diag(d_col), rows/cols ~unit inf-norm.
    shared_cols: one column scaling for every scenario (the EF's column
    space), which consensus solves need; d_col is then broadcast to
    (S, N)."""
    S, M, N = A.shape
    dr = torch.ones((S, M), dtype=A.dtype, device=A.device)
    dc = torch.ones((N,) if shared_cols else (S, N), dtype=A.dtype,
                    device=A.device)
    for _ in range(n_iter):
        absA = torch.abs(A)
        rmax = torch.amax(absA, dim=2)                  # (S, M)
        cmax = torch.amax(absA, dim=(0, 1) if shared_cols else 1)
        sr = torch.where(rmax <= eps, 1.0,
                         1.0 / torch.sqrt(torch.clamp(rmax, min=eps)))
        sc = torch.where(cmax <= eps, 1.0,
                         1.0 / torch.sqrt(torch.clamp(cmax, min=eps)))
        A = A * sr[:, :, None] * (sc[None, None, :] if shared_cols
                                  else sc[:, None, :])
        dr = dr * sr
        dc = dc * sc
    if shared_cols:
        dc = dc[None, :].expand(S, N).contiguous()
    return A, dr, dc


def normal_draw(shape, dtype, device, seed=0):
    """The standard normal start vector of a power iteration: a draw
    from a torch.Generator seeded `seed` on `device`.  (The JAX package
    draws jax.random.normal(PRNGKey(seed)), which torch cannot
    reproduce; tests that compare iteration counts hand its draw in
    through `v0` or in place of this function.)"""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _power_iteration(A, iters=40, seed=0, v0=None):
    """||A||_2 per scenario via power iteration on A^T A, for any
    operator form (S is 1 for a shared A).  The start vector is
    `normal_draw`, or `v0` (S, N) when given."""
    S, M, N = A.shape
    if v0 is None:
        v = normal_draw((S, N), A.dtype, A.device, seed)
    else:
        v = torch.as_tensor(np.array(v0), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-30)
        v = _ATy(A, _Ax(A, v))
    av = _Ax(A, v / (torch.linalg.vector_norm(v, dim=1, keepdim=True)
                     + 1e-30))
    return torch.linalg.vector_norm(av, dim=1)


def _scale_rows(r, d_row):
    return torch.where(torch.isfinite(r), r * d_row, r)


def prepare_batch(A, row_lo, row_hi, ruiz_iters=10, v0=None,
                  shared_cols=False):
    """One-time per-batch preprocessing (scale + norm estimate) on the
    device of A, for a dense (S, M, N) or a shared (1, M, N) A; a
    shared A keeps its singleton leading axis in the prep.
    shared_cols: one column scaling for all scenarios (consensus)."""
    if isinstance(A, SplitA):
        raise TypeError("prepare_batch: a SplitA takes "
                        "prepare_split_native")
    if A.dim() != 3 or A.shape[0] not in (1, row_lo.shape[0]):
        raise ValueError(f"prepare_batch: A must be (S, M, N) or "
                         f"(1, M, N), got {tuple(A.shape)}")
    As, d_row, d_col = _ruiz(A, n_iter=ruiz_iters, shared_cols=shared_cols)
    anorm = _power_iteration(As, v0=v0)
    return PreparedBatch(
        A=As,
        row_lo=_scale_rows(row_lo, d_row),
        row_hi=_scale_rows(row_hi, d_row),
        d_row=d_row,
        d_col=d_col,
        # floor at 1: an all-zero A would otherwise blow up the steps
        anorm=torch.clamp(anorm, min=1.0),
    )


def prepare_batch_split(A, rows, cols, row_lo, row_hi, ruiz_iters=10,
                        v0=None):
    """prepare_batch for a dense (S, M, N) A whose matrix uncertainty is
    confined to the (rows, cols) coordinates (the model's
    model_meta["A_delta_idx"] declaration; ops/pdhg.py:223-252 of the
    JAX package).  One row and one column scaling serve every scenario
    (norms taken as the max over scenarios), which keeps the shared +
    sparse structure.  Returns a prep whose A is a SplitA and whose
    d_row / d_col are (1, M) / (1, N)."""
    rows = torch.as_tensor(np.asarray(rows), dtype=torch.int32,
                           device=A.device)
    cols = torch.as_tensor(np.asarray(cols), dtype=torch.int32,
                           device=A.device)
    r, c = rows.long(), cols.long()
    vals = A[:, r, c]                                  # (S, nnz)
    A0 = A[0].clone()
    A0[r, c] = 0.0                                     # (M, N) shared
    return _prepare_split_core(A0, rows, cols, vals, row_lo, row_hi,
                               ruiz_iters=ruiz_iters, v0=v0)


def prepare_split_native(A, row_lo, row_hi, ruiz_iters=10, v0=None):
    """prepare_batch_split for a batch born split (its A is a SplitA:
    the only form at sizes where the dense tensor cannot exist)."""
    return _prepare_split_core(A.shared, A.rows.to(torch.int32),
                               A.cols.to(torch.int32), A.vals, row_lo,
                               row_hi, ruiz_iters=ruiz_iters, v0=v0)


def _prepare_split_core(A0, rows, cols, vals, row_lo, row_hi,
                        ruiz_iters=10, v0=None):
    """Ruiz equilibration of shared + deltas with one scaling for every
    scenario, then the norm estimate (ops/pdhg.py:265-293)."""
    M, N = A0.shape
    r, c = rows.long(), cols.long()
    A0 = A0.clone()
    A0[r, c] = 0.0        # enforce the zeros-at-delta contract
    eps = 1e-12
    dr = torch.ones((M,), dtype=A0.dtype, device=A0.device)
    dc = torch.ones((N,), dtype=A0.dtype, device=A0.device)
    vs = vals
    for _ in range(ruiz_iters):
        vmax = torch.amax(torch.abs(vs), dim=0)        # (nnz,) over scens
        rmax = torch.amax(torch.abs(A0), dim=1).scatter_reduce(
            0, r, vmax, "amax")
        cmax = torch.amax(torch.abs(A0), dim=0).scatter_reduce(
            0, c, vmax, "amax")
        sr = torch.where(rmax <= eps, 1.0,
                         1.0 / torch.sqrt(torch.clamp(rmax, min=eps)))
        sc = torch.where(cmax <= eps, 1.0,
                         1.0 / torch.sqrt(torch.clamp(cmax, min=eps)))
        A0 = A0 * sr[:, None] * sc[None, :]
        vs = vs * sr[r] * sc[c]
        dr = dr * sr
        dc = dc * sc
    As = SplitA(shared=A0, rows=rows, cols=cols, vals=vs)
    anorm = _power_iteration(As, v0=v0)
    d_row = dr[None, :]
    return PreparedBatch(
        A=As,
        row_lo=_scale_rows(row_lo, d_row),
        row_hi=_scale_rows(row_hi, d_row),
        d_row=d_row,
        d_col=dc[None, :],
        anorm=torch.clamp(anorm, min=1.0),
    )


def _gather_prep(prep: PreparedBatch, ii) -> PreparedBatch:
    """A PreparedBatch gathered to the scenario rows `ii`
    (ops/pdhg.py:296-317).  Shared leaves (leading dim 1) serve every
    scenario and are not gathered; a SplitA gathers only its
    per-scenario values."""
    def take(a):
        return a if a.shape[0] == 1 else a[ii]

    A = prep.A
    if isinstance(A, SplitA):
        # replace (not the constructor): a SparseSplitA stays sparse
        A = dataclasses.replace(A, vals=A.vals[ii])
    else:
        A = take(A)
    return PreparedBatch(
        A=A, row_lo=take(prep.row_lo), row_hi=take(prep.row_hi),
        d_row=take(prep.d_row), d_col=take(prep.d_col),
        anorm=take(prep.anorm))


def reprep_row_bounds(prep: PreparedBatch, row_lo, row_hi):
    """Rebuild a prep's scaled row bounds from new RAW bounds (valid
    while the constraint operator is unchanged)."""
    return dataclasses.replace(prep,
                               row_lo=_scale_rows(row_lo, prep.d_row),
                               row_hi=_scale_rows(row_hi, prep.d_row))


def _unscale_A(A, dr, dc):
    """User-space view of a scaled constraint operator, in its own form
    (a SplitA's shared block is rescaled into a new tensor).  A
    coalesced group's B matrices take the scaling of the first scenario
    of each request (one scaling a request)."""
    if isinstance(A, SplitA):
        if A.bases > 1:
            pb = A.per_base
            shared = A.scale_shared(1.0 / dr[::pb], 1.0 / dc[::pb])
        else:
            shared = A.scale_shared(1.0 / dr[0], 1.0 / dc[0])
        return dataclasses.replace(
            A, shared=shared,
            vals=A.vals / (dr[:, A.rows] * dc[:, A.cols]))
    if isinstance(A, GroupedA):
        pb = A.per_base
        return dataclasses.replace(
            A, stack=A.stack / dr[::pb, :, None] / dc[::pb, None, :])
    return A / dr[:, :, None] / dc[:, None, :]


def _cast_A(A, dt):
    """Storage-dtype cast of a constraint operator (SplitA.astype keeps
    its subclass)."""
    return (A.astype(dt) if isinstance(A, (SplitA, GroupedA))
            else A.to(dt))


# --------------------------------------------------------------------------
# core iteration pieces (all batched over leading S axis)
# --------------------------------------------------------------------------

def _residuals(x, y, c, qdiag, A, row_lo, row_hi, lb, ub, cavg=None):
    """KKT residuals + gap, all relative, inf-norms, batched
    (ops/pdhg.py:371-427 of the JAX package; PDLP convention).  cavg:
    a consensus solve's averaging function, which replaces each nonant
    slot's reduced cost by its node average so that the per-scenario
    sums of the reduced-cost terms are the EF's."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    Ax = _Ax(A, x)
    pviol = torch.clamp(torch.maximum(row_lo - Ax, Ax - row_hi), min=0.0)
    pviol = torch.where(torch.isfinite(pviol), pviol, zero)
    hi_fin = torch.isfinite(row_hi)
    lo_fin = torch.isfinite(row_lo)
    rhs_scale = 1.0 + torch.amax(
        torch.where(hi_fin, torch.abs(row_hi), zero)
        + torch.where(lo_fin, torch.abs(row_lo), zero), dim=1)
    pres = torch.amax(pviol, dim=1) / rhs_scale

    grad = c + qdiag * x
    r = grad + _ATy(A, y)
    if cavg is not None:
        r = cavg(r)
    rpos = torch.clamp(r, min=0.0)
    rneg = torch.clamp(r, max=0.0)
    lb_fin = torch.isfinite(lb)
    ub_fin = torch.isfinite(ub)
    dviol = torch.where(lb_fin, zero, rpos) + torch.where(ub_fin, zero, -rneg)
    at_lb = x <= lb + 1e-9 * (1 + torch.abs(lb))
    at_ub = x >= ub - 1e-9 * (1 + torch.abs(ub))
    interior = ~(at_lb | at_ub)
    dviol = torch.maximum(dviol, torch.where(interior, torch.abs(r), zero))
    obj_scale = 1.0 + torch.amax(torch.abs(c), dim=1)
    dres = torch.amax(dviol, dim=1) / obj_scale

    qxx = torch.sum(qdiag * x * x, dim=1)
    pobj = torch.sum(c * x, dim=1) + 0.5 * qxx
    ysup = torch.where(y > 0,
                       torch.where(hi_fin, y * row_hi, zero),
                       torch.where(lo_fin, y * row_lo, zero))
    rc = (torch.where(lb_fin, rpos * lb, zero)
          + torch.where(ub_fin, rneg * ub, zero))
    dobj = (-0.5 * qxx - torch.sum(ysup, dim=1) + torch.sum(rc, dim=1))
    gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))
    return pres, dres, gap, pobj, dobj


# the primal weight's clip at a restart (ops/pdhg.py:1067 of the JAX
# package)
OMEGA_MIN, OMEGA_MAX = 1e-4, 1e4


class PDHGSolver:
    """Restarted PDHG solver over a ScenarioBatch.  Typical
    use is through SPOpt.solve_loop, which supplies PH-modified
    objectives as plain tensors."""

    def __init__(self, max_iters=20000, eps=1e-6, check_every=40,
                 restart_every=16, omega0=1.0, use_pallas="auto",
                 pallas_tile=8, pallas_interpret=False,
                 restart_mode="adaptive", restart_beta_sufficient=0.2,
                 restart_beta_necessary=0.8, compact_threshold=0.0,
                 hot_dtype=None, sparse_threshold=0.0):
        # restart_every is in units of check_every inner iterations:
        # the forced cycle cap under "adaptive", the policy under "fixed"
        self.max_iters = int(max_iters)
        self.eps = float(eps)
        self.check_every = int(check_every)
        self.restart_every = int(restart_every)
        self.omega0 = float(omega0)
        if restart_mode not in ("adaptive", "fixed"):
            raise ValueError(
                f"restart_mode must be 'adaptive' or 'fixed', "
                f"got {restart_mode!r}")
        self.restart_mode = str(restart_mode)
        self.restart_beta_sufficient = float(restart_beta_sufficient)
        self.restart_beta_necessary = float(restart_beta_necessary)
        # active fraction below which solve_compacted gathers the
        # survivors into a narrower slab; 0 disables compaction
        self.compact_threshold = float(compact_threshold)
        # use_pallas / pallas_tile / pallas_interpret configure the TPU
        # kernel's tiling and are accepted for option compatibility
        # only: every inner chunk here goes through the CUDA kernel
        # (or its twin on CPU tensors), whatever they say.  "auto"
        # resolves as in the JAX package, so both packages key a config
        # alike
        self.use_pallas = False if use_pallas == "auto" \
            else bool(use_pallas)
        self.pallas_tile = int(pallas_tile)
        self.pallas_interpret = bool(pallas_interpret)
        if hot_dtype in (None, "", "none", "off", "f64", "float64"):
            hot_dtype = None
        elif hot_dtype not in HOT_DTYPES:
            raise ValueError(
                f"hot_dtype must be one of {sorted(HOT_DTYPES)} (or "
                f"None/'f64' for full precision), got {hot_dtype!r}")
        self.hot_dtype = hot_dtype
        # shared-block density below which a SplitA prep is stored as a
        # SparseSplitA (spopt._build_prep); 0 disables
        self.sparse_threshold = float(sparse_threshold)

    @classmethod
    def from_options(cls, options):
        """Build a solver from an SPBase-style options dict (the pdhg_*
        keys), with the JAX package's names and defaults.

        The MPISPPY_TPU_PDHG environment variable overlays the dict (the
        variable wins): a space-separated key=value string of pdhg knobs
        with or without the pdhg_ prefix, e.g.
        ``MPISPPY_TPU_PDHG="restart_mode=fixed compact_threshold=0.25"``.
        """
        o = dict(options or {})
        env = os.environ.get("MPISPPY_TPU_PDHG")
        if env:
            for k, v in (option_string_to_dict(env) or {}).items():
                o[k if k.startswith("pdhg_") else f"pdhg_{k}"] = v
        return cls(
            max_iters=int(o.get("pdhg_max_iters", 20000)),
            eps=float(o.get("pdhg_eps", 1e-6)),
            check_every=int(o.get("pdhg_check_every", 40)),
            restart_every=int(o.get("pdhg_restart_every", 16)),
            use_pallas=o.get("pdhg_use_pallas", "auto"),
            pallas_tile=int(o.get("pdhg_pallas_tile", 8)),
            pallas_interpret=bool(o.get("pdhg_pallas_interpret", False)),
            restart_mode=str(o.get("pdhg_restart_mode", "adaptive")),
            restart_beta_sufficient=float(
                o.get("pdhg_restart_beta_sufficient", 0.2)),
            restart_beta_necessary=float(
                o.get("pdhg_restart_beta_necessary", 0.8)),
            compact_threshold=float(o.get("pdhg_compact_threshold", 0.0)),
            hot_dtype=o.get("pdhg_hot_dtype"),
            sparse_threshold=float(o.get("pdhg_sparse_threshold", 0.0)))

    def config_key(self):
        """Hashable construction-time config (what `_solve_impl` reads,
        and compact_threshold, so that configs with different
        compaction policies never alias in caches keyed on it)."""
        return (self.max_iters, self.eps, self.check_every,
                self.restart_every, self.omega0, self.use_pallas,
                self.pallas_tile, self.pallas_interpret,
                self.restart_mode, self.restart_beta_sufficient,
                self.restart_beta_necessary, self.compact_threshold,
                self.hot_dtype, self.sparse_threshold)

    def clone(self, **overrides):
        """A new solver with this one's full config, selected fields
        overridden."""
        cfg = dict(
            max_iters=self.max_iters, eps=self.eps,
            check_every=self.check_every,
            restart_every=self.restart_every, omega0=self.omega0,
            use_pallas=self.use_pallas, pallas_tile=self.pallas_tile,
            pallas_interpret=self.pallas_interpret,
            restart_mode=self.restart_mode,
            restart_beta_sufficient=self.restart_beta_sufficient,
            restart_beta_necessary=self.restart_beta_necessary,
            compact_threshold=self.compact_threshold,
            hot_dtype=self.hot_dtype,
            sparse_threshold=self.sparse_threshold)
        cfg.update(overrides)
        return type(self)(**cfg)

    # -- mixed precision ---------------------------------------------------
    def hot_eps_floor(self):
        """Tolerance floor of the hot dtype's compute precision (0.0
        when the hot loop runs full precision)."""
        if self.hot_dtype is None:
            return 0.0
        return eps_floor(HOT_DTYPES[self.hot_dtype][1])

    def wants_promotion(self, eps=None):
        """True when a solve at tolerance `eps` needs more precision
        than the hot dtype can express (the promotion rule)."""
        if self.hot_dtype is None:
            return False
        e = self.eps if eps is None else float(eps)
        return e < self.hot_eps_floor()

    def _hot_pair(self, caller_dtype):
        """(storage, compute) dtypes for the hot loop given the caller's
        dtype, or None when no downcast applies."""
        if self.hot_dtype is None:
            return None
        store, compute = HOT_DTYPES[self.hot_dtype]
        if caller_dtype == store and caller_dtype == compute:
            return None
        if torch.finfo(caller_dtype).bits < torch.finfo(compute).bits:
            return None     # never upcast the caller's data
        return store, compute

    # -- public ----------------------------------------------------------
    def solve(self, prep: PreparedBatch, c, qdiag, lb, ub,
              obj_const=None, x0=None, y0=None, consensus=None,
              eps=None, iters_cap=None) -> SolveResult:
        """Solve the batch.  c/qdiag/lb/ub are UNSCALED user-space
        (S, N) tensors; x0/y0 optional warm starts in user space; `eps`
        overrides the construction-time tolerance for this call."""
        S, N = c.shape
        M = prep.A.shape[1]
        if obj_const is None:
            obj_const = torch.zeros((S,), dtype=c.dtype, device=c.device)
        if x0 is None:
            x0 = torch.zeros((S, N), dtype=c.dtype, device=c.device)
        if y0 is None:
            y0 = torch.zeros((S, M), dtype=c.dtype, device=c.device)
        return self._solve_impl(prep, c, qdiag, lb, ub, obj_const, x0, y0,
                                consensus, eps, iters_cap)

    def solve_compacted(self, prep: PreparedBatch, c, qdiag, lb, ub,
                        obj_const=None, x0=None, y0=None, consensus=None,
                        eps=None, probs=None, segment_iters=None,
                        on_segment=None) -> SolveResult:
        """`solve`, segmented on the host so that converged scenarios
        stop paying for steps (ops/pdhg.py:696-815 of the JAX package).
        Each segment runs `segment_iters` inner iterations through
        `iters_cap` and reads the converged mask back; once the active
        (unconverged, prob>0) fraction is at most `compact_threshold`
        of the width, the survivors are gathered into the next smaller
        power-of-two width (`width_bucket`) and the loop goes on over
        the narrower slab, scattering results back into full-width
        buffers.

        Converged scenarios never re-enter a segment, so a scenario
        frozen in the first segment is bit-identical to the uncompacted
        solve's.  Survivors restart each segment from their own warm
        iterate, with their restart average and omega re-seeded, so
        they agree with the uncompacted solve only up to the KKT
        tolerance.  A survivor slab is padded to its width by repeating
        survivors; the duplicates are dropped at scatter time.

        Falls back to `solve` when compaction is off (compact_threshold
        0) or under a ConsensusSpec (consensus couples the batch).
        `probs`: optional (S,) probabilities; prob-0 rows never count as
        active.  `on_segment`: optional callback receiving a dict
        (width, active, iters, seg_iters) after each segment."""
        if self.compact_threshold <= 0.0 or consensus is not None:
            return self.solve(prep, c, qdiag, lb, ub, obj_const=obj_const,
                              x0=x0, y0=y0, consensus=consensus, eps=eps)
        S, N = c.shape
        M = prep.A.shape[1]
        dev = c.device
        if obj_const is None:
            obj_const = torch.zeros((S,), dtype=c.dtype, device=dev)
        if x0 is None:
            x0 = torch.zeros((S, N), dtype=c.dtype, device=dev)
        if y0 is None:
            y0 = torch.zeros((S, M), dtype=c.dtype, device=dev)
        seg = (int(segment_iters) if segment_iters
               else self.check_every * self.restart_every)
        seg = max(seg, self.check_every)

        real = np.arange(S)
        if probs is not None:
            p = (probs.detach().cpu().numpy() if torch.is_tensor(probs)
                 else np.asarray(probs)).reshape(-1)
            real = real[p > 0]

        bufs = None          # full-width result buffers (set by seg 1)
        restarts = None
        iters_done = 0
        width = S
        cur = None           # None = full width, else gathered indices
        cur_n = S            # how many leading rows of `cur` are real
        while True:
            cap = min(seg, self.max_iters - iters_done)
            if cap < self.check_every and bufs is not None:
                break
            if cur is None:
                res = self.solve(prep, c, qdiag, lb, ub,
                                 obj_const=obj_const, x0=x0, y0=y0,
                                 eps=eps, iters_cap=cap)
            else:
                ii = torch.as_tensor(cur, dtype=torch.long, device=dev)
                res = self.solve(
                    _gather_prep(prep, ii), c[ii], qdiag[ii], lb[ii],
                    ub[ii], obj_const=obj_const[ii], x0=bufs["x"][ii],
                    y0=bufs["y"][ii], eps=eps, iters_cap=cap)
            iters_done += int(res.iters)
            if bufs is None:
                bufs = {f: getattr(res, f) for f in _COMPACT_FIELDS}
                restarts = res.restarts
            else:
                ri = torch.as_tensor(cur[:cur_n], dtype=torch.long,
                                     device=dev)
                for f in bufs:
                    bufs[f] = bufs[f].index_copy(
                        0, ri, getattr(res, f)[:cur_n])
                restarts = restarts.index_add(0, ri, res.restarts[:cur_n])

            conv = bufs["converged"].cpu().numpy()
            act = real[~conv[real]]
            if on_segment is not None:
                on_segment({"width": int(width), "active": int(act.size),
                            "iters": iters_done,
                            "seg_iters": int(res.iters)})
            if act.size == 0 or iters_done >= self.max_iters:
                break
            target = width_bucket(act.size)
            if target < width and act.size <= self.compact_threshold * width:
                width = target
            # survivors only: converged rows stay frozen in `bufs`; the
            # slab is padded to its width by repeating survivors
            cur = np.resize(act, width)
            cur[:act.size] = act
            cur_n = int(act.size)

        return SolveResult(
            x=bufs["x"], y=bufs["y"], obj=bufs["obj"],
            dual_obj=bufs["dual_obj"], pres=bufs["pres"],
            dres=bufs["dres"], gap=bufs["gap"],
            converged=bufs["converged"], iters=iters_done,
            restarts=restarts)

    # -- impl --------------------------------------------------------
    def _solve_impl(self, prep, c, qdiag, lb, ub, obj_const, x0, y0,
                    consensus=None, eps=None, iters_cap=None,
                    per_scenario=False):
        """The solve.  `eps` is None (the solver's), a float, or an (S,)
        tensor of per-scenario tolerances (a coalesced group of requests,
        each with its own); `per_scenario` keeps `SolveResult.checks`,
        from which a group's requests read their own iteration counts.
        Every scenario's iterates depend on its own data alone, so a
        request solved inside a group follows the same steps as alone."""
        dc, dr = prep.d_col, prep.d_row
        # scale into solver space, in the caller's precision
        cs = c * dc
        qs = qdiag * dc * dc
        lbs = torch.where(torch.isfinite(lb), lb / dc, lb)
        ubs = torch.where(torch.isfinite(ub), ub / dc, ub)
        xq = x0 / dc
        xs0 = _proj_box(torch.where(torch.isfinite(xq), xq, 0.0), lbs, ubs)
        ys0 = y0 / dr
        A, rlo, rhi = prep.A, prep.row_lo, prep.row_hi
        # mixed precision: the loop runs in the hot compute dtype; the
        # final verdict and the SolveResult are in the caller's dtype
        # (the *_f views)
        out_dt = cs.dtype
        hot = self._hot_pair(out_dt)
        cs_f, qs_f, lbs_f, ubs_f = cs, qs, lbs, ubs
        A_f, rlo_f, rhi_f = A, rlo, rhi
        if hot is not None:
            store, compute = hot
            cs, qs = cs.to(compute), qs.to(compute)
            lbs, ubs = lbs.to(compute), ubs.to(compute)
            xs0, ys0 = xs0.to(compute), ys0.to(compute)
            rlo, rhi = rlo.to(compute), rhi.to(compute)
            A = _cast_A(A, store)
        S = cs.shape[0]
        # clamp the tolerance to what the loop dtype can express; a
        # comparison of a tensor with a Python float rounds the float
        # to the tensor's dtype, as the JAX code's astype does
        floor = eps_floor(cs.dtype)
        if eps is None:
            eps = max(self.eps, floor)
            eps_out = eps
        elif torch.is_tensor(eps):
            # per scenario: the scalar rule below, element by element
            # (floor is exact in both dtypes)
            eps_out = torch.clamp(eps.to(out_dt), min=floor)
            eps = eps_out.to(cs.dtype)
        else:
            eps_out = max(round_to_dtype(eps, out_dt), floor)
            eps = round_to_dtype(eps_out, cs.dtype)

        # the chunk kernel takes contiguous tensors
        A = A.contiguous()
        kin = [t.contiguous() for t in (cs, qs, lbs, ubs, rlo, rhi)]
        # the KKT checks and the matmul route read A in the loop's
        # compute dtype, cast up once per solve when it is stored lower
        # (jnp promotes bf16 x f32 operands to f32 in the JAX package)
        A_kkt = A if A.dtype == cs.dtype else _cast_A(A, cs.dtype)
        if consensus is not None:
            cons = _Consensus(consensus, cs)
            csum, cavg = cons.csum, cons.cavg
            anorm, qmax = cons.norm_and_qmax(A_kkt, qs)
            xs0 = _proj_box(cavg(xs0), lbs, ubs)   # consistent warm start
            route = "consensus"
        else:
            cons = csum = cavg = None
            anorm = prep.anorm.to(cs.dtype)
            qmax = torch.amax(qs, dim=1)
            optin = (smem_optin() if cs.device.type == "cuda"
                     else H100_SMEM_OPTIN)
            route = pick_route(operator_form(A, S), A.shape[1],
                               A.shape[2], A.dtype, optin)

        def steps(x, y, omega, n):
            """n PDHG iterations, in one kernel launch, on the matmul
            route or on the consensus route: final iterates + running
            sums."""
            sigma = 0.9 * omega / anorm
            tau = 0.9 / (omega * anorm + 0.9 * qmax)
            if route == "consensus":
                return consensus_chunk(A_kkt, *kin, x, y, tau, sigma, n,
                                       csum)
            if route == "matmul":
                return matmul_chunk(A_kkt, *kin, x, y, tau, sigma, n)
            return fused_chunk(A, *kin, x.contiguous(), y.contiguous(),
                               tau.contiguous(), sigma.contiguous(), n)

        def kkt_score(x, y, data=None):
            if data is None:
                data = (cs, qs, A_kkt, rlo, rhi, lbs, ubs)
            pres, dres, gap, pobj, dobj = _residuals(x, y, *data,
                                                     cavg=cavg)
            if cons is not None:
                # each EF copy is one problem: one verdict for its
                # scenarios, the gap from its objective sums
                pres, dres = cons.scen_max(pres), cons.scen_max(dres)
                ps, ds = cons.scen_sum(pobj), cons.scen_sum(dobj)
                gap = torch.abs(ps - ds) / (1.0 + torch.abs(ps)
                                            + torch.abs(ds))
            return pres + dres + gap, pres, dres, gap

        ne = self.check_every
        n_outer = self.max_iters // ne
        cap_outer = n_outer if iters_cap is None else min(
            n_outer, (int(iters_cap) + ne - 1) // ne)

        dev = cs.device
        score0 = kkt_score(xs0, ys0)[0]
        x, y = xs0, ys0
        x_sum, y_sum = torch.zeros_like(xs0), torch.zeros_like(ys0)
        nsum = torch.zeros((S,), dtype=cs.dtype, device=dev)
        x_last, y_last = xs0, ys0
        omega = torch.full((S,), self.omega0, dtype=cs.dtype, device=dev)
        converged = torch.zeros((S,), dtype=torch.bool, device=dev)
        x_best, y_best = xs0, ys0
        cycle = torch.zeros((S,), dtype=torch.int32, device=dev)
        score_restart = score0
        score_cand_prev = torch.full((S,), float("inf"), dtype=cs.dtype,
                                     device=dev)
        restarts = torch.zeros((S,), dtype=torch.int32, device=dev)
        checks = (torch.zeros((S,), dtype=torch.int32, device=dev)
                  if per_scenario else None)
        k = 0
        # one host sync per KKT check (the JAX while_loop's cond)
        while k < cap_outer and not bool(torch.all(converged)):
            xn, yn, xs, ys = steps(x, y, omega, ne)
            x_sum = x_sum + xs
            y_sum = y_sum + ys
            nsum = nsum + ne
            score_cur, pres, dres, gap = kkt_score(xn, yn)
            newly = (pres < eps) & (dres < eps) & (gap < eps)
            conv = converged | newly
            fresh = (newly & ~converged)[:, None]
            x_best = torch.where(fresh, xn, x_best)
            y_best = torch.where(fresh, yn, y_best)
            k += 1
            cycle = cycle + 1
            if checks is not None:
                checks = torch.where(converged, checks, k)

            # restart candidate: the better of {current, cycle average}
            xa = x_sum / nsum[:, None]
            ya = y_sum / nsum[:, None]
            score_avg = kkt_score(xa, ya)[0]
            take_avg = (score_avg < score_cur)[:, None]
            xr = torch.where(take_avg, xa, xn)
            yr = torch.where(take_avg, ya, yn)
            score_cand = torch.minimum(score_avg, score_cur)

            if self.restart_mode == "adaptive":
                suff = score_cand <= (self.restart_beta_sufficient
                                      * score_restart)
                nec = ((score_cand
                        <= self.restart_beta_necessary * score_restart)
                       & (score_cand > score_cand_prev))
                do_restart = suff | nec | (cycle >= self.restart_every)
            else:
                do_restart = cycle >= self.restart_every
            do_restart = do_restart & ~conv

            # primal weight update (PDLP-style smoothing); one omega
            # per EF copy under consensus
            if cons is not None:
                dx = cons.copy_norm(xr - x_last)
                dy = cons.copy_norm(yr - y_last)
            else:
                dx = torch.linalg.vector_norm(xr - x_last, dim=1)
                dy = torch.linalg.vector_norm(yr - y_last, dim=1)
            ok = (dx > 1e-12) & (dy > 1e-12)
            ratio = torch.where(ok, dy / torch.clamp(dx, min=1e-12), 1.0)
            om_new = torch.where(
                ok, torch.exp(0.5 * torch.log(ratio)
                              + 0.5 * torch.log(omega)), omega)
            om_new = torch.clamp(om_new, OMEGA_MIN, OMEGA_MAX)

            m = do_restart
            m2 = m[:, None]
            xr_ = torch.where(m2, xr, xn)
            yr_ = torch.where(m2, yr, yn)
            # freeze scenarios converged before this check
            cm = converged[:, None]
            x = torch.where(cm, x, xr_)
            y = torch.where(cm, y, yr_)
            x_sum = torch.where(m2, 0.0, x_sum)
            y_sum = torch.where(m2, 0.0, y_sum)
            nsum = torch.where(m, 0.0, nsum)
            x_last = torch.where(m2, xr, x_last)
            y_last = torch.where(m2, yr, y_last)
            omega = torch.where(m, om_new, omega)
            converged = conv
            cycle = torch.where(m, 0, cycle)
            score_restart = torch.where(m, score_cand, score_restart)
            # +inf at a restart so stagnation cannot fire on the new
            # cycle's first check
            score_cand_prev = torch.where(m, float("inf"), score_cand)
            restarts = restarts + m.to(torch.int32)

        cm = converged[:, None]
        x = torch.where(cm, x_best, x)
        y = torch.where(cm, y_best, y)
        if hot is not None:
            # final verdict in the caller's dtype: frozen scenarios keep
            # their hot-precision certificate, the recheck can only add
            x = x.to(out_dt)
            y = y.to(out_dt)
        # (a hot prep may be stored below the caller's precision: the
        # verdict promotes it, as jnp's type promotion does)
        _, pres, dres, gap = kkt_score(
            x, y, data=(cs_f, qs_f, _cast_A(A_f, out_dt), rlo_f.to(out_dt),
                        rhi_f.to(out_dt), lbs_f, ubs_f))
        # unscale
        xu = x * dc
        yu = y * dr
        pobj = (torch.sum(c * xu, dim=1)
                + 0.5 * torch.sum(qdiag * xu * xu, dim=1) + obj_const)
        rlo_u = torch.where(torch.isfinite(prep.row_lo),
                            prep.row_lo / dr, prep.row_lo)
        rhi_u = torch.where(torch.isfinite(prep.row_hi),
                            prep.row_hi / dr, prep.row_hi)
        dobj = _residuals(xu, yu, c, qdiag,
                          _cast_A(_unscale_A(prep.A, dr, dc), out_dt),
                          rlo_u, rhi_u, lb, ub, cavg=cavg)[4]
        return SolveResult(
            x=xu, y=yu, obj=pobj, dual_obj=dobj + obj_const,
            pres=pres, dres=dres, gap=gap,
            converged=converged | ((pres < eps_out) & (dres < eps_out)
                                   & (gap < eps_out)),
            iters=k * ne, restarts=restarts, checks=checks)


# the SolveResult fields solve_compacted scatters back per segment
_COMPACT_FIELDS = ("x", "y", "obj", "dual_obj", "pres", "dres", "gap",
                   "converged")


def width_bucket(n, floor=1):
    """Next power of two >= max(n, floor): the width of a compacted
    slab (the JAX package's serve/compile_cache.width_bucket).  Powers
    of two bound the distinct widths a solve launches at to log2(S)."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


#: inner iteration chunks run on the matmul route in this process
matmul_chunks = 0
# the route counters are bumped from the wheel's spoke threads too
_COUNT_LOCK = threading.Lock()


def matmul_chunk(A, cs, qs, lbs, ubs, rlo, rhi, x, y, tau, sigma, n):
    """n PDHG iterations through `ir.bmatvec` / `bmatvec_t`: the JAX
    package's XLA body (ops/pdhg.py:942-955) as torch ops.  Its matvecs
    are plain large matrix products on the shared block (one
    (S, N) x (N, M) product each) plus the delta `index_add_`; it is
    the route of operators too large for the chunk kernel's tile, not a
    kernel's plain version.  Returns (x, y, x_sum, y_sum)."""
    global matmul_chunks
    with _COUNT_LOCK:
        matmul_chunks += 1
    return _torch_steps(A, cs, qs, lbs, ubs, rlo, rhi, x, y, tau, sigma,
                        n)


def _torch_steps(A, cs, qs, lbs, ubs, rlo, rhi, x, y, tau, sigma, n,
                 csum=None):
    """The body of `matmul_chunk` and `consensus_chunk`; csum, when
    given, is applied to the primal gradient of every step."""
    t2 = tau[:, None]
    s2 = sigma[:, None]
    xs = torch.zeros_like(x)
    ys = torch.zeros_like(y)
    for _ in range(int(n)):
        grad = cs + qs * x + _ATy(A, y)
        if csum is not None:
            grad = csum(grad)
        xn = _proj_box(x - t2 * grad, lbs, ubs)
        xt = 2.0 * xn - x
        v = y + s2 * _Ax(A, xt)
        yn = _dual_prox(v, sigma, rlo, rhi)
        x, y = xn, yn
        xs = xs + xn
        ys = ys + yn
    return x, y, xs, ys


class _Consensus:
    """The consensus pieces of one solve (ops/pdhg.py:863-918 of the
    JAX package): `csum` segment-sums the nonant slots over their node
    members and broadcasts back (the adjoint of the shared-variable
    broadcast), `cavg` divides that by the member count, and the
    per-copy reductions map (S,) to each copy's sum or max, broadcast
    back, with num_copies stacked EFs of S / num_copies scenarios."""

    def __init__(self, spec, cs):
        dev = cs.device
        self.v0 = spec.v0
        self.na = torch.as_tensor(spec.nonant_idx, device=dev).long()
        _, self.segsum = node_segment_sum(
            torch.as_tensor(spec.node_of, device=dev), spec.num_nodes)
        self.counts = self.segsum(torch.ones_like(cs[:, self.na]))
        # z-space norm weights: a shared coordinate counted once
        self.wz = torch.ones_like(cs)
        self.wz[:, self.na] = 1.0 / self.counts
        self.nc = max(int(spec.num_copies or 1), 1)
        self.S0 = cs.shape[0] // self.nc

    def csum(self, g):
        g = g.clone()
        g[:, self.na] = self.segsum(g[:, self.na])
        return g

    def cavg(self, g):
        g = self.csum(g)
        g[:, self.na] = g[:, self.na] / self.counts
        return g

    def scen_sum(self, a):
        """(S,) -> per-copy sum, broadcast back to (S,)."""
        return torch.sum(a.reshape(self.nc, self.S0),
                         dim=1).repeat_interleave(self.S0)

    def scen_max(self, a):
        return torch.amax(a.reshape(self.nc, self.S0),
                          dim=1).repeat_interleave(self.S0)

    def copy_norm(self, d):
        """(S, n) -> the 2-norm of each copy's rows, broadcast (S,)."""
        return torch.sqrt(self.scen_sum(torch.sum(d * d, dim=1)))

    def znorm(self, g):
        return torch.sqrt(self.scen_sum(
            torch.sum(self.wz * g * g, dim=1))) + 1e-30

    def norm_and_qmax(self, A, qs):
        """(anorm, qmax), each (S,) and uniform per copy: ||.||_2 of the
        EF operator blockdiag(A) B by 40 power steps in z-space, and the
        largest summed quadratic coefficient."""
        S, N = qs.shape
        v = (normal_draw((S, N), qs.dtype, qs.device, 0) if self.v0 is None
             else torch.as_tensor(self.v0, dtype=qs.dtype,
                                  device=qs.device))
        v = self.cavg(v)
        for _ in range(40):
            v = v / self.znorm(v)[:, None]
            v = self.csum(_ATy(A, _Ax(A, v)))
        av = _Ax(A, v / self.znorm(v)[:, None])
        anorm = torch.sqrt(self.scen_sum(torch.sum(av * av, dim=1)))
        qmax = self.scen_max(torch.amax(self.csum(qs), dim=1))
        return torch.clamp(anorm, min=1.0).to(qs.dtype), qmax


#: inner iteration chunks run on the consensus route in this process
consensus_chunks = 0


def consensus_chunk(A, cs, qs, lbs, ubs, rlo, rhi, x, y, tau, sigma, n,
                    csum):
    """n PDHG iterations of a consensus (EF) solve: `matmul_chunk`'s
    body with the primal gradient segment-summed over node members
    (`csum`) before each update (ops/pdhg.py:942-955 with csum
    applied).  The sum couples the scenarios of a node, so no
    per-scenario kernel block can take it.  Returns (x, y, x_sum,
    y_sum)."""
    global consensus_chunks
    with _COUNT_LOCK:
        consensus_chunks += 1
    return _torch_steps(A, cs, qs, lbs, ubs, rlo, rhi, x, y, tau, sigma,
                        n, csum)


def round_to_dtype(v, dtype):
    """The Python float `v` rounded to `dtype`: the JAX package keeps
    tolerances as scalars of the batch dtype (jnp.asarray(v, dtype))."""
    return float(torch.tensor(float(v), dtype=dtype))
