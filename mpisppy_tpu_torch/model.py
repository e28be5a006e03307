"""Declarative linear-model builder (port of `mpisppy_tpu/model.py`).

A `scenario_creator` builds a `LinearModel`, declares variable blocks,
constraints and per-stage costs, then calls `lower()`, which assembles
one scenario's dense arrays in numpy, as the JAX builder does, and
returns the port's single-scenario `ScenarioBatch` (S=1) on `device`
(default: the CUDA device).  `ir.stack_scenarios` stacks such batches;
`SPBase(scenario_creator=...)` does that for a list of names.
"""

from __future__ import annotations

import numpy as np

from .convert import batch_from_arrays

INF = float("inf")


class _VarBlock:
    __slots__ = ("name", "offset", "size", "shape")

    def __init__(self, name, offset, size, shape):
        self.name = name
        self.offset = offset
        self.size = size
        self.shape = shape

    def __getitem__(self, idx):
        flat = np.ravel_multi_index(idx if isinstance(idx, tuple) else (idx,),
                                    self.shape)
        return self.offset + int(flat)

    def indices(self):
        return np.arange(self.offset, self.offset + self.size)


class LinearExpr:
    """Tiny linear expression: {var_index: coeff} + const."""

    __slots__ = ("terms", "const")

    def __init__(self, terms=None, const=0.0):
        self.terms = dict(terms or {})
        self.const = const

    def add(self, idx, coeff):
        self.terms[idx] = self.terms.get(idx, 0.0) + coeff
        return self


class LinearModel:
    """Build one scenario's LP/QP.

    Usage (see models/farmer.py's scenario_creator for a full example):
        m = LinearModel()
        x = m.add_vars("DevotedAcreage", 3, lb=0, ub=500)
        m.add_constr({x[0]: 1, x[1]: 1, x[2]: 1}, hi=500)
        m.add_cost(stage=1, terms={x[0]: 150.0, ...})
        m.set_nonants([x], stage=1)
        spec = m.lower(prob=1/3, name="scen0", device="cpu")
    """

    def __init__(self, sense=1):
        # sense: +1 minimize, -1 maximize (objective is negated on lowering
        # so the kernels always minimize; mirrors SPBase._set_sense
        # at spbase.py:122)
        self.sense = sense
        self._blocks = {}
        self._n = 0
        self._lb = []
        self._ub = []
        self._integer = []
        self._rows = []        # list of (terms_dict, lo, hi)
        self._stage_costs = {}  # stage -> {idx: coeff}
        self._obj_const = 0.0
        self._nonant_blocks = []  # list of (block, stage)
        self._var_names = []

    # ---- variables -----------------------------------------------------
    def add_vars(self, name, shape, lb=0.0, ub=INF, integer=False):
        if isinstance(shape, int):
            shape = (shape,)
        size = int(np.prod(shape))
        blk = _VarBlock(name, self._n, size, shape)
        self._blocks[name] = blk
        self._n += size
        self._lb.extend(np.broadcast_to(lb, (size,)).astype(float).tolist())
        self._ub.extend(np.broadcast_to(ub, (size,)).astype(float).tolist())
        self._integer.extend(np.broadcast_to(integer, (size,)).tolist())
        if size == 1:
            self._var_names.append(name)
        else:
            self._var_names.extend(f"{name}[{i}]" for i in range(size))
        return blk

    def add_var(self, name, lb=0.0, ub=INF, integer=False):
        return self.add_vars(name, 1, lb=lb, ub=ub, integer=integer)[0]

    # ---- constraints ---------------------------------------------------
    def add_constr(self, terms, lo=-INF, hi=INF):
        """terms: {var_index: coeff} (or LinearExpr).  lo <= a@x <= hi."""
        if isinstance(terms, LinearExpr):
            lo = lo - terms.const if lo != -INF else lo
            hi = hi - terms.const if hi != INF else hi
            terms = terms.terms
        self._rows.append((dict(terms), float(lo), float(hi)))

    def add_constr_rows(self, A_rows, idx_cols, lo, hi):
        """Vectorized: A_rows (R, k) coeffs hitting columns idx_cols (R, k)."""
        A_rows = np.asarray(A_rows, dtype=float)
        idx_cols = np.asarray(idx_cols)
        lo = np.broadcast_to(lo, (A_rows.shape[0],))
        hi = np.broadcast_to(hi, (A_rows.shape[0],))
        for r in range(A_rows.shape[0]):
            self._rows.append(
                (dict(zip(idx_cols[r].tolist(), A_rows[r].tolist())),
                 float(lo[r]), float(hi[r])))

    # ---- objective -----------------------------------------------------
    def add_cost(self, stage, terms, const=0.0):
        """Attach per-stage cost (reference: ScenarioNode.cost_expression,
        scenario_tree.py:44).  terms: {var_index: coeff}."""
        d = self._stage_costs.setdefault(stage, {})
        if isinstance(terms, LinearExpr):
            const = const + terms.const
            terms = terms.terms
        for i, cf in terms.items():
            d[i] = d.get(i, 0.0) + cf
        self._obj_const += const

    # ---- nonanticipativity --------------------------------------------
    def set_nonants(self, blocks, stage=1):
        """Declare nonant variable blocks for a stage, in order
        (reference: nonant_list on ScenarioNode)."""
        for b in blocks:
            self._nonant_blocks.append((b, stage))

    # ---- lowering ------------------------------------------------------
    def lower(self, prob, name="scen", node_ids=None, num_nodes=1,
              dtype=np.float64, pad_rows_to=None, device=None):
        """A single-scenario ScenarioBatch (S=1) on `device` (default:
        the CUDA device), assembled in numpy.

        node_ids: optional (K,) array of global tree-node ids per nonant
        slot (multistage); default all-ROOT (two-stage).
        """
        n = self._n
        m = len(self._rows)
        mpad = max(m, pad_rows_to or 0)
        A = np.zeros((mpad, n), dtype=dtype)
        row_lo = np.full((mpad,), -INF, dtype=dtype)
        row_hi = np.full((mpad,), INF, dtype=dtype)
        for r, (terms, lo, hi) in enumerate(self._rows):
            for i, cf in terms.items():
                A[r, i] += cf
            row_lo[r] = lo
            row_hi[r] = hi

        c = np.zeros((n,), dtype=dtype)
        stages = sorted(self._stage_costs)
        n_stages = max(stages) if stages else 1
        stage_cost_c = np.zeros((n_stages, n), dtype=dtype)
        for st, d in self._stage_costs.items():
            for i, cf in d.items():
                stage_cost_c[st - 1, i] += cf
                c[i] += cf
        if self.sense < 0:
            c = -c
            stage_cost_c = -stage_cost_c

        nonant_idx = np.concatenate(
            [b.indices() for b, _st in self._nonant_blocks]
        ).astype(np.int32) if self._nonant_blocks else np.zeros(
            (0,), np.int32)
        stage_of = np.concatenate(
            [np.full((b.size,), st, np.int32)
             for b, st in self._nonant_blocks]
        ) if self._nonant_blocks else np.zeros((0,), np.int32)
        K = nonant_idx.shape[0]
        if node_ids is None:
            node_ids = np.zeros((K,), np.int32)
        node_ids = np.asarray(node_ids, np.int32).reshape(1, K)

        tree = dict(
            node_of=node_ids,
            prob=np.asarray([prob], dtype=dtype),
            num_nodes=num_nodes,
            stage_of=tuple(stage_of.tolist()),
            nonant_names=tuple(self._var_names[i] for i in nonant_idx),
            scen_names=(name,),
        )
        return batch_from_arrays(dict(
            c=c[None], qdiag=np.zeros((1, n), dtype=dtype),
            A=A[None], row_lo=row_lo[None], row_hi=row_hi[None],
            lb=np.asarray(self._lb, dtype=dtype)[None],
            ub=np.asarray(self._ub, dtype=dtype)[None],
            obj_const=np.asarray(
                [self._obj_const * (1 if self.sense > 0 else -1)],
                dtype=dtype),
            nonant_idx=nonant_idx,
            integer_mask=np.asarray(self._integer, dtype=bool)[None],
            tree=tree,
            stage_cost_c=stage_cost_c[:, None, :],
            var_names=tuple(self._var_names),
        ), device=device)
