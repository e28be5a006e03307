"""L-shaped (Benders) method (port of `mpisppy_tpu/opt/lshaped.py`).

A subproblem is the scenario LP with its nonant slots pinned to x̂ by
bounds (`spopt.fixed_nonant_bounds`): every scenario solves in one
batched PDHG call, and each pinned slot's reduced cost
r_j = c_j + q_j x_j + (A'y)_j is the cut gradient dq_s/dx̂_j.

The root is a small LP over [x (K,), eta (n_eta,)]: the first-stage
rows (rows of A whose support lies inside the nonant columns) plus a
fixed-capacity cut buffer of n_eta * (max_iter + 1) rows that start
free (row_lo = -inf) and activate as cuts arrive, so the root's shape
never changes.  The root is one shared (1, M, N) system: a root that
fits the kernel's tile takes the chunk kernel's shared form, a larger
one (farmer at S=1000) the matmul route.  Each root solve builds its
prep afresh, as the JAX package does.

eta's lower bounds come from the wait-and-see duals of the unpinned
first solve.  Cuts are multi-cut (one eta per scenario); `single_cut`
aggregates them.  Two-stage only, like the reference.

The root's rows are slack at its start, so its dual iterate starts at
zero and its solver's primal weight (1.0 at the start) moves only when
the dual motion over a restart exceeds the restart's 1e-12 gate.  In
the JAX package XLA contracts the dual update v - sigma * z into one
FMA, which leaves ~1e-12 of rounding remainder on each slack row, so
the weight moves when that remainder happens to cross the gate; here
the product is rounded on its own (as in the chunk kernel), the dual
stays exactly zero and a root that starts slack stalls at its
iteration cap (tests/lshaped_root_witness.py: farmer cm=10, the first
root converges in the JAX package at S=10 and S=100 and in neither
package at S=1000).  The JAX package then takes the unconverged
objective as its outer bound, which is no bound.  Here a root still
unconverged after ROOT_STALL_ITERS iterations is solved again from the
primal weight's floor (`OMEGA_MIN`, where the JAX package's weight
lands when its gate fires), warm from where it stopped, to the root's
own cap; a root that converges before, as every root of the parity
tests does, is the reference's.  `root_resolves` and
`root_unconverged` count both cases.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import global_toc
from ..device import host
from ..ir import bmatvec_t
from ..ops.pdhg import OMEGA_MIN, PDHGSolver, prepare_batch
from ..spopt import SPOpt

# iterations at the primal weight 1.0 after which a root counts as
# stalled: the JAX package's first roots of farmer S=10 and S=100, cm=10
# converge there in 2,520 and 4,160 (tests/lshaped_root_witness.py),
# and every farmer-3 root of tests/test_torch_lshaped.py converges
# before it in both packages
ROOT_STALL_ITERS = 10000


class LShapedMethod(SPOpt):
    _needs_dense_A = True   # cut generation indexes A by scenario

    def __init__(self, options, all_scenario_names, **kwargs):
        super().__init__(options, all_scenario_names, **kwargs)
        node_of = host(self.batch.tree.node_of)
        if self.batch.tree.num_nodes > 2 and node_of.max() > 0 and \
                np.any(node_of[: self.n_real_scens] > 0):
            raise RuntimeError(
                "LShapedMethod is two-stage only (so is the reference, "
                "opt/lshaped.py)")
        o = self.options
        self.max_iter = int(o.get("max_iter", 50))
        self.tol = float(o.get("tol", 1e-6))
        self.single_cut = bool(o.get("single_cut", False))
        self.verbose = bool(o.get("verbose", False))
        self.root_eps = float(o.get("root_eps", o.get("pdhg_eps", 1e-7)))

        self._build_root_skeleton()
        self.outer_bound = -np.inf if self.is_minimizing else np.inf
        self.inner_bound = np.inf if self.is_minimizing else -np.inf
        self.best_xhat = None
        self.iter = 0
        self.spcomm = None
        # (outer, inner, x̂) after each iteration
        self.history = []

    # -- root construction -------------------------------------------------
    def _build_root_skeleton(self):
        b = self.batch
        K = b.num_nonants
        S = self.n_real_scens
        na = host(b.nonant_idx)
        self.n_eta = 1 if self.single_cut else S

        # first-stage rows: support entirely inside the nonant columns
        A0 = host(b.A[0]).astype(np.float64)
        lo0 = host(b.row_lo[0]).astype(np.float64)
        hi0 = host(b.row_hi[0]).astype(np.float64)
        nz = np.abs(A0) > 0
        mask_cols = np.zeros(b.num_vars, bool)
        mask_cols[na] = True
        fs_rows = np.where(
            (nz.any(axis=1)) & (~nz[:, ~mask_cols].any(axis=1)))[0]
        self._fs_rows = fs_rows

        self.max_cuts = self.n_eta * (self.max_iter + 1)
        M_root = len(fs_rows) + self.max_cuts
        N_root = K + self.n_eta

        A = np.zeros((1, M_root, N_root))
        row_lo = np.full((1, M_root), -np.inf)
        row_hi = np.full((1, M_root), np.inf)
        A[0, : len(fs_rows), :K] = A0[np.ix_(fs_rows, na)]
        row_lo[0, : len(fs_rows)] = lo0[fs_rows]
        row_hi[0, : len(fs_rows)] = hi0[fs_rows]

        # objective: min sum_s p_s eta_s (the subproblem value q_s holds
        # the first-stage cost: pinned slots keep their c terms)
        c = np.zeros((1, N_root))
        if self.single_cut:
            c[0, K] = 1.0
        else:
            c[0, K:] = host(b.prob)[:S]
        lb = np.full((1, N_root), -np.inf)
        ub = np.full((1, N_root), np.inf)
        lb[0, :K] = host(b.lb[0])[na]
        ub[0, :K] = host(b.ub[0])[na]

        self._root = {"A": A, "row_lo": row_lo, "row_hi": row_hi,
                      "c": c, "lb": lb, "ub": ub,
                      "n_cuts": 0, "K": K, "S": S}
        self._root_solver = PDHGSolver(
            max_iters=int(self.options.get("root_max_iters", 50000)),
            eps=self.root_eps)
        self._root_warm = None
        self.root_resolves = 0
        self.root_unconverged = 0

    def _root_solve(self):
        r = self._root
        dt, dev = self.batch.c.dtype, self.device

        def t(a):
            return torch.as_tensor(a, dtype=dt, device=dev)

        prep = prepare_batch(t(r["A"]), t(r["row_lo"]), t(r["row_hi"]))
        x0 = y0 = None
        if self._root_warm is not None:
            x0, y0 = self._root_warm
        c = t(r["c"])
        args = (prep, c, torch.zeros_like(c), t(r["lb"]), t(r["ub"]))
        res = self._root_solver.solve(*args, x0=x0, y0=y0,
                                      iters_cap=ROOT_STALL_ITERS)
        if not bool(res.converged.all()):
            self.root_resolves += 1
            res = self._root_solver.clone(omega0=OMEGA_MIN).solve(
                *args, x0=res.x, y0=res.y)
            if not bool(res.converged.all()):
                self.root_unconverged += 1
                global_toc("L-shaped: the root LP did not converge; its "
                           "objective is no bound")
        self._root_warm = (res.x, res.y)
        xhat = host(res.x[0, : r["K"]]).astype(np.float64)
        return xhat, float(res.obj[0])

    def _add_cuts(self, xhat, q, grad, only=None):
        """Cut eta_s >= q_s + grad_s.(x - x̂), stored as the row
        eta_s - grad_s.x >= q_s - grad_s.x̂.  q: (S,) subproblem values;
        grad: (S, K).  `only` (S,) bool adds cuts for those scenarios
        alone (the others' subproblems failed)."""
        r = self._root
        K, S = r["K"], r["S"]
        if self.single_cut:
            p = host(self.batch.prob)[:S]
            q = np.array([np.dot(p, q)])
            grad = (p[:, None] * grad).sum(axis=0, keepdims=True)
            only = None
        for j in range(q.shape[0]):
            if only is not None and not only[j]:
                continue
            i = len(self._fs_rows) + r["n_cuts"]
            if r["n_cuts"] >= self.max_cuts:
                global_toc("L-shaped: cut buffer full; dropping cut")
                return
            r["A"][0, i, :K] = -grad[j]
            r["A"][0, i, K + j] = 1.0
            r["row_lo"][0, i] = q[j] - float(grad[j] @ xhat)
            r["n_cuts"] += 1

    # -- main loop (reference lshaped.py:508-679 lshaped_algorithm) --------
    def lshaped_algorithm(self):
        b = self.batch
        S = self.n_real_scens
        na = host(b.nonant_idx)
        prob = host(b.prob).astype(np.float64)

        # unpinned wait-and-see solves -> eta lower bounds and x̂_0
        global_toc("L-shaped iter0: wait-and-see solves")
        res = self.solve_loop(warm=False)
        ws_dual = host(res.dual_obj)[:S].astype(np.float64)
        K = b.num_nonants
        r = self._root
        if self.single_cut:
            pd = float(prob[:S] @ ws_dual)
            r["lb"][0, K] = pd - abs(pd) - 1.0
        else:
            r["lb"][0, K:] = ws_dual - np.abs(ws_dual) * 1e-6 - 1.0
        # first candidate: the probability-weighted average of the
        # wait-and-see nonants
        p = prob[:, None]
        x_na = host(b.nonants(res.x)).astype(np.float64)
        xhat = (p * x_na).sum(axis=0) / p.sum()

        for k in range(1, self.max_iter + 1):
            self.iter = k
            lb, ub = self.fixed_nonant_bounds(xhat)
            sub = self.solve_loop(lb=lb, ub=ub, warm=True)
            q = host(sub.obj)[:S].astype(np.float64)
            grad = host(self._reduced_costs(sub))[:S][:, na].astype(
                np.float64)

            # nothing from a non-converged or infeasible subproblem
            feas_tol = 10 * self.solver.eps
            scen_ok = host(sub.pres)[:S] < feas_tol
            if bool(scen_ok.all()):
                ib = float(prob[:S] @ q)
                if self._ib_better(ib, self.inner_bound):
                    self.inner_bound = ib
                    self.best_xhat = xhat.copy()
                self._add_cuts(xhat, q, grad)
            else:
                bad = np.where(~scen_ok)[0]
                global_toc(f"L-shaped iter {k}: {bad.size} subproblem(s) "
                           "infeasible/non-converged at candidate; "
                           "adding cuts from feasible scenarios only")
                if not self.single_cut and scen_ok.any():
                    self._add_cuts(xhat, np.where(scen_ok, q, -np.inf),
                                   grad, only=scen_ok)
            xhat, root_obj = self._root_solve()
            self.outer_bound = root_obj
            self.history.append((self.outer_bound, self.inner_bound,
                                 xhat.copy()))

            gap = abs(self.inner_bound - self.outer_bound) / (
                1e-12 + abs(self.outer_bound))
            if self.verbose or k % 5 == 0 or k == 1:
                global_toc(f"L-shaped iter {k:3d} outer={root_obj:.6g} "
                           f"inner={self.inner_bound:.6g} gap={gap:.3e}")
            if self.spcomm is not None:
                self.spcomm.sync()
                if self.spcomm.is_converged():
                    global_toc(f"L-shaped terminated by hub at iter {k}")
                    break
            if gap <= self.tol:
                global_toc(f"L-shaped converged at iter {k} "
                           f"(gap {gap:.3e})")
                break
        self.first_stage_solution = self.best_xhat
        return self.outer_bound, self.inner_bound, self.best_xhat

    def _ib_better(self, new, old):
        return new < old if self.is_minimizing else new > old

    def _reduced_costs(self, res):
        """r = c + qdiag*x + A'y per scenario (user space)."""
        b = self.batch
        return b.c + b.qdiag * res.x + bmatvec_t(b.A, res.y)

    def root_xbar(self):
        """The incumbent x̂ (what the spokes evaluate)."""
        return self.best_xhat
