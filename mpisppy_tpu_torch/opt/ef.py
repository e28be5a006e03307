"""ExtensiveForm — the monolithic EF solve (port of
`mpisppy_tpu/opt/ef.py`).

The EF is never built: the batched PDHG solver runs in consensus mode
(`ops.pdhg.ConsensusSpec`), where each (tree node, nonant slot) is one
variable shared by the node's scenarios.  The per-scenario matvecs stay
batched and the coupling is one segment sum per inner iteration (the
solver's consensus route).  The probability weights move into the
per-scenario objective arrays.

One difference from the JAX package, on purpose: the float64 re-solve
of an unconverged EF (`_certified_ef_resolve`) runs on the batch's own
device, as `SPOpt._certified_resolve` does, where the JAX package moves
it to the host CPU.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .. import global_toc
from ..ops.pdhg import ConsensusSpec, prepare_batch
from ..spopt import SPOpt, _sync


class ExtensiveForm(SPOpt):
    # consensus solves need one column scaling shared by all scenarios;
    # SPOpt._build_prep reads this so the batch is prepared once
    _shared_cols = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        b = self.batch
        self.consensus = ConsensusSpec(
            node_of=b.tree.node_of, nonant_idx=b.nonant_idx,
            num_nodes=b.tree.num_nodes)
        self._result = None

    def solve_extensive_form(self, solver_options=None, tee=False,
                             certify=True, x0=None, y0=None):
        """One batched consensus solve, the reference's single
        monolithic solver call (opt/ef.py:66).  certify: when the fast
        solve leaves the coupled EF unconverged, re-solve the full
        batch in float64, warm-started.  x0/y0: user-space warm
        starts."""
        b = self.batch
        t0 = time.time()
        p = b.prob[:, None]
        res = self.solver.solve(
            self.prep, b.c * p, b.qdiag * p, b.lb, b.ub,
            obj_const=b.obj_const * b.prob, x0=x0, y0=y0,
            consensus=self.consensus)
        it_n = int(res.iters)
        self._account(self.prep, it_n)
        self._kernel_iters += it_n
        self._restarts_total += int(torch.sum(res.restarts))
        if certify and not bool(torch.all(res.converged)):
            res = self._certified_ef_resolve(res)
        _sync(res.x)
        self._solve_wall += time.time() - t0
        self._result = res
        global_toc(
            f"EF solve: obj={self.get_objective_value():.6g} "
            f"pres={float(torch.max(res.pres)):.2e} "
            f"gap={float(torch.max(res.gap)):.2e} "
            f"iters={int(res.iters)}", tee)
        return res

    def _certified_ef_resolve(self, res, c=None, qdiag=None, lb=None,
                              ub=None, obj_const=None):
        """Full-batch float64 consensus re-solve, warm-started from the
        fast result, on the batch's device.  The consensus system
        cannot be cut to its stragglers as the per-scenario fallback
        is.  c/qdiag/lb/ub/obj_const override the batch's own
        (probability-weighted) arrays: a caller that solves a modified
        EF (the MIP dive fixes integer boxes) passes its arrays."""
        t_cert = time.time()
        b = self.batch
        f64 = torch.float64
        p = b.prob.to(f64)[:, None]

        def pick(t, default):
            return (default if t is None else t).to(f64)

        c = pick(c, b.c.to(f64) * p)
        qdiag = pick(qdiag, b.qdiag.to(f64) * p)
        obj_const = pick(obj_const, b.obj_const.to(f64) * p[:, 0])
        lb, ub = pick(lb, b.lb), pick(ub, b.ub)
        prep64 = prepare_batch(b.A.to(f64), b.row_lo.to(f64),
                               b.row_hi.to(f64), shared_cols=True)
        # hot_dtype pinned off: this is the certified f64 authority for
        # the coupled EF solve
        s64 = self.solver.clone(
            max_iters=max(self.solver.max_iters, 100000), hot_dtype=None)
        r64 = s64.solve(prep64, c, qdiag, lb, ub, obj_const=obj_const,
                        x0=res.x.to(f64), y0=res.y.to(f64),
                        consensus=self.consensus,
                        eps=float(self.solver.eps))
        self._account(prep64, int(r64.iters))
        self._certify_wall += time.time() - t_cert
        if not bool(torch.all(r64.converged)):
            global_toc("WARNING: EF f64 fallback did not fully converge")
        dt = res.x.dtype
        return dataclasses.replace(
            res, x=r64.x.to(dt), y=r64.y.to(dt), obj=r64.obj.to(dt),
            dual_obj=r64.dual_obj.to(dt), pres=r64.pres.to(dt),
            dres=r64.dres.to(dt), gap=r64.gap.to(dt),
            converged=r64.converged)

    @property
    def solved(self):
        return self._result is not None

    def _need_result(self):
        if self._result is None:
            raise RuntimeError("call solve_extensive_form first")
        return self._result

    def get_objective_value(self):
        """EF objective: the sum of the probability-weighted scenario
        pieces (reference opt/ef.py:97)."""
        return float(torch.sum(self._need_result().obj))

    def get_dual_bound(self):
        """A valid lower bound from the EF dual estimate."""
        return float(torch.sum(self._need_result().dual_obj))

    def get_root_solution(self):
        """Root-node nonant values (K,) (reference opt/ef.py:114): every
        scenario agrees by construction, so scenario 0's."""
        x_na = self.batch.nonants(self._need_result().x)
        return x_na[0].cpu().numpy()

    def nonants(self):
        """Per-scenario nonant values of the real scenarios (reference
        sputils.ef_nonants)."""
        x_na = self.batch.nonants(self._need_result().x)
        return x_na.cpu().numpy()[: self.n_real_scens]


def ef_dual_bound(batch, scenario_names, eps=1e-5, max_iters=100000,
                  device=None):
    """(bound, seconds): one consensus-EF LP solve's dual objective, a
    valid outer bound at any iterate when the batch is an LP with
    all-finite boxes.  The protocol of bench.py's UC row."""
    t0 = time.time()
    ef = ExtensiveForm({"pdhg_eps": eps, "pdhg_max_iters": max_iters},
                       scenario_names, batch=batch, device=device)
    ef.solve_extensive_form()
    return ef.get_dual_bound(), time.time() - t0
