"""PHBase — Progressive Hedging machinery (port of
`mpisppy_tpu/phbase.py`).

One PH iteration is one superstep:

    x  <- argmin_x  c@x + (W - rho*xbar)@x_na + rho/2 ||x_na||^2 + ...
    xbar <- per-node probability-weighted average (segment sum)
    W  <- W + rho * (x_na - xbar)
    conv <- prob-weighted scaled ||x - xbar||_1

The JAX package jits the superstep; here it is a plain function of
tensors, and the PDHG solve inside it runs its inner iterations in the
CUDA chunk kernel.

When a hub (`cylinders/hub.py`) drives the loop, `iterk_loop` calls
its `sync()` after every iteration and stops when `is_converged()`.

Telemetry (`options["telemetry"]`, `telemetry/`): each PH iteration is
a `ph.iteration` span with its counters, and with `phase_timing` the
superstep runs as four timed cuts (solve / x̄ / W update / conv), each
a `ph.phase.*` span with a device sync after it.  With telemetry off
the superstep is the plain call with one sync.

Extensions (`extensions/`) are called at the hook points of the loop;
they may replace `rho`, `lb_eff`/`ub_eff` (`fix_nonants`) or
`solver_eps` between supersteps, and every superstep receives the
current values as arguments.  `options["ph_converger"]` (a class of
`convergers/`) is polled once per iteration after the hub sync.

Crash-resume and fault injection (`resilience/`):
`options["run_checkpoint"]` names an atomic full-state checkpoint
written every `options["checkpoint_every"]` iterations (default 1);
`options["resume_from"]` restores one in place of Iter0 (opt/ph.py);
`options["chaos"]` arms the injectors, whose hub tick fires after that
iteration's checkpoint.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from . import global_toc
from .resilience.chaos import ChaosInjector
from .ir import ScenarioBatch, SparseSplitA, TreeInfo, node_segment_sum
from .ops.pdhg import round_to_dtype
from .spopt import SPOpt, _sync


@dataclasses.dataclass(frozen=True)
class PHState:
    """Per-iteration PH state (tensors on the batch's device; scalar
    counters are Python ints)."""
    x: Any        # (S, N) last primal solutions
    y: Any        # (S, M) last duals
    W: Any        # (S, K) dual weights on nonants
    xbar: Any     # (S, K) per-slot consensus values
    xsqbar: Any   # (S, K) consensus of squares
    obj: Any      # (S,) per-scenario objective at x
    dual_obj: Any  # (S,)
    conv: Any     # () convergence metric
    it: int       # iteration count
    solve_iters: int = 0      # kernel iterations of the last solve
    active_frac: Any = 1.0    # () unconverged fraction of the last solve
    solve_restarts: Any = 0   # () restart events of the last solve
    promoted: int = 0         # 1 once a solve ran on the promoted pair


@dataclasses.dataclass(frozen=True)
class ScenarioView:
    """One scenario's slice of the solution state (what denouements
    receive in place of the reference's Pyomo scenario instance)."""
    index: int
    name: str
    x: Any
    nonants: Any
    obj: float
    prob: float
    W: Any
    xbar: Any


# ---- pure functional core ------------------------------------------------

def compute_xbar(batch: ScenarioBatch, x_na):
    """Per-node probability-weighted averages of nonant values
    (phbase.py:85-111).  A batch with `var_prob` (variable_probability)
    weights each (scenario, slot) by it instead of the scenario
    probability.  Returns (xbar, xsqbar), each (S, K)."""
    tree = batch.tree
    if batch.var_prob is not None:
        p = batch.var_prob.to(x_na.dtype)
    else:
        p = tree.prob[:, None].expand(x_na.shape)
    _, segsum = node_segment_sum(tree.node_of, tree.num_nodes)
    denom = torch.clamp(segsum(p), min=1e-30)
    xbar = segsum(p * x_na) / denom
    xsqbar = segsum(p * x_na * x_na) / denom
    return xbar, xsqbar


def ph_objective_arrays(batch: ScenarioBatch, W, rho, xbar,
                        W_on=1.0, prox_on=1.0):
    """Fold PH's W and prox terms into (c_eff, qdiag_eff); the xbar^2
    constant is dropped (objective values are reported from c)."""
    na = batch.nonant_idx
    c_eff = batch.c.clone()
    c_eff[:, na] += W_on * W - prox_on * rho * xbar
    q_eff = batch.qdiag.clone()
    q_eff[:, na] += prox_on * rho
    return c_eff, q_eff


def update_W(W, rho, x_na, xbar):
    """Dual update (reference phbase.py:293-318 Update_W)."""
    return W + rho * (x_na - xbar)


def _active_fraction(batch, converged):
    """Fraction of prob>0 scenarios the solve left unconverged."""
    live = batch.prob > 0
    n = torch.clamp(torch.sum(live), min=1)
    return torch.sum((~converged) & live) / n


def convergence_metric(batch: ScenarioBatch, x_na, xbar):
    """Scaled prob-weighted ||x - xbar||_1 (reference phbase.py:321)."""
    K = max(x_na.shape[1], 1)
    per_scen = torch.sum(torch.abs(x_na - xbar), dim=1) / K
    return torch.sum(batch.prob * per_scen)


def _superstep_solve(solver, state, rho, W_on, prox_on, lb, ub, eps,
                     prep, batch):
    """The solve cut of the superstep: PH's objective, one batched
    solve warm-started from the last iterate."""
    c_eff, q_eff = ph_objective_arrays(
        batch, state.W, rho, state.xbar, W_on=W_on, prox_on=prox_on)
    return solver._solve_impl(prep, c_eff, q_eff, lb, ub, batch.obj_const,
                              state.x, state.y, None, eps)


def _next_state(state, res, W, xbar, xsqbar, conv, obj, batch):
    return PHState(
        x=res.x, y=res.y, W=W, xbar=xbar, xsqbar=xsqbar, obj=obj,
        dual_obj=res.dual_obj, conv=conv, it=state.it + 1,
        solve_iters=res.iters,
        active_frac=_active_fraction(batch, res.converged),
        solve_restarts=torch.sum(res.restarts))


def ph_superstep(solver, state: PHState, rho, W_on, prox_on,
                 lb, ub, eps, prep, batch):
    """One PH iteration as a function of its inputs: solve -> xbar
    consensus -> W update -> convergence metric."""
    res = _superstep_solve(solver, state, rho, W_on, prox_on, lb, ub, eps,
                           prep, batch)
    x_na = batch.nonants(res.x)
    xbar, xsqbar = compute_xbar(batch, x_na)
    W = update_W(state.W, rho, x_na, xbar)
    conv = convergence_metric(batch, x_na, xbar)
    return _next_state(state, res, W, xbar, xsqbar, conv,
                       batch.objective(res.x), batch)


# ---- a coalesced group of same-bucket requests (serve/) -------------------

class GroupRefused(ValueError):
    """Raised when requests cannot share one group solve (operators of
    different forms, or split deltas at different coordinates); the
    service then runs them one by one."""


@dataclasses.dataclass(frozen=True)
class GroupArgs:
    """The superstep arguments of B same-bucket PH instances stacked
    along the scenario axis: request b owns rows b*S .. (b+1)*S - 1 of
    every (B*S, ...) tensor.  The counterpart of the JAX package's
    vmap over a leading request axis (serve/service.py:86-120 there):
    `state` is a PHState whose conv, active_frac and solve_restarts are
    (B,) tensors and whose it and solve_iters are tuples; eps, W_on and
    prox_on are each request's, per scenario."""
    state: PHState
    rho: Any
    W_on: Any       # (B*S, 1)
    prox_on: Any    # (B*S, 1)
    lb: Any
    ub: Any
    eps: Any        # (B*S,) superstep tolerance of each request
    prep: Any       # PreparedBatch over the B*S scenarios, grouped A
    batch: ScenarioBatch
    B: int
    S: int


def _rows(t, S):
    """A per-scenario leaf with a singleton (shared) leading axis
    expanded to S rows."""
    return t.expand((S,) + tuple(t.shape[1:])) if t.shape[0] == 1 else t


def stack_preps(preps, S):
    """One PreparedBatch over the B*S scenarios of B requests: A as a
    group of B matrices (an `ir.GroupedA`, or a SplitA with a (B, M, N)
    shared block; dense per-scenario A's are concatenated), each
    request's scalings and norm estimate repeated over its rows.
    Raises GroupRefused when the operators differ in form or the split
    deltas in their coordinates (the kernel reads one (rows, cols) for
    the whole group; nothing is densified)."""
    from .ir import GroupedA, SplitA
    from .ops.pdhg import PreparedBatch
    As = [p.A for p in preps]
    if all(isinstance(a, SplitA) for a in As):
        if any(isinstance(a, SparseSplitA) for a in As):
            raise GroupRefused("a sparse shared block does not group")
        a0 = As[0]
        for a in As[1:]:
            if not (torch.equal(a.rows, a0.rows)
                    and torch.equal(a.cols, a0.cols)):
                raise GroupRefused("split deltas at different "
                                   "coordinates")
        A = SplitA(shared=torch.stack([a.shared for a in As]),
                   rows=a0.rows, cols=a0.cols,
                   vals=torch.cat([a.vals for a in As]))
    elif any(isinstance(a, SplitA) for a in As):
        raise GroupRefused("split and unsplit operators in one group")
    elif all(a.shape[0] == 1 for a in As):
        A = GroupedA(stack=torch.cat(As), per_base=S)   # one each
    elif all(a.shape[0] == S for a in As):
        A = torch.cat(As)                      # dense (B*S, M, N)
    else:
        raise GroupRefused("shared and per-scenario operators in one "
                           "group")

    def cat(field):
        return torch.cat([_rows(getattr(p, field), S) for p in preps])

    return PreparedBatch(A=A, row_lo=cat("row_lo"), row_hi=cat("row_hi"),
                         d_row=cat("d_row"), d_col=cat("d_col"),
                         anorm=cat("anorm"))


def stack_batches(batches):
    """The B batches' per-scenario fields concatenated, each request's
    tree nodes offset so that its x̄ averages over its own scenarios
    (A is left out: the group's operator lives in its prep)."""
    b0 = batches[0]
    nn = b0.tree.num_nodes

    def cat(field):
        vals = [getattr(b, field) for b in batches]
        return None if vals[0] is None else torch.cat(vals)

    tree = TreeInfo(
        node_of=torch.cat([b.tree.node_of + i * nn
                           for i, b in enumerate(batches)]),
        prob=torch.cat([b.tree.prob for b in batches]),
        num_nodes=nn * len(batches), stage_of=b0.tree.stage_of,
        nonant_names=b0.tree.nonant_names,
        scen_names=tuple(n for b in batches for n in b.tree.scen_names))
    return ScenarioBatch(
        c=cat("c"), qdiag=cat("qdiag"), A=None, row_lo=cat("row_lo"),
        row_hi=cat("row_hi"), lb=cat("lb"), ub=cat("ub"),
        obj_const=cat("obj_const"), nonant_idx=b0.nonant_idx,
        integer_mask=cat("integer_mask"), tree=tree,
        var_names=b0.var_names, var_prob=cat("var_prob"))


def stack_group(phs):
    """GroupArgs of B PH instances of one bucket after their Iter0."""
    S = phs[0].batch.num_scens
    dev = phs[0].device
    dt = phs[0].batch.c.dtype

    def cat(get):
        return torch.cat([get(ph) for ph in phs])

    def per_scen(get):
        return torch.tensor([float(get(ph)) for ph in phs], dtype=dt,
                            device=dev).repeat_interleave(S)

    st0 = phs[0].state
    state = PHState(
        x=cat(lambda p: p.state.x), y=cat(lambda p: p.state.y),
        W=cat(lambda p: p.state.W), xbar=cat(lambda p: p.state.xbar),
        xsqbar=cat(lambda p: p.state.xsqbar),
        obj=cat(lambda p: p.state.obj),
        dual_obj=cat(lambda p: p.state.dual_obj),
        conv=torch.stack([torch.as_tensor(p.state.conv, device=dev)
                          for p in phs]),
        it=tuple(int(p.state.it) for p in phs),
        solve_iters=tuple(int(p.state.solve_iters) for p in phs),
        active_frac=st0.active_frac, solve_restarts=st0.solve_restarts)
    return GroupArgs(
        state=state, rho=cat(lambda p: p.rho),
        W_on=per_scen(lambda p: p.W_on)[:, None],
        prox_on=per_scen(lambda p: p.prox_on)[:, None],
        lb=cat(lambda p: p.lb_eff), ub=cat(lambda p: p.ub_eff),
        eps=per_scen(lambda p: p.superstep_eps),
        prep=stack_preps([p.prep for p in phs], S),
        batch=stack_batches([p.batch for p in phs]), B=len(phs), S=S)


def group_superstep(solver, g: GroupArgs):
    """One PH iteration of every request of a group: ONE PDHG solve
    over the B*S scenarios (one kernel launch a chunk for the group),
    then each request's own x̄ (its tree nodes offset), W update and
    convergence metric.  Returns the group's next PHState."""
    st, b, B, S = g.state, g.batch, g.B, g.S
    c_eff, q_eff = ph_objective_arrays(b, st.W, g.rho, st.xbar,
                                       W_on=g.W_on, prox_on=g.prox_on)
    res = solver._solve_impl(g.prep, c_eff, q_eff, g.lb, g.ub, b.obj_const,
                             st.x, st.y, None, g.eps, per_scenario=True)
    x_na = b.nonants(res.x)
    xbar, xsqbar = compute_xbar(b, x_na)
    W = update_W(st.W, g.rho, x_na, xbar)
    K = max(x_na.shape[1], 1)
    per_scen = torch.sum(torch.abs(x_na - xbar), dim=1) / K
    wp = b.prob * per_scen
    # each request's metric over its own rows, as convergence_metric
    # sums them alone
    conv = torch.stack([torch.sum(wp[i * S:(i + 1) * S]) for i in range(B)])
    live = (b.prob > 0).reshape(B, S)
    unconv = (~res.converged).reshape(B, S) & live
    checks = res.checks.reshape(B, S).amax(dim=1).tolist()
    ne = solver.check_every
    return PHState(
        x=res.x, y=res.y, W=W, xbar=xbar, xsqbar=xsqbar,
        obj=b.objective(res.x), dual_obj=res.dual_obj, conv=conv,
        it=tuple(i + 1 for i in st.it),
        solve_iters=tuple(int(c) * ne for c in checks),
        active_frac=(torch.sum(unconv, dim=1)
                     / torch.clamp(torch.sum(live, dim=1), min=1)),
        solve_restarts=torch.sum(res.restarts.reshape(B, S), dim=1))


def unstack_state(state: PHState, i, S):
    """Request i's own PHState out of a group's."""
    rows = slice(i * S, (i + 1) * S)
    return PHState(
        x=state.x[rows], y=state.y[rows], W=state.W[rows],
        xbar=state.xbar[rows], xsqbar=state.xsqbar[rows],
        obj=state.obj[rows], dual_obj=state.dual_obj[rows],
        conv=state.conv[i], it=state.it[i],
        solve_iters=state.solve_iters[i],
        active_frac=state.active_frac[i],
        solve_restarts=state.solve_restarts[i])


class PHBase(SPOpt):
    """Shared PH machinery; opt/ph.py's PH subclasses it."""

    def __init__(self, options, all_scenario_names, scenario_creator=None,
                 scenario_denouement=None, all_nodenames=None,
                 extensions=None, extension_kwargs=None,
                 rho_setter=None, variable_probability=None,
                 scenario_creator_kwargs=None, batch=None, device=None,
                 prep=None):
        super().__init__(
            options, all_scenario_names,
            scenario_creator=scenario_creator,
            scenario_denouement=scenario_denouement,
            all_nodenames=all_nodenames,
            scenario_creator_kwargs=scenario_creator_kwargs,
            variable_probability=variable_probability,
            batch=batch, device=device, prep=prep)
        self.rho_setter = rho_setter
        self.spcomm = None   # set by cylinders.hub when running as a hub
        self.extobject = None
        if extensions is not None:
            self.extobject = extensions(self, **(extension_kwargs or {}))
        self.W_on = 1.0
        self.prox_on = 1.0

        # rho: scalar option -> (S, K) tensor; rho_setter may override
        b = self.batch
        K, S = b.num_nonants, b.num_scens
        dt = b.c.dtype
        if rho_setter is not None:
            vals = np.asarray(rho_setter(b), dtype=float)
            rho = torch.as_tensor(vals, device=self.device).to(dt)
            rho = rho.expand(S, K).contiguous()
        else:
            rho = torch.full((S, K), float(self.options.get(
                "defaultPHrho", 1.0)), dtype=dt, device=self.device)
        self.rho = rho

        self.state: PHState | None = None
        self.trivial_bound = None
        self.best_bound = None
        self.conv = None
        # effective bounds: extensions pin nonants by tightening these
        self.lb_eff = b.lb
        self.ub_eff = b.ub
        self._superstep_eps_opt = self.options.get("superstep_eps")
        # inexactness ladder (options["eps_ladder"]): hot-loop solves
        # start loose and tighten with PH's convergence metric
        lad = self.options.get("eps_ladder")
        self._ladder = None
        if lad:
            lad = dict(lad) if isinstance(lad, dict) else {}
            self._ladder = {
                "start": float(lad.get(
                    "start", max(100.0 * self.solver.eps, 1e-3))),
                "min": float(lad.get("min", self.solver.eps)),
                "couple": float(lad.get("couple", 0.1)),
            }
            self._ladder_eps = self._ladder["start"]

        # optional converger: options["ph_converger"] is a class of
        # convergers/, polled once per PH iteration (iterk_loop)
        self.convobject = None
        conv_cls = self.options.get("ph_converger")
        if conv_cls is not None:
            self.convobject = conv_cls(self)
        # deterministic fault injectors (inert unless options["chaos"]
        # or the MPISPPY_TPU_CHAOS environment variable is set)
        self._chaos = ChaosInjector.from_options(self.options.get("chaos"))

    # -- hook plumbing (reference extensions/extension.py API) ------------
    def _ext(self, hook, *args):
        if self.extobject is not None:
            getattr(self.extobject, hook, lambda *a: None)(*args)

    # -- nonant fixing for extensions ------------------------------------
    def fix_nonants(self, mask, values):
        """Pin nonant slots where mask (S, K) is True to `values` (S, K)
        by tightening the effective bounds."""
        na = self.batch.nonant_idx
        vals = torch.as_tensor(values, device=self.device).to(
            self.batch.c.dtype)
        m = torch.as_tensor(mask, device=self.device).bool()
        lb, ub = self.lb_eff.clone(), self.ub_eff.clone()
        lb[:, na] = torch.where(m, vals, lb[:, na])
        ub[:, na] = torch.where(m, vals, ub[:, na])
        self.lb_eff, self.ub_eff = lb, ub

    def unfix_nonants(self, mask):
        """Restore original batch bounds where mask (S, K) is True."""
        b = self.batch
        na = b.nonant_idx
        m = torch.as_tensor(mask, device=self.device).bool()
        lb, ub = self.lb_eff.clone(), self.ub_eff.clone()
        lb[:, na] = torch.where(m, b.lb[:, na], lb[:, na])
        ub[:, na] = torch.where(m, b.ub[:, na], ub[:, na])
        self.lb_eff, self.ub_eff = lb, ub

    def count_fixed(self):
        """Nonant slots pinned by fix_nonants (lb_eff == ub_eff)."""
        na = self.batch.nonant_idx
        return int(torch.sum(self.lb_eff[:, na] == self.ub_eff[:, na]))

    # -- Iter0 (reference phbase.py:758-872) ------------------------------
    def Iter0(self):
        self._ext("pre_iter0")
        global_toc("Iter0: no-penalty solves")
        # certify="feas": refine (f64) only primal-infeasible scenarios
        res = self.solve_loop(
            lb=self.lb_eff, ub=self.ub_eff, warm=False,
            dtiming=self.options.get("display_timing"),
            certify=("feas" if self.options.get("iter0_certify", True)
                     else False))
        feas = self.feas_prob(res)
        self.iter0_feas_mass = float(feas)
        if feas < 1.0 - 1e-6:
            if self.options.get("iter0_certify", True):
                msg = (f"iter0 feasible mass only {feas} after "
                       f"certified re-solve: infeasible or unsolvable "
                       f"scenario(s)")
            else:
                msg = (f"iter0 feasible mass only {feas} on the "
                       f"UNCERTIFIED fast solve (iter0_certify=False): "
                       f"enable iter0_certify for an f64 re-solve, or "
                       f"set iter0_infeasibility_ok to continue with "
                       f"masked bounds")
            if self.options.get("iter0_infeasibility_ok", False):
                global_toc("WARNING: " + msg)
            else:
                raise RuntimeError(msg)
        b = self.batch
        x_na = b.nonants(res.x)
        xbar, xsqbar = compute_xbar(b, x_na)
        W = update_W(torch.zeros_like(x_na), self.rho, x_na, xbar)
        conv = convergence_metric(b, x_na, xbar)
        self.trivial_bound = float(self.valid_Ebound(res))
        self.best_bound = self.trivial_bound
        self.state = PHState(
            x=res.x, y=res.y, W=W, xbar=xbar, xsqbar=xsqbar,
            obj=res.obj, dual_obj=res.dual_obj, conv=conv, it=0,
            solve_iters=res.iters,
            active_frac=_active_fraction(b, res.converged),
            solve_restarts=torch.sum(res.restarts))
        self.conv = float(conv)
        global_toc(f"Iter0 trivial bound = {self.trivial_bound:.6g}, "
                   f"conv = {self.conv:.6g}")
        if self._tel.enabled:
            self._tel.event("ph.iter0", trivial_bound=self.trivial_bound,
                            feas_mass=self.iter0_feas_mass, conv=self.conv)
        self._ext("post_iter0")
        return self.trivial_bound

    @property
    def superstep_eps(self):
        """Tolerance of the hot-loop subproblem solves: the eps-ladder
        schedule when enabled, else the superstep_eps option, else the
        dynamic solver_eps (all rounded to the batch dtype)."""
        dt = self.batch.c.dtype
        if self._ladder is not None:
            return round_to_dtype(self._ladder_eps, dt)
        if self._superstep_eps_opt is None:
            return self.solver_eps
        return round_to_dtype(self._superstep_eps_opt, dt)

    def _run_superstep(self):
        """Advance self.state by one superstep; a hot-dtype run promotes
        to the full-precision pair once the superstep tolerance crosses
        the hot dtype's eps floor.  Telemetry phase timing routes
        through the phased path; otherwise this is the plain call with
        one device sync (telemetry off costs an attribute read)."""
        eps = self.superstep_eps
        solver, prep = self.active_solver_prep(eps)
        if self._tel.phase_timing:
            self._superstep_phased(solver, prep, eps)
        else:
            self.state = ph_superstep(
                solver, self.state, self.rho, self.W_on, self.prox_on,
                self.lb_eff, self.ub_eff, eps, prep, self.batch)
            _sync(self.state.x)
        if solver is not self.solver:
            self.state = dataclasses.replace(self.state, promoted=1)

    def _superstep_phased(self, solver, prep, eps):
        """One PH iteration as `ph_superstep`'s four cuts (solve / x̄
        psum / W update / conv), each in a ph.phase.* span with a device
        sync after it and a ph.phase.*_seconds histogram
        (phbase.py:590-631 of the JAX package).  The same torch ops in
        the same order as `ph_superstep`, so the same PHState; the three
        extra syncs are why this path runs only behind
        tel.phase_timing."""
        tel, st, b = self._tel, self.state, self.batch
        t0 = time.monotonic()
        with tel.span("ph.phase.solve"):
            res = _superstep_solve(solver, st, self.rho, self.W_on,
                                   self.prox_on, self.lb_eff, self.ub_eff,
                                   eps, prep, b)
            _sync(res.x)
        t1 = time.monotonic()
        with tel.span("ph.phase.psum"):
            x_na = b.nonants(res.x)
            xbar, xsqbar = compute_xbar(b, x_na)
            _sync(xbar)
        t2 = time.monotonic()
        with tel.span("ph.phase.w_update"):
            W = update_W(st.W, self.rho, x_na, xbar)
            _sync(W)
        t3 = time.monotonic()
        with tel.span("ph.phase.conv"):
            conv = convergence_metric(b, x_na, xbar)
            obj = b.objective(res.x)
            _sync(conv)
        t4 = time.monotonic()
        hist = tel.registry.histogram
        hist("ph.phase.solve_seconds").observe(t1 - t0)
        hist("ph.phase.psum_seconds").observe(t2 - t1)
        hist("ph.phase.w_update_seconds").observe(t3 - t2)
        hist("ph.phase.conv_seconds").observe(t4 - t3)
        self.state = _next_state(st, res, W, xbar, xsqbar, conv, obj, b)

    def ph_iteration(self):
        self._ext("pre_solve_loop")
        t0 = time.time()
        tel = self._tel
        if tel.enabled:
            with tel.span("ph.iteration"):
                self._run_superstep()
        else:
            self._run_superstep()
        it_n = int(self.state.solve_iters)
        rst_n = int(self.state.solve_restarts)
        # FLOPs discounted by the shared block's density, and the
        # sparse-matvec count (phbase.py:645-653)
        self._account(self.prep, it_n)
        self._kernel_iters += it_n
        self._restarts_total += rst_n
        self._active_fraction = float(self.state.active_frac)
        wall = time.time() - t0
        self._solve_wall += wall
        self._ext("post_solve_loop")
        self.conv = float(self.state.conv)
        if self._ladder is not None:
            # tighten (never loosen) toward couple*conv, floored at min
            self._ladder_eps = min(
                self._ladder_eps,
                max(self._ladder["min"],
                    self._ladder["couple"] * self.conv))
        if tel.enabled:
            r = tel.registry
            r.counter("ph.iterations").inc()
            r.histogram("ph.iteration_seconds").observe(wall)
            r.gauge("ph.conv").set(self.conv)
            r.counter("pdhg.inner_iters_total").inc(it_n)
            r.counter("pdhg.restarts_total").inc(rst_n)
            r.gauge("pdhg.active_fraction").set(self._active_fraction)
            if isinstance(self.prep.A, SparseSplitA):
                r.counter("pdhg.sparse_matvecs").inc(2 * it_n)
            if self._ladder is not None:
                r.gauge("ph.superstep_eps").set(self._ladder_eps)
        return self.conv

    # -- crash-resume (resilience/checkpoint.py) --------------------------
    def _save_checkpoint(self, path):
        """Write this run's checkpoint (StreamingPH writes its stream
        format instead)."""
        from .resilience.checkpoint import save_run_checkpoint
        save_run_checkpoint(path, self)

    def _maybe_checkpoint(self, k):
        path = self.options.get("run_checkpoint")
        if not path:
            return
        if k % int(self.options.get("checkpoint_every", 1)) == 0:
            self._save_checkpoint(path)

    def restore_run_checkpoint(self, path):
        """Install a full run checkpoint (state, bounds, iteration): the
        Iter0 replacement of a `resume_from=` run.  Returns the trivial
        bound."""
        from .resilience.checkpoint import load_run_checkpoint
        load_run_checkpoint(path, self)
        global_toc(f"PH resumed from checkpoint {path} at iter "
                   f"{int(self.state.it)} "
                   f"(trivial_bound={self.trivial_bound})")
        return self.trivial_bound

    # -- main loop (reference phbase.py:875-979 iterk_loop) ---------------
    def iterk_loop(self):
        max_iters = int(self.options.get("PHIterLimit", 100))
        convthresh = float(self.options.get("convthresh", 1e-4))
        verbose = self.options.get("verbose", False)
        start = int(self.state.it) if self.state is not None else 0
        for k in range(start + 1, max_iters + 1):
            conv = self.ph_iteration()
            self._ext("miditer")
            if verbose or k % 10 == 0 or k == 1:
                eobj = float(self.Eobjective(self.state.obj))
                global_toc(f"PH iter {k:4d} conv={conv:.6e} "
                           f"E[obj]={eobj:.6g}")
            self._ext("enditer")
            self._maybe_checkpoint(k)
            # the chaos crash fires after the checkpoint: a run killed
            # at iteration k resumes from iteration k
            self._chaos.hub_iter_tick(k)
            if self.spcomm is not None:
                self.spcomm.sync()
                if self.spcomm.is_converged():
                    global_toc(f"PH terminated by hub at iter {k}")
                    break
            if self.convobject is not None and self.convobject.is_converged():
                global_toc(f"PH terminated by converger "
                           f"{type(self.convobject).__name__} at iter {k}")
                break
            if conv < convthresh:
                global_toc(f"PH converged (conv={conv:.3e} < "
                           f"{convthresh}) at iter {k}")
                break
            self._ext("enditer_after_sync")
        self._ext("post_everything")
        return self.conv

    def post_loops(self):
        """Final expected objective; denouements receive each
        scenario's ScenarioView."""
        eobj = float(self.Eobjective(self.state.obj))
        if self.scenario_denouement is not None:
            for i, name in enumerate(self.all_scenario_names):
                self.scenario_denouement(0, name, self.scenario_view(i))
        return eobj

    def _host_state(self):
        """Bulk device->host copy of the solution state."""
        st = self.state
        return {
            "x": st.x.cpu().numpy(),
            "nonants": self.batch.nonants(st.x).cpu().numpy(),
            "obj": st.obj.cpu().numpy(),
            "prob": self.batch.prob.cpu().numpy(),
            "W": st.W.cpu().numpy(),
            "xbar": st.xbar.cpu().numpy(),
        }

    def scenario_view(self, i):
        """Per-scenario slice of the current state (host copy cached
        per state object)."""
        h = getattr(self, "_host_cache", None)
        if h is None or h["state"] is not self.state:
            h = dict(self._host_state(), state=self.state)
            self._host_cache = h
        return ScenarioView(
            index=i, name=self.all_scenario_names[i], x=h["x"][i],
            nonants=h["nonants"][i], obj=float(h["obj"][i]),
            prob=float(h["prob"][i]), W=h["W"][i], xbar=h["xbar"][i])

    # -- bounds -----------------------------------------------------------
    def lagrangian_bound(self, W=None, certify="auto", eps=None):
        """Valid outer bound from the current W: re-solve with the
        W-only objective (no prox), then Ebound.  certify="auto" needs
        no certificate for LPs with finite boxes (the dual objective is
        a Lagrangian value at any iterate); otherwise uncertified
        scenarios are masked to -inf.  `eps` (or options
        "lagrangian_eps") loosens this solve alone.  Raises under
        variable_probability (`check_W_bound_supported`)."""
        self.check_W_bound_supported()
        self._tel.counter("ph.lagrangian_bound_calls").inc()
        b = self.batch
        W = self.state.W if W is None else W
        c_eff = b.c.clone()
        c_eff[:, b.nonant_idx] += W
        if certify == "auto":
            certify = not (self.is_lp and self.all_bounds_finite)
        if eps is None:
            eps = self.options.get("lagrangian_eps")
        if eps is not None:
            eps = round_to_dtype(eps, b.c.dtype)
        cap = None if certify else self.options.get(
            "lagrangian_iters_cap")
        res = self.solve_loop(c=c_eff, warm="lagrangian", certify=certify,
                              eps=eps, iters_cap=cap)
        return float(self.Ebound(res.dual_obj,
                                 converged=res.converged if certify
                                 else None))

    def root_xbar(self):
        """Root-node consensus vector (K,)."""
        return self.state.xbar[0]
