"""AIRCOND — multistage production/inventory model (parameter parity
with the reference's aircond, mpisppy/tests/examples/aircond.py:15-34
`parms` table — the CI-interval and proper-bundle workhorse).

Port of `mpisppy_tpu/models/aircond.py`: the builder works in numpy, with
the same random draws, up to the final wrap into tensors on `device`
(default: the CUDA device), so its arrays equal the JAX builder's
exactly.

T stages (T = len(branching_factors) + 1).  Per stage t: regular
production p_t in [0, Capacity] at RegularProdCost, overtime o_t >= 0
at OvertimeProdCost, and inventory split into its positive and
negative parts (reference aircond.py:146-151 doleInventory):
Ipos_t >= 0 at InventoryCost (LastInventoryCost < 0 at the terminal
stage — end-of-horizon salvage), Ineg_t >= 0 (backlog) at
NegInventoryCost plus an optional QUADRATIC shortage penalty
QuadShortCoeff * Ineg^2 — expressed natively through the batch's
diagonal quadratic (`qdiag`), where the reference needs a QP solver.

    (Ipos_t - Ineg_t) = (Ipos_{t-1} - Ineg_{t-1}) + p_t + o_t - d_t
    (BeginInventory enters the t=1 balance)

start_ups=True adds a per-stage binary u_t with the big-M forcing row
p_t + o_t <= bigM * u_t and StartUpCost * u_t (reference
aircond.py:142-144; bigM = Capacity * max_T) — the integer variant.

Demand is the reference's per-NODE seeded random walk
(aircond.py:37-67 _demands_creator): d_1 = starting_d and
d_{t+1} = clip(d_t + Normal(mu_dev, sigma_dev), min_d, max_d), the
normal draw seeded by start_seed + node index so scenarios sharing a
tree node share the demand path — which is also what makes resampled
trees (confidence_intervals.sample_tree) reproducible from a seed.

Nonants per stage t < T: [p_t, o_t, Ipos_t, Ineg_t (, u_t)]
(stage-major, matching the reference's per-node nonant lists).

Not ported yet (ROADMAP.md queue A): `scenario_source` (item 12,
streaming) refuses.
"""

from __future__ import annotations

import numpy as np

from .. import not_ported
from ..convert import batch_from_arrays
from ..scenario_tree import MultistageTree

INF = float("inf")

# reference aircond.py:17-34 `parms` defaults ("Do not edit")
PARMS = {
    "mu_dev": 0.0,
    "sigma_dev": 40.0,
    "start_ups": False,
    "StartUpCost": 300.0,
    "start_seed": 1134,
    "min_d": 0.0,
    "max_d": 400.0,
    "starting_d": 200.0,
    "BeginInventory": 200.0,
    "InventoryCost": 0.5,
    "LastInventoryCost": -0.8,
    "Capacity": 200.0,
    "RegularProdCost": 1.0,
    "OvertimeProdCost": 3.0,
    "NegInventoryCost": 5.0,
    "QuadShortCoeff": 0.0,
}
MAX_T = 25            # reference aircond.py:113 (bigM horizon bound)


def _node_demands(branching_factors, start_seed, mu_dev, sigma_dev,
                  min_d, max_d, starting_d):
    """(S, T) demand array from the per-node seeded random walk."""
    tree = MultistageTree(list(branching_factors))
    S = tree.num_scens
    T = len(branching_factors) + 1
    dem = np.zeros((S, T))
    dem[:, 0] = starting_d
    for s in range(S):
        digits = tree.scen_digits(s)
        path_idx = 0
        d = starting_d
        for t in range(1, T):
            path_idx = path_idx * branching_factors[t - 1] \
                + digits[t - 1]
            rng = np.random.RandomState(
                (start_seed + t * 9176 + path_idx) % (2**31))
            d = min(max_d, max(min_d, d + rng.normal(mu_dev, sigma_dev)))
            dem[s, t] = d
    return dem, tree


def build_batch(branching_factors=(3, 2), start_seed=None,
                dtype=np.float64, device=None, **params):
    kw = dict(PARMS)
    kw.update(params)
    if start_seed is not None:
        kw["start_seed"] = start_seed
    unknown = set(kw) - set(PARMS)
    if unknown:
        raise ValueError(f"unknown aircond parameter(s): {unknown}")
    start_ups = bool(kw["start_ups"])
    cap = float(kw["Capacity"])
    bigM = cap * MAX_T

    dem, tree = _node_demands(
        branching_factors, int(kw["start_seed"]), kw["mu_dev"],
        kw["sigma_dev"], kw["min_d"], kw["max_d"], kw["starting_d"])
    S = tree.num_scens
    T = len(branching_factors) + 1
    if T > MAX_T:
        raise RuntimeError(f"number of stages exceeds {MAX_T}")

    # layout: stage-major [p, o, Ipos, Ineg] blocks, then u_t columns
    N = 4 * T + (T if start_ups else 0)
    ip = lambda t: 4 * t
    io = lambda t: 4 * t + 1
    ii = lambda t: 4 * t + 2
    ib = lambda t: 4 * t + 3
    iu = lambda t: 4 * T + t

    # rows: T balance equalities (+ T start-up forcing rows)
    M = T + (T if start_ups else 0)
    A = np.zeros((S, M, N), dtype=dtype)
    row_lo = np.full((S, M), -INF, dtype=dtype)
    row_hi = np.full((S, M), INF, dtype=dtype)

    for t in range(T):
        # Ipos_t - Ineg_t - Ipos_{t-1} + Ineg_{t-1} - p_t - o_t = -d_t
        A[:, t, ii(t)] = 1.0
        A[:, t, ib(t)] = -1.0
        A[:, t, ip(t)] = -1.0
        A[:, t, io(t)] = -1.0
        if t > 0:
            A[:, t, ii(t - 1)] = -1.0
            A[:, t, ib(t - 1)] = 1.0
        rhs = -dem[:, t] + (kw["BeginInventory"] if t == 0 else 0.0)
        row_lo[:, t] = rhs
        row_hi[:, t] = rhs
    if start_ups:
        for t in range(T):
            r = T + t                       # p + o - bigM u <= 0
            A[:, r, ip(t)] = 1.0
            A[:, r, io(t)] = 1.0
            A[:, r, iu(t)] = -bigM
            row_hi[:, r] = 0.0

    lb = np.zeros((S, N), dtype=dtype)
    ub = np.full((S, N), INF, dtype=dtype)
    for t in range(T):
        ub[:, ip(t)] = cap
        ub[:, io(t)] = bigM               # reference box (0, bigM)
        ub[:, ii(t)] = bigM
        ub[:, ib(t)] = bigM
    if start_ups:
        ub[:, 4 * T:] = 1.0

    c = np.zeros((S, N), dtype=dtype)
    qdiag = np.zeros((S, N), dtype=dtype)
    stage_cost_c = np.zeros((T, S, N), dtype=dtype)
    for t in range(T):
        last = (t == T - 1)
        inv_cost = kw["LastInventoryCost"] if last else kw["InventoryCost"]
        c[:, ip(t)] = kw["RegularProdCost"]
        c[:, io(t)] = kw["OvertimeProdCost"]
        c[:, ii(t)] = inv_cost
        c[:, ib(t)] = kw["NegInventoryCost"]
        if kw["QuadShortCoeff"] > 0 and not last:
            # native diagonal QP: 0.5*qdiag*x^2, so qdiag = 2*coeff
            qdiag[:, ib(t)] = 2.0 * kw["QuadShortCoeff"]
        if start_ups:
            c[:, iu(t)] = kw["StartUpCost"]
        for j in (ip(t), io(t), ii(t), ib(t)):
            stage_cost_c[t, :, j] = c[:, j]
        if start_ups:
            stage_cost_c[t, :, iu(t)] = c[:, iu(t)]

    integer_mask = np.zeros((S, N), dtype=bool)
    if start_ups:
        integer_mask[:, 4 * T:] = True

    # nonants: stages 1..T-1, stage-major groups
    per_stage = (lambda t: (ip(t), io(t), ii(t), ib(t), iu(t))
                 if start_ups else (ip(t), io(t), ii(t), ib(t)))
    nonant_idx = np.array(
        [j for t in range(T - 1) for j in per_stage(t)], np.int32)
    width = 5 if start_ups else 4
    stage_of = tuple(t + 1 for t in range(T - 1)
                     for _ in range(width))
    node_of = np.stack([
        tree.node_of_slots(s, stage_of) for s in range(S)
    ]).astype(np.int32)

    var_names = tuple(
        f"{nm}[{t+1}]" for t in range(T)
        for nm in ("RegularProd", "OvertimeProd", "posInventory",
                   "negInventory")) + (tuple(
                       f"StartUp[{t+1}]" for t in range(T))
                       if start_ups else ())
    tree_info = dict(
        node_of=node_of,
        prob=np.array([tree.scen_probability(s) for s in range(S)],
                      dtype=dtype),
        num_nodes=tree.num_nodes,
        stage_of=stage_of,
        nonant_names=tuple(var_names[i] for i in nonant_idx),
        scen_names=tuple(f"Scenario{s+1}" for s in range(S)),
    )
    return batch_from_arrays(dict(
        c=c, qdiag=qdiag,
        A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        obj_const=np.zeros((S,), dtype=dtype),
        nonant_idx=nonant_idx,
        integer_mask=integer_mask,
        tree=tree_info, stage_cost_c=stage_cost_c, var_names=var_names), device=device)


def scenario_source(num_scens, cfg=None):
    """streaming.ScenarioSource for aircond (the JAX package's
    BatchSource over the host-resident tree): refused until streaming
    is ported."""
    raise not_ported("aircond.scenario_source (streaming.BatchSource)", 12)


def scenario_names_creator(num_scens, start=0):
    return [f"Scenario{i+1}" for i in range(start, start + num_scens)]


MULTISTAGE = True


def xhat_generator_aircond(scenario_names, branching_factors=None,
                           solver_options=None, device=None, **params):
    """Sequential-sampling candidate generator (reference
    aircond.py:465 xhat_generator_aircond): solve the EF of the
    sampled tree the given scenario names imply, with the port's
    `opt/ef` on `device` (default: the CUDA device), and return the
    root (stage-1) decisions as a numpy array."""
    from ..opt.ef import ExtensiveForm
    assert branching_factors is not None, \
        "branching factors must be supplied to xhat_generator_aircond"
    prod = int(np.prod(branching_factors))
    if len(scenario_names) != prod:
        raise ValueError(
            f"{len(scenario_names)} scenario names for a "
            f"{prod}-leaf tree {tuple(branching_factors)}")
    # the NAMES select the sample (reference aircond.py:47-55 derives
    # node seeds from the scenario numbers): advance the demand-walk
    # seed by the first scenario's number so successive name blocks
    # draw different trees
    first = scenario_names[0]
    scennum = int("".join(ch for ch in first if ch.isdigit()) or 0)
    params = dict(params)
    params["start_seed"] = (params.get("start_seed", PARMS["start_seed"])
                            + scennum)
    b = build_batch(branching_factors=tuple(branching_factors),
                    device=device, **params)
    opts = dict(solver_options or {})
    opts.setdefault("pdhg_eps", 1e-6)
    ef = ExtensiveForm(opts, list(b.tree.scen_names), batch=b,
                       device=b.device)
    ef.solve_extensive_form()
    xhat = np.asarray(ef.get_root_solution())
    stage1 = np.asarray(b.tree.stage_of) == 1
    return xhat[stage1[:xhat.size]] if xhat.size > stage1.sum() \
        else xhat


def inparser_adder(cfg):
    """Reference aircond.py:387-419 flag set (same names)."""
    cfg.add_branching_factors()
    cfg["branching_factors"] = "3,2"
    for name, default in PARMS.items():
        if name == "start_ups":
            cfg.add_to_config("start_ups",
                              description="per-stage start-up binaries",
                              domain=bool, default=False)
        else:
            dom = int if name == "start_seed" else float
            cfg.add_to_config(name, description=f"aircond {name}",
                              domain=dom, default=default)


def kw_creator(options):
    from ..utils.config import parse_branching_factors
    bf = options.get("branching_factors", "3,2")
    kw = {"branching_factors": tuple(parse_branching_factors(bf))}
    for name in PARMS:
        if options.get(name) is not None:
            kw[name] = options[name]
    return kw
