"""SIZES — 2-stage production-sizes MIP (reference:
mpisppy/tests/examples/sizes/ReferenceModel.py + SIZES3/SIZES10 data;
the two-period version of Lokketangen & Woodruff's product-sizes
problem, Journal of Heuristics 1996).

Port of `mpisppy_tpu/models/sizes.py`: the builder works in numpy, with
the same random draws, up to the final wrap into tensors on `device`
(default: the CUDA device), so its arrays equal the JAX builder's
exactly.

This module carries the PUBLISHED instance data of the reference's
SIZES3/SIZES10 `.dat` files (demands, costs, capacity — problem data,
not code): 10 product sizes, capacity 200000, setup cost 453 per size
per period, unit production cost 0.748 + 0.0104*(i-1), flat unit
reduction (cut-down) cost 0.008, first-period demand
[2500 7500 12500 10000 35000 25000 15000 12500 12500 5000], and
second-period demand = factor * first-period demand with factors
  3 scenarios:  0.7, 1.0, 1.3      (SIZES3/Scenario{1,2,3}.dat)
  10 scenarios: 0.5, 1.5, 0.6, 0.7, 0.8, 0.9, 1.1, 1.2, 1.3, 1.4
                                   (SIZES10/Scenario{1..10}.dat)
Golden value: the 3-scenario EF optimum rounds to 220000 at 2
significant figures (reference mpisppy/tests/test_ef_ph.py:137), with
NumProducedFirstStage[5] == 1134 at the optimum (test_ef_ph.py:155).

A size-i unit can be cut down to serve demand for any size j <= i at
the flat reduction cost.  Producing any units of size i in a period
incurs a setup (binary, big-M forcing).  Per scenario, variables
(F = num_sizes, P = F(F+1)/2 ordered pairs i >= j):

    z1[i] in {0,1}   setup, period 1        (derived — NOT nonant,
                     matching the reference's StageDerivedVariables)
    x1[i] int [0,cap]  production, period 1   (nonant)
    y1[i,j] int [0,cap] cut i->j, period 1    (nonant)
    z2[i], x2[i], y2[i,j]                     (recourse)

Constraints (reference ReferenceModel.py:94-140):
    x_t[i] - cap * z_t[i] <= 0                 (setup forcing)
    sum_{j<=i} y1[i,j] - x1[i] <= 0            (inventory, period 1)
    sum_{j<=i} (y1[i,j] + y2[i,j]) - x1[i] - x2[i] <= 0   (period 2)
    sum_{i>=j} y1[i,j] >= d1[j]                (period-1 demand)
    sum_{i>=j} y2[i,j] >= d2_s[j]              (period-2 demand, random)
    sum_i x_t[i] <= cap                        (capacity per period)
Objective: sum_t [ setup*z_t + unitcost*x_t + 0.008 * y_t[i,j] (i!=j) ].

All variable boxes are finite ([0,1] / [0,cap]), so the PDHG dual
objective is a valid Lagrangian bound at any iterate (spopt.Ebound).

`rho_setter` mirrors the reference's sizes _rho_setter
(tests/examples/sizes/sizes.py:37-58): rho = 0.001 * cost coefficient
of each nonant (unit production cost for x1, reduction cost for y1).
"""

from __future__ import annotations

import numpy as np

from ..convert import batch_from_arrays

INF = float("inf")

# ---- published instance data (reference SIZES3/SIZES10 .dat files) -------
NUM_SIZES = 10
CAPACITY = 200000.0
SETUP_COST = 453.0
UNIT_COST = 0.748 + 0.0104 * np.arange(NUM_SIZES)
CUT_COST = 0.008
DEMAND1 = np.array([2500., 7500., 12500., 10000., 35000.,
                    25000., 15000., 12500., 12500., 5000.])
_FACTORS3 = np.array([0.7, 1.0, 1.3])
_FACTORS10 = np.array([0.5, 1.5, 0.6, 0.7, 0.8, 0.9, 1.1, 1.2, 1.3, 1.4])


def demand_factors(num_scens):
    """Second-period demand factors: exact reference data for 3 and 10
    scenarios; evenly spaced in [0.5, 1.5] otherwise (scalable
    extension for stress runs)."""
    if num_scens == 3:
        return _FACTORS3
    if num_scens == 10:
        return _FACTORS10
    if num_scens == 1:
        return np.array([1.0])
    return 0.5 + np.arange(num_scens) / (num_scens - 1)


def scenario_demand(scennum, num_scens, num_sizes=NUM_SIZES):
    """Period-2 demand vector for one scenario (rounded to integers,
    exactly as the .dat files carry them)."""
    f = demand_factors(num_scens)[scennum]
    return np.round(DEMAND1[:num_sizes] * f)


def build_batch(num_scens, num_sizes=NUM_SIZES, dtype=np.float64,
                seed=None, tighten=True, device=None):
    """tighten: replace the reference's loose forcing big-M (the
    Capacity, ReferenceModel.py:106 "simple upper bound for M") by the
    presolve-tight value
        M_i = min(cap, total demand servable by size i over the
                  horizon, at the scenario's worst case)
    — a standard MIP-equivalent strengthening (production beyond
    servable demand is pure cost, so no optimum exceeds M_i); the LP
    relaxation bound tightens and big-M diving (opt/mip.py) gets honest
    setup amortization.  tighten=False reproduces the reference's
    relaxation exactly."""
    F = num_sizes
    S = num_scens
    d1 = DEMAND1[:F]
    cap = CAPACITY
    pairs = [(i, j) for i in range(F) for j in range(F) if i >= j]
    P = len(pairs)

    # layout: [z1 | x1 | y1 | z2 | x2 | y2]
    iz1, ix1, iy1 = 0, F, 2 * F
    iz2, ix2, iy2 = 2 * F + P, 3 * F + P, 4 * F + P
    N = 4 * F + 2 * P

    # rows: forcing (2F), inventory p1 (F), inventory p2 (F),
    # demand p1 (F), demand p2 (F), capacity (2)
    M = 6 * F + 2
    A = np.zeros((S, M, N), dtype=dtype)
    row_lo = np.full((S, M), -INF, dtype=dtype)
    row_hi = np.full((S, M), INF, dtype=dtype)
    d2all = np.stack([scenario_demand(s, S, F) for s in range(S)])
    if tighten:
        # servable demand by size i: sizes j <= i, both periods (x1 may
        # pre-produce for period 2 through the p2 inventory row).  x1
        # is SHARED across scenarios, so its M must cover the
        # worst-case scenario (max over s) or valid pre-production for
        # a high-demand scenario would be cut off; x2/z2 are
        # scenario-local so the scenario's own demand bounds them.
        cum1 = np.cumsum(d1)
        cum2 = np.cumsum(d2all, axis=1)                    # (S, F)
        M1 = np.minimum(
            cap, cum1[None, :] + np.max(cum2, axis=0)[None, :]
        ) * np.ones((S, 1))                                # (S, F)
        M2 = np.minimum(cap, cum2)
    else:
        M1 = np.full((S, F), cap)
        M2 = np.full((S, F), cap)
    r = 0
    for i in range(F):                      # x1 - M1 z1 <= 0
        A[:, r, ix1 + i] = 1.0
        A[:, r, iz1 + i] = -M1[:, i]
        row_hi[:, r] = 0.0
        r += 1
    for i in range(F):                      # x2 - M2 z2 <= 0
        A[:, r, ix2 + i] = 1.0
        A[:, r, iz2 + i] = -M2[:, i]
        row_hi[:, r] = 0.0
        r += 1
    for i in range(F):                      # sum_{j<=i} y1[i,.] - x1 <= 0
        for p, (pi, pj) in enumerate(pairs):
            if pi == i:
                A[:, r, iy1 + p] = 1.0
        A[:, r, ix1 + i] = -1.0
        row_hi[:, r] = 0.0
        r += 1
    for i in range(F):  # sum_{j<=i} (y1[i,.]+y2[i,.]) - x1 - x2 <= 0
        for p, (pi, pj) in enumerate(pairs):
            if pi == i:
                A[:, r, iy2 + p] = 1.0
                A[:, r, iy1 + p] = 1.0
        A[:, r, ix1 + i] = -1.0
        A[:, r, ix2 + i] = -1.0
        row_hi[:, r] = 0.0
        r += 1
    for j in range(F):                      # sum_{i>=j} y1[.,j] >= d1
        for p, (pi, pj) in enumerate(pairs):
            if pj == j:
                A[:, r, iy1 + p] = 1.0
        row_lo[:, r] = d1[j]
        r += 1
    d2 = d2all
    for j in range(F):                      # sum_{i>=j} y2[.,j] >= d2_s
        for p, (pi, pj) in enumerate(pairs):
            if pj == j:
                A[:, r, iy2 + p] = 1.0
        row_lo[:, r] = d2[:, j]
        r += 1
    A[:, r, ix1:ix1 + F] = 1.0              # capacity p1
    row_hi[:, r] = cap
    r += 1
    A[:, r, ix2:ix2 + F] = 1.0              # capacity p2
    row_hi[:, r] = cap
    r += 1
    assert r == M

    lb = np.zeros((S, N), dtype=dtype)
    ub = np.full((S, N), cap, dtype=dtype)
    ub[:, iz1:iz1 + F] = 1.0
    ub[:, iz2:iz2 + F] = 1.0

    c = np.zeros((S, N), dtype=dtype)
    c[:, iz1:iz1 + F] = SETUP_COST
    c[:, iz2:iz2 + F] = SETUP_COST
    c[:, ix1:ix1 + F] = UNIT_COST[:F]
    c[:, ix2:ix2 + F] = UNIT_COST[:F]
    for p, (pi, pj) in enumerate(pairs):    # flat reduction cost, i != j
        if pi != pj:
            c[:, iy1 + p] = CUT_COST
            c[:, iy2 + p] = CUT_COST

    # every variable is integer in the reference model (z binary; x, y
    # NonNegativeIntegers, ReferenceModel.py:70-83)
    integer_mask = np.ones((S, N), dtype=bool)

    stage_cost_c = np.zeros((2, S, N), dtype=dtype)
    stage_cost_c[0, :, : 2 * F + P] = c[:, : 2 * F + P]
    stage_cost_c[1, :, 2 * F + P:] = c[:, 2 * F + P:]

    # nonants = x1 and y1 (the reference's varlist,
    # tests/examples/sizes/sizes.py:27); z1 is stage-derived
    nonant_idx = np.arange(F, 2 * F + P, dtype=np.int32)
    var_names = (
        tuple(f"ProduceSizeFirstStage[{i+1}]" for i in range(F))
        + tuple(f"NumProducedFirstStage[{i+1}]" for i in range(F))
        + tuple(f"NumUnitsCutFirstStage[{i+1},{j+1}]" for i, j in pairs)
        + tuple(f"ProduceSizeSecondStage[{i+1}]" for i in range(F))
        + tuple(f"NumProducedSecondStage[{i+1}]" for i in range(F))
        + tuple(f"NumUnitsCutSecondStage[{i+1},{j+1}]" for i, j in pairs))
    tree = dict(
        node_of=np.zeros((S, len(nonant_idx)), np.int32),
        prob=np.full((S,), 1.0 / S, dtype=dtype),
        num_nodes=1,
        stage_of=(1,) * len(nonant_idx),
        nonant_names=tuple(var_names[i] for i in nonant_idx),
        scen_names=tuple(f"Scenario{i+1}" for i in range(S)),
    )
    return batch_from_arrays(dict(
        c=c, qdiag=np.zeros((S, N), dtype=dtype),
        A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        obj_const=np.zeros((S,), dtype=dtype),
        nonant_idx=nonant_idx, integer_mask=integer_mask,
        tree=tree, stage_cost_c=stage_cost_c, var_names=var_names), device=device)


def rho_setter(batch, rho_scale_factor=0.001):
    """Cost-proportional rho (reference tests/examples/sizes/sizes.py:37
    _rho_setter: rho = RF * unit production cost for NumProduced slots,
    RF * reduction cost for NumUnitsCut slots, RF = 0.001)."""
    c_na = np.abs(np.asarray(batch.c))[:, np.asarray(batch.nonant_idx)]
    return rho_scale_factor * np.maximum(c_na, CUT_COST)


def scenario_names_creator(num_scens, start=0):
    return [f"Scenario{i+1}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.num_scens_required()
    cfg.add_to_config("num_sizes", description="number of product sizes",
                      domain=int, default=NUM_SIZES)


def kw_creator(options):
    return {"num_sizes": options.get("num_sizes", NUM_SIZES)}


def batch_creator(cfg_or_kwargs, num_scens=None):
    kw = dict(cfg_or_kwargs)
    n = num_scens or kw.pop("num_scens", None)
    kw.pop("num_scens", None)
    kw.pop("use_integer", None)
    kw.pop("crops_multiplier", None)
    return build_batch(n, **kw)


def scenario_denouement(rank, scenario_name, result):
    pass
