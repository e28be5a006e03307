"""Hydro — the canonical 3-stage multistage test model (port of
`mpisppy_tpu/models/hydro.py`; the builder is numpy up to the final
wrap into tensors, so its arrays equal the JAX builder's exactly).

Same mathematics and data as the reference's hydro ("elec3") model
(reference: mpisppy/tests/examples/hydro/hydro.py and its
PySP/scenariodata/Scen*.dat files): a hydro-thermal scheduling problem
over 3 periods.  Per period t: thermal generation Pgt[t] in [0,100],
hydro generation Pgh[t] in [0,100], unserved demand PDns[t] in
[0, D[t]], reservoir volume Vol[t] in [0,100]; terminal future-cost
slack sl >= 0.

    min  sum_t r[t] * (betaGt*Pgt[t] + betaGh*Pgh[t] + betaDns*PDns[t]) + sl
    s.t. Pgt[t] + Pgh[t] + PDns[t]        = D[t]            (demand)
         Vol[t] - Vol[t-1] + u[t]*Pgh[t] <= u[t]*A_s[t]     (conservation,
                                                             Vol[0] = V0)
         sl >= 4166.67 * (V0 - Vol[3])                      (future cost)

with discount r[t] = (1/1.1)^(duracion[t]/T).  Scenario s's only
stochastic data is the inflow A_s: A[1] = 50 for all; A[2] in
{10, 50, 90} chosen by the stage-2 branch; A[3] in {40, 50, 60} by the
stage-3 branch (read from the reference's Scen1..Scen9.dat).

Tree: branching factors [3, 3] by default, 9 scenarios; nonants are
[Pgt[t], Pgh[t], PDns[t], Vol[t]] at stage t for t = 1, 2 (reference
hydro.py MakeNodesforScen).

Reference golden values (2 sig figs, test_ef_ph.py Test_hydro):
PH trivial bound = 180, E[objective] at consensus = 190.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..convert import batch_from_arrays
from ..ir import TreeInfo
from ..model import LinearModel
from ..scenario_tree import MultistageTree
from ..utils.config import parse_branching_factors

INF = float("inf")

_D = np.array([90.0, 160.0, 110.0])
_U = np.array([0.6048, 0.6048, 1.2096])
_DURACION = np.array([168.0, 168.0, 336.0])
_T_HOURS = 8760.0
_V0 = 60.48
_VMAX = 100.0
_PMAX = 100.0
_BETA_GT = 1.0
_BETA_GH = 0.0
_BETA_DNS = 10.0
_FCFE = 4166.67
_A2_BY_BRANCH = np.array([10.0, 50.0, 90.0])   # stage-2 inflow
_A3_BY_BRANCH = np.array([40.0, 50.0, 60.0])   # stage-3 inflow

_R = (1.0 / 1.1) ** (_DURACION / _T_HOURS)     # discount factors


def _inflows(scennum, tree: MultistageTree):
    """(3,) inflow vector A for scenario scennum (0-based)."""
    d = tree.scen_digits(scennum)
    return np.array([50.0, _A2_BY_BRANCH[d[0]], _A3_BY_BRANCH[d[1]]])


def build_batch(branching_factors=(3, 3), dtype=np.float64, device=None):
    """Vectorized batch builder for the full hydro tree, on `device`
    (default: the CUDA device).

    Variable layout per scenario (N = 13):
        [0:3)   Pgt[t]       [3:6)  Pgh[t]
        [6:9)   PDns[t]      [9:12) Vol[t]
        [12]    sl
    Rows (M = 7): 3 demand equalities, 3 conservation <=, 1 future-cost.
    Nonant slots (K = 8, stage-major): stage-1 [Pgt1,Pgh1,PDns1,Vol1]
    then stage-2 [Pgt2,Pgh2,PDns2,Vol2].
    """
    tree = MultistageTree(list(branching_factors))
    S = tree.num_scens
    N, M = 13, 7
    iPgt, iPgh, iPDns, iVol, isl = 0, 3, 6, 9, 12

    A = np.zeros((S, M, N), dtype=dtype)
    row_lo = np.full((S, M), -INF, dtype=dtype)
    row_hi = np.full((S, M), INF, dtype=dtype)
    inflow = np.stack([_inflows(s, tree) for s in range(S)])   # (S, 3)

    for t in range(3):
        # demand equality
        A[:, t, iPgt + t] = 1.0
        A[:, t, iPgh + t] = 1.0
        A[:, t, iPDns + t] = 1.0
        row_lo[:, t] = _D[t]
        row_hi[:, t] = _D[t]
        # conservation: Vol[t] - Vol[t-1] + u[t]*Pgh[t] <= u[t]*A[t] (+V0)
        r = 3 + t
        A[:, r, iVol + t] = 1.0
        if t > 0:
            A[:, r, iVol + t - 1] = -1.0
        A[:, r, iPgh + t] = _U[t]
        row_hi[:, r] = _U[t] * inflow[:, t] + (_V0 if t == 0 else 0.0)
    # future cost: sl + FCFE*Vol[3] >= FCFE*V0
    A[:, 6, isl] = 1.0
    A[:, 6, iVol + 2] = _FCFE
    row_lo[:, 6] = _FCFE * _V0

    lb = np.zeros((S, N), dtype=dtype)
    ub = np.full((S, N), INF, dtype=dtype)
    ub[:, iPgt:iPgt + 3] = _PMAX
    ub[:, iPgh:iPgh + 3] = _PMAX
    ub[:, iPDns:iPDns + 3] = _D[None, :]
    ub[:, iVol:iVol + 3] = _VMAX

    c = np.zeros((S, N), dtype=dtype)
    stage_cost_c = np.zeros((3, S, N), dtype=dtype)
    for t in range(3):
        c[:, iPgt + t] = _R[t] * _BETA_GT
        c[:, iPgh + t] = _R[t] * _BETA_GH
        c[:, iPDns + t] = _R[t] * _BETA_DNS
        stage_cost_c[t, :, iPgt + t] = _R[t] * _BETA_GT
        stage_cost_c[t, :, iPgh + t] = _R[t] * _BETA_GH
        stage_cost_c[t, :, iPDns + t] = _R[t] * _BETA_DNS
    c[:, isl] = 1.0
    stage_cost_c[2, :, isl] = 1.0

    # nonants: stage-major [stage1 vars | stage2 vars]
    nonant_idx = np.array(
        [iPgt, iPgh, iPDns, iVol, iPgt + 1, iPgh + 1, iPDns + 1, iVol + 1],
        np.int32)
    stage_of = (1, 1, 1, 1, 2, 2, 2, 2)
    node_of = np.stack([
        tree.node_of_slots(s, stage_of) for s in range(S)
    ]).astype(np.int32)

    var_names = tuple(
        [f"Pgt[{t+1}]" for t in range(3)]
        + [f"Pgh[{t+1}]" for t in range(3)]
        + [f"PDns[{t+1}]" for t in range(3)]
        + [f"Vol[{t+1}]" for t in range(3)]
        + ["sl"])
    treeinfo = dict(
        node_of=node_of,
        prob=np.array([tree.scen_probability(s) for s in range(S)],
                      dtype=dtype),
        num_nodes=tree.num_nodes,
        stage_of=stage_of,
        nonant_names=tuple(var_names[i] for i in nonant_idx),
        scen_names=tuple(f"Scen{s+1}" for s in range(S)),
    )
    return batch_from_arrays(dict(
        c=c, qdiag=np.zeros((S, N), dtype=dtype),
        A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        obj_const=np.zeros((S,), dtype=dtype),
        nonant_idx=nonant_idx,
        integer_mask=np.zeros((S, N), dtype=bool),
        tree=treeinfo,
        stage_cost_c=stage_cost_c,
        var_names=var_names,
    ), device=device)


def scenario_creator(scenario_name, branching_factors=None, device=None):
    """Single-scenario creator via the declarative LinearModel API —
    the analog of the reference's scenario_creator contract
    (reference hydro.py scenario_creator), on `device` (default: the
    CUDA device).  Scenario names are one-based: "Scen1".."Scen9"."""
    if branching_factors is None:
        raise ValueError(
            "hydro scenario_creator requires branching_factors "
            "(reference raises here too)")
    tree = MultistageTree(list(branching_factors))
    snum = int("".join(ch for ch in scenario_name if ch.isdigit())) - 1
    inflow = _inflows(snum, tree)

    m = LinearModel()
    Pgt = m.add_vars("Pgt", 3, lb=0.0, ub=_PMAX)
    Pgh = m.add_vars("Pgh", 3, lb=0.0, ub=_PMAX)
    PDns = m.add_vars("PDns", 3, lb=0.0, ub=_D)
    Vol = m.add_vars("Vol", 3, lb=0.0, ub=_VMAX)
    sl = m.add_var("sl", lb=0.0)

    for t in range(3):
        m.add_constr({Pgt[t]: 1.0, Pgh[t]: 1.0, PDns[t]: 1.0},
                     lo=_D[t], hi=_D[t])
        m.add_cost(t + 1, {Pgt[t]: _R[t] * _BETA_GT,
                           Pgh[t]: _R[t] * _BETA_GH,
                           PDns[t]: _R[t] * _BETA_DNS})
    for t in range(3):
        terms = {Vol[t]: 1.0, Pgh[t]: _U[t]}
        if t > 0:
            terms[Vol[t - 1]] = -1.0
        m.add_constr(terms,
                     hi=_U[t] * inflow[t] + (_V0 if t == 0 else 0.0))
    m.add_constr({sl: 1.0, Vol[2]: _FCFE}, lo=_FCFE * _V0)
    m.add_cost(3, {sl: 1.0})

    # hydro's nonants are per-index slices of the var blocks (stage t
    # owns index t-1 of each block), finer-grained than block-level
    # set_nonants — lower first, then attach explicit slot metadata:
    spec = m.lower(prob=tree.scen_probability(snum), name=scenario_name,
                   device=device)
    # Rebuild nonant metadata to the stage-major slice layout
    nonant_idx = np.array([Pgt[0], Pgh[0], PDns[0], Vol[0],
                           Pgt[1], Pgh[1], PDns[1], Vol[1]], np.int64)
    stage_of = (1, 1, 1, 1, 2, 2, 2, 2)
    node_of = tree.node_of_slots(snum, stage_of)[None, :]
    dev = spec.device
    treeinfo = TreeInfo(
        node_of=torch.as_tensor(node_of, dtype=torch.long, device=dev),
        prob=spec.tree.prob,
        num_nodes=tree.num_nodes,
        stage_of=stage_of,
        nonant_names=tuple(spec.var_names[i] for i in nonant_idx),
        scen_names=(scenario_name,),
    )
    return dataclasses.replace(
        spec, nonant_idx=torch.as_tensor(nonant_idx, device=dev),
        tree=treeinfo)


def scenario_denouement(rank, scenario_name, result):
    pass


# ---- amalgamator-contract helpers ----------------------------------------

def scenario_names_creator(num_scens, start=None):
    start = start or 0
    return [f"Scen{i+1}" for i in range(start, start + num_scens)]


MULTISTAGE = True


def kw_creator(options):
    bf = options.get("branching_factors", [3, 3])
    return {"branching_factors": parse_branching_factors(bf)}


def inparser_adder(cfg):
    cfg.add_branching_factors()
