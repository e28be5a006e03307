"""GBD — the Ferguson & Dantzig (1956) aircraft-allocation problem
(reference: mpisppy/tests/examples/gbd/gbd.py, used by the sequential-
sampling tests following Bayraksan & Morton).

Port of `mpisppy_tpu/models/gbd.py`: the builder works in numpy, with
the same random draws, up to the final wrap into tensors on `device`
(default: the CUDA device), so its arrays equal the JAX builder's
exactly.

Allocate 4 aircraft types across 5 routes (first stage, nonant) before
route passenger demand realizes; recourse is pure simple-recourse
slack: excess demand loses revenue, excess capacity flies empty.

Per scenario (N = 34):
    x[a, r]  (20)  aircraft of type a on route r      (nonant)
             x[1,0], x[2,0], x[2,2] are structurally impossible
             (fixed to 0 via the box, reference gbd.py:34-36)
    sa[a]    (4)   idle aircraft of type a
    sp[r]    (5)   unserved demand (hundreds of passengers)
    sn[r]    (5)   over-capacity slack
Rows (9 equalities):
    sum_r x[a, r] + sa[a]              == fleet[a]
    sum_a p[a, r] x[a, r] + sp[r] - sn[r] == demand_s[r]
Objective: sum c[a, r] x[a, r] + sum lost[r] * sp[r].

Data: the published 1956 tables (capacities p, costs c, fleet) and the
demand distributions — either the ORIGINAL 1956 5-point distributions
or the EXTENDED distributions used by the reference's sequential-
sampling experiments (gbd_data/gbd_extended_data.json; embedded
below).  Scenario demands follow the reference's RNG protocol exactly
(gbd.py:18-21, :122-126): RandomState(scennum).rand(5), inverse-CDF
lookup via reversed cumulative probabilities — so sampled-problem
trajectories carry over.
"""

from __future__ import annotations

import numpy as np

from ..convert import batch_from_arrays

INF = float("inf")

# ---- published 1956 tables (aircraft x route) ----------------------------
FLEET = np.array([10.0, 19.0, 25.0, 15.0])
# passengers (hundreds) hauled per month, aircraft type a on route r
P = np.array([
    [16.0, 15.0, 28.0, 23.0, 81.0],
    [0.0, 10.0, 14.0, 15.0, 57.0],
    [0.0, 5.0, 0.0, 7.0, 29.0],
    [9.0, 11.0, 22.0, 17.0, 55.0],
])
# operating cost (thousands) per month
C = np.array([
    [18.0, 21.0, 18.0, 16.0, 10.0],
    [0.0, 15.0, 16.0, 14.0, 9.0],
    [0.0, 10.0, 0.0, 9.0, 6.0],
    [17.0, 16.0, 17.0, 15.0, 10.0],
])
LOST_REVENUE = np.array([13.0, 13.0, 7.0, 7.0, 1.0])
# routes an aircraft type cannot fly (reference gbd.py:34-36)
FORBIDDEN = [(1, 0), (2, 0), (2, 2)]

# original 1956 demand distributions (gbd.py:100-110 comment block)
DEMANDS_1956 = ([20, 22, 25, 27, 30], [5, 15], [14, 16, 18, 20, 22],
                [1, 5, 8, 10, 34], [58, 60, 62])
PROBS_1956 = ([.2, .05, .35, .2, .2], [.3, .7], [.1, .2, .4, .2, .1],
              [.2, .2, .3, .2, .1], [.1, .8, .1])

# extended distributions (reference gbd_data/gbd_extended_data.json)
DEMANDS_EXT = (
    [175., 185., 195., 200., 210., 220., 250., 270., 280., 290., 300.,
     305., 310., 312., 314.],
    [40., 45., 50., 55., 134., 138., 142., 146., 150., 154., 158.,
     160., 162.],
    [138., 140., 156., 158., 160., 162., 164., 170., 175., 180., 185.,
     188., 200., 205., 210., 220., 222.],
    [5., 10., 30., 37., 50., 57., 80., 85., 100., 110., 300., 320.,
     340., 360., 380.],
    [570., 580., 590., 600., 602., 604., 606., 610., 612., 614., 616.,
     618., 620.])
PROBS_EXT = (
    [.04, .04, .04, .04, .04, .05, .35, .1, .05, .05, .04, .04, .04,
     .04, .04],
    [.05, .05, .05, .05, .1, .1, .1, .1, .1, .1, .1, .05, .05],
    [.05, .05, .02, .04, .1, .02, .02, .1, .1, .1, .1, .06, .06, .04,
     .04, .07, .03],
    [.1, .1, .05, .05, .05, .05, .15, .15, .1, .1, .02, .02, .02, .02,
     .02],
    [.03, .04, .03, .05, .05, .1, .1, .2, .1, .1, .1, .05, .05])


def scenario_demand(scennum, extended=True):
    """(5,) demand vector, matching the reference's sampling protocol
    (gbd.py:122-126): one rand() per route, inverse CDF on the
    reversed cumulative probabilities."""
    dmds = DEMANDS_EXT if extended else DEMANDS_1956
    prbs = PROBS_EXT if extended else PROBS_1956
    rng = np.random.RandomState(scennum)
    rd = rng.rand(5)
    out = np.zeros(5)
    for r in range(5):
        cum = np.flip(np.cumsum(np.flip(prbs[r])))
        j = np.searchsorted(np.flip(cum), rd[r])
        out[r] = dmds[r][len(cum) - 1 - j]
    return out


def build_batch(num_scens, extended=True, seed=0,
                dtype=np.float64, device=None):
    S = num_scens
    A_, R_ = 4, 5
    ix = 0                      # x[a, r] row-major (a * R + r)
    isa = A_ * R_               # 20
    isp = isa + A_              # 24
    isn = isp + R_              # 29
    N = isn + R_                # 34
    M = A_ + R_                 # 9 equality rows

    dem = np.stack([scenario_demand(seed + s, extended)
                    for s in range(S)]).astype(dtype)   # (S, 5)

    A = np.zeros((S, M, N), dtype=dtype)
    row_lo = np.zeros((S, M), dtype=dtype)
    row_hi = np.zeros((S, M), dtype=dtype)
    for a in range(A_):                      # fleet equalities
        A[:, a, ix + a * R_: ix + (a + 1) * R_] = 1.0
        A[:, a, isa + a] = 1.0
        row_lo[:, a] = row_hi[:, a] = FLEET[a]
    for r in range(R_):                      # demand equalities
        m = A_ + r
        for a in range(A_):
            A[:, m, ix + a * R_ + r] = P[a, r]
        A[:, m, isp + r] = 1.0
        A[:, m, isn + r] = -1.0
        row_lo[:, m] = row_hi[:, m] = dem[:, r]

    lb = np.zeros((S, N), dtype=dtype)
    # implied finite boxes (Ebound validity without certificates):
    # x and the idle slack are fleet-bounded by their equality row;
    # sp <= demand; sn <= max capacity deliverable minus min demand
    ub = np.zeros((S, N), dtype=dtype)
    for a in range(A_):
        ub[:, ix + a * R_: ix + (a + 1) * R_] = FLEET[a]
        ub[:, isa + a] = FLEET[a]
    ub[:, isp:isp + R_] = dem
    cap_max = (P * FLEET[:, None]).sum(axis=0)          # (5,)
    ub[:, isn:isn + R_] = 2.0 * cap_max[None, :]
    for a, r in FORBIDDEN:
        ub[:, ix + a * R_ + r] = 0.0

    c = np.zeros((S, N), dtype=dtype)
    c[:, :isa] = C.reshape(-1)
    c[:, isp:isp + R_] = LOST_REVENUE

    stage_cost_c = np.zeros((2, S, N), dtype=dtype)
    stage_cost_c[0, :, :isa] = C.reshape(-1)
    stage_cost_c[1, :, isp:isp + R_] = LOST_REVENUE

    nonant_idx = np.arange(A_ * R_, dtype=np.int32)
    var_names = (
        tuple(f"x[{a},{r}]" for a in range(A_) for r in range(R_))
        + tuple(f"aircraftSlack[{a}]" for a in range(A_))
        + tuple(f"passengerSlack_pos[{r}]" for r in range(R_))
        + tuple(f"passengerSlack_neg[{r}]" for r in range(R_)))
    tree = dict(
        node_of=np.zeros((S, A_ * R_), np.int32),
        prob=np.full((S,), 1.0 / S, dtype=dtype),
        num_nodes=1,
        stage_of=(1,) * (A_ * R_),
        nonant_names=var_names[:A_ * R_],
        scen_names=tuple(f"scen{i}" for i in range(S)),
    )
    return batch_from_arrays(dict(
        c=c, qdiag=np.zeros((S, N), dtype=dtype),
        A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        obj_const=np.zeros((S,), dtype=dtype),
        nonant_idx=nonant_idx,
        integer_mask=np.zeros((S, N), dtype=bool),
        tree=tree, stage_cost_c=stage_cost_c, var_names=var_names), device=device)


def scenario_names_creator(num_scens, start=0):
    start = start or 0
    return [f"scen{i}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.num_scens_required()
    cfg.add_to_config("gbd_original_demands",
                      description="use the 1956 5-point distributions "
                      "instead of the extended ones", domain=bool,
                      default=False)


def kw_creator(options):
    return {"extended": not options.get("gbd_original_demands", False)}


def scenario_denouement(rank, scenario_name, result):
    pass
