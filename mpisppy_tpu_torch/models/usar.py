"""USAR — urban search and rescue team deployment (reference:
examples/usar/abstract.py, after Chen & Miller-Hooks 2012).

Port of `mpisppy_tpu/models/usar.py`: the builder works in numpy, with
the same random draws, up to the final wrap into tensors on `device`
(default: the CUDA device), so its arrays equal the JAX builder's
exactly.

Choose which depots to activate (first stage, binary, nonant), then
route rescue teams from depots to incident sites over a discrete time
horizon; a site rescue saves its (scenario-random) lives when a team
ARRIVES.  Teams travel depot->site and site->site with time-dependent
travel times, each site is serviced at most once, and a started rescue
occupies the team for the site's rescue time.  Objective: maximize
expected lives saved (minimize the negative).

Per scenario, T times, D depots, G sites (all binary; reference
abstract.py:52-65):
    act[d]                   activate depot d          (nonant)
    dd[t, d, g]              team departs depot d at t toward site g
    sd[t, g1, g2]            team departs g1 at t toward g2 (g1 != g2)
    st[t, g]                 team stays at g during t
    ita[t, tau, g]           a team is tau steps from arriving at g

Rows (reference abstract.py:67-131):
    sum_d act[d] == num_active_depots
    dd[t, d, g] <= act[d]
    sum_{d,g} dd[t, d, g] <= inflow[t]
    ita[t, tau, g] == ita[t-1, tau+1, g]
                      + sum_{d: travel_dg(t)==tau} dd[t, d, g]
                      + sum_{g': travel_g'g(t)==tau} sd[t, g', g]
    ita[t, 0, g] + st[t-1, g] == sum_{g'} sd[t, g, g'] + st[t, g]
    sum_t ita[t, 0, g] <= 1
    st[t, g] >= (1/T) * sum_{t'<=t, t'+rescue > t} ita[t', 0, g]

Data is generated like the reference's generate_data.py: uniform
coordinates on the unit square, travel time = ceil(distance / speed)
(>= 1), lives ~ 1 + Poisson(2) per site-time, constant rescue times
and depot inflows; per-scenario randomness re-draws the lives map.

The LP relaxation runs through PH and `opt/ef`; the integer model
through the MIP extensive form (`opt/mip.ExtensiveFormMIP`).
"""

from __future__ import annotations

import numpy as np

from ..convert import batch_from_arrays

INF = float("inf")


def _coords(rng, n):
    return rng.rand(n, 2)


def _travel_times(c1, c2, speed):
    d = np.linalg.norm(c1[:, None, :] - c2[None, :, :], axis=2)
    return np.maximum(1, np.ceil(d / speed)).astype(int)


def build_batch(num_scens, time_horizon=6, num_depots=2, num_sites=4,
                num_active_depots=1, rescue_time=1, depot_inflow=2,
                travel_speed=0.5, seed=1234,
                dtype=np.float64, device=None):
    T, D, G, S = time_horizon, num_depots, num_sites, num_scens
    rng = np.random.RandomState(seed)
    dep_xy = _coords(rng, D)
    site_xy = _coords(rng, G)
    tt_dg = _travel_times(dep_xy, site_xy, travel_speed)    # (D, G)
    tt_gg = _travel_times(site_xy, site_xy, travel_speed)   # (G, G)

    # lives to be saved: scenario-random, decaying over time (later
    # arrival saves fewer) — the reference draws per (time, site)
    lives = np.zeros((S, T, G))
    for s in range(S):
        r = np.random.RandomState(seed + 7919 * (s + 1))
        base = 1 + r.poisson(2.0, size=G)
        decay = np.clip(1.0 - 0.1 * np.arange(T), 0.1, None)
        lives[s] = np.round(base[None, :] * decay[:, None])

    # variable layout
    iact = 0
    idd = D                                   # dd[t, d, g]
    n_dd = T * D * G
    isd = idd + n_dd                          # sd[t, g1, g2]
    n_sd = T * G * G
    ist = isd + n_sd                          # st[t, g]
    n_st = T * G
    iita = ist + n_st                         # ita[t, tau, g]
    n_ita = T * T * G
    N = iita + n_ita

    def v_dd(t, d, g):
        return idd + (t * D + d) * G + g

    def v_sd(t, g1, g2):
        return isd + (t * G + g1) * G + g2

    def v_st(t, g):
        return ist + t * G + g

    def v_ita(t, tau, g):
        return iita + (t * T + tau) * G + g

    rows = []       # (coef dict, lo, hi) built per scenario-shared part

    def add(coefs, lo, hi):
        rows.append((coefs, lo, hi))

    add({iact + d: 1.0 for d in range(D)},
        float(num_active_depots), float(num_active_depots))
    for t in range(T):
        for d in range(D):
            for g in range(G):
                add({v_dd(t, d, g): 1.0, iact + d: -1.0}, -INF, 0.0)
    for t in range(T):
        add({v_dd(t, d, g): 1.0 for d in range(D) for g in range(G)},
            -INF, float(depot_inflow))
    for t in range(T):
        for tau in range(T):
            for g in range(G):
                coefs = {v_ita(t, tau, g): 1.0}
                if t > 0 and tau + 1 < T:
                    coefs[v_ita(t - 1, tau + 1, g)] = \
                        coefs.get(v_ita(t - 1, tau + 1, g), 0.0) - 1.0
                for d in range(D):
                    if tt_dg[d, g] == tau:
                        coefs[v_dd(t, d, g)] = \
                            coefs.get(v_dd(t, d, g), 0.0) - 1.0
                for g2 in range(G):
                    if g2 != g and tt_gg[g2, g] == tau:
                        coefs[v_sd(t, g2, g)] = \
                            coefs.get(v_sd(t, g2, g), 0.0) - 1.0
                add(coefs, 0.0, 0.0)
    for t in range(T):
        for g in range(G):
            coefs = {v_ita(t, 0, g): 1.0, v_st(t, g): -1.0}
            if t > 0:
                coefs[v_st(t - 1, g)] = 1.0
            for g2 in range(G):
                if g2 != g:
                    coefs[v_sd(t, g, g2)] = -1.0
            add(coefs, 0.0, 0.0)
    for g in range(G):
        add({v_ita(t, 0, g): 1.0 for t in range(T)}, -INF, 1.0)
    for t in range(T):
        for g in range(G):
            coefs = {v_st(t, g): 1.0}
            for t2 in range(t + 1):
                if t2 + rescue_time > t:
                    coefs[v_ita(t2, 0, g)] = \
                        coefs.get(v_ita(t2, 0, g), 0.0) - 1.0 / T
            add(coefs, 0.0, INF)

    M = len(rows)
    A = np.zeros((S, M, N), dtype=dtype)
    row_lo = np.zeros((S, M), dtype=dtype)
    row_hi = np.zeros((S, M), dtype=dtype)
    for m, (coefs, lo, hi) in enumerate(rows):
        for j, v in coefs.items():
            A[:, m, j] = v
        row_lo[:, m] = lo
        row_hi[:, m] = hi

    lb = np.zeros((S, N), dtype=dtype)
    ub = np.ones((S, N), dtype=dtype)        # everything binary
    for g in range(G):                       # self loops forbidden
        for t in range(T):
            ub[:, v_sd(t, g, g)] = 0.0

    # minimize negative lives saved (reference maximizes lives_saved)
    c = np.zeros((S, N), dtype=dtype)
    for t in range(T):
        for g in range(G):
            c[:, v_ita(t, 0, g)] = -lives[:, t, g]

    integer_mask = np.ones((S, N), dtype=bool)

    stage_cost_c = np.zeros((2, S, N), dtype=dtype)
    stage_cost_c[1] = c.copy()               # first-stage cost is 0

    nonant_idx = np.arange(D, dtype=np.int32)
    var_names = tuple(
        [f"is_active_depot[{d}]" for d in range(D)]
        + [f"depot_departures[{t},{d},{g}]" for t in range(T)
           for d in range(D) for g in range(G)]
        + [f"site_departures[{t},{g1},{g2}]" for t in range(T)
           for g1 in range(G) for g2 in range(G)]
        + [f"stays_at_site[{t},{g}]" for t in range(T) for g in range(G)]
        + [f"is_time_from_arrival[{t},{tau},{g}]" for t in range(T)
           for tau in range(T) for g in range(G)])
    tree = dict(
        node_of=np.zeros((S, D), np.int32),
        prob=np.full((S,), 1.0 / S, dtype=dtype),
        num_nodes=1,
        stage_of=(1,) * D,
        nonant_names=var_names[:D],
        scen_names=tuple(f"scen{i}" for i in range(S)),
    )
    return batch_from_arrays(dict(
        c=c, qdiag=np.zeros((S, N), dtype=dtype),
        A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        obj_const=np.zeros((S,), dtype=dtype),
        nonant_idx=nonant_idx, integer_mask=integer_mask,
        tree=tree, stage_cost_c=stage_cost_c, var_names=var_names), device=device)


def scenario_names_creator(num_scens, start=0):
    start = start or 0
    return [f"scen{i}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.num_scens_required()
    cfg.add_to_config("time_horizon", description="time steps",
                      domain=int, default=6)
    cfg.add_to_config("num_depots", description="depots", domain=int,
                      default=2)
    cfg.add_to_config("num_sites", description="incident sites",
                      domain=int, default=4)


def kw_creator(options):
    return {"time_horizon": options.get("time_horizon", 6),
            "num_depots": options.get("num_depots", 2),
            "num_sites": options.get("num_sites", 4)}


def scenario_denouement(rank, scenario_name, result):
    pass
