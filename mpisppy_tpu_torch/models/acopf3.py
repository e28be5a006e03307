"""ACOPF3 — multistage optimal power flow with random line outages
(reference: examples/acopf3/ccopf_multistage.py + ACtree.py, which
builds chance-constrained AC-OPF instances over an outage scenario
tree via egret/matpower and per-stage repair processes).

Port of `mpisppy_tpu/models/acopf3.py`: the builder works in numpy, with
the same random draws, up to the final wrap into tensors on `device`
(default: the CUDA device), so its arrays equal the JAX builder's
exactly.

Array-native analog: the **DC** approximation (the standard convex
relaxation of the reference's `convex_relaxation=True` mode) over the
same kind of outage tree, lowered directly to batched arrays — no
external power-systems stack.  Per scenario and stage t:

    g[t, i]      generator dispatch            (nonant for t < T)
    th[t, b]     bus voltage angle (slack bus pinned to 0)
    f[t, l]      line flow
    mp/mn[t, b]  load-mismatch slacks (cost `load_mismatch_cost`,
                 the reference's default 1000, ccopf_multistage.py:77)

Rows:
    f[t, l] - alive[t, l] * B_l (th_from - th_to) == 0   (DC flow; an
        OUTAGE sets alive=0, forcing the flow to zero)
    sum_in f - sum_out f + gen_at_bus + mp - mn == load[t, b]
    -ramp <= g[t, i] - g[t-1, i] <= ramp                 (ramping)
Boxes: |f| <= cap, |th| <= pi, 0 <= g <= gmax, 0 <= m <= total load —
all finite, so PDHG dual objectives are valid bounds at any iterate
(spopt.valid_Ebound).

Generator cost is c1*g + c2*g^2 via the batch's diagonal quadratic
term — this model family exercises the QP path of the kernel.

Outage process: at each non-root tree node, the node's branch digit d
selects line d-1 to fail for that stage (digit 0 = no new outage);
outages persist down the tree (no repair — the reference's FixNever;
its FixGaussian repair corresponds to clearing alive bits, hookable
via `repair`).  The grid is a seeded ring-plus-chords synthetic case,
or the embedded IEEE 14-bus case (`case="ieee14"`).

The Jabr SOC relaxation (`build_soc_batch`) lifts the same outage tree
to the AC branch-flow variables, with a buffer of inactive cut rows;
`soc_refine` tightens it by outer approximation: each round solves the
EF (consensus route) warm-started from the last, and `add_soc_cuts`
activates one supporting hyperplane per violated cone.  The cut rows
are built on the host and copied to the device in one indexed write.
"""

from __future__ import annotations

import numpy as np

import dataclasses

import torch

from ..convert import batch_from_arrays
from ..device import host
from ..scenario_tree import MultistageTree

INF = float("inf")


# IEEE 14-bus test case — standard public benchmark data (the
# matpower/PGLib `case14`): bus loads (MW), branch endpoints and
# series reactances (p.u.), generator buses, limits (MW), and
# polynomial costs.  This is the kind of real network the reference
# feeds egret (examples/acopf3/ccopf_multistage.py builds instances
# from matpower case files); embedding the published case data mirrors
# how sizes/sslp embed SIZES/SIPLIB instance data.  Branch thermal
# limits: case14 publishes none (rateA=0 = unlimited); we use a
# uniform finite `line_cap` (default 160 MW — non-binding in the
# nominal dispatch, binding under outages) because the kernel's
# bound-validity rule wants all-finite boxes.
_IEEE14_LOAD = [0.0, 21.7, 94.2, 47.8, 7.6, 11.2, 0.0, 0.0, 29.5,
                9.0, 3.5, 6.1, 13.5, 14.9]
_IEEE14_LINES = [
    (0, 1, 0.05917), (0, 4, 0.22304), (1, 2, 0.19797),
    (1, 3, 0.17632), (1, 4, 0.17388), (2, 3, 0.17103),
    (3, 4, 0.04211), (3, 6, 0.20912), (3, 8, 0.55618),
    (4, 5, 0.25202), (5, 10, 0.19890), (5, 11, 0.25581),
    (5, 12, 0.13027), (6, 7, 0.17615), (6, 8, 0.11001),
    (8, 9, 0.08450), (8, 13, 0.27038), (9, 10, 0.19207),
    (11, 12, 0.19988), (12, 13, 0.34802)]
_IEEE14_GEN_BUS = [0, 1, 2, 5, 7]
_IEEE14_GMAX = [332.4, 140.0, 100.0, 100.0, 100.0]
_IEEE14_C1 = [20.0, 20.0, 40.0, 40.0, 40.0]
_IEEE14_C2 = [0.0430292599, 0.25, 0.01, 0.01, 0.01]


def _grid_ieee14(line_cap=160.0):
    lines = [(a, b) for a, b, _ in _IEEE14_LINES]
    # reactances are per-unit on the 100 MVA system base; loads/flows
    # here are MW, so B[MW/rad] = 100 / x_pu
    susceptance = np.array([100.0 / x for _, _, x in _IEEE14_LINES])
    cap = np.full(len(lines), float(line_cap))
    gen_bus = np.array(_IEEE14_GEN_BUS)
    return (lines, susceptance, cap, gen_bus,
            np.array(_IEEE14_GMAX), np.array(_IEEE14_C1),
            np.array(_IEEE14_C2), np.array(_IEEE14_LOAD))


def _grid(n_bus, n_line, n_gen, seed):
    rng = np.random.RandomState(seed)
    # ring + random chords; at most C(n_bus, 2) distinct lines exist,
    # so cap the request or the chord loop would never terminate
    n_line = min(n_line, n_bus * (n_bus - 1) // 2)
    lines = [(b, (b + 1) % n_bus) for b in range(n_bus)]
    while len(lines) < n_line:
        a, b = rng.randint(0, n_bus, 2)
        if a != b and (a, b) not in lines and (b, a) not in lines:
            lines.append((a, b))
    lines = lines[:n_line]
    susceptance = 5.0 + 10.0 * rng.rand(len(lines))
    cap = 60.0 + 40.0 * rng.rand(len(lines))
    gen_bus = rng.choice(n_bus, size=n_gen, replace=False)
    gmax = 80.0 + 40.0 * rng.rand(n_gen)
    c1 = 10.0 + 10.0 * rng.rand(n_gen)
    c2 = 0.05 + 0.1 * rng.rand(n_gen)
    base_load = 20.0 + 20.0 * rng.rand(n_bus)
    return (lines, susceptance, cap, gen_bus, gmax, c1, c2, base_load)


def build_batch(branching_factors=(2, 2), n_bus=5, n_line=6, n_gen=3,
                ramp=None, load_mismatch_cost=1000.0, seed=3301,
                repair=False, case=None, line_cap=160.0,
                dtype=np.float64, device=None):
    """case=None: seeded synthetic ring-plus-chords grid (n_bus /
    n_line / n_gen sized).  case="ieee14": the embedded IEEE 14-bus
    benchmark network (n_bus/n_line/n_gen ignored; `line_cap` sets the
    uniform thermal limit).  ramp=None resolves per case: 40 MW on the
    synthetic grid, a third of each unit's Pmax on ieee14."""
    tree = MultistageTree(list(branching_factors))
    T = tree.n_stages
    S = tree.num_scens
    if case == "ieee14":
        (lines, B, cap, gen_bus, gmax, c1, c2, base_load) = \
            _grid_ieee14(line_cap)
        n_bus, n_gen = len(base_load), len(gen_bus)
        if ramp is None:
            ramp = gmax / 3.0
    elif case is not None:
        raise ValueError(f"unknown case {case!r} (None or 'ieee14')")
    else:
        (lines, B, cap, gen_bus, gmax, c1, c2, base_load) = _grid(
            n_bus, n_line, n_gen, seed)
        if ramp is None:
            ramp = 40.0
    nL, nG, nB = len(lines), n_gen, n_bus
    ramp_arr = np.broadcast_to(np.asarray(ramp, float), (nG,))

    # outage mask per scenario per stage: branch digit d at stage t>=2
    # fails line d-1 (0 = none); persists unless repair
    alive = np.ones((S, T, nL))
    for s in range(S):
        digits = tree.scen_digits(s)
        out = set()
        for t in range(1, T):
            d = digits[t - 1] % (nL + 1)
            if d > 0:
                out.add(d - 1)
            if repair and len(out) > 1:
                out.pop()
            for l_ in out:
                alive[s, t, l_] = 0.0

    # per-stage layout: [g (nG) | th (nB) | f (nL) | mp (nB) | mn (nB)]
    per = nG + nB + nL + 2 * nB
    N = T * per

    def vg(t, i):
        return t * per + i

    def vth(t, b):
        return t * per + nG + b

    def vf(t, l_):
        return t * per + nG + nB + l_

    def vmp(t, b):
        return t * per + nG + nB + nL + b

    def vmn(t, b):
        return t * per + nG + nB + nL + nB + b

    # loads grow slightly by stage
    load = np.stack([base_load * (1.0 + 0.1 * t) for t in range(T)])

    M = T * nL + T * nB + (T - 1) * nG
    A = np.zeros((S, M, N), dtype=dtype)
    row_lo = np.full((S, M), -INF, dtype=dtype)
    row_hi = np.full((S, M), INF, dtype=dtype)
    r = 0
    for t in range(T):                 # DC flow definition
        for l_, (a, b) in enumerate(lines):
            A[:, r, vf(t, l_)] = 1.0
            A[:, r, vth(t, a)] = -alive[:, t, l_] * B[l_]
            A[:, r, vth(t, b)] = alive[:, t, l_] * B[l_]
            row_lo[:, r] = row_hi[:, r] = 0.0
            r += 1
    for t in range(T):                 # bus balance
        for b in range(nB):
            for l_, (x, y) in enumerate(lines):
                if y == b:
                    A[:, r, vf(t, l_)] = 1.0
                elif x == b:
                    A[:, r, vf(t, l_)] = -1.0
            for i, gb in enumerate(gen_bus):
                if gb == b:
                    A[:, r, vg(t, i)] = 1.0
            A[:, r, vmp(t, b)] = 1.0
            A[:, r, vmn(t, b)] = -1.0
            row_lo[:, r] = row_hi[:, r] = load[t, b]
            r += 1
    for t in range(1, T):              # ramping
        for i in range(nG):
            A[:, r, vg(t, i)] = 1.0
            A[:, r, vg(t - 1, i)] = -1.0
            row_lo[:, r] = -ramp_arr[i]
            row_hi[:, r] = ramp_arr[i]
            r += 1
    assert r == M

    lb = np.zeros((S, N), dtype=dtype)
    ub = np.zeros((S, N), dtype=dtype)
    tot = float(load.max(axis=0).sum())
    for t in range(T):
        for i in range(nG):
            ub[:, vg(t, i)] = gmax[i]
        for b in range(nB):
            lb[:, vth(t, b)] = -np.pi if b else 0.0
            ub[:, vth(t, b)] = np.pi if b else 0.0   # slack bus pinned
            ub[:, vmp(t, b)] = tot
            ub[:, vmn(t, b)] = tot
        for l_ in range(nL):
            lb[:, vf(t, l_)] = -cap[l_]
            ub[:, vf(t, l_)] = cap[l_]

    c = np.zeros((S, N), dtype=dtype)
    qdiag = np.zeros((S, N), dtype=dtype)
    stage_cost_c = np.zeros((T, S, N), dtype=dtype)
    for t in range(T):
        for i in range(nG):
            c[:, vg(t, i)] = c1[i]
            qdiag[:, vg(t, i)] = 2.0 * c2[i]
            stage_cost_c[t, :, vg(t, i)] = c1[i]
        for b in range(nB):
            c[:, vmp(t, b)] = load_mismatch_cost
            c[:, vmn(t, b)] = load_mismatch_cost
            stage_cost_c[t, :, vmp(t, b)] = load_mismatch_cost
            stage_cost_c[t, :, vmn(t, b)] = load_mismatch_cost

    # nonants: dispatch for stages 1..T-1, stage-major (the leaf stage
    # is pure recourse), matching the reference's per-node dispatch
    nonant_idx = np.array(
        [vg(t, i) for t in range(T - 1) for i in range(nG)], np.int32)
    stage_of = tuple(t + 1 for t in range(T - 1) for _ in range(nG))
    node_of = np.stack([
        tree.node_of_slots(s, stage_of) for s in range(S)
    ]).astype(np.int32)

    var_names = tuple(
        f"{nm}[{t+1},{k}]"
        for t in range(T)
        for nm, n in (("g", nG), ("th", nB), ("f", nL), ("mp", nB),
                      ("mn", nB))
        for k in range(n))
    treeinfo = dict(
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
        integer_mask=np.zeros((S, N), dtype=bool),
        tree=treeinfo, stage_cost_c=stage_cost_c, var_names=var_names), device=device)


# IEEE 14-bus AC data (same public matpower/PGLib case14 the DC section
# embeds): series resistance per branch (same order as _IEEE14_LINES),
# reactive loads (MVAr), generator reactive limits (MVAr), voltage
# band.  Branches with r=0 are the case's transformers.
_IEEE14_R = [0.01938, 0.05403, 0.04699, 0.05811, 0.05695, 0.06701,
             0.01335, 0.0, 0.0, 0.0, 0.09498, 0.12291, 0.06615,
             0.0, 0.0, 0.03181, 0.12711, 0.08205, 0.22092, 0.17093]
_IEEE14_QLOAD = [0.0, 12.7, 19.0, -3.9, 1.6, 7.5, 0.0, 0.0, 16.6,
                 5.8, 1.8, 1.6, 5.8, 5.0]
_IEEE14_QMIN = [0.0, -40.0, 0.0, -6.0, -6.0]
_IEEE14_QMAX = [10.0, 50.0, 40.0, 24.0, 24.0]
_IEEE14_VMIN, _IEEE14_VMAX = 0.94, 1.06


def _grid_soc(n_bus, n_line, n_gen, seed):
    """Seeded synthetic AC grid in per-unit (the p.u.-sane analog of
    `_grid` — that generator's MW-per-radian susceptances don't map to
    a physical AC case): ring + chords, x in [0.05, 0.2] p.u.,
    r = 0.3 x (lossy), loads 0.2-0.4 p.u., thermal caps sized so the
    nominal dispatch is feasible without shed."""
    rng = np.random.RandomState(seed)
    n_line = min(n_line, n_bus * (n_bus - 1) // 2)
    lines = [(b, (b + 1) % n_bus) for b in range(n_bus)]
    while len(lines) < n_line:
        a, b = rng.randint(0, n_bus, 2)
        if a != b and (a, b) not in lines and (b, a) not in lines:
            lines.append((a, b))
    lines = lines[:n_line]
    x = 0.05 + 0.15 * rng.rand(len(lines))
    r = 0.3 * x
    cap = 0.8 + 0.4 * rng.rand(len(lines))
    gen_bus = rng.choice(n_bus, size=n_gen, replace=False)
    gmax = 0.8 + 0.4 * rng.rand(n_gen)
    qmin = -0.3 * np.ones(n_gen)
    qmax = 0.5 * np.ones(n_gen)
    c1 = 10.0 + 10.0 * rng.rand(n_gen)
    c2 = 0.05 + 0.1 * rng.rand(n_gen)
    pload = 0.2 + 0.2 * rng.rand(n_bus)
    qload = 0.3 * pload
    return (lines, r, x, cap, gen_bus, gmax, qmin, qmax, c1, c2,
            pload, qload)


def build_soc_batch(branching_factors=(2, 2), case=None, n_bus=5,
                    n_line=6, n_gen=3, ramp=None,
                    load_mismatch_cost=1000.0, seed=3301,
                    repair=False, line_cap=160.0, soc_cut_slots=6,
                    dtype=np.float64, device=None):
    """Jabr SOC relaxation over the same outage tree as `build_batch`.

    Per stage t the layout is
        [pg nG | qg nG | u nB | cc nL | ss nL |
         P nL | Pr nL | Q nL | Qr nL | mp nB | mn nB | rp nB | rn nB]
    (P/Pr = active power entering the line at its from/to bus; Q/Qr
    reactive; mp/mn active-mismatch slacks, rp/rn reactive — slacks
    keep every instance structurally feasible, the reference's
    load_mismatch_cost recourse).

    soc_cut_slots: cone-cut buffer capacity per (stage, line).  Cut
    rows start inactive (all-zero, free bounds) and are activated in
    place by `add_soc_cuts`; shapes never change across refine rounds.

    model_meta carries the cone index tables (soc_*, host numpy)
    consumed by soc_violation / add_soc_cuts / soc_refine."""
    tree = MultistageTree(list(branching_factors))
    T = tree.n_stages
    S = tree.num_scens
    if case == "ieee14":
        lines = [(a, b) for a, b, _ in _IEEE14_LINES]
        r_pu = np.array(_IEEE14_R)
        x_pu = np.array([x for _, _, x in _IEEE14_LINES])
        cap = np.full(len(lines), float(line_cap) / 100.0)   # p.u.
        gen_bus = np.array(_IEEE14_GEN_BUS)
        gmax = np.array(_IEEE14_GMAX) / 100.0
        qmin = np.array(_IEEE14_QMIN) / 100.0
        qmax = np.array(_IEEE14_QMAX) / 100.0
        c1 = np.array(_IEEE14_C1)
        c2 = np.array(_IEEE14_C2)
        pload = np.array(_IEEE14_LOAD) / 100.0
        qload = np.array(_IEEE14_QLOAD) / 100.0
        vmin, vmax = _IEEE14_VMIN, _IEEE14_VMAX
        n_bus = len(pload)
    elif case is not None:
        raise ValueError(f"unknown case {case!r} (None or 'ieee14')")
    else:
        (lines, r_pu, x_pu, cap, gen_bus, gmax, qmin, qmax, c1, c2,
         pload, qload) = _grid_soc(n_bus, n_line, n_gen, seed)
        vmin, vmax = 0.94, 1.06
    nL, nG, nB = len(lines), len(gen_bus), n_bus
    if ramp is None:
        ramp_arr = gmax / 3.0
    else:
        ramp_arr = np.broadcast_to(np.asarray(ramp, float) / 100.0
                                   if case == "ieee14"
                                   else np.asarray(ramp, float), (nG,))
    # series admittance y = 1/(r+jx) = g + jb
    z2 = r_pu * r_pu + x_pu * x_pu
    g_l = r_pu / z2
    b_l = -x_pu / z2

    alive = np.ones((S, T, nL))
    for s in range(S):
        digits = tree.scen_digits(s)
        out = set()
        for t in range(1, T):
            d = digits[t - 1] % (nL + 1)
            if d > 0:
                out.add(d - 1)
            if repair and len(out) > 1:
                out.pop()
            for l_ in out:
                alive[s, t, l_] = 0.0

    per = 2 * nG + 5 * nB + 6 * nL
    N = T * per

    def vpg(t, i):
        return t * per + i

    def vqg(t, i):
        return t * per + nG + i

    def vu(t, b):
        return t * per + 2 * nG + b

    def vcc(t, l_):
        return t * per + 2 * nG + nB + l_

    def vss(t, l_):
        return t * per + 2 * nG + nB + nL + l_

    def vP(t, l_):
        return t * per + 2 * nG + nB + 2 * nL + l_

    def vPr(t, l_):
        return t * per + 2 * nG + nB + 3 * nL + l_

    def vQ(t, l_):
        return t * per + 2 * nG + nB + 4 * nL + l_

    def vQr(t, l_):
        return t * per + 2 * nG + nB + 5 * nL + l_

    def vmp(t, b):
        return t * per + 2 * nG + nB + 6 * nL + b

    def vmn(t, b):
        return t * per + 2 * nG + 2 * nB + 6 * nL + b

    def vrp(t, b):
        return t * per + 2 * nG + 3 * nB + 6 * nL + b

    def vrn(t, b):
        return t * per + 2 * nG + 4 * nB + 6 * nL + b

    pload_t = np.stack([pload * (1.0 + 0.1 * t) for t in range(T)])
    qload_t = np.stack([qload * (1.0 + 0.1 * t) for t in range(T)])

    n_cut = soc_cut_slots * T * nL
    M = T * (4 * nL + 2 * nB) + (T - 1) * nG + n_cut
    A = np.zeros((S, M, N), dtype=dtype)
    row_lo = np.full((S, M), -INF, dtype=dtype)
    row_hi = np.full((S, M), INF, dtype=dtype)
    r = 0
    for t in range(T):          # branch-flow definitions (4 per line)
        for l_, (a, b) in enumerate(lines):
            al = alive[:, t, l_]
            # P - alive*(g u_a - g cc - b ss) = 0
            A[:, r, vP(t, l_)] = 1.0
            A[:, r, vu(t, a)] = -al * g_l[l_]
            A[:, r, vcc(t, l_)] = al * g_l[l_]
            A[:, r, vss(t, l_)] = al * b_l[l_]
            row_lo[:, r] = row_hi[:, r] = 0.0
            r += 1
            # Q - alive*(-b u_a + b cc - g ss) = 0
            A[:, r, vQ(t, l_)] = 1.0
            A[:, r, vu(t, a)] = al * b_l[l_]
            A[:, r, vcc(t, l_)] = -al * b_l[l_]
            A[:, r, vss(t, l_)] = al * g_l[l_]
            row_lo[:, r] = row_hi[:, r] = 0.0
            r += 1
            # Pr - alive*(g u_b - g cc + b ss) = 0
            A[:, r, vPr(t, l_)] = 1.0
            A[:, r, vu(t, b)] = -al * g_l[l_]
            A[:, r, vcc(t, l_)] = al * g_l[l_]
            A[:, r, vss(t, l_)] = -al * b_l[l_]
            row_lo[:, r] = row_hi[:, r] = 0.0
            r += 1
            # Qr - alive*(-b u_b + b cc + g ss) = 0
            A[:, r, vQr(t, l_)] = 1.0
            A[:, r, vu(t, b)] = al * b_l[l_]
            A[:, r, vcc(t, l_)] = -al * b_l[l_]
            A[:, r, vss(t, l_)] = -al * g_l[l_]
            row_lo[:, r] = row_hi[:, r] = 0.0
            r += 1
    for t in range(T):          # bus balances (P then Q per bus)
        for b in range(nB):
            for i, gb in enumerate(gen_bus):
                if gb == b:
                    A[:, r, vpg(t, i)] = 1.0
                    A[:, r + 1, vqg(t, i)] = 1.0
            for l_, (xx, yy) in enumerate(lines):
                if xx == b:
                    A[:, r, vP(t, l_)] = -1.0
                    A[:, r + 1, vQ(t, l_)] = -1.0
                elif yy == b:
                    A[:, r, vPr(t, l_)] = -1.0
                    A[:, r + 1, vQr(t, l_)] = -1.0
            A[:, r, vmp(t, b)] = 1.0
            A[:, r, vmn(t, b)] = -1.0
            row_lo[:, r] = row_hi[:, r] = pload_t[t, b]
            A[:, r + 1, vrp(t, b)] = 1.0
            A[:, r + 1, vrn(t, b)] = -1.0
            row_lo[:, r + 1] = row_hi[:, r + 1] = qload_t[t, b]
            r += 2
    for t in range(1, T):       # ramping on active dispatch
        for i in range(nG):
            A[:, r, vpg(t, i)] = 1.0
            A[:, r, vpg(t - 1, i)] = -1.0
            row_lo[:, r] = -ramp_arr[i]
            row_hi[:, r] = ramp_arr[i]
            r += 1
    cut_base = r
    assert r + n_cut == M       # remaining rows: inactive cut buffer

    lb = np.zeros((S, N), dtype=dtype)
    ub = np.zeros((S, N), dtype=dtype)
    totp = float(pload_t.max(axis=0).sum()) + float(np.sum(gmax))
    totq = float(np.abs(qload_t).max(axis=0).sum()) \
        + float(np.abs(qmax).sum()) + float(np.abs(qmin).sum())
    for t in range(T):
        for i in range(nG):
            ub[:, vpg(t, i)] = gmax[i]
            lb[:, vqg(t, i)] = qmin[i]
            ub[:, vqg(t, i)] = qmax[i]
        for b in range(nB):
            lb[:, vu(t, b)] = vmin * vmin
            ub[:, vu(t, b)] = vmax * vmax
            ub[:, vmp(t, b)] = totp
            ub[:, vmn(t, b)] = totp
            ub[:, vrp(t, b)] = totq
            ub[:, vrn(t, b)] = totq
        for l_ in range(nL):
            al = alive[:, t, l_]
            # dead line: flows AND lifted products pinned to zero
            lb[:, vcc(t, l_)] = 0.0
            ub[:, vcc(t, l_)] = al * vmax * vmax
            lb[:, vss(t, l_)] = -al * vmax * vmax
            ub[:, vss(t, l_)] = al * vmax * vmax
            for vv in (vP, vPr, vQ, vQr):
                lb[:, vv(t, l_)] = -al * cap[l_]
                ub[:, vv(t, l_)] = al * cap[l_]

    # $/h costs: pg is p.u. -> c1[$/MWh]*100*pg; quadratic 2*c2*1e4
    c = np.zeros((S, N), dtype=dtype)
    qdiag = np.zeros((S, N), dtype=dtype)
    stage_cost_c = np.zeros((T, S, N), dtype=dtype)
    shed_cost = load_mismatch_cost * 100.0
    for t in range(T):
        for i in range(nG):
            c[:, vpg(t, i)] = c1[i] * 100.0
            qdiag[:, vpg(t, i)] = 2.0 * c2[i] * 1e4
            stage_cost_c[t, :, vpg(t, i)] = c1[i] * 100.0
        for b in range(nB):
            for vv in (vmp, vmn, vrp, vrn):
                c[:, vv(t, b)] = shed_cost
                stage_cost_c[t, :, vv(t, b)] = shed_cost

    nonant_idx = np.array(
        [vpg(t, i) for t in range(T - 1) for i in range(nG)], np.int32)
    stage_of = tuple(t + 1 for t in range(T - 1) for _ in range(nG))
    node_of = np.stack([
        tree.node_of_slots(s, stage_of) for s in range(S)
    ]).astype(np.int32)

    var_names = tuple(
        f"{nm}[{t+1},{k}]"
        for t in range(T)
        for nm, n in (("pg", nG), ("qg", nG), ("u", nB), ("cc", nL),
                      ("ss", nL), ("P", nL), ("Pr", nL), ("Q", nL),
                      ("Qr", nL), ("mp", nB), ("mn", nB), ("rp", nB),
                      ("rn", nB))
        for k in range(n))
    treeinfo = dict(
        node_of=node_of,
        prob=np.array([tree.scen_probability(s) for s in range(S)],
                      dtype=dtype),
        num_nodes=tree.num_nodes,
        stage_of=stage_of,
        nonant_names=tuple(var_names[i] for i in nonant_idx),
        scen_names=tuple(f"Scenario{s+1}" for s in range(S)),
    )
    meta = {
        "soc_cc": np.array([[vcc(t, l_) for l_ in range(nL)]
                            for t in range(T)], np.int32),
        "soc_ss": np.array([[vss(t, l_) for l_ in range(nL)]
                            for t in range(T)], np.int32),
        "soc_ua": np.array([[vu(t, a) for a, _ in lines]
                            for t in range(T)], np.int32),
        "soc_ub": np.array([[vu(t, b) for _, b in lines]
                            for t in range(T)], np.int32),
        "soc_alive": alive.astype(dtype),
        "soc_cut_base": int(cut_base),
        "soc_cut_slots": int(soc_cut_slots),
    }
    return batch_from_arrays(dict(
        c=c, qdiag=qdiag,
        A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        obj_const=np.zeros((S,), dtype=dtype),
        nonant_idx=nonant_idx,
        integer_mask=np.zeros((S, N), dtype=bool),
        tree=treeinfo, stage_cost_c=stage_cost_c,
        var_names=var_names, model_meta=meta), device=device)



def soc_violation(batch, x):
    """Cone violation cc^2 + ss^2 - u_a*u_b per (scenario, stage, line)
    for a (S, N) primal point (tensor or array), masked to live lines ->
    (S, T, nL) numpy."""
    m = batch.model_meta
    x = host(x)[:batch.num_scens]
    cc = x[:, m["soc_cc"]]
    ss = x[:, m["soc_ss"]]
    ua = x[:, m["soc_ua"]]
    ub_ = x[:, m["soc_ub"]]
    return m["soc_alive"] * (cc * cc + ss * ss - ua * ub_)


def add_soc_cuts(batch, x, round_idx, tol=1e-7):
    """Activate one supporting-hyperplane cut per violated
    (scenario, stage, line) cone at the incumbent `x`.

    Rotated cone cc^2+ss^2 <= ua*ub == ||(2cc, 2ss, ua-ub)|| <= ua+ub;
    at a violating point p = (2c, 2s, ua-ub) with rho = ||p||, the
    supporting hyperplane is (p/rho).(2cc, 2ss, ua-ub) - ua - ub <= 0.
    Round k writes slot k mod soc_cut_slots of each (stage, line) —
    the oldest cut is recycled once the buffer wraps (bounded memory,
    static shapes).  The cut rows are assembled on the host and
    written into a copy of A with one indexed copy.

    Returns (new_batch, max_violation, n_cuts_added)."""
    m = batch.model_meta
    S = batch.num_scens
    T, nL = m["soc_cc"].shape
    slots = int(m["soc_cut_slots"])
    base = int(m["soc_cut_base"])
    viol = soc_violation(batch, x)
    x = host(x)
    N = batch.num_vars
    k = round_idx % slots
    cc_i, ss_i, ua_i, ub_i = (m["soc_cc"], m["soc_ss"], m["soc_ua"],
                              m["soc_ub"])
    srows, rrows, rows = [], [], []
    for s in range(S):
        for t in range(T):
            for l_ in range(nL):
                if viol[s, t, l_] <= tol:
                    continue
                ic, is_, ia, ib = (cc_i[t, l_], ss_i[t, l_],
                                   ua_i[t, l_], ub_i[t, l_])
                p = np.array([2 * x[s, ic], 2 * x[s, is_],
                              x[s, ia] - x[s, ib]])
                rho = float(np.linalg.norm(p))
                if rho < 1e-12:
                    continue
                row = np.zeros(N)
                row[ic] = 2 * p[0] / rho
                row[is_] = 2 * p[1] / rho
                row[ia] = p[2] / rho - 1.0
                row[ib] = -p[2] / rho - 1.0
                srows.append(s)
                rrows.append(base + k * T * nL + t * nL + l_)
                rows.append(row)
    A, row_lo, row_hi = batch.A, batch.row_lo, batch.row_hi
    if rows:
        dev, dt = A.device, A.dtype
        si = torch.as_tensor(srows, device=dev)
        ri = torch.as_tensor(rrows, device=dev)
        A = A.clone()
        A[si, ri] = torch.as_tensor(np.stack(rows), dtype=dt, device=dev)
        row_lo = row_lo.clone()
        row_lo[si, ri] = -INF
        row_hi = row_hi.clone()
        row_hi[si, ri] = 0.0
    nb = dataclasses.replace(batch, A=A, row_lo=row_lo, row_hi=row_hi)
    return nb, float(viol.max(initial=0.0)), len(rows)


def soc_refine(batch, opts=None, rounds=8, tol=1e-5, solve=None):
    """Outer-approximation loop: solve the current relaxation, cut the
    violated cones, repeat.  `solve(batch) -> (S, N) x` defaults to the
    consensus-route ExtensiveForm solve on the batch's device; pass a
    custom callable to refine around PH/xhat incumbents instead.
    Returns (batch, history) where history rows are
    (round, objective, max_violation, n_cuts)."""
    from ..opt.ef import ExtensiveForm

    opts = dict(opts or {})
    opts.setdefault("pdhg_eps", 1e-6)
    opts.setdefault("pdhg_max_iters", 60000)
    warm = {"x": None, "y": None}

    def _ef_solve(b):
        ef = ExtensiveForm(dict(opts), list(b.tree.scen_names), batch=b,
                           device=b.c.device)
        # warm start from the previous round: a new cut only nudges the
        # optimum.  certify=False: a supporting hyperplane of the cone
        # is a valid cut wherever it is generated, so intermediate
        # rounds need no f64 certificate (the caller certifies its own
        # final solve)
        ef.solve_extensive_form(certify=False,
                                x0=warm["x"], y0=warm["y"])
        warm["x"], warm["y"] = ef._result.x, ef._result.y
        return ef._result.x, float(ef.get_objective_value())

    history = []
    for rd in range(rounds):
        if solve is None:
            x, obj = _ef_solve(batch)
        else:
            out = solve(batch)
            x, obj = (out if isinstance(out, tuple)
                      else (out, float("nan")))
        batch, mv, n = add_soc_cuts(batch, x, rd)
        history.append((rd, obj, mv, n))
        if mv <= tol:
            break
    return batch, history


MULTISTAGE = True


def scenario_names_creator(num_scens, start=0):
    start = start or 0
    return [f"Scenario{i+1}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.add_branching_factors()
    cfg.add_to_config("n_bus", description="buses", domain=int,
                      default=5)
    cfg.add_to_config("n_line", description="lines", domain=int,
                      default=6)
    cfg.add_to_config("n_gen", description="generators", domain=int,
                      default=3)
    cfg.add_to_config("case", description="network case (ieee14 or "
                      "empty for the synthetic grid)", domain=str,
                      default="")
    cfg.add_to_config("line_cap", description="uniform thermal limit "
                      "(MW) for case networks", domain=float,
                      default=160.0)


def kw_creator(options):
    from ..utils.config import parse_branching_factors
    return {"branching_factors": parse_branching_factors(
        options.get("branching_factors", (2, 2))),
        "n_bus": options.get("n_bus", 5),
        "n_line": options.get("n_line", 6),
        "n_gen": options.get("n_gen", 3),
        "case": options.get("case") or None,
        "line_cap": options.get("line_cap", 160.0)}


def scenario_denouement(rank, scenario_name, result):
    pass


