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

Not ported yet (ROADMAP.md queue A item 9's residual): the Jabr SOC
relaxation (`build_soc_batch`, `soc_violation`, `add_soc_cuts`,
`soc_refine`) refuses.
"""

from __future__ import annotations

import numpy as np

from .. import not_ported
from ..convert import batch_from_arrays
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


# ---- not ported yet: the Jabr SOC relaxation (ROADMAP.md queue A item
# 9's residual; the JAX package's acopf3.py:355-766) ----------------------

def _soc_refused(what):
    return not_ported(f"acopf3.{what} (the Jabr SOC relaxation and its "
                      "cone-cut refinement)", 9)


def build_soc_batch(*args, **kwargs):
    raise _soc_refused("build_soc_batch")


def soc_violation(*args, **kwargs):
    raise _soc_refused("soc_violation")


def add_soc_cuts(*args, **kwargs):
    raise _soc_refused("add_soc_cuts")


def soc_refine(*args, **kwargs):
    raise _soc_refused("soc_refine")
