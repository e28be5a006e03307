"""NETDES — 2-stage stochastic network design (structure parity with
the reference's netdes model, examples/netdes/netdes.py — the
cross-scenario-cuts showcase).

Port of `mpisppy_tpu/models/netdes.py`: the builder works in numpy, with
the same random draws, up to the final wrap into tensors on `device`
(default: the CUDA device), so its arrays equal the JAX builder's
exactly.

First stage: open arc a (binary x_a, fixed cost f_a).  Second stage:
route single-commodity flows from a source to a sink under a random
demand D^s; flow on a closed arc is forbidden (flow_a <= cap * x_a);
unserved demand is penalized so recourse is complete.

    min  sum_a f_a x_a + E[ sum_a c_a flow_a + pen * short ]
    s.t. flow balance at each node (source injects D^s - short)
         flow_a - cap_a * x_a <= 0
Nonants: x (binary).

The network is a seeded random layered digraph (n_nodes, arc density),
mirroring the scale of the SIPLIB-style netdes instances without
copying their data files.
"""

from __future__ import annotations

import numpy as np

from ..convert import batch_from_arrays

INF = float("inf")


def _network(n_nodes, seed=2077):
    """Layered digraph: node 0 = source, n-1 = sink, plus all 'forward'
    random arcs; returns arc list [(u, v)], costs, caps, fixed costs."""
    rng = np.random.RandomState(seed)
    arcs = []
    for u in range(n_nodes - 1):
        for v in range(u + 1, n_nodes):
            if v == u + 1 or rng.rand() < 0.5:
                arcs.append((u, v))
    arcs = np.array(arcs)
    nA = len(arcs)
    f = np.round(20.0 + 60.0 * rng.rand(nA))
    cv = np.round(1.0 + 9.0 * rng.rand(nA))
    cap = np.round(30.0 + 40.0 * rng.rand(nA))
    return arcs, f, cv, cap


def scenario_demand(scennum, num_scens, seed=2077):
    rng = np.random.RandomState(seed + 5000 + scennum)
    return float(np.round(20.0 + 30.0 * rng.rand()))


def build_batch(num_scens, n_nodes=6, overflow_penalty=200.0, seed=2077,
                dtype=np.float64, device=None):
    arcs, f, cv, cap = _network(n_nodes, seed)
    nA = len(arcs)
    S = num_scens
    # layout: [x (nA) | flow (nA) | short (1)]
    ix, ifl, ish = 0, nA, 2 * nA
    N = 2 * nA + 1
    M = n_nodes + nA
    A = np.zeros((S, M, N), dtype=dtype)
    row_lo = np.full((S, M), -INF, dtype=dtype)
    row_hi = np.full((S, M), INF, dtype=dtype)

    D = np.array([scenario_demand(s, S, seed) for s in range(S)])
    for node in range(n_nodes):
        out_arcs = np.where(arcs[:, 0] == node)[0]
        in_arcs = np.where(arcs[:, 1] == node)[0]
        A[:, node, ifl + out_arcs] = 1.0
        A[:, node, ifl + in_arcs] = -1.0
        if node == 0:
            A[:, node, ish] = 1.0        # out - in + short = D
            row_lo[:, node] = D
            row_hi[:, node] = D
        elif node == n_nodes - 1:
            A[:, node, ish] = -1.0       # out - in - short = -D
            row_lo[:, node] = -D
            row_hi[:, node] = -D
        else:
            row_lo[:, node] = 0.0
            row_hi[:, node] = 0.0
    for a in range(nA):                  # flow_a - cap_a x_a <= 0
        r = n_nodes + a
        A[:, r, ifl + a] = 1.0
        A[:, r, ix + a] = -cap[a]
        row_hi[:, r] = 0.0

    lb = np.zeros((S, N), dtype=dtype)
    ub = np.full((S, N), INF, dtype=dtype)
    ub[:, ix:ix + nA] = 1.0

    c = np.zeros((S, N), dtype=dtype)
    c[:, ix:ix + nA] = f
    c[:, ifl:ifl + nA] = cv
    c[:, ish] = overflow_penalty

    integer_mask = np.zeros((S, N), dtype=bool)
    integer_mask[:, ix:ix + nA] = True

    stage_cost_c = np.zeros((2, S, N), dtype=dtype)
    stage_cost_c[0, :, ix:ix + nA] = f
    stage_cost_c[1] = c.copy()
    stage_cost_c[1, :, ix:ix + nA] = 0.0

    nonant_idx = np.arange(nA, dtype=np.int32)
    var_names = (
        tuple(f"x[{u}->{v}]" for u, v in arcs)
        + tuple(f"flow[{u}->{v}]" for u, v in arcs)
        + ("short",))
    tree = dict(
        node_of=np.zeros((S, nA), np.int32),
        prob=np.full((S,), 1.0 / S, dtype=dtype),
        num_nodes=1,
        stage_of=(1,) * nA,
        nonant_names=var_names[:nA],
        scen_names=tuple(f"Scenario{i+1}" for i in range(S)),
    )
    return batch_from_arrays(dict(
        c=c, qdiag=np.zeros((S, N), dtype=dtype),
        A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        obj_const=np.zeros((S,), dtype=dtype),
        nonant_idx=nonant_idx, integer_mask=integer_mask,
        tree=tree, stage_cost_c=stage_cost_c, var_names=var_names), device=device)


def scenario_names_creator(num_scens, start=0):
    return [f"Scenario{i+1}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.num_scens_required()
    cfg.add_to_config("netdes_nodes", description="network nodes",
                      domain=int, default=6)


def kw_creator(options):
    return {"n_nodes": options.get("netdes_nodes", 6)}
