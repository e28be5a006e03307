"""SSLP — 2-stage stochastic server location (port of
`mpisppy_tpu/models/sslp.py`).

Two instance sources, as in the JAX package:
  * synthetic, seed-generated (default): scalable m/n/S;
  * the published SIPLIB instance sslp_5_25_50 (instance="sslp_5_25":
    5 sites, 25 clients, up to 50 scenarios; the benchmark's data
    tables are copied below).  SIPLIB's published optimum for
    sslp_5_25_50 is -121.6.

First stage: open server at site j (binary x_j, cost cs_j), at most
`max_servers` open.  Second stage: present clients (h_i^s in {0,1}) are
assigned to open sites (y_ij in [0,1], relaxed binaries), earning
revenue q_ij; site capacity u limits the assigned load; an overflow
variable o_j (penalty) keeps recourse complete.

    min  sum_j cs_j x_j - sum_ij q_ij y_ij + pen * sum_j o_j
    s.t. sum_j y_ij  = h_i^s                 (assign present clients)
         sum_i d_i y_ij - u x_j - o_j <= 0   (capacity if open)
         sum_j x_j <= max_servers
Nonants: x.  `build_batch` works in numpy up to the final wrap into
tensors, so its arrays equal the JAX package's exactly.
"""

from __future__ import annotations

import numpy as np

from ..convert import batch_from_arrays

INF = float("inf")


def _instance(m, n, seed=365):
    rng = np.random.RandomState(seed)
    d = rng.randint(5, 21, size=n).astype(float)
    q = rng.randint(10, 41, size=(n, m)).astype(float)
    cs = rng.randint(40, 81, size=m).astype(float)
    u = float(np.ceil(1.5 * d.sum() / m))
    return d, q, cs, u


# ---- published SIPLIB sslp_5_25_50 data ----------------------------------
SIPLIB_5_25_FIXED_COST = np.array([40.0, 60.0, 47.0, 68.0, 60.0])
SIPLIB_5_25_CAPACITY = 188.0
SIPLIB_5_25_REVENUE = np.array([   # (25 clients, 5 sites); == Demand
    [0, 22, 18, 14, 22], [15, 11, 20, 8, 14], [4, 22, 10, 0, 25],
    [14, 23, 23, 5, 22], [8, 23, 14, 5, 11], [18, 5, 2, 23, 6],
    [6, 8, 22, 3, 15], [14, 21, 6, 16, 14], [21, 6, 1, 8, 3],
    [16, 14, 13, 12, 22], [8, 20, 15, 15, 12], [11, 4, 9, 15, 11],
    [2, 19, 13, 2, 9], [15, 20, 17, 0, 16], [6, 1, 21, 23, 1],
    [11, 21, 2, 15, 17], [17, 17, 3, 13, 3], [15, 5, 14, 19, 7],
    [10, 8, 0, 8, 14], [22, 24, 23, 14, 15], [14, 13, 8, 2, 23],
    [21, 12, 10, 12, 17], [2, 10, 13, 10, 9], [20, 21, 9, 20, 21],
    [23, 18, 2, 9, 23]], dtype=float)
# per-scenario ClientPresent vectors, packed MSB-first as 25-bit ints
SIPLIB_5_25_PRESENCE = [
    20993912, 9960662, 7363960, 24339278, 9109504, 29602284, 1319906,
    10106138, 4046399, 4624107, 709021, 31316171, 8568690, 24379175,
    25755796, 28888391, 11091660, 31149044, 30174143, 2178029,
    13892334, 5272943, 14864160, 4486218, 14990610, 29994912,
    27939587, 29855491, 22570151, 1630004, 918378, 10689346, 14884763,
    27127282, 10444694, 1718028, 626212, 10917971, 5014440, 32786963,
    27330641, 10525162, 32990958, 23749576, 26983959, 23481858,
    18431288, 910631, 24749425, 8684607]


def siplib_presence(scennum):
    """(25,) 0/1 ClientPresent vector of SIPLIB scenario scennum+1."""
    bits = SIPLIB_5_25_PRESENCE[scennum]
    return np.array([(bits >> (24 - i)) & 1 for i in range(25)],
                    dtype=float)


def client_presence(scennum, num_scens, n_clients, seed=365):
    """(n,) 0/1 presence vector; each client present w.p. 0.5 (the
    SIPLIB convention), scenario-seeded."""
    rng = np.random.RandomState(seed + 1000 + scennum)
    return (rng.rand(n_clients) < 0.5).astype(float)


def build_batch(num_scens, m_sites=5, n_clients=10, max_servers=None,
                overflow_penalty=1000.0, seed=365, dtype=np.float64,
                instance=None, device=None):
    """instance="sslp_5_25": the published SIPLIB sslp_5_25_50 data
    (num_scens <= 50, binary allocations, per-PAIR demand == revenue);
    default: the synthetic seed-generated family.  device: where the
    batch's tensors live (default: the CUDA device)."""
    if instance == "sslp_5_25":
        return _build_siplib_5_25(num_scens, dtype=dtype, device=device)
    m, n, S = m_sites, n_clients, num_scens
    d, q, cs, u = _instance(m, n, seed)
    if max_servers is None:
        max_servers = m

    # layout: [x (m) | y (n*m, client-major) | o (m)]
    ix, iy, io = 0, m, m + n * m
    N = m + n * m + m
    # rows: n assignment equalities + m capacity + 1 cardinality
    M = n + m + 1
    A = np.zeros((S, M, N), dtype=dtype)
    row_lo = np.full((S, M), -INF, dtype=dtype)
    row_hi = np.full((S, M), INF, dtype=dtype)

    h = np.stack([client_presence(s, S, n, seed) for s in range(S)])
    for i in range(n):                       # sum_j y_ij = h_i
        A[:, i, iy + i * m: iy + (i + 1) * m] = 1.0
        row_lo[:, i] = h[:, i]
        row_hi[:, i] = h[:, i]
    for j in range(m):       # sum_i d_i y_ij - u x_j - o_j <= 0
        r = n + j
        for i in range(n):
            A[:, r, iy + i * m + j] = d[i]
        A[:, r, ix + j] = -u
        A[:, r, io + j] = -1.0
        row_hi[:, r] = 0.0
    A[:, n + m, ix:ix + m] = 1.0             # cardinality
    row_hi[:, n + m] = float(max_servers)

    lb = np.zeros((S, N), dtype=dtype)
    ub = np.full((S, N), INF, dtype=dtype)
    ub[:, ix:ix + m] = 1.0
    ub[:, iy:io] = 1.0

    c = np.zeros((S, N), dtype=dtype)
    c[:, ix:ix + m] = cs
    c[:, iy:io] = -q.reshape(-1)
    c[:, io:] = overflow_penalty

    integer_mask = np.zeros((S, N), dtype=bool)
    integer_mask[:, ix:ix + m] = True

    stage_cost_c = np.zeros((2, S, N), dtype=dtype)
    stage_cost_c[0, :, ix:ix + m] = cs
    stage_cost_c[1] = c.copy()
    stage_cost_c[1, :, ix:ix + m] = 0.0

    nonant_idx = np.arange(m, dtype=np.int32)
    var_names = (
        tuple(f"x[{j}]" for j in range(m))
        + tuple(f"y[{i},{j}]" for i in range(n) for j in range(m))
        + tuple(f"o[{j}]" for j in range(m)))
    tree = dict(
        node_of=np.zeros((S, m), np.int32),
        prob=np.full((S,), 1.0 / S, dtype=dtype),
        num_nodes=1,
        stage_of=(1,) * m,
        nonant_names=var_names[:m],
        scen_names=tuple(f"Scenario{i+1}" for i in range(S)),
    )
    return batch_from_arrays(dict(
        c=c, qdiag=np.zeros((S, N), dtype=dtype),
        A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        obj_const=np.zeros((S,), dtype=dtype),
        nonant_idx=nonant_idx, integer_mask=integer_mask,
        tree=tree, stage_cost_c=stage_cost_c, var_names=var_names),
        device=device)


def _build_siplib_5_25(num_scens, dtype=np.float64, device=None):
    """The published SIPLIB sslp_5_25_50 instance (reference
    examples/sslp/model/ReferenceModel.py + data/sslp_5_25_50):

        min  FixedCost @ x - Revenue @ y + 1000 * sum_j o_j
        s.t. sum_j y_ij = present_i^s          (client assignment)
             sum_i Demand_ij y_ij - o_j <= Capacity * x_j
             x_j, y_ij binary; o_j >= 0
    """
    if num_scens > 50:
        raise ValueError("sslp_5_25 has 50 published scenarios")
    m, n, S = 5, 25, num_scens
    q = SIPLIB_5_25_REVENUE                       # (n, m); == demand
    cs = SIPLIB_5_25_FIXED_COST
    u = SIPLIB_5_25_CAPACITY

    ix, iy, io = 0, m, m + n * m
    N = m + n * m + m
    M = n + m
    A = np.zeros((S, M, N), dtype=dtype)
    row_lo = np.full((S, M), -INF, dtype=dtype)
    row_hi = np.full((S, M), INF, dtype=dtype)

    h = np.stack([siplib_presence(s) for s in range(S)])
    for i in range(n):                       # sum_j y_ij = h_i
        A[:, i, iy + i * m: iy + (i + 1) * m] = 1.0
        row_lo[:, i] = h[:, i]
        row_hi[:, i] = h[:, i]
    for j in range(m):       # sum_i d_ij y_ij - u x_j - o_j <= 0
        r = n + j
        for i in range(n):
            A[:, r, iy + i * m + j] = q[i, j]
        A[:, r, ix + j] = -u
        A[:, r, io + j] = -1.0
        row_hi[:, r] = 0.0

    lb = np.zeros((S, N), dtype=dtype)
    ub = np.full((S, N), INF, dtype=dtype)
    ub[:, ix:ix + m] = 1.0
    ub[:, iy:io] = 1.0
    # implied finite box for the overflow: o_j <= total demand of
    # present clients at j (provably inactive beyond it)
    ub[:, io:] = float(q.sum())

    c = np.zeros((S, N), dtype=dtype)
    c[:, ix:ix + m] = cs
    c[:, iy:io] = -q.reshape(-1)
    c[:, io:] = 1000.0

    integer_mask = np.zeros((S, N), dtype=bool)
    integer_mask[:, ix:ix + m] = True
    integer_mask[:, iy:io] = True            # Allocation is binary

    stage_cost_c = np.zeros((2, S, N), dtype=dtype)
    stage_cost_c[0, :, ix:ix + m] = cs
    stage_cost_c[1] = c.copy()
    stage_cost_c[1, :, ix:ix + m] = 0.0

    nonant_idx = np.arange(m, dtype=np.int32)
    var_names = (
        tuple(f"FacilityOpen[{j+1}]" for j in range(m))
        + tuple(f"Allocation[{i+1},{j+1}]"
                for i in range(n) for j in range(m))
        + tuple(f"Dummy[{j+1}]" for j in range(m)))
    tree = dict(
        node_of=np.zeros((S, m), np.int32),
        prob=np.full((S,), 1.0 / S, dtype=dtype),
        num_nodes=1,
        stage_of=(1,) * m,
        nonant_names=var_names[:m],
        scen_names=tuple(f"Scenario{i+1}" for i in range(S)),
    )
    return batch_from_arrays(dict(
        c=c, qdiag=np.zeros((S, N), dtype=dtype),
        A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        obj_const=np.zeros((S,), dtype=dtype),
        nonant_idx=nonant_idx, integer_mask=integer_mask,
        tree=tree, stage_cost_c=stage_cost_c, var_names=var_names),
        device=device)


def scenario_names_creator(num_scens, start=0):
    return [f"Scenario{i+1}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.num_scens_required()
    cfg.add_to_config("m_sites", description="candidate server sites",
                      domain=int, default=5)
    cfg.add_to_config("n_clients", description="clients", domain=int,
                      default=10)
    cfg.add_to_config("sslp_instance",
                      description="named instance (sslp_5_25) or "
                      "empty for synthetic", domain=str, default="")


def kw_creator(options):
    kw = {"m_sites": options.get("m_sites", 5),
          "n_clients": options.get("n_clients", 10)}
    inst = options.get("sslp_instance") or options.get("instance")
    if inst:
        kw["instance"] = inst
    return kw
