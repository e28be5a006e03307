"""BATTERY — 2-stage battery sizing + operation under price/solar
uncertainty (structure parity with the reference's battery example,
examples/battery/battery.py).

Port of `mpisppy_tpu/models/battery.py`: the builder works in numpy, with
the same random draws, up to the final wrap into tensors on `device`
(default: the CUDA device), so its arrays equal the JAX builder's
exactly.

First stage: battery energy capacity B (continuous, cost cB per kWh).
Second stage, per scenario over H hours: charge ch_h, discharge dis_h,
grid purchase g_h >= 0, state of charge soc_h in [0, B]:

    soc_h = soc_{h-1} + eta*ch_h - dis_h        (soc_0 = 0)
    g_h + solar^s_h + dis_h - ch_h >= load_h    (power balance)
    ch_h <= rmax, dis_h <= rmax                 (rate limits)
    min cB*B + E[ sum_h price^s_h * g_h ]
Nonants: B.
"""

from __future__ import annotations

import numpy as np

from ..convert import batch_from_arrays

INF = float("inf")

_ETA = 0.92
_RMAX = 20.0
_CB = 8.0


def _profiles(scennum, H, seed=77):
    rng = np.random.RandomState(seed + scennum)
    hours = np.arange(H)
    solar = np.maximum(
        0.0, 30.0 * np.sin(np.pi * (hours + 0.5) / H)) * (
        0.6 + 0.8 * rng.rand())
    price = 5.0 + 10.0 * rng.rand(H) + 10.0 * (hours >= H * 2 // 3)
    load = 25.0 + 10.0 * np.cos(np.pi * hours / H) * rng.rand()
    return solar, price, load


def build_batch(num_scens, H=12, seed=77, dtype=np.float64, device=None):
    S = num_scens
    # layout: [B | ch (H) | dis (H) | g (H) | soc (H)]
    iB, ich, idis, ig, isoc = 0, 1, 1 + H, 1 + 2 * H, 1 + 3 * H
    N = 1 + 4 * H
    M = 3 * H            # soc dynamics (H), balance (H), soc<=B (H)
    A = np.zeros((S, M, N), dtype=dtype)
    row_lo = np.full((S, M), -INF, dtype=dtype)
    row_hi = np.full((S, M), INF, dtype=dtype)

    solar = np.zeros((S, H))
    price = np.zeros((S, H))
    load = np.zeros((S, H))
    for s in range(S):
        solar[s], price[s], load[s] = _profiles(s, H, seed)

    for h in range(H):
        # soc_h - soc_{h-1} - eta*ch_h + dis_h = 0
        A[:, h, isoc + h] = 1.0
        if h > 0:
            A[:, h, isoc + h - 1] = -1.0
        A[:, h, ich + h] = -_ETA
        A[:, h, idis + h] = 1.0
        row_lo[:, h] = 0.0
        row_hi[:, h] = 0.0
        # g + dis - ch >= load - solar
        r = H + h
        A[:, r, ig + h] = 1.0
        A[:, r, idis + h] = 1.0
        A[:, r, ich + h] = -1.0
        row_lo[:, r] = load[:, h] - solar[:, h]
        # soc_h - B <= 0
        r2 = 2 * H + h
        A[:, r2, isoc + h] = 1.0
        A[:, r2, iB] = -1.0
        row_hi[:, r2] = 0.0

    lb = np.zeros((S, N), dtype=dtype)
    ub = np.full((S, N), INF, dtype=dtype)
    ub[:, ich:ich + H] = _RMAX
    ub[:, idis:idis + H] = _RMAX

    c = np.zeros((S, N), dtype=dtype)
    c[:, iB] = _CB
    c[:, ig:ig + H] = price

    stage_cost_c = np.zeros((2, S, N), dtype=dtype)
    stage_cost_c[0, :, iB] = _CB
    stage_cost_c[1, :, ig:ig + H] = price

    nonant_idx = np.array([iB], np.int32)
    var_names = (("B",)
                 + tuple(f"ch[{h}]" for h in range(H))
                 + tuple(f"dis[{h}]" for h in range(H))
                 + tuple(f"g[{h}]" for h in range(H))
                 + tuple(f"soc[{h}]" for h in range(H)))
    tree = dict(
        node_of=np.zeros((S, 1), np.int32),
        prob=np.full((S,), 1.0 / S, dtype=dtype),
        num_nodes=1,
        stage_of=(1,),
        nonant_names=("B",),
        scen_names=tuple(f"Scenario{i+1}" for i in range(S)),
    )
    return batch_from_arrays(dict(
        c=c, qdiag=np.zeros((S, N), dtype=dtype),
        A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        obj_const=np.zeros((S,), dtype=dtype),
        nonant_idx=nonant_idx,
        integer_mask=np.zeros((S, N), dtype=bool),
        tree=tree, stage_cost_c=stage_cost_c, var_names=var_names), device=device)


def scenario_names_creator(num_scens, start=0):
    return [f"Scenario{i+1}" for i in range(start, start + num_scens)]


def inparser_adder(cfg):
    cfg.num_scens_required()
    cfg.add_to_config("battery_hours", description="operation horizon",
                      domain=int, default=12)


def kw_creator(options):
    return {"H": options.get("battery_hours", 12)}
