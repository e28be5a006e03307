"""Farmer — the canonical scalable 2-stage model (port of
`mpisppy_tpu/models/farmer.py`).

Same model and stochastic data as the JAX builder: `500 *
crops_multiplier` acres among `3 * crops_multiplier` crops (first
stage), then buy/sell after the random yield realizes.  The builder is
numpy up to the final wrap into tensors, so its arrays equal the JAX
builder's exactly.

Variable layout per scenario (N = 4 * ncrops): acreage (nonant),
sub-quota sales, super-quota sales, purchases.  Rows (M = 2*ncrops+1):
cattle feed (>=), limit sold (<=), total acreage (<=).

A is stored dense (S, M, N), or split-native (`ir.SplitA`: one shared
(M, N) matrix plus the 2*nc per-scenario yield coefficients) with
`split=True`, which "auto" picks when the dense tensor would exceed
1 GB: the true-size instance (S=1000, crops_multiplier=1000) is ~288 GB
dense in f32 and exists only split-native.

The driver functions of `examples/farmer_cylinders.py`
(`scenario_names_creator`, `inparser_adder`, `kw_creator`,
`batch_creator`, `scenario_denouement`) are the JAX package's.

`scenario_creator` builds one scenario through `model.LinearModel`
(the modelling path of `SPBase(scenario_creator=...)`).

Not ported yet (ROADMAP queue A): `scenario_source` and
`export_corpus` (item 12).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ir import ScenarioBatch, SplitA, TreeInfo
from ..model import LinearModel

INF = float("inf")

_BASE_YIELD = {
    "below": np.array([2.0, 2.4, 16.0]),
    "average": np.array([2.5, 3.0, 20.0]),
    "above": np.array([3.0, 3.6, 24.0]),
}
_YIELD_BY_MOD3 = [_BASE_YIELD["below"], _BASE_YIELD["average"],
                  _BASE_YIELD["above"]]

_PLANTING_COST = np.array([150.0, 230.0, 260.0])
_SUB_PRICE = np.array([170.0, 150.0, 36.0])
_SUPER_PRICE = np.array([0.0, 0.0, 10.0])
_CATTLE_REQ = np.array([200.0, 240.0, 0.0])
_PURCHASE_PRICE = np.array([238.0, 210.0, 100000.0])
_QUOTA = np.array([100000.0, 100000.0, 6000.0])
_CROP_NAMES = ["WHEAT", "CORN", "SUGAR_BEETS"]

def scenario_yields(scennum, crops_multiplier=1, seedoffset=0):
    """Per-crop yields for scenario `scennum`: base by scennum%3, plus
    one rand() per crop from RandomState(scennum + seedoffset) when
    scennum // 3 != 0 (the reference's farmerstream protocol)."""
    base = np.tile(_YIELD_BY_MOD3[scennum % 3], crops_multiplier)
    if scennum // 3 != 0:
        rng = np.random.RandomState(scennum + seedoffset)
        base = base + rng.rand(3 * crops_multiplier)
    return base


def _tensor(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def scenario_block(indices, crops_multiplier=1, use_integer=False,
                   seedoffset=0, sense=1, dtype=np.float64,
                   split="auto", device=None) -> ScenarioBatch:
    """Vectorized batch builder over an arbitrary index set: scenario
    i's data depends only on its global index.  Probabilities are
    block-uniform.  `device` defaults to the CUDA device."""
    dev = resolve_device(device)
    idx = np.asarray(indices, dtype=np.int64)
    nc = 3 * crops_multiplier
    N = 4 * nc
    M = 2 * nc + 1
    S = idx.size
    if split == "auto":
        split = S * M * N * np.dtype(dtype).itemsize > 1 << 30

    yields = np.stack([
        scenario_yields(int(i), crops_multiplier, seedoffset) for i in idx
    ]).astype(dtype)                                      # (S, nc)

    iac = np.arange(nc)
    isub = nc + iac
    isup = 2 * nc + iac
    ipur = 3 * nc + iac

    row_lo = np.full((S, M), -INF, dtype=dtype)
    row_hi = np.full((S, M), INF, dtype=dtype)
    r = np.arange(nc)
    r2 = nc + r
    row_lo[:, r] = np.tile(_CATTLE_REQ, crops_multiplier)
    row_hi[:, r2] = 0.0
    row_hi[:, -1] = 500.0 * crops_multiplier
    delta_rows = np.concatenate([r, r2]).astype(np.int32)
    delta_cols = np.concatenate([iac, iac]).astype(np.int32)
    if split:
        shared = np.zeros((M, N), dtype=dtype)
        shared[r, ipur] = 1.0
        shared[r, isub] = -1.0
        shared[r, isup] = -1.0
        shared[r2, isub] = 1.0
        shared[r2, isup] = 1.0
        shared[-1, iac] = 1.0
        # the yield slots stay zero in shared; the per-scenario values
        # live in vals at (delta_rows, delta_cols)
        A = SplitA(shared=_tensor(shared, dev),
                   rows=_tensor(delta_rows, dev),
                   cols=_tensor(delta_cols, dev),
                   vals=_tensor(np.concatenate([yields, -yields], axis=1),
                                dev))
    else:
        A = np.zeros((S, M, N), dtype=dtype)
        A[:, r, iac] = yields
        A[:, r, ipur] = 1.0
        A[:, r, isub] = -1.0
        A[:, r, isup] = -1.0
        A[:, r2, isub] = 1.0
        A[:, r2, isup] = 1.0
        A[:, r2, iac] = -yields
        A[:, -1, iac] = 1.0
        A = _tensor(A, dev)

    lb = np.zeros((S, N), dtype=dtype)
    ub = np.full((S, N), INF, dtype=dtype)
    total_acreage = 500.0 * crops_multiplier
    ub[:, iac] = total_acreage
    # implied finite boxes, provably inactive at an optimum (see the
    # JAX builder): they make every variable box finite, so the PDHG
    # dual objective is a valid Lagrangian bound at any dual iterate
    sale_cap = 2.0 * yields * total_acreage                # (S, nc)
    ub[:, isub] = np.minimum(np.tile(_QUOTA, crops_multiplier), sale_cap)
    ub[:, isup] = sale_cap
    ub[:, ipur] = 2.0 * np.tile(_CATTLE_REQ + 1.0, crops_multiplier)

    c = np.zeros((S, N), dtype=dtype)
    c[:, iac] = np.tile(_PLANTING_COST, crops_multiplier)
    c[:, isub] = -np.tile(_SUB_PRICE, crops_multiplier)
    c[:, isup] = -np.tile(_SUPER_PRICE, crops_multiplier)
    c[:, ipur] = np.tile(_PURCHASE_PRICE, crops_multiplier)
    stage_cost_c = np.zeros((2, S, N), dtype=dtype)
    stage_cost_c[0][:, iac] = np.tile(_PLANTING_COST, crops_multiplier)
    stage_cost_c[1] = c.copy()
    stage_cost_c[1][:, iac] = 0.0
    if sense < 0:
        c = -c
        stage_cost_c = -stage_cost_c

    integer_mask = np.zeros((S, N), dtype=bool)
    if use_integer:
        integer_mask[:, iac] = True

    crop_names = [f"{nm}{g}" for g in range(crops_multiplier)
                  for nm in _CROP_NAMES]
    var_names = (
        tuple(f"DevotedAcreage[{n}]" for n in crop_names)
        + tuple(f"QuantitySubQuotaSold[{n}]" for n in crop_names)
        + tuple(f"QuantitySuperQuotaSold[{n}]" for n in crop_names)
        + tuple(f"QuantityPurchased[{n}]" for n in crop_names))

    tree = TreeInfo(
        node_of=_tensor(np.zeros((S, nc), np.int64), dev),
        prob=_tensor(np.full((S,), 1.0 / S, dtype=dtype), dev),
        num_nodes=1,
        stage_of=(1,) * nc,
        nonant_names=var_names[:nc],
        scen_names=tuple(f"scen{int(i)}" for i in idx),
    )
    return ScenarioBatch(
        c=_tensor(c, dev), qdiag=_tensor(np.zeros((S, N), dtype), dev),
        A=A, row_lo=_tensor(row_lo, dev),
        row_hi=_tensor(row_hi, dev), lb=_tensor(lb, dev),
        ub=_tensor(ub, dev),
        obj_const=_tensor(np.zeros((S,), dtype), dev),
        nonant_idx=_tensor(iac.astype(np.int64), dev),
        integer_mask=_tensor(integer_mask, dev),
        tree=tree,
        stage_cost_c=_tensor(stage_cost_c, dev),
        var_names=var_names,
        model_meta={"A_delta_idx": (delta_rows, delta_cols)},
    )


def build_batch(num_scens, crops_multiplier=1, use_integer=False,
                seedoffset=0, sense=1, dtype=np.float64,
                split="auto", device=None) -> ScenarioBatch:
    """The full scenario universe [0, num_scens) on `device` (default:
    the CUDA device)."""
    return scenario_block(np.arange(num_scens),
                          crops_multiplier=crops_multiplier,
                          use_integer=use_integer, seedoffset=seedoffset,
                          sense=sense, dtype=dtype, split=split,
                          device=device)


def scenario_creator(scenario_name, use_integer=False, sense=1,
                     crops_multiplier=1, num_scens=None, seedoffset=0,
                     device=None):
    """One scenario through the declarative LinearModel API (the JAX
    package's farmer.py:256, after the reference's farmer.py:25-91), on
    `device` (default: the CUDA device).  `build_batch` is the fast
    path; stacked, these scenarios equal its dense (split=False)
    arrays."""
    scennum = int("".join(ch for ch in scenario_name if ch.isdigit()) or 0)
    nc = 3 * crops_multiplier
    y = scenario_yields(scennum, crops_multiplier, seedoffset)
    m = LinearModel(sense=sense)
    total = 500.0 * crops_multiplier
    ac = m.add_vars("DevotedAcreage", nc, lb=0.0, ub=total,
                    integer=use_integer)
    # the implied finite bounds of scenario_block
    sub = m.add_vars("QuantitySubQuotaSold", nc, lb=0.0,
                     ub=np.minimum(np.tile(_QUOTA, crops_multiplier),
                                   2.0 * y * total))
    sup = m.add_vars("QuantitySuperQuotaSold", nc, lb=0.0,
                     ub=2.0 * y * total)
    pur = m.add_vars("QuantityPurchased", nc, lb=0.0,
                     ub=2.0 * np.tile(_CATTLE_REQ + 1.0, crops_multiplier))
    req = np.tile(_CATTLE_REQ, crops_multiplier)
    for i in range(nc):
        m.add_constr({ac[i]: y[i], pur[i]: 1.0, sub[i]: -1.0,
                      sup[i]: -1.0}, lo=req[i])
    for i in range(nc):
        m.add_constr({sub[i]: 1.0, sup[i]: 1.0, ac[i]: -y[i]}, hi=0.0)
    m.add_constr({ac[i]: 1.0 for i in range(nc)}, hi=total)
    m.add_cost(1, {ac[i]: np.tile(_PLANTING_COST, crops_multiplier)[i]
                   for i in range(nc)})
    m.add_cost(2, {
        **{pur[i]: np.tile(_PURCHASE_PRICE, crops_multiplier)[i]
           for i in range(nc)},
        **{sub[i]: -np.tile(_SUB_PRICE, crops_multiplier)[i]
           for i in range(nc)},
        **{sup[i]: -np.tile(_SUPER_PRICE, crops_multiplier)[i]
           for i in range(nc)},
    })
    m.set_nonants([ac], stage=1)
    prob = 1.0 / num_scens if num_scens else 1.0
    return m.lower(prob=prob, name=scenario_name, device=device)


# ---- driver helpers (the reference's farmer.py:237-268) -----------------

def scenario_names_creator(num_scens, start=None):
    start = start or 0
    return [f"scen{i}" for i in range(start, start + num_scens)]


def kw_creator(options):
    return {
        # the flag is farmer_with_integers (inparser_adder); callers
        # may pass use_integer directly
        "use_integer": options.get(
            "use_integer", options.get("farmer_with_integers", False)),
        "crops_multiplier": options.get("crops_multiplier", 1),
        "num_scens": options.get("num_scens", None),
    }


def inparser_adder(cfg):
    cfg.num_scens_required()
    cfg.add_to_config("crops_multiplier",
                      description="number of crops is 3x this", domain=int,
                      default=1)
    cfg.add_to_config("farmer_with_integers",
                      description="integer acreage variant", domain=bool,
                      default=False)


def batch_creator(cfg_or_kwargs, num_scens=None):
    """The full ScenarioBatch from keyword options (`build_batch`'s,
    `device` included)."""
    kw = dict(cfg_or_kwargs)
    n = num_scens or kw.pop("num_scens", None)
    kw.pop("num_scens", None)
    return build_batch(n, **kw)


def scenario_denouement(rank, scenario_name, result):
    pass
