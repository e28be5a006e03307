"""APL1P — classic 2-stage power-expansion planning fixture (structure
parity with the reference's apl1p test model,
mpisppy/tests/examples/apl1p.py; Infanger's APL1P).

Port of `mpisppy_tpu/models/apl1p.py`: the builder works in numpy, with
the same random draws, up to the final wrap into tensors on `device`
(default: the CUDA device), so its arrays equal the JAX builder's
exactly.

First stage: install capacity w_g >= 0 of G generator types
(investment cost inv_g per MW), with a minimum total capacity.
Second stage: generator availability alpha_g^s and demands D_d^s
realize; dispatch x_gd serves demand level d from generator g at
operating cost op_gd; unserved demand penalized.

    min  sum_g inv_g w_g + E[ sum_gd op_gd x_gd + pen * sum_d un_d ]
    s.t. sum_g w_g >= Wmin
         sum_d x_gd <= alpha_g^s * w_g          (availability)
         sum_g x_gd + un_d >= D_d^s             (demand levels)
Nonants: w (continuous).

Scenarios enumerate an independent discrete grid: each generator's
availability in {0.9, 1.0} and a demand scale in {0.8, 1.0, 1.2}
(scenario index decodes mixed-radix), probabilities uniform.
"""

from __future__ import annotations

import numpy as np

from ..convert import batch_from_arrays

INF = float("inf")

_G = 2          # generator types
_D = 3          # demand levels
_INV = np.array([4.0, 2.5])
_OP = np.array([[4.3, 2.0, 0.5],
                [8.7, 4.0, 1.0]])
_DEMAND = np.array([900.0, 1000.0, 750.0])
_WMIN = 1000.0
_PEN = 10.0
_AVAIL_CHOICES = np.array([0.9, 1.0])
_SCALE_CHOICES = np.array([0.8, 1.0, 1.2])


def max_num_scens():
    return len(_AVAIL_CHOICES) ** _G * len(_SCALE_CHOICES)


def scenario_outcome(scennum):
    """Decode mixed-radix scenario index -> (alpha (G,), demand (D,))."""
    na = len(_AVAIL_CHOICES)
    digits = []
    k = scennum
    for _ in range(_G):
        digits.append(k % na)
        k //= na
    scale = _SCALE_CHOICES[k % len(_SCALE_CHOICES)]
    alpha = _AVAIL_CHOICES[np.array(digits)]
    return alpha, _DEMAND * scale


def build_batch(num_scens=None, dtype=np.float64, device=None):
    S = max_num_scens() if num_scens is None else num_scens
    if S > max_num_scens():
        raise ValueError(f"apl1p has at most {max_num_scens()} scenarios")
    G, D = _G, _D
    # layout: [w (G) | x (G*D) | un (D)]
    iw, ix, iu = 0, G, G + G * D
    N = G + G * D + D
    M = 1 + G + D
    A = np.zeros((S, M, N), dtype=dtype)
    row_lo = np.full((S, M), -INF, dtype=dtype)
    row_hi = np.full((S, M), INF, dtype=dtype)

    alphas = np.zeros((S, G))
    dems = np.zeros((S, D))
    for s in range(S):
        alphas[s], dems[s] = scenario_outcome(s)

    A[:, 0, iw:iw + G] = 1.0                 # min total capacity
    row_lo[:, 0] = _WMIN
    for g in range(G):                       # availability
        r = 1 + g
        A[:, r, ix + g * D: ix + (g + 1) * D] = 1.0
        A[:, r, iw + g] = -alphas[:, g]
        row_hi[:, r] = 0.0
    for d in range(D):                       # demand levels
        r = 1 + G + d
        for g in range(G):
            A[:, r, ix + g * D + d] = 1.0
        A[:, r, iu + d] = 1.0
        row_lo[:, r] = dems[:, d]

    lb = np.zeros((S, N), dtype=dtype)
    ub = np.full((S, N), INF, dtype=dtype)

    c = np.zeros((S, N), dtype=dtype)
    c[:, iw:iw + G] = _INV
    c[:, ix:iu] = _OP.reshape(-1)
    c[:, iu:] = _PEN

    stage_cost_c = np.zeros((2, S, N), dtype=dtype)
    stage_cost_c[0, :, iw:iw + G] = _INV
    stage_cost_c[1] = c.copy()
    stage_cost_c[1, :, iw:iw + G] = 0.0

    nonant_idx = np.arange(G, dtype=np.int32)
    var_names = (
        tuple(f"CapExp[{g}]" for g in range(G))
        + tuple(f"Gen[{g},{d}]" for g in range(G) for d in range(D))
        + tuple(f"Unserved[{d}]" for d in range(D)))
    tree = dict(
        node_of=np.zeros((S, G), np.int32),
        prob=np.full((S,), 1.0 / S, dtype=dtype),
        num_nodes=1,
        stage_of=(1,) * G,
        nonant_names=var_names[:G],
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


def kw_creator(options):
    return {}
