"""Port parity: acopf3's Jabr SOC relaxation
(`mpisppy_tpu_torch/models/acopf3.py`: `build_soc_batch`,
`soc_violation`, `add_soc_cuts`, `soc_refine`) against the JAX package
on the CPU, float64.

* The builders are exactly equal (every array and the soc_* index
  tables) on the synthetic (2,2) grid, the JAX tests' (3,) n_bus=4
  grid and IEEE 14-bus (1,).
* `soc_violation` and `add_soc_cuts` are exactly equal on the same
  point: the violations, the cut count, and A, row_lo and row_hi after
  the round.
* `soc_refine`'s history over 2 rounds on the (3,) grid: the
  objectives within 1e-6 relative, the maximum violations within 1e-6
  relative, the same cut counts.  The JAX side runs its EF on one
  device (`torch_parity.ONE`, with the round-to-round warm start of
  `soc_refine`) and the port's power iterations start from the JAX
  PRNGKey draw; every round builds a new prep.
"""

import numpy as np
import pytest

from mpisppy_tpu.models import acopf3 as jacopf3
from mpisppy_tpu.opt.ef import ExtensiveForm as JExtensiveForm
from mpisppy_tpu_torch.models import acopf3
from torch_parity import ONE, jax_draw, one_torch_thread, rel  # noqa

pytestmark = pytest.mark.usefixtures("jax_draw", "one_torch_thread")

SHAPES = {
    "synthetic_2x2": dict(branching_factors=(2, 2)),
    "n_bus4_3": dict(branching_factors=(3,), n_bus=4, n_line=5, n_gen=2),
    "ieee14_1": dict(branching_factors=(1,), case="ieee14",
                     soc_cut_slots=8),
}
FIELDS = ("c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub", "obj_const",
          "nonant_idx", "integer_mask", "stage_cost_c")
OPTS = {"pdhg_eps": 1e-5, "pdhg_max_iters": 4000}


def _point(jb):
    """A point with every cone violated somewhere (seeded)."""
    ub = np.asarray(jb.ub)
    return ub * 0.5 + 0.1 * np.random.RandomState(0).rand(*ub.shape)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_soc_builder_equals_jax(shape):
    jb = jacopf3.build_soc_batch(**SHAPES[shape])
    tb = acopf3.build_soc_batch(**SHAPES[shape], device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), f)
    assert set(tb.model_meta) == set(jb.model_meta)
    for k, v in jb.model_meta.items():
        np.testing.assert_array_equal(tb.model_meta[k], np.asarray(v), k)
    assert tb.var_names == jb.var_names
    assert tb.tree.nonant_names == jb.tree.nonant_names
    assert tb.tree.num_nodes == jb.tree.num_nodes


@pytest.mark.parametrize("shape", list(SHAPES))
def test_soc_violation_and_cuts_equal_jax(shape):
    jb = jacopf3.build_soc_batch(**SHAPES[shape])
    tb = acopf3.build_soc_batch(**SHAPES[shape], device="cpu")
    x = _point(jb)
    np.testing.assert_array_equal(acopf3.soc_violation(tb, x),
                                  jacopf3.soc_violation(jb, x))
    # round 7 wraps the 6-slot buffer of the synthetic grids
    jb2, jmv, jn = jacopf3.add_soc_cuts(jb, x, 7)
    tb2, tmv, tn = acopf3.add_soc_cuts(tb, x, 7)
    assert (tmv, tn) == (jmv, jn) and tn > 0
    for f in ("A", "row_lo", "row_hi"):
        np.testing.assert_array_equal(getattr(tb2, f).numpy(),
                                      np.asarray(getattr(jb2, f)), f)


def _jax_solve():
    """The JAX package's default refine solve on one device: the
    consensus EF, warm-started from the previous round."""
    warm = {"x": None, "y": None}

    def solve(b):
        ef = JExtensiveForm(dict(OPTS), list(b.tree.scen_names), batch=b,
                            mesh=ONE)
        ef.solve_extensive_form(certify=False, x0=warm["x"], y0=warm["y"])
        warm["x"], warm["y"] = ef._result.x, ef._result.y
        return (np.asarray(ef._result.x)[:b.num_scens],
                float(ef.get_objective_value()))
    return solve


def test_soc_refine_history_equals_jax():
    kw = SHAPES["n_bus4_3"]
    _, jh = jacopf3.soc_refine(jacopf3.build_soc_batch(**kw), rounds=2,
                               opts=dict(OPTS), solve=_jax_solve())
    tb2, th = acopf3.soc_refine(acopf3.build_soc_batch(**kw, device="cpu"),
                                rounds=2, opts=dict(OPTS))
    assert len(th) == len(jh) == 2
    for t, j in zip(th, jh):
        assert t[0] == j[0] and t[3] == j[3] and t[3] > 0
        assert rel(t[1], j[1]) <= 1e-6 and rel(t[2], j[2]) <= 1e-6
    # the cuts only shrink the feasible set
    assert th[1][1] >= th[0][1] - 1e-3 * abs(th[0][1])
    assert tb2.A.shape == acopf3.build_soc_batch(**kw, device="cpu").A.shape
