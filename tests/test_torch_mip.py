"""Port parity: the MIP extensive form (`mpisppy_tpu_torch/opt/mip.py`,
the three-phase LP dive) against the JAX package, float64, on the CPU.

* sizes-3 cut to 2 sizes (3 scenarios, 42 integer columns: the gating
  setup binaries of phase Z, their 1-opt / 2-opt refinement, a feasible
  and an infeasible branch and the phase-B per-scenario dives all run,
  the same kinds of decision as at 3 sizes), with the options that
  `examples/sizes_ef_mip.py`'s command line builds: the same incumbent and
  bound (1e-6 relative), the same LP-solve and round counts, the same
  integral solution, and the same sequence of decisions (each line the
  verbose dive prints, objective values aside).  The port solves on the
  JAX package's PreparedBatch, and its stacked probes' power
  iterations start from the JAX PRNGKey draw.  Both packages cap the
  refinement probes at 8,000 iterations (`mip_refine_max_iters`; the
  default is the dive's 60,000), which keeps the port's CPU run short
  and leaves this instance's result unchanged.

usar's integer EF (usar-2 takes ~90 s on this CPU path) runs on the card
in `chip_smoke.py`'s `algorithms` phase.
"""

import re

import numpy as np
import pytest

from mpisppy_tpu.models import sizes as jsizes
from mpisppy_tpu.opt.mip import ExtensiveFormMIP as JMIP
from mpisppy_tpu_torch.convert import prep_from_arrays, to_arrays
from mpisppy_tpu_torch.models import sizes
from mpisppy_tpu_torch.opt.mip import ExtensiveFormMIP
from mpisppy_tpu_torch.utils import config
from torch_parity import ONE, jax_draw, one_torch_thread, rel  # noqa

pytestmark = pytest.mark.usefixtures("jax_draw", "one_torch_thread")

REFINE_CAP = 8000
NUM_SIZES = 2


def _decisions(text):
    """The dive's decisions from its verbose trace: every line of a
    fix, a release or a refinement move, with the objective estimates
    cut off."""
    out = []
    for ln in text.splitlines():
        m = re.search(r"(MIP dive .*|  branch \(.*)", ln)
        if m:
            out.append(re.sub(r"obj[~=]\S+|pres=\S+", "", m.group(1)))
    return out


def _command_line_options():
    """The options examples/sizes_ef_mip.py's main() builds from its
    command line (3 sizes), with the refinement cap."""
    cfg = config.Config()
    cfg.popular_args()
    sizes.inparser_adder(cfg)
    cfg.parse_command_line("sizes_ef_mip", args=[
        "--num-scens", "3", "--solver-eps", "1e-6", "--num-sizes",
        str(NUM_SIZES)])
    assert cfg.num_scens == 3 and cfg.get("num_sizes") == NUM_SIZES
    return {"pdhg_eps": cfg.get("solver_eps", 1e-6),
            "pdhg_max_iters": cfg.get("solver_max_iters", 200000),
            "mip_refine_max_iters": REFINE_CAP}


@pytest.fixture(scope="module")
def runs(jax_draw, one_torch_thread):
    import contextlib
    import io
    opts = _command_line_options()
    jb = jsizes.build_batch(3, num_sizes=NUM_SIZES)
    j = JMIP(dict(opts), list(jb.tree.scen_names), batch=jb, mesh=ONE)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jout = j.solve_mip(verbose=True)
    jtext = buf.getvalue()
    t = ExtensiveFormMIP(
        dict(opts), sizes.scenario_names_creator(3),
        batch=sizes.build_batch(3, num_sizes=NUM_SIZES, device="cpu"),
        device="cpu", prep=prep_from_arrays(to_arrays(j.prep),
                                            device="cpu"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tout = t.solve_mip(verbose=True)
    return t, j, tout, jout, buf.getvalue(), jtext


def test_dive_matches_jax(runs):
    t, j, tout, jout, ttext, jtext = runs
    assert rel(tout["incumbent"], jout["incumbent"]) <= 1e-6
    assert rel(tout["bound"], jout["bound"]) <= 1e-6
    for k in ("lp_solves", "rounds"):
        assert tout[k] == jout[k], k
    np.testing.assert_array_equal(np.round(tout["x"][host_mask(t)]),
                                  np.round(jout["x"][host_mask(t)]))
    assert rel(tout["x"], jout["x"]) <= 1e-5


def host_mask(t):
    return t.batch.integer_mask.cpu().numpy()


def test_fix_sequence_matches_jax(runs):
    t, j, tout, jout, ttext, jtext = runs
    td, jd = _decisions(ttext), _decisions(jtext)
    assert len(jd) >= 3            # the dive made decisions to compare
    assert td == jd


def test_incumbent_is_integral_and_bounded(runs):
    t, j, tout, jout, ttext, jtext = runs
    xi = tout["x"][host_mask(t)]
    assert np.allclose(xi, np.round(xi))
    assert tout["bound"] <= tout["incumbent"]
    assert tout["viol"] < 1e-3
    # the probe stacks are released after the dive
    assert not [k for k in t._np_cache
                if isinstance(k, tuple) and k[0] == "mip_stack"]
