"""Port parity: the hub-and-spoke wheel (`spin_the_wheel`, `cylinders/`,
`resilience/bounds`, `utils/config`, `utils/vanilla`,
`utils/xhat_eval`) against the JAX package, on the CPU.

* Windows, window pairs, the scenario cycler, payload checksums and the
  payload and bound guards: the same write_id sequences, kill and shape
  guard, bit-equal CRC32s, epoch orders and accept/reject decisions.
* Interleaved wheels on farmer-3 (tests/test_cylinders.py's OPTS),
  float64: the hub's bound trace at every sync (BestOuterBound,
  BestInnerBound and which spoke set each), the termination iteration
  and the incumbent agree with the JAX wheel to 1e-6 relative, for
  Lagrangian + XhatShuffle, Lagrangian + XhatXbar (and the solution
  writers' CSV rows), Lagranger + SlamMax, and XhatLooper +
  XhatSpecific.  The port's hub gets the JAX hub's PreparedBatch
  (`convert.py`), which the spokes share, and the xhat reduced system's
  power iteration starts from the JAX PRNGKey draw (`ops.pdhg.
  normal_draw` is replaced in this module), so both sides take the same
  step sizes.
* Threads mode (order not deterministic): the bounds bracket the
  farmer-3 optimum −108390 and outer ≤ inner; the launch and chunk
  counters stay exact with concurrent spoke threads.
* Failure tolerance: a spoke whose step raises is pruned, in both
  modes; a hung spoke is escalated at the join timeout.
* Config and vanilla: examples/farmer_cylinders.py's command line
  parses to the same options in both packages, the factories build the
  same dicts, and the port's dicts spin.
* Every unported flag, backend, mode and option raises
  NotImplementedError naming its ROADMAP item; the telemetry, solver
  option, APH, L-shaped and FWPH cases ported since check that those
  parts work.
"""

import os
import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpisppy_tpu.cylinders import hub as jhub
from mpisppy_tpu.cylinders import spcommunicator as jspc
from mpisppy_tpu.cylinders.lagranger_bounder import (
    LagrangerOuterBound as JLagranger)
from mpisppy_tpu.cylinders.lagrangian_bounder import (
    LagrangianOuterBound as JLagrangian)
from mpisppy_tpu.cylinders.slam_heuristic import SlamMaxHeuristic as JSlamMax
from mpisppy_tpu.cylinders.xhatlooper_bounder import (
    XhatLooperInnerBound as JLooper)
from mpisppy_tpu.cylinders.xhatshufflelooper_bounder import (
    ScenarioCycler as JCycler)
from mpisppy_tpu.cylinders.xhatshufflelooper_bounder import (
    XhatShuffleInnerBound as JShuffle)
from mpisppy_tpu.cylinders.xhatspecific_bounder import (
    XhatSpecificInnerBound as JSpecific)
from mpisppy_tpu.cylinders.xhatxbar_bounder import XhatXbarInnerBound as JXbar
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu.resilience import bounds as jbounds
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu.utils import config as jconfig
from mpisppy_tpu.utils import vanilla as jvanilla
from mpisppy_tpu.utils.xhat_eval import Xhat_Eval as JXhat_Eval
from mpisppy_tpu.utils.xhat_eval import (
    calculate_incumbent as jcalculate_incumbent)
from mpisppy_tpu_torch.convert import prep_from_arrays, to_arrays
from mpisppy_tpu_torch.cylinders import hub, spcommunicator as spc
from mpisppy_tpu_torch.cylinders.lagranger_bounder import LagrangerOuterBound
from mpisppy_tpu_torch.cylinders.lagrangian_bounder import (
    LagrangianOuterBound)
from mpisppy_tpu_torch.cylinders.fwph_spoke import FrankWolfeOuterBound
from mpisppy_tpu_torch.cylinders.lshaped_bounder import XhatLShapedInnerBound
from mpisppy_tpu_torch.cylinders.slam_heuristic import SlamMaxHeuristic
from mpisppy_tpu_torch.cylinders.spoke import Spoke
from mpisppy_tpu_torch.cylinders.xhatlooper_bounder import (
    XhatLooperInnerBound)
from mpisppy_tpu_torch.cylinders.xhatshufflelooper_bounder import (
    ScenarioCycler, XhatShuffleInnerBound)
from mpisppy_tpu_torch.cylinders.xhatspecific_bounder import (
    XhatSpecificInnerBound)
from mpisppy_tpu_torch.cylinders.xhatxbar_bounder import XhatXbarInnerBound
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
from mpisppy_tpu_torch.fwph.fwph import FWPH
from mpisppy_tpu_torch.opt.aph import APH
from mpisppy_tpu_torch.opt.lshaped import LShapedMethod
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.resilience import bounds
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.utils import config, vanilla
from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval, calculate_incumbent

ONE = ScenarioMesh(devices=jax.devices()[:1])
S = 3
NAMES = [f"scen{i}" for i in range(S)]
OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 40, "convthresh": 0.0,
        "pdhg_eps": 1e-7, "pdhg_max_iters": 20000}
HUB_OPTS = {"rel_gap": 1e-4, "abs_gap": 1.0}
# the farmer-3 optimum (tests/test_cylinders.py)
OPTIMUM = -108390.0
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small cases: more intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_normal_draw(shape, dtype, device, seed=0):
    jd = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    return torch.tensor(np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), shape, jd)), device=device)


@pytest.fixture(scope="module", autouse=True)
def jax_draw():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdhg, "normal_draw", jax_normal_draw)
        yield


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


# ---- windows, guards, cycler ---------------------------------------------

def _window_script(W, case):
    """Drive one window through `case`; the observable results."""
    out = []
    w = W(4)
    out.append(w.read()[1])
    if case == "ids_and_kill":
        for v in ([1, 2, 3, 4], [5, 6, 7, 8]):
            out.append(w.write(v))
            d, wid = w.read()
            out += [wid, d.tolist()]
        w.send_kill()
        out.append(w.read()[1])
        out.append(w.read_checked()[2:])
    elif case == "shape_guard":
        with pytest.raises(ValueError):
            w.write([1.0, 2.0])
        out.append(w.write_id)
    elif case == "explicit_ids":
        out.append(w.write([1, 1, 1, 1], write_id=7))
        out.append(w.read_checked()[1:])
        out.append(w.write([2, 2, 2, 2], write_id=3))
        out.append(w.read_checked()[1:])          # regressed id
        out.append(w.write([3, 3, 3, 3]))
        out.append(w.read_checked()[1:])
    elif case == "corrupt_next_write":
        w.write([1.5, 2.5, 3.5, 4.5])
        out.append(w.read_checked()[1:])
        w.corrupt_next_write()
        w.write([1.5, 2.5, 3.5, 4.5])
        d, wid, ok, reason = w.read_checked()
        out += [d.tolist(), wid, ok, reason]
        w.write([1.5, 2.5, 3.5, 4.5])
        out.append(w.read_checked()[1:])
    return out


@pytest.mark.parametrize("case", ["ids_and_kill", "shape_guard",
                                  "explicit_ids", "corrupt_next_write"])
def test_window_matches_jax(case):
    assert _window_script(spc.Window, case) == \
        _window_script(jspc.Window, case)


@pytest.mark.parametrize("backend", ["python", "seqlock", "registered"])
def test_window_pair_matches_jax(backend):
    if backend == "registered":
        def factory(hub_length, spoke_length, scale=1):
            return jspc.Window(hub_length * scale), \
                jspc.Window(spoke_length)
        jspc.register_window_backend("test_pair", factory)
        spc.register_window_backend("test_pair", factory)
        kw = {"backend": "test_pair", "backend_kwargs": {"scale": 2}}
    else:
        kw = {"backend": backend}
    got = spc.WindowPair(6, 1, **kw)
    want = jspc.WindowPair(6, 1, **kw)
    for g, w in ((got.to_spoke, want.to_spoke), (got.to_hub, want.to_hub)):
        assert g.length == w.length
        assert g.read()[1] == w.read()[1] == 0


def test_unregistered_window_backend_raises():
    with pytest.raises(RuntimeError, match="not registered"):
        spc.WindowPair(3, 1, backend="no_such_backend")


@pytest.mark.parametrize("shuffled,reverse,n", [
    ([2, 0, 1], True, 9), ([2, 0, 1], False, 9), ([5], True, 4),
    (list(range(7)), True, 30), ([], True, 2)])
def test_scenario_cycler_matches_jax(shuffled, reverse, n):
    got, want = ScenarioCycler(shuffled, reverse), JCycler(shuffled, reverse)
    assert [got.get_next() for _ in range(n)] == \
        [want.get_next() for _ in range(n)]


@pytest.mark.parametrize("values", [
    np.arange(5, dtype=np.float64), np.zeros(0),
    np.array([np.nan, np.inf, -np.inf, -0.0, 0.0]),
    np.linspace(-1e300, 1e300, 17),
    np.random.default_rng(3).standard_normal(1000).astype(np.float32),
    [1, 2, 3]], ids=["arange", "empty", "specials", "huge", "f32", "list"])
def test_payload_checksum_bit_equal(values):
    assert bounds.payload_checksum(values) == \
        jbounds.payload_checksum(values)


def test_payload_guard_matches_jax():
    v = np.arange(3.0)
    good = jbounds.payload_checksum(v)
    script = [(v, 1, good), (v, 2, good + 1), (v, 1, good), (v, -1, None),
              (v, 5, None), (v + 1, 5, good), (v, 6, good)]
    g, j = bounds.PayloadGuard(), jbounds.PayloadGuard()
    assert [g.check(*s) for s in script] == [j.check(*s) for s in script]
    assert (g.max_wid, g.corrupt) == (j.max_wid, j.corrupt)


@pytest.mark.parametrize("kind", ["outer", "inner"])
@pytest.mark.parametrize("minimizing", [True, False])
@pytest.mark.parametrize("rtol", [1e-2, 0.0])
def test_bound_guard_matches_jax(kind, minimizing, rtol):
    cases = [(v, inner, outer)
             for v in (np.nan, np.inf, -np.inf, -108390.0, -107000.0,
                       -109500.0, 0.5, -0.5)
             for inner, outer in ((np.inf, -np.inf), (-108389.0, -108400.0),
                                  (0.0, 0.0), (-108000.0, -np.inf),
                                  (np.inf, -109000.0))]
    g, j = bounds.BoundGuard(rtol), jbounds.BoundGuard(rtol)
    for v, inner, outer in cases:
        assert g.check(kind, v, inner, outer, minimizing) == \
            j.check(kind, v, inner, outer, minimizing), (v, inner, outer)


# ---- interleaved wheels: port against JAX -------------------------------

def _tracing(hub_cls):
    """`hub_cls` recording (iteration, outer, inner, outer char, inner
    char) at every screen trace, i.e. at every sync."""

    class Tracing(hub_cls):
        def setup_hub(self):
            super().setup_hub()
            self.trace = []

        def screen_trace(self):
            self.trace.append((self.current_iteration(),
                               float(self.BestOuterBound),
                               float(self.BestInnerBound),
                               self.latest_ob_char, self.latest_ib_char))
            return super().screen_trace()

    return Tracing


WHEELS = {
    "lagrangian_xhatshuffle": (
        [(LagrangianOuterBound, PH, {}), (XhatShuffleInnerBound, Xhat_Eval,
                                          {})],
        [(JLagrangian, JPH), (JShuffle, JXhat_Eval)], {}),
    "lagrangian_xhatxbar": (
        [(LagrangianOuterBound, PH, {}), (XhatXbarInnerBound, Xhat_Eval,
                                          {})],
        [(JLagrangian, JPH), (JXbar, JXhat_Eval)], {"PHIterLimit": 15}),
    "lagranger_slammax": (
        [(LagrangerOuterBound, PH, {}), (SlamMaxHeuristic, Xhat_Eval, {})],
        # slam-max candidates are infeasible on farmer: every xhat step
        # runs to the iteration cap, then the f64 certify to its own.
        # Both caps are cut so that the port's host loop (one sync per
        # 40 iterations) stays quick on the CPU; the PH and Lagranger
        # solves here take at most 1,000 iterations.
        [(JLagranger, JPH), (JSlamMax, JXhat_Eval)],
        {"PHIterLimit": 12, "pdhg_max_iters": 3000,
         "certify_max_iters": 2000}),
    "xhatlooper_xhatspecific": (
        [(XhatLooperInnerBound, Xhat_Eval, {"scen_limit": 2}),
         (XhatSpecificInnerBound, Xhat_Eval,
          {"xhat_scenario_dict": {0: 1}})],
        [(JLooper, JXhat_Eval), (JSpecific, JXhat_Eval)],
        {"PHIterLimit": 8}),
}


def _dicts(hub_cls, ph_cls, spokes, opts, batch, **hub_kw):
    hub_dict = {"hub_class": _tracing(hub_cls),
                "hub_kwargs": {"options": dict(HUB_OPTS)},
                "opt_class": ph_cls,
                "opt_kwargs": {"options": dict(opts),
                               "all_scenario_names": NAMES, "batch": batch,
                               **hub_kw}}
    spoke_dicts = [{"spoke_class": cls, "spoke_kwargs": {"options": so},
                    "opt_class": ocls,
                    "opt_kwargs": {"options": dict(opts),
                                   "all_scenario_names": NAMES}}
                   for cls, ocls, so in spokes]
    return hub_dict, spoke_dicts


@pytest.fixture(scope="module")
def wheels():
    """Each wheel of WHEELS spun once per package, interleaved."""
    out = {}
    for name, (tspokes, jspokes, extra) in WHEELS.items():
        opts = dict(OPTS, **extra)
        jspokes = [(c, o, so) for (c, o), (_, _, so) in zip(jspokes,
                                                           tspokes)]
        jws = JWheelSpinner(*_dicts(jhub.PHHub, JPH, jspokes, opts,
                                    jfarmer.build_batch(S), mesh=ONE))
        jws.spin()
        prep = prep_from_arrays(to_arrays(jws.spcomm.opt.prep),
                                device="cpu")
        tws = WheelSpinner(*_dicts(hub.PHHub, PH, tspokes, opts,
                                   farmer.build_batch(S, device="cpu"),
                                   device="cpu", prep=prep))
        tws.spin()
        out[name] = (tws, jws)
    return out


def _assert_traces_match(t, j):
    assert len(t) == len(j), (t, j)
    for a, b in zip(t, j):
        assert a[0] == b[0] and a[3:] == b[3:], (a, b)
        for x, y in zip(a[1:3], b[1:3]):
            if np.isfinite(y):
                assert _rel(x, y) <= TOL, (a, b)
            else:
                assert x == y, (a, b)


@pytest.mark.parametrize("name", list(WHEELS))
def test_interleaved_wheel_matches_jax(wheels, name):
    """Bound trace at every sync, termination iteration, final bounds
    and incumbent: 1e-6 relative."""
    tws, jws = wheels[name]
    th, jh = tws.spcomm, jws.spcomm
    _assert_traces_match(th.trace, jh.trace)
    assert th.current_iteration() == jh.current_iteration()
    for f in ("BestOuterBound", "BestInnerBound"):
        got, want = getattr(tws, f), getattr(jws, f)
        assert got == want if np.isinf(want) else _rel(got, want) <= TOL, f
    assert np.isfinite(tws.BestOuterBound)
    assert tws.BestOuterBound <= OPTIMUM + 1.0
    if np.isfinite(jws.BestInnerBound):
        assert tws.BestInnerBound >= OPTIMUM - 1.0
    else:
        assert tws.BestInnerBound == jws.BestInnerBound
    tsol, jsol = tws.best_nonant_solution(), jws.best_nonant_solution()
    assert tsol.shape == np.asarray(jsol).shape
    assert _rel(tsol, jsol) <= TOL
    assert th.failed_spokes == jh.failed_spokes == []
    assert th.finalize_failures == []
    np.testing.assert_array_equal(th.bound_rejects, jh.bound_rejects)
    assert tws.exchange_backend_used == jws.exchange_backend_used == "python"


def test_spoke_state_matches_jax(wheels):
    """The shuffled candidate order (Random(42)), the Lagranger's W and
    the algo_state keys of each spoke."""
    tws, jws = wheels["lagrangian_xhatshuffle"]
    ts, js = tws.spcomm.spokes[1], jws.spcomm.spokes[1]
    assert ts.cycler._shuffled == js.cycler._shuffled == \
        random.Random(42).sample(range(S), S)
    assert ts.cycler.best == js.cycler.best
    for name in WHEELS:
        tws, jws = wheels[name]
        for tsp, jsp in zip(tws.spcomm.spokes, jws.spcomm.spokes):
            assert sorted(tsp.algo_state()) == sorted(jsp.algo_state())
            assert tsp.last_hub_id == jsp.last_hub_id
    tws, jws = wheels["lagranger_slammax"]
    assert _rel(tws.spcomm.spokes[0].W, np.asarray(
        jws.spcomm.spokes[0].W)) <= TOL


def test_solution_writers_match_jax(wheels, tmp_path):
    tws, jws = wheels["lagrangian_xhatxbar"]
    for tag, ws in (("torch", tws), ("jax", jws)):
        ws.write_first_stage_solution(str(tmp_path / tag / "first.csv"))
        ws.write_tree_solution(str(tmp_path / tag / "tree"))

    def rows(path):
        return [ln.split(",") for ln in path.read_text().splitlines()]

    files = ["first.csv"] + [f"tree/{n}.csv" for n in NAMES]
    for f in files:
        t, j = rows(tmp_path / "torch" / f), rows(tmp_path / "jax" / f)
        assert [r[0] for r in t] == [r[0] for r in j], f
        assert _rel([float(r[1]) for r in t],
                    [float(r[1]) for r in j]) <= TOL, f
    assert len(rows(tmp_path / "torch" / "first.csv")) == 3


def test_xhat_eval_matches_jax(wheels):
    """Xhat_Eval.evaluate / evaluate_one and calculate_incumbent on
    farmer-3 (the port's reduced prep starts from the JAX draw)."""
    t = Xhat_Eval(dict(OPTS), NAMES, batch=farmer.build_batch(
        S, device="cpu"), device="cpu")
    j = JXhat_Eval(dict(OPTS), NAMES, batch=jfarmer.build_batch(S),
                   mesh=ONE)
    cand = np.array([170.0, 80.0, 250.0])
    (t_obj, t_ok), (j_obj, j_ok) = t.evaluate(cand), j.evaluate(cand)
    assert t_ok and j_ok and _rel(t_obj, j_obj) <= TOL
    assert _rel(t.evaluate_one(cand, 1), j.evaluate_one(cand, 1)) <= TOL
    cands = np.array([[170.0, 80.0, 250.0], [100.0, 100.0, 300.0],
                      [500.0, 500.0, 500.0]])
    (ti, tv), (ji, jv) = calculate_incumbent(t, cands), \
        jcalculate_incumbent(j, cands)
    assert ti == ji and _rel(tv, jv) <= TOL


# ---- threads mode, failures, counters ------------------------------------

def _port_wheel(spokes, mode="interleaved", hub_opts=None, opts=None):
    opts = dict(OPTS, **(opts or {}))
    hd, sds = _dicts(hub.PHHub, PH, [(c, o, {}) for c, o in spokes], opts,
                     farmer.build_batch(S, device="cpu"), device="cpu")
    hd["hub_kwargs"]["options"].update(hub_opts or {})
    return WheelSpinner(hd, sds, mode=mode)


def test_threads_mode_brackets_the_optimum():
    """Also: every cylinder solves on the hub's PreparedBatch, and no
    solve of any thread writes into it."""
    ws = _port_wheel([(LagrangianOuterBound, PH),
                      (XhatShuffleInnerBound, Xhat_Eval)], mode="threads",
                     opts={"PHIterLimit": 8})
    prep = PH(dict(OPTS), NAMES, batch=farmer.build_batch(S, device="cpu"),
              device="cpu").prep
    ws.hub_dict["opt_kwargs"]["prep"] = prep

    def leaves(p):
        d = to_arrays(p)
        d.update({f"A.{k}": v for k, v in d.pop("A").items()})
        return {k: np.array(v) for k, v in d.items()}

    before = leaves(prep)
    assert "A.shared" in before and "d_row" in before
    ws.spin()
    hp = ws.spcomm.opt.prep
    for sp in ws.spcomm.spokes:        # the same tensors, not copies
        assert sp.opt.prep.A.shared is hp.A.shared
        assert sp.opt.prep.d_col is hp.d_col
    after = leaves(ws.spcomm.opt.prep)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    assert np.isfinite(ws.BestOuterBound) and np.isfinite(ws.BestInnerBound)
    assert ws.BestOuterBound <= OPTIMUM + 1.0 <= ws.BestInnerBound + 2.0
    assert ws.BestOuterBound <= ws.BestInnerBound
    assert ws.spcomm.failed_spokes == []
    assert ws.spcomm.finalize_failures == []
    # the spoke threads were joined
    assert not any("guarded_main" in t.name for t in threading.enumerate())


class _Exploding(LagrangianOuterBound):
    def step(self):
        raise RuntimeError("synthetic spoke crash")


@pytest.mark.parametrize("mode", ["interleaved", "threads"])
def test_crashing_spoke_is_pruned(mode):
    ws = _port_wheel([(_Exploding, PH), (XhatShuffleInnerBound, Xhat_Eval)],
                     mode=mode, opts={"PHIterLimit": 10})
    ws.spin()
    h = ws.spcomm
    assert [f[0] for f in h.failed_spokes] == ["_Exploding"]
    assert "synthetic spoke crash" in h.failed_spokes[0][1]
    assert 0 not in h.outerbound_idx and 0 not in h.w_idx
    # the trivial bound and the healthy xhat spoke still answer
    assert np.isfinite(ws.BestOuterBound) and np.isfinite(ws.BestInnerBound)
    assert ws.BestOuterBound <= ws.BestInnerBound + 1.0
    assert abs(ws.BestInnerBound - OPTIMUM) < 50.0


class _FailingFinalPass(LagrangianOuterBound):
    def finalize(self):
        raise RuntimeError("synthetic final-pass failure")


@pytest.mark.parametrize("mode", ["interleaved", "threads"])
def test_failing_final_pass_is_recorded(mode):
    """A spoke whose final pass raises leaves the wheel's results in
    place and is listed in hub.finalize_failures, not only logged."""
    ws = _port_wheel([(_FailingFinalPass, PH),
                      (XhatShuffleInnerBound, Xhat_Eval)],
                     mode=mode, opts={"PHIterLimit": 6})
    ws.spin()
    h = ws.spcomm
    assert h.failed_spokes == []
    assert h.finalize_failures == [("_FailingFinalPass",
                                    "synthetic final-pass failure")]
    assert np.isfinite(ws.BestOuterBound) and np.isfinite(ws.BestInnerBound)
    assert ws.BestOuterBound <= ws.BestInnerBound


def test_hung_spoke_is_escalated_at_the_join_timeout():
    release = threading.Event()

    class Hung(LagrangianOuterBound):
        def main(self):
            # ignores the kill signal until the test ends
            release.wait(timeout=60.0)

    # the healthy spoke must finish its last step within the join
    # timeout even on a loaded machine: its solves are capped (farmer-3
    # needs at most ~1,000 iterations) so that no step can run long
    ws = _port_wheel([(Hung, PH), (XhatShuffleInnerBound, Xhat_Eval)],
                     mode="threads",
                     opts={"PHIterLimit": 4, "pdhg_max_iters": 3000,
                           "certify_max_iters": 2000},
                     hub_opts={"shutdown_join_timeout": 10.0})
    t0 = time.time()
    try:
        ws.spin()
    finally:
        release.set()
    assert time.time() - t0 < 50.0
    h = ws.spcomm
    hung = [sp for sp in h.spokes if getattr(sp, "_failed", False)]
    assert len(hung) == 1 and isinstance(hung[0], Hung)
    assert any("did not exit" in msg for _, msg in h.failed_spokes)
    assert np.isfinite(ws.BestInnerBound)


def test_route_counters_survive_contention():
    """Many threads bump the matmul-route counter at once, with a tiny
    switch interval: no count may be lost."""
    x = torch.zeros((1, 2), dtype=torch.float64)
    y = torch.zeros((1, 1), dtype=torch.float64)
    A = torch.ones((1, 1, 2), dtype=torch.float64)
    args = (A, x, x, x - 1, x + 1, y - 1, y + 1, x, y,
            torch.ones(1, dtype=torch.float64),
            torch.ones(1, dtype=torch.float64), 0)
    n_threads, n_calls = 16, 300
    old = sys.getswitchinterval()
    pdhg.matmul_chunks = 0
    try:
        sys.setswitchinterval(1e-6)
        ts = [threading.Thread(target=lambda: [pdhg.matmul_chunk(*args)
                                               for _ in range(n_calls)])
              for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert pdhg.matmul_chunks == n_threads * n_calls


@pytest.mark.parametrize("mode", ["interleaved", "threads"])
def test_chunk_counts_are_exact_in_the_wheel(monkeypatch, mode):
    """With a sparse shared block (pdhg_sparse_threshold) the hub's and
    the Lagrangian's solves take the matmul route on the CPU too;
    `ops.pdhg.matmul_chunks` must equal an independent, locked count of
    the matmul-route chunks that ran."""
    seen = [0]
    lock = threading.Lock()
    body = pdhg._torch_steps

    def counted(*a, **kw):
        if kw.get("csum") is None and len(a) < 13:
            with lock:
                seen[0] += 1
        return body(*a, **kw)

    monkeypatch.setattr(pdhg, "_torch_steps", counted)
    pdhg.matmul_chunks = 0
    pdhg_chunk.launches = 0
    ws = _port_wheel([(LagrangianOuterBound, PH),
                      (XhatShuffleInnerBound, Xhat_Eval)], mode=mode,
                     opts={"PHIterLimit": 3, "pdhg_sparse_threshold": 1.0})
    ws.spin()
    assert seen[0] > 0
    assert pdhg.matmul_chunks == seen[0]
    assert pdhg_chunk.launches == 0          # the CPU runs no kernel


# ---- config and vanilla --------------------------------------------------

ARGV = ["--num-scens", "3", "--lagrangian", "--xhatshuffle",
        "--rel-gap", "1e-4", "--max-iterations", "6"]


def _standard_cfg(mod):
    """examples/_driver.standard_cfg's groups, plus farmer's."""
    cfg = mod.Config()
    for g in ("popular_args", "ph_args", "two_sided_args", "fwph_args",
              "lagrangian_args", "lagranger_args", "xhatlooper_args",
              "xhatshuffle_args", "xhatspecific_args", "xhatxbar_args",
              "xhatlshaped_args", "slammax_args", "slammin_args",
              "fixer_args", "gapper_args", "converger_args",
              "norm_rho_args", "mult_rho_args", "wtracker_args",
              "ef_args"):
        getattr(cfg, g)()
    return cfg


@pytest.mark.parametrize("argv", [ARGV, [], [
    "--num-scens", "7", "--crops-multiplier", "2", "--xhatxbar",
    "--lagranger", "--slammax", "--default-rho", "2.5",
    "--solver-eps", "1e-5", "--farmer-with-integers", "--xhatlooper",
    "--xhat-scen-limit", "2", "--add-reversed-shuffle", "true"]],
    ids=["wheel", "defaults", "many_flags"])
def test_cylinders_command_line_parses_as_in_jax(argv):
    tcfg, jcfg = _standard_cfg(config), _standard_cfg(jconfig)
    farmer.inparser_adder(tcfg)
    jfarmer.inparser_adder(jcfg)
    tcfg.parse_command_line("farmer_cylinders", args=argv)
    jcfg.parse_command_line("farmer_cylinders", args=argv)
    assert dict(tcfg) == dict(jcfg)
    assert tcfg.options_dict() == jcfg.options_dict()
    assert farmer.kw_creator(tcfg) == jfarmer.kw_creator(jcfg)
    assert farmer.scenario_names_creator(tcfg.num_scens) == \
        jfarmer.scenario_names_creator(jcfg.num_scens)
    assert config.parse_branching_factors("3, 2") == \
        jconfig.parse_branching_factors("3, 2")


def test_vanilla_builds_jax_dicts_and_spins():
    tcfg, jcfg = _standard_cfg(config), _standard_cfg(jconfig)
    argv = ARGV + ["--xhatxbar", "--lagranger", "--slammin",
                   "--xhatlooper"]
    for cfg, mod in ((tcfg, farmer), (jcfg, jfarmer)):
        mod.inparser_adder(cfg)
        cfg.parse_command_line("farmer_cylinders", args=argv)
    names = farmer.scenario_names_creator(tcfg.num_scens)
    tb = farmer.batch_creator(dict(farmer.kw_creator(tcfg), device="cpu"),
                              tcfg.num_scens)
    th = vanilla.ph_hub(tcfg, farmer.scenario_creator, None, names,
                        batch=tb)
    jh = jvanilla.ph_hub(jcfg, jfarmer.scenario_creator, None, names,
                         batch=None)
    tsp = vanilla.build_spokes(tcfg, farmer.scenario_creator, None, names,
                               batch=tb)
    jsp = jvanilla.build_spokes(jcfg, jfarmer.scenario_creator, None,
                                names)
    assert th["hub_kwargs"] == jh["hub_kwargs"]
    assert th["opt_kwargs"]["options"] == jh["opt_kwargs"]["options"]
    assert th["hub_class"].__name__ == jh["hub_class"].__name__
    assert [d["spoke_class"].__name__ for d in tsp] == \
        [d["spoke_class"].__name__ for d in jsp]
    for t, j in zip(tsp, jsp):
        assert t["spoke_kwargs"] == j["spoke_kwargs"]
        assert t["opt_kwargs"]["options"] == j["opt_kwargs"]["options"]
        assert t["opt_class"].__name__ == j["opt_class"].__name__
    th["opt_kwargs"]["device"] = "cpu"
    tsp = [d for d in tsp
           if d["spoke_class"] in (LagrangianOuterBound,
                                   XhatShuffleInnerBound)]
    ws = WheelSpinner(th, tsp).spin()
    assert ws.BestOuterBound <= OPTIMUM + 1.0 <= ws.BestInnerBound + 2.0
    assert ws.spcomm.current_iteration() <= 6


# ---- what is not ported raises -------------------------------------------

def _hub_dict(**opts):
    return {"hub_class": hub.PHHub, "hub_kwargs": {"options": opts},
            "opt_class": PH,
            "opt_kwargs": {"options": dict(OPTS, PHIterLimit=1),
                           "all_scenario_names": NAMES,
                           "batch": farmer.build_batch(S, device="cpu"),
                           "device": "cpu"}}


def _spoke_dict(cls=LagrangianOuterBound, **spoke_opts):
    return {"spoke_class": cls, "spoke_kwargs": {"options": spoke_opts},
            "opt_class": PH if cls is LagrangianOuterBound else Xhat_Eval,
            "opt_kwargs": {"options": dict(OPTS), "all_scenario_names": NAMES}}


def _cfg(**kv):
    cfg = _standard_cfg(config)
    farmer.inparser_adder(cfg)
    cfg.update(kv)
    return cfg


UNPORTED = {
    "exchange_device": (lambda: WheelSpinner(
        _hub_dict(), exchange_backend="device"), 13),
    "exchange_collective": (lambda: WheelSpinner(
        _hub_dict(), exchange_backend="collective"), 13),
    "window_backend_device": (lambda: spc.WindowPair(
        3, 1, backend="device"), 13),
    "window_backend_collective": (lambda: spc.WindowPair(
        3, 1, backend="collective"), 13),
}


def _multiproc(keep):
    """A hub-only multiproc spin (no spoke process): the native windows,
    the workdir kept or removed."""
    import shutil
    ws = WheelSpinner(_hub_dict(), mode="multiproc",
                      keep_workdir=keep).spin()
    kept = os.path.isdir(ws.workdir)
    shutil.rmtree(ws.workdir, ignore_errors=True)
    return ws.exchange_backend_used == "native" and kept == keep


def _native_spin(**kw):
    """A farmer-3 wheel with a Lagrangian spoke on the native seqlock;
    True iff its windows are native ones and it bounded the run."""
    from mpisppy_tpu_torch.runtime import NativeWindow
    ws = WheelSpinner(_hub_dict(**kw.pop("hub", {})), [_spoke_dict()],
                      **kw).spin()
    pair = ws.spcomm.pairs[0]
    return (isinstance(pair.to_hub, NativeWindow)
            and isinstance(pair.to_spoke, NativeWindow)
            and bool(np.isfinite(ws.BestOuterBound)))


def _window_files():
    """window_path_prefix on the native backend: the pair's windows are
    files under the prefix."""
    import shutil
    import tempfile
    d = tempfile.mkdtemp()
    try:
        ok = _native_spin(hub={"window_backend": "native",
                               "window_path_prefix": f"{d}/w"})
        return ok and sorted(os.listdir(d)) == ["w0.to_hub", "w0.to_spoke"]
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _chaos_pruned():
    """A spoke crashed by chaos at its first step is pruned and the
    wheel ends on the hub's own bounds."""
    ws = WheelSpinner(_hub_dict(), [_spoke_dict(
        chaos={"crash_at_step": 1})]).spin()
    (name, msg), = ws.spcomm.failed_spokes
    return (name == "LagrangianOuterBound"
            and "injected spoke crash" in msg
            and bool(np.isfinite(ws.BestOuterBound)))


def _resume_missing():
    """resume_from a missing checkpoint: a fresh start."""
    ws = WheelSpinner(_hub_dict(), resume_from="absent_run.ckpt").spin()
    return ws.spcomm.opt.options["resume_from"] == "absent_run.ckpt" \
        and ws.spcomm.current_iteration() == 1


def _telemetry_spin(hub_opts, spoke_opts):
    """Spin with a telemetry option on the hub or a spoke; True iff the
    cylinder that set it holds an enabled handle."""
    from mpisppy_tpu_torch import telemetry
    telemetry.reset()
    try:
        sd = _spoke_dict(**spoke_opts)
        ws = WheelSpinner(_hub_dict(**hub_opts),
                          [sd] if spoke_opts else []).spin()
        cyl = ws.spcomm.spokes[0] if spoke_opts else ws.spcomm
        return cyl.telemetry.enabled
    finally:
        telemetry.reset()


def _solver_option(factory, **kv):
    """The pdhg_eps a spoke factory resolves from its solver options."""
    return factory(_cfg(**kv), None, None, NAMES)["opt_kwargs"][
        "options"]["pdhg_eps"]


def _adder(name):
    """A vanilla extension adder attaches its extension to a hub dict."""
    hub = vanilla.ph_hub(_cfg(), None, None, NAMES)
    if name == "extension_adder":
        from mpisppy_tpu_torch.extensions.mipgapper import Gapper
        vanilla.extension_adder(hub, Gapper)
        vanilla.extension_adder(hub, Gapper)
        return hub["opt_kwargs"]["extension_kwargs"] == {
            "ext_classes": [Gapper, Gapper]}
    getattr(vanilla, name)(hub, _cfg())
    return hub["opt_kwargs"]["extensions"] is not None


def _hub_of(hub_cls, opt_cls, opts):
    """A hub of `hub_cls` over a farmer-3 optimizer, wired."""
    opt = opt_cls(dict(OPTS, **opts), NAMES,
                  batch=farmer.build_batch(S, device="cpu"), device="cpu")
    h = hub_cls(opt, [], options={})
    h.setup_hub()
    return isinstance(h, hub_cls) and h.pairs == []


def _spoke_selected(flag, spoke_cls, opt_cls):
    """build_spokes turns the cfg flag into the spoke's dict."""
    (d,) = vanilla.build_spokes(_cfg(**{flag: True}), None, None, NAMES)
    return d["spoke_class"] is spoke_cls and d["opt_class"] is opt_cls


# parts that raised until ported (ROADMAP.md queue A items 8, 5, 7, 9,
# 10, 11 and 6): each case now checks that the part works
PORTED = {
    "mode_multiproc": lambda: _multiproc(keep=False),
    "keep_workdir": lambda: _multiproc(keep=True),
    "resume_from": _resume_missing,
    "exchange_native": lambda: _native_spin(exchange_backend="native"),
    "window_backend_native": lambda: _native_spin(
        hub={"window_backend": "native"}),
    "window_path_prefix": _window_files,
    "spoke_chaos": _chaos_pruned,
    "aph_hub_class": lambda: _hub_of(hub.APHHub, APH, {}),
    "lshaped_hub_class": lambda: _hub_of(hub.LShapedHub, LShapedMethod,
                                         {"max_iter": 2}),
    "vanilla_aph_hub": lambda: vanilla.aph_hub(
        _cfg(), None, None, NAMES)["hub_class"] is hub.APHHub,
    "vanilla_lshaped_hub": lambda: vanilla.lshaped_hub(
        _cfg(), None, None, NAMES)["opt_class"] is LShapedMethod,
    "vanilla_fwph": lambda: _spoke_selected("fwph", FrankWolfeOuterBound,
                                            FWPH),
    "vanilla_xhatlshaped": lambda: _spoke_selected(
        "xhatlshaped", XhatLShapedInnerBound, Xhat_Eval),
    "scenario_creator": lambda: farmer.scenario_creator(
        "scen0", device="cpu").num_scens == 1,
    "add_fixer": lambda: _adder("add_fixer"),
    "add_norm_rho": lambda: _adder("add_norm_rho"),
    "add_multi_rho": lambda: _adder("add_multi_rho"),
    "add_wtracker": lambda: _adder("add_wtracker"),
    "extension_adder": lambda: _adder("extension_adder"),
    "hub_telemetry": lambda: _telemetry_spin({"telemetry": True}, {}),
    "spoke_telemetry": lambda: _telemetry_spin({}, {"telemetry": True}),
    "root_solver_option": lambda: _solver_option(
        vanilla.lagrangian_spoke, lagrangian_solver_eps=1e-5,
        solver_eps=1e-7) == 1e-5,
    "solver_options_string": lambda: _solver_option(
        vanilla.xhatxbar_spoke, solver_options="eps=1e-5") == 1e-5,
}


@pytest.mark.parametrize("case", list(UNPORTED) + list(PORTED))
def test_unported_parts_raise(case):
    if case in PORTED:
        assert PORTED[case]() is True
        return
    fn, item = UNPORTED[case]
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue A item {item}$"):
        fn()


def test_unknown_mode_and_backend_raise():
    with pytest.raises(ValueError, match="mode"):
        WheelSpinner(_hub_dict(), mode="sideways")
    with pytest.raises(ValueError, match="exchange_backend"):
        WheelSpinner(_hub_dict(), exchange_backend="pigeon")
    with pytest.raises(RuntimeError, match="hub_dict missing"):
        WheelSpinner({"hub_class": hub.PHHub})
    with pytest.raises(RuntimeError, match="spoke_dict missing"):
        WheelSpinner(_hub_dict(), [{"spoke_class": Spoke}])
