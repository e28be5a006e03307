"""The port's resilience layer and the rest of the wheel on the CPU:
the native seqlock exchange (`runtime/`), the chaos injectors, the
spoke supervisor, run checkpoints and multiproc mode, held against
the JAX package where both can run.

* The exchange: round trip, kill, explicit write_id and length
  mismatch behave as in the JAX package's NativeWindow, and one mmap
  window file is shared across the packages (a JAX writer and a port
  reader, and the other way round).  The port's NativeWindow raises
  where its library is missing (no fallback).
* `ChaosInjector`: the same fates as the JAX injector for the same
  configs, the environment override included.
* `SpokeSupervisor` against a fake `spawn_fn` (sleeping children): a
  hang is detected, restarted, then pruned; window writes defer the
  hang verdict; a clean exit is no failure.
* Checkpoints: a farmer-6 run crashed by chaos after iteration 4's
  checkpoint and resumed lands exactly on the uninterrupted run's W,
  x̄ and conv; either package reads the other's run checkpoint files;
  WheelSpinner(resume_from=...) restores the hub's bounds
  and incumbent; a spoke's `restore_algo_state` inverts `algo_state`.
* Multiproc: one farmer-6 wheel whose spoke processes run on "cpu"
  (the hub's device): its bounds and those of the port's interleaved
  wheel bracket each other, and its children load neither JAX nor the
  JAX package; its third child, crashed by chaos (os._exit), is
  restarted once, then pruned, and the hub ends on valid bounds.
"""

import json
import os
import shutil
import time
import types

import numpy as np
import pytest
import torch

from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.resilience.chaos import (ChaosError as JChaosError,
                                          ChaosInjector as JChaos)
from mpisppy_tpu.resilience.checkpoint import (
    load_run_checkpoint as jload, save_run_checkpoint as jsave)
from mpisppy_tpu.runtime import native as jnative
from mpisppy_tpu_torch.cylinders.hub import PHHub
from mpisppy_tpu_torch.cylinders.lagrangian_bounder import (
    LagrangianOuterBound)
from mpisppy_tpu_torch.cylinders.spcommunicator import Window
from mpisppy_tpu_torch.cylinders.xhatshufflelooper_bounder import (
    XhatShuffleInnerBound)
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.resilience import wheel_counters
from mpisppy_tpu_torch.resilience.chaos import ChaosError, ChaosInjector
from mpisppy_tpu_torch.resilience.checkpoint import (
    checkpoint_exists, is_wheel_checkpoint, save_run_checkpoint)
from mpisppy_tpu_torch.resilience.supervisor import (SpokeSupervisor,
                                                     restart_delay)
from mpisppy_tpu_torch.runtime import native
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval
from torch_parity import ONE


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small cases: more intra-op threads only contend with the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

S = 6
NAMES = [f"scen{i}" for i in range(S)]
OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 8, "convthresh": 0.0,
        "pdhg_eps": 1e-7, "pdhg_max_iters": 20000}
SPEC = {"module": "mpisppy_tpu_torch.models.farmer",
        "builder": "build_batch", "kwargs": {"num_scens": S}}


# ---- the native exchange --------------------------------------------------

def _pair_of_windows(kind, n, path=None):
    cls = {"port": native.NativeWindow, "port_py": native.PySeqlockWindow,
           "jax": jnative.NativeWindow}[kind]
    return cls(n, path=path)


def _exchange_trace(kind):
    """What a window does in the JAX tests' cases: round trip, explicit
    write_id, kill, length mismatch."""
    w = _pair_of_windows(kind, 8)
    out = [w.write(np.arange(8.0)), w.read()[1],
           w.read()[0].tolist(), w.write(np.arange(8.0) * 2),
           w.read()[0].tolist(), w.write(np.zeros(8), write_id=7),
           w.read()[1]]
    with pytest.raises(ValueError):
        w.write(np.zeros(5))
    w.send_kill()
    out.append(w.write_id)
    w.close()
    return out


@pytest.mark.parametrize("kind", ["port", "port_py"])
def test_exchange_equals_jax(kind):
    assert native.available() and jnative.available()
    assert _exchange_trace(kind) == _exchange_trace("jax")
    assert native.library_path().parent.name == "runtime"
    assert native.library_path().parent.parent.name == "build"


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax"),
                                           ("port_py", "port")])
def test_exchange_file_shared_across_packages(tmp_path, writer, reader):
    p = str(tmp_path / "win.bin")
    a = _pair_of_windows(writer, 6, path=p)
    b = _pair_of_windows(reader, 6, path=p)
    assert a.write(np.full(6, 3.25)) == 1
    out, wid = b.read()
    assert wid == 1 and np.all(out == 3.25)
    b.send_kill()
    assert a.write_id == -1
    # a window of another length on the same file is refused
    with pytest.raises(RuntimeError, match="exch_create failed"):
        _pair_of_windows(reader, 5, path=p)
    a.close()
    b.close()


def test_native_window_raises_without_library(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "no g++ here")
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable: no g.. here"):
        native.NativeWindow(3)


# ---- chaos ------------------------------------------------------------------

def _fates(cls, err, config, n=6):
    """The outcome of n step ticks, writes, a poison and hub ticks."""
    c = cls.from_options(config)
    out = [c.active]
    for _ in range(n):
        try:
            c.step_tick()
            out.append("ok")
        except err as e:
            out.append(f"{type(e).__name__}: {e}")
    out += [c.write_fate() for _ in range(n)]
    out.append(np.isnan(np.asarray(c.poison([1.0, 2.0]))).tolist())
    for k in range(1, n):
        try:
            c.hub_iter_tick(k)
            out.append("ok")
        except err as e:
            out.append(f"{type(e).__name__}: {e}")
    return out


@pytest.mark.parametrize("config", [
    None, {"crash_at_step": 3}, {"device_loss": 2},
    {"nan_bound": True, "corrupt_window": 2},
    {"partition_slice": 4, "crash_at_iter": 3},
    {"replica_crash": 5, "delay_write_s": 0.0}])
def test_chaos_fates_equal_jax(config, monkeypatch):
    assert _fates(ChaosInjector, ChaosError, config) == \
        _fates(JChaos, JChaosError, config)
    # the environment override merges into the options (env wins)
    monkeypatch.setenv("MPISPPY_TPU_CHAOS", '{"crash_at_step": 2}')
    assert _fates(ChaosInjector, ChaosError, config) == \
        _fates(JChaos, JChaosError, config)


# ---- the supervisor against a fake spawn_fn ---------------------------------

def _fake_hub(n):
    hub = types.SimpleNamespace(
        spokes=[types.SimpleNamespace(proc=None, spoke_name=f"Spoke{i}")
                for i in range(n)],
        pairs=[types.SimpleNamespace(to_hub=Window(1)) for _ in range(n)],
        failed=[])
    hub._mark_spoke_failed = lambda i, exc: hub.failed.append((i, str(exc)))
    return hub


def _spawn(code):
    def spawn(spec, workdir, tag):
        import subprocess
        import sys
        return subprocess.Popen([sys.executable, "-c", code])
    return spawn


def _drive(sup, until, timeout=30.0):
    t0 = time.monotonic()
    while not until() and time.monotonic() - t0 < timeout:
        sup.poll(force=True)
        time.sleep(0.02)
    assert until(), "the supervisor never reached the expected state"


@pytest.mark.parametrize("case", ["hang_restart_prune", "writes_defer_hang",
                                  "clean_exit"])
def test_supervisor_unit(case):
    hub = _fake_hub(1)
    opts = {"supervise_interval": 0.0, "spoke_hang_timeout": 0.3,
            "spoke_max_restarts": 1, "spoke_restart_backoff": 0.01,
            "spoke_term_deadline": 2.0}
    code = "pass" if case == "clean_exit" else "import time; time.sleep(60)"
    sup = SpokeSupervisor(hub, specs=[{}], workdir=".",
                          spawn_fn=_spawn(code), options=opts)
    sup.start()
    try:
        if case == "hang_restart_prune":
            first = hub.spokes[0].proc.pid
            _drive(sup, lambda: sup.restarts[0] == 1)
            assert sup.spoke_restarts == 1
            _drive(sup, lambda: sup.spokes_failed == 1)
            assert hub.failed and hub.failed[0][0] == 0
            assert "hung" in hub.failed[0][1]
            assert [r["hung"] for r in sup.exit_reports] == [True, True]
            assert hub.spokes[0].proc.poll() is not None
            assert first in sup.killed_by_us
        elif case == "writes_defer_hang":
            for _ in range(10):
                hub.pairs[0].to_hub.write([1.0])   # the heartbeat
                sup.poll(force=True)
                time.sleep(0.05)
            assert sup.spokes_failed == 0 and not hub.failed
        else:
            hub.spokes[0].proc.wait(timeout=30)
            sup.poll(force=True)
            assert sup.state[0] == "stopped"
            assert sup.spokes_failed == 0 and not sup.exit_reports
    finally:
        sup.kill_all()
    assert restart_delay(3, 0.5, 30.0) == 2.0
    assert restart_delay(9, 0.5, 30.0) == 30.0


# ---- checkpoints ------------------------------------------------------------

def _ph(extra=None):
    return PH({**OPTS, **(extra or {})}, NAMES,
              batch=farmer.build_batch(S, device="cpu"), device="cpu")


def test_crash_then_resume_replays(tmp_path):
    ck = str(tmp_path / "run.ckpt")
    a = _ph()
    conv_a, _, triv_a = a.ph_main(finalize=False)
    b = _ph({"run_checkpoint": ck, "checkpoint_every": 2,
             "chaos": {"crash_at_iter": 4}})
    with pytest.raises(ChaosError, match="iter 4"):
        b.ph_main(finalize=False)
    assert checkpoint_exists(ck) and not is_wheel_checkpoint(ck)
    assert int(np.load(ck + ".npz")["it"]) == 4
    c = _ph({"resume_from": ck})
    conv_c, _, triv_c = c.ph_main(finalize=False)
    assert int(c.state.it) == int(a.state.it) == 8
    assert triv_c == triv_a and conv_c == conv_a
    for f in ("W", "xbar", "x", "y"):
        np.testing.assert_array_equal(getattr(c.state, f).numpy(),
                                      getattr(a.state, f).numpy(), f)
    # the file format is the JAX package's, both ways
    j = JPH(dict(OPTS), NAMES, batch=jfarmer.build_batch(S), mesh=ONE)
    jload(ck, j)
    np.testing.assert_array_equal(np.asarray(j.state.W), b.state.W.numpy())
    save_run_checkpoint(str(tmp_path / "port.ckpt"), c)
    jload(str(tmp_path / "port.ckpt"), j)
    np.testing.assert_array_equal(np.asarray(j.state.xbar),
                                  c.state.xbar.numpy())
    jsave(str(tmp_path / "jax.ckpt"), j)
    e = _ph()
    e.restore_run_checkpoint(str(tmp_path / "jax.ckpt"))
    assert int(e.state.it) == 8
    np.testing.assert_array_equal(e.state.W.numpy(), c.state.W.numpy())
    # a missing checkpoint falls through to a fresh start
    d = _ph({"resume_from": str(tmp_path / "absent.ckpt"),
             "PHIterLimit": 1})
    assert np.isfinite(d.ph_main(finalize=False)[2])
    # a checkpoint of another model is refused
    other = PH(dict(OPTS, PHIterLimit=1), NAMES,
               batch=farmer.build_batch(S, crops_multiplier=2,
                                        device="cpu"), device="cpu")
    other.ph_main(finalize=False)
    with pytest.raises(ValueError, match="does not match"):
        other.restore_run_checkpoint(ck)


def _wheel(spokes, mode="interleaved", hub_opts=None, opt_extra=None,
           hub_cls=PHHub, **kw):
    opts = {**OPTS, **(opt_extra or {})}
    hub_dict = {"hub_class": hub_cls,
                "hub_kwargs": {"options": {"rel_gap": 1e-4,
                                           **(hub_opts or {})}},
                "opt_class": PH,
                "opt_kwargs": {"options": opts, "all_scenario_names": NAMES,
                               "batch": farmer.build_batch(S, device="cpu"),
                               "device": "cpu"}}
    spoke_dicts = [
        {"spoke_class": cls, "spoke_kwargs": {"options": sp_opts or {}},
         "opt_class": ocls, "proc": {"batch": SPEC},
         "opt_kwargs": {"options": dict(opts), "all_scenario_names": NAMES}}
        for cls, ocls, sp_opts in spokes]
    return WheelSpinner(hub_dict, spoke_dicts, mode=mode, **kw).spin()


def test_wheel_resume_restores_hub_bounds(tmp_path):
    ck = str(tmp_path / "wheel.ckpt")
    a = _wheel([(XhatShuffleInnerBound, Xhat_Eval, None)],
               opt_extra={"PHIterLimit": 6, "run_checkpoint": ck})
    # the checkpoint's iteration is the limit: no new iteration, every
    # bound the resumed wheel reports comes from the file
    b = _wheel([], opt_extra={"PHIterLimit": 6}, resume_from=ck)
    assert b.BestOuterBound == a.BestOuterBound
    assert b.BestInnerBound == a.BestInnerBound
    np.testing.assert_array_equal(b.best_nonant_solution(),
                                  a.best_nonant_solution())


def test_restore_algo_state_round_trip():
    ws = _wheel([(XhatShuffleInnerBound, Xhat_Eval, None)],
                opt_extra={"PHIterLimit": 3})
    sp = ws.spcomm.spokes[0]
    state = sp.algo_state()
    assert {"cycler_pos", "last_nonants", "bound", "best_solution",
            "last_hub_id"} <= set(state)
    fresh = XhatShuffleInnerBound(
        Xhat_Eval(dict(OPTS), NAMES, batch=farmer.build_batch(
            S, device="cpu"), device="cpu"))
    fresh.restore_algo_state(
        {k: np.asarray(v) for k, v in state.items()})
    back = fresh.algo_state()
    assert set(back) == set(state)
    for k in state:
        np.testing.assert_array_equal(np.asarray(back[k]),
                                      np.asarray(state[k]), k)


# ---- multiproc --------------------------------------------------------------

class _UntilPruned(PHHub):
    """Iterates until the supervisor pruned a spoke and PH ran
    MP_ITERS iterations (or 120 s)."""

    def setup_hub(self):
        super().setup_hub()
        self._t0 = time.monotonic()

    def is_converged(self):
        super().is_converged()
        if (self.supervisor is not None and self.supervisor.spokes_failed
                and self.current_iteration() >= MP_ITERS):
            return True
        time.sleep(0.02)
        return time.monotonic() - self._t0 > 120.0


MP_ITERS = 20


@pytest.fixture(scope="module")
def multiproc_wheel():
    """One multiproc farmer-6 wheel whose children run on "cpu": a
    Lagrangian and an xhat-shuffle child that stay healthy, and a second
    Lagrangian child that chaos crashes (os._exit) at its third step,
    restarted once, then pruned.  Both multiproc tests read it, so that
    the children's start-up is paid once."""
    chaos = {"crash_at_step": 3, "hard_exit": True}
    ws = _wheel([(LagrangianOuterBound, PH, None),
                 (XhatShuffleInnerBound, Xhat_Eval, None),
                 (LagrangianOuterBound, PH, {"chaos": chaos})],
                mode="multiproc", keep_workdir=True, hub_cls=_UntilPruned,
                hub_opts={"supervise_interval": 0.05,
                          "spoke_max_restarts": 1,
                          "spoke_restart_backoff": 0.1,
                          "shutdown_join_timeout": 30.0},
                opt_extra={"PHIterLimit": 10 ** 6})
    yield ws
    shutil.rmtree(ws.workdir, ignore_errors=True)


def test_multiproc_wheel_brackets_interleaved(multiproc_wheel):
    ws = multiproc_wheel
    spokes = [(LagrangianOuterBound, PH, None),
              (XhatShuffleInnerBound, Xhat_Eval, None)]
    ref = _wheel(spokes, opt_extra={"PHIterLimit": 5})
    assert ws.exchange_backend_used == "native"
    assert ws.spcomm.current_iteration() >= MP_ITERS
    # the healthy children ended on the kill signal
    for h in ws.spcomm.spokes[:2]:
        assert h.proc is not None and h.proc.returncode == 0
    # each child ran on the hub's device and loaded no JAX module
    assert [i["device"] for i in ws.child_info] == ["cpu"] * 3
    assert all(i["forbidden_modules"] == [] for i in ws.child_info)
    assert os.path.exists(os.path.join(ws.workdir, "pair1.sol.npy"))
    # valid bounds bracket each other: the optimum lies between each
    # run's outer and inner bound
    ob, ib = ws.BestOuterBound, ws.BestInnerBound
    assert np.isfinite(ob) and np.isfinite(ib)
    tol = 1e-6 * abs(ref.BestInnerBound)
    assert ob <= ref.BestInnerBound + tol and ib >= ref.BestOuterBound - tol
    assert (ib - ob) / abs(ib) < 0.05
    assert ws.best_nonant_solution() is not None


def test_multiproc_crashed_spoke_restarted_then_pruned(multiproc_wheel):
    ws = multiproc_wheel
    hub = ws.spcomm
    sup = hub.supervisor
    assert sup.spoke_restarts == 1 and sup.spokes_failed == 1
    assert [f[0] for f in hub.failed_spokes] == ["LagrangianOuterBound"]
    assert [(r["spoke"], r["rc"], r["incarnation"])
            for r in sup.exit_reports] == [(2, 13, 0), (2, 13, 1)]
    assert hub.spoke_exit_reports is sup.exit_reports
    # the failure logs are kept
    assert os.path.exists(os.path.join(ws.workdir, "spoke_2.log"))
    assert np.isfinite(ws.BestOuterBound)
    assert wheel_counters(ws) == {"spoke_restarts": 1, "spokes_failed": 1}
    info = json.load(open(os.path.join(ws.workdir, "pair2.info.json")))
    assert info["device"] == "cpu"
