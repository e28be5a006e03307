"""Port parity: what crosses between the serve layers of the two
packages — drain checkpoints, `MTNETP1` wire frames, the serve gateway
itself, and the compile cache's on-disk artifacts.

* Drain checkpoints written by either package's `save_drain_checkpoint`
  are read by the other's `load_drain_checkpoint` with every array
  equal (the port maps the JAX package's pickled classes onto plain
  records and never imports it), and a port service warms from either.
* Frames: a batch or a result encoded by either package decodes in the
  other bit for bit, and the frame bytes are the same.
* A port `Gateway` serves the port's `Client` and the JAX package's
  `Client` alike; both results are bitwise equal to the port's
  `PH.ph_main`.
* Artifacts: a group's plan is saved once and loaded by a fresh cache;
  an artifact in the JAX package's byte image (its payload a serialized
  program, not a plan) is a foreign fingerprint: one load failure, then
  the plan is computed.
"""

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch import disable_tictoc_output, reenable_tictoc_output
from mpisppy_tpu_torch.convert import to_arrays
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.serve import compile_cache as cc
from mpisppy_tpu_torch.serve.net import protocol as P
from mpisppy_tpu_torch.serve.service import SolverService

FAST_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 4, "convthresh": 1e-4,
             "pdhg_eps": 1e-7, "superstep_eps": 1e-5}
NAMES3 = [f"scen{i}" for i in range(3)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    disable_tictoc_output()
    yield
    reenable_tictoc_output()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_fast():
    """The port's standalone PH.ph_main on farmer-3 with FAST_OPTS."""
    ph = PH(dict(FAST_OPTS), NAMES3,
            batch=farmer.build_batch(3, device="cpu"), device="cpu")
    conv, eobj, trivial = ph.ph_main()
    return {"conv": conv, "eobj": eobj, "xbar": ph.root_xbar().numpy()}


def _jax_batch(split=False):
    import jax

    from mpisppy_tpu.models import farmer as jfarmer
    b = jfarmer.build_batch(3, split=True) if split \
        else jfarmer.build_batch(3)
    return jax.tree_util.tree_map(np.asarray, b)


def _assert_same(port_batch, other):
    """Every array of a port batch equals the field of `other` (a JAX
    batch, or a field dict), recursively."""
    def walk(a, b, path):
        if isinstance(a, dict):
            for k, v in a.items():
                if k == "model_meta":
                    continue
                bv = b[k] if isinstance(b, dict) else getattr(b, k)
                walk(v, bv, f"{path}.{k}")
        elif isinstance(a, np.ndarray):
            assert np.array_equal(a, np.asarray(b)), path
        elif isinstance(a, (tuple, list)):
            assert tuple(a) == tuple(b), path
        else:
            assert a == b, path
    walk(to_arrays(port_batch), other, "batch")


def test_drain_checkpoints_cross_packages(tmp_path, port_fast):
    from mpisppy_tpu.resilience import checkpoint as jck

    from mpisppy_tpu_torch.resilience.checkpoint import (
        load_drain_checkpoint)
    # the JAX package's file, read by the port, and warmed from
    jpath = str(tmp_path / "jax_drain.npz")
    jck.save_drain_checkpoint(jpath, [
        {"id": 7, "options": dict(FAST_OPTS), "scenario_names": NAMES3,
         "model": "farmer", "batch": _jax_batch()}])
    got = load_drain_checkpoint(jpath)
    assert [d["id"] for d in got] == [7]
    _assert_same(got[0]["batch"], _jax_batch())
    _assert_same(farmer.build_batch(3, device="cpu"), _jax_batch())
    svc = SolverService(device="cpu")
    try:
        adopted = svc.warm_from(jpath)
        assert [sid for sid, _ in adopted] == [7]
        res = svc.result(adopted[0][1], timeout=300)
    finally:
        svc.shutdown()
    assert res["status"] == "ok" and res["eobj"] == port_fast["eobj"]
    # the port's file (a draining service's leftovers), read by the JAX
    # package and by the port
    svc = SolverService(device="cpu")
    b_split = farmer.build_batch(3, device="cpu", split=True)
    svc.submit(farmer.build_batch(3, device="cpu"), FAST_OPTS,
               scenario_names=NAMES3, model="farmer")
    svc.submit(b_split, FAST_OPTS, model="farmer")
    info = svc.drain(deadline=0.1, checkpoint_path=str(tmp_path / "p"))
    assert info["drained"] == 2
    theirs = jck.load_drain_checkpoint(info["checkpoint"])
    assert [d["model"] for d in theirs] == ["farmer", "farmer"]
    _assert_same(farmer.build_batch(3, device="cpu"), theirs[0]["batch"])
    _assert_same(b_split, theirs[1]["batch"])
    _assert_same(b_split, _jax_batch(split=True))
    ours = load_drain_checkpoint(info["checkpoint"])
    _assert_same(b_split, to_arrays(ours[1]["batch"]))
    assert ours[0]["scenario_names"] == NAMES3
    # a torn file is a structured reject, never a half-warmed service
    bad = tmp_path / "bad.npz"
    bad.write_bytes(open(info["checkpoint"], "rb").read()[:200])
    svc = SolverService(device="cpu")
    out = svc.warm_from(str(bad))
    svc.shutdown()
    assert out["status"] == "failed"
    assert out["reason"] == "corrupt_drain_checkpoint"


def test_mtnetp1_frames_cross_packages():
    from mpisppy_tpu.serve.net import protocol as JP
    for split in (False, True):
        ours = farmer.build_batch(3, device="cpu", split=split)
        theirs = _jax_batch(split=split)
        # port-encoded -> JAX-decoded, and back
        _assert_same(ours, JP.decode_batch(P.encode_batch(ours)))
        rt = P.decode_batch(JP.encode_batch(theirs))
        _assert_same(rt, theirs)
        assert rt.tree.stage_of == tuple(theirs.tree.stage_of)
        assert rt.model_meta["A_delta_idx"][0].tolist() \
            == list(theirs.model_meta["A_delta_idx"][0])
        assert P.encode_batch(ours) == JP.encode_batch(theirs)
    res = {"status": "ok", "conv": 1.2345678901234567e-7,
           "eobj": -108390.0703125, "iterations": 9,
           "xbar": np.array([170.0, 80.0, 250.0]), "reason": None}
    for enc, dec in ((P.encode_result, JP.decode_result),
                     (JP.encode_result, P.decode_result)):
        hdr, payload = enc(res)
        out = dec(hdr, payload)
        assert out["conv"] == res["conv"] and out["eobj"] == res["eobj"]
        assert np.array_equal(out["xbar"], res["xbar"])
    hdr = {"kind": "request", "verb": "health", "token": "t"}
    assert P.pack_message(hdr, b"xy") == JP.pack_message(hdr, b"xy")
    assert P.ERROR_CODES == JP.ERROR_CODES


def test_gateway_serves_either_packages_client(port_fast):
    from mpisppy_tpu.serve.net.client import Client as JaxClient

    from mpisppy_tpu_torch.serve.net.client import Client
    from mpisppy_tpu_torch.serve.net.gateway import Gateway
    gw = Gateway({"serve_replicas": 1, "router_hedge_threshold": None},
                 device="cpu").start()
    try:
        with Client(*gw.address) as c:
            mine = c.solve(farmer.build_batch(3, device="cpu"), FAST_OPTS,
                           scenario_names=NAMES3, model="farmer",
                           timeout=300)
        with JaxClient(*gw.address) as c:
            theirs = c.solve(_jax_batch(), FAST_OPTS,
                             scenario_names=NAMES3, model="farmer",
                             timeout=300)
    finally:
        gw.shutdown()
        gw.router.shutdown(timeout=10)
    for res in (mine, theirs):
        assert res["status"] == "ok"
        assert res["conv"] == port_fast["conv"]
        assert res["eobj"] == port_fast["eobj"]
        assert np.array_equal(res["xbar"], port_fast["xbar"])


def test_group_plans_persist_and_refuse_foreign_artifacts(tmp_path,
                                                          monkeypatch):
    from mpisppy_tpu.serve import compile_cache as jcc

    from mpisppy_tpu_torch.serve.service import stack_superstep_args
    monkeypatch.setenv("MPISPPY_TPU_COMPILE_CACHE_DIR", str(tmp_path))
    phs = []
    for _ in range(2):
        ph = PH(dict(FAST_OPTS), NAMES3,
                batch=farmer.build_batch(3, device="cpu"), device="cpu")
        ph.Iter0()
        phs.append(ph)
    args = stack_superstep_args(phs)
    cache = cc.CompileCache()
    run = cache.get(phs[0].batch, FAST_OPTS,
                    model="farmer").batched_superstep(args)
    assert run.plan["form"] == "split" and run.plan["variant"] is None
    assert run.plan["shape"] == [6, 7, 12]
    assert cache.stats()["aot_saves"] == 1
    files = list((tmp_path / "aot").glob("*.mtaot"))
    assert len(files) == 1
    fresh = cc.CompileCache()
    again = fresh.get(phs[0].batch, FAST_OPTS,
                      model="farmer").batched_superstep(args)
    assert again.plan == run.plan
    assert fresh.stats()["aot_loads"] == 1
    assert fresh.stats()["aot_saves"] == 0
    out = again(args)
    assert out.it == (1, 1) and out.conv.shape == (2,)
    # the JAX package's artifact under the port's name: foreign
    fp = files[0].name[:-len(".mtaot")]
    files[0].write_bytes(jcc._aot_encode(fp, 2, b"serialized program"))
    foreign = cc.CompileCache()
    plan = foreign.get(phs[0].batch, FAST_OPTS,
                       model="farmer").batched_superstep(args).plan
    st = foreign.stats()
    assert st["aot_load_failures"] == 1 and st["aot_loads"] == 0
    assert plan == run.plan and st["aot_saves"] == 1
    cc.clear_prewarmed()
    (tmp_path / "aot" / "junk.mtaot").write_bytes(
        jcc._aot_encode("junk", 2, b"serialized program"))
    assert cc.prewarm() == 1             # ours loads, the JAX one not
    cc.clear_prewarmed()
