"""Layering guards of the PyTorch/CUDA port.

* An AST scan: no file under `mpisppy_tpu_torch/`, and not
  `chip_smoke.py`, imports `jax` or anything of the JAX package
  `mpisppy_tpu` (the port's own name starts with `mpisppy_tpu`, so the
  check is on whole module components, not on a prefix).
* A fresh interpreter runs the port's farmer PH and a farmer-3
  interleaved wheel (PH hub, Lagrangian and XhatShuffle spokes, built
  through `utils/config` and `utils/vanilla`) on the CPU, with telemetry
  into a dir (`telemetry/`, `log.py`) and converged-scenario compaction
  on, imports every module of `extensions/` and `convergers/`, runs
  `utils/amalgamator` in EF mode, imports every module of `models/`,
  runs hydro's EF through the amalgamator's multistage path and its
  scenario_creator through SPBase, imports L-shaped, APH, FWPH, their
  cylinders and the bundle modules, runs the Schur-complement IPM and
  PH on bundles, and finds no `jax` and no `mpisppy_tpu.*` module
  loaded.
* A spoke process (`python -m mpisppy_tpu_torch.cylinders.proc`, as
  multiproc mode spawns it) loads no `jax` and no `mpisppy_tpu.*`
  module either, and the spec resolver refuses a module path outside
  the port.
* No silent CPU: without CUDA, the entry points' default device raises.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch import convert, device
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.ph import PH

ROOT = Path(__file__).resolve().parents[1]


def _forbidden(mod):
    head = mod.split(".")[0]
    return head in ("jax", "jaxlib", "mpisppy_tpu")


def _port_files():
    return sorted((ROOT / "mpisppy_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_ast_no_jax_or_jax_package_imports():
    bad = []
    files = _port_files()
    assert len(files) > 10
    # every subpackage of the port is scanned, the wheel's too
    scanned = {p.relative_to(ROOT).parts[1] for p in files
               if p.parent != ROOT}
    assert {"cylinders", "resilience", "utils", "ops", "opt",
            "models", "telemetry", "extensions", "convergers",
            "fwph", "runtime"} <= scanned
    assert ROOT / "mpisppy_tpu_torch" / "spin_the_wheel.py" in files
    assert ROOT / "mpisppy_tpu_torch" / "log.py" in files
    assert {p.name for p in files if p.parent.name == "telemetry"} == {
        "__init__.py", "metrics.py", "tracer.py", "export.py"}
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {m}" for m in mods
                    if _forbidden(m)]
    assert bad == []
    assert not _forbidden("mpisppy_tpu_torch.ops.pdhg")
    assert _forbidden("mpisppy_tpu.ops.pdhg") and _forbidden("jax.numpy")


_DRIVE = """
import json, os, sys, tempfile
from mpisppy_tpu_torch import disable_tictoc_output, telemetry
from mpisppy_tpu_torch.log import global_toc_logger
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.opt.ph import PH
disable_tictoc_output()
tdir = tempfile.mkdtemp()
global_toc_logger(out=os.path.join(tdir, "toc.log"))
ph = PH({"defaultPHrho": 1.0, "PHIterLimit": 5, "convthresh": 0.0,
         "pdhg_eps": 1e-6, "pdhg_compact_threshold": 0.9,
         "telemetry": {"dir": tdir}}, ["s0", "s1", "s2"],
        batch=farmer.build_batch(3, device="cpu"), device="cpu")
conv, eobj, triv = ph.ph_main()
ph.evaluate_xhat(ph.root_xbar())
ph.lagrangian_bound()
traj = ph.pdhg_stats()["active_fraction_traj"]

from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.utils import config, vanilla
cfg = config.Config()
for g in ("popular_args", "ph_args", "two_sided_args", "lagrangian_args",
          "xhatshuffle_args"):
    getattr(cfg, g)()
farmer.inparser_adder(cfg)
cfg.parse_command_line("wheel", args=[
    "--num-scens", "3", "--lagrangian", "--xhatshuffle",
    "--max-iterations", "4"])
names = farmer.scenario_names_creator(3)
b = farmer.build_batch(3, device="cpu")
hub = vanilla.ph_hub(cfg, farmer.scenario_creator, None, names, batch=b)
hub["opt_kwargs"]["device"] = "cpu"
spokes = vanilla.build_spokes(cfg, farmer.scenario_creator, None, names,
                              batch=b)
for d in [hub] + spokes:
    d["opt_kwargs"]["options"]["telemetry"] = {"dir": tdir}
ws = WheelSpinner(hub, spokes).spin()

import importlib, pkgutil
import mpisppy_tpu_torch.convergers, mpisppy_tpu_torch.extensions
for pkg in (mpisppy_tpu_torch.extensions, mpisppy_tpu_torch.convergers):
    for info in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"{pkg.__name__}.{info.name}")
from mpisppy_tpu_torch.utils import amalgamator, gradient, wtracker, wxbarutils
acfg = config.Config()
for g in ("popular_args", "ph_args", "ef_args"):
    getattr(acfg, g)()
ama = amalgamator.from_module(farmer, acfg, args=["--num-scens", "3",
                              "--EF"], device="cpu").run()
import mpisppy_tpu_torch.models
for info in pkgutil.iter_modules(mpisppy_tpu_torch.models.__path__):
    importlib.import_module(f"mpisppy_tpu_torch.models.{info.name}")
from mpisppy_tpu_torch import model, scenario_tree
from mpisppy_tpu_torch.models import hydro
from mpisppy_tpu_torch.opt import mip
from mpisppy_tpu_torch.spbase import SPBase
hcfg = config.Config()
for g in ("popular_args", "ph_args", "ef_args"):
    getattr(hcfg, g)()
hama = amalgamator.from_module(hydro, hcfg, args=["--branching-factors",
                               "3,3", "--EF"], device="cpu").run()
sb = SPBase({}, hydro.scenario_names_creator(9),
            scenario_creator=hydro.scenario_creator,
            scenario_creator_kwargs={"branching_factors": [3, 3]},
            device="cpu")
# the remaining algorithms: import each; run the Schur-complement IPM
# and a bundled PH iteration
from mpisppy_tpu_torch.cylinders import fwph_spoke, lshaped_bounder
from mpisppy_tpu_torch.fwph import fwph
from mpisppy_tpu_torch.opt import aph, lshaped, sc
from mpisppy_tpu_torch.utils import bundles, pickle_bundle
sc_obj, _ = sc.SchurComplement({}, ["s0", "s1", "s2"],
                               batch=farmer.build_batch(3, device="cpu"),
                               device="cpu").solve()
bph = PH({"PHIterLimit": 1}, ["b0", "b1"], batch=bundles.bundle_batch(
    farmer.build_batch(4, device="cpu"), 2), device="cpu")
bph.ph_main()
with open(os.path.join(tdir, "trace.json")) as f:
    rows = [e["args"]["name"] for e in json.load(f)["traceEvents"]
            if e["ph"] == "M"]
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "mpisppy_tpu"))
wheel = sorted(m for m in sys.modules
               if m.startswith(("mpisppy_tpu_torch.cylinders.",
                                "mpisppy_tpu_torch.fwph.",
                                "mpisppy_tpu_torch.resilience.",
                                "mpisppy_tpu_torch.utils.",
                                "mpisppy_tpu_torch.extensions.",
                                "mpisppy_tpu_torch.convergers.",
                                "mpisppy_tpu_torch.models.",
                                "mpisppy_tpu_torch.model",
                                "mpisppy_tpu_torch.scenario_tree",
                                "mpisppy_tpu_torch.opt.")))
print(json.dumps({"loaded": loaded, "eobj": eobj, "wheel": wheel,
                  "ef_obj": ama.EF_Obj, "hydro_ef": hama.EF_Obj,
                  "hydro_nodes": sb.batch.tree.num_nodes,
                  "sc_obj": sc_obj,
                  "bounds": [ws.BestOuterBound, ws.BestInnerBound],
                  "traj": traj, "rows": rows,
                  "traffic": telemetry.traffic_counters()}))
"""


def test_fresh_interpreter_port_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _DRIVE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert np.isfinite(res["eobj"])
    assert {"mpisppy_tpu_torch.cylinders.hub",
            "mpisppy_tpu_torch.resilience.bounds",
            "mpisppy_tpu_torch.utils.vanilla",
            "mpisppy_tpu_torch.utils.amalgamator",
            "mpisppy_tpu_torch.extensions.fixer",
            "mpisppy_tpu_torch.extensions.xhatter",
            "mpisppy_tpu_torch.convergers.primal_dual_converger"} <= set(
                res["wheel"])
    assert abs(res["ef_obj"] - -108390.0) < 10.0
    # the model corpus, the creator path and the multistage path
    assert {f"mpisppy_tpu_torch.models.{m}" for m in (
        "hydro", "aircond", "aircondB", "acopf3", "sizes", "apl1p",
        "battery", "netdes", "gbd", "usar")} | {
        "mpisppy_tpu_torch.model", "mpisppy_tpu_torch.scenario_tree",
        "mpisppy_tpu_torch.opt.mip"} <= set(res["wheel"])
    assert abs(res["hydro_ef"] - 186.17) < 0.01
    # the remaining algorithms (ROADMAP.md queue A item 10)
    assert {f"mpisppy_tpu_torch.{m}" for m in (
        "opt.lshaped", "opt.aph", "opt.sc", "fwph.fwph",
        "cylinders.lshaped_bounder", "cylinders.fwph_spoke",
        "utils.bundles", "utils.pickle_bundle")} <= set(res["wheel"])
    assert abs(res["sc_obj"] - -108390.0) < 1.0
    assert res["hydro_nodes"] == 4
    outer, inner = res["bounds"]
    assert np.isfinite(outer) and np.isfinite(inner) and outer <= inner
    assert res["traj"] and res["traj"][-1]["active"] == 0
    assert len(res["rows"]) == 3 and "hub" in res["rows"]
    assert res["traffic"]["window_writes"] > 0


def test_no_silent_cpu_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        farmer.build_batch(3)
    b = farmer.build_batch(3, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PH({"PHIterLimit": 1}, ["s0", "s1", "s2"], batch=b)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.prep_from_arrays({})
    assert device.resolve_device("cpu").type == "cpu"


def test_unported_options_refuse():
    """The options once refused (queue A item 6) now work:
    run_checkpoint writes, resume_from restores (a missing file starts
    fresh), chaos arms the injector."""
    import tempfile
    b = farmer.build_batch(3, device="cpu")
    ck = os.path.join(tempfile.mkdtemp(), "run")
    ph = PH({"PHIterLimit": 1, "run_checkpoint": ck,
             "resume_from": ck + "_absent",
             "chaos": {"crash_at_iter": 99}}, ["s0", "s1", "s2"],
            batch=b, device="cpu")
    assert ph._chaos.active
    ph.ph_main(finalize=False)
    assert os.path.exists(ck + ".npz")
    r = PH({"PHIterLimit": 1, "resume_from": ck}, ["s0", "s1", "s2"],
           batch=b, device="cpu")
    r.ph_main(finalize=False)
    assert int(r.state.it) == 1
    np.testing.assert_array_equal(r.state.W.numpy(), ph.state.W.numpy())
    # ph_converger is ported: the option builds the converger
    from mpisppy_tpu_torch.convergers.norm_rho_converger import (
        NormRhoConverger)
    assert isinstance(PH({"ph_converger": NormRhoConverger},
                         ["s0", "s1", "s2"], batch=b,
                         device="cpu").convobject, NormRhoConverger)
    # telemetry is ported: the option configures the handle
    assert PH({"telemetry": "on"}, ["s0", "s1", "s2"], batch=b,
              device="cpu")._tel.enabled
    # variable_probability is ported: the option sets batch.var_prob
    vp = np.full((3, 3), 1.0 / 3.0)
    ph = PH({}, ["s0", "s1", "s2"], batch=b, device="cpu",
            variable_probability=vp)
    np.testing.assert_array_equal(ph.batch.var_prob.numpy(), vp)
    # the scenario_creator path is ported: without a batch the creator
    # is required
    with pytest.raises(ValueError, match="batch or a scenario_creator"):
        PH({}, ["s0", "s1", "s2"], device="cpu")


def test_spoke_process_loads_no_jax(tmp_path):
    """A spoke process, spawned as multiproc mode spawns it, attaches
    to its windows, sees the kill signal, ends cleanly and reports its
    device and the forbidden modules it loaded (none)."""
    from mpisppy_tpu_torch.cylinders import proc
    from mpisppy_tpu_torch.cylinders.spcommunicator import WindowPair
    prefix = str(tmp_path / "pair0")
    pair = WindowPair(9, 1, backend="native", path_prefix=prefix)
    pair.to_spoke.send_kill()
    spec = {"batch": {"module": "mpisppy_tpu_torch.models.farmer",
                      "builder": "build_batch", "kwargs": {"num_scens": 3}},
            "opt_class": "mpisppy_tpu_torch.utils.xhat_eval:Xhat_Eval",
            "spoke_class": "mpisppy_tpu_torch.cylinders."
                           "xhatshufflelooper_bounder:XhatShuffleInnerBound",
            "scenario_names": ["s0", "s1", "s2"], "device": "cpu",
            "windows": {"prefix": prefix, "hub_length": 9,
                        "spoke_length": 1}}
    p = proc.spawn_spoke(spec, str(tmp_path), "0")
    assert p.wait(timeout=120) == 0, open(p.log_path).read()
    info = json.load(open(prefix + ".info.json"))
    assert info == {"device": "cpu", "pid": p.pid,
                    "forbidden_modules": [], "kernel_launches": []}
    # the spec resolver refuses a path outside the port
    for path in ("mpisppy_tpu.models.farmer:build_batch",
                 "jax.numpy:zeros", "mpisppy_tpu_torchx.m:f"):
        with pytest.raises(ValueError, match="outside mpisppy_tpu_torch"):
            proc._resolve(path)
    bad = dict(spec, batch=dict(spec["batch"],
                                module="mpisppy_tpu.models.farmer"))
    spec_file = tmp_path / "bad.json"
    spec_file.write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="outside mpisppy_tpu_torch"):
        proc.run_spoke_from_spec(str(spec_file))
    pair.to_spoke.close()
    pair.to_hub.close()
