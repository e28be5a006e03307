"""Port parity: the driver layer (`mpisppy_tpu_torch/utils/amalgamator.py`
and the vanilla extension adders) against the JAX package on the CPU.

* `--EF` on farmer-3 (tests/test_config_amalgamator.py's flags): the
  objective, the dual bound and the first-stage solution agree with
  the JAX amalgamator to 1e-6 relative.
* Cylinders mode, farmer-3, float64: tests/test_config_amalgamator.py's
  flags (Lagrangian + XhatXbar), and examples/farmer_cylinders.py's
  extension flags (Lagrangian + XhatShuffle, integer farmer, --fixer
  --use-norm-rho-updater --wtracker --primal-dual-converger): the
  bounds, the incumbent and the superstep count agree with the JAX
  amalgamator to 1e-6 relative.  Both sides build their own batch and
  prep; the port's power iterations start from the JAX PRNGKey draw
  (`ops.pdhg.normal_draw` is replaced in this module).
* The vanilla adders build the same hub dicts as the JAX ones
  (MultiExtension on the second extension).
* A module with only `scenario_creator` and a multistage module, both
  refused before the model corpus was ported, run.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpisppy_tpu.utils import amalgamator as jamalgamator
from mpisppy_tpu.utils import config as jconfig
from mpisppy_tpu.utils import vanilla as jvanilla
from mpisppy_tpu_torch.extensions import MultiExtension
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.utils import amalgamator, config, vanilla

TOL = 1e-6
# examples/_driver.py's standard_cfg groups
GROUPS = ("popular_args", "ph_args", "two_sided_args", "fwph_args",
          "lagrangian_args", "lagranger_args", "xhatlooper_args",
          "xhatshuffle_args", "xhatspecific_args", "xhatxbar_args",
          "xhatlshaped_args", "slammax_args", "slammin_args", "fixer_args",
          "gapper_args", "converger_args", "norm_rho_args", "mult_rho_args",
          "wtracker_args", "ef_args")
ARGS = {
    "ef": ["--num-scens", "3", "--EF", "--EF-solver-eps", "1e-7"],
    "wheel": ["--num-scens", "3", "--xhatxbar", "--lagrangian",
              "--max-iterations", "20", "--rel-gap", "1e-3",
              "--solver-eps", "1e-7"],
    "extensions": ["--num-scens", "3", "--lagrangian", "--xhatshuffle",
                   "--fixer", "--farmer-with-integers",
                   "--use-norm-rho-updater", "--wtracker",
                   "--primal-dual-converger", "--max-iterations", "6",
                   "--rel-gap", "1e-4", "--solver-eps", "1e-7"],
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
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


def _cfg(mod):
    cfg = mod.Config()
    for g in GROUPS:
        getattr(cfg, g)()
    return cfg


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, args in ARGS.items():
        ja = jamalgamator.from_module("mpisppy_tpu.models.farmer",
                                      _cfg(jconfig), args=args)
        ja.run()
        ta = amalgamator.from_module(farmer, _cfg(config), args=args,
                                     device="cpu")
        ta.run()
        out[name] = (ta, ja)
    return out


def test_ef_matches_jax(runs):
    ta, ja = runs["ef"]
    assert ta.is_EF and ta.wheel is None
    assert abs(ta.EF_Obj - -108390.0) < 10.0
    assert _rel(ta.EF_Obj, ja.EF_Obj) <= TOL
    assert _rel(ta.best_outer_bound, ja.best_outer_bound) <= TOL
    assert _rel(ta.first_stage_solution, ja.first_stage_solution) <= TOL
    assert ta.ef.batch.c.device.type == "cpu"


@pytest.mark.parametrize("name", ["wheel", "extensions"])
def test_cylinders_match_jax(runs, name):
    ta, ja = runs[name]
    assert not ta.is_EF
    assert abs(ta.best_inner_bound - -108390.0) < 100.0
    assert ta.best_outer_bound <= ta.best_inner_bound
    assert _rel(ta.best_inner_bound, ja.best_inner_bound) <= TOL
    assert _rel(ta.best_outer_bound, ja.best_outer_bound) <= TOL
    # the JAX batch is padded to the 8-device test mesh: its real rows
    n = ta.first_stage_solution.shape[0]
    assert _rel(ta.first_stage_solution, ja.first_stage_solution[:n]) <= TOL
    assert ta.wheel.spcomm.current_iteration() == \
        ja.wheel.spcomm.current_iteration()
    assert ta.wall_build >= 0.0 and ta.wall_run > 0.0
    assert ta.wheel.spcomm.opt.state.x.device.type == "cpu"


def test_extension_flags_are_wired(runs):
    """examples/farmer_cylinders.py's flags reach the hub: its
    MultiExtension holds the Fixer, NormRhoUpdater and the W tracker in
    flag order, the converger is polled, and the Fixer pinned slots."""
    ta, ja = runs["extensions"]
    opt, jopt = ta.wheel.spcomm.opt, ja.wheel.spcomm.opt
    assert isinstance(opt.extobject, MultiExtension)
    assert [type(e).__name__ for e in opt.extobject.extensions] == \
        [type(e).__name__ for e in jopt.extobject.extensions] == \
        ["Fixer", "NormRhoUpdater", "Wtracker_extension"]
    assert type(opt.convobject).__name__ == "PrimalDualConverger"
    assert opt.convobject.tol == 1e-2
    assert len(opt.convobject.history) == \
        len(jopt.convobject.history) == int(opt.state.it)
    assert opt.count_fixed() == jopt.count_fixed()
    assert _rel(opt.rho.numpy(), np.asarray(jopt.rho)[:3]) <= TOL


def test_adders_build_the_jax_dicts():
    names = farmer.scenario_names_creator(3)
    cfg, jcfg = _cfg(config), _cfg(jconfig)
    for c in (cfg, jcfg):
        c.parse_command_line("t", args=["--fixer-tol", "0.25",
                                        "--wtracker-wlen", "4"])
    hub = vanilla.ph_hub(cfg, None, None, names,
                         batch=farmer.build_batch(3, device="cpu"))
    jhub = jvanilla.ph_hub(jcfg, None, None, names, batch=None)
    for v, h, c in ((vanilla, hub, cfg), (jvanilla, jhub, jcfg)):
        v.add_fixer(h, c)
        v.add_multi_rho(h, c)
        v.add_norm_rho(h, c)
        v.add_wtracker(h, c)
    kw, jkw = hub["opt_kwargs"], jhub["opt_kwargs"]
    assert kw["extensions"] is MultiExtension
    assert [c.__name__ for c in kw["extension_kwargs"]["ext_classes"]] == \
        [c.__name__ for c in jkw["extension_kwargs"]["ext_classes"]] == \
        ["Fixer", "MultRhoUpdater", "NormRhoUpdater", "Wtracker_extension"]
    for key in ("fixeroptions", "mult_rho_options", "wtracker_options"):
        assert kw["options"][key] == jkw["options"][key]
    assert kw["options"]["fixeroptions"]["boundtol"] == 0.25
    # one extension stays itself
    one = vanilla.ph_hub(cfg, None, None, names)
    vanilla.add_fixer(one, cfg)
    assert one["opt_kwargs"]["extensions"].__name__ == "Fixer"


def test_device_default_and_f32_batch(monkeypatch):
    """The batch is built on the amalgamator's device; without CUDA the
    default device raises; batch_kwargs reach build_batch."""
    ama = amalgamator.from_module(farmer, _cfg(config),
                                  args=["--num-scens", "3"], device="cpu",
                                  batch_kwargs={"dtype": np.float32})
    batch, names = ama._make_batch_and_names()
    assert batch.c.dtype == torch.float32 and batch.c.device.type == "cpu"
    assert names == ["scen0", "scen1", "scen2"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        amalgamator.from_module(farmer, _cfg(config),
                                args=["--num-scens", "3"])


def _module(**attrs):
    base = dict(scenario_names_creator=farmer.scenario_names_creator,
                inparser_adder=farmer.inparser_adder,
                kw_creator=farmer.kw_creator)
    return types.SimpleNamespace(**base, **attrs)


def _sized_farmer(**kw):
    """farmer-3 as a module that sizes its own batch, as a multistage
    module does from its branching factors."""
    return farmer.build_batch(3, **kw)


@pytest.mark.parametrize("attrs", [
    {"scenario_creator": farmer.scenario_creator},
    {"build_batch": _sized_farmer, "MULTISTAGE": True}],
    ids=["scenario_creator_only", "multistage"])
def test_unported_modules_refuse(attrs):
    """The two module kinds that the amalgamator refused before the
    model corpus was ported (ROADMAP.md queue A item 9) now run: a
    module with scenario_creator only gets its batch stacked from the
    creator by the EF's SPBase, and a MULTISTAGE module's build_batch
    sizes the batch itself, its names following from it.  Both give
    farmer-3's EF."""
    ama = amalgamator.from_module(
        _module(**attrs), _cfg(config),
        args=["--num-scens", "3", "--EF", "--EF-solver-eps", "1e-7"],
        device="cpu")
    batch, names = ama._make_batch_and_names()
    assert names == ["scen0", "scen1", "scen2"]
    assert (batch is None) == ("scenario_creator" in attrs)
    ama.run()
    assert abs(ama.EF_Obj - -108390.0) < 10.0
    assert ama.ef.batch.num_scens == 3
    assert ama.ef.batch.c.device.type == "cpu"
