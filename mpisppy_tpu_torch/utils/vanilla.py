"""vanilla — hub and spoke dict factories from a Config (port of
`mpisppy_tpu/utils/vanilla.py`, the counterpart of the reference's
cfg_vanilla.py).

Each factory returns the dict schema WheelSpinner consumes, with the
reference's signature (cfg, scenario_creator, scenario_denouement,
all_scenario_names, ...) plus `batch=`, a prebuilt ScenarioBatch; with
`batch=None` each optimizer's SPBase stacks the scenarios from
`scenario_creator`.  On the CPU put `device="cpu"` into the returned
dicts' `opt_kwargs` (the hub's device is the spokes' default).

The extension adders (`extension_adder`, `add_fixer`, `add_norm_rho`,
`add_multi_rho`, `add_wtracker`) attach `extensions/` classes to a hub
dict.  Each spoke factory resolves its own `{root}_solver_*` options
through `utils/solver_spec.py` (FWPH's root is `fwph`).
"""

from __future__ import annotations

import json

from ..cylinders.fwph_spoke import FrankWolfeOuterBound
from ..cylinders.hub import APHHub, LShapedHub, PHHub
from ..cylinders.lagranger_bounder import LagrangerOuterBound
from ..cylinders.lagrangian_bounder import LagrangianOuterBound
from ..cylinders.lshaped_bounder import XhatLShapedInnerBound
from ..cylinders.slam_heuristic import SlamMaxHeuristic, SlamMinHeuristic
from ..cylinders.xhatlooper_bounder import XhatLooperInnerBound
from ..cylinders.xhatshufflelooper_bounder import XhatShuffleInnerBound
from ..cylinders.xhatspecific_bounder import XhatSpecificInnerBound
from ..cylinders.xhatxbar_bounder import XhatXbarInnerBound
from ..fwph.fwph import FWPH
from ..opt.aph import APH
from ..opt.lshaped import LShapedMethod
from ..opt.ph import PH
from .solver_spec import solver_specification
from .xhat_eval import Xhat_Eval


def shared_options(cfg):
    return cfg.options_dict()


def _opt_kwargs(cfg, scenario_creator, scenario_denouement,
                all_scenario_names, scenario_creator_kwargs=None,
                batch=None, rho_setter=None, all_nodenames=None,
                extensions=None, extension_kwargs=None, extra=None,
                solver_root=None):
    opts = shared_options(cfg)
    if solver_root:
        # the per-cylinder kernel-knob cascade: the cylinder's own root,
        # then the unprefixed options
        _, sopts = solver_specification(cfg, [solver_root, ""],
                                        name_required=False)
        opts.update(sopts)
    if extra:
        opts.update(extra)
    kw = dict(options=opts,
              all_scenario_names=all_scenario_names,
              scenario_creator=scenario_creator,
              scenario_denouement=scenario_denouement,
              scenario_creator_kwargs=scenario_creator_kwargs,
              batch=batch)
    if rho_setter is not None:
        kw["rho_setter"] = rho_setter
    if all_nodenames is not None:
        kw["all_nodenames"] = all_nodenames
    if extensions is not None:
        kw["extensions"] = extensions
        kw["extension_kwargs"] = extension_kwargs
    return kw


def _hub_options(cfg):
    o = {}
    for k in ("rel_gap", "abs_gap", "max_stalled_iters"):
        if cfg.get(k) is not None:
            o[k] = cfg[k]
    o["convthresh"] = cfg.get("convthresh", 1e-4)
    return o


def ph_hub(cfg, scenario_creator, scenario_denouement,
           all_scenario_names, scenario_creator_kwargs=None,
           ph_extensions=None, extension_kwargs=None, rho_setter=None,
           all_nodenames=None, batch=None):
    return {
        "hub_class": PHHub,
        "hub_kwargs": {"options": _hub_options(cfg)},
        "opt_class": PH,
        "opt_kwargs": _opt_kwargs(
            cfg, scenario_creator, scenario_denouement,
            all_scenario_names, scenario_creator_kwargs, batch,
            rho_setter, all_nodenames, ph_extensions, extension_kwargs),
    }


def aph_hub(cfg, scenario_creator, scenario_denouement,
            all_scenario_names, scenario_creator_kwargs=None,
            ph_extensions=None, extension_kwargs=None, rho_setter=None,
            all_nodenames=None, batch=None):
    """ph_hub with APH as the hub's algorithm."""
    d = ph_hub(cfg, scenario_creator, scenario_denouement,
               all_scenario_names, scenario_creator_kwargs,
               ph_extensions, extension_kwargs, rho_setter,
               all_nodenames, batch)
    d["hub_class"] = APHHub
    d["opt_class"] = APH
    return d


def lshaped_hub(cfg, scenario_creator, scenario_denouement,
                all_scenario_names, scenario_creator_kwargs=None,
                batch=None):
    """L-shaped as the hub: max_iter from --max-iterations, tol from
    --convthresh."""
    opts = shared_options(cfg)
    opts.update({"max_iter": cfg.get("max_iterations", 50),
                 "tol": cfg.get("convthresh", 1e-6)})
    return {
        "hub_class": LShapedHub,
        "hub_kwargs": {"options": _hub_options(cfg)},
        "opt_class": LShapedMethod,
        "opt_kwargs": dict(options=opts,
                           all_scenario_names=all_scenario_names,
                           scenario_creator=scenario_creator,
                           scenario_creator_kwargs=scenario_creator_kwargs,
                           batch=batch),
    }


def _spoke(spoke_class, opt_class, cfg, scenario_creator,
           scenario_denouement, all_scenario_names,
           scenario_creator_kwargs=None, batch=None, extra=None,
           spoke_options=None, all_nodenames=None, solver_root=None):
    if solver_root is None:
        # "LagrangianOuterBound" -> "lagrangian", etc.
        solver_root = spoke_class.__name__.replace(
            "OuterBound", "").replace("InnerBound", "").replace(
            "Heuristic", "").lower()
    return {
        "spoke_class": spoke_class,
        "spoke_kwargs": {"options": spoke_options or {}},
        "opt_class": opt_class,
        "opt_kwargs": _opt_kwargs(
            cfg, scenario_creator, scenario_denouement,
            all_scenario_names, scenario_creator_kwargs, batch,
            all_nodenames=all_nodenames, extra=extra,
            solver_root=solver_root),
    }


def fwph_spoke(cfg, scenario_creator, scenario_denouement,
               all_scenario_names, scenario_creator_kwargs=None,
               batch=None):
    # explicit root: the derived name would be 'frankwolfe', but the
    # flag convention (fwph_solver_*) uses 'fwph'
    return _spoke(FrankWolfeOuterBound, FWPH, cfg, scenario_creator,
                  scenario_denouement, all_scenario_names,
                  scenario_creator_kwargs, batch, solver_root="fwph")


def lagrangian_spoke(cfg, scenario_creator, scenario_denouement,
                     all_scenario_names, scenario_creator_kwargs=None,
                     rho_setter=None, batch=None):
    return _spoke(LagrangianOuterBound, PH, cfg, scenario_creator,
                  scenario_denouement, all_scenario_names,
                  scenario_creator_kwargs, batch)


def lagranger_spoke(cfg, scenario_creator, scenario_denouement,
                    all_scenario_names, scenario_creator_kwargs=None,
                    rho_setter=None, batch=None):
    extra = {}
    if cfg.get("lagranger_rho_rescale_factors_json"):
        with open(cfg["lagranger_rho_rescale_factors_json"]) as f:
            extra["lagranger_rho_rescale_factors"] = {
                int(k): v for k, v in json.load(f).items()}
    return _spoke(LagrangerOuterBound, PH, cfg, scenario_creator,
                  scenario_denouement, all_scenario_names,
                  scenario_creator_kwargs, batch, extra=extra)


def xhatlooper_spoke(cfg, scenario_creator, scenario_denouement,
                     all_scenario_names, scenario_creator_kwargs=None,
                     batch=None):
    return _spoke(XhatLooperInnerBound, Xhat_Eval, cfg,
                  scenario_creator, scenario_denouement,
                  all_scenario_names, scenario_creator_kwargs, batch,
                  spoke_options={"scen_limit":
                                 cfg.get("xhat_scen_limit", 3)})


def xhatshuffle_spoke(cfg, scenario_creator, scenario_denouement,
                      all_scenario_names, scenario_creator_kwargs=None,
                      all_nodenames=None, batch=None):
    return _spoke(XhatShuffleInnerBound, Xhat_Eval, cfg,
                  scenario_creator, scenario_denouement,
                  all_scenario_names, scenario_creator_kwargs, batch,
                  all_nodenames=all_nodenames,
                  spoke_options={"reverse":
                                 cfg.get("add_reversed_shuffle", False)})


def xhatspecific_spoke(cfg, scenario_creator, scenario_denouement,
                       all_scenario_names, scenario_dict=None,
                       scenario_creator_kwargs=None, all_nodenames=None,
                       batch=None):
    return _spoke(XhatSpecificInnerBound, Xhat_Eval, cfg,
                  scenario_creator, scenario_denouement,
                  all_scenario_names, scenario_creator_kwargs, batch,
                  all_nodenames=all_nodenames,
                  spoke_options={"xhat_scenario_dict":
                                 scenario_dict or {}})


def xhatxbar_spoke(cfg, scenario_creator, scenario_denouement,
                   all_scenario_names, scenario_creator_kwargs=None,
                   batch=None):
    return _spoke(XhatXbarInnerBound, Xhat_Eval, cfg, scenario_creator,
                  scenario_denouement, all_scenario_names,
                  scenario_creator_kwargs, batch)


def xhatlshaped_spoke(cfg, scenario_creator, scenario_denouement,
                      all_scenario_names, scenario_creator_kwargs=None,
                      batch=None):
    return _spoke(XhatLShapedInnerBound, Xhat_Eval, cfg,
                  scenario_creator, scenario_denouement,
                  all_scenario_names, scenario_creator_kwargs, batch)


def slammax_spoke(cfg, scenario_creator, scenario_denouement,
                  all_scenario_names, scenario_creator_kwargs=None,
                  batch=None):
    return _spoke(SlamMaxHeuristic, Xhat_Eval, cfg, scenario_creator,
                  scenario_denouement, all_scenario_names,
                  scenario_creator_kwargs, batch)


def slammin_spoke(cfg, scenario_creator, scenario_denouement,
                  all_scenario_names, scenario_creator_kwargs=None,
                  batch=None):
    return _spoke(SlamMinHeuristic, Xhat_Eval, cfg, scenario_creator,
                  scenario_denouement, all_scenario_names,
                  scenario_creator_kwargs, batch)


def build_spokes(cfg, scenario_creator, scenario_denouement,
                 all_scenario_names, scenario_creator_kwargs=None,
                 batch=None, all_nodenames=None, scenario_dict=None):
    """The flag-driven spoke list (the one home of the cfg-flag ->
    factory dispatch)."""
    sk = scenario_creator_kwargs
    args = (cfg, scenario_creator, scenario_denouement,
            all_scenario_names)
    spokes = []
    if cfg.get("fwph"):
        spokes.append(fwph_spoke(*args, sk, batch=batch))
    if cfg.get("lagrangian"):
        spokes.append(lagrangian_spoke(*args, sk, batch=batch))
    if cfg.get("lagranger"):
        spokes.append(lagranger_spoke(*args, sk, batch=batch))
    if cfg.get("xhatlooper"):
        spokes.append(xhatlooper_spoke(*args, sk, batch=batch))
    if cfg.get("xhatshuffle"):
        spokes.append(xhatshuffle_spoke(*args, sk,
                                        all_nodenames=all_nodenames,
                                        batch=batch))
    if cfg.get("xhatspecific"):
        spokes.append(xhatspecific_spoke(*args,
                                         scenario_dict=scenario_dict,
                                         scenario_creator_kwargs=sk,
                                         all_nodenames=all_nodenames,
                                         batch=batch))
    if cfg.get("xhatxbar"):
        spokes.append(xhatxbar_spoke(*args, sk, batch=batch))
    if cfg.get("xhatlshaped"):
        spokes.append(xhatlshaped_spoke(*args, sk, batch=batch))
    if cfg.get("slammax"):
        spokes.append(slammax_spoke(*args, sk, batch=batch))
    if cfg.get("slammin"):
        spokes.append(slammin_spoke(*args, sk, batch=batch))
    return spokes


def extension_adder(hub_dict, ext_class, ext_kwargs=None):
    """Attach an extension class to a hub dict (the reference's
    cfg_vanilla.py:164); the second one promotes to MultiExtension."""
    from ..extensions import MultiExtension
    kw = hub_dict["opt_kwargs"]
    cur = kw.get("extensions")
    if cur is None:
        kw["extensions"] = ext_class
        kw["extension_kwargs"] = ext_kwargs
    elif cur is MultiExtension:
        kw["extension_kwargs"]["ext_classes"].append(ext_class)
    else:
        kw["extensions"] = MultiExtension
        kw["extension_kwargs"] = {"ext_classes": [cur, ext_class]}
    return hub_dict


def add_fixer(hub_dict, cfg):
    """The Fixer with the cfg's tolerance and count (the reference's
    cfg_vanilla.py:184)."""
    from ..extensions.fixer import Fixer
    hub_dict["opt_kwargs"]["options"]["fixeroptions"] = {
        "boundtol": cfg.get("fixer_tol", 1e-2),
        "nb": cfg.get("fixer_nb", 3)}
    return extension_adder(hub_dict, Fixer)


def add_multi_rho(hub_dict, cfg):
    from ..extensions.mult_rho_updater import MultRhoUpdater
    hub_dict["opt_kwargs"]["options"]["mult_rho_options"] = {
        "convergence_tolerance":
            cfg.get("mult_rho_convergence_tolerance", 1e-4),
        "rho_update_stop_iteration":
            cfg.get("mult_rho_update_stop_iteration"),
        "rho_update_start_iteration":
            cfg.get("mult_rho_update_start_iteration", 2)}
    return extension_adder(hub_dict, MultRhoUpdater)


def add_norm_rho(hub_dict, cfg):
    from ..extensions.norm_rho_updater import NormRhoUpdater
    return extension_adder(hub_dict, NormRhoUpdater)


def add_wtracker(hub_dict, cfg):
    from ..extensions.wtracker_extension import Wtracker_extension
    hub_dict["opt_kwargs"]["options"]["wtracker_options"] = {
        "wlen": cfg.get("wtracker_wlen", 10)}
    return extension_adder(hub_dict, Wtracker_extension)
