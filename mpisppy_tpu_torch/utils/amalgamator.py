"""Amalgamator — one-call driver from a model module and a Config (port
of `mpisppy_tpu/utils/amalgamator.py`).

Module contract: the model module exports
    scenario_names_creator(num_scens, start=0)
    build_batch(num_scens, **kw)  OR  scenario_creator(name, **kw)
                                        (either with a `device=` keyword)
    inparser_adder(cfg)
    kw_creator(cfg) -> keyword arguments of the builder or creator
`build_batch` is preferred where both exist.  A `MULTISTAGE` module's
`build_batch(**kw)`, and one whose `build_batch` takes no `num_scens`
(aircondB: bundles of a tree), sizes the tree itself from the
branching factors that `kw_creator` parses from `--branching-factors`;
the scenario names are the batch's own.  (The JAX package passes
aircondB a positional scenario count, which its `build_batch` refuses
with a TypeError.)  A module with `scenario_creator` only
gets its batch built once by the hub's SPBase (one creator call per
scenario name, stacked), and every spoke shares it.

Dispatch: `--EF` solves the extensive form in one consensus solve
(`opt/ef.ExtensiveForm`); otherwise a WheelSpinner is built from the
cfg flags through the vanilla factories, with the extension and
converger flags wired onto the hub (--fixer, --use-norm-rho-updater,
--mult-rho, --wtracker, the W/x̄ files, --primal-dual-converger,
--use-norm-rho-converger).

The batch is built on `device` (default: the CUDA device), and every
cylinder runs there.  `batch_kwargs` adds keyword arguments of the
builder or creator that no flag carries (e.g. dtype=np.float32).
`run()` records `wall_build` (the batch; for a creator module the
stacking happens inside the solve's construction and counts in
`wall_run`) and `wall_run` (the solve).
"""

from __future__ import annotations

import importlib
import inspect
import time

from .. import global_toc
from ..device import host, resolve_device
from ..opt.ef import ExtensiveForm
from ..spin_the_wheel import WheelSpinner
from . import vanilla
from .config import Config


def from_module(mname, cfg, extraargs_fct=None, use_command_line=True,
                args=None, progname=None, device=None, batch_kwargs=None):
    """An Amalgamator for model module `mname` (a module or its dotted
    name).  Declares the module's flags on cfg and optionally parses
    the command line (argparse prog = `progname`, default the module
    name)."""
    m = mname if not isinstance(mname, str) else importlib.import_module(
        mname)
    for needed in ("scenario_names_creator", "inparser_adder",
                   "kw_creator"):
        if not hasattr(m, needed):
            raise RuntimeError(
                f"module {getattr(m, '__name__', m)} missing {needed} "
                "(amalgamator module contract)")
    if not (hasattr(m, "build_batch") or hasattr(m, "scenario_creator")):
        raise RuntimeError("module needs build_batch or scenario_creator")
    m.inparser_adder(cfg)
    if extraargs_fct is not None:
        extraargs_fct(cfg)
    if use_command_line:
        cfg.parse_command_line(
            progname or getattr(m, "__name__", "amalgamator"),
            args=args)
    return Amalgamator(cfg, m, device=device, batch_kwargs=batch_kwargs)


class Amalgamator:
    def __init__(self, cfg: Config, module, device=None,
                 batch_kwargs=None):
        self.cfg = cfg
        self.module = module
        self.device = resolve_device(device)
        self.batch_kwargs = dict(batch_kwargs or {})
        self.is_EF = bool(cfg.get("EF", False)) or bool(
            cfg.get("EF_2stage", False)) or bool(
            cfg.get("EF_mstage", False))
        self.best_inner_bound = None
        self.best_outer_bound = None
        self.EF_Obj = None
        self.first_stage_solution = None
        self.wheel = None
        self.ef = None
        self.creator_kwargs = None

    def _make_batch_and_names(self):
        """(batch, scenario names): the batch from the module's
        build_batch on the amalgamator's device, or None for a module
        with scenario_creator only (its kwargs are then kept in
        `creator_kwargs`, for the SPBase that stacks the scenarios)."""
        cfg, m = self.cfg, self.module
        kw = dict(m.kw_creator(cfg))
        kw.pop("num_scens", None)   # build_batch takes it positionally
        if hasattr(m, "build_batch"):
            # --seed goes to whichever seed keyword build_batch takes
            sig = inspect.signature(m.build_batch)
            seed = int(cfg.get("seed", 0) or 0)
            for s in ("seed", "seedoffset", "start_seed"):
                if s in sig.parameters and s not in kw:
                    kw[s] = seed
                    break
        kw.update(self.batch_kwargs)
        kw["device"] = self.device
        if getattr(m, "MULTISTAGE", False) or (
                hasattr(m, "build_batch")
                and "num_scens" not in inspect.signature(
                    m.build_batch).parameters):
            # multistage modules and aircondB's bundles size themselves
            # from branching factors
            batch = m.build_batch(**kw)
            names = list(batch.tree.scen_names) or \
                m.scenario_names_creator(batch.num_scens)
            return batch, names
        num_scens = int(cfg.get("num_scens", 3))
        names = m.scenario_names_creator(num_scens)
        if hasattr(m, "build_batch"):
            return m.build_batch(num_scens, **kw), names
        self.creator_kwargs = kw
        return None, names

    def run(self):
        t0 = time.time()
        batch, names = self._make_batch_and_names()
        self.wall_build = time.time() - t0
        t0 = time.time()
        try:
            return self._run_built(batch, names)
        finally:
            self.wall_run = time.time() - t0

    def _run_built(self, batch, names):
        cfg = self.cfg
        creator = None if batch is not None else self.module.scenario_creator
        ckw = self.creator_kwargs
        opts = cfg.options_dict()
        if self.is_EF:
            opts["pdhg_eps"] = cfg.get("EF_solver_eps",
                                       opts.get("pdhg_eps", 1e-7))
            ef = ExtensiveForm(opts, names, batch=batch,
                               scenario_creator=creator,
                               scenario_creator_kwargs=ckw,
                               device=self.device)
            ef.solve_extensive_form()
            self.ef = ef
            self.EF_Obj = ef.get_objective_value()
            self.best_inner_bound = self.EF_Obj
            self.best_outer_bound = ef.get_dual_bound()
            self.first_stage_solution = ef.get_root_solution()
            global_toc(f"Amalgamator EF obj = {self.EF_Obj:.6g}")
            return self

        hub = vanilla.ph_hub(cfg, creator, None, names,
                             scenario_creator_kwargs=ckw, batch=batch)
        # the spokes take the hub's device
        hub["opt_kwargs"]["device"] = self.device
        spokes = vanilla.build_spokes(cfg, creator, None, names,
                                      scenario_creator_kwargs=ckw,
                                      batch=batch)
        for sd in spokes:
            # and the batch the hub built, rather than their own
            if sd["opt_kwargs"].get("batch") is None:
                sd["opt_kwargs"].pop("batch", None)
        hub_opts = hub["opt_kwargs"]["options"]
        if cfg.get("fixer"):
            vanilla.add_fixer(hub, cfg)
        if cfg.get("use_norm_rho_updater"):
            vanilla.add_norm_rho(hub, cfg)
        if cfg.get("mult_rho"):
            vanilla.add_multi_rho(hub, cfg)
        if cfg.get("wtracker"):
            vanilla.add_wtracker(hub, cfg)
        if cfg.get("W_fname") or cfg.get("Xbar_fname"):
            from ..extensions.wxbarwriter import WXBarWriter
            hub_opts["W_fname"] = cfg.get("W_fname") or cfg.get(
                "Xbar_fname")
            vanilla.extension_adder(hub, WXBarWriter)
        if cfg.get("init_W_fname") or cfg.get("init_Xbar_fname"):
            from ..extensions.wxbarreader import WXBarReader
            hub_opts["init_W_fname"] = cfg.get("init_W_fname") or cfg.get(
                "init_Xbar_fname")
            vanilla.extension_adder(hub, WXBarReader)
        if cfg.get("primal_dual_converger"):
            from ..convergers.primal_dual_converger import \
                PrimalDualConverger
            hub_opts["ph_converger"] = PrimalDualConverger
            hub_opts["primal_dual_converger_options"] = {
                "tol": cfg.get("primal_dual_converger_tol", 1e-2)}
        elif cfg.get("use_norm_rho_converger"):
            from ..convergers.norm_rho_converger import NormRhoConverger
            hub_opts["ph_converger"] = NormRhoConverger

        self.wheel = WheelSpinner(hub, spokes).spin()
        self.best_inner_bound = self.wheel.BestInnerBound
        self.best_outer_bound = self.wheel.BestOuterBound
        sol = self.wheel.best_nonant_solution()
        if sol is not None:
            self.first_stage_solution = host(sol)
        if cfg.get("solution_base_name") and \
                self.first_stage_solution is not None:
            self.wheel.write_first_stage_solution(
                cfg["solution_base_name"] + ".csv")
        return self
