"""Config — typed flag registry exposed as argparse flags (port of
`mpisppy_tpu/utils/config.py`, itself the counterpart of the
reference's mpisppy/utils/config.py).

A `Config` declares typed options with `add_to_config`; each declared
option becomes a `--dashed-name` flag of `create_parser` /
`parse_command_line`.  The named groups are the JAX package's, so a
cylinders command line parses to the same options in both packages.

Usage:
    cfg = config.Config()
    cfg.popular_args(); cfg.ph_args(); cfg.two_sided_args()
    farmer.inparser_adder(cfg)
    cfg.parse_command_line("farmer_cylinders")
"""

from __future__ import annotations

import argparse


def _boolify(v):
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        return v.lower() in ("1", "true", "yes", "on")
    return bool(v)


class Config(dict):
    """dict of option-name -> value with typed declarations.
    Attribute access mirrors the reference (cfg.num_scens)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__["_defs"] = {}

    # -- declaration (reference config.py:47-78) --------------------------
    def add_to_config(self, name, description="", domain=str,
                      default=None, argparse=True, complain=False):
        if name in self._defs:
            if complain:
                raise RuntimeError(f"option {name} re-declared")
            return
        self._defs[name] = dict(description=description, domain=domain,
                                default=default, argparse=argparse)
        self.setdefault(name, default)

    def quick_assign(self, name, domain=str, value=None):
        self.add_to_config(name, domain=domain, default=value,
                           argparse=False)
        self[name] = value

    # -- attribute sugar --------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    # -- argparse bridge (reference config.py:47-78 auto-args) ------------
    def create_parser(self, progname=None):
        parser = argparse.ArgumentParser(prog=progname)
        for name, d in self._defs.items():
            if not d["argparse"]:
                continue
            flag = "--" + name.replace("_", "-")
            dom = d["domain"]
            # the CURRENT value is the parser default, so programmatic
            # assignments between declaration and parse survive an
            # absent flag
            cur = self.get(name, d["default"])
            if dom is bool:
                # bare --flag means True; --flag false/0 also accepted;
                # one arity regardless of the current value
                parser.add_argument(
                    flag, dest=name, nargs="?", const=True,
                    type=_boolify, default=bool(cur),
                    help=d["description"])
            else:
                parser.add_argument(flag, dest=name, type=dom,
                                    default=cur,
                                    help=d["description"])
        return parser

    def parse_command_line(self, progname=None, args=None):
        parser = self.create_parser(progname)
        ns = parser.parse_args(args=args)
        for name in self._defs:
            if self._defs[name]["argparse"]:
                self[name] = getattr(ns, name)
        return self

    # ======= named groups (reference config.py:151-778) =================
    def popular_args(self):
        self.add_to_config("max_iterations", "hub iteration limit",
                           int, 100)
        self.add_to_config("time_limit", "wall-clock limit (s)",
                           float, None, argparse=False)
        self.add_to_config("default_rho", "PH rho", float, 1.0)
        self.add_to_config("seed", "base RNG seed", int, 0)
        self.add_to_config("solver_eps", "kernel KKT tolerance "
                           "(the solver-options analog)", float, 1e-6)
        self.add_to_config("solver_max_iters", "kernel iteration cap",
                           int, 20000)
        self.add_to_config("display_timing", "print solve timing",
                           bool, False)
        self.add_to_config("verbose", "chatty output", bool, False)
        self.add_to_config("solution_base_name",
                           "write solution files with this prefix",
                           str, None)

    def num_scens_required(self):
        self.add_to_config("num_scens", "number of scenarios", int, 3)

    def add_branching_factors(self):
        self.add_to_config("branching_factors",
                           "comma-separated branching factors",
                           str, "3,3")

    def ph_args(self):
        self.add_to_config("convthresh", "PH convergence threshold",
                           float, 1e-4)
        self.add_to_config("linearize_proximal_terms",
                           "kept for API parity (prox is exact here)",
                           bool, False)

    def two_sided_args(self):
        self.add_to_config("rel_gap", "relative gap termination",
                           float, 0.01)
        self.add_to_config("abs_gap", "absolute gap termination",
                           float, None, argparse=False)
        self.add_to_config("max_stalled_iters", "stall termination",
                           int, 100)

    def aph_args(self):
        self.add_to_config("aph_gamma", "APH gamma", float, 1.0)
        self.add_to_config("aph_nu", "APH nu (relaxation)", float, 1.0)
        self.add_to_config("dispatch_frac",
                           "fraction of scenarios dispatched per pass",
                           float, 1.0)

    def fwph_args(self):
        self.add_to_config("fwph_iter_limit", "SDM rounds per pass",
                           int, 2)
        self.add_to_config("fwph_column_bank", "column capacity",
                           int, 16)
        self.add_to_config("fwph", "add an FWPH outer-bound spoke",
                           bool, False)

    def lagrangian_args(self):
        self.add_to_config("lagrangian",
                           "add a Lagrangian outer-bound spoke",
                           bool, False)

    def lagranger_args(self):
        self.add_to_config("lagranger",
                           "add a Lagranger outer-bound spoke",
                           bool, False)
        self.add_to_config("lagranger_rho_rescale_factors_json",
                           "per-iteration rho rescale factors",
                           str, None)

    def xhatlooper_args(self):
        self.add_to_config("xhatlooper", "add an xhat looper spoke",
                           bool, False)
        self.add_to_config("xhat_scen_limit", "looper scenario limit",
                           int, 3)

    def xhatshuffle_args(self):
        self.add_to_config("xhatshuffle",
                           "add an xhat shuffle-looper spoke",
                           bool, False)
        self.add_to_config("add_reversed_shuffle",
                           "also walk reversed epochs", bool, False)

    def xhatspecific_args(self):
        self.add_to_config("xhatspecific",
                           "add an xhat specific-scenario spoke",
                           bool, False)

    def xhatxbar_args(self):
        self.add_to_config("xhatxbar", "add an xhat-xbar spoke",
                           bool, False)

    def xhatlshaped_args(self):
        self.add_to_config("xhatlshaped",
                           "add an L-shaped xhat spoke", bool, False)

    def slammax_args(self):
        self.add_to_config("slammax", "add a slam-max spoke",
                           bool, False)

    def slammin_args(self):
        self.add_to_config("slammin", "add a slam-min spoke",
                           bool, False)

    def fixer_args(self):
        self.add_to_config("fixer", "attach the Fixer extension",
                           bool, False)
        self.add_to_config("fixer_tol", "Fixer ripeness tolerance",
                           float, 1e-2)
        self.add_to_config("fixer_nb", "consecutive-ripe count",
                           int, 3)

    def gapper_args(self):
        self.add_to_config("mipgaps_json",
                           "JSON file of {iter: eps} schedule",
                           str, None)

    def converger_args(self):
        self.add_to_config("use_norm_rho_converger",
                           "use NormRhoConverger", bool, False)
        self.add_to_config("primal_dual_converger",
                           "use PrimalDualConverger", bool, False)
        self.add_to_config("primal_dual_converger_tol",
                           "its tolerance", float, 1e-2)

    def mult_rho_args(self):
        self.add_to_config("mult_rho", "attach MultRhoUpdater",
                           bool, False)
        self.add_to_config("mult_rho_convergence_tolerance",
                           "stop updating below this conv", float, 1e-4)
        self.add_to_config("mult_rho_update_stop_iteration",
                           "stop updating after this iter", int, None,
                           argparse=False)
        self.add_to_config("mult_rho_update_start_iteration",
                           "start updating at this iter", int, 2)

    def norm_rho_args(self):
        self.add_to_config("use_norm_rho_updater",
                           "attach NormRhoUpdater", bool, False)

    def gradient_args(self):
        self.add_to_config("grad_rho_setter",
                           "use gradient-based rho", bool, False)
        self.add_to_config("grad_order_stat",
                           "order statistic in [0,1] for grad rho",
                           float, 0.5)
        self.add_to_config("grad_rho_relative_bound",
                           "cap rho at this multiple of cost", float,
                           1e3)

    def wtracker_args(self):
        self.add_to_config("wtracker", "attach Wtracker", bool, False)
        self.add_to_config("wtracker_wlen", "window length", int, 10)

    def tracking_args(self):
        self.add_to_config("tracking_folder",
                           "PHTracker output folder", str, None)

    def wxbar_read_write_args(self):
        self.add_to_config("init_W_fname",
                           "warm-start W from this file", str, None)
        self.add_to_config("init_Xbar_fname",
                           "warm-start xbar from this file", str, None)
        self.add_to_config("W_fname", "write W to this file", str, None)
        self.add_to_config("Xbar_fname", "write xbar to this file",
                           str, None)

    def ef_args(self):
        self.add_to_config("EF", "solve the extensive form directly "
                           "(one consensus solve) instead of cylinders",
                           bool, False)
        self.add_to_config("EF_solver_eps", "EF kernel tolerance",
                           float, 1e-7)

    def dynamic_rho_args(self):
        self.gradient_args()

    # -- translation to runtime options -----------------------------------
    def options_dict(self):
        """Map declared flags to the option names the optimizers take
        (the role of the reference's shared_options block in
        cfg_vanilla.py:77-100)."""
        o = {
            "PHIterLimit": self.get("max_iterations", 100),
            "defaultPHrho": self.get("default_rho", 1.0),
            "convthresh": self.get("convthresh", 1e-4),
            "pdhg_eps": self.get("solver_eps", 1e-6),
            "pdhg_max_iters": self.get("solver_max_iters", 20000),
            "display_timing": self.get("display_timing", False),
            "verbose": self.get("verbose", False),
        }
        if self.get("aph_gamma") is not None:
            o["APHgamma"] = self.get("aph_gamma", 1.0)
        if self.get("aph_nu") is not None:
            o["APHnu"] = self.get("aph_nu", 1.0)
        if self.get("dispatch_frac") is not None:
            o["dispatch_frac"] = self.get("dispatch_frac", 1.0)
        if self.get("fwph_iter_limit") is not None:
            o["FW_iter_limit"] = self.get("fwph_iter_limit", 2)
        if self.get("fwph_column_bank") is not None:
            o["column_bank"] = self.get("fwph_column_bank", 16)
        return o


def parse_branching_factors(bf):
    """'3,3' or [3, 3] -> [3, 3] (shared by multistage kw_creators)."""
    if isinstance(bf, str):
        return [int(x) for x in bf.replace(" ", "").split(",") if x]
    return [int(x) for x in bf]


def global_config():
    """Reference exposes a module-level global_config; some drivers use
    it instead of passing cfg around."""
    global _GLOBAL
    try:
        return _GLOBAL
    except NameError:
        _GLOBAL = Config()
        return _GLOBAL
