"""Gradient-based rho utilities (port of `mpisppy_tpu/utils/gradient.py`).

Per-scenario objective gradients at the nonant slots, written to and
read from CSV, and rho derived as an order statistic of |gradient| over
scenarios scaled by the nonant spread: one (S, K) gradient array on the
host, one quantile call.
"""

from __future__ import annotations

import csv

import numpy as np

from ..device import host


def grad_cost(opt, x=None):
    """Per-scenario objective gradient at the nonant slots, (S, K)
    numpy: g = c + qdiag * x restricted to the nonant columns, at `x`
    (default the PH state's x, else the lower bounds)."""
    b = opt.batch
    if x is None:
        x = opt.state.x if getattr(opt, "state", None) is not None \
            else b.lb
    na = host(b.nonant_idx)
    return host(b.c)[:, na] + host(b.qdiag)[:, na] * host(x)[:, na]


def find_rho(opt, order_stat=0.5, rel_bound=1e3, x=None):
    """(K,) rho from gradient order statistics: per slot, the
    order_stat quantile over scenarios of |g|, divided by the scenario
    spread of the nonant values (floored at 1), clipped to
    [median / rel_bound, median * rel_bound]."""
    g = np.abs(grad_cost(opt, x=x))
    S = opt.n_real_scens
    g = g[:S]
    quant = np.quantile(g, order_stat, axis=0)
    if getattr(opt, "state", None) is not None:
        x_na = host(opt.batch.nonants(opt.state.x))[:S]
        spread = np.maximum(x_na.max(axis=0) - x_na.min(axis=0), 1.0)
    else:
        spread = np.ones_like(quant)
    rho = quant / spread
    med = np.median(rho[rho > 0]) if (rho > 0).any() else 1.0
    rho = np.clip(rho, med / rel_bound, med * rel_bound)
    return np.maximum(rho, 1e-6)


def _nonant_names(opt, count):
    return opt.batch.tree.nonant_names or tuple(
        str(k) for k in range(count))


def _scen_names(opt, count):
    return opt.batch.tree.scen_names or tuple(
        str(s) for s in range(count))


def write_grad_cost(path, opt, x=None):
    """CSV rows: scenario, varname, gradient."""
    g = grad_cost(opt, x=x)
    names = _nonant_names(opt, g.shape[1])
    scen = _scen_names(opt, g.shape[0])
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for s in range(opt.n_real_scens):
            for k in range(g.shape[1]):
                w.writerow([scen[s], names[k], g[s, k]])


def read_grad_cost(path, opt):
    """(S, K) gradients from a write_grad_cost CSV."""
    g = np.zeros((opt.batch.num_scens, opt.batch.num_nonants))
    names = {n: k for k, n in enumerate(_nonant_names(opt, g.shape[1]))}
    scen = {n: s for s, n in enumerate(_scen_names(opt, g.shape[0]))}
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) == 3 and row[0] in scen and row[1] in names:
                g[scen[row[0]], names[row[1]]] = float(row[2])
    return g


# -- rho CSV round trip: per-variable rhos that a later run starts from --

def write_rho(path, opt, rho):
    """CSV: varname, rho (one row per nonant slot; (K,) or (S, K)
    input, per-scenario rhos written as their scenario-0 row)."""
    rho = host(rho)
    if rho.ndim == 2:
        rho = rho[0]
    names = _nonant_names(opt, rho.size)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["varname", "rho"])
        for k in range(rho.size):
            w.writerow([names[k], rho[k]])


def read_rho(path, opt):
    """(K,) rho vector from a write_rho CSV."""
    names = {n: k for k, n in enumerate(
        _nonant_names(opt, opt.batch.num_nonants))}
    rho = np.ones(opt.batch.num_nonants)
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) == 2 and row[0] in names:
                rho[names[row[0]]] = float(row[1])
    return rho


# -- command line: gradients and rhos of a model module, as the CSVs
#    that Gradient_extension and later runs consume ---------------------

def main(args=None):
    """python -m mpisppy_tpu_torch.utils.gradient --module <model
    module> --num-scens N [--grad-order-stat q] [--grad-cost-file F]
    [--rho-file F] [--device cuda|cpu]
    """
    import importlib

    from ..opt.ph import PH
    from .amalgamator import from_module
    from .config import Config

    cfg = Config()
    cfg.popular_args()
    cfg.ph_args()
    cfg.gradient_args()
    cfg.add_to_config("module", "model module name (e.g. "
                      "mpisppy_tpu_torch.models.farmer)", str, None)
    cfg.add_to_config("grad_cost_file", "gradient CSV output", str,
                      "grad_cost.csv")
    cfg.add_to_config("rho_file", "rho CSV output", str, "rhos.csv")
    cfg.add_to_config("device", "torch device (default: the CUDA "
                      "device)", str, None)
    known, _ = cfg.create_parser("gradient").parse_known_args(args)
    if not known.module:
        cfg.create_parser("gradient").error(
            "--module is required (e.g. mpisppy_tpu_torch.models.farmer)")
    m = importlib.import_module(known.module)
    ama = from_module(m, cfg, use_command_line=True, args=args,
                      progname="gradient", device=known.device)
    batch, names = ama._make_batch_and_names()
    ph = PH(cfg.options_dict(), names, batch=batch, device=ama.device)
    ph.Iter0()
    write_grad_cost(cfg["grad_cost_file"], ph)
    rho = find_rho(ph, order_stat=cfg.get("grad_order_stat", 0.5),
                   rel_bound=cfg.get("grad_rho_relative_bound", 1e3))
    write_rho(cfg["rho_file"], ph, rho)
    print(f"wrote {cfg['grad_cost_file']} and {cfg['rho_file']} "
          f"({rho.size} nonant slots)")


if __name__ == "__main__":      # pragma: no cover — command line
    main()
