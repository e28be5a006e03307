"""ciutils — shared confidence-interval machinery (port of
`mpisppy_tpu/confidence_intervals/ciutils.py`; the reference's
mpisppy/confidence_intervals/ciutils.py).

Seed discipline, xhat readers and writers, batch sampling through the
amalgamator module contract, and `gap_estimators`: for a candidate xhat
and a fresh scenario sample, the bias-corrected point estimate G and
the sample standard deviation s of the optimality gap.  The sampled EF
is the port's consensus `opt/ef.ExtensiveForm`; the candidate is
evaluated by `utils/xhat_eval.Xhat_Eval`, one batched fixed-nonant
solve.

Sampling protocol: the module's build_batch gets a seed-bearing kwarg
(`seed`, `seedoffset` or `start_seed`, whichever its signature takes),
so each sample is an independent draw.  `device` goes to build_batch
(default: the CUDA device), and a `dtype` in the options reaches a
build_batch that takes one.
"""

from __future__ import annotations

import inspect

import numpy as np

from ..device import host
from ..opt.ef import ExtensiveForm
from ..utils.xhat_eval import Xhat_Eval

try:
    from scipy.stats import t as _t_dist
    HAVE_SCIPY = True
except ImportError:                                    # pragma: no cover
    HAVE_SCIPY = False


def t_quantile(confidence_level, dof):
    """One-sided t quantile (scipy.stats.t.ppf, as the reference)."""
    if HAVE_SCIPY:
        return float(_t_dist.ppf(confidence_level, dof))
    return 1.96  # normal fallback, as the JAX package


def write_xhat(xhat, path="xhat.npy"):
    np.save(path, host(xhat))


def read_xhat(path="xhat.npy"):
    return np.load(path)


def writetxt_xhat(xhat, path="xhat.txt"):
    np.savetxt(path, host(xhat))


def readtxt_xhat(path="xhat.txt"):
    return np.loadtxt(path)


def _seed_kwargs(module, kw, seed, device, cfg):
    sig = inspect.signature(module.build_batch)
    for name in ("seed", "seedoffset", "start_seed"):
        if name in sig.parameters:
            kw[name] = seed
            break
    if "device" in sig.parameters:
        kw["device"] = device
    if "dtype" in sig.parameters and (cfg or {}).get("dtype") is not None:
        kw["dtype"] = np.dtype(cfg["dtype"])
    return kw


def sample_batch(module, num_scens, seed, cfg=None, extra_kw=None,
                 device=None):
    """A batch of scenarios drawn with `seed` on `device`.  For
    MULTISTAGE modules build_batch's first argument is the branching
    factors (from kw_creator), and num_scens is ignored."""
    kw = dict(module.kw_creator(cfg or {})) if hasattr(
        module, "kw_creator") else {}
    kw.pop("num_scens", None)
    kw.update(extra_kw or {})
    kw = _seed_kwargs(module, kw, seed, device, cfg)
    if getattr(module, "MULTISTAGE", False):
        return module.build_batch(**kw)
    return module.build_batch(num_scens, **kw)


def _solver_opts(cfg):
    cfg = cfg or {}
    return {"pdhg_eps": cfg.get("solver_eps", 1e-7),
            "pdhg_max_iters": cfg.get("solver_max_iters", 100000)}


def gap_estimators(xhat_one, mname_or_module, solving_type="EF_2stage",
                   scenario_names=None, sample_options=None,
                   num_scens=None, seed=0, cfg=None, objective_gap=False,
                   ArRP=1, device=None):
    """The optimality gap of candidate `xhat_one` on a fresh sample:
    {"G": point estimate, "std" (alias "s"): sample std of the
    per-scenario gap terms, "zhats": E[f(xhat)], "zstar": the sampled
    EF's value, "seed": the next seed}.

    Two-stage: G_n = (1/n) sum_s [f_s(xhat) - f_s(x*_n)] with x*_n the
    sampled EF's optimizer; std is the (n-1)-dof sample std of those
    terms.  ArRP > 1 pools G and s from ArRP disjoint sub-estimators of
    num_scens/ArRP scenarios each: G = mean(G_i),
    s = ||(s_i)||_2 / sqrt(n/ArRP)."""
    import importlib
    m = (importlib.import_module(mname_or_module)
         if isinstance(mname_or_module, str) else mname_or_module)
    if num_scens is None:
        num_scens = len(scenario_names) if scenario_names else 10
    if solving_type not in ("EF_2stage", "EF-2stage", "EF_mstage"):
        raise ValueError(f"unknown solving_type {solving_type}")

    if ArRP > 1:
        if solving_type == "EF_mstage":
            raise NotImplementedError(
                "pooled (ArRP) estimators are not supported for "
                "multistage problems (reference ciutils.py:288)")
        n = num_scens - num_scens % ArRP
        npool = n // ArRP
        if npool < 2:
            raise ValueError(
                f"gap_estimators: num_scens={num_scens} too small for "
                f"ArRP={ArRP} pooling (need >= 2 per pool)")
        Gs, ss, zhs, zss, gobjs = [], [], [], [], []
        sub_seed = seed
        for _ in range(ArRP):
            tmp = gap_estimators(
                xhat_one, m, solving_type=solving_type,
                num_scens=npool, seed=sub_seed, cfg=cfg, ArRP=1,
                objective_gap=objective_gap, device=device)
            sub_seed = tmp["seed"]
            Gs.append(tmp["G"])
            ss.append(tmp["std"])
            zhs.append(tmp["zhats"])
            zss.append(tmp["zstar"])
            if objective_gap:
                gobjs.append(tmp["Gobj"])
        G = float(np.mean(Gs))
        s = float(np.linalg.norm(ss) / np.sqrt(npool))
        out = {"G": G, "std": s, "s": s,
               "zhats": float(np.mean(zhs)),
               "zstar": float(np.mean(zss)), "seed": sub_seed}
        if objective_gap:
            out["Gobj"] = float(np.mean(gobjs))
        return out

    batch = sample_batch(m, num_scens, seed, cfg, device=device)
    num_scens = min(num_scens, batch.num_scens)   # multistage trees
    names = list(batch.tree.scen_names)[:num_scens]
    opts = _solver_opts(cfg)
    dev = batch.device

    # sampled EF solve -> zstar and the sampled-optimal solution
    ef = ExtensiveForm(dict(opts), names, batch=batch, device=dev)
    res = ef.solve_extensive_form()
    zstar = ef.get_objective_value()
    # per-scenario f_s(x*_n), unweighted (the consensus solve reports
    # probability-weighted objectives)
    fs_star = host(ef.batch.objective(res.x))[:num_scens]

    # the candidate on the same sample
    ev = Xhat_Eval(dict(opts), names, batch=batch, device=dev)
    lb, ub = ev.fixed_nonant_bounds(
        np.asarray(host(xhat_one)),
        upto_stage=1 if solving_type == "EF_mstage" else None)
    evres = ev.solve_loop(lb=lb, ub=ub, warm=False)
    if ev.feas_prob(evres) < 1.0 - 1e-6:
        raise RuntimeError(
            "gap_estimators: candidate xhat infeasible on the sample "
            f"(feasible mass {ev.feas_prob(evres):.4f})")
    fs_hat = host(evres.obj)[:num_scens]
    prob = host(batch.prob)[:num_scens]
    prob = prob / prob.sum()
    zhat = float(prob @ fs_hat)

    gaps = fs_hat - fs_star
    G = float(prob @ gaps)
    std = float(np.std(gaps, ddof=1)) if num_scens > 1 else 0.0
    out = {"G": G, "std": std, "s": std, "zhats": zhat, "zstar": zstar,
           "seed": seed + num_scens}
    if objective_gap:
        out["Gobj"] = zhat - zstar
    return out


def debit_quarantined_mass(est, frac):
    """Debit lost scenario mass into a gap estimate, in place.

    When a shard store quarantines unreadable shards, `frac` of the
    universe was replaced by draws from the healthy rest, and the unread
    mass could hide up to `frac * |z|` of objective: the certificate
    widens by that much.  Scales by the largest objective magnitude of
    the estimate (floored at 1.0), adds the debit to est["G"], records
    it under est["quarantine_debit"] and returns it.  frac <= 0 is a
    no-op returning 0.0: a healthy run's estimate is untouched."""
    frac = float(frac)
    if frac <= 0.0:
        return 0.0
    scale = max(abs(float(est.get("zhats", 0.0))),
                abs(float(est.get("zstar", 0.0))), 1.0)
    debit = frac * scale
    est["G"] = float(est["G"]) + debit
    est["quarantine_debit"] = debit
    return debit
