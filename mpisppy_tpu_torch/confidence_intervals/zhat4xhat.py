"""zhat4xhat — t-interval on z(xhat) for a fixed candidate (port of
`mpisppy_tpu/confidence_intervals/zhat4xhat.py`; the reference's
mpisppy/confidence_intervals/zhat4xhat.py:15-200).

Evaluates xhat on `num_samples` independent scenario batches and
returns the mean and a symmetric t confidence interval.  `device`
(default: the CUDA device) is where each sample is built and solved.
"""

from __future__ import annotations

import importlib

import numpy as np

from .. import global_toc
from ..utils.xhat_eval import Xhat_Eval
from . import ciutils


def evaluate_sample(module, xhat, num_scens, seed, options=None,
                    device=None):
    batch = ciutils.sample_batch(module, num_scens, seed, options,
                                 device=device)
    names = list(batch.tree.scen_names)[:num_scens]
    ev = Xhat_Eval(
        {"pdhg_eps": (options or {}).get("solver_eps", 1e-7)},
        names, batch=batch, device=batch.device)
    eobj, feas = ev.evaluate(np.asarray(xhat))
    if not feas:
        raise RuntimeError(
            "zhat4xhat: candidate infeasible on the sampled batch")
    return eobj


def zhat4xhat(mname, xhat, num_samples=5, sample_size=10, seed=0,
              confidence_level=0.95, options=None, device=None):
    m = (mname if not isinstance(mname, str)
         else importlib.import_module(mname))
    zhats = []
    for i in range(num_samples):
        zhats.append(evaluate_sample(m, xhat, sample_size,
                                     seed + i * sample_size, options,
                                     device))
    zhat_bar = float(np.mean(zhats))
    s = float(np.std(zhats, ddof=1)) if num_samples > 1 else 0.0
    tq = ciutils.t_quantile(
        0.5 + confidence_level / 2.0, max(num_samples - 1, 1))
    half = tq * s / np.sqrt(num_samples)
    global_toc(f"zhat4xhat: {zhat_bar:.6g} +/- {half:.6g} "
               f"({confidence_level:.0%})")
    return zhat_bar, s, (zhat_bar - half, zhat_bar + half)
