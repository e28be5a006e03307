"""Iter0 of the true-size farmer instance (crops_multiplier=1000: M=6001
rows, N=12000 columns a scenario, split-native, f32) at a few scenarios,
in the JAX package or in the PyTorch port, with the bench's options and
caps (`bench.py`'s farmer row, `no_split_prep` left out).

It makes Iter0's two steps one at a time, through the same calls in
both packages, so their results can be laid side by side:

1. the fast solve (`solve_loop`, warm=False, to `pdhg_max_iters`; f32
   for the bench's f32 batch);
2. the float64 re-solve of its primal-infeasible scenarios
   (`_certified_resolve`, to `certify_max_iters`, 100,000 by default).

It prints one JSON line after each step: iterations, the converged
mask, per-scenario residuals and the certified-feasible probability
mass.  This is not a test: it takes minutes on an H100 and hours on a
CPU.  Run it from the repo root:

    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 \\
        python tests/true_size_witness.py --impl jax --scens 4
    python tests/true_size_witness.py --impl torch --device cpu --scens 4
    python tests/true_size_witness.py --impl torch --device cuda --scens 4

Each run imports one package only.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# bench.py's farmer options on an accelerator, without no_split_prep
BENCH_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 200, "convthresh": 0.0,
              "pdhg_eps": 1e-5, "superstep_eps": 1e-4,
              "lagrangian_eps": 1e-4, "pdhg_max_iters": 30000,
              "eps_ladder": {"start": 1e-3, "min": 1e-4, "couple": 0.1},
              "pdhg_hot_dtype": "f32"}


def _np(t):
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _record_solves(solver_cls, iters):
    """Append the iteration count of every `solver_cls.solve` call."""
    solve = solver_cls.solve

    def recorded(self, *args, **kwargs):
        res = solve(self, *args, **kwargs)
        iters.append(int(_np(res.iters)))
        return res

    solver_cls.solve = recorded


def _report(step, ph, res, t, iters, out):
    row = {"step": step, "s": time.time() - t,
           "solve_iters": list(iters),
           "converged": _np(res.converged).astype(int).tolist(),
           "pres": _np(res.pres).tolist(), "dres": _np(res.dres).tolist(),
           "gap": _np(res.gap).tolist(),
           "feasible_mass": float(ph.feas_prob(res))}
    iters.clear()
    out.append(row)
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--device", default="cuda",
                    help="the port's device (torch only)")
    ap.add_argument("--scens", type=int, default=4)
    ap.add_argument("--cm", type=int, default=1000,
                    help="crops_multiplier (1000: the true size)")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32",
                    help="the batch's dtype (the bench's accelerator row: "
                         "float32)")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    a = ap.parse_args()
    if a.impl == "jax":
        from mpisppy_tpu.models import farmer
        from mpisppy_tpu.ops.pdhg import PDHGSolver
        from mpisppy_tpu.opt.ph import PH
        kw, sync = {}, (lambda: None)
    else:
        import torch

        from mpisppy_tpu_torch.models import farmer
        from mpisppy_tpu_torch.ops.pdhg import PDHGSolver
        from mpisppy_tpu_torch.opt.ph import PH
        kw = {"device": a.device}

        def sync():
            if a.device.startswith("cuda"):
                torch.cuda.synchronize()
    iters = []
    _record_solves(PDHGSolver, iters)
    names = [f"scen{i}" for i in range(a.scens)]
    out = []
    t = time.time()
    b = farmer.build_batch(a.scens, crops_multiplier=a.cm,
                           dtype=np.dtype(a.dtype), split=True, **kw)
    ph = PH(dict(BENCH_OPTS, iter0_infeasibility_ok=True), names, batch=b,
            **kw)
    sync()
    iters.clear()
    head = {"impl": a.impl, "device": a.device if a.impl == "torch"
            else "cpu", "S": a.scens, "crops_multiplier": a.cm,
            "dtype": a.dtype,
            "M": int(b.num_rows), "N": int(b.num_vars),
            "setup_s": time.time() - t,
            "anorm": _np(ph.prep.anorm).tolist(),
            "d_row_shape": list(ph.prep.d_row.shape)}
    print(json.dumps(head), flush=True)
    t = time.time()
    res = ph.solve_loop(lb=ph.lb_eff, ub=ph.ub_eff, warm=False)
    sync()
    _report("fast solve", ph, res, t, iters, out)
    select = _np(res.pres) >= 10 * float(ph.solver_eps)
    if a.impl == "torch":
        import torch
        select = torch.as_tensor(select, device=res.pres.device)
    t = time.time()
    res = ph._certified_resolve(res, lb=ph.lb_eff, ub=ph.ub_eff,
                                select=select)
    sync()
    _report("f64 certify", ph, res, t, iters, out)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({**head, "steps": out}))


if __name__ == "__main__":
    main()
