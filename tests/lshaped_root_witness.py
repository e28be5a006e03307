"""L-shaped's first root LP on farmer cm=10 (S=100 unless --scens),
f64, solved by the JAX package and by the port, on the CPU.

Both packages build the same root (the JAX package's subproblem prep
is handed to the port, and the port's power iterations start from the
JAX PRNGKey draw).  It prints one JSON line per root solve of either
package (iterations, converged, objective, duality gap, the starting
primal weight), then the port's outer bound and its root re-solves
(`LShapedMethod.root_resolves`).  The root's rows start slack, so the
primal weight moves only on the rounding remainder of the dual update
(`mpisppy_tpu_torch/ops/pdhg_chunk.py` `_dual_prox`).  Not a test: it
takes about a minute at S=100 and ten at S=1000.  From the repo root:

    JAX_PLATFORMS=cpu python tests/lshaped_root_witness.py [--scens 1000]
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT.parent))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scens", type=int, default=100)
    args = ap.parse_args(argv)

    import conftest  # noqa: F401  (the JAX CPU platform, float64)
    import torch
    from torch_parity import ONE, jax_normal_draw

    from mpisppy_tpu.models import farmer as jfarmer
    from mpisppy_tpu.opt.lshaped import LShapedMethod as JLShaped
    from mpisppy_tpu_torch import disable_tictoc_output
    from mpisppy_tpu_torch.convert import prep_from_arrays, to_arrays
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg
    from mpisppy_tpu_torch.opt.lshaped import LShapedMethod
    disable_tictoc_output()
    pdhg.normal_draw = jax_normal_draw
    S = args.scens
    names = [f"scen{i}" for i in range(S)]
    opts = {"max_iter": 1, "tol": 0.0, "pdhg_eps": 1e-6}

    def report(impl, solver):
        solve = solver.solve

        def traced(self, prep, c, *a, **k):
            r = solve(self, prep, c, *a, **k)
            if c.shape[0] == 1:     # the root (the subproblems are S)
                print(json.dumps({
                    "impl": impl, "S": S, "omega0": self.omega0,
                    "iters": int(r.iters),
                    "converged": bool(np.all(np.asarray(r.converged))),
                    "objective": float(np.asarray(r.obj)[0]),
                    "gap": float(np.asarray(r.gap)[0])}), flush=True)
            return r
        solver.solve = traced

    j = JLShaped(dict(opts), names,
                 batch=jfarmer.build_batch(S, crops_multiplier=10),
                 mesh=ONE)
    from mpisppy_tpu.ops.pdhg import PDHGSolver as JSolver
    report("jax", JSolver)
    j.lshaped_algorithm()
    prep = prep_from_arrays(to_arrays(j.prep), device="cpu")
    torch.set_num_threads(4)
    t = LShapedMethod(dict(opts), names,
                      batch=farmer.build_batch(S, crops_multiplier=10,
                                               device="cpu"),
                      device="cpu", prep=prep)
    report("torch", pdhg.PDHGSolver)
    t.lshaped_algorithm()
    print(json.dumps({"impl": "torch", "S": S, "outer": t.outer_bound,
                      "root_resolves": t.root_resolves,
                      "root_unconverged": t.root_unconverged}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
