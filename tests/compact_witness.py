"""Converged-scenario compaction against the plain solve, in the JAX
package or in the PyTorch port: farmer at `--scens` scenarios and
`--cm` crops_multiplier, f32 or f64, chip_smoke.py's split options
(bench.py's farmer row) with and without pdhg_compact_threshold, one
Iter0 and one Lagrangian bound at the uncompacted run's W.

It prints one JSON line per run: each step's bound, the scenarios its
solve converged, its inner iterations and, with compaction, the segment
trajectory's widths and active counts.  Both packages run the same
algorithm (tests/test_torch_compact.py holds the port's segment
trajectory to the JAX package's), so the two lines of one size show
whether a difference between compacted and plain solves belongs to the
algorithm.  This is not a test (tens of seconds on a CPU at S=40).  Run
it from the repo root:

    python tests/compact_witness.py --impl jax --scens 40 --cm 2
    python tests/compact_witness.py --impl torch --scens 40 --cm 2

The JAX run uses one CPU device (`JAX_PLATFORMS=cpu` is set here) and
enables x64 only for --dtype f64.  Each run imports one package only.
"""

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# chip_smoke.SPLIT_OPTS (bench.py:1252-1294 without no_split_prep)
OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 4, "convthresh": 0.0,
        "pdhg_eps": 1e-5, "superstep_eps": 1e-4, "lagrangian_eps": 1e-4,
        "pdhg_max_iters": 30000,
        "eps_ladder": {"start": 1e-3, "min": 1e-4, "couple": 0.1},
        "pdhg_hot_dtype": "f32"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--scens", type=int, default=40)
    ap.add_argument("--cm", type=int, default=2)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--device", default="cpu", help="torch only")
    args = ap.parse_args()
    dtype = np.float32 if args.dtype == "f32" else np.float64
    names = [f"scen{i}" for i in range(args.scens)]
    if args.impl == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax
        jax.config.update("jax_enable_x64", args.dtype == "f64")
        from mpisppy_tpu import disable_tictoc_output
        from mpisppy_tpu.models import farmer
        from mpisppy_tpu.opt.ph import PH
        from mpisppy_tpu.parallel.mesh import ScenarioMesh
        batch = farmer.build_batch(args.scens, crops_multiplier=args.cm,
                                   dtype=dtype)
        kw = {"mesh": ScenarioMesh(devices=jax.devices()[:1])}
    else:
        from mpisppy_tpu_torch import disable_tictoc_output
        from mpisppy_tpu_torch.models import farmer
        from mpisppy_tpu_torch.opt.ph import PH
        batch = farmer.build_batch(args.scens, crops_multiplier=args.cm,
                                   dtype=dtype, device=args.device)
        kw = {"device": args.device}
    disable_tictoc_output()

    def run(opts, W=None, prep=None):
        ph = PH(opts, names, batch=batch, **kw,
                **({} if prep is None else {"prep": prep}))
        last = {}
        solve_loop = ph.solve_loop

        def recording(*a, **k):
            last["res"] = solve_loop(*a, **k)
            return last["res"]

        ph.solve_loop = recording
        out = {}
        for step, fn in (("iter0", ph.Iter0),
                         ("lagrangian_bound",
                          lambda: ph.lagrangian_bound(W=W))):
            ph._active_traj = []
            value = float(fn())
            res = last["res"]
            out[step] = {
                "value": value,
                "converged": int(np.sum(np.asarray(res.converged))),
                "iters": int(res.iters),
                "widths": [t["width"] for t in ph._active_traj],
                "active": [t["active"] for t in ph._active_traj]}
        return ph, out

    ph_u, plain = run(dict(OPTS))
    _, compacted = run(dict(OPTS, pdhg_compact_threshold=args.threshold),
                       W=ph_u.state.W, prep=ph_u.prep)
    print(json.dumps({"impl": args.impl, "S": args.scens, "cm": args.cm,
                      "dtype": args.dtype, "threshold": args.threshold,
                      "plain": plain, "compacted": compacted}))


if __name__ == "__main__":
    main()
