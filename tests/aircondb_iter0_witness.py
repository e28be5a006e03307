"""PH's Iter0 on aircondB in float32 at the default solver eps (1e-6),
aircond (10, 10, 10) in ten proper bundles of 100 scenarios, run by the
JAX package and by the port on the CPU, with chip_smoke.py's certify
cap (20,000 f64 iterations).

It prints one JSON line per package: the certified feasible mass of
Iter0 (`iter0_feas_mass`) or the error Iter0 raised, and the wall.  It
shows whether the JAX package fails Iter0 there as the port does on
the card.  Not a test: it takes tens of minutes.  From the repo root:

    JAX_PLATFORMS=cpu python tests/aircondb_iter0_witness.py [--eps 1e-6]
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT.parent))

BF = (10, 10, 10)
PER_BUNDLE = 100


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--impl", default="jax,torch")
    args = ap.parse_args(argv)

    import conftest  # noqa: F401  (the JAX CPU platform)
    import torch
    from torch_parity import ONE

    from mpisppy_tpu.models import aircondB as jaircondB
    from mpisppy_tpu.opt.ph import PH as JPH
    from mpisppy_tpu_torch import disable_tictoc_output
    from mpisppy_tpu_torch.models import aircondB
    from mpisppy_tpu_torch.opt.ph import PH
    disable_tictoc_output()
    torch.set_num_threads(4)
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 0, "convthresh": 0.0,
            "pdhg_eps": args.eps, "certify_max_iters": 20000}
    for impl in args.impl.split(","):
        t = time.time()
        if impl == "jax":
            b = jaircondB.build_batch(BF, scenarios_per_bundle=PER_BUNDLE,
                                      dtype=np.float32)
            ph = JPH(dict(opts), list(b.tree.scen_names), batch=b, mesh=ONE)
        else:
            b = aircondB.build_batch(BF, scenarios_per_bundle=PER_BUNDLE,
                                     dtype=np.float32, device="cpu")
            ph = PH(dict(opts), list(b.tree.scen_names), batch=b,
                    device="cpu")
        line = {"impl": impl, "eps": args.eps,
                "shape": [b.num_scens, b.num_rows, b.num_vars]}
        try:
            ph.Iter0()
            line["iter0_feas_mass"] = float(ph.iter0_feas_mass)
        except RuntimeError as e:
            line["error"] = str(e)
        line["s"] = time.time() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
