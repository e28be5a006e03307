"""The Schur-complement IPM on farmer cm=10 (S=1000 unless --scens),
f64, run by the JAX package and by the port on the CPU, at
--iters iterations (default 1000, chip_smoke.py's S=1000 run), beside
the EF optimum by HiGHS.

It prints one JSON line per package: the objective, its error relative
to the EF optimum and the wall, then one line with the two packages'
relative difference.  It shows where both packages' IPM ends at a size
where neither reaches 1e-6 of the optimum.  Not a test: it takes a few
minutes.  From the repo root:

    JAX_PLATFORMS=cpu python tests/sc_witness.py [--scens 1000] [--iters 1000]
        [--impl jax,torch]
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scens", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--impl", default="jax,torch")
    args = ap.parse_args(argv)

    import conftest  # noqa: F401  (the JAX CPU platform, float64)
    import torch
    from torch_parity import ONE

    from chip_smoke import ef_lp_oracle
    from mpisppy_tpu.models import farmer as jfarmer
    from mpisppy_tpu.opt.sc import SchurComplement as JSC
    from mpisppy_tpu_torch import disable_tictoc_output
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.opt.sc import SchurComplement
    disable_tictoc_output()
    torch.set_num_threads(4)
    S, opts = args.scens, {"sc_max_iter": args.iters}
    names = farmer.scenario_names_creator(S)
    batch = farmer.build_batch(S, crops_multiplier=10, device="cpu")
    ef, _ = ef_lp_oracle(batch)
    out = {}
    for impl in args.impl.split(","):
        t = time.time()
        if impl == "jax":
            obj, _ = JSC(dict(opts), names, mesh=ONE,
                         batch=jfarmer.build_batch(
                             S, crops_multiplier=10)).solve()
        else:
            obj, _ = SchurComplement(dict(opts), names, batch=batch,
                                     device="cpu").solve()
        out[impl] = float(obj)
        print(json.dumps({"impl": impl, "S": S, "sc_max_iter": args.iters,
                          "objective": float(obj), "ef_optimum": ef,
                          "rel_err": abs(obj - ef) / abs(ef),
                          "s": time.time() - t}), flush=True)
    if len(out) == 2:
        print(json.dumps({"S": S, "rel_diff": abs(out["torch"] - out["jax"])
                          / abs(out["jax"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
