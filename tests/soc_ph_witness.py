"""PH's Iter0 on acopf3's refined SOC batch at the width chip_smoke.py's
`soc` phase runs (IEEE 14-bus, branching factors (2, 2), 8 cut slots,
float64), run by the JAX package on the CPU (one device) and by the port
on the CPU or the card.

Each package refines its own batch with its own `soc_refine` at the
phase's rounds and refine options, then runs PH (10 iterations, rho 50,
as tests/test_acopf3_soc.py) at each solver eps asked for: the JAX
test's 1e-6 with its 100,000-iteration cap, and the phase's 1e-4 at
20,000, and evaluates x̄.  It prints one line for the refine (its
objectives, violations and cuts) and one JSON line per eps: Iter0's
certified feasible mass, the trivial bound, E[obj], x̄'s objective and
whether it certified feasible, or the error PH raised, and the wall.
It shows whether PH on the refined batch certifies a bound in the JAX
package where it does not in the port.  Not a test: the JAX package
takes ~5 minutes on the CPU.  From the repo root:

    JAX_PLATFORMS=cpu python tests/soc_ph_witness.py --impl jax
    python tests/soc_ph_witness.py --impl torch --device cuda
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

BF, CASE, SLOTS = (2, 2), "ieee14", 8
ROUNDS = 7
REFINE_OPTS = {"pdhg_eps": 1e-5, "pdhg_max_iters": 8000}
# solver eps -> iteration cap: the JAX test's, then the phase's (PH's
# options in chip_smoke.SOC_PH_OPTS)
ITER0 = {1e-6: 100000, 1e-4: 20000}


def _jax_refine():
    from torch_parity import ONE

    from mpisppy_tpu.models import acopf3 as jacopf3
    from mpisppy_tpu.opt.ef import ExtensiveForm
    warm = {"x": None, "y": None}

    def solve(b):
        # soc_refine's own solve, on one device: its EF pads the batch
        # to the 8 virtual devices otherwise
        ef = ExtensiveForm(dict(REFINE_OPTS), list(b.tree.scen_names),
                           batch=b, mesh=ONE)
        ef.solve_extensive_form(certify=False, x0=warm["x"], y0=warm["y"])
        warm["x"], warm["y"] = ef._result.x, ef._result.y
        return (np.asarray(ef._result.x)[:b.num_scens],
                float(ef.get_objective_value()))

    b = jacopf3.build_soc_batch(BF, case=CASE, soc_cut_slots=SLOTS)
    return jacopf3.soc_refine(b, rounds=ROUNDS, opts=dict(REFINE_OPTS),
                              solve=solve)


def _torch_refine(device):
    from mpisppy_tpu_torch.models import acopf3
    b = acopf3.build_soc_batch(BF, case=CASE, soc_cut_slots=SLOTS,
                               device=device)
    return acopf3.soc_refine(b, rounds=ROUNDS, opts=dict(REFINE_OPTS))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default="jax", choices=("jax", "torch"))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--eps", default="1e-6,1e-4")
    args = ap.parse_args(argv)

    if args.impl == "jax":
        import conftest  # noqa: F401  (the JAX CPU platform, x64)
        from torch_parity import ONE

        from mpisppy_tpu.opt.ph import PH as JPH
    else:
        import torch

        from mpisppy_tpu_torch import disable_tictoc_output
        from mpisppy_tpu_torch.opt.ph import PH
        disable_tictoc_output()
        if args.device == "cpu":
            torch.set_num_threads(4)
    t = time.time()
    b2, hist = (_jax_refine() if args.impl == "jax"
                else _torch_refine(args.device))
    refine = {"impl": args.impl, "device": args.device,
              "shape": [int(b2.num_scens), int(b2.num_rows),
                        int(b2.num_vars)],
              "rounds": ROUNDS, "refine_opts": REFINE_OPTS,
              "objectives": [h[1] for h in hist],
              "max_violations": [h[2] for h in hist],
              "cuts": [h[3] for h in hist], "refine_s": time.time() - t}
    print(json.dumps(refine), flush=True)
    for eps in (float(e) for e in args.eps.split(",")):
        opts = {"defaultPHrho": 50.0, "PHIterLimit": 10,
                "convthresh": 1e-6, "pdhg_eps": eps,
                "pdhg_max_iters": ITER0[eps]}
        names = list(b2.tree.scen_names)
        ph = (JPH(dict(opts), names, batch=b2, mesh=ONE)
              if args.impl == "jax"
              else PH(dict(opts), names, batch=b2, device=args.device))
        line = {"impl": args.impl, "device": args.device, "eps": eps,
                "pdhg_max_iters": ITER0[eps]}
        t = time.time()
        try:
            conv, eobj, triv = ph.ph_main()
            xhat_obj, feas = ph.evaluate_xhat(ph.state.xbar)
            line.update(iter0_feas_mass=float(ph.iter0_feas_mass),
                        trivial_bound=float(triv), eobj=float(eobj),
                        conv=float(conv), xhat_obj=float(xhat_obj),
                        xhat_feasible=bool(feas))
        except RuntimeError as e:
            line["error"] = str(e)
        line["s"] = time.time() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
