"""The bench's `wheel_mpmd` row (farmer, a PH hub with a Lagrangian and
an XhatShuffle spoke, rel_gap 1e-4, abs_gap 1.0, 40 PH iterations,
bench.py:1083-1124 without its telemetry option) in the JAX package or
in the PyTorch port, in f32 or f64, interleaved or in threads, so that
the two packages' hub bound traces can be laid side by side.

It prints one JSON line: the bounds, the gap as the bench computes it,
whether it certified, and the trace of (iteration, BestOuterBound,
BestInnerBound, outer char, inner char) at every sync.  This is not a
test (minutes on a CPU at S=100).  Run it from the repo root:

    python tests/wheel_witness.py --impl jax --scens 100 --dtype f32
    python tests/wheel_witness.py --impl torch --scens 100 --dtype f32
    python tests/wheel_witness.py --impl torch --device cuda --scens 100

The JAX run uses one CPU device (`JAX_PLATFORMS=cpu` is set here) and
enables x64 only for --dtype f64.  Each run imports one package only.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 40, "convthresh": 0.0,
        "pdhg_eps": 1e-7, "pdhg_max_iters": 30000}
HUB_OPTS = {"rel_gap": 1e-4, "abs_gap": 1.0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--scens", type=int, default=100)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--mode", choices=("interleaved", "threads"),
                    default="interleaved")
    ap.add_argument("--device", default="cpu", help="torch only")
    args = ap.parse_args()
    dtype = np.float32 if args.dtype == "f32" else np.float64
    if args.impl == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax
        jax.config.update("jax_enable_x64", args.dtype == "f64")
        from mpisppy_tpu import disable_tictoc_output
        from mpisppy_tpu.cylinders.hub import PHHub
        from mpisppy_tpu.cylinders.lagrangian_bounder import (
            LagrangianOuterBound)
        from mpisppy_tpu.cylinders.xhatshufflelooper_bounder import (
            XhatShuffleInnerBound)
        from mpisppy_tpu.models import farmer
        from mpisppy_tpu.opt.ph import PH
        from mpisppy_tpu.parallel.mesh import ScenarioMesh
        from mpisppy_tpu.spin_the_wheel import WheelSpinner
        from mpisppy_tpu.utils.xhat_eval import Xhat_Eval
        batch = farmer.build_batch(args.scens, dtype=dtype)
        hub_kw = {"mesh": ScenarioMesh(devices=jax.devices()[:1])}
    else:
        from mpisppy_tpu_torch import disable_tictoc_output
        from mpisppy_tpu_torch.cylinders.hub import PHHub
        from mpisppy_tpu_torch.cylinders.lagrangian_bounder import (
            LagrangianOuterBound)
        from mpisppy_tpu_torch.cylinders.xhatshufflelooper_bounder import (
            XhatShuffleInnerBound)
        from mpisppy_tpu_torch.models import farmer
        from mpisppy_tpu_torch.opt.ph import PH
        from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
        from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval
        batch = farmer.build_batch(args.scens, dtype=dtype,
                                   device=args.device)
        hub_kw = {"device": args.device}
    disable_tictoc_output()
    trace = []

    class TracingHub(PHHub):
        def screen_trace(self):
            trace.append((self.current_iteration(),
                          float(self.BestOuterBound),
                          float(self.BestInnerBound), self.latest_ob_char,
                          self.latest_ib_char))
            return super().screen_trace()

    names = [f"scen{i}" for i in range(args.scens)]
    hub = {"hub_class": TracingHub, "hub_kwargs": {"options": HUB_OPTS},
           "opt_class": PH,
           "opt_kwargs": {"options": dict(OPTS), "all_scenario_names": names,
                          "batch": batch, **hub_kw}}
    spokes = [{"spoke_class": cls, "spoke_kwargs": {"options": {}},
               "opt_class": ocls,
               "opt_kwargs": {"options": dict(OPTS),
                              "all_scenario_names": names}}
              for cls, ocls in ((LagrangianOuterBound, PH),
                                (XhatShuffleInnerBound, Xhat_Eval))]
    t0 = time.time()
    ws = WheelSpinner(hub, spokes, mode=args.mode).spin()
    outer, inner = float(ws.BestOuterBound), float(ws.BestInnerBound)
    gap = abs(inner - outer) / max(1.0, abs(inner))     # bench.py:1155
    print(json.dumps({"impl": args.impl, "scens": args.scens,
                      "dtype": args.dtype, "mode": args.mode,
                      "wall_s_host": time.time() - t0, "outer": outer,
                      "inner": inner, "gap": gap,
                      "certified": gap <= HUB_OPTS["rel_gap"],
                      "supersteps": ws.spcomm.current_iteration(),
                      "trace": trace}))


if __name__ == "__main__":
    main()
