"""The steps of `bench.py`'s uc1000 row on the PyTorch port, one at a
time, each timed: UC at full width (21 units, 24 h: M=2502, N=1536, one
shared matrix, f32) with the row's options, at a chosen scenario count.

Steps: the build and prep, Iter0, 5 PH iterations, one Lagrangian
bound, the 5 threshold commitments screened in one stacked solve, one
xhat solve of the best of them, one 64-flip screening launch of a 1-opt
sweep (screen_eps=3e-3, screen_cap=2000) run twice, and the
consensus-EF dual bound.  Each step prints one JSON line (wall, chunks
on the matmul and consensus routes, peak device memory) as it ends.
`chip_smoke.py`'s `uc` phase cuts its depth from these walls.  This is
not a test: at S=1000 it takes ~7 minutes on an H100.  From the repo
root:

    python tests/uc_steps_witness.py --scens 1000
    python tests/uc_steps_witness.py --scens 4 --device cpu --hours 6 \\
        --fleet 1

It imports the port only.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# bench.py's uc1000 options on an accelerator (f32, bench.py:336-374)
BENCH_OPTS = {"defaultPHrho": 50.0, "PHIterLimit": 25, "convthresh": 0.0,
              "pdhg_eps": 1e-4, "superstep_eps": 1e-4,
              "lagrangian_eps": 1e-4, "pdhg_max_iters": 20000,
              "iter0_infeasibility_ok": True, "iter0_certify": False,
              "certify_max_iters": 30000}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scens", type=int, default=1000)
    ap.add_argument("--hours", type=int, default=24)
    ap.add_argument("--fleet", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from mpisppy_tpu_torch import disable_tictoc_output
    from mpisppy_tpu_torch.models import uc
    from mpisppy_tpu_torch.ops import pdhg
    from mpisppy_tpu_torch.opt.ef import ef_dual_bound
    from mpisppy_tpu_torch.opt.ph import PH
    disable_tictoc_output()
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def peak_gb():
        return torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None

    S = args.scens

    def step(name, fn):
        m0, c0 = pdhg.matmul_chunks, pdhg.consensus_chunks
        t = time.time()
        out = fn()
        sync()
        print(json.dumps({
            "S": S, "step": name, "s": time.time() - t,
            "matmul_chunks": pdhg.matmul_chunks - m0,
            "consensus_chunks": pdhg.consensus_chunks - c0,
            "peak_gb": peak_gb(),
            "value": out if isinstance(out, (int, float)) else None}),
            flush=True)
        return out

    print(json.dumps({"device": torch.cuda.get_device_name(dev) if cuda
                      else "cpu", "torch": torch.__version__}), flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    names = uc.scenario_names_creator(S)
    holder = {}

    def setup():
        b = uc.build_batch(S, H=args.hours, fleet_multiplier=args.fleet,
                           dtype=np.float32, device=dev)
        holder["b"] = b
        holder["ph"] = PH(dict(BENCH_OPTS), names, batch=b, device=dev)

    step("setup (build + prep)", setup)
    b, ph = holder["b"], holder["ph"]
    step("iter0", ph.Iter0)
    for k in range(5):
        step(f"ph_iteration_{k + 1}", ph.ph_iteration)
    step("lagrangian", ph.lagrangian_bound)
    cands = uc.commitment_candidates(b, ph.root_xbar())
    objs, feas, mass = step("candidate_screen", lambda: (
        ph.evaluate_candidates(cands, return_mass=True)))
    print(json.dumps({"threshold_objs": objs.tolist(),
                      "feas": feas.tolist(), "mass": mass.tolist()}),
          flush=True)
    best = cands[int(np.argmin(np.where(feas, objs, np.inf)))]
    step("xhat", lambda: ph.evaluate_xhat(best)[0])
    GH = best.size // 2
    flips = []
    for j in range(min(64, GH)):
        u = best[:GH].copy()
        u[j] = 1.0 - u[j]
        flips.append(np.concatenate([u, uc._derive_startups(b, u)]))
    flips = np.stack(flips)
    for name in ("flip64_screen", "flip64_screen_again"):
        step(name, lambda: int(ph.evaluate_candidates(
            flips, eps=3e-3, iters_cap=2000, tol=3e-2)[1].sum()))
    step("ef_dual_bound", lambda: ef_dual_bound(b, names, device=dev)[0])


if __name__ == "__main__":
    main()
