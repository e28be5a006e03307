"""bench.py's farmer_stream row at chip_smoke.py's `stream` settings
(STREAM_OPTS: S = 1,000,000 farmer scenarios, crops_multiplier 1,
split-native blocks of 256, BM with h 2.0, h' 0.35, eps 200, solver eps
1e-5, superstep eps 1e-4, a certification every 5 supersteps, float32),
run by the JAX package on the CPU (one device, x64 off) or by the port
on the CPU or the card.

It prints one JSON line per certification (superstep, sample size,
G, s, stop) and a last line with the verdict, the supersteps, the
sampled scenarios, the CI and the wall.  `--record FILE` writes that
trajectory as JSON: chip_smoke.py's `stream` phase holds the port to
the JAX package's (tests/stream_witness_jax.json).  Not a test: the
JAX package takes minutes on the CPU.  From the repo root:

    JAX_PLATFORMS=cpu python tests/stream_witness.py --impl jax \\
        --record tests/stream_witness_jax.json
    python tests/stream_witness.py --impl torch --device cuda
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parent))

import chip_smoke  # noqa: E402  (the phase's settings)


def _tracing(cls):
    class Tracing(cls):
        def _certify_step(self):
            n0 = len(self._est_history)
            out = super()._certify_step()
            if len(self._est_history) > n0:
                n, G, s = self._est_history[-1]
                print(json.dumps({"superstep": int(self.state.it), "n": n,
                                  "G": G, "s": s,
                                  "stop": self.certified is not None}),
                      flush=True)
            return out
    return Tracing


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default="jax", choices=("jax", "torch"))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--scens", type=int, default=chip_smoke.STREAM_S)
    ap.add_argument("--iters", type=int, default=chip_smoke.STREAM_ITERS)
    ap.add_argument("--record", default=None)
    args = ap.parse_args(argv)
    opts = dict(chip_smoke.STREAM_OPTS, PHIterLimit=args.iters)
    cfg = dict(chip_smoke.STREAM_SOURCE_CFG)
    if args.impl == "jax":
        from mpisppy_tpu.utils.platform import ensure_cpu_backend
        ensure_cpu_backend(force=True)
        import jax
        jax.config.update("jax_enable_x64", False)   # float32, as a TPU
        from mpisppy_tpu import disable_tictoc_output
        from mpisppy_tpu.models import farmer
        from mpisppy_tpu.parallel.mesh import ScenarioMesh
        from mpisppy_tpu.streaming.streaming_ph import StreamingPH
        disable_tictoc_output()
        cfg.pop("dtype")
        src = farmer.scenario_source(args.scens, cfg)
        sph = _tracing(StreamingPH)(
            opts, src, module=farmer,
            mesh=ScenarioMesh(devices=jax.devices()[:1]))
    else:
        import torch

        from mpisppy_tpu_torch import disable_tictoc_output
        from mpisppy_tpu_torch.models import farmer
        from mpisppy_tpu_torch.streaming.streaming_ph import StreamingPH
        disable_tictoc_output()
        if args.device == "cpu":
            torch.set_num_threads(4)
        src = farmer.scenario_source(args.scens, cfg)
        sph = _tracing(StreamingPH)(opts, src, module=farmer,
                                    device=args.device)
    t = time.time()
    sph.stream_main(finalize=False)
    st = sph.stream_stats()
    out = {"impl": args.impl, "device": args.device, "scens": args.scens,
           "superstep_cap": args.iters, "options": opts,
           "certified": sph.certified is not None,
           "certified_at": int(sph.state.it) if sph.certified else None,
           "ci_gap": st["ci_gap"], "est_history": st["est_history"],
           "supersteps": st["supersteps"],
           "sampled_scenarios": st["sampled_scenarios"],
           "blocks_loaded": st["blocks_loaded"],
           "xbar": [float(v) for v in sph.xbar_host],
           "conv": float(sph.conv), "s": time.time() - t}
    print(json.dumps(out), flush=True)
    if args.record:
        with open(args.record, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())
