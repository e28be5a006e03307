"""Runs the serve phases of `chip_smoke.py` alone on the card, with the
wall of each: the build, the grouped kernel rows (phase e), `serve`,
`serve_net`, `serve_bucket`, and the checkpoint phase (two f64
farmer-100 PH runs, which must be bit-equal).

    python tests/serve_phase_witness.py [--bench-depth]

`--bench-depth` runs the serve rows at bench.py's own PH iterations
(200 in the serve row, 50 in the chaos and wire rows) and the bucket's
Iter0 at the bench's 1e-5, the settings the script cuts.  Each phase's
line is printed as the script prints it, then one JSON line of walls;
the lines also go to chiprun_out/serve_phase_witness.jsonl.
"""

import argparse
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench-depth", action="store_true")
    args = ap.parse_args()
    import torch

    from mpisppy_tpu_torch import disable_tictoc_output
    from mpisppy_tpu_torch.utils.mfu import cuda_peaks
    disable_tictoc_output()
    if args.bench_depth:
        cs.SERVE_OPTS["PHIterLimit"] = 200
        cs.SERVE_CHAOS_OPTS["PHIterLimit"] = 50
        cs.BUCKET_OPTS["pdhg_eps"] = 1e-5
    os.makedirs("chiprun_out", exist_ok=True)
    log = open(os.path.join("chiprun_out", "serve_phase_witness.jsonl"),
               "w")
    emit = cs.emit

    def tee(obj):
        emit(obj)
        log.write(json.dumps(obj) + "\n")
        log.flush()

    cs.emit = tee
    walls, failed = {}, {}
    t = time.time()
    cs.build_phase()
    walls["build"] = time.time() - t
    name = torch.cuda.get_device_name(0)
    peak_name, (bw, f32p, f64p) = cuda_peaks(name)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    steps = {"grouped_kernel_rows": lambda: cs.grouped_kernel_rows(
        peak_name, bw, f32p, f64p, n_sm)}
    steps.update((fn, getattr(cs, fn)) for fn in (
        "serve_row", "serve_net_row", "serve_bucket", "checkpoint_phase"))
    for fn, step in steps.items():
        t = time.time()
        try:
            step()
        except Exception:           # the other phases still run
            failed[fn] = traceback.format_exc()[-3000:]
        walls[fn] = time.time() - t
    tee({"witness": "serve_phase", "device": name,
         "nvidia_smi": cs.nvidia_smi(), "bench_depth": args.bench_depth,
         "walls_s": walls, "failed": failed})
    log.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
