"""Measurements behind the `algorithms` phase of `chip_smoke.py` that
take too long for the script itself, on one NVIDIA card:

* `mip`: examples/sizes_ef_mip.py's examples/run_all.py row (sizes-3,
  the example's options) through `opt/mip.ExtensiveFormMIP`, the
  reference golden (incumbent 220000 at 2 significant figures) and its
  wall (`alg_sizes_mip`);
* `bundles`: chip_smoke.py's `alg_bundles` sub-run alone.

One JSON line per measurement, also written to
chiprun_out/algorithms_witness.jsonl.  Not a test: run it from the repo
root on the card,

    python3 tests/algorithms_witness.py bundles,mip

It builds the chunk kernel as chip_smoke.py does and imports nothing
of jax or the JAX package.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUT = ROOT / "chiprun_out" / "algorithms_witness.jsonl"
ALG_SIZES_MIP_ARGV = ["--num-scens", "3", "--solver-eps", "1e-6"]


def main(parts):
    import torch

    import chip_smoke as cs
    from mpisppy_tpu_torch import disable_tictoc_output
    if not torch.cuda.is_available():
        print("algorithms_witness: needs a CUDA card", file=sys.stderr)
        return 1
    disable_tictoc_output()
    os.makedirs(OUT.parent, exist_ok=True)
    with open(OUT, "w") as log:
        def emit(obj):
            print(json.dumps(obj), flush=True)
            log.write(json.dumps(obj) + "\n")
            log.flush()

        cs.emit = emit
        print(cs.nvidia_smi(), flush=True)
        cs.build_phase()
        if "mip" in parts:
            cs._alg_line("alg_sizes_mip", lambda: alg_sizes_mip(cs))
        if "bundles" in parts:
            cs._alg_line("alg_bundles", cs.alg_bundles)
    return 0


def alg_sizes_mip(cs):
    """examples/sizes_ef_mip.py's examples/run_all.py row (sizes-3, f64,
    the example's options): the incumbent is 220000 at 2 significant
    figures (the reference golden), bound <= incumbent, the LP count."""
    from mpisppy_tpu_torch.models import sizes
    from mpisppy_tpu_torch.opt.mip import ExtensiveFormMIP
    from mpisppy_tpu_torch.utils import config
    cfg = config.Config()
    cfg.popular_args()
    sizes.inparser_adder(cfg)
    cfg.parse_command_line("sizes_ef_mip", args=ALG_SIZES_MIP_ARGV)
    batch = sizes.build_batch(cfg.num_scens,
                              num_sizes=cfg.get("num_sizes", 10))
    ef = ExtensiveFormMIP(
        {"pdhg_eps": cfg.get("solver_eps", 1e-6),
         "pdhg_max_iters": cfg.get("solver_max_iters", 200000)},
        sizes.scenario_names_creator(cfg.num_scens), batch=batch)
    out = ef.solve_mip()
    inc, bound = out["incumbent"], out["bound"]
    cs.check(cs.round_pos_sig(inc) == 220000.0,
             f"alg_sizes_mip: incumbent {inc} is not 220000 at 2 figures")
    cs.check(bound <= inc, f"alg_sizes_mip: bound {bound} above {inc}")
    return {"S": batch.num_scens, "M": batch.num_rows, "N": batch.num_vars,
            "argv": ALG_SIZES_MIP_ARGV, "incumbent": inc, "bound": bound,
            "gap": out["gap"], "viol": out["viol"],
            "lp_solves": out["lp_solves"], "rounds": out["rounds"]}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1].split(",")))
