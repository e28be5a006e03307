"""`chip_smoke.py`'s `wheel_row` and `wheel_row_telemetry` (farmer
S=100, f32, a PH hub with a Lagrangian and an XhatShuffle spoke in
threads mode) spun several times on the card, with the smoke's checks
recorded instead of raised, to see how often a row ends without a
finite bound.

It prints one JSON line per spin: the failed checks, the bounds, the
steps each spoke took (and those on fresh hub data), the bound rejects
and the f64 certifies.  This is not a test; it needs the card:

    python tests/wheel_row_repeat.py --repeats 4
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

KEYS = ("wall_s", "best_outer", "best_inner", "steps_per_spoke",
        "fresh_steps_per_spoke", "spoke_step_s", "bound_rejects",
        "f64_certifies", "certify_s", "corrupt_reads")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=4)
    args = ap.parse_args(argv)
    from mpisppy_tpu_torch import disable_tictoc_output
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.opt.ef import ExtensiveForm
    disable_tictoc_output()
    fails = []
    cs.check = lambda cond, msg: None if cond else fails.append(msg)
    cs.build_phase()
    names = farmer.scenario_names_creator(cs.WHEEL_S)
    batch = farmer.build_batch(cs.WHEEL_S, dtype=np.float32)
    ef = ExtensiveForm({"pdhg_eps": 1e-7, "pdhg_max_iters": 400000},
                       names, batch=farmer.build_batch(cs.WHEEL_S))
    ef.solve_extensive_form()
    opt = ef.get_objective_value()
    for i in range(args.repeats):
        for tel in (False, True):
            fails.clear()
            t = time.time()
            try:
                if tel:
                    row = cs.wheel_row_telemetry(names, batch,
                                                 {"wall_s": 1.0}, opt)
                else:
                    _, row = cs.spin_wheel(*cs.wheel_row_dicts(
                        names, batch, cs.WHEEL_OPTS), "threads")
                out = {k: row.get(k) for k in KEYS}
            except Exception as e:      # a check that raised inside
                out = {"error": repr(e), "s": time.time() - t}
            print(json.dumps({"run": i, "telemetry": tel,
                              "fails": list(fails), **out}), flush=True)


if __name__ == "__main__":
    main()
