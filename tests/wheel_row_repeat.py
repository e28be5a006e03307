"""`chip_smoke.py`'s `wheel_row` and `wheel_row_telemetry` (farmer
S=100, f32, a PH hub with a Lagrangian and an XhatShuffle spoke in
threads mode) spun several times on the card, with the smoke's checks
recorded instead of raised, to see how often a row ends without a
finite bound, and why.

Every xhat evaluation is logged: the fast solve's largest primal
residual and converged count, the feasibility test's tolerance, whether
the f64 certify ran and on how many scenarios, the verdict, the hub's
PH iteration and the time relative to the hub's kill signal.  Each spin
prints one JSON line: the failed checks, the bounds, the steps each
spoke took (and those on fresh hub data), the bound rejects, the f64
certifies, the evaluation counts (feasible, certified, started before
and finished after the kill) and the xhat spoke's steps at the kill.
The per-evaluation records go to `--log` (JSON lines).

`--certify-unconverged-only` restores the earlier certify selection
(re-solve the unconverged scenarios only, as the JAX package does), for
a before/after reading on the same card.  This is not a test; it needs
the card:

    python tests/wheel_row_repeat.py --repeats 8
"""

import argparse
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

KEYS = ("wall_s", "best_outer", "best_inner", "steps_per_spoke",
        "fresh_steps_per_spoke", "spoke_step_s", "bound_rejects",
        "f64_certifies", "certify_s", "corrupt_reads")


class EvalLog:
    """Per-evaluation records of the xhat spoke (Xhat_Eval), and the
    kill time and the spoke's steps at it."""

    def __init__(self, unconverged_only):
        from mpisppy_tpu_torch.cylinders.hub import Hub
        from mpisppy_tpu_torch.spopt import SPOpt
        from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval
        self.records, self.kill_t, self.steps_at_kill = [], None, None
        self.hub = None
        self._local = threading.local()
        log = self
        evaluate, resolve = Xhat_Eval.evaluate_xhat, SPOpt._certified_resolve
        feas_prob, terminate = SPOpt.feas_prob, Hub.send_terminate

        def evaluate_xhat(self, *a, **kw):
            rec = {"t0": time.time(),
                   "hub_it": log.hub.current_iteration() if log.hub else None,
                   "certified_scens": 0}
            log._local.rec = rec
            try:
                obj, feas = evaluate(self, *a, **kw)
            finally:
                log._local.rec = None
            rec.update(t1=time.time(), feas=bool(feas), obj=float(obj))
            log.records.append(rec)
            return obj, feas

        def certified_resolve(self, res, *a, select=None, **kw):
            rec = getattr(log._local, "rec", None)
            if rec is not None and isinstance(self, Xhat_Eval):
                if unconverged_only:
                    select = None          # ~res.converged
                pick = ~res.converged if select is None else select
                rec["certified_scens"] = int(
                    (pick & (self.batch.prob > 0)).sum())
            return resolve(self, res, *a, select=select, **kw)

        def feas(self, res, tol=None):
            v = feas_prob(self, res, tol)
            rec = getattr(log._local, "rec", None)
            if rec is not None and isinstance(self, Xhat_Eval) \
                    and "fast_pres_max" not in rec:
                live = self.batch.prob > 0
                rec.update(fast_pres_max=float(res.pres[live].max()),
                           fast_converged=int(res.converged[live].sum()),
                           tol=tol or 10 * float(self.solver_eps),
                           fast_feas_prob=v)
            return v

        def send_terminate(self):
            log.kill_t = time.time()
            log.steps_at_kill = {type(sp).__name__: sp.steps_done
                                 for sp in self.spokes}
            return terminate(self)

        Xhat_Eval.evaluate_xhat = evaluate_xhat
        SPOpt._certified_resolve = certified_resolve
        SPOpt.feas_prob = feas
        Hub.send_terminate = send_terminate

    def reset(self):
        self.records, self.kill_t, self.steps_at_kill = [], None, None

    def summary(self):
        kt = self.kill_t or float("inf")
        r = self.records
        return {"evaluations": len(r),
                "feasible": sum(x["feas"] for x in r),
                "certified": sum(x["certified_scens"] > 0 for x in r),
                "fast_converged_all_above_tol": sum(
                    x.get("fast_converged") == cs.WHEEL_S
                    and x.get("fast_pres_max", 0) >= x.get("tol", 1)
                    for x in r),
                "started_before_kill_finished_after": sum(
                    x["t0"] < kt <= x["t1"] for x in r),
                "xhat_steps_at_kill": self.steps_at_kill}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--certify-unconverged-only", action="store_true")
    ap.add_argument("--log", default=os.path.join(
        "chiprun_out", "wheel_row_repeat.jsonl"))
    args = ap.parse_args(argv)
    from mpisppy_tpu_torch import disable_tictoc_output
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.opt.ef import ExtensiveForm
    disable_tictoc_output()
    fails = []
    cs.check = lambda cond, msg: None if cond else fails.append(msg)
    cs.build_phase()
    log = EvalLog(args.certify_unconverged_only)
    spin = cs.spin_wheel

    def spin_and_keep_hub(hub_dict, spoke_dicts, mode):
        cls = hub_dict["hub_class"]

        class Keep(cls):
            def setup_hub(self):
                super().setup_hub()
                log.hub = self

        Keep.__name__ = cls.__name__
        hub_dict = dict(hub_dict, hub_class=Keep)
        return spin(hub_dict, spoke_dicts, mode)

    cs.spin_wheel = spin_and_keep_hub
    names = farmer.scenario_names_creator(cs.WHEEL_S)
    batch = farmer.build_batch(cs.WHEEL_S, dtype=np.float32)
    ef = ExtensiveForm({"pdhg_eps": 1e-7, "pdhg_max_iters": 400000},
                       names, batch=farmer.build_batch(cs.WHEEL_S))
    ef.solve_extensive_form()
    opt = ef.get_objective_value()
    os.makedirs(os.path.dirname(args.log) or ".", exist_ok=True)
    with open(args.log, "w") as f:
        for i in range(args.repeats):
            for tel in (False, True):
                fails.clear()
                log.reset()
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
                head = {"run": i, "telemetry": tel,
                        "certify_unconverged_only":
                            args.certify_unconverged_only}
                print(json.dumps({**head, "fails": list(fails), **out,
                                  **log.summary()}), flush=True)
                kt = log.kill_t
                for rec in log.records:
                    f.write(json.dumps({**head, **rec, "t0_after_kill": (
                        None if kt is None else rec["t0"] - kt)}) + "\n")


if __name__ == "__main__":
    main()
