"""WheelSpinner — hub-and-spoke orchestration on one device (port of
`mpisppy_tpu/spin_the_wheel.py`).

Two modes share all algorithm code:
* "interleaved" (the default): after each hub iteration PHHub.sync()
  pushes W and nonants, runs every spoke's `step()` inline and pulls
  the bounds; hub and spokes share one device queue;
* "threads": each spoke loops its `main()` in a host thread against
  the same windows.  The threads issue their kernels to the same CUDA
  stream, so their device work runs one after another.

The spokes share the hub's ScenarioBatch, its device and, where the
opt classes agree on the column scaling, its PreparedBatch: no solve
writes into a prep in place, so one prep serves every thread.

Dict schema (that of the JAX package and the `utils/vanilla` factories):
    hub_dict   = {"hub_class": PHHub, "hub_kwargs": {"options": {...}},
                  "opt_class": PH,    "opt_kwargs": {...}}
    spoke_dict = {"spoke_class": ..., "spoke_kwargs": {"options": ...},
                  "opt_class": ...,   "opt_kwargs": {...}}

With telemetry on, each spoke records on its own trace row
("spoke<i>:<class>"), and a telemetry `dir` receives trace.json (hub
and spokes merged on one timeline) and metrics.jsonl after the spin.

Not ported yet (ROADMAP.md queue A): `mode="multiproc"` and the native
window (item 11), with the per-process telemetry files it merges,
`resume_from` (item 6), and the "device" / "collective" exchange
backends and `MPMDWheel` (item 13).  Each raises where selected.
"""

from __future__ import annotations

import os
import threading

from . import global_toc, not_ported
from . import telemetry as _telemetry
from .cylinders.spcommunicator import _UNPORTED_BACKENDS
from .device import host
from .ir import SplitA

MODES = ("interleaved", "threads")


class WheelSpinner:
    def __init__(self, hub_dict, list_of_spoke_dict=(), mode="interleaved",
                 keep_workdir=False, resume_from=None,
                 exchange_backend=None):
        if mode == "multiproc":
            raise not_ported('WheelSpinner mode="multiproc"', 11)
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if keep_workdir:
            raise not_ported("keep_workdir (multiproc mode's workdir)", 11)
        if resume_from is not None:
            raise not_ported("WheelSpinner(resume_from=...)", 6)
        if exchange_backend in _UNPORTED_BACKENDS:
            raise not_ported(f"exchange_backend={exchange_backend!r}",
                             _UNPORTED_BACKENDS[exchange_backend])
        if exchange_backend not in (None, "auto", "seqlock", "python"):
            raise ValueError(f"unknown exchange_backend {exchange_backend!r}")
        self._validate(hub_dict, list_of_spoke_dict)
        self.hub_dict = hub_dict
        self.list_of_spoke_dict = list(list_of_spoke_dict)
        self.mode = mode
        self.exchange_backend = exchange_backend
        self.exchange_backend_used = None
        self.spcomm = None

    @staticmethod
    def _validate(hub_dict, spoke_dicts):
        for k in ("hub_class", "opt_class", "opt_kwargs"):
            if k not in hub_dict:
                raise RuntimeError(f"hub_dict missing key {k}")
        for sd in spoke_dicts:
            for k in ("spoke_class", "opt_class", "opt_kwargs"):
                if k not in sd:
                    raise RuntimeError(f"spoke_dict missing key {k}")

    def spin(self):
        hd = self.hub_dict
        global_toc("WheelSpinner: constructing hub optimizer")
        hub_opt = hd["opt_class"](**hd["opt_kwargs"])

        spokes = []
        for sd in self.list_of_spoke_dict:
            kw = dict(sd["opt_kwargs"])
            # every cylinder shares the hub's batch and device
            kw.setdefault("batch", hub_opt.batch)
            kw.setdefault("device", hub_opt.device)
            # and its PreparedBatch, when the spoke's opt class uses the
            # same column scaling and accepts the hub's prep form (a
            # class that indexes prep.A densely must not get a SplitA)
            if (kw.get("batch") is hub_opt.batch
                    and sd["opt_class"]._shared_cols
                    == hd["opt_class"]._shared_cols
                    and (getattr(sd["opt_class"], "_use_split_prep", True)
                         or not isinstance(hub_opt.prep.A, SplitA))):
                kw.setdefault("prep", hub_opt.prep)
            sp_opt = sd["opt_class"](**kw)
            spoke = sd["spoke_class"](
                sp_opt, options=sd.get("spoke_kwargs", {}).get("options"))
            # each spoke gets its own row of the merged trace
            spoke.telemetry_track = (
                f"spoke{len(spokes)}:{type(spoke).__name__}")
            spokes.append(spoke)

        hub_options = dict(hd.get("hub_kwargs", {}).get("options") or {})
        # on one device "auto" (and "seqlock") resolve to the host
        # seqlock, as in the JAX package; a window_backend in the hub
        # options wins
        hub_options.setdefault("window_backend", "python")
        self.exchange_backend_used = hub_options["window_backend"]
        hub = hd["hub_class"](hub_opt, spokes, options=hub_options)
        hub.setup_hub()
        self.spcomm = hub

        if self.mode == "threads" and spokes:
            self._spin_threads(hub, spokes)
        else:
            hub.drive_spokes_inline = True
            hub.main()
            hub.send_terminate()

        # final spoke passes; a spoke that failed is out of the wheel
        for sp in spokes:
            if getattr(sp, "_failed", False):
                continue
            try:
                sp.finalize()
            except Exception as e:     # a failing final pass must not
                # eat the results; it is kept in hub.finalize_failures
                hub.finalize_failures.append((type(sp).__name__, str(e)))
                global_toc(f"spoke finalize failed: {e}")
        hub.hub_finalize()
        self._flush_telemetry()
        return self

    def _flush_telemetry(self):
        """Write trace.json (hub and spoke rows merged on one timeline)
        and metrics.jsonl into the configured telemetry dir; a no-op
        when telemetry is off or has no dir."""
        tel = getattr(self.spcomm, "telemetry", None) or _telemetry.get()
        path = tel.flush()
        if path is not None:
            global_toc(f"WheelSpinner: telemetry written to "
                       f"{os.path.dirname(path)}")

    @staticmethod
    def _spin_threads(hub, spokes):
        hub.drive_spokes_inline = False

        def guarded_main(sp):
            try:
                sp.main()
            except Exception as e:
                # the hub thread prunes (the wiring sets must not change
                # under the hub's own iteration)
                hub.report_spoke_failure(sp, e)

        threads = [threading.Thread(target=guarded_main, args=(sp,),
                                    daemon=True)
                   for sp in spokes]
        for t in threads:
            t.start()
        try:
            hub.main()
        finally:
            hub.send_terminate()
            # bounded join, per thread: a spoke stuck in a solve must not
            # block shutdown; one still alive at its deadline is pruned
            # like a crashed one and finalize skips it
            join_timeout = float(hub.options.get(
                "shutdown_join_timeout", 120.0))
            for t, sp in zip(threads, spokes):
                t.join(timeout=join_timeout)
                if t.is_alive():
                    hub.report_spoke_failure(sp, TimeoutError(
                        f"spoke did not exit within {join_timeout:.0f}s "
                        "of the kill signal"))
        hub._drain_failures()

    # -- results ----------------------------------------------------------
    @property
    def BestInnerBound(self):
        return self.spcomm.BestInnerBound

    @property
    def BestOuterBound(self):
        return self.spcomm.BestOuterBound

    def on_hub(self):
        return True

    def best_nonant_solution(self):
        """Incumbent (S, K) or (K,) nonants of the winning inner-bound
        spoke, else the hub's consensus x̄ (host arrays)."""
        sol = self.spcomm.best_nonant_solution
        if sol is None and self.spcomm.opt.state is not None:
            sol = host(self.spcomm.opt.state.xbar)
        return sol

    def write_first_stage_solution(self, path):
        sol = self.best_nonant_solution()
        if sol is None:
            raise RuntimeError("no solution available")
        root = sol if sol.ndim == 1 else sol[0]
        K = self.spcomm.opt.batch.num_nonants
        self.spcomm.opt.write_first_stage_solution(path, root[:K])

    def write_tree_solution(self, directory):
        opt = self.spcomm.opt
        if opt.state is None:
            raise RuntimeError("hub has no solution state")
        opt.write_tree_solution(directory, opt.state.x)
