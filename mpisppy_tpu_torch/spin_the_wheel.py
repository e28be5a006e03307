"""WheelSpinner — hub-and-spoke orchestration on one device (port of
`mpisppy_tpu/spin_the_wheel.py`).

Three modes share all algorithm code:
* "interleaved" (the default): after each hub iteration PHHub.sync()
  pushes W and nonants, runs every spoke's `step()` inline and pulls
  the bounds; hub and spokes share one device queue;
* "threads": each spoke loops its `main()` in a host thread against
  the same windows.  The threads issue their kernels to the same CUDA
  stream, so their device work runs one after another;
* "multiproc": each spoke is its own OS process (`cylinders/proc.py`)
  over the native seqlock's mmap window files, on the hub's device (a
  CUDA hub's children each open a context on the card), supervised by
  `resilience.supervisor.SpokeSupervisor`.  Spoke dicts carry a "proc"
  key with a declarative batch spec.  The window files and the
  children's logs live in a temporary workdir, removed after a healthy
  run unless `keep_workdir`.  The hub waits up to
  SPOKE_READY_TIMEOUT_S seconds for every child to build its spoke and
  attach before its first iteration: a child's start-up (torch's
  import, a context on the card) can outlast a short hub run.

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
and spokes merged on one timeline; a multiproc child writes its own
trace and metrics files there, and its trace is merged in) and
metrics.jsonl after the spin.

`resume_from=` restores the hub optimizer's PH state and the hub's
best bounds and incumbent from a run checkpoint
(`resilience/checkpoint.py`); a missing file means a fresh start.
`exchange_backend="native"` puts the in-process modes on the native
seqlock.

Not ported yet (ROADMAP.md queue A item 13): the "device" /
"collective" exchange backends and `MPMDWheel`, which raise where
selected.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time

from . import global_toc, not_ported
from . import telemetry as _telemetry
from .cylinders.spcommunicator import _UNPORTED_BACKENDS
from .device import host
from .ir import SplitA

MODES = ("interleaved", "threads", "multiproc")
# how long a multiproc hub waits for its children to attach before its
# first iteration (a child takes seconds to import torch and reach the
# card)
SPOKE_READY_TIMEOUT_S = 300.0


class WheelSpinner:
    def __init__(self, hub_dict, list_of_spoke_dict=(), mode="interleaved",
                 keep_workdir=False, resume_from=None,
                 exchange_backend=None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if exchange_backend in _UNPORTED_BACKENDS:
            raise not_ported(f"exchange_backend={exchange_backend!r}",
                             _UNPORTED_BACKENDS[exchange_backend])
        if exchange_backend not in (None, "auto", "seqlock", "python",
                                    "native"):
            raise ValueError(f"unknown exchange_backend {exchange_backend!r}")
        self._validate(hub_dict, list_of_spoke_dict)
        self.hub_dict = hub_dict
        self.list_of_spoke_dict = list(list_of_spoke_dict)
        self.mode = mode
        self.exchange_backend = exchange_backend
        self.exchange_backend_used = None
        self.spcomm = None
        # multiproc mode: keep the window files and logs after the run
        self.options_keep_workdir = keep_workdir
        self.workdir = None
        self.child_info = []      # each child's info file (multiproc)
        # multiproc: seconds waiting for the children, and of the hub's
        # own loop after that
        self.ready_wait_s = self.hub_loop_s = None
        # crash-resume: the hub optimizer restores its PH state (PH
        # reads options["resume_from"]), the hub its bounds
        self.resume_from = resume_from
        if resume_from is not None:
            kw = dict(self.hub_dict["opt_kwargs"])
            kw["options"] = dict(kw.get("options") or {},
                                 resume_from=resume_from)
            self.hub_dict = dict(self.hub_dict, opt_kwargs=kw)

    @staticmethod
    def _validate(hub_dict, spoke_dicts):
        for k in ("hub_class", "opt_class", "opt_kwargs"):
            if k not in hub_dict:
                raise RuntimeError(f"hub_dict missing key {k}")
        for sd in spoke_dicts:
            for k in ("spoke_class", "opt_class", "opt_kwargs"):
                if k not in sd:
                    raise RuntimeError(f"spoke_dict missing key {k}")

    def _restore_hub_bounds(self, hub):
        from .resilience.checkpoint import checkpoint_exists, restore_hub
        if self.resume_from is not None \
                and checkpoint_exists(self.resume_from):
            restore_hub(self.resume_from, hub)
            global_toc(f"WheelSpinner: hub bounds restored from "
                       f"{self.resume_from}")

    def spin(self):
        if self.mode == "multiproc":
            return self._spin_multiproc()
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
        hub_options.setdefault(
            "window_backend",
            "native" if self.exchange_backend == "native" else "python")
        self.exchange_backend_used = hub_options["window_backend"]
        hub = hd["hub_class"](hub_opt, spokes, options=hub_options)
        hub.setup_hub()
        self._restore_hub_bounds(hub)
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

    def _flush_telemetry(self, extra_trace_files=()):
        """Write trace.json (hub and spoke rows merged on one timeline,
        with the given per-process trace files) and metrics.jsonl into
        the configured telemetry dir; a no-op when telemetry is off or
        has no dir."""
        tel = getattr(self.spcomm, "telemetry", None) or _telemetry.get()
        path = tel.flush(extra_trace_files=extra_trace_files)
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

    def _proc_spec(self, i, sd, hub_opt, prefix, send, recv):
        """The declarative spec from which spoke process i rebuilds its
        spoke (cylinders/proc.py)."""
        b = hub_opt.batch
        ocls, scls, okw = sd["opt_class"], sd["spoke_class"], sd["opt_kwargs"]
        spec = {
            # the child pads to the hub's scenario count, or the W /
            # nonant window vectors would reshape differently
            "batch": dict(sd["proc"]["batch"], pad_to=b.num_scens),
            "opt_class": f"{ocls.__module__}:{ocls.__name__}",
            "spoke_class": f"{scls.__module__}:{scls.__name__}",
            "opt_options": okw.get("options", {}),
            "spoke_options": sd.get("spoke_kwargs", {}).get("options"),
            "scenario_names": list(okw["all_scenario_names"]),
            "device": str(hub_opt.device),
            "windows": {"prefix": prefix, "hub_length": recv,
                        "spoke_length": send},
        }
        # each child records into its own trace and metrics files (its
        # own pid: its own trace row), merged by the hub after shutdown
        tel = _telemetry.get()
        if tel.enabled and tel.out_dir:
            # absolute: a child runs in the workdir
            out_dir = os.path.abspath(tel.out_dir)
            os.makedirs(out_dir, exist_ok=True)
            spec["telemetry"] = {
                "enabled": True,
                "phase_timing": tel.phase_timing,
                "main_label": f"spoke{i}:{scls.__name__}",
                "trace_path": os.path.join(
                    out_dir, f"trace_spoke{i}.json"),
                "metrics_path": os.path.join(
                    out_dir, f"metrics_spoke{i}.jsonl"),
            }
        return spec

    def _spin_multiproc(self):
        """Hub and spokes as separate OS processes over the native mmap
        seqlock: the hub in this process, each spoke a child on the
        hub's device, supervised (dead and hung children restarted,
        then pruned once their restart budget is spent)."""
        from .cylinders.proc import SpokeHandle, prebuild
        from .resilience.supervisor import SpokeSupervisor

        hd = self.hub_dict
        self.workdir = workdir = tempfile.mkdtemp(
            prefix="mpisppy_tpu_torch_wheel_")
        global_toc(f"WheelSpinner[multiproc]: workdir {workdir} "
                   "(window files and per-spoke logs)")
        hub_opt = hd["opt_class"](**hd["opt_kwargs"])
        # the children load these; building them here keeps every child
        # from running the compilers itself
        prebuild(hub_opt.device)

        handles, specs = [], []
        for i, sd in enumerate(self.list_of_spoke_dict):
            if "proc" not in sd:
                raise RuntimeError(
                    "multiproc mode needs spoke_dict['proc'] with a "
                    "declarative batch spec")
            scls = sd["spoke_class"]
            # the spoke-side lengths (cylinders/spoke.py), computed on
            # the hub's batch: both sides build the same model
            b = hub_opt.batch
            recv = b.num_scens * b.num_nonants
            send = (2 * b.num_nonants + 1
                    if getattr(scls, "provides_cuts", False) else 1)
            prefix = f"{workdir}/pair{i}"
            handles.append(SpokeHandle(scls, send, recv,
                                       sol_path=prefix + ".sol.npy"))
            specs.append(self._proc_spec(i, sd, hub_opt, prefix, send,
                                         recv))

        hub = hd["hub_class"](
            hub_opt, handles,
            options=dict(hd.get("hub_kwargs", {}).get("options") or {},
                         window_backend="native",
                         window_path_prefix=f"{workdir}/pair"))
        self.exchange_backend_used = "native"
        hub.setup_hub()       # creates and resets the window files
        self._restore_hub_bounds(hub)
        self.spcomm = hub

        sup = SpokeSupervisor(hub, specs, workdir, options=hub.options)
        hub.supervisor = sup
        sup.start()
        hub.drive_spokes_inline = False
        ok = False
        try:
            t0 = time.monotonic()
            self._wait_ready(hub, handles, sup, SPOKE_READY_TIMEOUT_S)
            t1 = time.monotonic()
            hub.main()
            self.ready_wait_s = t1 - t0
            self.hub_loop_s = time.monotonic() - t1
            sup.poll(force=True)   # deaths after the last sync
            hub.send_terminate()
            sup.shutdown(timeout=float(hub.options.get(
                "shutdown_join_timeout", 120.0)))
            ok = True
        finally:
            sup.kill_all()
        hub.spoke_exit_reports = sup.exit_reports
        hub.hub_finalize()
        # a spoke process writes its solution file at its finalize,
        # after the hub read the matching bound: pair them now
        for i in hub.innerbound_idx:
            data, wid = hub.pairs[i].to_hub.read()
            sol = handles[i].best_solution
            if (wid > 0 and sol is not None
                    and float(data[0]) == hub.BestInnerBound):
                hub.best_nonant_solution = sol
        self.child_info = [h.info for h in handles]
        if ok and not self.options_keep_workdir and not sup.exit_reports:
            # window files and logs are kept when a spoke died or hung
            # (the logs are the post-mortem) or on request
            for pair in hub.pairs:
                pair.to_spoke.close()
                pair.to_hub.close()
            shutil.rmtree(workdir, ignore_errors=True)
        elif ok and sup.exit_reports:
            global_toc(f"WheelSpinner[multiproc]: spoke failure logs "
                       f"kept in {workdir}")
        child_traces = [s["telemetry"]["trace_path"] for s in specs
                        if "telemetry" in s
                        and os.path.exists(s["telemetry"]["trace_path"])]
        self._flush_telemetry(extra_trace_files=child_traces)
        return self

    @staticmethod
    def _wait_ready(hub, handles, sup, timeout):
        """Wait until every live child has attached, or `timeout`."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            sup.poll(force=True)
            if all(h.ready or sup.state[i] not in ("live", "waiting")
                   for i, h in enumerate(handles)):
                global_toc(f"WheelSpinner[multiproc]: spokes ready after "
                           f"{time.monotonic() - t0:.1f}s")
                return
            time.sleep(0.05)
        global_toc(f"WARNING: not every spoke was ready within "
                   f"{timeout:.0f}s; the hub starts anyway")

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
