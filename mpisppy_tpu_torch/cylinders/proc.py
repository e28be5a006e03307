"""Spokes as separate processes over the native seqlock exchange (port
of `mpisppy_tpu/cylinders/proc.py`).

Reference counterpart: the reference's WheelSpinner runs hub and spokes
as distinct MPI programs tied by one-sided RMA windows.  Here each
spoke runs as its own OS process (its own interpreter) and attaches to
the hub's mmap window files (`runtime/exchange.cpp`: the seqlock
protocol of the in-process modes, write_id freshness, kill =
write_id -1, no torn reads).

Unlike the JAX package, whose children are pinned to the CPU because a
TPU belongs to one process, a child here runs on the hub's device: the
spec carries it, and a child of a CUDA hub opens its own context on the
card.  A child that cannot reach its device fails (it never carries on
on the CPU), and so does a CUDA child that finds the chunk kernel's
library unbuilt: the hub process builds the kernel and the exchange
before spawning (`prebuild`), so no child runs nvcc.

A live optimizer cannot cross an exec boundary, so a spoke process
rebuilds its problem from a declarative spec:

    spec = {
      "batch": {"module": "mpisppy_tpu_torch.models.farmer",
                "builder": "build_batch",
                "kwargs": {"num_scens": 30}},
      "opt_class":   "mpisppy_tpu_torch.utils.xhat_eval:Xhat_Eval",
      "spoke_class": "mpisppy_tpu_torch.cylinders.lagrangian_bounder:"
                     "LagrangianOuterBound",
      "opt_options": {...}, "spoke_options": {...},
      "scenario_names": [...], "device": "cuda:0",
      "windows": {"prefix": "/tmp/run/pair0",
                  "hub_length": N, "spoke_length": M},
    }

Every module path of a spec must lie in `mpisppy_tpu_torch`, so that a
child never imports JAX.  The hub process creates (and resets) the
window files before spawning, so attaching children never race their
initialization.  A child writes `<prefix>.info.json` once its spoke is
built and attached (its pid and device: the wheel's readiness signal)
and again at its end, with the modules of JAX
or of the JAX package it loaded (none) and its chunk-kernel launches
by (form, S, M, N, dtype).

Run a child as `python -m mpisppy_tpu_torch.cylinders.proc <specfile>`.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np

PACKAGE = "mpisppy_tpu_torch"


def _check_module(mod: str):
    if mod != PACKAGE and not mod.startswith(PACKAGE + "."):
        raise ValueError(f"spec module {mod!r} is outside {PACKAGE}: a "
                         "spoke process imports the port only")
    return mod


def _resolve(path: str):
    mod, _, name = path.partition(":")
    return getattr(importlib.import_module(_check_module(mod)), name)


def prebuild(device):
    """Build what the children load, in the hub process: the exchange
    library, and on a CUDA device the chunk kernel's library."""
    from ..runtime import native
    native.build()
    if str(device).startswith("cuda"):
        from ..ops import pdhg_chunk
        pdhg_chunk.build()


class SpokeHandle:
    """Hub-side stand-in for a spoke that lives in another process.

    It carries what the hub's wiring needs (spoke types, display char,
    window lengths); `step()` is a no-op because the work happens in
    the other process.  An inner-bound spoke's incumbent comes back in
    a side file written at the spoke's finalize (`<prefix>.sol.npy`);
    scalar bounds travel through the window itself.
    """

    def __init__(self, spoke_class, send_length: int, receive_length: int,
                 sol_path: str | None = None):
        self.converger_spoke_types = spoke_class.converger_spoke_types
        self.converger_spoke_char = spoke_class.converger_spoke_char
        self.provides_cuts = getattr(spoke_class, "provides_cuts", False)
        self.spoke_name = spoke_class.__name__
        self._send_length = int(send_length)
        self._receive_length = int(receive_length)
        self._sol_path = sol_path
        self.pair = None
        self.proc = None

    def send_length(self):
        return self._send_length

    def receive_length(self):
        return self._receive_length

    def step(self):
        return False

    timed_step = step

    @property
    def best_solution(self):
        if self._sol_path and os.path.exists(self._sol_path):
            # written through tmp + os.replace, so never torn; a
            # malformed file degrades to "no solution"
            try:
                return np.load(self._sol_path)
            except (OSError, ValueError, EOFError):
                return None
        return None

    @property
    def ready(self):
        """True once the current child process has built its spoke and
        attached to its windows."""
        info = self.info
        return (info is not None and self.proc is not None
                and info.get("pid") == self.proc.pid)

    @property
    def info(self):
        """The child's `<prefix>.info.json` (pid, device, forbidden
        modules loaded), or None before the child wrote it."""
        if not self._sol_path:
            return None
        path = self._sol_path[:-len(".sol.npy")] + ".info.json"
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def finalize(self):
        return None


def spawn_spoke(spec: dict, workdir: str, tag: str,
                env_overrides: dict | None = None) -> subprocess.Popen:
    """Launch `python -m mpisppy_tpu_torch.cylinders.proc <specfile>`
    with the parent's environment and the repo on PYTHONPATH; its
    output goes to `<workdir>/spoke_<tag>.log`."""
    specfile = os.path.join(workdir, f"spoke_{tag}.json")
    with open(specfile, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    env.update(env_overrides or {})
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    log_path = os.path.join(workdir, f"spoke_{tag}.log")
    with open(log_path, "w") as log:
        # Popen dups the fd: closing ours keeps a long-lived hub from
        # leaking one per spoke
        p = subprocess.Popen(
            [sys.executable, "-m", f"{PACKAGE}.cylinders.proc", specfile],
            env=env, cwd=workdir, stdout=log, stderr=subprocess.STDOUT)
    p.log_path = log_path
    return p


def _forbidden_loaded():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "mpisppy_tpu"))


def _open_device(device):
    """The child's torch.device; a CUDA child opens its context here
    and refuses to start without the prebuilt kernel library."""
    import torch

    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import pdhg_chunk
        if not pdhg_chunk.library_path().exists():
            raise RuntimeError(
                "the chunk kernel's library is not built "
                f"({pdhg_chunk.library_path()}): the hub process builds "
                "it before spawning (proc.prebuild)")
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    return dev


def _die_with_parent():
    """On Linux, have the kernel SIGKILL this process when the hub
    process that spawned it dies, so that no child outlives its hub
    (the hub's kill signal never comes if the hub itself is killed)."""
    if not sys.platform.startswith("linux"):
        return
    import ctypes
    import signal
    parent = os.getppid()
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)      # PR_SET_PDEATHSIG
    if os.getppid() != parent:                      # it died already
        os._exit(1)


def run_spoke_from_spec(specfile: str) -> int:
    """Child entry: rebuild the spoke from its spec and serve until
    killed."""
    with open(specfile) as f:
        spec = json.load(f)
    bs = spec["batch"]
    # refuse a spec that names a module outside the port before this
    # process ties its life to its parent's
    for path in (bs["module"], spec["opt_class"], spec["spoke_class"]):
        _check_module(path.partition(":")[0])
    _die_with_parent()
    builder = getattr(importlib.import_module(bs["module"]), bs["builder"])
    opt_cls = _resolve(spec["opt_class"])
    spoke_cls = _resolve(spec["spoke_class"])
    dev = _open_device(spec["device"])

    from ..runtime import native
    if not native.library_path().exists():
        raise RuntimeError("the exchange library is not built "
                           f"({native.library_path()})")

    # this child's telemetry, active before the optimizer is built so
    # that every configure_from_options(None) picks it up; its spans
    # and metrics go to its own files, merged by the hub after shutdown
    from .. import telemetry as _telemetry
    tel_cfg = spec.get("telemetry")
    tel = _telemetry.configure(tel_cfg) if tel_cfg else _telemetry.get()

    batch = builder(**dict(bs.get("kwargs", {}), device=dev))
    pad_to = bs.get("pad_to")
    if pad_to and pad_to > batch.num_scens:
        # the hub's scenario count, so that the flattened W / nonant
        # window vectors reshape alike on both sides
        from ..ir import pad_scenarios
        batch = pad_scenarios(batch, pad_to)
    opt_options = dict(spec.get("opt_options") or {})
    spoke_options = dict(spec.get("spoke_options") or {})
    if tel_cfg:
        # the spec's telemetry is this process's: a "telemetry" option
        # would install another handle in its place
        opt_options.pop("telemetry", None)
        spoke_options.pop("telemetry", None)
    opt = opt_cls(opt_options, spec["scenario_names"], batch=batch,
                  device=dev)
    spoke = spoke_cls(opt, options=spoke_options)

    from .spcommunicator import WindowPair
    w = spec["windows"]
    spoke.pair = WindowPair(w["hub_length"], w["spoke_length"],
                            backend="native", path_prefix=w["prefix"],
                            attach=True)
    from ..resilience.checkpoint import atomic_write

    def write_info():
        from ..ops import pdhg_chunk
        atomic_write(w["prefix"] + ".info.json", json.dumps({
            "device": str(opt.device), "pid": os.getpid(),
            "forbidden_modules": _forbidden_loaded(),
            "kernel_launches": [list(k) + [n] for k, n in
                                sorted(pdhg_chunk.launch_shapes.items())],
        }).encode())
    write_info()
    spoke.main()
    sol = getattr(spoke, "best_solution", None)
    if sol is not None:
        # atomic: the hub may read it at any moment.  np.save on a file
        # object keeps the name verbatim
        buf = io.BytesIO()
        np.save(buf, np.asarray(sol))
        atomic_write(w["prefix"] + ".sol.npy", buf.getvalue())
    spoke.finalize()
    if tel.enabled:
        tp = tel.config.get("trace_path")
        if tp:
            tel.write_trace(tp)
        mp = tel.config.get("metrics_path")
        if mp:
            tel.write_metrics(mp)
    write_info()
    return 0


if __name__ == "__main__":
    sys.exit(run_spoke_from_spec(sys.argv[1]))
