"""Crash-resumable PH runs: atomic run checkpoints (port of the run
part of `mpisppy_tpu/resilience/checkpoint.py`).

A run checkpoint holds the whole `PHState` (x, y, W, x̄, xsqbar, obj,
dual_obj, conv, it, solve_iters, active_frac, solve_restarts,
promoted) as host arrays, the run-level scalars (trivial and best
bound, the eps ladder's tolerance) and, when the optimizer runs under
a hub, the hub's BestInnerBound / BestOuterBound and incumbent nonant
solution.  Restoring the full state makes the resumed trajectory
replay the uninterrupted one (the superstep is a function of its
state), so a run killed at iteration k and resumed with `resume_from=`
lands on the uninterrupted run's W, x̄ and bounds.  The file format is
the JAX package's: either package reads the other's run checkpoints.

Writes are atomic: the .npz is written to `<path>.tmp` and
`os.replace`d over the target, so a reader, or a resume after a crash
mid-write, never sees a torn file.

Not ported (ROADMAP.md queue A items 12 and 13): the stream
checkpoints of StreamingPH, the MPMD wheel's ensemble checkpoints
(`is_wheel_checkpoint` reads their marker only) and the serve layer's
drain checkpoints.
"""

from __future__ import annotations

import io
import os

import numpy as np
import torch

from ..device import host


def atomic_write(path, data):
    """Atomically write `data` (bytes) to `path` through a tmp file and
    os.replace: a reader, or a resume after a crash mid-write, never
    sees a torn file."""
    path = str(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def _norm_npz(path):
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def checkpoint_exists(path):
    return os.path.exists(_norm_npz(path))


def _opt_float(x):
    """None -> nan for npz storage (and back, in _opt_load)."""
    return np.float64(np.nan if x is None else float(x))


def _opt_load(v):
    v = float(v)
    return None if np.isnan(v) else v


def _atomic_savez(path, payload):
    """Write `payload` as <path>.npz through `atomic_write` (savez on a
    file object keeps the name verbatim)."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **payload)
    return atomic_write(_norm_npz(path), buf.getvalue())


def _run_payload(opt):
    """The run-checkpoint key set of `opt` (a PHBase with a live
    `state`)."""
    st = opt.state
    if st is None:
        raise RuntimeError("cannot checkpoint before Iter0 (no state)")
    hub = getattr(opt, "spcomm", None)
    incumbent = getattr(hub, "best_nonant_solution", None)
    names = opt.batch.tree.nonant_names
    return {
        "x": host(st.x), "y": host(st.y), "W": host(st.W),
        "xbar": host(st.xbar), "xsqbar": host(st.xsqbar),
        "obj": host(st.obj), "dual_obj": host(st.dual_obj),
        "conv": np.float64(float(st.conv)), "it": np.int64(int(st.it)),
        "solve_iters": np.int64(int(st.solve_iters)),
        "active_frac": np.float64(float(st.active_frac)),
        "solve_restarts": np.int64(int(st.solve_restarts)),
        # precision state: whether the last solve ran on the promoted
        # full-precision pair, and the ladder's current tolerance
        "promoted": np.int64(int(st.promoted)),
        "ladder_eps": _opt_float(getattr(opt, "_ladder_eps", None)
                                 if getattr(opt, "_ladder", None)
                                 is not None else None),
        "trivial_bound": _opt_float(getattr(opt, "trivial_bound", None)),
        "best_bound": _opt_float(getattr(opt, "best_bound", None)),
        "nonant_names": (np.array(names, dtype=object) if names
                         else np.array([], dtype=object)),
        "best_inner": _opt_float(getattr(hub, "BestInnerBound", None)),
        "best_outer": _opt_float(getattr(hub, "BestOuterBound", None)),
        "incumbent": (host(incumbent) if incumbent is not None
                      else np.array([])),
    }


def save_run_checkpoint(path, opt):
    """Atomically persist the full run state of `opt` (a PHBase with a
    live `state`); the hub's bounds ride along when `opt.spcomm` is a
    hub.  Returns the file's path."""
    return _atomic_savez(path, _run_payload(opt))


def load_run_checkpoint(path, opt):
    """Install a saved run state into `opt` (shapes and nonant names
    checked against its batch), as tensors of the batch's dtype on its
    device.  Returns the npz for callers that want the hub fields."""
    from ..phbase import PHState

    z = np.load(_norm_npz(path), allow_pickle=True)
    b = opt.batch
    S, K = b.num_scens, b.num_nonants
    W = np.asarray(z["W"])
    if W.shape != (S, K):
        raise ValueError(
            f"checkpoint W{W.shape} does not match this batch "
            f"(S,K)=({S},{K})")
    if np.asarray(z["x"]).shape[1] != b.num_vars:
        raise ValueError(
            f"checkpoint x has {np.asarray(z['x']).shape[1]} vars, "
            f"batch has {b.num_vars}")
    saved_names = tuple(np.asarray(z["nonant_names"]).tolist())
    cur_names = tuple(b.tree.nonant_names or ())
    if saved_names and cur_names and saved_names != cur_names:
        raise ValueError(
            "checkpoint nonant names do not match this model: "
            f"{saved_names[:3]}... vs {cur_names[:3]}...")
    dt, dev = b.c.dtype, b.c.device

    def t(key):
        return torch.as_tensor(np.asarray(z[key]), dtype=dt, device=dev)

    def scalar(value):
        return torch.tensor(value, dtype=dt, device=dev)

    opt.state = PHState(
        x=t("x"), y=t("y"), W=t("W"), xbar=t("xbar"), xsqbar=t("xsqbar"),
        obj=t("obj"), dual_obj=t("dual_obj"),
        conv=scalar(float(z["conv"])), it=int(z["it"]),
        solve_iters=int(z["solve_iters"]),
        active_frac=scalar(float(z["active_frac"])
                           if "active_frac" in z else 1.0),
        solve_restarts=torch.tensor(
            int(z["solve_restarts"]) if "solve_restarts" in z else 0,
            device=dev),
        promoted=int(z["promoted"]) if "promoted" in z else 0)
    opt.conv = float(z["conv"])
    opt.trivial_bound = _opt_load(z["trivial_bound"])
    opt.best_bound = _opt_load(z["best_bound"])
    if "ladder_eps" in z and getattr(opt, "_ladder", None) is not None:
        lad_eps = _opt_load(z["ladder_eps"])
        if lad_eps is not None:
            # the restored tolerance only tightens the fresh ladder
            opt._ladder_eps = min(opt._ladder_eps, lad_eps)
    return z


def restore_hub(path, hub):
    """Restore the hub's bound state (BestInner/OuterBound, incumbent)
    from a run checkpoint: the hub half of `resume_from=`."""
    z = np.load(_norm_npz(path), allow_pickle=True)
    bi, bo = float(z["best_inner"]), float(z["best_outer"])
    if np.isfinite(bi):
        hub.BestInnerBound = bi
    if np.isfinite(bo):
        hub.BestOuterBound = bo
    inc = np.asarray(z["incumbent"])
    if inc.size:
        hub.best_nonant_solution = inc
    return hub


def is_wheel_checkpoint(path):
    """True when `path` is an ensemble (wheel_format) checkpoint of the
    MPMD wheel, not a plain PH run checkpoint."""
    if not checkpoint_exists(path):
        return False
    with np.load(_norm_npz(path), allow_pickle=True) as z:
        return "wheel_format" in z
