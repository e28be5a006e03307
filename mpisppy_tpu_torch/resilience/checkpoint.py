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

Stream checkpoints (`save_stream_checkpoint`, `load_stream_checkpoint`)
hold a StreamingPH run: its host-resident full-S state, the sampler's
RNG state and active size, the block already drawn, the certification
cursor and, for a shard-backed source, the store's quarantine cursor.
They too are the JAX package's format, read by either package.

Drain checkpoints (`save_drain_checkpoint`, `load_drain_checkpoint`)
hold the requests a draining serve replica could not finish, in the JAX
package's format (an .npz with `drain_format` and an object array of
request dicts).  The port writes each request's batch as its field dict
of plain numpy arrays (`convert.to_arrays`: no class of either package
inside), and reads either that or the JAX package's pickled batches,
whose classes it maps onto plain records without importing the JAX
package.

Not ported (ROADMAP.md queue A item 13): the MPMD wheel's ensemble
checkpoints (`is_wheel_checkpoint` reads their marker only).
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
import zipfile

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


def save_stream_checkpoint(path, sph):
    """Atomically persist a StreamingPH run (streaming/streaming_ph.py).
    Its trajectory is a function of the host-resident W, x_na, solved
    mask and consensus x̄, the sampler's RNG state and active size, the
    drawn next block and the certification cursor, all numpy; restoring
    them and re-prefetching the pending block replays the run."""
    if sph.state is None:
        raise RuntimeError("cannot checkpoint before Iter0 (no state)")
    import json

    samp = sph.sampler.state()
    warm = sph._warm_host  # (x_full, y_full) or None
    names = sph.batch.tree.nonant_names
    payload = {
        "stream_format": np.int64(1),
        "W_host": np.asarray(sph.W_host),
        "x_na_host": np.asarray(sph.x_na_host),
        "solved": np.asarray(sph.solved),
        "xbar_host": np.asarray(sph.xbar_host),
        "conv": np.float64(sph.conv),
        "it": np.int64(int(sph.state.it)),
        "active_n": np.int64(samp["active_n"]),
        "est_rounds": np.int64(samp["est_rounds"]),
        "rng_state": np.array(samp["rng_state"]),  # json string
        "pending_indices": np.asarray(sph._pending_indices,
                                      dtype=np.int64),
        "est_seed": np.int64(sph._est_seed),
        "est_history": np.array(json.dumps(sph._est_history)),
        "trivial_bound": _opt_float(getattr(sph, "trivial_bound", None)),
        "best_bound": _opt_float(getattr(sph, "best_bound", None)),
        "ladder_eps": _opt_float(getattr(sph, "_ladder_eps", None)
                                 if getattr(sph, "_ladder", None)
                                 is not None else None),
        "nonant_names": (np.array(names, dtype=object) if names
                         else np.array([], dtype=object)),
        "warm_x": (np.asarray(warm[0]) if warm is not None
                   else np.array([])),
        "warm_y": (np.asarray(warm[1]) if warm is not None
                   else np.array([])),
    }
    # storage cursor of a shard-backed source: substitution is a pure
    # function of (indices, quarantine set), so restoring the set
    # replays the quarantine substitutions
    store = sph._shard_store()
    if store is not None:
        payload["storage_cursor"] = np.array(json.dumps(store.state()))
    return _atomic_savez(path, payload)


def load_stream_checkpoint(path, sph):
    """Install a stream checkpoint into `sph` (a StreamingPH), with the
    shape and name checks of load_run_checkpoint.  The pending block is
    not prefetched here: the caller re-issues the prefetch, and the
    stream rebuilds it from the stored indices."""
    import json

    z = np.load(_norm_npz(path), allow_pickle=True)
    if "stream_format" not in z:
        raise ValueError(
            f"{path} is a plain PH run checkpoint, not a stream "
            "checkpoint (use PH.ph_main resume for it)")
    W = np.asarray(z["W_host"])
    S, K = sph.total_scens, sph.batch.num_nonants
    if W.shape != (S, K):
        raise ValueError(
            f"stream checkpoint W{W.shape} does not match this source "
            f"(S,K)=({S},{K})")
    saved_names = tuple(np.asarray(z["nonant_names"]).tolist())
    cur_names = tuple(sph.batch.tree.nonant_names or ())
    if saved_names and cur_names and saved_names != cur_names:
        raise ValueError(
            "stream checkpoint nonant names do not match this model: "
            f"{saved_names[:3]}... vs {cur_names[:3]}...")
    sph.W_host = W.copy()
    sph.x_na_host = np.asarray(z["x_na_host"]).copy()
    sph.solved = np.asarray(z["solved"]).copy()
    sph.xbar_host = np.asarray(z["xbar_host"]).copy()
    sph.conv = float(z["conv"])
    sph.sampler.restore({
        "active_n": int(z["active_n"]),
        "est_rounds": int(z["est_rounds"]),
        "rng_state": str(z["rng_state"]),
    })
    sph._pending_indices = np.asarray(z["pending_indices"],
                                      dtype=np.int64)
    sph._est_seed = int(z["est_seed"])
    sph._est_history = json.loads(str(z["est_history"]))
    sph.trivial_bound = _opt_load(z["trivial_bound"])
    sph.best_bound = _opt_load(z["best_bound"])
    if getattr(sph, "_ladder", None) is not None:
        lad_eps = _opt_load(z["ladder_eps"])
        if lad_eps is not None:
            sph._ladder_eps = min(sph._ladder_eps, lad_eps)
    wx = np.asarray(z["warm_x"])
    sph._warm_host = ((wx.copy(), np.asarray(z["warm_y"]).copy())
                      if wx.size else None)
    store = sph._shard_store()
    if store is not None and "storage_cursor" in z:
        store.restore(json.loads(str(z["storage_cursor"])))
    sph._install_resumed_state(int(z["it"]))
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


# -- serve drain checkpoints (serve/service.py) -----------------------------

def save_drain_checkpoint(path, requests):
    """Atomically persist the requests a draining SolverService could
    not finish: a list of dicts (id, options, scenario_names, model,
    batch).  Each batch is written as its field dict of host numpy
    arrays (`convert.to_arrays`), in the JAX package's drain format.  A
    restarted service warms from this file and resubmits them."""
    from ..convert import to_arrays
    reqs = []
    for r in requests:
        d = dict(r)
        b = d.get("batch")
        if dataclasses.is_dataclass(b):
            d["batch"] = to_arrays(b)
        reqs.append(d)
    arr = np.empty(len(reqs), dtype=object)
    arr[:] = reqs
    payload = {"drain_format": np.int64(1), "requests": arr}
    return _atomic_savez(path, payload)


class _Foreign:
    """A record of a pickled JAX-package object (ScenarioBatch,
    TreeInfo, SplitA): its state, nothing else."""

    def __init__(self, *args, **kwargs):
        self.state = {}

    def __setstate__(self, state):
        if isinstance(state, tuple):        # (dict, slots) form
            state = {k: v for part in state if part for k, v in
                     part.items()}
        self.state = dict(state)


def _foreign_class(module, name):
    return type(name, (_Foreign,), {"__module__": __name__,
                                    "foreign": f"{module}.{name}"})


class _DrainUnpickler(pickle.Unpickler):
    """Unpickles a drain file's request list: classes of the JAX package
    become `_Foreign` records (the port never imports it); numpy and
    the builtins load as usual."""

    def find_class(self, module, name):
        if module.split(".")[0] == "mpisppy_tpu":
            return _foreign_class(module, name)
        return super().find_class(module, name)


def _plain(v):
    """A `_Foreign` record tree as nested field dicts."""
    if isinstance(v, _Foreign):
        return {k: _plain(x) for k, x in v.state.items()}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def _read_requests(path):
    """The `requests` member of a drain file, unpickled by
    `_DrainUnpickler`."""
    with zipfile.ZipFile(_norm_npz(path)) as zf:
        names = zf.namelist()
        if "drain_format.npy" not in names:
            raise ValueError(f"{path} is not a drain checkpoint")
        with zf.open("requests.npy") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, _, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, _, dtype = np.lib.format.read_array_header_2_0(f)
            if dtype != object:
                raise ValueError(f"{path}: requests is not a list")
            arr = _DrainUnpickler(f).load()
    return list(np.asarray(arr, dtype=object).reshape(shape))


def load_drain_checkpoint(path, device="cpu"):
    """The saved request dicts, in submission order, each batch a port
    ScenarioBatch on `device` (written by either package).  A truncated
    or bit-flipped file raises ValueError with the underlying cause —
    SolverService.warm_from turns that into a structured reject instead
    of propagating mid-resubmit."""
    from ..convert import batch_from_arrays
    try:
        reqs = _read_requests(path)
        out = []
        for r in reqs:
            d = dict(r) if isinstance(r, dict) else r
            if isinstance(d, dict) and "batch" in d:
                d["batch"] = batch_from_arrays(_plain(d["batch"]),
                                               device=device)
            out.append(d)
        return out
    except ValueError:
        raise
    except Exception as exc:
        raise ValueError(
            f"corrupt or truncated drain checkpoint {path}: "
            f"{exc!r}") from exc
