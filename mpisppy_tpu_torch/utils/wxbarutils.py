"""W / x̄ persistence, PH warm starts (port of
`mpisppy_tpu/utils/wxbarutils.py`).

One .npz holds W (S, K) and xbar (S, K), the nonant names for a sanity
check, and the iteration: the JAX package's format, so a file written
by either package loads in the other.  The CSV export and import keep
the reference's file format (rows: scenario, varname, value).
"""

from __future__ import annotations

import csv
import dataclasses
import io

import numpy as np
import torch

from ..device import host
from ..resilience.checkpoint import atomic_write


def _norm_npz(path):
    """np.savez appends '.npz' to suffix-less names; normalize so the
    writer and reader agree on the real filename."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def write_W_and_xbar(path, opt):
    """Persist the current PH dual state (host copies of W and x̄),
    atomically; savez on a file object keeps the name verbatim."""
    st = opt.state
    names = opt.batch.tree.nonant_names
    buf = io.BytesIO()
    np.savez_compressed(
        buf, W=host(st.W), xbar=host(st.xbar),
        nonant_names=np.array(names, dtype=object) if names
        else np.array([], dtype=object),
        it=int(st.it))
    atomic_write(_norm_npz(path), buf.getvalue())


def read_W_and_xbar(path, opt):
    """Load W/x̄ and install them into the optimizer's state (after
    Iter0), on its device in the state's dtype."""
    z = np.load(_norm_npz(path), allow_pickle=True)
    W = np.asarray(z["W"])
    xbar = np.asarray(z["xbar"])
    st = opt.state
    S, K = tuple(st.W.shape)
    if W.shape != (S, K) or xbar.shape != (S, K):
        raise ValueError(
            f"checkpoint shapes W{W.shape}/xbar{xbar.shape} != "
            f"current (S,K)=({S},{K})")
    saved_names = tuple(np.asarray(z["nonant_names"]).tolist())
    cur_names = tuple(opt.batch.tree.nonant_names or ())
    if saved_names and cur_names and saved_names != cur_names:
        raise ValueError(
            "checkpoint nonant names do not match this model: "
            f"{saved_names[:3]}... vs {cur_names[:3]}...")

    def dev(a):
        return torch.as_tensor(a, device=st.W.device).to(st.W.dtype)

    opt.state = dataclasses.replace(st, W=dev(W), xbar=dev(xbar))


def write_W_csv(path, opt):
    """Reference-format CSV: scenario, varname, W value."""
    W = host(opt.state.W)
    names = opt.batch.tree.nonant_names or tuple(
        str(k) for k in range(W.shape[1]))
    scen_names = opt.batch.tree.scen_names or tuple(
        str(s) for s in range(W.shape[0]))
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for s in range(min(opt.n_real_scens, W.shape[0])):
            for k in range(W.shape[1]):
                w.writerow([scen_names[s], names[k], W[s, k]])


def read_W_csv(path, opt):
    """Read the reference-format CSV back into an (S, K) array."""
    W = np.array(host(opt.state.W), copy=True)
    names = {n: k for k, n in enumerate(
        opt.batch.tree.nonant_names
        or tuple(str(k) for k in range(W.shape[1])))}
    scen = {n: s for s, n in enumerate(
        opt.batch.tree.scen_names
        or tuple(str(s) for s in range(W.shape[0])))}
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) != 3:
                continue
            s, k = scen.get(row[0]), names.get(row[1])
            if s is not None and k is not None:
                W[s, k] = float(row[2])
    return W
