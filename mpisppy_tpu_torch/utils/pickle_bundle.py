"""Array-native batch files (port of `mpisppy_tpu/utils/pickle_bundle.py`,
the counterpart of the reference's dill-pickled "proper bundles").

A ScenarioBatch is written as one compressed `.npz`: its arrays under
the JAX package's key names plus a JSON `meta` entry (tree and name
metadata).  The format is the JAX package's own, so either package
reads the other's files.  `dill_pickle` / `dill_unpickle` keep the
reference's names.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..device import host, resolve_device
from ..ir import ScenarioBatch, TreeInfo


def dill_pickle(batch: ScenarioBatch, path):
    """Write a batch to `path` (.npz)."""
    meta = dict(
        num_nodes=int(batch.tree.num_nodes),
        stage_of=list(batch.tree.stage_of or ()),
        nonant_names=list(batch.tree.nonant_names or ()),
        scen_names=list(batch.tree.scen_names or ()),
        var_names=list(batch.var_names or ()),
        has_stage_cost=batch.stage_cost_c is not None,
    )
    arrays = {f: host(getattr(batch, f)) for f in (
        "c", "qdiag", "A", "row_lo", "row_hi", "lb", "ub", "obj_const",
        "nonant_idx", "integer_mask")}
    arrays.update(
        node_of=host(batch.tree.node_of), prob=host(batch.tree.prob),
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
    if batch.stage_cost_c is not None:
        arrays["stage_cost_c"] = host(batch.stage_cost_c)
    np.savez_compressed(_norm_npz(path), **arrays)


def _norm_npz(path):
    """np.savez appends '.npz' to a suffix-less name; reader and writer
    agree on it."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def dill_unpickle(path, device=None) -> ScenarioBatch:
    """Read a batch written by either package's dill_pickle, as tensors
    on `device` (default: the CUDA device)."""
    dev = resolve_device(device)
    z = np.load(_norm_npz(path))
    meta = json.loads(bytes(z["meta"]).decode())

    def t(key, dtype=None):
        a = torch.from_numpy(np.array(z[key])).to(dev)
        return a if dtype is None else a.to(dtype)

    tree = TreeInfo(
        node_of=t("node_of", torch.long), prob=t("prob"),
        num_nodes=meta["num_nodes"],
        stage_of=tuple(meta["stage_of"]) or None,
        nonant_names=tuple(meta["nonant_names"]),
        scen_names=tuple(meta["scen_names"]))
    return ScenarioBatch(
        c=t("c"), qdiag=t("qdiag"), A=t("A"), row_lo=t("row_lo"),
        row_hi=t("row_hi"), lb=t("lb"), ub=t("ub"),
        obj_const=t("obj_const"), nonant_idx=t("nonant_idx", torch.long),
        integer_mask=t("integer_mask", torch.bool), tree=tree,
        stage_cost_c=t("stage_cost_c") if meta["has_stage_cost"] else None,
        var_names=tuple(meta["var_names"]))


def pickle_bundle_parser(cfg):
    """Config flags of the bundle-file workflow (reference
    pickle_bundle.py:37-55)."""
    cfg.add_to_config("pickle_bundles_dir",
                      description="write per-bundle npz files here",
                      domain=str, default=None)
    cfg.add_to_config("unpickle_bundles_dir",
                      description="read per-bundle npz files from here "
                      "instead of building the model",
                      domain=str, default=None)
    cfg.add_to_config("scenarios_per_bundle",
                      description="scenarios per proper bundle",
                      domain=int, default=None)


def have_proper_bundles(cfg):
    """Is a bundle-file workflow active (reference
    pickle_bundle.py:58-64)?"""
    return (cfg.get("pickle_bundles_dir") is not None
            or cfg.get("unpickle_bundles_dir") is not None)
