"""Carry problem and solver state into the port from plain arrays.

The JAX package's `ScenarioBatch` (with its `TreeInfo` and its
`var_prob`, the variable_probability weights; farmer, uc and sslp
batches alike), `PreparedBatch`, `ConsensusSpec` and `PHState`
cross over as plain dicts of numpy arrays keyed by the JAX
dataclasses' field names; `to_arrays` produces
such a dict from any dataclass whose array fields support
`np.asarray` (the JAX objects, or the port's own).  Nothing here
imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import not_ported
from .device import resolve_device
from .ir import ScenarioBatch, SplitA, TreeInfo
from .ops.pdhg import ConsensusSpec, PreparedBatch
from .phbase import PHState


def to_arrays(obj):
    """A dataclass as a dict keyed by field name: array-like fields as
    numpy arrays, nested dataclasses as nested dicts, everything else
    (names, static metadata, Python scalars) unchanged."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_arrays(v)
        elif torch.is_tensor(v):
            out[f.name] = v.detach().cpu().numpy()
        elif hasattr(v, "__array__") and not isinstance(v, np.ndarray):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def _t(a, dev, dtype=None):
    if a is None:
        return None
    if not isinstance(a, np.ndarray) or a.dtype == object:
        raise not_ported(f"converting a {type(a).__name__} (dense arrays "
                         "and dense-shared SplitA operators convert; a "
                         "sparse shared block does not)", 1)
    t = torch.from_numpy(np.array(a)).to(dev)
    return t if dtype is None else t.to(dtype)


def _operator(a, dev):
    """A constraint operator: a dense array, or a SplitA's field dict
    (to_arrays of the JAX package's SplitA)."""
    if isinstance(a, dict):
        return SplitA(shared=_t(a["shared"], dev),
                      rows=_t(np.asarray(a["rows"]), dev, torch.int32),
                      cols=_t(np.asarray(a["cols"]), dev, torch.int32),
                      vals=_t(a["vals"], dev))
    return _t(a, dev)


def batch_from_arrays(d, device=None) -> ScenarioBatch:
    """ScenarioBatch (dense, shared or SplitA operator) from a dict of
    the JAX field names."""
    dev = resolve_device(device)
    tr = d["tree"]
    stage_of = tr.get("stage_of")
    tree = TreeInfo(
        node_of=_t(np.asarray(tr["node_of"]), dev, torch.long),
        prob=_t(np.asarray(tr["prob"]), dev),
        num_nodes=int(tr.get("num_nodes", 1)),
        stage_of=None if stage_of is None else tuple(
            int(s) for s in np.asarray(stage_of).reshape(-1)),
        nonant_names=tuple(tr.get("nonant_names", ())),
        scen_names=tuple(tr.get("scen_names", ())))
    return ScenarioBatch(
        c=_t(d["c"], dev), qdiag=_t(d["qdiag"], dev), A=_operator(d["A"], dev),
        row_lo=_t(d["row_lo"], dev), row_hi=_t(d["row_hi"], dev),
        lb=_t(d["lb"], dev), ub=_t(d["ub"], dev),
        obj_const=_t(d["obj_const"], dev),
        nonant_idx=_t(np.asarray(d["nonant_idx"]), dev, torch.long),
        integer_mask=_t(np.asarray(d["integer_mask"]), dev, torch.bool),
        tree=tree,
        stage_cost_c=_t(d.get("stage_cost_c"), dev),
        var_names=tuple(d.get("var_names", ())),
        model_meta=d.get("model_meta"),
        var_prob=_t(d.get("var_prob"), dev))


def prep_from_arrays(d, device=None) -> PreparedBatch:
    """PreparedBatch (dense, shared or SplitA operator) from a dict of
    the JAX field names."""
    dev = resolve_device(device)
    return PreparedBatch(**{f.name: (_operator if f.name == "A" else _t)(
        d[f.name], dev) for f in dataclasses.fields(PreparedBatch)})


def consensus_from_arrays(d, device=None, v0=None) -> ConsensusSpec:
    """ConsensusSpec from a dict of the JAX field names; `v0` is the
    optional start vector of the EF power iteration."""
    dev = resolve_device(device)
    return ConsensusSpec(
        node_of=_t(np.asarray(d["node_of"]), dev, torch.long),
        nonant_idx=_t(np.asarray(d["nonant_idx"]), dev, torch.long),
        num_nodes=int(d.get("num_nodes", 1)),
        num_copies=int(d.get("num_copies", 1)),
        v0=_t(None if v0 is None else np.asarray(v0), dev))


def state_from_arrays(d, device=None) -> PHState:
    """PHState from a dict of the JAX field names: per-scenario arrays
    become tensors, the scalar counters Python ints."""
    dev = resolve_device(device)
    kw = {k: _t(np.asarray(d[k]), dev)
          for k in ("x", "y", "W", "xbar", "xsqbar", "obj", "dual_obj",
                    "conv", "active_frac", "solve_restarts") if k in d}
    for k in ("it", "solve_iters", "promoted"):
        if k in d:
            kw[k] = int(np.asarray(d[k]))
    return PHState(**kw)
