"""aircondB — the bundle-file variant of aircond (port of
`mpisppy_tpu/models/aircondB.py`; the reference's "PICKLE BUNDLE
VERSION").

Proper bundles that consume entire second-stage subtrees are built
once (`utils/bundles.bundle_batch`: in-bundle chain rows for the
stage>=2 nodes make each bundle a two-stage subproblem), optionally
written one `.npz` per bundle (`utils/pickle_bundle`, the reference's
Bundle_first_last naming), and a later run can load those files
instead of building the model.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..ir import TreeInfo, stack_scenarios
from ..utils import pickle_bundle
from ..utils.bundles import bundle_batch
from . import aircond

MULTISTAGE = False   # bundled: two-stage by construction


def bundle_names(num_scens, scenarios_per_bundle, start=0):
    """Bundle_first_last over the original scenario numbers (reference
    aircondB.py:146)."""
    m = int(scenarios_per_bundle)
    return [f"Bundle_{i}_{i + m - 1}"
            for i in range(start, start + num_scens, m)]


def build_batch(branching_factors=(3, 2), scenarios_per_bundle=None,
                pickle_bundles_dir=None, unpickle_bundles_dir=None,
                start_seed=None, dtype=np.float64, device=None, **params):
    """The bundled aircond batch on `device` (default: the CUDA device).
    scenarios_per_bundle defaults to one full stage-2 subtree (the
    product of the non-root branching factors, the smallest proper
    bundle).  pickle_bundles_dir: also write each bundle as its own
    npz.  unpickle_bundles_dir: load the bundle files instead of
    building the model."""
    bf = tuple(branching_factors)
    m = int(scenarios_per_bundle or int(np.prod(bf[1:])) or 1)
    S = int(np.prod(bf))
    if unpickle_bundles_dir is not None:
        rows = [pickle_bundle.dill_unpickle(
            os.path.join(unpickle_bundles_dir, nm), device=device)
            for nm in bundle_names(S, m)]
        return stack_scenarios(rows, scen_names=[r.tree.scen_names[0]
                                                 for r in rows])
    base = aircond.build_batch(bf, start_seed=start_seed, dtype=dtype,
                               device=device, **params)
    bb = bundle_batch(base, m)
    if pickle_bundles_dir is not None:
        os.makedirs(pickle_bundles_dir, exist_ok=True)
        for i, nm in enumerate(bundle_names(S, m)):
            pickle_bundle.dill_pickle(
                _slice_bundle(bb, i), os.path.join(pickle_bundles_dir, nm))
    return bb


def _slice_bundle(bb, i):
    """Bundle row i as an S=1 ScenarioBatch (the unit of one file)."""
    sl = slice(i, i + 1)
    tree = bb.tree
    return dataclasses.replace(
        bb,
        c=bb.c[sl], qdiag=bb.qdiag[sl],
        A=bb.A if bb.A.shape[0] == 1 else bb.A[sl],
        row_lo=bb.row_lo[sl], row_hi=bb.row_hi[sl],
        lb=bb.lb[sl], ub=bb.ub[sl], obj_const=bb.obj_const[sl],
        integer_mask=bb.integer_mask[sl],
        stage_cost_c=None,
        tree=TreeInfo(
            node_of=tree.node_of[sl], prob=tree.prob[sl], num_nodes=1,
            stage_of=tree.stage_of, nonant_names=tree.nonant_names,
            scen_names=(tree.scen_names[i],)))


def scenario_names_creator(num_scens, start=0, bundles_per_rank=None,
                           scenarios_per_bundle=None):
    """Bundle names (the reference's aircondB yields bundle names)."""
    m = int(scenarios_per_bundle or 1)
    return bundle_names(num_scens, m, start=start)


def inparser_adder(cfg):
    aircond.inparser_adder(cfg)
    pickle_bundle.pickle_bundle_parser(cfg)


def kw_creator(options):
    kw = aircond.kw_creator(options)
    for key in ("pickle_bundles_dir", "unpickle_bundles_dir",
                "scenarios_per_bundle"):
        if options.get(key) is not None:
            kw[key] = options[key]
    return kw


def scenario_denouement(rank, scenario_name, scenario):
    pass
