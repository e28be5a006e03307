"""Bundling — block-diagonal stacking of scenarios into one batch
element (port of `mpisppy_tpu/utils/bundles.py`).

A bundle of m scenarios becomes ONE subproblem: constraint blocks on
the diagonal, objectives weighted by within-bundle conditional
probability, and explicit nonanticipativity equality rows chaining the
members' nonant columns — the same construction as the reference's
per-bundle EF (sputils._create_EF_from_scen_dict), done on arrays.
The bundled batch is a plain ScenarioBatch, so every algorithm (PH,
L-shaped, FWPH, EF) runs on bundles unchanged; PH's consensus then
couples only across bundles.

Multistage: a "proper bundle" consumes ENTIRE subtrees (the
reference's constraint — pickle_bundle.py:14-30, aircondB.py:158-161:
"bundles consume entire second stage nodes"), so every stage>=2 tree
node is interior to one bundle.  The in-bundle nonanticipativity of
those nodes becomes explicit chain rows, only the ROOT slots remain
nonanticipative ACROSS bundles, and the bundled problem is TWO-STAGE
by construction — exactly how the reference turns multistage aircond
into two-stage pickled bundles.

The bundled arrays are built on the host in numpy, as in the JAX
package, in the input batch's float dtype, and returned as tensors on
the input batch's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import host
from ..ir import ScenarioBatch, TreeInfo, delta_idx

INF = float("inf")


def _chain_pairs(node_of, stage_of, members):
    """Chain specification for one bundle: list of (j_a, k, j_b) — tie
    member j_a's nonant slot k to member j_b's — covering (a) every
    stage-1 slot of every member j>0 chained to member 0, and (b) every
    stage>=2 (node, slot) group chained within its members.  Raises if
    a stage>=2 node's scenario set extends outside the bundle (the
    bundle does not consume entire subtrees)."""
    m = len(members)
    K = node_of.shape[1]
    pairs = []
    for k in range(K):
        if stage_of is not None and stage_of[k] == 1:
            for j in range(1, m):
                pairs.append((j, k, 0))
            continue
        # group members by the node owning slot k
        groups = {}
        for j, s in enumerate(members):
            groups.setdefault(int(node_of[s, k]), []).append(j)
        for js in groups.values():
            for j in js[1:]:
                pairs.append((j, k, js[0]))
    return pairs


def bundle_batch(batch: ScenarioBatch, scenarios_per_bundle: int):
    """Stack every `scenarios_per_bundle` consecutive scenarios into a
    bundle.  S must be divisible by the bundle size (the reference
    likewise requires equal bundles, spbase.py:219 _assign_bundles).
    Multistage batches additionally require each bundle to consume
    entire stage>=2 subtrees (proper bundles)."""
    m = int(scenarios_per_bundle)
    S = batch.num_scens
    if m <= 1:
        return batch
    if S % m:
        raise ValueError(f"num_scens {S} not divisible by bundle size {m}")
    if batch.var_prob is not None:
        raise ValueError("bundle_batch does not support "
                         "variable_probability")
    B = S // m
    N, M, K = batch.num_vars, batch.num_rows, batch.num_nonants
    na = host(batch.nonant_idx)
    node_of = host(batch.tree.node_of)
    stage_of = (np.asarray(batch.tree.stage_of)
                if batch.tree.stage_of is not None else None)
    multistage = int(node_of.max()) > 0
    if multistage and stage_of is None:
        raise ValueError("multistage bundling needs tree.stage_of")
    A = host(batch.A)
    prob = host(batch.prob)
    fdt = A.dtype

    # proper-bundle check in ONE pass: every stage>=2 node must be
    # touched by exactly one bundle (scenario s belongs to bundle
    # s // m, so a node's scenario set maps to one bundle id)
    if multistage:
        deep = np.flatnonzero(stage_of > 1)
        node_ids = node_of[:, deep]                       # (S, Kd)
        bundle_of = (np.arange(S) // m)[:, None]
        owner = {}
        for n, b in zip(node_ids.ravel().tolist(),
                        np.broadcast_to(bundle_of,
                                        node_ids.shape).ravel().tolist()):
            if owner.setdefault(n, b) != b:
                raise ValueError(
                    "proper bundles must consume entire subtrees: a "
                    "stage>=2 tree node is shared across bundles "
                    "(choose scenarios_per_bundle as a multiple of "
                    "the leaves per stage-2 subtree)")
    all_pairs = [
        _chain_pairs(node_of, stage_of,
                     list(range(b * m, (b + 1) * m)))
        for b in range(B)]
    n_chain = max(len(p) for p in all_pairs)
    # identical chain patterns across bundles keep the shared-A fast
    # path available (regular trees — aircond — always qualify)
    uniform_chains = all(p == all_pairs[0] for p in all_pairs)
    # a shared-A batch bundles to a shared-A batch: every bundle's
    # block-diagonal is the same matrix (A identical across members,
    # nonant-chain rows constant), so Ab stays (1, Mb, Nb) and the
    # bmatvec matmul fast path survives bundling
    shared = batch.shared_A and uniform_chains

    Nb = m * N
    Mb = m * M + n_chain
    Ab = np.zeros((1 if shared else B, Mb, Nb), fdt)
    lob = np.full((B, Mb), -INF, fdt)
    hib = np.full((B, Mb), INF, fdt)
    cb = np.zeros((B, Nb), fdt)
    qb = np.zeros((B, Nb), fdt)
    lbb = np.zeros((B, Nb), fdt)
    ubb = np.zeros((B, Nb), fdt)
    constb = np.zeros((B,), fdt)
    intb = np.zeros((B, Nb), bool)
    pb = np.zeros((B,), fdt)

    c = host(batch.c)
    q = host(batch.qdiag)
    lo = host(batch.row_lo)
    hi = host(batch.row_hi)
    lb = host(batch.lb)
    ub = host(batch.ub)
    oc = host(batch.obj_const)
    im = host(batch.integer_mask)

    for b in range(B):
        mem = range(b * m, (b + 1) * m)
        pB = prob[list(mem)].sum()
        pb[b] = pB
        for j, s in enumerate(mem):
            w = prob[s] / pB if pB > 0 else 1.0 / m
            sl = slice(j * N, (j + 1) * N)
            rw = slice(j * M, (j + 1) * M)
            if not shared:
                Ab[b, rw, sl] = A[s] if A.shape[0] > 1 else A[0]
            lob[b, rw] = lo[s]
            hib[b, rw] = hi[s]
            cb[b, sl] = w * c[s]
            qb[b, sl] = w * q[s]
            lbb[b, sl] = lb[s]
            ubb[b, sl] = ub[s]
            intb[b, sl] = im[s]
            constb[b] += w * oc[s]
        # nonant chains (equality row bounds; matrix entries below)
        pairs = all_pairs[b]
        lob[b, m * M:m * M + len(pairs)] = 0.0
        hib[b, m * M:m * M + len(pairs)] = 0.0
        if not shared:
            for r0, (ja, k, jb) in enumerate(pairs):
                r = m * M + r0
                Ab[b, r, ja * N + na[k]] = 1.0
                Ab[b, r, jb * N + na[k]] = -1.0
    if shared:
        # ONE block-diagonal serves every bundle (members share A and
        # the chain rows are constant)
        for j in range(m):
            Ab[0, j * M:(j + 1) * M, j * N:(j + 1) * N] = A[0]
        for r0, (ja, k, jb) in enumerate(all_pairs[0]):
            r = m * M + r0
            Ab[0, r, ja * N + na[k]] = 1.0
            Ab[0, r, jb * N + na[k]] = -1.0

    # remap sparse matrix-uncertainty coordinates (ir.SplitA contract)
    # to the bundled block-diagonal layout: member j's delta entry
    # (r, c) lands at (j*M + r, j*N + c).  The shared part stays
    # bundle-independent (identical member blocks + constant chain
    # rows), so the split fast path survives bundling.
    meta = dict(batch.model_meta) if isinstance(batch.model_meta, dict) \
        else None
    if meta and delta_idx(batch) is not None:
        if shared:
            del meta["A_delta_idx"]   # already on the shared-A path
        else:
            r0, c0 = (np.asarray(v) for v in delta_idx(batch))
            meta["A_delta_idx"] = (
                np.concatenate([j * M + r0 for j in range(m)]).astype(
                    np.int32),
                np.concatenate([j * N + c0 for j in range(m)]).astype(
                    np.int32))
    names = batch.tree.scen_names or tuple(str(i) for i in range(S))
    # the bundled problem is TWO-STAGE: only member 0's ROOT slots stay
    # nonanticipative across bundles (multistage slots are chained
    # inside each bundle above)
    if multistage:
        keep = np.flatnonzero(stage_of == 1)
    else:
        keep = np.arange(K)
    nonant_idx_b = na[keep]
    Kb = keep.size
    dev = batch.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tree = TreeInfo(
        node_of=t(np.zeros((B, Kb), np.int64)),
        prob=t(pb / pb.sum()),
        num_nodes=1,
        stage_of=(1,) * Kb,
        nonant_names=tuple(np.asarray(
            batch.tree.nonant_names or tuple(str(k) for k in range(K))
        )[keep]),
        scen_names=tuple(f"bundle{b}({names[b*m]}..{names[(b+1)*m-1]})"
                         for b in range(B)),
    )
    return ScenarioBatch(
        c=t(cb), qdiag=t(qb), A=t(Ab), row_lo=t(lob), row_hi=t(hib),
        lb=t(lbb), ub=t(ubb), obj_const=t(constb),
        nonant_idx=t(nonant_idx_b.astype(np.int64)),
        integer_mask=t(intb), tree=tree,
        stage_cost_c=None,
        model_meta=meta if meta is not None else batch.model_meta,
        var_names=tuple(f"m{j}.{v}" for j in range(m)
                        for v in (batch.var_names
                                  or tuple(str(i) for i in range(N)))))
