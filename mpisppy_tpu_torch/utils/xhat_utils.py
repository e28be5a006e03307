"""Candidate (xhat) construction helpers of the xhat spokes (port of
`mpisppy_tpu/utils/xhat_utils.py`, host numpy).

A candidate is an (S, K) matrix of nonant values: slot j of scenario s
is taken from the source scenario assigned to the tree node that owns
(s, j).  Two-stage problems broadcast one row; multistage trees get a
source per node.  Tensors of the batch are copied to the host first.
"""

from __future__ import annotations

import numpy as np

from ..device import host


def node_members(node_of):
    """{node_id: sorted list of the scenario indices through that
    node}, from the batch's node_of array."""
    node_of = host(node_of)
    out = {}
    for s in range(node_of.shape[0]):
        for n in np.unique(node_of[s]):
            out.setdefault(int(n), []).append(s)
    return out


def full_source_map(node_of, base_scen, members=None):
    """{node: src}: base_scen at the nodes it passes through, else the
    node's smallest-index member scenario."""
    node_of = host(node_of)
    if members is None:
        members = node_members(node_of)
    base_nodes = set(int(n) for n in np.unique(node_of[base_scen]))
    return {n: (base_scen if n in base_nodes else mem[0])
            for n, mem in members.items()}


def candidate_from_sources(x_na, node_of, node_to_src):
    """(S, K) candidate: value (s, j) taken from scenario
    node_to_src[node_of[s, j]].  node_to_src: dict or (num_nodes,)
    array."""
    x_na = host(x_na)
    node_of = host(node_of)
    if isinstance(node_to_src, dict):
        arr = np.zeros(int(node_of.max()) + 1, np.int64)
        for n, s in node_to_src.items():
            arr[int(n)] = int(s)
        node_to_src = arr
    srcs = node_to_src[node_of]                       # (S, K)
    return np.take_along_axis(x_na, srcs, axis=0)


def round_integer_nonants(batch, candidate):
    """The candidate rounded on integer nonant slots (integrality is
    restored by rounding before the fixed evaluation)."""
    cand = np.asarray(candidate, dtype=float).copy()
    imask = host(batch.integer_mask)[:, host(batch.nonant_idx)]
    if cand.ndim == 1:
        imask0 = imask[0] if imask.ndim == 2 else imask
        cand[imask0] = np.round(cand[imask0])
    else:
        cand[imask] = np.round(cand[imask])
    return cand
