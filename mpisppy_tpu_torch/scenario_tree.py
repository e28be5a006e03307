"""Scenario-tree metadata for multistage problems (port of
`mpisppy_tpu/scenario_tree.py`; pure numpy, a copy rather than an
import, as the port imports nothing of the JAX package).

Reference counterparts: `ScenarioNode` (mpisppy/scenario_tree.py:44),
`sputils.create_nodenames_from_branching_factors` (sputils.py:934) and
`sputils._ScenTree`/`_TreeNode` (sputils.py:675-840).

The tree is static metadata.  Each nonant slot of each scenario carries
the global id of the tree node that owns it (`ir.TreeInfo.node_of`);
consensus reductions are segment sums over those ids
(`ir.node_segment_sum`), so two-stage and multistage problems run the
same code.  Nothing here touches a device.

Node numbering: breadth-first over non-leaf stages — ROOT = 0, then the
stage-2 nodes left to right, then stage 3, ...  Leaf nodes are elided,
as in the reference ("mpisppy does not have leaf nodes", reference
hydro.py MakeAllScenarioTreeNodes comment; sputils.py:659).
"""

from __future__ import annotations

import numpy as np


def create_nodenames_from_branching_factors(branching_factors):
    """Non-leaf node names for a balanced tree (reference
    sputils.py:934).  BFs [3,3] (3 stages) -> ["ROOT", "ROOT_0",
    "ROOT_1", "ROOT_2"]; leaves are elided."""
    names = ["ROOT"]
    frontier = ["ROOT"]
    # nodes exist at stages 1..len(BFs); stage t branches BFs[t-1] ways
    for bf in branching_factors[:-1]:
        nxt = []
        for parent in frontier:
            for b in range(bf):
                nxt.append(f"{parent}_{b}")
        names.extend(nxt)
        frontier = nxt
    return names


class MultistageTree:
    """Balanced scenario tree from branching factors.

    branching_factors: list of ints, length = n_stages - 1.  Scenario
    count = prod(BFs).  Scenario i (0-based) follows the digit path of
    i in the mixed-radix system of the BFs.

    Attributes:
        nodenames: non-leaf names, breadth-first (id = index)
        num_nodes: number of non-leaf nodes
        n_stages:  len(BFs) + 1
        num_scens: prod(BFs)
    """

    def __init__(self, branching_factors, cond_probs=None):
        self.branching_factors = list(branching_factors)
        self.n_stages = len(self.branching_factors) + 1
        self.num_scens = int(np.prod(self.branching_factors))
        self.nodenames = create_nodenames_from_branching_factors(
            self.branching_factors)
        self.num_nodes = len(self.nodenames)
        self._id_of = {n: i for i, n in enumerate(self.nodenames)}
        # per-stage node id offsets: stage t (1-based) nodes occupy
        # ids [offset[t-1], offset[t])
        self._stage_counts = [1]
        for bf in self.branching_factors[:-1]:
            self._stage_counts.append(self._stage_counts[-1] * bf)
        self._stage_offsets = np.concatenate(
            [[0], np.cumsum(self._stage_counts)])
        # conditional probability per branch of each stage (uniform
        # unless given); reference ScenarioNode cond_prob
        if cond_probs is None:
            cond_probs = [
                np.full((bf,), 1.0 / bf) for bf in self.branching_factors
            ]
        self.cond_probs = [np.asarray(p, float) for p in cond_probs]

    def node_id(self, name):
        return self._id_of[name]

    def scen_digits(self, scennum):
        """Mixed-radix digits of scenario scennum (0-based), most
        significant (stage-2 branch) first."""
        digits = []
        rem = scennum
        for bf in reversed(self.branching_factors):
            digits.append(rem % bf)
            rem //= bf
        return list(reversed(digits))

    def nodes_for_scen(self, scennum):
        """Global ids of the non-leaf nodes scenario scennum passes
        through, one per stage 1..n_stages-1 (reference hydro.py
        MakeNodesforScen)."""
        digits = self.scen_digits(scennum)
        ids = [0]
        idx = 0  # index of current node within its stage
        for t in range(1, self.n_stages - 1):
            idx = idx * self.branching_factors[t - 1] + digits[t - 1]
            ids.append(int(self._stage_offsets[t] + idx))
        return ids

    def nodenames_for_scen(self, scennum):
        return [self.nodenames[i] for i in self.nodes_for_scen(scennum)]

    def scen_probability(self, scennum):
        """Unconditional probability (reference
        spbase.py:378 _compute_unconditional_node_probabilities)."""
        p = 1.0
        for t, d in enumerate(self.scen_digits(scennum)):
            p *= float(self.cond_probs[t][d])
        return p

    def node_of_slots(self, scennum, stage_of):
        """(K,) global node id per nonant slot, given each slot's stage
        (1-based).  Slots of stage t attach to the scenario's stage-t
        node."""
        ids = self.nodes_for_scen(scennum)
        stage_of = np.asarray(stage_of, np.int32)
        if stage_of.size and stage_of.max() > len(ids):
            raise ValueError(
                f"nonant slot declared at stage {int(stage_of.max())} but "
                f"the tree has only {len(ids)} non-leaf stages")
        return np.array([ids[t - 1] for t in stage_of], np.int32)

    def scens_of_node(self, node_id):
        """List of scenario numbers passing through node_id."""
        return [s for s in range(self.num_scens)
                if node_id in self.nodes_for_scen(s)]

    def stage_of_node(self, node_id):
        """1-based stage of a node id."""
        return int(np.searchsorted(self._stage_offsets, node_id,
                                   side="right"))

    def parent_of(self, node_id):
        """Parent node id (None for ROOT)."""
        if node_id == 0:
            return None
        t = self.stage_of_node(node_id)           # node's stage
        idx = node_id - self._stage_offsets[t - 1]
        pidx = idx // self.branching_factors[t - 2]
        return int(self._stage_offsets[t - 2] + pidx)


def two_stage_tree(num_scens, probs=None):
    """Degenerate 1-node tree for 2-stage problems."""
    t = MultistageTree([num_scens],
                       cond_probs=None if probs is None else [probs])
    return t
