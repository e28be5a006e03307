"""Xhat-specific inner-bound spoke (port of
`mpisppy_tpu/cylinders/xhatspecific_bounder.py`): evaluates one
user-given node->scenario dict against the hub's latest nonants."""

from __future__ import annotations

import numpy as np

from ..device import host
from ..utils.xhat_utils import (candidate_from_sources, node_members,
                                round_integer_nonants)
from .spoke import InnerBoundNonantSpoke


class XhatSpecificInnerBound(InnerBoundNonantSpoke):
    converger_spoke_char = "S"

    def __init__(self, spbase_object, options=None):
        super().__init__(spbase_object, options=options)
        # {"ROOT": scen_index, "ROOT_0": ...} by node name or id
        spec = self.options.get("xhat_scenario_dict")
        if spec is None:
            raise ValueError(
                "XhatSpecificInnerBound needs options['xhat_scenario_dict']")
        self.node_to_src = {}
        names = list(getattr(self.opt, "all_nodenames", None) or [])
        scen_names = list(self.opt.all_scenario_names)
        for k, v in spec.items():
            if isinstance(k, str):
                if k not in names:
                    raise ValueError(
                        f"node name {k!r} not in all_nodenames {names}")
                node = names.index(k)
            else:
                node = int(k)
            snum = (scen_names.index(v) if isinstance(v, str)
                    else int(v))
            self.node_to_src[node] = snum
        # the dict must cover every real tree node: a partial one would
        # evaluate the wrong candidate
        self._node_of = host(self.opt.batch.tree.node_of)
        real_nodes = set(node_members(
            self._node_of[:self.opt.n_real_scens]))
        missing = real_nodes - set(self.node_to_src)
        if missing:
            raise ValueError(
                f"xhat_scenario_dict misses tree nodes {sorted(missing)}")

    def step(self):
        x_na, is_new = self.fresh_nonants()
        if self._killed or not is_new:
            return False
        cand = candidate_from_sources(np.asarray(x_na), self._node_of,
                                      self.node_to_src)
        cand = round_integer_nonants(self.opt.batch, cand)
        obj, feas = self.opt.evaluate_xhat(cand)
        if feas:
            self.update_if_improving(obj, solution=cand)
        return True
