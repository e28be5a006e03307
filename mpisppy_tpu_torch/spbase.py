"""SPBase — scenario manager on one device (port of
`mpisppy_tpu/spbase.py`).

Owns the lowered ScenarioBatch and its placement on the device, and
checks that the scenario probabilities sum to one.  The batch is passed
in (`batch=`, a vectorized builder's), or built by calling
`scenario_creator(name, **scenario_creator_kwargs)` for every scenario
name and stacking the results (`ir.stack_scenarios`).  There is no
mesh: the port runs on one device.

`variable_probability` (an (S, K) array, or a callable batch -> (S, K))
sets per-(scenario, nonant slot) averaging weights (`batch.var_prob`),
which `phbase.compute_xbar` uses in place of the scenario
probabilities; a node whose weights do not sum to one draws a warning.
Algorithms that index A by scenario (`_needs_dense_A`: L-shaped, the
Schur-complement IPM, the MIP dive) get a dense per-scenario A.

Not ported yet (ROADMAP queue A): multi-device sharding.
"""

from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np
import torch

from . import global_toc
from .device import host, resolve_device
from .ir import ScenarioBatch, node_segment_sum, stack_scenarios

class SPBase:
    # algorithms that index A by scenario set this; SPBase then builds
    # the dense per-scenario A of a shared or split batch once
    _needs_dense_A = False

    def __init__(self, options, all_scenario_names, scenario_creator=None,
                 scenario_denouement=None, all_nodenames=None,
                 scenario_creator_kwargs=None, variable_probability=None,
                 batch: ScenarioBatch | None = None, device=None):
        self.options = dict(options or {})
        self.all_scenario_names = list(all_scenario_names)
        self.all_nodenames = all_nodenames
        self.scenario_creator = scenario_creator
        self.scenario_denouement = scenario_denouement
        self.scenario_creator_kwargs = scenario_creator_kwargs or {}
        self.device = resolve_device(device)
        if batch is None:
            if scenario_creator is None:
                raise ValueError("need either a batch or a scenario_creator")
            global_toc(f"Creating {len(self.all_scenario_names)} scenarios")
            kw = dict(self.scenario_creator_kwargs)
            kw.setdefault("device", self.device)
            batch = stack_scenarios(
                [scenario_creator(name, **kw)
                 for name in self.all_scenario_names],
                scen_names=self.all_scenario_names)
        if self._needs_dense_A and (batch.shared_A or batch.split_A):
            batch = batch.densify()
        self.n_real_scens = len(self.all_scenario_names)
        if variable_probability is not None:
            vp = (variable_probability(batch)
                  if callable(variable_probability)
                  else variable_probability)
            vp = torch.as_tensor(np.asarray(vp)).to(batch.c.dtype)
            if tuple(vp.shape) != (batch.num_scens, batch.num_nonants):
                raise ValueError(
                    f"variable_probability must be (S, K) = "
                    f"({batch.num_scens}, {batch.num_nonants}), "
                    f"got {tuple(vp.shape)}")
            batch = dataclasses.replace(batch, var_prob=vp)
        self.batch = batch.to(self.device)
        self._verify_probabilities()
        self.is_minimizing = True
        global_toc(
            f"SPBase: {self.n_real_scens} scenarios x "
            f"{self.batch.num_vars} vars x {self.batch.num_rows} rows, "
            f"{self.batch.num_nonants} nonants, on {self.device}")

    def _verify_probabilities(self):
        tot = float(torch.sum(self.batch.prob))
        if abs(tot - 1.0) > 1e-6:
            raise RuntimeError(
                f"scenario probabilities sum to {tot}, not 1 "
                "(reference hard-quits here too, spbase.py:470)")
        if self.batch.var_prob is not None:
            # per-variable weights should sum to 1 within each node
            # (the reference warns, spbase.py:457-502)
            tree = self.batch.tree
            _, segsum = node_segment_sum(tree.node_of, tree.num_nodes)
            bad = float(torch.max(torch.abs(
                segsum(self.batch.var_prob) - 1.0)))
            if bad > 1e-6:
                global_toc(
                    f"WARNING: variable_probability sums deviate from 1 "
                    f"by up to {bad:.3g} within a node "
                    "(reference warns here too, spbase.py:483)")

    # -- solution writers (spbase.py:618-651 of the JAX package) ----------
    def write_first_stage_solution(self, path, xbar_root):
        """CSV of the root-node consensus values, one `name,value` row
        per nonant."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        names = self.batch.tree.nonant_names
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            for name, v in zip(names, host(xbar_root).tolist()):
                w.writerow([name, v])
        global_toc(f"Wrote first-stage solution to {path}")

    def write_tree_solution(self, directory, x):
        """One CSV of all variables per scenario."""
        os.makedirs(directory, exist_ok=True)
        xa = host(x)[: self.n_real_scens]
        for si, sname in enumerate(self.all_scenario_names):
            with open(os.path.join(directory, f"{sname}.csv"), "w",
                      newline="") as f:
                w = csv.writer(f)
                for vi, vname in enumerate(self.batch.var_names
                                           or range(xa.shape[1])):
                    w.writerow([vname, float(xa[si, vi])])
        global_toc(f"Wrote tree solution to {directory}/")
