"""IndepScens_SeqSampling — multistage sequential sampling with
independent scenario resampling (port of
`mpisppy_tpu/confidence_intervals/multi_seqsampling.py`; the
reference's mpisppy/confidence_intervals/multi_seqsampling.py:29-339).

The multistage variant of SeqSampling: candidates come from a sampled
TREE (branching factors), and gap estimation evaluates the stage-1
candidate on independently resampled trees (sample_tree fans).
"""

from __future__ import annotations

import numpy as np

from .. import global_toc
from ..opt.ef import ExtensiveForm
from .sample_tree import walking_tree_xhats
from .seqsampling import SeqSampling


class IndepScens_SeqSampling(SeqSampling):
    def __init__(self, mname, optionsdict, seed=0,
                 stopping_criterion="BM", device=None):
        super().__init__(mname, optionsdict, seed=seed,
                         stopping_criterion=stopping_criterion,
                         solving_type="EF_mstage", device=device)
        bf = self.options.get("branching_factors", [3, 3])
        from ..utils.config import parse_branching_factors
        self.branching_factors = parse_branching_factors(bf)

    def _candidate(self, n, seed):
        """Sampled-tree EF -> stage-1 xhat.  `n` scales the FIRST
        branching factor (the independent-scenarios axis)."""
        bf = list(self.branching_factors)
        bf[0] = max(bf[0], int(np.ceil(n / int(np.prod(bf[1:]) or 1))))
        batch = self._tree_batch(bf, seed)
        names = list(batch.tree.scen_names)
        ef = ExtensiveForm(
            {"pdhg_eps": self.options.get("solver_eps", 1e-7)},
            names, batch=batch, device=self.device)
        ef.solve_extensive_form()
        sol = np.asarray(ef.get_root_solution())
        # root nonants only (stage-1 slots)
        stage_of = np.asarray(batch.tree.stage_of)
        return sol[stage_of == 1]

    def _tree_batch(self, bf, seed):
        import inspect
        kw = dict(self.module.kw_creator(self.options)) if hasattr(
            self.module, "kw_creator") else {}
        kw["branching_factors"] = tuple(bf)
        sig = inspect.signature(self.module.build_batch)
        for s in ("seed", "seedoffset", "start_seed"):
            if s in sig.parameters:
                kw[s] = seed
                break
        if "device" in sig.parameters:
            kw["device"] = self.device
        return self.module.build_batch(**kw)

    def run(self):
        n = None
        seed = self.seed
        history = []
        xhat = None
        G = s = None
        # candidate-padding metadata depends only on the branching
        # factors, not the sample seed — compute once, not per
        # iteration (each _tree_batch materializes the full tensor)
        meta_batch = self._tree_batch(self.branching_factors, self.seed)
        K = meta_batch.num_nonants
        stage_of = np.asarray(meta_batch.tree.stage_of)
        for k in range(1, self.max_iters + 1):
            # the reference forces kf_Gs = kf_xhat = 1 for multistage
            # (seqsampling.py:233-241): every sample is a fresh tree;
            # sizes follow the BM/BPL schedules
            n = self._sample_size(k, G, s, n)
            xhat1 = self._candidate(n, seed)
            seed += n
            # pad the stage-1 candidate to the full nonant layout for
            # evaluation (later stages stay free via upto_stage=1)
            xhat = np.zeros(K)
            xhat[stage_of == 1] = xhat1
            vals = walking_tree_xhats(
                self.module, xhat, self.branching_factors, seed=seed,
                options=self.options,
                num_samples=int(self.options.get("num_eval_samples", 3)),
                device=self.device)
            seed += 7919
            if not vals:
                global_toc("IndepScens: no feasible evaluation; "
                           "resampling at the schedule's next size")
                G = s = None
                continue
            zhat = float(np.mean(vals))
            # gap vs the sampled-tree optimum at this iteration
            est_batch = self._tree_batch(self.branching_factors,
                                         seed + 13)
            names = list(est_batch.tree.scen_names)
            ef = ExtensiveForm(
                {"pdhg_eps": self.options.get("solver_eps", 1e-7)},
                names, batch=est_batch, device=self.device)
            ef.solve_extensive_form()
            zstar = ef.get_objective_value()
            G = max(zhat - zstar, 0.0)
            s = float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0
            history.append((n, G, s))
            stop = not self._continue(G, s, max(len(vals), 2))
            global_toc(f"IndepScens iter {k}: n={n} G={G:.6g} "
                       f"s={s:.6g} stop={stop}")
            if stop:
                upper = (self.h * s + self.eps
                         if self.stopping_criterion == "BM"
                         else self.bpl_eps)
                return {"xhat_one": xhat, "G": G, "std": s, "s": s,
                        "num_scens": n, "T": k,
                        "CI": [0.0, float(upper)], "history": history}
        return {"xhat_one": xhat, "G": G, "std": s, "s": s,
                "num_scens": n, "T": self.max_iters, "history": history,
                "stopped": False}
