"""Sequential sampling (port of
`mpisppy_tpu/confidence_intervals/seqsampling.py`; the reference's
mpisppy/confidence_intervals/seqsampling.py:110-585) — produce a
candidate xhat together with a confidence interval on its optimality
gap by solving sampled problems of growing size.

Implements both stopping rules of the reference, with the full
parameterization:

* **BM** [Bayraksan & Morton 2011, "A Sequential Sampling Procedure
  for Stochastic Programming"]: continue while
  ``G_k > BM_hprime * s_k + BM_eps_prime``; the deterministic sample
  size schedule is eq. (5)/(14) of the paper,
      n_k >= (c + 2 p ln^2 k) / (h - h')^2          (BM_q is None)
      n_k >= (c + 2 p k^{2q/r}) / (h - h')^2        (BM_q given, r=2)
  with c = max(1, 2 ln( sum_j exp(-p ln^2 j) / (sqrt(2 pi) (1-alpha))))
  (resp. sum_j exp(-p j^{2q/r})).  Final CI: [0, BM_h*s_k + BM_eps].
* **BPL** [Bayraksan & Pierre-Louis 2012, "Fixed-Width Sequential
  Stopping Rules"]: continue while
  ``G_k + t_{alpha,n_k-1} s_k / sqrt(n_k) + 1/sqrt(n_k) > BPL_eps``;
  sample sizes either deterministic
  ``n_k = BPL_c0 + BPL_c1 * growth_function(k)`` (growth_function
  defaults to k-1) or **stochastic** (sec. 5 of the paper,
  `stochastic_sampling=True`): n_1 = max(BPL_n0min, ln(1/eps)), then
  n_k solves the quadratic  -eps n + (1 + t s) sqrt(n) + n_{k-1} G = 0
  in sqrt(n).  Final CI: [0, BPL_eps].

The rule arithmetic lives in the standalone `SamplingRule` class so
consumers with their OWN gap estimate (streaming.AdaptiveSampler feeds
it G/s from a sampled-PH trajectory) can drive the schedule without
inheriting SeqSampling's solve loop.  SeqSampling composes a rule and
mirrors its knobs as instance attributes for back-compat
(multi_seqsampling and user code read `self.h` / `self.bpl_eps` etc.).

Shared options (reference cfg knobs, same names):
  sample_size_ratio — m_k = ratio * n_k scenarios for the xhat solve
  ArRP              — pool G/s from ArRP disjoint sub-estimators
  kf_Gs, kf_xhat    — resampling frequencies: at iterations where
                      k % kf != 0 the previous sample is EXTENDED
                      (same seed, more scenarios) instead of redrawn
  confidence_level  — alpha for quantiles and the c constant
  n0min             — floor on every n_k (this build's extension; the
                      reference has it only for stochastic sampling)

Candidate solves use the batched consensus EF (`opt/ef.py`);
evaluation uses the batched fixed-nonant solve
(ciutils.gap_estimators).  `device` (default: the CUDA device) is where
every sampled batch is built and solved.
"""

from __future__ import annotations

import importlib

import numpy as np

from .. import global_toc
from ..device import resolve_device
from ..opt.ef import ExtensiveForm
from . import ciutils


def _bm_constant(p, q, confidence_level, r=2):
    """The c_p / c_pq constant of [bm2011] eqs. (5)/(14)."""
    j = np.arange(1, 1000)
    if q is None:
        ssum = np.sum(np.power(j.astype(float), -p * np.log(j)))
    else:
        if q < 1:
            raise ValueError("BM_q must be >= 1")
        ssum = np.sum(np.exp(-p * np.power(j.astype(float), 2 * q / r)))
    return max(1.0, 2 * np.log(
        ssum / (np.sqrt(2 * np.pi) * (1 - confidence_level))))


class SamplingRule:
    """Standalone BM/BPL stopping rule + sample-size schedule.

    Stateless between calls: every method takes the current gap
    estimate (G, s) and sample size, so any driver that can produce a
    gap estimate — SeqSampling's sampled-EF loop, the streaming
    AdaptiveSampler, user code — can ask `should_continue` /
    `sample_size` without subclassing anything.  Knob names and
    defaults are exactly SeqSampling's options-dict surface.
    """

    def __init__(self, options=None, stochastic_sampling=False,
                 stopping_criterion="BM"):
        o = dict(options or {})
        if stopping_criterion not in ("BM", "BPL"):
            raise ValueError("Only BM and BPL criteria are supported")
        self.stopping_criterion = stopping_criterion
        self.stochastic_sampling = bool(
            o.get("stochastic_sampling", stochastic_sampling))

        # shared knobs
        self.confidence = float(o.get("confidence_level", 0.95))
        self.n0 = int(o.get("n0min", o.get("nn0min", 10)))

        # BM knobs [bm2011]
        self.h = float(o.get("BM_h", 2.0))
        self.hprime = float(o.get("BM_hprime", 0.0))
        self.eps = float(o.get("BM_eps", 1e-2))
        self.eps_prime = float(o.get("BM_eps_prime", self.eps))
        self.p = float(o.get("BM_p", 0.191))
        self.q = o.get("BM_q", None)
        if self.q is not None:
            self.q = float(self.q)

        # BPL knobs [bpl2012]
        bpl_eps = o.get("BPL_eps", o.get("eps"))
        self.bpl_eps = float(1.0 if bpl_eps is None else bpl_eps)
        self.bpl_c0 = int(o.get("BPL_c0", self.n0))
        self.bpl_c1 = float(o.get("BPL_c1", 2))
        self.growth_function = o.get("growth_function", lambda k: k - 1)
        self.bpl_n0min = int(o.get("BPL_n0min", max(self.n0, 50)))

        self._c = (_bm_constant(self.p, self.q, self.confidence)
                   if stopping_criterion == "BM" else None)

    # -- stopping rules (True = CONTINUE, as in the reference) ------------
    def bm_continue(self, G, s, nk):
        return G > self.hprime * s + self.eps_prime

    def bpl_continue(self, G, s, nk):
        t = ciutils.t_quantile(self.confidence, max(nk - 1, 1))
        return (G + t * s / np.sqrt(nk) + 1.0 / np.sqrt(nk)
                > self.bpl_eps)

    def should_continue(self, G, s, nk):
        if self.stopping_criterion == "BM":
            return self.bm_continue(G, s, nk)
        return self.bpl_continue(G, s, nk)

    # -- sample-size schedules --------------------------------------------
    def bm_sampsize(self, k, G, s, nk_m1, r=2):
        if self.q is None:
            lower = ((self._c + 2 * self.p * np.log(k) ** 2)
                     / (self.h - self.hprime) ** 2)
        else:
            lower = ((self._c + 2 * self.p * k ** (2 * self.q / r))
                     / (self.h - self.hprime) ** 2)
        return int(np.ceil(lower))

    def bpl_fsp_sampsize(self, k, G, s, nk_m1):
        return int(np.ceil(self.bpl_c0
                           + self.bpl_c1 * self.growth_function(k)))

    def stochastic_sampsize(self, k, G, s, nk_m1):
        """[bpl2012] sec. 5: solve -eps*n + (1+t*s)*sqrt(n) + n_{k-1}G
        = 0 for sqrt(n).  Falls back to the initialization size when no
        (G, s) estimate exists yet (e.g. a multistage iteration whose
        evaluation produced no feasible sample)."""
        if k == 1 or G is None or s is None or nk_m1 is None:
            return int(np.ceil(max(self.bpl_n0min,
                                   np.log(1.0 / self.bpl_eps))))
        t = ciutils.t_quantile(self.confidence, max(nk_m1 - 1, 1))
        a = -self.bpl_eps
        bq = 1.0 + t * s
        cq = nk_m1 * G
        disc = max(bq * bq - 4 * a * cq, 0.0)
        maxroot = -(np.sqrt(disc) + bq) / (2 * a)
        return int(np.ceil(maxroot ** 2))

    def sample_size(self, k, G, s, nk_m1):
        if self.stochastic_sampling:
            n = self.stochastic_sampsize(k, G, s, nk_m1)
        elif self.stopping_criterion == "BM":
            n = self.bm_sampsize(k, G, s, nk_m1)
        else:
            n = self.bpl_fsp_sampsize(k, G, s, nk_m1)
        n = max(n, self.n0)
        if nk_m1 is not None:
            n = max(n, nk_m1)      # sample sizes must not shrink
        return n

    # -- the certified interval -------------------------------------------
    def ci_upper(self, s):
        """Upper end of the [0, u] gap CI once should_continue says
        stop: h*s + eps (BM) or the fixed width (BPL)."""
        if self.stopping_criterion == "BM":
            return float(self.h * s + self.eps)
        return float(self.bpl_eps)


# Attributes mirrored from the rule onto SeqSampling instances
# (multi_seqsampling and user code read them there).
_RULE_ATTRS = ("stochastic_sampling", "confidence", "n0",
               "h", "hprime", "eps", "eps_prime", "p", "q",
               "bpl_eps", "bpl_c0", "bpl_c1", "growth_function",
               "bpl_n0min", "_c")


class SeqSampling:
    def __init__(self, mname, optionsdict, seed=0,
                 stochastic_sampling=False,
                 stopping_criterion="BM", solving_type="EF_2stage",
                 device=None):
        self.module = (mname if not isinstance(mname, str)
                       else importlib.import_module(mname))
        self.options = dict(optionsdict or {})
        self.seed = int(seed)
        self.stopping_criterion = stopping_criterion
        self.solving_type = solving_type
        self.device = resolve_device(device)
        self.rule = SamplingRule(
            self.options, stochastic_sampling=stochastic_sampling,
            stopping_criterion=stopping_criterion)
        for a in _RULE_ATTRS:
            setattr(self, a, getattr(self.rule, a))
        o = self.options

        # loop-only knobs (not part of the rule arithmetic)
        self.sample_size_ratio = float(o.get("sample_size_ratio", 1))
        self.ArRP = int(o.get("ArRP", 1))
        self.kf_Gs = int(o.get("kf_Gs", 1))
        self.kf_xhat = int(o.get("kf_xhat", 1))
        self.max_iters = int(o.get("max_seq_iters", 200))

    # -- delegation to the rule (back-compat method names) ----------------
    def _bm_continue(self, G, s, nk):
        return self.rule.bm_continue(G, s, nk)

    def _bpl_continue(self, G, s, nk):
        return self.rule.bpl_continue(G, s, nk)

    def _continue(self, G, s, nk):
        return self.rule.should_continue(G, s, nk)

    def _bm_sampsize(self, k, G, s, nk_m1, r=2):
        return self.rule.bm_sampsize(k, G, s, nk_m1, r=r)

    def _bpl_fsp_sampsize(self, k, G, s, nk_m1):
        return self.rule.bpl_fsp_sampsize(k, G, s, nk_m1)

    def _stochastic_sampsize(self, k, G, s, nk_m1):
        return self.rule.stochastic_sampsize(k, G, s, nk_m1)

    def _sample_size(self, k, G, s, nk_m1):
        return self.rule.sample_size(k, G, s, nk_m1)

    # -- candidate solve ---------------------------------------------------
    def _candidate(self, n, seed):
        """Solve a sampled EF -> root xhat (reference xhat_generator_*
        helpers: sampled-amalgamator EF solve)."""
        batch = ciutils.sample_batch(self.module, n, seed, self.options,
                                     device=self.device)
        names = list(batch.tree.scen_names)[:n]
        ef = ExtensiveForm(
            {"pdhg_eps": self.options.get("solver_eps", 1e-7),
             "pdhg_max_iters":
                 self.options.get("solver_max_iters", 100000)},
            names, batch=batch, device=self.device)
        ef.solve_extensive_form()
        return np.asarray(ef.get_root_solution())

    # -- main loop (reference seqsampling.py:330-527 run) ------------------
    def run(self, maxit=None):
        maxit = maxit or self.max_iters
        mult = self.sample_size_ratio
        nk = None
        # xhat and estimator samples live in DISJOINT seed regions so a
        # kf-driven sample EXTENSION (same seed, larger n) can never
        # grow into scenarios the other side has drawn — overlap would
        # evaluate the candidate on its own training scenarios and bias
        # G downward, voiding the BM/BPL guarantee.  (The reference
        # keeps disjointness through a single ScenCount because its
        # extensions append NEW scenario names; seed-block sampling
        # needs the region split instead.)
        _REGION = 10_000_000
        xhat_seed = self.seed              # current xhat sample seed
        xhat_next = self.seed              # next unused seed, region A
        est_seed = self.seed + _REGION     # current estimator seed
        est_next = self.seed + _REGION     # next unused seed, region B
        history = []
        xhat = G = s = None
        stopped = False
        for k in range(1, maxit + 1):
            nk_m1 = nk
            nk = self._sample_size(k, G, s, nk_m1)
            nk = self.ArRP * int(np.ceil(nk / self.ArRP))
            mk = max(int(np.floor(mult * nk)), 1)

            # xhat sample: redraw at k % kf_xhat == 0, else extend
            # (same seed, larger n = previous draws plus new ones)
            if k == 1 or k % self.kf_xhat == 0:
                xhat_seed = xhat_next
            xhat_next = max(xhat_next, xhat_seed + mk)
            xhat = self._candidate(mk, xhat_seed)

            # estimator sample: redraw at k % kf_Gs == 0, else extend
            if k == 1 or k % self.kf_Gs == 0:
                est_seed = est_next
            est_next = max(est_next, est_seed + nk)
            est = ciutils.gap_estimators(
                xhat, self.module, solving_type=self.solving_type,
                num_scens=nk, seed=est_seed, cfg=self.options,
                ArRP=self.ArRP, device=self.device)
            G, s = est["G"], est["std"]
            history.append((nk, G, s))
            cont = self._continue(G, s, nk)
            global_toc(f"SeqSampling iter {k}: n={nk} m={mk} "
                       f"G={G:.6g} s={s:.6g} continue={cont}")
            if not cont:
                stopped = True
                break

        upper = self.rule.ci_upper(s)
        out = {"xhat_one": xhat, "G": G, "std": s, "s": s,
               "num_scens": nk, "T": k, "CI": [0.0, float(upper)],
               "Candidate_solution": xhat,
               "history": history, "seed": est_next}
        if not stopped:
            out["stopped"] = False
        return out
