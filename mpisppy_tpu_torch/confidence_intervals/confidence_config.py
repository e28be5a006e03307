"""Config groups for the confidence-interval layer (port of
`mpisppy_tpu/confidence_intervals/confidence_config.py`; the
reference's mpisppy/confidence_intervals/confidence_config.py:3-85)."""

from __future__ import annotations


def confidence_config(cfg):
    cfg.add_to_config("confidence_level", "CI confidence level",
                      float, 0.95)


def sequential_config(cfg):
    confidence_config(cfg)
    cfg.add_to_config("sample_size_ratio", "growth factor", float, 1.5)
    cfg.add_to_config("xhat1_option", "candidate source", str, "xhat_xbar")
    cfg.add_to_config("n0min", "initial sample size", int, 10)


def BM_config(cfg):
    sequential_config(cfg)
    cfg.add_to_config("BM_h", "BM h parameter", float, 2.0)
    cfg.add_to_config("BM_hprime", "BM h' parameter", float, 0.1)
    cfg.add_to_config("BM_eps", "BM eps", float, 1e-2)
    cfg.add_to_config("BM_eps_prime", "BM eps'", float, 1e-3)
    cfg.add_to_config("BM_p", "BM p", float, 0.1)
    cfg.add_to_config("BM_q", "BM q", float, 1.2)


def BPL_config(cfg):
    sequential_config(cfg)
    cfg.add_to_config("BPL_eps", "BPL fixed width", float, 1.0)
    cfg.add_to_config("BPL_c0", "BPL initial sample", int, 20)
    cfg.add_to_config("BPL_n0min", "BPL minimal n0", int, 0)


def zhat_config(cfg):
    confidence_config(cfg)
    cfg.add_to_config("num_samples", "evaluation batches", int, 5)
    cfg.add_to_config("sample_size", "scenarios per batch", int, 10)
