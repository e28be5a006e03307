"""confidence_intervals — statistical bounds on a candidate solution
(port of `mpisppy_tpu/confidence_intervals/`): the gap estimators
(`ciutils`), the BM/BPL sampling rule and sequential sampling
(`seqsampling`, `multi_seqsampling`, `sample_tree`), MMW intervals
(`mmw_ci`) and the t-interval on z(xhat) (`zhat4xhat`)."""
