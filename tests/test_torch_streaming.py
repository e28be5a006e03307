"""The port's streaming layer (`mpisppy_tpu_torch/streaming/`) held to
the JAX package's (`mpisppy_tpu/streaming/`) on the CPU, at the JAX
tests' sizes:

* block builders (farmer dense and split-native, uc, aircond's tree
  source) and `gather_block` (dense and SplitA) equal to the JAX ones
  exactly;
* `AdaptiveSampler` draws and `SamplingRule` values equal, the sampler
  state round-trips;
* `ScenarioStream` order, worker errors and close;
* `StreamingPH` over farmer (S=32, blocks of 8, a certification every
  3 supersteps) against the JAX package at every superstep: W_host,
  x̄ and conv to 1e-6, the certify history (n, G, s) to 1e-6, the same
  verdict;
* a stream checkpoint written by either package resumed by the other,
  and a chaos crash resumed in the port.

The JAX power iterations' PRNGKey(0) draw is patched into the port
(`torch_parity.jax_draw`), as in the other parity files.
"""

import os

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX package's tests configure it)

from mpisppy_tpu.confidence_intervals import seqsampling as jseq
from mpisppy_tpu.models import aircond as jaircond
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import uc as juc
from mpisppy_tpu.streaming import gather_block as jgather
from mpisppy_tpu.streaming import sampler as jsampler
from mpisppy_tpu.streaming.streaming_ph import StreamingPH as JSPH
from mpisppy_tpu_torch.confidence_intervals import seqsampling
from mpisppy_tpu_torch.models import aircond, farmer, uc
from mpisppy_tpu_torch.resilience.chaos import ChaosError
from mpisppy_tpu_torch.resilience.checkpoint import load_stream_checkpoint
from mpisppy_tpu_torch.streaming import (AdaptiveSampler, BatchSource,
                                         GeneratorSource, ScenarioStream,
                                         StreamClosed, gather_block,
                                         source_for_module)
from mpisppy_tpu_torch.streaming.streaming_ph import StreamingPH
from torch_parity import (ONE, assert_same_batch,  # noqa: F401
                          jax_ci_one_mesh, jax_draw, one_torch_thread,
                          rel)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_draw",
                                     "jax_ci_one_mesh")


TOL = 1e-6
S = 32
STEPS = 6


# ---- block builders and gathers -------------------------------------------

def _check_builder(case):
    idx = np.array([0, 2, 3, 7, 11, 30])
    if case.startswith("farmer"):
        cfg = {"split": case == "farmer_split"}
        t = farmer.scenario_source(64, cfg).block(idx)
        j = jfarmer.scenario_source(64, cfg).block(idx)
    elif case == "uc":
        cfg = {"H": 4}
        t = uc.scenario_source(40, cfg).block(idx)
        j = juc.scenario_source(40, cfg).block(idx)
        assert t.shared_A and t.A.shape[0] == 1
    else:
        cfg = {"branching_factors": "4,3,3"}
        t = aircond.scenario_source(0, cfg).block(idx)
        j = jaircond.scenario_source(0, cfg).block(idx)
    assert t.c.device.type == "cpu"
    assert_same_batch(t, j)


def _check_gather(split):
    t = gather_block(farmer.build_batch(12, split=split, device="cpu"),
                     [1, 4, 5, 10])
    j = jgather(jfarmer.build_batch(12, split=split), [1, 4, 5, 10])
    assert_same_batch(t, j)
    if split:
        # the shared block passes through unreplicated
        assert tuple(t.A.shared.shape) == (7, 12)
        assert tuple(t.A.vals.shape) == (4, 6)


# ---- sampler and rule -----------------------------------------------------

RULE_OPTS = [({"BM_h": 1.2, "BM_hprime": 0.3, "BM_eps": 0.5, "n0min": 9},
              "BM", False),
             ({"BM_q": 1.2, "BM_p": 0.1}, "BM", False),
             ({"BPL_eps": 50.0, "n0min": 12}, "BPL", False),
             ({"BPL_eps": 50.0}, "BPL", True)]


def _check_rule(opts, crit, stoch):
    t = seqsampling.SamplingRule(opts, stochastic_sampling=stoch,
                                 stopping_criterion=crit)
    j = jseq.SamplingRule(opts, stochastic_sampling=stoch,
                          stopping_criterion=crit)
    for k in (1, 2, 5, 17):
        for G, s, nk in ((10.0, 1.0, 9), (0.1, 1.0, 30), (3.0, 0.5, None)):
            assert t.sample_size(k, G, s, nk) == j.sample_size(k, G, s, nk)
    for G, s, nk in ((10.0, 1.0, 9), (0.1, 1.0, 30), (100.0, 40.0, 64)):
        assert t.should_continue(G, s, nk) == j.should_continue(G, s, nk)
    assert t.ci_upper(2.0) == j.ci_upper(2.0)
    if crit == "BM":
        assert seqsampling._bm_constant(t.p, t.q, 0.95) == \
            jseq._bm_constant(j.p, j.q, 0.95)


def _check_sampler():
    rule_t = seqsampling.SamplingRule({"BM_h": 1.5, "BM_hprime": 0.2,
                                       "BM_eps": 0.1, "n0min": 10})
    rule_j = jseq.SamplingRule({"BM_h": 1.5, "BM_hprime": 0.2,
                                "BM_eps": 0.1, "n0min": 10})
    t = AdaptiveSampler(rule_t, 500, block_size=8, seed=7)
    j = jsampler.AdaptiveSampler(rule_j, 500, block_size=8, seed=7)
    sizes = []
    for G, s in ((5.0, 1.0), (4.0, 2.0), (3.0, 1.0)):
        np.testing.assert_array_equal(t.draw_block(), j.draw_block())
        assert t.observe(G, s) == j.observe(G, s)
        assert t.active_n == j.active_n
        sizes.append(t.active_n)
    assert sizes == sorted(sizes) and sizes[-1] <= 500
    st = t.state()
    assert st == j.state()
    ahead = [t.draw_block() for _ in range(3)]
    t.restore(st)
    j.restore(st)
    for a in ahead:
        np.testing.assert_array_equal(t.draw_block(), a)
        np.testing.assert_array_equal(j.draw_block(), a)


# ---- the stream -----------------------------------------------------------

def _check_stream():
    src = farmer.scenario_source(16, {})
    with ScenarioStream(src) as st:
        st.prefetch([0, 1, 2])
        st.prefetch([10, 11])
        i1, b1 = st.next_block()
        i2, b2 = st.next_block()
        assert list(i1) == [0, 1, 2] and b1.num_scens == 3
        assert list(i2) == [10, 11] and b2.num_scens == 2
        assert st.stats()["blocks_loaded"] == 2
        assert st.stats()["scenarios_streamed"] == 5
        # a failing build surfaces on next_block, the stream goes on
        st.prefetch([99])
        with pytest.raises(IndexError):
            st.next_block()
        st.prefetch([4])
        assert list(st.next_block()[0]) == [4]
    with pytest.raises(StreamClosed):
        st.prefetch([0])
    st.close()                               # idempotent
    with pytest.raises(ValueError, match="empty"):
        GeneratorSource("g", 4, lambda i: None).block([])


# ---- StreamingPH against the JAX package ----------------------------------

def _opts(**kw):
    o = {"PHIterLimit": STEPS, "defaultPHrho": 1.0, "solver_eps": 1e-6,
         "stream_block_size": 8, "stream_check_every": 3,
         "stream_seed": 0, "BM_h": 2.0, "BM_hprime": 0.2,
         "BM_eps": 200.0}
    o.update(kw)
    return o


def _tracing(cls, save_at=None):
    """`cls` recording (W_host, x̄, conv) after every superstep, and
    writing its checkpoint only at superstep `save_at`."""

    class Tracing(cls):
        def ph_iteration(self):
            conv = super().ph_iteration()
            self.trace.append((self.W_host.copy(), self.xbar_host.copy(),
                               float(self.conv)))
            return conv

        def _save_checkpoint(self, path):
            if save_at is None or int(self.state.it) == save_at:
                super()._save_checkpoint(path)

    return Tracing


def _port(opts, cls=StreamingPH):
    sph = cls(opts, source_for_module(farmer, S, {}), module=farmer,
              device="cpu")
    sph.trace = []
    return sph


def _jax(opts, cls=JSPH):
    sph = cls(opts, jfarmer.scenario_source(S, {}), module=jfarmer,
              mesh=ONE)
    sph.trace = []
    return sph


def test_certify_step_matches_jax():
    """One certification of a fixed consensus on both packages: the
    estimator sample, (G, s) and the stopping verdict."""
    t = _port(_opts())
    j = _jax(_opts())
    for sph in (t, j):
        sph.xbar_host = np.array([160.0, 90.0, 250.0])
        sph._certify_step()
    t.close()
    assert t._est_history[0][0] == j._est_history[0][0] == 10
    assert rel(t._est_history[0][1:], j._est_history[0][1:]) <= TOL
    assert t._est_seed == j._est_seed
    assert t.sampler.state() == j.sampler.state()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_draw, one_torch_thread, jax_ci_one_mesh):
    d = tmp_path_factory.mktemp("stream")
    ck = {k: os.fspath(d / k) for k in ("jax", "port")}
    j = _jax(_opts(run_checkpoint=ck["jax"]), _tracing(JSPH, 3))
    j.stream_main(finalize=False)
    t = _port(_opts(run_checkpoint=ck["port"]),
              _tracing(StreamingPH, 3))
    t.stream_main(finalize=False)
    return {"jax": j, "port": t, "ck": ck}


def _assert_state_close(t, j):
    assert int(t.state.it) == int(j.state.it)
    assert rel(t.W_host, j.W_host) <= TOL
    assert rel(t.xbar_host, j.xbar_host) <= TOL
    assert rel(t.conv, j.conv) <= TOL
    np.testing.assert_array_equal(t.solved, j.solved)
    assert t.sampler.state() == j.sampler.state()
    np.testing.assert_array_equal(t._pending_indices, j._pending_indices)


def _check_every_superstep(runs):
    t, j = runs["port"], runs["jax"]
    assert len(t.trace) == len(j.trace) == STEPS
    for (tw, tx, tc), (jw, jx, jc) in zip(t.trace, j.trace):
        assert rel(tw, jw) <= TOL and rel(tx, jx) <= TOL
        assert rel(tc, jc) <= TOL
    assert rel(t.trivial_bound, j.trivial_bound) <= TOL
    _assert_state_close(t, j)
    th, jh = t._est_history, j._est_history
    assert len(th) == len(jh) == STEPS // 3
    for a, b in zip(th, jh):
        assert a[0] == b[0] and rel(a[1:], b[1:]) <= TOL
    assert (t.certified is None) == (j.certified is None)
    st = t.stream_stats()
    assert st["peak_block_scens"] <= st["block_width"] == 8
    assert st["blocks_loaded"] == j.stream_stats()["blocks_loaded"]
    assert not t.solved[t.sampler.active_n:].any()


def _check_cross_resume(runs, writer):
    """A checkpoint written at superstep 3 by one package, resumed by
    the other, ends at the writer's superstep-6 state."""
    ref = runs[writer]
    ck = runs["ck"][writer]
    if writer == "jax":
        r = _port(_opts(resume_from=ck))
    else:
        r = _jax(_opts(resume_from=ck))
    r.stream_main(finalize=False)
    _assert_state_close(r, ref) if writer == "jax" else \
        _assert_state_close(ref, r)


def _check_crash_resume(runs, tmp_path):
    ck = os.fspath(tmp_path / "ck")
    a = runs["port"]
    b1 = _port(_opts(run_checkpoint=ck, chaos={"crash_at_iter": 4}))
    with pytest.raises(ChaosError):
        b1.stream_main(finalize=False)
    b2 = _port(_opts(resume_from=ck))
    b2.stream_main(finalize=False)
    np.testing.assert_array_equal(a.W_host, b2.W_host)
    np.testing.assert_array_equal(a.xbar_host, b2.xbar_host)
    assert a.conv == b2.conv and a._est_history == b2._est_history
    np.testing.assert_array_equal(a._pending_indices, b2._pending_indices)
    # a plain PH run checkpoint is refused
    p = os.fspath(tmp_path / "plain.npz")
    np.savez(p, W=np.zeros((S, 3)))
    with pytest.raises(ValueError, match="plain PH run checkpoint"):
        load_stream_checkpoint(p, b2)


def _check_refusals():
    b = aircond.build_batch((2, 2), device="cpu")
    with pytest.raises(NotImplementedError, match="two-stage"):
        StreamingPH(_opts(), BatchSource(b), device="cpu")
    sph = StreamingPH(_opts(PHIterLimit=1),
                      BatchSource(farmer.build_batch(8, device="cpu")),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="randomized"):
        sph.lagrangian_bound()
    sph.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            StreamingPH(_opts(), farmer.scenario_source(8, {}))


# ---- the tests: five, each a few of the checks above ----------------------
# (a file of at most five tests is queued after the suite's heavy
# few-test files by pytest-xdist's loadfile scheduling, which orders
# files by their number of tests; it then runs beside them)

def test_block_builders_and_gathers_equal_jax():
    for case in ("farmer_dense", "farmer_split", "uc", "aircond"):
        _check_builder(case)
    for split in (False, True):
        _check_gather(split)


def test_sampling_rule_and_sampler_equal_jax():
    for opts, crit, stoch in RULE_OPTS:
        _check_rule(opts, crit, stoch)
    _check_sampler()


def test_stream_order_errors_close_and_refusals():
    _check_stream()
    _check_refusals()


def test_streaming_ph_and_its_checkpoints_match_jax(runs, tmp_path):
    _check_every_superstep(runs)
    for writer in ("jax", "port"):
        _check_cross_resume(runs, writer)
    _check_crash_resume(runs, tmp_path)
