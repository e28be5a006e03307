"""The port's durable shard store (`mpisppy_tpu_torch/streaming/
store.py`, `readahead.py`) held to the JAX package's on the CPU:

* a corpus written by either package is read by the other, block for
  block equal to the generator's, with the same header and payload
  arrays (dtypes included);
* header and CRC validation on every read, transient-fault retry,
  quarantine with the JAX package's deterministic substitution, the
  hard-fail budget, the storage cursor across packages, the readahead
  accounting;
* StreamingPH over a faulted corpus: the port's trajectory against the
  JAX package's, a certified stop whose CI carries the lost-mass debit,
  and a crash resumed through the storage cursor.
"""

import io
import json
import os

import numpy as np
import pytest

import jax  # noqa: F401  (the JAX package's tests configure it)

from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import uc as juc
from mpisppy_tpu.streaming import ShardSource as JShardSource
from mpisppy_tpu.streaming import ShardStore as JShardStore
from mpisppy_tpu.streaming.streaming_ph import StreamingPH as JSPH
from mpisppy_tpu_torch import telemetry
from mpisppy_tpu_torch.device import host
from mpisppy_tpu_torch.models import aircond, farmer, uc
from mpisppy_tpu_torch.resilience.chaos import ChaosError
from mpisppy_tpu_torch.resilience.checkpoint import atomic_write
from mpisppy_tpu_torch.streaming import (QuarantinedCorpusError,
                                         ReadaheadCache, RetryingSource,
                                         ShardIntegrityError,
                                         ShardQuarantinedError,
                                         ShardSource, ShardStore,
                                         write_corpus)
from mpisppy_tpu_torch.streaming.store import MAGIC, _decode_shard
from mpisppy_tpu_torch.streaming.streaming_ph import StreamingPH
from torch_parity import (ONE, assert_same_batch, jax_draw,  # noqa: F401
                          one_torch_thread, rel)

pytestmark = pytest.mark.usefixtures("one_torch_thread", "jax_draw")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A 64-scenario farmer corpus in 8-wide shards (split-native A)
    written by each package."""
    d = tmp_path_factory.mktemp("corpora")
    out = {"port": os.fspath(d / "port"), "jax": os.fspath(d / "jax")}
    farmer.export_corpus(out["port"], 64, shard_width=8)
    jfarmer.export_corpus(out["jax"], 64, shard_width=8)
    return out


@pytest.fixture
def farmer_corpus(corpora, tmp_path):
    """A private copy of the port-written corpus (tests corrupt it)."""
    import shutil
    path = os.fspath(tmp_path / "corpus")
    shutil.copytree(corpora["port"], path)
    return path


def _payload(path, sid):
    data = open(os.path.join(path, f"shard-{sid:06d}.mts"), "rb").read()
    hlen = int.from_bytes(data[len(MAGIC):len(MAGIC) + 4], "little")
    header = json.loads(data[len(MAGIC) + 4:len(MAGIC) + 4 + hlen])
    z = np.load(io.BytesIO(data[len(MAGIC) + 4 + hlen:]),
                allow_pickle=True)
    return header, {k: z[k] for k in z.files}


def _check_cross_read(corpora, writer):
    path = corpora[writer]
    idx = np.array([1, 5, 9, 17, 23, 63])
    t = ShardSource(path, depth=2)
    j = JShardSource(path, depth=2)
    ts, tb = t.block_with_indices(idx)
    js, jb = j.block_with_indices(idx)
    t.close()
    j.close()
    np.testing.assert_array_equal(ts, idx)
    np.testing.assert_array_equal(js, idx)
    assert_same_batch(tb, jb)
    assert type(tb.A).__name__ == "SplitA" and tb.c.device.type == "cpu"
    # the blocks served off disk are the generator's (the JAX package's
    # concatenation of shard parts stores probabilities 1/B)
    ref = farmer.scenario_source(64, {}).block(idx)
    for f in ("c", "row_lo", "row_hi", "lb", "ub", "nonant_idx"):
        np.testing.assert_array_equal(host(getattr(tb, f)),
                                      host(getattr(ref, f)))
    np.testing.assert_array_equal(host(tb.A.vals), host(ref.A.vals))
    assert t.names(idx) == [f"scen{i}" for i in idx]


def _check_same_files(corpora):
    for sid in (0, 7):
        th, tp = _payload(corpora["port"], sid)
        jh, jp = _payload(corpora["jax"], sid)
        for k in ("payload_len", "payload_crc32"):
            th.pop(k), jh.pop(k)
        assert th == jh
        assert sorted(tp) == sorted(jp)
        for k in tp:
            if tp[k].dtype == object:
                assert tp[k].tolist().__repr__() == \
                    jp[k].tolist().__repr__(), k
            else:
                assert tp[k].dtype == jp[k].dtype, k
                np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    assert json.load(open(os.path.join(corpora["port"], "manifest.json"))) \
        == json.load(open(os.path.join(corpora["jax"], "manifest.json")))


def _check_uc_shared(tmp_path):
    cfg = {"H": 4, "n_units": 2}
    path = os.fspath(tmp_path / "uc_corpus")
    uc.export_corpus(path, 12, shard_width=4, cfg=cfg)
    ss = ShardSource(path, depth=2)
    idx = np.array([0, 5, 9])
    _, blk = ss.block_with_indices(idx)
    ss.close()
    assert blk.shared_A and tuple(blk.A.shape)[0] == 1
    js = JShardSource(path, depth=2)
    _, jblk = js.block_with_indices(idx)
    js.close()
    assert_same_batch(blk, jblk)
    np.testing.assert_array_equal(host(blk.A), np.asarray(
        juc.scenario_source(12, cfg).block(idx).A))
    assert ss.names(idx) == ["Scenario1", "Scenario6", "Scenario10"]


def _check_multistage_refused(tmp_path):
    src = aircond.scenario_source(None, {"branching_factors": (3, 2)})
    with pytest.raises(NotImplementedError, match="two-stage only"):
        write_corpus(src, os.fspath(tmp_path / "ms"), 4)


def _check_flipped_byte(farmer_corpus):
    st = ShardStore(farmer_corpus, max_shard_retries=0,
                    max_quarantined_frac=0.5)
    p = st.shard_path(2)
    data = bytearray(open(p, "rb").read())
    data[-1] ^= 0xFF                       # payload region
    atomic_write(p, bytes(data))
    with pytest.raises(ShardQuarantinedError):
        st.read_checked(2)
    assert st.quarantined == {2}
    with pytest.raises(ShardIntegrityError, match="CRC mismatch"):
        _decode_shard(bytes(data))


def _check_magic_and_truncation(farmer_corpus):
    st = ShardStore(farmer_corpus)
    data = open(st.shard_path(0), "rb").read()
    with pytest.raises(ShardIntegrityError, match="magic"):
        _decode_shard(b"NOTMAGIC" + data[len(MAGIC):])
    with pytest.raises(ShardIntegrityError, match="truncated|length"):
        _decode_shard(data[:len(data) // 2])
    with pytest.raises(ShardIntegrityError, match="model ident"):
        _decode_shard(data, expect_model="not_farmer")
    with pytest.raises(ShardIntegrityError, match="seed range"):
        _decode_shard(data, expect_range=(8, 16))


def _check_transient_io_error(farmer_corpus):
    st = ShardStore(farmer_corpus, max_shard_retries=2, backoff=0.001,
                    backoff_cap=0.002, chaos={"io_error": 2})
    blk = st.read_checked(0)
    assert blk.num_scens == 8
    assert st.read_retries == 2
    assert st.quarantined == set()


def _check_substitution(farmer_corpus):
    ss = ShardSource(farmer_corpus, depth=3, max_shard_retries=1,
                     backoff=0.001, max_quarantined_frac=0.5,
                     chaos={"shard_corrupt": [5], "shard_missing": 6})
    served, blk = ss.block_with_indices(np.arange(64))
    ss.close()
    assert sorted(ss.store.quarantined) == [5, 6]
    assert ss.store.quarantined_frac == pytest.approx(0.25)
    assert not np.isin(served // 8, [5, 6]).any()
    assert served.size == 64 and blk.num_scens == 64
    # the substitution is a pure function of (indices, quarantine set),
    # the same in both packages
    for idx, q in ((np.arange(64), {5, 6}),
                   (np.array([0, 3, 17, 20, 41]), {0})):
        t = ShardStore(farmer_corpus, max_quarantined_frac=0.5)
        j = JShardStore(farmer_corpus, max_quarantined_frac=0.5)
        t.quarantined, j.quarantined = set(q), set(q)
        out = t.substitute_quarantined(idx)
        np.testing.assert_array_equal(out, j.substitute_quarantined(idx))
        if q == {0}:
            assert out.max() <= 41 and np.unique(out).size == 5
        else:
            np.testing.assert_array_equal(out, served)


def _check_budget(farmer_corpus):
    ss = ShardSource(farmer_corpus, depth=2, max_shard_retries=0,
                     backoff=0.001, max_quarantined_frac=0.1,
                     chaos={"shard_corrupt": [1, 2]})
    with pytest.raises(QuarantinedCorpusError,
                       match="max_quarantined_frac"):
        ss.block_with_indices(np.arange(64))
    ss.close()
    # a RetryingSource propagates the terminal error without retrying
    inner = ShardSource(farmer_corpus, depth=2, max_shard_retries=0,
                        backoff=0.001, max_quarantined_frac=0.1,
                        chaos={"shard_missing": [1, 2]})
    src = RetryingSource(inner, retries=3, backoff=0.001)
    with pytest.raises(QuarantinedCorpusError):
        src.block_with_indices(np.arange(64))
    assert src.retry_log == []
    inner.close()


def _check_cursor(farmer_corpus):
    st = ShardStore(farmer_corpus, max_shard_retries=0, backoff=0.001,
                    max_quarantined_frac=0.5, jitter_seed=3,
                    chaos={"shard_missing": [3]})
    with pytest.raises(ShardQuarantinedError):
        st.read_checked(3)
    cur = json.loads(json.dumps(st.state()))
    idx = np.arange(40)
    for other in (ShardStore, JShardStore):
        st2 = other(farmer_corpus, max_quarantined_frac=0.5)
        st2.restore(cur)
        assert st2.state() == cur
        assert st2.quarantined == {3}
        assert st2._retry_rng.getstate() == st._retry_rng.getstate()
        np.testing.assert_array_equal(st.substitute_quarantined(idx),
                                      st2.substitute_quarantined(idx))


def _check_readahead(farmer_corpus):
    tel = telemetry.configure(True)
    try:
        st = ShardStore(farmer_corpus, telemetry=tel)
        ra = ReadaheadCache(st, depth=4, telemetry=tel)
        ra.schedule([0, 1])
        a, b, c = ra.get(0), ra.get(1), ra.get(7)
        assert a.num_scens == b.num_scens == c.num_scens == 8
        assert ra.hits == 2 and ra.misses == 1
        assert ra.hit_rate == pytest.approx(2 / 3)
        ctr = telemetry.storage_counters(tel.registry)
        assert ctr["store_readahead_hits"] == 2
        assert ctr["store_readahead_misses"] == 1
        assert ctr["store_shards_read"] == 3
        ra.close()
    finally:
        telemetry.reset()
    st = ShardStore(farmer_corpus, max_shard_retries=0, backoff=0.001,
                    max_quarantined_frac=0.9, chaos={"shard_missing": [2]})
    ra = ReadaheadCache(st, depth=2)
    with pytest.raises(ShardQuarantinedError):
        ra.get(2)
    assert 2 not in ra._cache             # the poisoned entry is dropped
    assert ra.get(0).num_scens == 8
    ra.close()
    with pytest.raises(Exception):
        ra.get(1)


# ---- StreamingPH over a faulted corpus --------------------------------------

CHAOS = {"shard_missing": 6}


def _opts(**kw):
    o = {"PHIterLimit": 5, "defaultPHrho": 1.0, "solver_eps": 1e-6,
         "stream_block_size": 8, "stream_check_every": 100,
         "stream_seed": 0, "n0min": 64}
    o.update(kw)
    return o


def _src(pkg, path, chaos=CHAOS, retries=1):
    cls = ShardSource if pkg == "port" else JShardSource
    return cls(path, depth=4, max_shard_retries=retries, backoff=0.001,
               max_quarantined_frac=0.5, chaos=chaos)


def _check_faulted_parity(corpora):
    path = corpora["jax"]
    t = StreamingPH(_opts(), _src("port", path), device="cpu")
    t.stream_main(finalize=False)
    j = JSPH(_opts(), _src("jax", path), mesh=ONE)
    j.stream_main(finalize=False)
    assert t._shard_store().quarantined == j._shard_store().quarantined \
        == {6}
    assert rel(t.W_host, j.W_host) <= 1e-6
    assert rel(t.xbar_host, j.xbar_host) <= 1e-6
    assert rel(t.conv, j.conv) <= 1e-6
    np.testing.assert_array_equal(t.solved, j.solved)
    assert t.stream_stats()["storage"]["resampled_indices"] == \
        j.stream_stats()["storage"]["resampled_indices"] > 0


def test_chaos_certifies_with_gap_debit(farmer_corpus):
    """All four storage chaos modes: a certified stop whose CI carries
    the lost-mass debit; the healthy run's debit is exactly 0."""
    opts = _opts(PHIterLimit=25, stream_check_every=3, BM_h=2.0,
                 BM_hprime=0.4, BM_eps=60000.0, solver_eps=1e-5)
    healthy = StreamingPH(opts, ShardSource(farmer_corpus, depth=4),
                          module=farmer, device="cpu")
    healthy.stream_main(finalize=False)
    chaos = {"io_delay": 0.001, "io_error": 2, "shard_corrupt": [5],
             "shard_missing": 6}
    chaotic = StreamingPH(opts, _src("port", farmer_corpus, chaos, 2),
                          module=farmer, device="cpu")
    chaotic.stream_main(finalize=False)
    hc, cc = healthy.certified, chaotic.certified
    assert hc is not None and cc is not None
    assert hc["gap_debit"] == 0.0 and hc["quarantined_frac"] == 0.0
    assert cc["gap_debit"] > 0.0
    assert cc["quarantined_frac"] == pytest.approx(2 / 8)
    assert cc["CI"][1] == pytest.approx(
        chaotic.rule.ci_upper(cc["s"]) + cc["gap_debit"])
    st = chaotic.stream_stats()["storage"]
    assert st["shards_quarantined"] == 2 and st["read_retries"] >= 2
    assert st["resampled_indices"] > 0 and st["readahead_hit_rate"] > 0


def _check_crash_resume(farmer_corpus, tmp_path):
    """A crash after a checkpoint resumes through the storage cursor to
    the uninterrupted degraded run."""
    ck = os.fspath(tmp_path / "ck")
    a = StreamingPH(_opts(), _src("port", farmer_corpus), device="cpu")
    a.stream_main(finalize=False)
    b1 = StreamingPH(_opts(run_checkpoint=ck,
                           chaos={"crash_at_iter": 3}),
                     _src("port", farmer_corpus), device="cpu")
    with pytest.raises(ChaosError):
        b1.stream_main(finalize=False)
    b2 = StreamingPH(_opts(resume_from=ck), _src("port", farmer_corpus),
                     device="cpu")
    b2.stream_main(finalize=False)
    assert b2._shard_store().quarantined == {6}
    np.testing.assert_array_equal(a.W_host, b2.W_host)
    np.testing.assert_array_equal(a.xbar_host, b2.xbar_host)
    np.testing.assert_array_equal(a.solved, b2.solved)
    assert a.conv == b2.conv
    assert a.sampler.state() == b2.sampler.state()


# ---- the tests: five, each a few of the checks above ----------------------
# (a file of at most five tests is queued after the suite's heavy
# few-test files by pytest-xdist's loadfile scheduling, which orders
# files by their number of tests; it then runs beside them)

def test_corpora_cross_between_the_packages(corpora, tmp_path):
    for writer in ("jax", "port"):
        _check_cross_read(corpora, writer)
    _check_same_files(corpora)
    _check_uc_shared(tmp_path)
    _check_multistage_refused(tmp_path)


def test_every_read_validated_retried_and_read_ahead(farmer_corpus):
    _check_magic_and_truncation(farmer_corpus)
    _check_transient_io_error(farmer_corpus)
    _check_readahead(farmer_corpus)
    _check_flipped_byte(farmer_corpus)


def test_quarantine_budget_and_cursor_match_jax(farmer_corpus):
    _check_substitution(farmer_corpus)
    _check_budget(farmer_corpus)
    _check_cursor(farmer_corpus)


def test_streaming_ph_over_a_faulted_corpus(corpora, farmer_corpus,
                                            tmp_path):
    _check_faulted_parity(corpora)
    _check_crash_resume(farmer_corpus, tmp_path)
