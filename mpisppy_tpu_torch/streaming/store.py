"""ShardStore — the durable, checksummed on-disk scenario corpus (port
of `mpisppy_tpu/streaming/store.py`).

A corpus too big to generate per block (or whose generator lives
elsewhere) is persisted once as fixed-width shard files and streamed
back through `ShardSource` (readahead.py):

  * every shard file carries a header (shard_format version, model
    ident, seed range, dtype) and a CRC32 over the payload bytes;
    `read_checked` validates all of it on every read;
  * shard files and the manifest are written atomically
    (`resilience.checkpoint.atomic_write`);
  * transient read failures retry through the capped, jittered backoff
    of `RetryingSource` (`source.backoff_delay`);
  * a shard that fails past `max_shard_retries` is quarantined: its
    seed indices are resampled from healthy shards
    (`substitute_quarantined`) and the lost mass is debited into the
    certified interval (`ciutils.debit_quarantined_mass`, wired by
    StreamingPH).  Past `max_quarantined_frac` (default 1%) the store
    fails hard (`QuarantinedCorpusError`);
  * the storage cursor (quarantine set, counters, the retry RNG state)
    round-trips through `state()`/`restore()`, so a stream checkpoint
    replays quarantine substitutions after a crash.

The file format is the JAX package's, so a corpus written by either
package is read by the other (all integers little-endian):

    bytes 0..8      magic  b"MTSHARD1"
    bytes 8..12     uint32 header length H
    bytes 12..12+H  header JSON: shard_format, model, seed_lo,
                    seed_hi, num_scens, dtype, payload_len,
                    payload_crc32
    rest            payload: an .npz of the shard's ScenarioBatch
                    fields, with the JAX package's dtypes (int32 node
                    ids, nonant indices and SplitA coordinates)

Blocks read back are batches of CPU tensors (the stream moves them to
the card).  Two-stage corpora only, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import random
import struct
import time
import zlib

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..device import host
from ..resilience.checkpoint import atomic_write
from .source import backoff_delay

MAGIC = b"MTSHARD1"
SHARD_FORMAT = 1
CORPUS_FORMAT = 1
MANIFEST = "manifest.json"


class ShardStoreError(RuntimeError):
    """Base: the corpus (not a transient read) is unusable."""


class ShardIntegrityError(ShardStoreError):
    """A shard file failed header/CRC validation on read."""


class ShardQuarantinedError(ShardStoreError):
    """A shard exhausted its retry budget and was quarantined; callers
    (ShardSource) resample its indices from healthy shards."""

    def __init__(self, sid, last_error=None):
        super().__init__(
            f"shard {int(sid)} quarantined after retry exhaustion: "
            f"{last_error}")
        self.sid = int(sid)
        self.last_error = last_error


class QuarantinedCorpusError(ShardStoreError):
    """Quarantined mass exceeded max_quarantined_frac — the corpus is
    too degraded for the certificate to absorb; the run must fail
    loudly instead of resampling its way to a biased verdict.
    `non_retryable` tells RetryingSource to propagate it unchanged:
    retrying a terminal corpus failure only delays (and disguises)
    the hard fail."""

    non_retryable = True


# -- ScenarioBatch (de)serialization ---------------------------------------

def _batch_payload(batch):
    """Host numpy npz payload dict of one shard's ScenarioBatch, in the
    JAX package's key set and dtypes.  Optional fields are encoded by
    key presence; the A form (dense, shared (1, M, N) or SplitA) is kept
    as it is."""
    from ..ir import SplitA

    out = {}
    for k in ("c", "qdiag", "row_lo", "row_hi", "lb", "ub",
              "obj_const", "nonant_idx", "integer_mask"):
        v = getattr(batch, k)
        if v is not None:
            out[k] = host(v)
    out["nonant_idx"] = out["nonant_idx"].astype(np.int32)
    A = batch.A
    if isinstance(A, SplitA):
        out["A_shared"] = host(A.shared)
        out["A_rows"] = host(A.rows).astype(np.int32)
        out["A_cols"] = host(A.cols).astype(np.int32)
        out["A_vals"] = host(A.vals)
    else:
        out["A"] = host(A)
    t = batch.tree
    out["tree_node_of"] = host(t.node_of).astype(np.int32)
    out["tree_prob"] = host(t.prob)
    out["tree_num_nodes"] = np.int64(t.num_nodes)
    if t.stage_of is not None:
        out["tree_stage_of"] = np.asarray(t.stage_of)
    out["tree_nonant_names"] = np.array(list(t.nonant_names or ()),
                                        dtype=object)
    out["tree_scen_names"] = np.array(list(t.scen_names or ()),
                                      dtype=object)
    if batch.stage_cost_c is not None:
        out["stage_cost_c"] = host(batch.stage_cost_c)
    if batch.var_prob is not None:
        out["var_prob"] = host(batch.var_prob)
    out["var_names"] = np.array(list(batch.var_names or ()),
                                dtype=object)
    if batch.model_meta is not None:
        out["model_meta"] = np.array([batch.model_meta], dtype=object)
    return out


def _batch_from_payload(z):
    """Inverse of _batch_payload: an npz mapping -> ScenarioBatch of CPU
    tensors (node ids and nonant indices as int64, SplitA coordinates
    as int32, as the port's builders store them)."""
    from ..ir import ScenarioBatch, SplitA, TreeInfo

    def t(a, dtype=None):
        out = torch.from_numpy(np.array(a))
        return out if dtype is None else out.to(dtype)

    def opt(k):
        return t(z[k]) if k in z else None

    if "A_shared" in z:
        A = SplitA(shared=t(z["A_shared"]),
                   rows=t(z["A_rows"], torch.int32),
                   cols=t(z["A_cols"], torch.int32),
                   vals=t(z["A_vals"]))
    else:
        A = t(z["A"])
    tree = TreeInfo(
        node_of=t(z["tree_node_of"], torch.int64),
        prob=t(z["tree_prob"]),
        num_nodes=int(z["tree_num_nodes"]),
        stage_of=(tuple(np.asarray(z["tree_stage_of"]).tolist())
                  if "tree_stage_of" in z else None),
        nonant_names=tuple(np.asarray(z["tree_nonant_names"]).tolist()),
        scen_names=tuple(np.asarray(z["tree_scen_names"]).tolist()),
    )
    meta = (np.asarray(z["model_meta"], dtype=object)[0]
            if "model_meta" in z else None)
    return ScenarioBatch(
        c=t(z["c"]), qdiag=opt("qdiag"), A=A,
        row_lo=opt("row_lo"), row_hi=opt("row_hi"),
        lb=opt("lb"), ub=opt("ub"), obj_const=opt("obj_const"),
        nonant_idx=t(z["nonant_idx"], torch.int64),
        integer_mask=opt("integer_mask"), tree=tree,
        stage_cost_c=opt("stage_cost_c"), var_prob=opt("var_prob"),
        var_names=tuple(np.asarray(z["var_names"]).tolist()),
        model_meta=meta)


def concat_blocks(parts):
    """Concatenate per-shard sub-blocks (each a gather_block result) into
    one block with block-uniform probabilities.  Two-stage only; a
    SplitA's shared matrix (and a shared (1, M, N) A) comes from the
    first part, never replicated."""
    from ..ir import ScenarioBatch, SplitA, TreeInfo

    if len(parts) == 1:
        return parts[0]
    first = parts[0]
    if any(p.tree.num_nodes > 1 for p in parts):
        raise NotImplementedError(
            "shard corpora are two-stage only: cross-shard node "
            "identity for multistage trees is not defined")

    def cat(field, dim=0):
        vs = [getattr(p, field) for p in parts]
        if vs[0] is None:
            return None
        return torch.cat(vs, dim=dim)

    A0 = first.A
    if isinstance(A0, SplitA):
        A = dataclasses.replace(
            A0, vals=torch.cat([p.A.vals for p in parts], dim=0))
    elif A0.shape[0] == 1 and first.num_scens > 1:
        A = A0                                       # shared: one copy
    elif (A0.shape[0] == 1
          and all(p.A.shape[0] == 1 for p in parts)
          and sum(p.num_scens for p in parts) > 1):
        # each part is a single-scenario gather of a shared-A corpus
        A = A0
    else:
        A = torch.cat([p.A for p in parts], dim=0)
    B = sum(p.num_scens for p in parts)
    tree = TreeInfo(
        node_of=torch.cat([p.tree.node_of for p in parts], dim=0),
        prob=torch.from_numpy(np.full(B, 1.0 / B)).to(
            first.tree.prob.dtype),
        num_nodes=1,
        stage_of=first.tree.stage_of,
        nonant_names=first.tree.nonant_names,
        scen_names=tuple(n for p in parts
                         for n in (p.tree.scen_names or ())),
    )
    return ScenarioBatch(
        c=cat("c"), qdiag=cat("qdiag"), A=A,
        row_lo=cat("row_lo"), row_hi=cat("row_hi"),
        lb=cat("lb"), ub=cat("ub"), obj_const=cat("obj_const"),
        nonant_idx=first.nonant_idx,
        integer_mask=cat("integer_mask"), tree=tree,
        stage_cost_c=cat("stage_cost_c", dim=1),
        var_prob=cat("var_prob"),
        var_names=first.var_names, model_meta=first.model_meta)


# -- shard file encode/decode ----------------------------------------------

def _shard_name(sid):
    return f"shard-{int(sid):06d}.mts"


def _encode_shard(batch, model, lo, hi):
    """One shard's byte image: magic + header JSON + npz payload, with
    an honest CRC32 over the payload bytes stamped into the header."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **_batch_payload(batch))
    payload = buf.getvalue()
    header = json.dumps({
        "shard_format": SHARD_FORMAT,
        "model": str(model),
        "seed_lo": int(lo), "seed_hi": int(hi),
        "num_scens": int(batch.num_scens),
        "dtype": str(host(batch.c).dtype),
        "payload_len": len(payload),
        "payload_crc32": zlib.crc32(payload) & 0xFFFFFFFF,
    }).encode("utf-8")
    return MAGIC + struct.pack("<I", len(header)) + header + payload


def _decode_shard(data, *, expect_model=None, expect_range=None):
    """Parse + validate one shard byte image.  EVERY read goes through
    here (`ShardStore.read_checked`): magic, header JSON, payload
    length, CRC32 over payload bytes, and — when expectations are
    given — model ident and seed range.  Any mismatch raises
    ShardIntegrityError (never a partially-decoded batch)."""
    if len(data) < len(MAGIC) + 4 or data[:len(MAGIC)] != MAGIC:
        raise ShardIntegrityError("bad shard magic (torn or foreign file)")
    (hlen,) = struct.unpack("<I", data[len(MAGIC):len(MAGIC) + 4])
    hoff = len(MAGIC) + 4
    if hoff + hlen > len(data):
        raise ShardIntegrityError("truncated shard header")
    try:
        header = json.loads(data[hoff:hoff + hlen].decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ShardIntegrityError(f"unparseable shard header: {e}")
    if int(header.get("shard_format", -1)) != SHARD_FORMAT:
        raise ShardIntegrityError(
            f"unsupported shard_format {header.get('shard_format')!r}")
    payload = data[hoff + hlen:]
    if len(payload) != int(header["payload_len"]):
        raise ShardIntegrityError(
            f"payload length {len(payload)} != header "
            f"{header['payload_len']} (truncated shard)")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    if crc != int(header["payload_crc32"]):
        raise ShardIntegrityError(
            f"payload CRC mismatch: computed {crc:#010x}, header "
            f"{int(header['payload_crc32']):#010x}")
    if expect_model is not None and header["model"] != expect_model:
        raise ShardIntegrityError(
            f"shard model ident {header['model']!r} != corpus "
            f"{expect_model!r}")
    if expect_range is not None:
        lo, hi = expect_range
        if (int(header["seed_lo"]), int(header["seed_hi"])) != (lo, hi):
            raise ShardIntegrityError(
                f"shard seed range [{header['seed_lo']}, "
                f"{header['seed_hi']}) != expected [{lo}, {hi})")
    try:
        batch = _batch_from_payload(
            np.load(io.BytesIO(payload), allow_pickle=True))
    except Exception as e:
        raise ShardIntegrityError(
            f"undecodable shard payload (CRC passed): {e!r}")
    if batch.num_scens != int(header["num_scens"]):
        raise ShardIntegrityError(
            f"decoded {batch.num_scens} scenarios, header says "
            f"{header['num_scens']}")
    return header, batch


# -- the corpus exporter ---------------------------------------------------

def write_corpus(source, path, shard_width, model=None, meta=None):
    """Persist `source`'s full scenario universe under `path` as
    fixed-width shard files plus a manifest — every file written via
    the atomic tmp-rename discipline.  Shard j holds the contiguous
    seed range [j*w, min((j+1)*w, S)); blocks are pure functions of
    their index set, so the shards reproduce exactly what the source
    would generate.  Returns the corpus path."""
    S = int(source.total_scens)
    w = int(shard_width)
    if S <= 0 or w <= 0:
        raise ValueError("write_corpus needs total_scens > 0 and "
                         "shard_width > 0")
    model = str(model if model is not None else source.name)
    os.makedirs(path, exist_ok=True)
    n_shards = (S + w - 1) // w
    dtype = None
    names = []
    for j in range(n_shards):
        lo, hi = j * w, min((j + 1) * w, S)
        batch = source.block(np.arange(lo, hi, dtype=np.int64))
        if batch.tree.num_nodes > 1:
            raise NotImplementedError(
                "shard corpora are two-stage only (cross-shard node "
                "identity for multistage trees is not defined)")
        if dtype is None:
            dtype = str(host(batch.c).dtype)
        fname = _shard_name(j)
        atomic_write(os.path.join(path, fname),
                     _encode_shard(batch, model, lo, hi))
        names.append(fname)
    manifest = {
        "corpus_format": CORPUS_FORMAT,
        "model": model,
        "total_scens": S,
        "shard_width": w,
        "n_shards": n_shards,
        "dtype": dtype,
        "shards": names,
        "meta": dict(meta or {}),
    }
    atomic_write(os.path.join(path, MANIFEST),
                 json.dumps(manifest, indent=1).encode("utf-8"))
    return path


# -- the store -------------------------------------------------------------

class ShardStore:
    """Validated random access to one on-disk corpus, with per-shard
    retry, quarantine, and certified-gap accounting hooks.

    Thread-safety note: reads are issued by the readahead worker ONE
    AT A TIME (streaming/readahead.py), and `substitute_quarantined`
    runs on the stream worker — the quarantine set is only ever grown,
    and growth is published before the raising read returns, so the
    substitution pass that follows a quarantine always sees it."""

    def __init__(self, path, *, max_shard_retries=2, backoff=0.05,
                 backoff_cap=5.0, jitter=0.25, jitter_seed=None,
                 max_quarantined_frac=0.01, resample_seed=0,
                 chaos=None, telemetry=None):
        from ..resilience.chaos import ChaosInjector

        self.path = str(path)
        mpath = os.path.join(self.path, MANIFEST)
        try:
            with open(mpath, "rb") as f:
                m = json.loads(f.read().decode("utf-8"))
        except (OSError, ValueError) as e:
            raise ShardStoreError(
                f"unreadable corpus manifest {mpath}: {e!r}")
        if int(m.get("corpus_format", -1)) != CORPUS_FORMAT:
            raise ShardStoreError(
                f"unsupported corpus_format {m.get('corpus_format')!r}")
        self.manifest = m
        self.model = str(m["model"])
        self.total_scens = int(m["total_scens"])
        self.shard_width = int(m["shard_width"])
        self.n_shards = int(m["n_shards"])
        self.meta = dict(m.get("meta") or {})
        self._shard_files = list(m["shards"])

        self.max_shard_retries = int(max_shard_retries)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.jitter = float(jitter)
        self._retry_rng = random.Random(jitter_seed)
        self.max_quarantined_frac = float(max_quarantined_frac)
        self.resample_seed = int(resample_seed)
        # an injector is shared (counters visible to the owner); a
        # dict/None goes through from_options so the MPISPPY_TPU_CHAOS
        # env override applies here too
        self.chaos = (chaos if isinstance(chaos, ChaosInjector)
                      else ChaosInjector.from_options(chaos))

        self.quarantined = set()
        self.shards_read = 0
        self.read_retries = 0
        self.resampled = 0
        self._tel = (telemetry if telemetry is not None
                     else _telemetry.get())

    # -- geometry ---------------------------------------------------------
    def shard_of(self, i):
        return int(i) // self.shard_width

    def shard_range(self, sid):
        lo = int(sid) * self.shard_width
        return lo, min(lo + self.shard_width, self.total_scens)

    def shard_path(self, sid):
        return os.path.join(self.path, self._shard_files[int(sid)])

    # -- validated reads --------------------------------------------------
    def _read_once(self, sid):
        """One read ATTEMPT: chaos ticks, disk read, chaos byte-flip,
        full header+CRC validation."""
        if self.chaos is not None:
            self.chaos.shard_read_tick(sid)
        with open(self.shard_path(sid), "rb") as f:
            data = f.read()
        if self.chaos is not None:
            data = self.chaos.corrupt_shard_bytes(sid, data)
        _, batch = _decode_shard(data, expect_model=self.model,
                                 expect_range=self.shard_range(sid))
        return batch

    def read_checked(self, sid):
        """Read + validate shard `sid`, retrying transient failures
        through the capped seeded-jitter backoff.  Retry exhaustion
        quarantines the shard (which may hard-fail the corpus) and
        raises ShardQuarantinedError."""
        sid = int(sid)
        if sid in self.quarantined:
            raise ShardQuarantinedError(sid, "already quarantined")
        last = None
        for attempt in range(1, self.max_shard_retries + 2):
            try:
                batch = self._read_once(sid)
            except (ShardIntegrityError, OSError) as e:
                last = e
                if attempt > self.max_shard_retries:
                    break
                self.read_retries += 1
                if self._tel.enabled:
                    self._tel.registry.counter(
                        "store.read_retries").inc()
                time.sleep(backoff_delay(
                    attempt, self.backoff, self.backoff_cap,
                    self.jitter, self._retry_rng))
                continue
            self.shards_read += 1
            if self._tel.enabled:
                self._tel.registry.counter("store.shards_read").inc()
            return batch
        self.quarantine(sid, reason=repr(last))
        raise ShardQuarantinedError(sid, last)

    # -- quarantine + certified-gap accounting ----------------------------
    @property
    def quarantined_scens(self):
        return sum(self.shard_range(s)[1] - self.shard_range(s)[0]
                   for s in self.quarantined)

    @property
    def quarantined_frac(self):
        return self.quarantined_scens / max(self.total_scens, 1)

    def quarantine(self, sid, reason=""):
        """Mark shard `sid` permanently unreadable.  Its indices will
        be resampled from healthy shards; the lost mass feeds the CI
        debit.  HARD-FAILS (QuarantinedCorpusError) once the
        quarantined fraction exceeds max_quarantined_frac."""
        sid = int(sid)
        if sid in self.quarantined:
            return
        self.quarantined.add(sid)
        if self._tel.enabled:
            r = self._tel.registry
            r.counter("store.shards_quarantined").inc()
            r.gauge("store.quarantined_frac").set(self.quarantined_frac)
            self._tel.event("store.shard_quarantined", sid=sid,
                            reason=str(reason)[:200],
                            quarantined_frac=self.quarantined_frac)
        if self.quarantined_frac > self.max_quarantined_frac:
            raise QuarantinedCorpusError(
                f"quarantined mass {self.quarantined_frac:.4f} "
                f"({len(self.quarantined)}/{self.n_shards} shards) "
                f"exceeds max_quarantined_frac="
                f"{self.max_quarantined_frac}; the corpus is too "
                f"degraded for a certified verdict")

    def substitute_quarantined(self, indices, count=True):
        """Deterministically replace indices that fall in quarantined
        shards with fresh draws from healthy shards (probability
        renormalization happens downstream in gather/concat — blocks
        stay block-uniform).  A pure function of (index set,
        quarantine set, resample_seed): a resumed run with the
        restored quarantine set replays the SAME substitutions, which
        is what makes crash-resume bit-equal through storage faults.

        Substitutes are drawn below max(indices)+1 when possible so a
        sampler's active-prefix discipline is preserved.  `count=False`
        is the dry-run form for readahead hints: same answer, no
        resampled-counter side effects."""
        idx = np.asarray(indices, dtype=np.int64)
        if not self.quarantined:
            return idx
        bad = np.isin(idx // self.shard_width,
                      np.fromiter(self.quarantined, dtype=np.int64))
        if not bad.any():
            return idx
        limit = int(idx.max()) + 1
        healthy = [s for s in range(self.n_shards)
                   if s not in self.quarantined]
        if not healthy:
            raise QuarantinedCorpusError(
                "every shard of the corpus is quarantined")
        seed = np.random.SeedSequence([
            zlib.crc32(idx.tobytes()) & 0xFFFFFFFF,
            zlib.crc32(json.dumps(sorted(self.quarantined))
                       .encode()) & 0xFFFFFFFF,
            self.resample_seed & 0xFFFFFFFF,
        ])
        rng = np.random.Generator(np.random.PCG64(seed))
        pool = np.concatenate([np.arange(*self.shard_range(s))
                               for s in healthy])
        in_prefix = pool[pool < limit]
        if in_prefix.size:
            pool = in_prefix
        # prefer DISTINCT substitutes (avail shrinks as draws land);
        # once the healthy pool is exhausted — e.g. the block spans
        # the whole corpus — fall back to with-replacement draws: the
        # block keeps its shape and the quarantine CI debit covers
        # the induced duplication bias
        avail = np.setdiff1d(pool, idx[~bad])
        out = idx.copy()
        for pos in np.flatnonzero(bad):
            if avail.size:
                k = int(rng.integers(avail.size))
                out[pos] = avail[k]
                avail = np.delete(avail, k)
            else:
                out[pos] = pool[int(rng.integers(pool.size))]
        out.sort()
        if count:
            n = int(bad.sum())
            self.resampled += n
            if self._tel.enabled:
                self._tel.registry.counter(
                    "store.resampled_indices").inc(n)
        return out

    # -- storage cursor (stream-checkpoint round-trip) --------------------
    def state(self):
        """JSON-serializable storage cursor: the quarantine set (what
        substitution determinism depends on), the retry-jitter RNG
        state, and the read/retry/resample counters."""
        st = self._retry_rng.getstate()
        return {
            "quarantined": sorted(int(s) for s in self.quarantined),
            "shards_read": int(self.shards_read),
            "read_retries": int(self.read_retries),
            "resampled": int(self.resampled),
            "resample_seed": int(self.resample_seed),
            "retry_rng": [st[0], list(st[1]), st[2]],
        }

    def restore(self, state):
        self.quarantined = {int(s) for s in state["quarantined"]}
        self.shards_read = int(state["shards_read"])
        self.read_retries = int(state["read_retries"])
        self.resampled = int(state["resampled"])
        self.resample_seed = int(state.get("resample_seed",
                                           self.resample_seed))
        rr = state.get("retry_rng")
        if rr:
            self._retry_rng.setstate((rr[0], tuple(rr[1]), rr[2]))
        if self._tel.enabled:
            self._tel.registry.gauge(
                "store.quarantined_frac").set(self.quarantined_frac)

    def stats(self):
        return {
            "shards_read": int(self.shards_read),
            "read_retries": int(self.read_retries),
            "shards_quarantined": len(self.quarantined),
            "quarantined_shards": sorted(int(s)
                                         for s in self.quarantined),
            "quarantined_frac": float(self.quarantined_frac),
            "resampled_indices": int(self.resampled),
        }
