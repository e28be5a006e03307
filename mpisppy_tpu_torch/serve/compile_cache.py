"""Shape-bucketed solver cache for the serve layer (port of
`mpisppy_tpu/serve/compile_cache.py`).

Requests are assigned to a BUCKET — the tuple of everything that
decides how a group of them runs: model identity (name, or the static
var/nonant names), scenario count, stage dims, constraint operator kind
and (for a split operator) its delta pattern, dtype, device, the solver
config, and the prep structure.  Two requests in one bucket differ only
in ARRAY VALUES (scenario data, rho, bounds, tolerance), so a group of
them runs as one group solve: one PDHG solve over all their scenarios,
whose chunks are ONE kernel launch for the whole group
(`phbase.group_superstep`; the chunk kernel's grouped form reads each
request's own matrix).  The split form's delta coordinates are in the
key because the kernel reads one (rows, cols) for the whole group.

Per bucket this module holds:
  * the canonical `PDHGSolver` (built once via `from_options`);
  * per group width B, the group's PLAN: its operator form and shape
    and, on the card, the kernel variant the picker chose there
    (`ops.pdhg_chunk.card_variant`, from the card's occupancy queries)
    and the kernel library it ran.  PyTorch has no traced executable
    to persist, so this plan is the artifact.  The picker stays the
    one owner of the variant: a loaded plan is checked against it,
    never handed to it.

Artifacts on disk
-----------------
When `MPISPPY_TPU_COMPILE_CACHE_DIR` is set, each plan is written to
`$MPISPPY_TPU_COMPILE_CACHE_DIR/aot/<fingerprint>.mtaot`, under a
fingerprint covering the full `bucket_key` PLUS the width, the torch
and CUDA versions, the device's name and the kernel library's name
(which carries the hash of its source and flags).  The byte image is
the JAX package's: magic + header JSON + payload CRC32, checked on
every load; ANY mismatch — a torn file, a foreign fingerprint (an
artifact the JAX package wrote, say), version skew — falls back to
computing the plan, counted in `cache.aot_load_failures`.  Loads count
`cache.aot_loads`, saves `cache.aot_saves`.  `prewarm()` loads the
whole directory once at boot (process replicas call it) and, on the
card, loads the kernel library the plans name and checks that it is
the one built and that the picker still chooses each plan's variant
(which leaves the picker's answers cached for the first group).

The cache also counts `serve.compile_cache.{hit,miss}` per REQUEST.
No CUDA graphs and no `torch.compile` here: a bucket's group runs the
solver's own host loop.

This module imports no torch at module level (the router reads
`merged_stats_dicts` from it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import threading
import time
import zlib

from .. import global_toc
from .. import telemetry as _telemetry

AOT_MAGIC = b"MTAOTX1\0"
AOT_FORMAT = 1
_AOT_SUFFIX = ".mtaot"
#: the payload kind this package writes (the JAX package's payload is
#: a serialized program; either package rejects the other's)
PLAN_KIND = "torch_group_plan"


def width_bucket(n, floor=1):
    """Next power-of-two >= max(n, floor): the width-bucketing rule of
    the serve layer's coalescing and of `ops.pdhg.solve_compacted`."""
    n = max(int(n), int(floor), 1)
    return 1 << (n - 1).bit_length()


def solver_config(options):
    """The bucket's solver-config component: `PDHGSolver.config_key`
    of the solver `from_options` would build."""
    from ..ops.pdhg import PDHGSolver
    return PDHGSolver.from_options(options).config_key()


def _digest(*arrays):
    h = hashlib.sha1()
    for a in arrays:
        h.update(repr((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def delta_pattern(batch, options=None):
    """The coordinates of a split operator's per-scenario deltas (the
    split-native A's, or the declared `A_delta_idx` that the delta-split
    prep uses), as a short digest; None when the prep is not split."""
    import numpy as np

    from ..device import host
    from ..ir import delta_idx
    if batch.split_A:
        return _digest(host(batch.A.rows).astype(np.int32),
                       host(batch.A.cols).astype(np.int32))
    d = delta_idx(batch)
    if d is None or batch.shared_A \
            or (options or {}).get("no_split_prep"):
        return None
    return _digest(np.asarray(d[0], np.int32), np.asarray(d[1], np.int32))


def bucket_key(batch, options=None, model=None, backend=None):
    """Shape-bucket key for one request.

    `model` defaults to the batch's static var/nonant names — a
    structural fingerprint that separates models which happen to share
    shapes; pass an explicit model name to pin it symbolically.
    `backend` is the device type the service runs on (default: the
    batch's)."""
    if backend is None:
        backend = batch.c.device.type
    ident = model if model is not None else (
        batch.var_names, batch.tree.nonant_names)
    akind = ("split" if batch.split_A
             else "shared" if batch.shared_A else "dense")
    return (
        ident,
        int(batch.num_scens),
        int(batch.num_vars),
        int(batch.num_rows),
        int(batch.num_nonants),
        int(batch.tree.num_nodes),
        akind,
        str(batch.c.dtype).replace("torch.", ""),
        str(backend),
        solver_config(options),
        # prep STRUCTURE flag: split-vs-dense preps group differently
        bool((options or {}).get("no_split_prep", False)),
        delta_pattern(batch, options),
    )


# -- the disk layer --------------------------------------------------------

def aot_cache_dir():
    """The on-disk artifact directory, or None when persistence is off
    (`MPISPPY_TPU_COMPILE_CACHE_DIR` unset/empty)."""
    root = os.environ.get("MPISPPY_TPU_COMPILE_CACHE_DIR")
    if not root:
        return None
    return os.path.join(root, "aot")


def _environment(device):
    """What can change a plan between processes: torch and CUDA
    versions, the device's name and the kernel library built from this
    checkout."""
    import torch

    from ..ops import pdhg_chunk
    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": name,
            "kernel_library": pdhg_chunk.library_path().name}


def aot_fingerprint(key, B, device):
    """sha256 over the full bucket key, the width and `_environment`:
    a mismatch means "compute, don't load"."""
    ident = (repr(key), int(B), sorted(_environment(device).items()))
    return hashlib.sha256(repr(ident).encode("utf-8")).hexdigest()


def _aot_encode(fingerprint, B, payload, device):
    """One artifact's byte image: magic + header JSON + payload,
    CRC-stamped like an MTSHARD1 shard."""
    env = _environment(device)
    header = {
        "aot_format": AOT_FORMAT,
        "fingerprint": fingerprint,
        "batch_width": int(B),
        "kind": PLAN_KIND,
        "torch_version": env["torch"],
        "device": env["device"],
        "payload_len": len(payload),
        "payload_crc32": zlib.crc32(payload) & 0xFFFFFFFF,
    }
    hjson = json.dumps(header, sort_keys=True).encode("utf-8")
    return AOT_MAGIC + struct.pack("<I", len(hjson)) + hjson + payload


def _aot_decode(data, fingerprint):
    """Validate + strip one artifact; raises ValueError on ANY mismatch
    (torn, foreign, corrupt, fingerprint/format skew)."""
    if len(data) < len(AOT_MAGIC) + 4:
        raise ValueError("truncated AOT file")
    if data[:len(AOT_MAGIC)] != AOT_MAGIC:
        raise ValueError("bad AOT magic")
    (hlen,) = struct.unpack(
        "<I", data[len(AOT_MAGIC):len(AOT_MAGIC) + 4])
    hstart = len(AOT_MAGIC) + 4
    if hstart + hlen > len(data):
        raise ValueError("truncated AOT header")
    header = json.loads(data[hstart:hstart + hlen].decode("utf-8"))
    if int(header.get("aot_format", -1)) != AOT_FORMAT:
        raise ValueError(f"AOT format {header.get('aot_format')!r}")
    if header.get("fingerprint") != fingerprint:
        raise ValueError("AOT fingerprint mismatch")
    payload = data[hstart + hlen:]
    if len(payload) != int(header.get("payload_len", -1)):
        raise ValueError("AOT payload length mismatch")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    if crc != int(header.get("payload_crc32", -1)):
        raise ValueError("AOT payload CRC mismatch")
    return payload


def _plan_from_payload(payload):
    """A plan dict from an artifact's payload; raises ValueError unless
    it is this package's plan (the JAX package's payload is a
    serialized program)."""
    try:
        plan = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise ValueError(f"not a plan payload: {exc}") from exc
    if not isinstance(plan, dict) or plan.get("kind") != PLAN_KIND:
        raise ValueError("not a plan payload")
    return plan


def _check_on_card(plan):
    """Raise ValueError unless a plan's kernel variant is the one the
    card's picker chooses at its shapes from the kernel library built
    here (a plan without a variant is not checked)."""
    v = plan.get("variant")
    if not v:
        return
    import torch

    from ..ops import pdhg_chunk
    if plan.get("kernel_library") != pdhg_chunk.library_path().name:
        raise ValueError("plan names another kernel library")
    if pdhg_chunk.smem_optin() <= 0:
        raise ValueError("kernel library does not answer")
    S, M, N = (int(d) for d in plan["shape"])
    pick = pdhg_chunk.card_variant(S, M, N, getattr(torch, plan["a_dtype"]))
    if dataclasses.asdict(pick) != v:
        raise ValueError("the picker now chooses another variant")


# A process replica boots, calls `prewarm()`, and every artifact in the
# shared aot/ dir is loaded ONCE into this fingerprint-keyed resident
# set; `_aot_load` consults it before touching the disk.  Keyed by full
# fingerprint, so a stale entry can never satisfy a lookup it
# shouldn't.
_PREWARM_LOCK = threading.Lock()
_PREWARMED = {}                        # fingerprint -> plan dict


def prewarm(directory=None, device=None):
    """Load the full artifact set into the resident prewarm registry.
    On a CUDA `device`, a plan that names this checkout's kernel library
    loads it (the library the parent built) and checks that it answers
    and that the picker chooses the plan's variant (`_check_on_card`);
    a plan naming another library or variant counts a load failure.  `directory` defaults to
    `aot_cache_dir()` (None → no-op, returns 0).  Undecodable or foreign
    files are skipped and counted in `cache.aot_load_failures`.  Returns
    the number of artifacts resident after the sweep."""
    d = directory if directory is not None else aot_cache_dir()
    if not d or not os.path.isdir(d):
        return 0
    tel = _telemetry.get()
    cuda = device is not None and str(device).startswith("cuda")
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(_AOT_SUFFIX):
            continue
        fp = fname[:-len(_AOT_SUFFIX)]
        with _PREWARM_LOCK:
            if fp in _PREWARMED:
                continue
        try:
            with open(os.path.join(d, fname), "rb") as f:
                plan = _plan_from_payload(_aot_decode(f.read(), fp))
            if cuda:
                _check_on_card(plan)
        except Exception as exc:
            tel.counter("cache.aot_load_failures").inc()
            global_toc(f"WARNING: prewarm rejected {fname}: {exc}")
            continue
        with _PREWARM_LOCK:
            _PREWARMED[fp] = plan
    with _PREWARM_LOCK:
        return len(_PREWARMED)


def clear_prewarmed():
    """Drop the resident prewarm registry (tests)."""
    with _PREWARM_LOCK:
        _PREWARMED.clear()


def prune_aot_dir(max_age_s=None, max_total_bytes=None, directory=None):
    """Bound the on-disk aot/ artifact set: evict entries older than
    `max_age_s` (by mtime), then oldest-first until the directory is
    under `max_total_bytes`.  Both limits None → no-op.  Evictions
    count in `cache.aot_evictions`; returns the number removed.
    Concurrent writers are fine — a racing delete is just skipped."""
    d = directory if directory is not None else aot_cache_dir()
    if not d or not os.path.isdir(d):
        return 0
    if max_age_s is None and max_total_bytes is None:
        return 0
    entries = []
    for fname in os.listdir(d):
        if not fname.endswith(_AOT_SUFFIX):
            continue
        path = os.path.join(d, fname)
        try:
            st = os.stat(path)
        except OSError:
            continue
        entries.append((st.st_mtime, st.st_size, path))
    entries.sort()                      # oldest first
    now = time.time()
    doomed = []
    if max_age_s is not None:
        cutoff = now - float(max_age_s)
        doomed = [e for e in entries if e[0] < cutoff]
        entries = [e for e in entries if e[0] >= cutoff]
    if max_total_bytes is not None:
        total = sum(e[1] for e in entries)
        while entries and total > int(max_total_bytes):
            e = entries.pop(0)
            doomed.append(e)
            total -= e[1]
    tel = _telemetry.get()
    removed = 0
    for _, _, path in doomed:
        try:
            os.remove(path)
        except OSError:
            continue
        removed += 1
        tel.counter("cache.aot_evictions").inc()
    if removed:
        global_toc(f"AOT cache pruned: {removed} artifact(s) evicted")
    return removed


def group_plan(solver, group):
    """The plan of a group (`phbase.GroupArgs`): its operator form and
    shape, and on the card the kernel variant the picker chooses there
    when the chunks take the kernel (the route rule of
    `ops.pdhg._solve_impl`)."""
    from ..ops import pdhg_chunk
    from ..ops.pdhg import _cast_A
    A = group.prep.A
    dt = group.batch.c.dtype
    hot = solver._hot_pair(dt)
    if hot is not None:
        A = _cast_A(A, hot[0])
    S, M, N = A.shape
    form = pdhg_chunk.operator_form(A, S)
    cuda = A.device.type == "cuda"
    optin = (pdhg_chunk.smem_optin() if cuda
             else pdhg_chunk.H100_SMEM_OPTIN)
    route = pdhg_chunk.pick_route(form, M, N, A.dtype, optin)
    plan = {"kind": PLAN_KIND, "form": form,
            "shape": [int(S), int(M), int(N)],
            "a_dtype": str(A.dtype).replace("torch.", ""),
            "variant": None,
            "kernel_library": pdhg_chunk.library_path().name}
    if cuda and route == "kernel":
        plan["variant"] = dataclasses.asdict(
            pdhg_chunk.card_variant(S, M, N, A.dtype))
    return plan


class _GroupRunner:
    """One width's runner: `phbase.group_superstep` under the bucket's
    solver.  Callable with the group's `GroupArgs`; returns the group's
    next PHState."""

    def __init__(self, solver, plan):
        self.solver = solver
        self.plan = plan

    def __call__(self, group):
        from ..phbase import group_superstep
        return group_superstep(self.solver, group)


class CompiledBucket:
    """One bucket's solver and its per-width plans (see module
    docstring).  Driven only from the service's dispatch thread."""

    def __init__(self, key, options, owner=None, device="cpu"):
        from ..ops.pdhg import PDHGSolver
        self.key = key
        self.solver = PDHGSolver.from_options(options)
        self.device = str(device)
        self._batched = {}            # B -> _GroupRunner
        self._lock = threading.Lock()
        self._owner = owner
        self.aot_compiles = 0

    def _aot_account(self, what):
        tel = self._owner._tel if self._owner is not None \
            else _telemetry.get()
        tel.counter(f"cache.{what}").inc()
        if self._owner is not None:
            with self._owner._lock:
                setattr(self._owner, what,
                        getattr(self._owner, what) + 1)

    def _aot_load(self, path, fingerprint):
        """A persisted plan, or None (counted) when the file is absent,
        torn, corrupt, foreign or fingerprint-skewed, or on the card
        fails `_check_on_card` — the silent fallback.  A boot-time `prewarm()` hit skips the disk."""
        with _PREWARM_LOCK:
            plan = _PREWARMED.get(fingerprint)
        if plan is not None:
            self._aot_account("aot_prewarm_hits")
            self._aot_account("aot_loads")
            return plan
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                plan = _plan_from_payload(_aot_decode(f.read(),
                                                      fingerprint))
            if self.device.startswith("cuda"):
                _check_on_card(plan)
        except Exception as exc:
            self._aot_account("aot_load_failures")
            global_toc("WARNING: AOT cache entry rejected "
                       f"({os.path.basename(path)}): {exc}")
            return None
        self._aot_account("aot_loads")
        return plan

    def _aot_save(self, path, fingerprint, B, plan):
        from ..resilience.checkpoint import atomic_write
        try:
            data = _aot_encode(fingerprint, B,
                               json.dumps(plan, sort_keys=True).encode(),
                               self.device)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            atomic_write(path, data)
        except Exception as exc:       # pragma: no cover - disk full &c
            global_toc(f"WARNING: AOT cache write failed: {exc}")
            return
        self._aot_account("aot_saves")

    def batched_superstep(self, group):
        """The runner of a group of width B (`group`: its
        `phbase.GroupArgs`), with the width's plan loaded from the disk
        layer when a matching artifact exists, computed (once per
        width) and persisted otherwise."""
        B = int(group.B)
        with self._lock:
            runner = self._batched.get(B)
        if runner is not None:
            return runner
        runner = _GroupRunner(self.solver, self._plan(B, group))
        with self._lock:
            if B not in self._batched:
                self._batched[B] = runner
                self.aot_compiles += 1
        return self._batched[B]

    def _plan(self, B, group):
        d = aot_cache_dir()
        path = fp = None
        if d is not None:
            fp = aot_fingerprint(self.key, B, self.device)
            path = os.path.join(d, fp + _AOT_SUFFIX)
            plan = self._aot_load(path, fp)
            if plan is not None:
                return plan
        plan = group_plan(self.solver, group)
        if path is not None:
            self._aot_save(path, fp, B, plan)
        return plan


class CompileCache:
    """Bucket table + per-request hit/miss accounting + the disk
    layer's load/save/failure counts."""

    def __init__(self, tel=None, device="cpu"):
        self._tel = tel if tel is not None else _telemetry.get()
        self.device = str(device)
        self._buckets = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.aot_loads = 0
        self.aot_load_failures = 0
        self.aot_saves = 0
        self.aot_export_failures = 0
        self.aot_prewarm_hits = 0

    def get(self, batch, options=None, model=None, backend=None):
        """The CompiledBucket for one request (building it on first
        sight of the bucket).  Counts one hit or miss per call — call
        it once per request, not once per dispatch group."""
        key = bucket_key(batch, options, model=model,
                         backend=backend or self.device.split(":")[0])
        with self._lock:
            entry = self._buckets.get(key)
            if entry is None:
                entry = CompiledBucket(key, options, owner=self,
                                       device=self.device)
                self._buckets[key] = entry
                self.misses += 1
                self._tel.counter("serve.compile_cache.miss").inc()
            else:
                self.hits += 1
                self._tel.counter("serve.compile_cache.hit").inc()
        return entry

    def stats(self):
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "buckets": len(self._buckets),
                    "aot_loads": self.aot_loads,
                    "aot_load_failures": self.aot_load_failures,
                    "aot_saves": self.aot_saves,
                    "aot_export_failures": self.aot_export_failures,
                    "aot_prewarm_hits": self.aot_prewarm_hits}


_MERGE_KEYS = ("hits", "misses", "buckets", "aot_loads",
               "aot_load_failures", "aot_saves",
               "aot_export_failures", "aot_prewarm_hits")


def merged_stats_dicts(stat_dicts):
    """Aggregate already-materialized `CompileCache.stats()` dicts —
    the form process replicas report over the wire."""
    out = {k: 0 for k in _MERGE_KEYS}
    out["caches"] = 0
    for s in stat_dicts:
        if not s:
            continue
        for k in _MERGE_KEYS:
            out[k] += int(s.get(k, 0))
        out["caches"] += 1
    return out


def merged_stats(caches):
    """Aggregate `CompileCache.stats()` across a replica set (each
    replica owns its own cache handle): `buckets` sums the per-cache
    bucket counts, so one shape served by two replicas counts twice —
    the price of the fault-isolation split, which the disk layer
    refunds (the second replica loads what the first worked out)."""
    return merged_stats_dicts(c.stats() for c in caches)
