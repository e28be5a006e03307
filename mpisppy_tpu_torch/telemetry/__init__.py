"""Telemetry of the port: structured tracing, metrics and trace export
(port of `mpisppy_tpu/telemetry/`).

Three layers:

  * `tracer`: span() tracing over CLOCK_MONOTONIC into a bounded ring
    buffer, exported as Chrome/Perfetto trace-event JSON with one
    process row per hub and spoke (export.chrome_events /
    merge_traces);
  * `metrics`: counters, gauges, seconds histograms and a bounded
    event log, snapshotted to JSONL and optionally Prometheus text;
  * this facade: ONE process-global `Telemetry` handle configured from
    `options["telemetry"]` or the MPISPPY_TPU_TELEMETRY environment
    variable (the variable wins), held by every instrumented object
    (`SPOpt._tel`, `SPCommunicator.telemetry`).

Zero cost when off: a disabled handle exposes the shared NullTracer and
null instruments, so hot paths hold real references and the off path
costs an attribute read and a false branch: no allocation and no
device sync.  This package is standard library only; it imports
neither torch nor jax (tests/test_torch_telemetry.py checks it).

Config forms accepted (options value or environment variable):
    None / False / "0"|"off"|"false"      disabled (default)
    True / "1"|"on"|"true"                enabled, no files written
    "<dir>"                               enabled, artifacts under dir
    {"enabled": ..., "dir": ..., "phase_timing": ...,
     "capacity": ..., "prometheus": ..., "main_label": ...}   full form
"""

from __future__ import annotations

import json
import os

from . import export
from .metrics import MetricsRegistry
from .tracer import NULL_SPAN, NULL_TRACER, Tracer  # noqa: F401

ENV_VAR = "MPISPPY_TPU_TELEMETRY"

_DEFAULTS = {
    "enabled": False,
    "dir": None,
    # phase_timing: time the superstep's four phases one by one, with a
    # device sync after each (phbase._superstep_phased)
    "phase_timing": True,
    "capacity": 65536,
    "prometheus": False,
    "main_label": "hub",
}

_FALSY = ("", "0", "off", "false", "no")
_TRUTHY = ("1", "on", "true", "yes")


def _norm(config):
    """Any accepted config form -> partial dict (or None for 'unset')."""
    if config is None:
        return None
    if isinstance(config, bool):
        return {"enabled": config}
    if isinstance(config, str):
        s = config.strip()
        if s.lower() in _FALSY:
            return {"enabled": False}
        if s.startswith("{"):
            try:
                d = json.loads(s)
            except ValueError:
                return {"enabled": True}
            return dict(d, enabled=d.get("enabled", True))
        if s.lower() in _TRUTHY:
            return {"enabled": True}
        return {"enabled": True, "dir": s}
    d = dict(config)
    d.setdefault("enabled", True)
    return d


def _effective(config):
    """defaults <- caller config <- environment variable (the variable
    wins)."""
    cfg = dict(_DEFAULTS)
    c = _norm(config)
    if c:
        cfg.update(c)
    env = _norm(os.environ.get(ENV_VAR))
    if env:
        cfg.update(env)
    return cfg


class Telemetry:
    """One configured telemetry instance: a tracer + a registry."""

    def __init__(self, config=None):
        self.config = _effective(config)
        self.enabled = bool(self.config["enabled"])
        self.phase_timing = self.enabled and bool(
            self.config["phase_timing"])
        self.out_dir = self.config.get("dir")
        if self.enabled:
            self.tracer = Tracer(
                capacity=self.config["capacity"],
                main_label=self.config.get("main_label", "hub"))
            self.registry = MetricsRegistry(enabled=True)
        else:
            self.tracer = NULL_TRACER
            self.registry = MetricsRegistry(enabled=False)

    # -- hot-path API -----------------------------------------------------
    def span(self, name, track=None, **args):
        if not self.enabled:
            return NULL_SPAN
        return self.tracer.span(name, track=track, args=args or None)

    def event(self, name, track=None, **args):
        """Instant trace event + entry in the registry event log."""
        if self.enabled:
            self.tracer.instant(name, track=track, args=args or None)
            self.registry.event(name, **args)

    def counter(self, name):
        return self.registry.counter(name)

    def gauge(self, name):
        return self.registry.gauge(name)

    def histogram(self, name):
        return self.registry.histogram(name)

    # -- export -----------------------------------------------------------
    def write_trace(self, path):
        return export.write_trace(path, export.chrome_events(self.tracer))

    def write_metrics(self, path):
        return self.registry.write_jsonl(path)

    def flush(self, out_dir=None, extra_trace_files=()):
        """Write trace.json (merged with any per-spoke-process files),
        metrics.jsonl, and (if configured) prometheus.txt under
        out_dir (default: the configured dir).  Returns the trace path
        or None when disabled / no dir."""
        d = out_dir or self.out_dir
        if not (self.enabled and d):
            return None
        os.makedirs(d, exist_ok=True)
        trace = export.merge_traces(
            os.path.join(d, "trace.json"),
            event_lists=[export.chrome_events(self.tracer)],
            trace_files=extra_trace_files)
        self.registry.write_jsonl(os.path.join(d, "metrics.jsonl"))
        if self.config.get("prometheus"):
            self.registry.write_prometheus(
                os.path.join(d, "prometheus.txt"))
        return trace


_active: Telemetry | None = None


def get() -> Telemetry:
    """The process-global handle (lazily built from the env var alone
    the first time; disabled unless MPISPPY_TPU_TELEMETRY enables it)."""
    global _active
    if _active is None:
        _active = Telemetry(None)
    return _active


def configure(config=None) -> Telemetry:
    """Install a fresh global Telemetry from `config` (+env overlay)."""
    global _active
    _active = Telemetry(config)
    return _active


def configure_from_options(config) -> Telemetry:
    """Install telemetry from an options-dict value.  None leaves the
    active instance untouched (the env var may still have enabled it);
    an identical effective config is idempotent: the wheel builds
    several optimizers from copies of one options dict and they must
    share one registry and tracer, not reset each other."""
    if config is None:
        return get()
    cand = _effective(config)
    if _active is not None and _active.config == cand:
        return _active
    return configure(config)


def reset():
    """Drop the global instance (tests)."""
    global _active
    _active = None


def traffic_counters(registry=None):
    """Window-traffic counter dict for bench JSON (zeros when the run
    had telemetry off — keys are stable either way)."""
    reg = registry if registry is not None else get().registry
    names = ("window.writes", "window.reads", "window.stale_reads",
             "window.kill_signals", "window.bound_rejects")
    vals = ({k: c.value for k, c in reg._counters.items()}
            if reg.enabled else {})
    return {n.replace(".", "_"): int(vals.get(n, 0)) for n in names}


def pdhg_counters(registry=None):
    """Inner-solver adaptive-work counters for bench JSON (zeros when
    the run had telemetry off — keys are stable either way)."""
    reg = registry if registry is not None else get().registry
    names = ("pdhg.inner_iters_total", "pdhg.restarts_total",
             "pdhg.flops_saved", "pdhg.promotions",
             "pdhg.sparse_matvecs")
    vals = ({k: c.value for k, c in reg._counters.items()}
            if reg.enabled else {})
    out = {n.replace(".", "_"): int(vals.get(n, 0)) for n in names}
    g = (reg._gauges.get("pdhg.active_fraction")
         if reg.enabled else None)
    out["pdhg_active_fraction"] = float(g.value) if g is not None else 0.0
    return out


def stream_counters(registry=None):
    """Streaming-layer counter dict for bench JSON (zeros when the run
    had telemetry off — keys are stable either way): blocks loaded,
    scenarios streamed through the host->device pipe, sample growth
    events, the active-sample-size gauge, and the total seconds the
    consumer spent blocked on prefetch (the double-buffering
    effectiveness signal — near-zero means block i+1 loads fully
    overlap block i's solve)."""
    reg = registry if registry is not None else get().registry
    names = ("stream.blocks_loaded", "stream.scenarios_streamed",
             "stream.sample_growth_events", "stream.supersteps",
             "stream.source_retries", "stream.source_giveups")
    vals = ({k: c.value for k, c in reg._counters.items()}
            if reg.enabled else {})
    out = {n.replace(".", "_"): int(vals.get(n, 0)) for n in names}
    g = (reg._gauges.get("stream.active_sample_size")
         if reg.enabled else None)
    out["stream_active_sample_size"] = (
        int(g.value) if g is not None else 0)
    h = (reg._histograms.get("stream.prefetch_wait_seconds")
         if reg.enabled else None)
    out["stream_prefetch_wait_seconds"] = (
        float(h.total) if h is not None else 0.0)
    return out


def storage_counters(registry=None):
    """Shard-store counter dict for bench JSON (zeros when the run had
    telemetry off — keys are stable either way): shards read/
    quarantined, read retries, resampled indices, readahead hit/miss
    traffic, plus the quarantined-mass and hit-rate gauges and the
    total seconds the reader spent blocked on shard loads
    (store.read_wait_seconds — ~0 when the readahead fully overlaps
    gathers and solves)."""
    reg = registry if registry is not None else get().registry
    names = ("store.shards_read", "store.read_retries",
             "store.shards_quarantined", "store.resampled_indices",
             "store.readahead_hits", "store.readahead_misses")
    vals = ({k: c.value for k, c in reg._counters.items()}
            if reg.enabled else {})
    out = {n.replace(".", "_"): int(vals.get(n, 0)) for n in names}
    for gname in ("store.quarantined_frac", "store.readahead_hit_rate"):
        g = reg._gauges.get(gname) if reg.enabled else None
        out[gname.replace(".", "_")] = (
            float(g.value) if g is not None else 0.0)
    h = (reg._histograms.get("store.read_wait_seconds")
         if reg.enabled else None)
    out["store_read_wait_seconds"] = (
        float(h.total) if h is not None else 0.0)
    return out


def wheel_counters(registry=None):
    """MPMD-wheel exchange/supervision counters for bench JSON (zeros
    when the run had telemetry off — keys are stable either way).
    Distinct from resilience.wheel_counters (which reads a hub's
    supervisor attributes): this reads the wheel.* instruments — the
    device-exchange traffic (bytes/writes/latency), window-level stale
    reads, slice restart/prune counts, the slice-count gauge, and the
    per-slice bound-progression gauges keyed by trace track."""
    reg = registry if registry is not None else get().registry
    names = ("wheel.exchange_writes", "wheel.exchange_bytes",
             "wheel.collective_exchanges", "wheel.stale_reads",
             "wheel.slice_restarts", "wheel.slices_failed",
             "wheel.reslice_events", "wheel.corrupt_reads",
             "wheel.devices_reclaimed")
    vals = ({k: c.value for k, c in reg._counters.items()}
            if reg.enabled else {})
    out = {n.replace(".", "_"): int(vals.get(n, 0)) for n in names}
    g = reg._gauges.get("wheel.n_slices") if reg.enabled else None
    out["wheel_n_slices"] = int(g.value) if g is not None else 0
    h = (reg._histograms.get("wheel.exchange_seconds")
         if reg.enabled else None)
    out["wheel_exchange_latency_seconds"] = (
        float(h.total) if h is not None else 0.0)
    out["wheel_slice_bounds"] = (
        {k[len("wheel.slice_bound."):]: float(g.value)
         for k, g in reg._gauges.items()
         if k.startswith("wheel.slice_bound.")} if reg.enabled else {})
    return out


def serve_counters(registry=None):
    """Serve-layer counter dict for bench JSON (zeros when the run had
    telemetry off — keys are stable either way)."""
    reg = registry if registry is not None else get().registry
    names = ("serve.requests.submitted", "serve.requests.ok",
             "serve.requests.timeout", "serve.requests.rejected",
             "serve.requests.failed", "serve.compile_cache.hit",
             "serve.compile_cache.miss", "serve.worker_restarts")
    vals = ({k: c.value for k, c in reg._counters.items()}
            if reg.enabled else {})
    return {n.replace(".", "_"): int(vals.get(n, 0)) for n in names}


def router_counters(registry=None):
    """Router-layer (replica-set front door) counter dict for bench
    JSON — stable keys whether or not telemetry was on."""
    reg = registry if registry is not None else get().registry
    names = ("router.requests_submitted", "router.requests_ok",
             "router.requests_timeout", "router.requests_failed",
             "router.requests_rejected", "router.hedged_requests",
             "router.shed_hedges", "router.shed_requests",
             "router.over_quota", "router.breaker_opens",
             "router.replica_restarts", "router.replayed_requests",
             "router.quarantined", "router.duplicate_completions",
             "router.degraded_requests", "router.bucket_starvation")
    vals = ({k: c.value for k, c in reg._counters.items()}
            if reg.enabled else {})
    out = {n.replace(".", "_"): int(vals.get(n, 0)) for n in names}
    g = (reg._gauges.get("router.brownout_level")
         if reg.enabled else None)
    out["router_brownout_level"] = int(g.value) if g is not None else 0
    return out


def gateway_counters(registry=None):
    """Network-edge (serve/net gateway) + AOT-disk-cache counter dict
    for bench JSON — stable keys whether or not telemetry was on,
    mirroring router_counters().  `gateway_rejects_by_code` expands the
    `gateway.rejects.<code>` counter family (protocol.ERROR_CODES keys)
    into a dict, the same prefix-scan shape as wheel_slice_bounds."""
    reg = registry if registry is not None else get().registry
    names = ("gateway.requests", "gateway.bytes_in",
             "gateway.bytes_out", "gateway.rolls", "gateway.drains",
             "cache.aot_loads", "cache.aot_load_failures",
             "cache.aot_saves", "cache.aot_export_failures",
             "cache.aot_prewarm_hits", "cache.aot_evictions",
             "client.reconnects", "client.resends",
             "client.idle_reaped")
    vals = ({k: c.value for k, c in reg._counters.items()}
            if reg.enabled else {})
    out = {n.replace(".", "_"): int(vals.get(n, 0)) for n in names}
    g = (reg._gauges.get("gateway.active_connections")
         if reg.enabled else None)
    out["gateway_active_connections"] = (
        int(g.value) if g is not None else 0)
    out["gateway_rejects_by_code"] = (
        {k[len("gateway.rejects."):]: int(c.value)
         for k, c in reg._counters.items()
         if k.startswith("gateway.rejects.")} if reg.enabled else {})
    return out
