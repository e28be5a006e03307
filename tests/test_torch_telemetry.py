"""Port parity: telemetry (`mpisppy_tpu_torch/telemetry/`, `log.py`,
`utils/mfu.py` and the instrumented PH, solve and wheel paths) against
the JAX package, on the CPU.

* Registry, tracer, export and config: the cases of
  tests/test_telemetry.py (TestRegistry, TestTracer, TestConfig) run on
  both packages; the same sequence of operations gives equal Prometheus
  text and equal JSONL snapshots (up to timestamps), and the same spans
  give equal Chrome events (up to timestamps and durations).
* PH on farmer-3, float64, telemetry on, with phase_timing off and on
  (the JAX prep handed over through `convert.py`): the counters, the
  histogram counts, the `ph.iter0` payload and the span names equal the
  JAX package's.  The phased superstep equals the plain one bit for
  bit.
* The off path: no record, counter or event, and exactly one device
  sync per superstep.
* The telemetry package imports neither torch nor jax (standard
  library only).
* An interleaved farmer-3 wheel with a telemetry dir gives the JAX
  wheel's wheel_counters(), traffic_counters(), (track, span name)
  pairs and metrics.jsonl counter keys.
* Threads mode: the window counters equal independent locked counts.
"""

import ast
import inspect
import json
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mpisppy_tpu.telemetry as jtelemetry
from mpisppy_tpu.cylinders.hub import PHHub as JPHHub
from mpisppy_tpu.cylinders.lagrangian_bounder import (
    LagrangianOuterBound as JLagrangian)
from mpisppy_tpu.cylinders.xhatshufflelooper_bounder import (
    XhatShuffleInnerBound as JShuffle)
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.opt.ph import PH as JPH
from mpisppy_tpu.parallel.mesh import ScenarioMesh
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu.telemetry import export as jexport
from mpisppy_tpu.telemetry import metrics as jmetrics
from mpisppy_tpu.telemetry import tracer as jtracer
from mpisppy_tpu.utils import mfu as jmfu
from mpisppy_tpu.utils.xhat_eval import Xhat_Eval as JXhat_Eval
import mpisppy_tpu_torch.telemetry as ttelemetry
from mpisppy_tpu_torch import convert, log, phbase
from mpisppy_tpu_torch.cylinders import spcommunicator
from mpisppy_tpu_torch.cylinders.hub import PHHub
from mpisppy_tpu_torch.cylinders.lagrangian_bounder import (
    LagrangianOuterBound)
from mpisppy_tpu_torch.cylinders.xhatshufflelooper_bounder import (
    XhatShuffleInnerBound)
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.opt.ph import PH
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.telemetry import export as texport
from mpisppy_tpu_torch.telemetry import metrics as tmetrics
from mpisppy_tpu_torch.telemetry import tracer as ttracer
from mpisppy_tpu_torch.utils import mfu as tmfu
from mpisppy_tpu_torch.utils.xhat_eval import Xhat_Eval

ROOT = Path(__file__).resolve().parents[1]
ONE = ScenarioMesh(devices=jax.devices()[:1])
S = 3
NAMES = [f"scen{i}" for i in range(S)]
OPTS = {"defaultPHrho": 1.0, "PHIterLimit": 40, "convthresh": 0.0,
        "pdhg_eps": 1e-7, "pdhg_max_iters": 20000}
N_ITERS = 3

PKGS = {
    "jax": types.SimpleNamespace(tel=jtelemetry, metrics=jmetrics,
                                 tracer=jtracer, export=jexport, mfu=jmfu),
    "torch": types.SimpleNamespace(tel=ttelemetry, metrics=tmetrics,
                                   tracer=ttracer, export=texport,
                                   mfu=tmfu),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_draw():
    """Preps built by the port (xhat's reduced system, the f64 certify)
    start their power iterations from the JAX PRNGKey draw."""
    def draw(shape, dtype, device, seed=0):
        jd = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
        return torch.tensor(np.asarray(jax.random.normal(
            jax.random.PRNGKey(seed), shape, jd)), device=device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdhg, "normal_draw", draw)
        yield


@pytest.fixture(autouse=True)
def _fresh_telemetry(monkeypatch):
    """Each test starts and ends with no process-global telemetry in
    either package."""
    monkeypatch.delenv(ttelemetry.ENV_VAR, raising=False)
    jtelemetry.reset()
    ttelemetry.reset()
    yield
    jtelemetry.reset()
    ttelemetry.reset()


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


# ---- metrics registry (tests/test_telemetry.py TestRegistry) --------------

class TestRegistry:
    def test_counter_gauge_histogram(self, pkg):
        r = pkg.metrics.MetricsRegistry()
        c = r.counter("a")
        c.inc()
        c.inc(4)
        assert c.value == 5
        assert r.counter("a") is c
        g = r.gauge("b")
        g.set(2.5)
        assert g.value == 2.5
        h = r.histogram("t")
        for v in (0.001, 0.01, 3.0):
            h.observe(v)
        assert h.count == 3
        assert h.min == 0.001 and h.max == 3.0
        assert abs(h.mean - (3.011 / 3)) < 1e-12
        assert sum(h.bucket_counts) == 3

    def test_histogram_inf_tail(self, pkg):
        h = pkg.metrics.MetricsRegistry().histogram("t")
        h.observe(1e9)
        assert h.bucket_counts[-1] == 1

    def test_event_log_bounded(self, pkg):
        r = pkg.metrics.MetricsRegistry(max_events=4)
        for i in range(10):
            r.event("e", i=i)
        evs = r.events("e")
        assert len(evs) == 4
        assert evs[-1]["i"] == 9
        assert all("ts" in e for e in evs)

    def test_disabled_registry_returns_nulls(self, pkg):
        m = pkg.metrics
        r = m.MetricsRegistry(enabled=False)
        assert r.counter("x") is m.NULL_COUNTER
        assert r.gauge("x") is m.NULL_GAUGE
        assert r.histogram("x") is m.NULL_HISTOGRAM
        r.counter("x").inc()
        r.gauge("x").set(1.0)
        r.histogram("x").observe(1.0)
        r.event("boom")
        snap = r.snapshot()
        assert snap["counters"] == {} and snap["events"] == []

    def test_jsonl_snapshot_strict_json(self, pkg, tmp_path):
        r = pkg.metrics.MetricsRegistry()
        r.counter("window.writes").inc(3)
        r.gauge("hub.best_outer").set(float("-inf"))
        r.gauge("hub.best_inner").set(float("nan"))
        p = tmp_path / "metrics.jsonl"
        r.write_jsonl(str(p))
        r.write_jsonl(str(p))
        lines = p.read_text().strip().splitlines()
        assert len(lines) == 2
        snap = json.loads(lines[-1])
        assert snap["counters"]["window.writes"] == 3
        assert snap["gauges"]["hub.best_outer"] is None
        assert snap["gauges"]["hub.best_inner"] is None

    def test_prometheus_text(self, pkg, tmp_path):
        r = pkg.metrics.MetricsRegistry()
        r.counter("window.writes").inc(2)
        r.gauge("ph.conv").set(0.5)
        h = r.histogram("solve.seconds")
        h.observe(0.02)
        h.observe(200.0)
        text = r.prometheus_text()
        assert "# TYPE window_writes counter\nwindow_writes 2" in text
        assert "ph_conv 0.5" in text
        assert 'solve_seconds_bucket{le="+Inf"} 2' in text
        assert "solve_seconds_count 2" in text
        assert "solve_seconds_sum 200.02" in text
        p = tmp_path / "prom.txt"
        r.write_prometheus(str(p))
        assert p.read_text() == text


def _registry_script(m, tmp_path, tag):
    r = m.MetricsRegistry(max_events=8)
    r.counter("window.writes").inc(3)
    r.counter("solve.calls").inc()
    r.counter("solve.calls").inc(2)
    r.gauge("hub.best_outer").set(-108390.5)
    r.gauge("hub.best_inner").set(float("inf"))
    h = r.histogram("ph.phase.solve_seconds")
    for v in (2e-6, 3e-4, 0.02, 0.7, 40.0, 500.0):
        h.observe(v)
    for i in range(12):
        r.event("hub.bound_reject", spoke=i % 2, kind="outer",
                reason="nan")
    p = tmp_path / f"{tag}.jsonl"
    r.write_jsonl(str(p))
    snap = json.loads(p.read_text())
    snap.pop("ts")
    for e in snap["events"]:
        e.pop("ts")
    return r.prometheus_text(), snap


def test_registry_exports_match_jax(tmp_path):
    """The same operations: equal Prometheus text and JSONL snapshot."""
    t_prom, t_snap = _registry_script(tmetrics, tmp_path, "t")
    j_prom, j_snap = _registry_script(jmetrics, tmp_path, "j")
    assert t_prom == j_prom
    assert t_snap == j_snap
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


# ---- tracer + chrome export (TestTracer) ----------------------------------

class TestTracer:
    def test_span_records_complete_event(self, pkg):
        tr = pkg.tracer.Tracer()
        with tr.span("work", args={"k": 1}):
            time.sleep(0.002)
        recs = tr.records()
        assert len(recs) == 1
        kind, name, pid, tid, ts, dur, args = recs[0]
        assert kind == "X" and name == "work"
        assert pid == tr._pid and args == {"k": 1}
        assert dur >= 1000

    def test_ring_wraps_and_counts_drops(self, pkg):
        tr = pkg.tracer.Tracer(capacity=16)
        for i in range(40):
            tr.instant(f"e{i}")
        recs = tr.records()
        assert len(recs) == 16
        assert recs[-1][1] == "e39"
        assert tr.emitted == 40 and tr.dropped == 24

    def test_tracks_get_distinct_row_pids(self, pkg):
        tr = pkg.tracer.Tracer(main_label="hub")
        with tr.span("hub-side"):
            pass
        with tr.track("spoke0:Lagrangian"):
            with tr.span("step"):
                pass
        with tr.track("spoke1:Xhat"):
            tr.instant("evt")
        pids = {rec[2] for rec in tr.records()}
        assert len(pids) == 3
        assert tr._pid in pids
        assert len(tr._tracks) == 2

    def test_record_span_and_counter(self, pkg):
        tr = pkg.tracer.Tracer()
        t0 = time.monotonic_ns()
        tr.record_span("solve.loop", t0, t0 + 5_000_000)
        tr.counter("hub.bounds", {"outer": -1.0})
        recs = tr.records()
        assert recs[0][0] == "X" and recs[0][5] == 5000
        assert recs[1][0] == "C" and recs[1][4] == {"outer": -1.0}

    def test_chrome_export_is_valid_trace(self, pkg, tmp_path):
        tr = pkg.tracer.Tracer(main_label="hub")
        with tr.span("a"):
            pass
        with tr.track("spoke0"):
            tr.instant("b")
        p = tmp_path / "trace.json"
        pkg.export.write_trace(str(p), pkg.export.chrome_events(tr))
        evs = json.loads(p.read_text())["traceEvents"]
        names = {e["args"]["name"] for e in evs if e["ph"] == "M"}
        assert {"hub", "spoke0"} <= names
        assert all({"ph", "pid"} <= set(e) for e in evs)
        assert any(e["ph"] == "X" and e["name"] == "a" for e in evs)
        assert any(e["ph"] == "i" and e["name"] == "b" for e in evs)

    def test_merge_traces_metadata_first_then_by_ts(self, pkg, tmp_path):
        T, ex = pkg.tracer.Tracer, pkg.export
        tr1, tr2 = T(main_label="hub"), T(main_label="spokeP")
        with tr1.span("one"):
            time.sleep(0.001)
        with tr2.span("two"):
            pass
        f2 = tmp_path / "spoke.json"
        ex.write_trace(str(f2), ex.chrome_events(tr2))
        out = tmp_path / "trace.json"
        ex.merge_traces(str(out), event_lists=[ex.chrome_events(tr1)],
                        trace_files=[str(f2), str(tmp_path / "no")])
        evs = json.loads(out.read_text())["traceEvents"]
        assert [e["ph"] for e in evs][:2] == ["M", "M"]
        rest = [e["ts"] for e in evs if e["ph"] != "M"]
        assert rest == sorted(rest)

    def test_corrupt_trace_file_ignored(self, pkg, tmp_path):
        p = tmp_path / "bad.json"
        p.write_text("{not json")
        assert pkg.export.load_trace_events(str(p)) == []


def _trace_script(tr):
    with tr.span("hub.sync", args={"it": 1}):
        pass
    with tr.track("spoke0:LagrangianOuterBound"):
        with tr.span("LagrangianOuterBound.step"):
            tr.instant("ph.iter0", args={"conv": 1.5})
    tr.counter("hub.bounds", {"outer": -108400.0})
    tr.record_span("solve.loop", 1_000_000, 3_500_000)
    with tr.track("spoke1:XhatShuffleInnerBound"):
        tr.counter("hub.bounds", {"inner": -108390.0})
    return tr


def test_chrome_events_match_jax():
    """The same spans, instants and counter samples on the same rows:
    equal Chrome events up to timestamps and durations."""
    def strip(evs):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                for e in evs]

    t = texport.chrome_events(_trace_script(ttracer.Tracer()))
    j = jexport.chrome_events(_trace_script(jtracer.Tracer()))
    assert strip(t) == strip(j)
    assert [e["ts"] for e in t if e["name"] == "solve.loop"] == [1000]
    assert [e["dur"] for e in t if e["name"] == "solve.loop"] == [2500]


# ---- config facade (TestConfig) -------------------------------------------

class TestConfig:
    def test_default_disabled(self, pkg):
        tel = pkg.tel.get()
        assert not tel.enabled
        assert tel.span("x") is pkg.tracer.NULL_SPAN
        assert tel.counter("c") is pkg.metrics.NULL_COUNTER

    def test_config_forms(self, pkg, tmp_path):
        t = pkg.tel
        assert t.configure(True).enabled
        assert not t.configure("off").enabled
        tel = t.configure(str(tmp_path))
        assert tel.enabled and tel.out_dir == str(tmp_path)
        tel = t.configure({"enabled": True, "phase_timing": False})
        assert tel.enabled and not tel.phase_timing
        tel = t.configure('{"dir": "%s", "capacity": 64}' % tmp_path)
        assert tel.enabled and tel.tracer.capacity == 64

    def test_env_var_wins(self, pkg, monkeypatch):
        monkeypatch.setenv(pkg.tel.ENV_VAR, "0")
        assert not pkg.tel.configure({"enabled": True}).enabled
        monkeypatch.setenv(pkg.tel.ENV_VAR, "1")
        assert pkg.tel.configure(None).enabled

    def test_env_dir_form(self, pkg, monkeypatch, tmp_path):
        monkeypatch.setenv(pkg.tel.ENV_VAR, str(tmp_path))
        pkg.tel.reset()
        tel = pkg.tel.get()
        assert tel.enabled and tel.out_dir == str(tmp_path)

    def test_configure_from_options_is_idempotent(self, pkg):
        t = pkg.tel
        a = t.configure_from_options({"enabled": True})
        a.counter("keep").inc()
        b = t.configure_from_options({"enabled": True})
        assert a is b
        assert b.registry.counter("keep").value == 1
        c = t.configure_from_options({"enabled": True, "capacity": 1024})
        assert c is not a
        assert t.configure_from_options(None) is c

    def test_stable_keys_when_off(self, pkg):
        t = pkg.tel
        assert t.traffic_counters() == {
            "window_writes": 0, "window_reads": 0,
            "window_stale_reads": 0, "window_kill_signals": 0,
            "window_bound_rejects": 0}
        for fn in ("pdhg_counters", "wheel_counters", "stream_counters",
                   "storage_counters", "serve_counters", "router_counters",
                   "gateway_counters"):
            assert getattr(ttelemetry, fn)() == getattr(jtelemetry, fn)()


def test_effective_configs_match_jax(monkeypatch, tmp_path):
    forms = [None, False, True, "0", "on", str(tmp_path), '{"capacity": 32}',
             "{not json", {"phase_timing": False, "dir": str(tmp_path)},
             {"enabled": False}]
    for env in (None, "1", "off"):
        if env is None:
            monkeypatch.delenv(ttelemetry.ENV_VAR, raising=False)
        else:
            monkeypatch.setenv(ttelemetry.ENV_VAR, env)
        for f in forms:
            assert ttelemetry._effective(f) == jtelemetry._effective(f), \
                (env, f)


def test_mfu_record_to_registry(pkg, monkeypatch):
    monkeypatch.setenv("TPU_PEAK_FLOPS", "1e12")
    r = pkg.metrics.MetricsRegistry()
    pkg.mfu.record_to_registry(r, 1e12, 2.0, kernel_iters=100)
    assert r.gauge("mfu.kernel_flops").value == 1e12
    assert r.gauge("mfu.iters_per_sec").value == 50.0
    assert r.gauge("mfu.mfu").value == pytest.approx(0.5)
    off = pkg.metrics.MetricsRegistry(enabled=False)
    pkg.mfu.record_to_registry(off, 1e12, 2.0)
    assert off.snapshot()["gauges"] == {}


def test_mfu_peaks():
    assert tmfu.cuda_peak_flops("NVIDIA H100 80GB HBM3") == 67e12
    assert tmfu.cuda_peak_flops("NVIDIA H100 80GB HBM3", "float64") == 34e12
    assert tmfu.cuda_peak_flops("NVIDIA H100 PCIe", "bfloat16") == 51.2e12
    assert tmfu.device_peak_flops("cpu", "float64") == \
        jmfu.cpu_peak_flops("float64")


def test_log_setup_and_toc_sink(tmp_path, monkeypatch):
    import mpisppy_tpu_torch
    monkeypatch.setattr(mpisppy_tpu_torch, "_TOC_SINKS", [])
    lg = log.setup_logger("mpisppy_tpu_torch.test", out=str(tmp_path / "a"))
    lg.info("hello")
    assert "hello" in (tmp_path / "a").read_text()
    assert len(log.setup_logger("mpisppy_tpu_torch.test").handlers) == 1
    log.global_toc_logger(out=str(tmp_path / "toc"))
    mpisppy_tpu_torch.global_toc("a toc line")
    assert "a toc line" in (tmp_path / "toc").read_text()


# ---- PH with telemetry on: the JAX package's counters ----------------------

def _ph_run(pkg_name, tel_cfg, jprep=None):
    opts = {**OPTS, "no_split_prep": True, "telemetry": tel_cfg}
    if pkg_name == "jax":
        ph = JPH(opts, NAMES, batch=jfarmer.build_batch(S), mesh=ONE)
    else:
        ph = PH(opts, NAMES, batch=farmer.build_batch(S, device="cpu"),
                device="cpu", prep=convert.prep_from_arrays(
                    convert.to_arrays(jprep), device="cpu"))
    ph.Iter0()
    for _ in range(N_ITERS):
        ph.ph_iteration()
    ph.lagrangian_bound()
    # a capped solve certified in f64: the certify instruments
    ph.solve_loop(warm=False, certify=True, iters_cap=80)
    return ph


def _summary(ph):
    r = ph._tel.registry
    iter0 = r.events("ph.iter0")
    return {
        "counters": {k: c.value for k, c in r._counters.items()},
        "histograms": {k: h.count for k, h in r._histograms.items()},
        "gauges": set(r._gauges),
        "events": sorted({e["event"] for e in r.events()}),
        "iter0": {k: v for k, v in iter0[0].items()
                  if k not in ("ts", "event")},
        "spans": {rec[1] for rec in ph._tel.tracer.records()},
    }


@pytest.fixture(scope="module")
def jax_prep():
    return JPH({**OPTS, "no_split_prep": True}, NAMES,
               batch=jfarmer.build_batch(S), mesh=ONE).prep


@pytest.mark.parametrize("phase_timing", [False, True])
def test_ph_telemetry_matches_jax(jax_prep, phase_timing):
    cfg = {"enabled": True, "phase_timing": phase_timing}
    j = _summary(_ph_run("jax", cfg))
    jtelemetry.reset()
    tph = _ph_run("torch", cfg, jax_prep)
    t = _summary(tph)
    assert t["counters"] == j["counters"]
    assert t["histograms"] == j["histograms"]
    assert t["gauges"] == j["gauges"]
    assert t["events"] == j["events"]
    assert t["spans"] == j["spans"]
    assert set(t["iter0"]) == set(j["iter0"])
    for k, v in j["iter0"].items():
        assert _rel(t["iter0"][k], v) <= 1e-6, k
    c = t["counters"]
    assert c["ph.iterations"] == N_ITERS
    assert c["solve.certify_calls"] == 1 and c["solve.certify_scenarios"] > 0
    assert c["ph.lagrangian_bound_calls"] == 1
    phases = {f"ph.phase.{k}" for k in ("solve", "psum", "w_update",
                                        "conv")}
    assert (phases <= t["spans"]) == phase_timing
    stats = tph.solve_stats()
    assert stats["mfu"] is not None and stats["mfu"] > 0
    assert tph._tel.registry.gauge("mfu.mfu").value == stats["mfu"]


def test_phased_superstep_equals_plain(jax_prep):
    """The phased path runs the same torch ops in the same order: the
    same PHState bit for bit."""
    prep = convert.prep_from_arrays(convert.to_arrays(jax_prep),
                                    device="cpu")
    b = farmer.build_batch(S, device="cpu")
    plain = PH({**OPTS, "telemetry": False}, NAMES, batch=b, device="cpu",
               prep=prep)
    plain.Iter0()
    ttelemetry.reset()
    phased = PH({**OPTS, "telemetry": {"phase_timing": True}}, NAMES,
                batch=b, device="cpu", prep=prep)
    assert phased._tel.phase_timing and not plain._tel.enabled
    phased.Iter0()
    for _ in range(N_ITERS):
        plain.ph_iteration()
        phased.ph_iteration()
    for f in ("x", "y", "W", "xbar", "xsqbar", "obj", "dual_obj", "conv",
              "active_frac", "solve_restarts"):
        a, b_ = getattr(phased.state, f), getattr(plain.state, f)
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b_)), f
    assert phased.state.it == plain.state.it
    assert phased.state.solve_iters == plain.state.solve_iters
    h = phased._tel.registry.histogram
    for k in ("solve", "psum", "w_update", "conv"):
        assert h(f"ph.phase.{k}_seconds").count == N_ITERS


def test_off_path_records_nothing_and_syncs_once(monkeypatch, jax_prep):
    syncs = [0]
    sync = phbase._sync

    def counted(t):
        syncs[0] += 1
        return sync(t)

    monkeypatch.setattr(phbase, "_sync", counted)
    ph = PH(dict(OPTS), NAMES, batch=farmer.build_batch(S, device="cpu"),
            device="cpu", prep=convert.prep_from_arrays(
                convert.to_arrays(jax_prep), device="cpu"))
    assert not ph._tel.enabled and not ph._tel.phase_timing
    ph.Iter0()
    for k in range(N_ITERS):
        before = syncs[0]
        ph.ph_iteration()
        assert syncs[0] - before == 1, k
    ph.lagrangian_bound()
    tel = ttelemetry.get()
    assert tel.tracer.records() == []
    assert tel.registry._counters == {}
    assert tel.registry._histograms == {}
    assert tel.registry.events() == []
    # and the phased path is reachable only behind tel.phase_timing
    src = inspect.getsource(phbase.PHBase._run_superstep)
    assert "phase_timing" in src and "_superstep_phased" in src


def test_telemetry_package_is_stdlib_only():
    files = sorted((ROOT / "mpisppy_tpu_torch" / "telemetry").glob("*.py"))
    assert {p.name for p in files} == {"__init__.py", "metrics.py",
                                       "tracer.py", "export.py"}
    for p in files + [ROOT / "mpisppy_tpu_torch" / "log.py"]:
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                head = m.split(".")[0]
                assert head == "__future__" or \
                    head in sys.stdlib_module_names, f"{p.name}: {m}"
                assert head not in ("torch", "jax", "numpy")


# ---- the wheel --------------------------------------------------------------

def _wheel_dicts(hub_cls, ph_cls, spokes, batch, tel_cfg, **hub_kw):
    opts = {**OPTS, "PHIterLimit": 10, "telemetry": tel_cfg}
    hub_dict = {"hub_class": hub_cls,
                "hub_kwargs": {"options": {"rel_gap": 1e-4, "abs_gap": 1.0,
                                           "telemetry": tel_cfg}},
                "opt_class": ph_cls,
                "opt_kwargs": {"options": dict(opts),
                               "all_scenario_names": NAMES, "batch": batch,
                               **hub_kw}}
    spoke_dicts = [{"spoke_class": cls,
                    "spoke_kwargs": {"options": {"telemetry": tel_cfg}},
                    "opt_class": ocls,
                    "opt_kwargs": {"options": dict(opts),
                                   "all_scenario_names": NAMES}}
                   for cls, ocls in spokes]
    return hub_dict, spoke_dicts


def _trace_pairs(path):
    evs = json.loads(path.read_text())["traceEvents"]
    rows = {e["pid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    return rows, {(rows[e["pid"]], e["name"]) for e in evs
                  if e["ph"] != "M"}


@pytest.fixture(scope="module")
def wheel_pair(tmp_path_factory):
    """One interleaved farmer-3 wheel per package (PH hub, Lagrangian and
    XhatShuffle spokes), telemetry into a dir each."""
    out = {}
    jtelemetry.reset()
    d = tmp_path_factory.mktemp("jax_wheel")
    cfg = {"enabled": True, "dir": str(d), "prometheus": True}
    jws = JWheelSpinner(*_wheel_dicts(
        JPHHub, JPH, [(JLagrangian, JPH), (JShuffle, JXhat_Eval)],
        jfarmer.build_batch(S), cfg, mesh=ONE))
    jws.spin()
    out["jax"] = (jws, d, jtelemetry.traffic_counters(),
                  jtelemetry.wheel_counters())
    jtelemetry.reset()
    ttelemetry.reset()
    d = tmp_path_factory.mktemp("torch_wheel")
    cfg = {"enabled": True, "dir": str(d), "prometheus": True}
    prep = convert.prep_from_arrays(convert.to_arrays(jws.spcomm.opt.prep),
                                    device="cpu")
    tws = WheelSpinner(*_wheel_dicts(
        PHHub, PH, [(LagrangianOuterBound, PH),
                    (XhatShuffleInnerBound, Xhat_Eval)],
        farmer.build_batch(S, device="cpu"), cfg, device="cpu", prep=prep))
    tws.spin()
    out["torch"] = (tws, d, ttelemetry.traffic_counters(),
                    ttelemetry.wheel_counters())
    ttelemetry.reset()
    return out


def test_wheel_telemetry_matches_jax(wheel_pair):
    tws, td, t_traffic, t_wheel = wheel_pair["torch"]
    jws, jd, j_traffic, j_wheel = wheel_pair["jax"]
    assert tws.spcomm.current_iteration() == jws.spcomm.current_iteration()
    assert t_traffic == j_traffic
    assert t_traffic["window_writes"] > 0 and t_traffic["window_reads"] > 0
    t_bounds = t_wheel.pop("wheel_slice_bounds")
    j_bounds = j_wheel.pop("wheel_slice_bounds")
    assert t_wheel == j_wheel
    assert set(t_bounds) == set(j_bounds) == {
        "spoke0:LagrangianOuterBound", "spoke1:XhatShuffleInnerBound"}
    for k, v in j_bounds.items():
        assert _rel(t_bounds[k], v) <= 1e-6, k
    t_rows, t_pairs = _trace_pairs(td / "trace.json")
    j_rows, j_pairs = _trace_pairs(jd / "trace.json")
    assert sorted(t_rows.values()) == sorted(j_rows.values())
    assert len(t_rows) == 3
    assert t_pairs == j_pairs
    assert ("hub", "hub.sync") in t_pairs
    assert ("spoke0:LagrangianOuterBound",
            "LagrangianOuterBound.step") in t_pairs
    t_snap = json.loads((td / "metrics.jsonl").read_text().splitlines()[-1])
    j_snap = json.loads((jd / "metrics.jsonl").read_text().splitlines()[-1])
    assert set(t_snap["counters"]) == set(j_snap["counters"])
    assert set(t_snap["histograms"]) == set(j_snap["histograms"])
    assert set(t_snap["gauges"]) == set(j_snap["gauges"])
    assert (td / "prometheus.txt").exists()


# ---- threads mode: exact counts -------------------------------------------

def test_counters_exact_under_thread_contention():
    r = tmetrics.MetricsRegistry()
    c, h = r.counter("c"), r.histogram("h")
    n_threads, n_calls = 16, 2000
    old = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)

        def work():
            for _ in range(n_calls):
                c.inc()
                h.observe(1e-3)

        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert c.value == n_threads * n_calls
    assert h.count == n_threads * n_calls == sum(h.bucket_counts)


def test_threads_mode_window_counters_are_exact(monkeypatch):
    """Every window write, validated read and kill, counted under a lock
    beside the telemetry: the counters equal those counts."""
    seen = {"writes": 0, "reads": 0, "kills": 0}
    lock = threading.Lock()
    W = spcommunicator.Window

    def wrap(name, key):
        fn = getattr(W, name)

        def counted(self, *a, **kw):
            with lock:
                seen[key] += 1
            return fn(self, *a, **kw)
        monkeypatch.setattr(W, name, counted)

    wrap("write", "writes")
    wrap("read_checked", "reads")
    wrap("send_kill", "kills")
    ws = WheelSpinner(*_wheel_dicts(
        PHHub, PH, [(LagrangianOuterBound, PH),
                    (XhatShuffleInnerBound, Xhat_Eval)],
        farmer.build_batch(S, device="cpu"), {"enabled": True},
        device="cpu"), mode="threads")
    ws.spin()
    assert ws.spcomm.failed_spokes == []
    tc = ttelemetry.traffic_counters()
    assert seen["writes"] > 0 and seen["reads"] > 0
    assert tc["window_writes"] == seen["writes"]
    assert tc["window_reads"] == seen["reads"]
    assert tc["window_kill_signals"] == seen["kills"] == 2
    assert tc["window_bound_rejects"] == int(ws.spcomm.bound_rejects.sum())
