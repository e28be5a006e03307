#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mpisppy_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero):
  1. env      torch/CUDA versions, the card, nvidia-smi name + power limit
  2. build    nvcc build (or load) of csrc/pdhg_chunk.cu, and what ptxas
              reports for each instantiated variant (registers, spills,
              stack); the main path's f32 variant must not spill
  3. kernel   the PDHG chunk kernel against its plain torch twin at the
              main path's shapes (farmer S=1000, crops_multiplier=10:
              M=61, N=120; n_steps=40) with A stored in f32, f64 and
              bf16 (f32 vectors), with timings, the bound, the variant
              taken, resident blocks per SM and waves
  4. slice    PH on farmer at full width (S=1000, crops_multiplier=10,
              f32, the bench's accelerator options): Iter0, a few PH
              iterations, one xhat inner bound and one Lagrangian outer
              bound, the bench's gap loop and a profiled window; every
              solve must go through the kernel, and the (S, M, N, dtype)
              shapes it launched with are listed
  5. bf16x    the same farmer batch with pdhg_hot_dtype="bf16x": Iter0
              (promoted to full precision at pdhg_eps=1e-5), 2 PH
              iterations on the eps ladder in bf16 storage, one xhat and
              one Lagrangian bound
  6. golden   farmer-3 in f64 through ph_main: E[obj] = -108390 +- 20,
              xbar ~ (170, 80, 250)
Then the kernels line, the nvidia-smi line, and the result line.

Imports nothing of jax and nothing of the JAX package.  Exits non-zero,
printing no result, without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

S, CM, N_STEPS = 1000, 10, 40
PH_ITERS = 4
BF16X_PH_ITERS = 2
# the bench's accelerator options (bench.py:1252-1294) for farmer
SLICE_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": PH_ITERS,
              "convthresh": 0.0, "pdhg_eps": 1e-5, "superstep_eps": 1e-4,
              "lagrangian_eps": 1e-4, "pdhg_max_iters": 30000,
              "no_split_prep": True,
              "eps_ladder": {"start": 1e-3, "min": 1e-4, "couple": 0.1},
              "pdhg_hot_dtype": "f32"}

# H100 rates used for the bound (NVIDIA data sheets, dense, no sparsity):
# (memory bytes/s, FP32 non-tensor FLOP/s, FP64 non-tensor FLOP/s)
PEAKS = {
    "H100 PCIe": (2.0e12, 51.2e12, 25.6e12),
    "H100": (3.35e12, 67e12, 34e12),          # SXM
}

# Kernel-vs-twin tolerance, as max|kernel - twin| / max(1, max|twin|):
# both do the same arithmetic in the same order except the summation
# order inside the two matvecs; over 40 steps that is ~1e-13 relative
# in f64 and, in f32, up to a few hundred ulp of the largest iterate
# (the chunk amplifies rounding by the number of steps and the row
# length).  With A in bf16 both cast the same bf16 values up and run in
# f32, so bf16 has f32's tolerance.
TOL = {"float64": 1e-9, "float32": 2e-4, "bfloat16": 2e-4}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def peaks(name):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


def time_ms(fn, reps=5, batch=20, warmup=3, queue_behind_sleep=False):
    """Median over `reps` runs of the mean time per call of `batch`
    back-to-back calls between two CUDA events, after warmup.  Events
    around a single call would also count the host's time to reach the
    launch (the wrapper's checks, the ctypes call), while the device
    waits.  queue_behind_sleep: first put a spin kernel of 8e6 clock
    cycles (4 ms at 2 GHz) on the stream, so that the host enqueues all
    `batch` calls while the device is still busy; the events then
    bracket device work alone even when one call's device work is
    shorter than its host cost."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queue_behind_sleep:
            torch.cuda._sleep(8_000_000)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def host_us(fn, n=50):
    """Host time per call of `fn` (enqueue only: no synchronize)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return dt


def template_args(mangled):
    """The template arguments of a mangled `pdhg_chunk_tiled<...>` name
    (Itanium ABI: f float, d double, <len><name> a class, Li<n>E an
    int), or None for another kernel."""
    i = mangled.find("pdhg_chunk_tiledI")
    if i < 0:
        return None
    rest, args = mangled[i + len("pdhg_chunk_tiledI"):], []
    while rest and rest[0] != "E":
        m = re.match(r"Li(-?\d+)E|(\d+)|([fd])", rest)
        if m is None:
            return None
        if m.group(1) is not None:
            args.append(m.group(1))
        elif m.group(3) is not None:
            args.append({"f": "float", "d": "double"}[m.group(3)])
        else:
            n = int(m.group(2))
            args.append(rest[m.end():m.end() + n])
            rest = rest[n:]
        rest = rest[m.end():]
    return args


def ptxas_report(log):
    """What `nvcc -Xptxas -v` said about each kernel: its template
    arguments (storage, compute, rows per thread, column vectors per
    lane, warps, source of A: 0 registers / 1 shared / 2 global, min
    blocks per SM), registers, stack, spill stores and loads."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"mangled": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    for k in out:
        name = k.pop("mangled")
        args = template_args(name)
        k["variant"] = ", ".join(args) if args else name
    return out


# template arguments of the main path's f32 variant (all but min blocks)
MAIN_F32 = ["float", "float", "8", "1", "8", "0"]


def sass_summary(lib):
    """The instruction mix of the main path's f32 variant's step loop
    (the backward branch whose body holds the most barriers), from
    `cuobjdump -sass`; None where the tool is missing."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    for block in re.split(r"\n\s*Function : ", out.stdout)[1:]:
        args = template_args(block.split("\n", 1)[0].strip())
        if not args or args[:6] != MAIN_F32:
            continue
        ins = [(int(a, 16), i.strip()) for a, i in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        best = (0, [])
        for addr, i in ins:
            m = re.search(r"BRA\s+(?:\S+,\s*)?0x([0-9a-f]+)", i)
            if m and int(m.group(1), 16) < addr:
                body = [j for b, j in ins if int(m.group(1), 16) <= b <= addr]
                bars = sum("BAR.SYNC" in j for j in body)
                if bars > best[0]:
                    best = (bars, body)
        ops = {}
        for j in best[1]:
            op = re.sub(r"^@!?U?P\w+\s+", "", j).split()[0].split(".")[0]
            ops[op] = ops.get(op, 0) + 1
        return {"variant": ", ".join(args), "barriers": best[0],
                "loop_instructions": len(best[1]),
                "by_opcode": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    return None


def build_phase():
    from mpisppy_tpu_torch.ops import pdhg_chunk
    t = time.time()
    lib = pdhg_chunk.build()
    pdhg_chunk.load_library()
    report = ptxas_report(pdhg_chunk.build_log_path().read_text())
    # 3 variants (registers, shared, global) for each of f32, f64, bf16
    check(len(report) == 9, f"ptxas reported {len(report)} kernels")
    main = [k for k in report
            if k["variant"].split(", ")[:6] == MAIN_F32]
    check(len(main) == 1, "no ptxas line for the main path's f32 variant")
    check(main[0].get("spill_stores", 1) == 0
          and main[0].get("spill_loads", 1) == 0,
          f"the main path's f32 variant spills: {main[0]}")
    emit({"phase": "build", "library": str(lib), "s": time.time() - t,
          "ptxas": report, "main_f32_step_loop": sass_summary(lib)})


def solver_space_inputs(dtype):
    """The chunk's inputs as PDHGSolver builds them for farmer S=1000,
    crops_multiplier=10 (Ruiz-scaled prep, cold start, omega=1)."""
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops.pdhg import prepare_batch
    b = farmer.build_batch(S, crops_multiplier=CM,
                           dtype=np.float32 if dtype == torch.float32
                           else np.float64)
    p = prepare_batch(b.A, b.row_lo, b.row_hi)
    dc = p.d_col
    qs = b.qdiag * dc * dc
    lbs = b.lb / dc
    ubs = torch.where(torch.isfinite(b.ub), b.ub / dc, b.ub)
    # a warm, non-trivial start: the box midpoint clipped
    x = torch.clamp(0.5 * (lbs + torch.clamp(ubs, max=1e3)), min=0.0)
    y = torch.zeros_like(p.row_lo)
    tau = 0.9 / (p.anorm + 0.9 * qs.amax(dim=1))
    sigma = 0.9 / p.anorm
    return [t.contiguous() for t in (p.A, b.c * dc, qs, lbs, ubs,
                                     p.row_lo, p.row_hi, x, y, tau,
                                     sigma)]


def kernel_phase(name):
    import torch

    from mpisppy_tpu_torch.ops import pdhg_chunk
    peak_name, (bw, f32_peak, f64_peak) = peaks(name)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    f32_args = solver_space_inputs(torch.float32)
    rows = {}
    for store, peak in ((torch.float32, f32_peak),
                        (torch.float64, f64_peak),
                        (torch.bfloat16, f32_peak)):
        if store == torch.float64:
            args = solver_space_inputs(torch.float64)
        else:
            args = [f32_args[0].to(store)] + f32_args[1:]
        got = pdhg_chunk.fused_chunk(*args, N_STEPS)
        torch.cuda.synchronize()
        want = pdhg_chunk.fused_chunk_reference(*args, N_STEPS)
        err_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
        err_rel = max(float((g - w).abs().max())
                      / max(1.0, float(w.abs().max()))
                      for g, w in zip(got, want))
        for g in got:
            check(bool(torch.isfinite(g).all()), "kernel output not finite")
        dname = str(store).replace("torch.", "")
        check(err_rel <= TOL[dname],
              f"{dname} kernel disagrees with its twin: {err_rel:.3e} > "
              f"{TOL[dname]:.0e}")

        def call():
            return pdhg_chunk.fused_chunk(*args, N_STEPS)

        ms = time_ms(call, queue_behind_sleep=True)
        wrapper_us = host_us(call)
        plain_ms = time_ms(
            lambda: pdhg_chunk.fused_chunk_reference(*args, N_STEPS))
        _, M, N = args[0].shape
        vec = args[1].element_size()
        # each input read once, each output written once; A at its
        # storage width, the FLOP at the compute type's peak
        nbytes = (args[0].element_size() * S * M * N
                  + vec * (5 * S * N + 3 * S * M + 2 * S
                           + 2 * S * N + 2 * S * M))
        flops = N_STEPS * S * (4 * M * N + 10 * N + 8 * M)
        t_bytes = nbytes / bw * 1e3
        t_ops = flops / peak * 1e3
        bound = max(t_bytes, t_ops)
        variant, blocks = pdhg_chunk.occupancy(M, N, store)
        rows[dname] = {
            "dtype": dname, "S": S, "M": M, "N": N, "n_steps": N_STEPS,
            "max_abs_err": err_abs, "max_rel_err": err_rel,
            "tol_rel": TOL[dname], "ms": ms, "wrapper_host_us": wrapper_us,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "share_of_bound": bound / ms,
            "bytes": nbytes, "flops": flops,
            "peaks": {"card": peak_name, "bytes_per_s": bw,
                      "flops_per_s": peak},
            "variant": dataclasses.asdict(variant),
            "blocks_per_sm": blocks, "sms": n_sm,
            "waves": S / (blocks * n_sm),
            "library_ms": None}
        emit({"phase": "kernel", **rows[dname]})
    return rows


def reset_counts():
    from mpisppy_tpu_torch.ops import pdhg_chunk
    pdhg_chunk.launches = 0
    pdhg_chunk.launch_shapes.clear()


def launch_table():
    """The (S, M, N, dtype) tuples the kernel launched with since the
    last reset_counts(), with their counts."""
    from mpisppy_tpu_torch.ops import pdhg_chunk
    return [{"S": k[0], "M": k[1], "N": k[2], "dtype": k[3], "launches": n}
            for k, n in sorted(pdhg_chunk.launch_shapes.items())]


def launches_by_dtype():
    from mpisppy_tpu_torch.ops import pdhg_chunk
    out = {}
    for k, n in pdhg_chunk.launch_shapes.items():
        out[k[3]] = out.get(k[3], 0) + n
    return out


def slice_phase():
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg_chunk
    from mpisppy_tpu_torch.opt.ph import PH
    opts = dict(SLICE_OPTS)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                    # count the main path's run only
    t0 = time.time()
    b = farmer.build_batch(S, crops_multiplier=CM, dtype=np.float32)
    ph = PH(opts, [f"scen{i}" for i in range(S)], batch=b)
    torch.cuda.synchronize()
    steps = [{"step": "setup", "s": time.time() - t0}]

    def timed(step, fn):
        n0, t = pdhg_chunk.launches, time.time()
        out = fn()
        torch.cuda.synchronize()
        steps.append({"step": step, "s": time.time() - t,
                      "launches": pdhg_chunk.launches - n0,
                      "solve_iters": int(ph.state.solve_iters)
                      if ph.state is not None else None})
        return out

    trivial = timed("iter0", ph.Iter0)
    for k in range(PH_ITERS):
        timed(f"ph_iteration_{k + 1}", ph.ph_iteration)
    inner, feas = timed("evaluate_xhat", lambda: ph.evaluate_xhat(
        ph.root_xbar()))
    outer = timed("lagrangian_bound", ph.lagrangian_bound)
    gap = gap_loop(PH, opts, b)
    gap["profile"] = profile_window(gap.pop("ph"))
    launches = pdhg_chunk.launches
    shapes = launch_table()
    check(sum(r["launches"] for r in shapes) == launches,
          "the per-shape launch counts do not add up")
    for f, v in vars(ph.state).items():
        if torch.is_tensor(v):
            check(v.device.type == "cuda", f"state.{f} is on {v.device}")
    check(all(np.isfinite([trivial, inner, outer])),
          f"bounds not finite: {trivial}, {inner}, {outer}")
    check(feas, "xhat candidate infeasible")
    check(max(trivial, outer) <= inner + 1e-6 * abs(inner),
          f"outer bound above inner: {max(trivial, outer)} > {inner}")
    check(launches > 0, "the main path launched no kernel")
    it_launches = [s["launches"] for s in steps
                   if s["step"].startswith("ph_iteration")]
    out = {"phase": "slice", "S": S, "crops_multiplier": CM,
           "dtype": "float32", "ph_iterations": PH_ITERS,
           "trivial_bound": trivial, "inner_bound": inner,
           "outer_bound": outer, "conv": ph.conv,
           "rel_gap": (inner - max(trivial, outer)) / abs(inner),
           "kernel_launches": launches, "launch_shapes": shapes,
           "launches_per_ph_iteration": it_launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "steps": steps, "pdhg_stats": ph.pdhg_stats(),
           "gap_loop": gap}
    emit(out)
    return out


def gap_loop(PH, opts, b):
    """The bench's farmer row on a fresh PH (bench.py:1322-1343): Iter0,
    then PH iterations with inner/outer bounds every 4 iterations (every
    2 below a 3% gap) until the gap is at most 1% or 200 iterations."""
    import torch
    ph = PH(dict(opts, PHIterLimit=200), [f"scen{i}" for i in range(S)],
            batch=b)
    torch.cuda.synchronize()
    t0 = time.time()
    outer = ph.Iter0()
    inner, gap, iters, checks = None, float("inf"), 0, 0
    while gap > 0.01 and iters < 200:
        ph.ph_iteration()
        iters += 1
        cadence = 2 if gap < 0.03 else 4
        if iters % cadence == 0 or ph.conv < 1e-4:
            inner, feas = ph.evaluate_xhat(ph.root_xbar())
            outer = max(outer, ph.lagrangian_bound())
            checks += 1
            if feas:
                gap = abs(inner - outer) / max(abs(inner), 1e-9)
    torch.cuda.synchronize()
    wall = time.time() - t0
    check(gap <= 0.01, f"gap loop ended at gap {gap} after {iters} iters")
    check(outer <= inner + 1e-6 * abs(inner), "outer above inner")
    return {"ph": ph, "wall_s": wall, "iters": iters, "bound_checks": checks,
            "gap": gap, "inner": inner, "outer": outer,
            "inner_iters": ph.pdhg_stats()["inner_iters"]}


def profile_window(ph, n=2):
    """Device time by kernel over `n` PH iterations under torch.profiler
    (the profiler's own host overhead inflates the window's wall time,
    so the idle share is an upper bound)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(n):
            ph.ph_iteration()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            d = by_name.setdefault(e.name, [0, 0.0])
            d[0] += 1
            d[1] += e.time_range.elapsed_us()
    busy = sum(v[1] for v in by_name.values())
    chunk = sum(v[1] for k, v in by_name.items() if "pdhg_chunk" in k)
    chunk_n = sum(v[0] for k, v in by_name.items() if "pdhg_chunk" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"ph_iterations": n, "wall_us": wall_us, "device_busy_us": busy,
            "idle_share": (1.0 - busy / wall_us) if busy else None,
            "chunk_kernel_us": chunk, "chunk_kernel_launches": chunk_n,
            "chunk_share_of_busy": (chunk / busy) if busy else None,
            "device_events": sum(v[0] for v in by_name.values()),
            "top": [{"name": k[:60], "count": v[0], "us": v[1]}
                    for k, v in top]}


def bf16x_phase():
    """This slice's own path: farmer S=1000, cm=10, f32 batch, the
    slice's options with A stored in bf16 in the hot loop."""
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.opt.ph import PH
    opts = dict(SLICE_OPTS, PHIterLimit=BF16X_PH_ITERS,
                pdhg_hot_dtype="bf16x")
    reset_counts()
    t0 = time.time()
    b = farmer.build_batch(S, crops_multiplier=CM, dtype=np.float32)
    ph = PH(opts, [f"scen{i}" for i in range(S)], batch=b)
    torch.cuda.synchronize()
    steps = [{"step": "setup", "s": time.time() - t0}]

    def timed(step, fn):
        n0, t = launches_by_dtype(), time.time()
        out = fn()
        torch.cuda.synchronize()
        n1 = launches_by_dtype()
        steps.append({"step": step, "s": time.time() - t,
                      "launches": {k: n1[k] - n0.get(k, 0) for k in n1
                                   if n1[k] != n0.get(k, 0)}})
        return out

    trivial = timed("iter0", ph.Iter0)
    for k in range(BF16X_PH_ITERS):
        timed(f"ph_iteration_{k + 1}", ph.ph_iteration)
    inner, feas = timed("evaluate_xhat", lambda: ph.evaluate_xhat(
        ph.root_xbar()))
    outer = timed("lagrangian_bound", ph.lagrangian_bound)
    by_dtype = launches_by_dtype()
    check(all(np.isfinite([trivial, inner, outer])),
          f"bf16x bounds not finite: {trivial}, {inner}, {outer}")
    check(feas, "bf16x xhat candidate infeasible")
    check(max(trivial, outer) <= inner + 1e-6 * abs(inner),
          f"bf16x outer bound above inner: {max(trivial, outer)} > {inner}")
    check(by_dtype.get("bfloat16", 0) > 0, "the bf16x path launched no "
          "bf16 kernel")
    check(all(s["launches"].get("bfloat16", 0) > 0 for s in steps
              if s["step"].startswith("ph_iteration")),
          "a bf16x PH iteration did not run in bf16 storage")
    out = {"phase": "bf16x", "S": S, "crops_multiplier": CM,
           "dtype": "float32", "hot_dtype": "bf16x",
           "ph_iterations": BF16X_PH_ITERS, "trivial_bound": trivial,
           "inner_bound": inner, "outer_bound": outer, "conv": ph.conv,
           "rel_gap": (inner - max(trivial, outer)) / abs(inner),
           "launches_by_dtype": by_dtype, "launch_shapes": launch_table(),
           "steps": steps, "pdhg_stats": ph.pdhg_stats()}
    emit(out)
    return out


def golden_phase():
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.opt.ph import PH
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 200, "convthresh": 1e-5,
            "pdhg_eps": 1e-7}
    ph = PH(opts, [f"scen{i}" for i in range(3)],
            batch=farmer.build_batch(3))
    conv, eobj, triv = ph.ph_main()
    xbar = ph.root_xbar().cpu().numpy()
    check(ph.state.x.device.type == "cuda", "golden run left the card")
    check(abs(eobj - -108390.0) < 20.0, f"E[obj] {eobj} != -108390 +- 20")
    check(np.allclose(xbar, [170.0, 80.0, 250.0], atol=0.5),
          f"xbar {xbar} != (170, 80, 250)")
    check(abs(triv - -115405.55) < 5.0, f"trivial bound {triv}")
    out = {"phase": "golden", "eobj": eobj, "trivial_bound": triv,
           "xbar": xbar.tolist(), "conv": conv,
           "ph_iterations": int(ph.state.it)}
    emit(out)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    t_all = time.time()
    from mpisppy_tpu_torch import disable_tictoc_output
    disable_tictoc_output()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    t = time.time()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": name, "nvidia_smi": smi, "s": time.time() - t})
    build_phase()
    t = time.time()
    rows = kernel_phase(name)
    emit({"phase": "kernel_done", "s": time.time() - t})
    t = time.time()
    sl = slice_phase()
    emit({"phase": "slice_done", "s": time.time() - t})
    t = time.time()
    bx = bf16x_phase()
    emit({"phase": "bf16x_done", "s": time.time() - t})
    t = time.time()
    golden_phase()
    emit({"phase": "golden_done", "s": time.time() - t,
          "total_s": time.time() - t_all})

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound", "blocks_per_sm", "waves")
    f32 = rows["float32"]
    emit({"kernels": [{
        "name": "pdhg_chunk", "route": "cuda",
        "source": "mpisppy_tpu_torch/csrc/pdhg_chunk.cu",
        "replaces": "mpisppy_tpu/ops/pallas_pdhg.py:106",
        "launches": sl["kernel_launches"],
        "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": None,
        "dtype": "float32", "share_of_bound": f32["share_of_bound"],
        "blocks_per_sm": f32["blocks_per_sm"], "waves": f32["waves"],
        "f64": {k: rows["float64"][k] for k in keys},
        "bf16": {**{k: rows["bfloat16"][k] for k in keys},
                 "launches": bx["launches_by_dtype"].get("bfloat16", 0)}}]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
