#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mpisppy_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero):
  1. env      torch/CUDA versions, the card, nvidia-smi name + power limit
  2. build    nvcc build (or load) of csrc/pdhg_chunk.cu, and what ptxas
              reports for each of its 21 instantiated variants
              (registers, spills, stack); no variant may spill
  3. kernel   each form of the PDHG chunk kernel (dense (S, M, N),
              shared (1, M, N), split SplitA) against its plain torch
              version at the main paths' shapes (farmer S=1000,
              crops_multiplier=10: M=61, N=120; n_steps=40; inputs from
              the dense and the split prep) with A stored in f32, f64
              and bf16 (f32 vectors); the shared and split forms must
              equal the dense kernel on the assembled matrices exactly;
              timings, the bound, the variant, blocks per SM and waves
  4. slice    PH on farmer at full width (S=1000, crops_multiplier=10,
              f32, the bench's options with its dense prep,
              no_split_prep=True): Iter0, a few PH iterations, one xhat
              inner bound and one Lagrangian outer bound, the bench's
              gap loop and a profiled window; every solve must go
              through the kernel, and the (form, S, M, N, dtype) shapes
              it launched with are listed
  5. bf16x    the same farmer batch with pdhg_hot_dtype="bf16x": Iter0
              (promoted to full precision at pdhg_eps=1e-5), 2 PH
              iterations on the eps ladder in bf16 storage, one xhat and
              one Lagrangian bound
  6. split    farmer S=1000, cm=10, f32 with the bench's options and
              no_split_prep left out: the split prep, the gap loop to a
              verified 1% gap, launches by form and dtype (the split and
              shared forms must both launch), a profiled window
  7. true_size the true-size instance, crops_multiplier=1000 (M=6001,
              N=12000), f32, split-native, S cut from 1000 to TRUE_S:
              Iter0, 2 PH iterations, one xhat and one Lagrangian bound
              on the matmul route, Iter0's certified-feasible mass; peak
              device memory under 20 GB, the per-step time of the
              matmul route against its bound, a profiled PH iteration,
              and the gap loop's projected wall
  8. golden   farmer-3 in f64 through ph_main: E[obj] = -108390 +- 20,
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
# the true-size instance (bench.py:1229-1243): S=1000 scenarios at
# crops_multiplier=1000, split-native.  S is cut to 125 so that the
# script ends within half its time limit: on an NVIDIA H100 80GB HBM3 at
# 700 W, Iter0 alone took 719 s at S=1000 (f32 to its 30,000-iteration
# cap, then the f64 certify of its stragglers) and the phase 469 s at
# S=250.  crops_multiplier, pdhg_eps and pdhg_max_iters stay the bench's.
TRUE_S, TRUE_CM, TRUE_PH_ITERS = 125, 1000, 2
# the bench's options (bench.py:1252-1294) for farmer, with the dense
# per-scenario prep of its accelerator row at the CPU-fallback size
# (cm=10); SPLIT_OPTS leave out no_split_prep, so farmer's declared
# A_delta_idx selects the split prep (the bench's BENCH_SPLIT=1 row)
SLICE_OPTS = {"defaultPHrho": 1.0, "PHIterLimit": PH_ITERS,
              "convthresh": 0.0, "pdhg_eps": 1e-5, "superstep_eps": 1e-4,
              "lagrangian_eps": 1e-4, "pdhg_max_iters": 30000,
              "no_split_prep": True,
              "eps_ladder": {"start": 1e-3, "min": 1e-4, "couple": 0.1},
              "pdhg_hot_dtype": "f32"}
SPLIT_OPTS = {k: v for k, v in SLICE_OPTS.items() if k != "no_split_prep"}

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
    lane, warps, source of A: 0 registers / 1 shared / 2 global, form
    of A: 0 dense / 1 shared / 2 split, min blocks per SM), registers,
    stack, spill stores and loads."""
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


# template arguments of the main path's f32 variant (all but min blocks):
# storage, compute, R, V, W, source (0 registers), form (0 dense)
MAIN_F32 = ["float", "float", "8", "1", "8", "0", "0"]


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
        if not args or args[:7] != MAIN_F32:
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
    # for each of f32, f64 and bf16: the dense form with A in registers,
    # shared or global memory, and the shared and split forms with A in
    # registers or shared memory
    check(len(report) == 21, f"ptxas reported {len(report)} kernels")
    main = [k for k in report
            if k["variant"].split(", ")[:7] == MAIN_F32]
    check(len(main) == 1, "no ptxas line for the main path's f32 variant")
    for k in report:
        check(k.get("spill_stores", 1) == 0 and k.get("spill_loads", 1) == 0,
              f"a variant spills: {k}")
    emit({"phase": "build", "library": str(lib), "s": time.time() - t,
          "ptxas": report, "main_f32_step_loop": sass_summary(lib)})


def solver_space_inputs(dtype, split=False):
    """The chunk's inputs as PDHGSolver builds them for farmer S=1000,
    crops_multiplier=10 (Ruiz-scaled prep, cold start, omega=1): from
    the dense prep, or with split=True from the split prep of farmer's
    default options (A is then a SplitA)."""
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops.pdhg import prepare_batch, prepare_batch_split
    b = farmer.build_batch(S, crops_multiplier=CM,
                           dtype=np.float32 if dtype == torch.float32
                           else np.float64)
    if split:
        p = prepare_batch_split(b.A, *b.model_meta["A_delta_idx"],
                                b.row_lo, b.row_hi)
    else:
        p = prepare_batch(b.A, b.row_lo, b.row_hi)
    dc = p.d_col
    qs = b.qdiag * dc * dc
    lbs = b.lb / dc
    ubs = torch.where(torch.isfinite(b.ub), b.ub / dc, b.ub)
    # a warm, non-trivial start: the box midpoint clipped
    x = torch.clamp(0.5 * (lbs + torch.clamp(ubs, max=1e3)), min=0.0)
    y = torch.zeros_like(p.row_lo)
    tau = 0.9 / (p.anorm + 0.9 * qs.amax(dim=1))
    sigma = (0.9 / p.anorm).expand(tau.shape)
    vec = [t.contiguous() for t in (b.c * dc, qs, lbs, ubs, p.row_lo,
                                    p.row_hi, x, y, tau, sigma)]
    return [p.A.contiguous()] + vec


def chunk_bytes(A, vec):
    """Bytes the chunk must move: each input read once (A at its storage
    width, a shared matrix once for all scenarios, a SplitA's shared
    block once plus its per-scenario values and coordinates), each
    output written once."""
    from mpisppy_tpu_torch.ir import SplitA
    if isinstance(A, SplitA):
        a = (A.shared.numel() * A.shared.element_size()
             + A.vals.numel() * A.vals.element_size()
             + 2 * A.rows.numel() * A.rows.element_size())
    else:
        a = A.numel() * A.element_size()
    vin = sum(t.numel() * t.element_size() for t in vec)
    vout = 2 * (vec[6].numel() + vec[7].numel()) * vec[6].element_size()
    return a + vin + vout


def kernel_phase(name):
    """Each form of the chunk kernel at the main paths' shapes, in f32,
    f64 and bf16 storage: error against its plain version; for the
    shared and split forms also against the dense kernel on the
    assembled matrices (must be 0); time, bound and occupancy."""
    import torch

    from mpisppy_tpu_torch.ops import pdhg_chunk
    peak_name, (bw, f32_peak, f64_peak) = peaks(name)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    base = {False: solver_space_inputs(torch.float32),
            True: solver_space_inputs(torch.float32, split=True)}
    rows = {}
    for store, peak in ((torch.float32, f32_peak),
                        (torch.float64, f64_peak),
                        (torch.bfloat16, f32_peak)):
        dname = str(store).replace("torch.", "")
        for form in pdhg_chunk.FORMS:
            split = form != "dense"
            if store == torch.float64:
                args = solver_space_inputs(torch.float64, split=split)
            else:
                args = list(base[split])
                args[0] = args[0].astype(store) if split \
                    else args[0].to(store)
            A, vec = args[0], args[1:]
            if form == "shared":
                # the split prep's shared block as one matrix for all
                A = A.shared[None].contiguous()
            ref = pdhg_chunk.REFERENCE[form]
            got = pdhg_chunk.fused_chunk(A, *vec, N_STEPS)
            torch.cuda.synchronize()
            want = ref(A, *vec, N_STEPS)
            err_abs = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
            err_rel = max(float((g - w).abs().max())
                          / max(1.0, float(w.abs().max()))
                          for g, w in zip(got, want))
            for g in got:
                check(bool(torch.isfinite(g).all()),
                      f"{form} {dname} kernel output not finite")
            check(err_rel <= TOL[dname],
                  f"{form} {dname} kernel disagrees with its plain version:"
                  f" {err_rel:.3e} > {TOL[dname]:.0e}")
            vs_dense = None
            if form != "dense":
                dense = (A.expand(S, -1, -1) if form == "shared"
                         else A.to_dense()).contiguous()
                d = pdhg_chunk.fused_chunk(dense, *vec, N_STEPS)
                vs_dense = max(float((g - w).abs().max())
                               for g, w in zip(got, d))
                check(vs_dense == 0.0,
                      f"{form} {dname} kernel differs from the dense kernel "
                      f"on the assembled matrices by {vs_dense}")

            def call():
                return pdhg_chunk.fused_chunk(A, *vec, N_STEPS)

            ms = time_ms(call, queue_behind_sleep=True)
            wrapper_us = host_us(call)
            plain_ms = time_ms(lambda: ref(A, *vec, N_STEPS))
            _, M, N = A.shape
            nbytes = chunk_bytes(A, vec)
            # FLOP at the compute type's peak (bf16 storage computes in
            # f32): the two matvecs and the elementwise updates
            flops = N_STEPS * S * (4 * M * N + 10 * N + 8 * M)
            t_bytes = nbytes / bw * 1e3
            t_ops = flops / peak * 1e3
            bound = max(t_bytes, t_ops)
            variant, blocks = pdhg_chunk.occupancy(M, N, store, form)
            rows[(form, dname)] = {
                "form": form, "dtype": dname, "S": S, "M": M, "N": N,
                "n_steps": N_STEPS, "max_abs_err": err_abs,
                "max_rel_err": err_rel, "tol_rel": TOL[dname],
                "max_abs_err_vs_dense_kernel": vs_dense,
                "ms": ms, "wrapper_host_us": wrapper_us,
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
            emit({"phase": "kernel", **rows[(form, dname)]})
    return rows


def reset_counts():
    """Zero the kernel's launch counts and the matmul route's chunk
    count (just before a path is driven)."""
    from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
    pdhg_chunk.launches = 0
    pdhg_chunk.launch_shapes.clear()
    pdhg.matmul_chunks = 0


def launch_table():
    """The (form, S, M, N, dtype) tuples the kernel launched with since
    the last reset_counts(), with their counts."""
    from mpisppy_tpu_torch.ops import pdhg_chunk
    return [{"form": k[0], "S": k[1], "M": k[2], "N": k[3], "dtype": k[4],
             "launches": n}
            for k, n in sorted(pdhg_chunk.launch_shapes.items())]


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


def split_phase():
    """Path (a): farmer S=1000, cm=10, f32 with the bench's options and
    `no_split_prep` left out (its BENCH_SPLIT=1 row at the fallback
    size).  The delta-split prep feeds the PH supersteps through the
    kernel's split form and the shared (1, M, N) xhat system through its
    shared form.  The bench's gap loop to a verified 1% gap, then a
    profiled window of 2 PH iterations."""
    import torch

    from mpisppy_tpu_torch.ir import SplitA
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
    from mpisppy_tpu_torch.opt.ph import PH
    opts = dict(SPLIT_OPTS)
    torch.cuda.reset_peak_memory_stats()
    b = farmer.build_batch(S, crops_multiplier=CM, dtype=np.float32)
    reset_counts()                    # count this path's run only
    t0 = time.time()
    gap = gap_loop(PH, opts, b)
    ph = gap.pop("ph")
    check(isinstance(ph.prep.A, SplitA), "the default prep is not split")
    check(tuple(ph.prep.d_row.shape) == (1, b.num_rows),
          f"the split prep's d_row is {tuple(ph.prep.d_row.shape)}")
    by_form = pdhg_chunk.launches_by("form")
    by_form_dtype = pdhg_chunk.launches_by("form/dtype")
    shapes = launch_table()
    matmul = pdhg.matmul_chunks
    check(by_form.get("split", 0) > 0, "the split form never launched")
    check(by_form.get("shared", 0) > 0, "the shared form never launched")
    check(matmul == 0, f"{matmul} chunks took the matmul route at cm=10")
    wall = time.time() - t0
    gap["profile"] = profile_window(ph)
    for f, v in vars(ph.state).items():
        if torch.is_tensor(v):
            check(v.device.type == "cuda", f"state.{f} is on {v.device}")
    out = {"phase": "split", "S": S, "crops_multiplier": CM,
           "dtype": "float32", "prep": "delta-split (no no_split_prep)",
           "launches_by_form": by_form,
           "launches_by_form_dtype": by_form_dtype,
           "launch_shapes": shapes, "matmul_chunks": matmul,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "wall_s": wall, "gap_loop": gap,
           "pdhg_stats": ph.pdhg_stats()}
    emit(out)
    return out


def true_size_phase(name, split_gap):
    """Path (b): the true-size instance, farmer crops_multiplier=1000
    (M=6001, N=12000 per scenario), f32, born split-native, with the
    bench's options: Iter0, PH iterations, one xhat inner bound and one
    Lagrangian outer bound.  Its operator is too large for the kernel's
    tile, so its solves take the matmul route; no (S, M, N) tensor
    exists (the dense one would be ~288 GB at S=1000).  TRUE_S is the
    scenario count (1000 uncut)."""
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg, pdhg_chunk
    from mpisppy_tpu_torch.opt.ph import PH
    peak_name, (bw, f32_peak, _) = peaks(name)
    # under the bench's iteration caps Iter0 leaves part of the
    # probability mass primal-infeasible at this size (0.785 feasible at
    # S=1000): the run goes on with that mass reported, as the option
    # allows, so that the rest of the path is driven and checked
    opts = dict(SPLIT_OPTS, PHIterLimit=TRUE_PH_ITERS,
                iter0_infeasibility_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                    # count this path's run only
    t0 = time.time()
    b = farmer.build_batch(TRUE_S, crops_multiplier=TRUE_CM,
                           dtype=np.float32)
    check(b.split_A, "the true-size batch is not split-native")
    ph = PH(opts, [f"scen{i}" for i in range(TRUE_S)], batch=b)
    torch.cuda.synchronize()
    steps = [{"step": "setup (build + split prep)", "s": time.time() - t0}]

    def timed(step, fn):
        n0, m0 = pdhg_chunk.launches_by("form/dtype"), pdhg.matmul_chunks
        c0, t = ph._certify_wall, time.time()
        out = fn()
        torch.cuda.synchronize()
        n1 = pdhg_chunk.launches_by("form/dtype")
        steps.append({
            "step": step, "s": time.time() - t,
            "certify_s": ph._certify_wall - c0,
            "matmul_chunks": pdhg.matmul_chunks - m0,
            "kernel_launches": {k: n1[k] - n0.get(k, 0) for k in n1
                                if n1[k] != n0.get(k, 0)},
            "solve_iters": int(ph.state.solve_iters)
            if ph.state is not None else None})
        emit({"phase": "true_size_step", **steps[-1]})
        return out

    trivial = timed("iter0", ph.Iter0)
    for k in range(TRUE_PH_ITERS):
        timed(f"ph_iteration_{k + 1}", ph.ph_iteration)
    inner, feas = timed("evaluate_xhat", lambda: ph.evaluate_xhat(
        ph.root_xbar()))
    outer = timed("lagrangian_bound", ph.lagrangian_bound)
    wall = time.time() - t0
    peak_mem = torch.cuda.max_memory_allocated()
    path_chunks = pdhg.matmul_chunks     # before the timing calls below
    for f, v in vars(ph.state).items():
        if torch.is_tensor(v):
            check(v.device.type == "cuda", f"state.{f} is on {v.device}")
    check(all(np.isfinite([trivial, inner, outer])),
          f"true-size bounds not finite: {trivial}, {inner}, {outer}")
    check(feas, "true-size xhat candidate infeasible")
    check(max(trivial, outer) <= inner + 1e-6 * abs(inner),
          f"true-size outer bound above inner: {max(trivial, outer)} > "
          f"{inner}")
    check(peak_mem < 20e9, f"true-size peak device memory {peak_mem}")
    check(path_chunks > 0, "the true-size path ran no matmul chunk")
    straggler = single_straggler_check(ph)

    # one matmul-route chunk alone, on the solver-space data of the prep
    p = ph.prep
    dc = p.d_col
    vec = [b.c * dc, b.qdiag * dc * dc, b.lb / dc,
           torch.where(torch.isfinite(b.ub), b.ub / dc, b.ub),
           p.row_lo, p.row_hi]
    x, y = torch.zeros_like(b.c), torch.zeros_like(p.row_lo)
    tau = 0.9 / (p.anorm + 0.9 * vec[1].amax(dim=1))
    sigma = (0.9 / p.anorm).expand(tau.shape)
    chunk_ms = time_ms(lambda: pdhg.matmul_chunk(p.A, *vec, x, y, tau,
                                                 sigma, N_STEPS),
                       reps=3, batch=1, warmup=1)
    M, N = b.num_rows, b.num_vars
    step_flops = 2 * 2 * TRUE_S * M * N
    step_bound = step_flops / f32_peak * 1e3
    prof = profile_window(ph, n=1)
    out = {"phase": "true_size", "S": TRUE_S, "crops_multiplier": TRUE_CM,
           "M": M, "N": N, "dtype": "float32", "split_native": True,
           "cut": (None if TRUE_S == 1000 else
                   f"S cut from 1000 to {TRUE_S} to end within half the "
                   f"smoke's time limit; crops_multiplier, pdhg_eps and "
                   f"pdhg_max_iters as the bench"),
           "options_beyond_the_bench": {"iter0_infeasibility_ok": True},
           "iter0_feasible_mass": ph.iter0_feas_mass,
           "ph_iterations": TRUE_PH_ITERS, "trivial_bound": trivial,
           "inner_bound": inner, "outer_bound": outer, "conv": ph.conv,
           "rel_gap": (inner - max(trivial, outer)) / abs(inner),
           "wall_s": wall, "steps": steps,
           "max_memory_allocated": peak_mem,
           "dense_A_bytes": 4 * TRUE_S * M * N,
           "matmul_chunks": path_chunks,
           "kernel_launches": pdhg_chunk.launches_by("form/dtype"),
           "matmul_chunk_ms": chunk_ms,
           "matmul_step_ms": chunk_ms / N_STEPS,
           "matmul_step_bound_ms": step_bound,
           "matmul_step_bound_by": "operations",
           "matmul_step_share_of_bound": step_bound / (chunk_ms / N_STEPS),
           "peaks": {"card": peak_name, "flops_per_s": f32_peak},
           "profile_1_ph_iteration": prof,
           "single_straggler_f64": straggler,
           "pdhg_stats": ph.pdhg_stats()}
    # what the bench's gap loop would take here: Iter0, then as many PH
    # iterations and bound checks as the cm=10 split gap loop needed (an
    # assumption: the loop's PH iteration count at cm=1000 is not
    # measured)
    it = [st["s"] for st in steps if st["step"].startswith("ph_iteration")]
    per_check = steps[-2]["s"] + steps[-1]["s"]
    out["gap_loop_projection_s"] = (
        steps[1]["s"] + split_gap["iters"] * statistics.mean(it)
        + split_gap["bound_checks"] * per_check)
    out["gap_loop_projection_basis"] = (
        "iter0 + (PH iterations of the cm=10 split gap loop, assumed for "
        "cm=1000, not measured) x mean PH iteration wall here + (its "
        "bound checks) x (xhat + Lagrangian wall here); not run")
    emit(out)
    return out


def single_straggler_check(ph):
    """The float64 re-solve of one straggler on the xhat's reduced
    system, as `_certified_resolve` gathers it: the shared (1, M, N)
    matrix keeps its form at S=1 (the kernel cannot take it: its state
    alone exceeds shared memory), so the solve takes the matmul route.
    Two chunks: the route, not the verdict, is checked."""
    import torch

    from mpisppy_tpu_torch.ops import pdhg
    f64 = torch.float64
    b, xc = ph.batch, ph._xhat_cache(None)
    full = pdhg.prepare_batch(xc["A_red"].to(f64), b.row_lo.to(f64),
                              b.row_hi.to(f64))
    one = pdhg._gather_prep(full, torch.tensor([0], device=b.c.device))
    check(tuple(one.A.shape) == (1, b.num_rows, b.num_vars),
          f"the gathered f64 xhat operator is {tuple(one.A.shape)}")
    m0, t = pdhg.matmul_chunks, time.time()
    res = pdhg.PDHGSolver(max_iters=2 * N_STEPS, eps=1e-5).solve(
        one, *(xc[k][:1].to(f64) for k in ("c_red", "q_red", "lb_red",
                                           "ub_red")))
    torch.cuda.synchronize()
    chunks = pdhg.matmul_chunks - m0
    check(chunks == int(res.iters) // N_STEPS > 0,
          f"the S=1 f64 xhat re-solve ran {chunks} matmul chunks for "
          f"{int(res.iters)} iterations")
    check(bool(torch.isfinite(res.x).all() & torch.isfinite(res.y).all()),
          "the S=1 f64 xhat re-solve is not finite")
    del full
    return {"S": 1, "A_shape": list(one.A.shape), "dtype": "float64",
            "iters": int(res.iters), "matmul_chunks": chunks,
            "s": time.time() - t}


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
    # the matmul route's matrix products (cuBLAS / CUTLASS GEMM kernels)
    gemm = sum(v[1] for k, v in by_name.items()
               if re.search(r"gemm|xmma|cutlass", k, re.I))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"ph_iterations": n, "wall_us": wall_us, "device_busy_us": busy,
            "idle_share": (1.0 - busy / wall_us) if busy else None,
            "chunk_kernel_us": chunk, "chunk_kernel_launches": chunk_n,
            "chunk_share_of_busy": (chunk / busy) if busy else None,
            "gemm_us": gemm,
            "gemm_share_of_busy": (gemm / busy) if busy else None,
            "other_share_of_busy": ((busy - gemm - chunk) / busy)
            if busy else None,
            "device_events": sum(v[0] for v in by_name.values()),
            "top": [{"name": k[:60], "count": v[0], "us": v[1]}
                    for k, v in top]}


def bf16x_phase():
    """This slice's own path: farmer S=1000, cm=10, f32 batch, the
    slice's options with A stored in bf16 in the hot loop."""
    import torch

    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg_chunk
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
        n0, t = pdhg_chunk.launches_by("dtype"), time.time()
        out = fn()
        torch.cuda.synchronize()
        n1 = pdhg_chunk.launches_by("dtype")
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
    by_dtype = pdhg_chunk.launches_by("dtype")
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
    sp = split_phase()
    emit({"phase": "split_done", "s": time.time() - t})
    t = time.time()
    true_size_phase(name, sp["gap_loop"])
    emit({"phase": "true_size_done", "s": time.time() - t})
    t = time.time()
    golden_phase()
    emit({"phase": "golden_done", "s": time.time() - t,
          "total_s": time.time() - t_all})

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "share_of_bound", "blocks_per_sm", "waves")
    # launches: the dense form's on the slice phase (path of the dense
    # prep), its bf16 storage's on the bf16x phase, the shared and split
    # forms' on the split phase; each count was zeroed just before its
    # path ran
    launched = {"dense": (sl["kernel_launches"],
                          bx["launches_by_dtype"].get("bfloat16", 0)),
                "shared": (sp["launches_by_form"].get("shared", 0),
                           None),
                "split": (sp["launches_by_form"].get("split", 0), None)}
    kernels = []
    for form in ("dense", "shared", "split"):
        f32 = rows[(form, "float32")]
        entry = {
            "name": "pdhg_chunk" if form == "dense"
            else f"pdhg_chunk_{form}",
            "route": "cuda",
            "source": "mpisppy_tpu_torch/csrc/pdhg_chunk.cu",
            "replaces": "mpisppy_tpu/ops/pallas_pdhg.py:106",
            "launches": launched[form][0],
            "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
            "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
            "bound_by": f32["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes a chunk of "
                            "PDHG steps",
            "form": form, "dtype": "float32",
            "share_of_bound": f32["share_of_bound"],
            "blocks_per_sm": f32["blocks_per_sm"], "waves": f32["waves"],
            "f64": {k: rows[(form, "float64")][k] for k in keys},
            "bf16": {k: rows[(form, "bfloat16")][k] for k in keys}}
        if form != "dense":
            entry["max_abs_err_vs_dense_kernel"] = {
                d: rows[(form, d)]["max_abs_err_vs_dense_kernel"]
                for d in ("float32", "float64", "bfloat16")}
        else:
            entry["bf16"]["launches"] = launched[form][1]
        check(entry["launches"] > 0, f"the {form} form launched no time "
              f"on its path")
        kernels.append(entry)
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
