"""FLOP accounting and MFU estimation for the batched solver (port of
`mpisppy_tpu/utils/mfu.py`).

`SPOpt.solve_loop` accumulates matvec FLOPs with `pdhg_flops`;
`solve_stats()` reports them over the solve wall as `mfu`, and
`record_to_registry` mirrors them into the telemetry registry.

Peaks are dtype-aware:

- CUDA: the NVIDIA H100 data-sheet rates, dense, without the tensor
  cores: the solver runs FP32 (TF32 is off, `device.py`) and FP64 on
  the CUDA cores, and bfloat16 storage ("bf16x") computes in f32, so it
  is held to the f32 rate.  A card that is not an H100 is held to the
  SXM rates.
- CPU: estimated from the host core count x a nominal frequency x SIMD
  FLOPs per cycle (AVX2 + FMA class: 32 f32, 16 f64 FLOPs per
  core-cycle; bf16 at the f32 rate).  A relative signal only.

Environment overrides, with the JAX package's names: TPU_PEAK_FLOPS
wins on every backend, CPU_PEAK_FLOPS on the host.
"""

from __future__ import annotations

import os

# NVIDIA H100 data-sheet rates (dense, no sparsity) by card-name key,
# checked in order: (memory bytes/s, FP32 non-tensor FLOP/s, FP64
# non-tensor FLOP/s).  chip_smoke.py bounds its kernels with them too.
CUDA_PEAKS = {
    "H100 PCIe": (2.0e12, 51.2e12, 25.6e12),
    "H100": (3.35e12, 67e12, 34e12),          # SXM
}

_CPU_FLOPS_PER_CYCLE = {"float32": 32.0, "float64": 16.0,
                        "bfloat16": 32.0}
_CPU_NOMINAL_HZ = 2.5e9


def _dtype_name(dtype):
    s = str(dtype)
    if "bf16" in s or "bfloat16" in s:
        return "bfloat16"
    if "64" in s:
        return "float64"
    return "float32"


def cpu_peak_flops(dtype="float32"):
    """Estimated aggregate peak FLOP/s of this host for `dtype`.
    Override with env CPU_PEAK_FLOPS (total, not per core)."""
    env = os.environ.get("CPU_PEAK_FLOPS")
    if env:
        return float(env)
    cores = os.cpu_count() or 1
    return cores * _CPU_NOMINAL_HZ * _CPU_FLOPS_PER_CYCLE[_dtype_name(dtype)]


def cuda_peaks(name):
    """(key, (bytes/s, f32 FLOP/s, f64 FLOP/s)) of the card called
    `name`; a card that is not an H100 is held to the SXM rates."""
    for key, peaks in CUDA_PEAKS.items():
        if key in name:
            return key, peaks
    return "H100", CUDA_PEAKS["H100"]


def cuda_peak_flops(name, dtype="float32"):
    """Peak FLOP/s of the card called `name` at `dtype`."""
    _, (_, f32, f64) = cuda_peaks(name)
    return f64 if _dtype_name(dtype) == "float64" else f32


def device_peak_flops(device=None, dtype="float32"):
    """Peak FLOP/s for `device` (a torch.device or its name; default
    the CUDA device) at `dtype`.  TPU_PEAK_FLOPS wins on every backend,
    CPU_PEAK_FLOPS on the host.  Never None."""
    env = os.environ.get("TPU_PEAK_FLOPS")
    if env:
        return float(env)
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return cpu_peak_flops(dtype)
    return cuda_peak_flops(torch.cuda.get_device_name(dev), dtype)


def pdhg_flops(iters, S, M, N, check_every=40, density=1.0):
    """FLOPs of `iters` PDHG iterations over an (S, M, N) batch: two
    batched matvecs per inner iteration (2*S*M*N FLOP each, one FLOP
    per multiply and per add), plus the KKT check's two matvecs every
    `check_every` iterations.  `density` debits the model when the
    shared block's products go through the sparse product
    (ir.SparseSplitA): they touch only its stored entries."""
    per_iter = 4.0 * S * M * N * density
    checks = 4.0 * S * M * N * density / max(check_every, 1)
    return float(iters) * (per_iter + checks)


def mfu(flops, wall_seconds, device=None, dtype="float32"):
    """Model FLOP utilization in [0, 1], or None when the wall time is
    degenerate."""
    peak = device_peak_flops(device, dtype)
    if peak is None or wall_seconds <= 0:
        return None
    return flops / wall_seconds / peak


def record_to_registry(registry, flops, wall_seconds, kernel_iters=None,
                       device=None, dtype="float32"):
    """Mirror the accumulated FLOP, wall and MFU numbers into the
    telemetry registry as gauges.  A no-op on a disabled registry, so
    callers may call it unconditionally."""
    if not getattr(registry, "enabled", False):
        return
    registry.gauge("mfu.kernel_flops").set(flops)
    registry.gauge("mfu.solve_wall_seconds").set(wall_seconds)
    if kernel_iters is not None:
        registry.gauge("mfu.kernel_iters").set(kernel_iters)
        if wall_seconds > 0:
            registry.gauge("mfu.iters_per_sec").set(
                kernel_iters / wall_seconds)
    u = mfu(flops, wall_seconds, device, dtype)
    if u is not None:
        registry.gauge("mfu.mfu").set(u)
