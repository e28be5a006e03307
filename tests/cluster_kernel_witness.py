"""Times the chunk kernel's cluster variants on the card, forced one by
one, at the shapes of the cluster kernel's rows (random inputs from a
seed, step sizes 0.9 / ||A||_2).  Not a test: it shows what
`ops.pdhg_chunk.pick_variant`'s rules rest on, the cluster size
against the rounds and rows it trades, and the streamed source's
stage rows.

    python tests/cluster_kernel_witness.py [--out FILE]
    python tests/cluster_kernel_witness.py --occupancy FILE

Needs the card (and nvcc for the first build).  Prints one JSON line a
variant: the shape, the storage dtype, the variant, the blocks per SM
and clusters the card holds at once, the kernel's ms at n_steps = 1
and 40 (mean of 10 calls queued behind a spin kernel), the relative
error against the plain version at n_steps = 40, and whether
`pick_variant` takes it; then the card's name and power limit.

With --occupancy it times nothing: it writes to FILE, as JSON, the
card's occupancy reading (blocks per SM, clusters held at once) of
every cluster variant `pick_variant` can weigh at OCCUPANCY_SHAPES
(resident where a band fits, else streamed, at each cluster size),
with the card's SM count, shared-memory limit, name and power limit:
the table tests/h100_occupancy.py gives the CPU tests of
`pick_variant`.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mpisppy_tpu_torch.ops import pdhg_chunk  # noqa: E402

V = pdhg_chunk.Variant
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
STREAMED_ROWS = (1, 4, 6, 7, 8)
# (S, M, N, storage dtypes, variants)
GRID = [
    ((4, 151, 268), (F64,), [V("resident", c) for c in (2, 4, 8, 16)]),
    ((12, 151, 268), (F32,), [V("resident", c) for c in (1, 4, 8, 16)]),
    ((1000, 121, 136), (F32,), [V("resident", c) for c in (1, 2, 4)]),
    ((1000, 121, 136), (F64,), [V("resident", c) for c in (1, 2, 3, 4)]),
    ((250, 174, 114), (F32, F64), [V("resident", c) for c in (1, 2, 4)]),
    ((3, 62, 150), (F32,), [V("resident", c) for c in (1, 2, 4, 7)]),
    ((3, 251, 314), (F32,), [V("resident", c) for c in (2, 4, 8, 16)]),
    ((10, 200, 1600), (F32,), [V("resident", 16)] + [
        V("streamed", 16, r) for r in (4, 8)]),
    ((10, 1552, 1600), (F32, BF16), [
        V("streamed", c, r) for c in (8, 12, 16) for r in STREAMED_ROWS]),
]
# (M, N) of every shape the CPU tests give pick_variant beyond the
# register tile, each in f32, f64 and bf16 storage
OCCUPANCY_SHAPES = [
    (9, 300), (40, 3000), (62, 150), (64, 129), (65, 128), (65, 129),
    (121, 136), (121, 240), (151, 268), (174, 114), (200, 200),
    (251, 314), (700, 900), (1552, 1600)]


def instance(S, M, N, dtype, seed=0):
    """A random chunk input: A with ~30% nonzeros, finite boxes, some
    infinite row lower bounds, step sizes 0.9 / ||A(s)||_2."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(S, M, N, generator=g, dtype=torch.float64)
    A[torch.rand(S, M, N, generator=g) < 0.7] = 0
    norm = torch.linalg.matrix_norm(A, ord=2).clamp(min=1e-3)
    rlo = -torch.rand(S, M, generator=g, dtype=torch.float64)
    rlo[torch.rand(S, M, generator=g) < 0.4] = -float("inf")
    vecs = (torch.randn(S, N, generator=g, dtype=torch.float64),
            torch.rand(S, N, generator=g, dtype=torch.float64) * 0.1,
            -5 * torch.rand(S, N, generator=g, dtype=torch.float64),
            5 * torch.rand(S, N, generator=g, dtype=torch.float64),
            rlo, torch.rand(S, M, generator=g, dtype=torch.float64),
            torch.randn(S, N, generator=g, dtype=torch.float64).clamp(-1, 1),
            0.1 * torch.randn(S, M, generator=g, dtype=torch.float64),
            0.9 / norm, 0.9 / norm)
    ct = pdhg_chunk.compute_dtype(dtype)
    return (A.to(dtype).cuda(),
            [t.to(ct).cuda().contiguous() for t in vecs])


def time_ms(fn, n=10):
    """Mean ms a call of `n` calls queued behind a spin kernel."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(8_000_000)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def nvidia_smi():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def occupancy_table(path):
    """Write the card's occupancy readings of every cluster variant
    pick_variant can weigh at OCCUPANCY_SHAPES to `path` (JSON)."""
    optin = pdhg_chunk.smem_optin()
    rows = []
    for M, N in OCCUPANCY_SHAPES:
        for dtype in (F32, F64, BF16):
            cb = pdhg_chunk.compute_dtype(dtype).itemsize
            sb = dtype.itemsize
            for C in range(1, pdhg_chunk.MAX_CLUSTER + 1):
                for v in (V("resident", C), pdhg_chunk._streamed(
                        C, M, N, cb, sb, optin)):
                    if v is None or v.smem_bytes(M, N, cb, sb) > optin:
                        continue
                    blocks, held = pdhg_chunk.variant_occupancy(
                        v, M, N, dtype)
                    rows.append([M, N, str(dtype).replace("torch.", ""),
                                 v.source, v.cluster, v.stage_rows,
                                 blocks, held])
    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": nvidia_smi(), "sms": pdhg_chunk.sm_count(),
           "smem_optin": optin,
           "columns": ["M", "N", "dtype", "source", "cluster",
                       "stage_rows", "blocks_per_sm", "active_clusters"],
           "rows": rows}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        # one row a line
        head = json.dumps({k: v for k, v in out.items() if k != "rows"})
        fh.write(head[:-1] + ', "rows": [\n')
        fh.write(",\n".join(json.dumps(r) for r in rows))
        fh.write("\n]}\n")
    print(json.dumps({k: out[k] for k in ("device", "nvidia_smi", "sms",
                                          "smem_optin")}
                     | {"rows": len(rows)}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(
        "build", "cluster_kernel_witness.jsonl"))
    ap.add_argument("--occupancy", metavar="FILE",
                    help="write the occupancy table to FILE instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cluster_kernel_witness: needs an NVIDIA card",
              file=sys.stderr)
        return 1
    if args.occupancy:
        occupancy_table(args.occupancy)
        return 0
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        def emit(d):
            line = json.dumps(d)
            print(line, flush=True)
            fh.write(line + "\n")

        for (S, M, N), dtypes, variants in GRID:
            for dtype in dtypes:
                A, vec = instance(S, M, N, dtype)
                picked = pdhg_chunk.card_variant(S, M, N, dtype)
                want = pdhg_chunk.fused_chunk_reference(A, *vec, 40)
                for v in variants:
                    row = {"shape": [S, M, N],
                           "dtype": str(dtype).replace("torch.", ""),
                           "variant": [v.source, v.cluster, v.stage_rows],
                           "picked": v == picked}
                    try:
                        row["blocks_per_sm"], row["active_clusters"] = \
                            pdhg_chunk.variant_occupancy(v, M, N, dtype)
                        got = pdhg_chunk.fused_chunk(A, *vec, 40, variant=v)
                        row["rel_err"] = max(
                            float((g - w).abs().max())
                            / max(1.0, float(w.abs().max()))
                            for g, w in zip(got, want))
                        for n in (1, 40):
                            row[f"ms_{n}"] = time_ms(
                                lambda: pdhg_chunk.fused_chunk(
                                    A, *vec, n, variant=v))
                    except (RuntimeError, ValueError) as e:
                        row["refused"] = str(e)
                    emit(row)
                emit({"shape": [S, M, N],
                      "dtype": str(dtype).replace("torch.", ""),
                      "picked": [picked.source, picked.cluster,
                                 picked.stage_rows]})
                del A, vec, want
        emit({"device": torch.cuda.get_device_name(0),
              "nvidia_smi": nvidia_smi()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
