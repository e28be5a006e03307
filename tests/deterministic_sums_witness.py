"""Times and checks the fixed-order sums of the PH superstep on the card
(`ir.node_segment_sum` by `index_put_` with accumulate, the SplitA
matvecs' deltas layer by layer) against the atomic `index_add_` they
replace.

    python tests/deterministic_sums_witness.py [--scens 1000 --cm 10]

On one CUDA card: farmer at S scenarios, crops_multiplier cm, f32, the
split prep; Iter0, then `--iters` PH supersteps timed one by one (CUDA
synchronized), with the fixed-order sums and then with the atomic ones
patched back in, in alternation; and two f64 farmer-100 PH runs of 8
iterations each way, whether W comes out bit-equal; and the segment
sum of farmer S's (S, 3) nonants (random values, f32 and f64) twice on
the card and once on the CPU: whether the card repeats its bits and how
far it is from the CPU's `index_add_` (`--sums-only` does this alone).
Prints one JSON line.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpisppy_tpu_torch import disable_tictoc_output, ir, phbase  # noqa: E402
from mpisppy_tpu_torch.models import farmer  # noqa: E402
from mpisppy_tpu_torch.opt.ph import PH  # noqa: E402


def atomic_segment_sum(node_of, num_nodes):
    """`ir.node_segment_sum` as it added before: `index_add_` (atomics
    on CUDA)."""
    K = node_of.shape[1]
    cols = torch.arange(K, device=node_of.device).expand(node_of.shape)
    flatid = node_of.long() * K + cols
    fl = flatid.reshape(-1)
    size = int(num_nodes) * K

    def segsum(v):
        z = torch.zeros((size,), dtype=v.dtype, device=v.device)
        z.index_add_(0, fl, v.reshape(-1))
        return z[flatid]

    return flatid, segsum


def atomic_index_add(out, index, src):
    return out.index_add_(1, index, src)


class Atomic:
    """Patch the atomic sums in for the duration of a with-block."""

    def __enter__(self):
        self.saved = (ir.node_segment_sum, ir._ordered_index_add,
                      phbase.node_segment_sum)
        ir.node_segment_sum = phbase.node_segment_sum = atomic_segment_sum
        ir._ordered_index_add = atomic_index_add

    def __exit__(self, *exc):
        (ir.node_segment_sum, ir._ordered_index_add,
         phbase.node_segment_sum) = self.saved


def segment_sums_vs_cpu(scens, cm):
    """{dtype: repeatable on the card, max |card - CPU|} of
    `ir.node_segment_sum` over farmer's two-stage tree."""
    b = farmer.build_batch(scens, crops_multiplier=cm, device="cpu")
    node_of = b.tree.node_of
    out = {}
    for dt in (torch.float32, torch.float64):
        v = torch.as_tensor(np.random.default_rng(0).standard_normal(
            tuple(node_of.shape)) * 100.0, dtype=dt)
        cpu = ir.node_segment_sum(node_of, b.tree.num_nodes)[1](v)
        seg = ir.node_segment_sum(node_of.cuda(), b.tree.num_nodes)[1]
        a, c = seg(v.cuda()), seg(v.cuda())
        out[str(dt).replace("torch.", "")] = {
            "card_same_bits_twice": bool(torch.equal(a, c)),
            "max_abs_card_vs_cpu": float((a.cpu() - cpu).abs().max()),
            "bit_equal_to_cpu": bool(torch.equal(a.cpu(), cpu))}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scens", type=int, default=1000)
    ap.add_argument("--cm", type=int, default=10)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--sums-only", action="store_true")
    args = ap.parse_args()
    disable_tictoc_output()
    sums = segment_sums_vs_cpu(args.scens, args.cm)
    if args.sums_only:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "scens": args.scens, "segment_sum": sums}))
        return
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 1000, "convthresh": 0.0,
            "pdhg_eps": 1e-5, "superstep_eps": 1e-4,
            "pdhg_max_iters": 30000}
    ph = PH(opts, [f"scen{i}" for i in range(args.scens)],
            batch=farmer.build_batch(args.scens, crops_multiplier=args.cm,
                                     dtype=np.float32))
    ph.Iter0()
    times = {"fixed_order": [], "atomic": []}
    for _ in range(args.iters):
        for mode in ("fixed_order", "atomic"):
            st = ph.state
            torch.cuda.synchronize()
            t = time.perf_counter()
            if mode == "atomic":
                with Atomic():
                    ph.ph_iteration()
            else:
                ph.ph_iteration()
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t)
            ph.state = st              # the same superstep each way
    ck = {"defaultPHrho": 1.0, "PHIterLimit": 8, "convthresh": 0.0,
          "pdhg_eps": 1e-7}
    same = {}
    for mode in ("fixed_order", "atomic"):
        Ws = []
        for _ in range(2):
            with (Atomic() if mode == "atomic" else _Null()):
                p = PH(ck, [f"scen{i}" for i in range(100)],
                       batch=farmer.build_batch(100))
                p.ph_main(finalize=False)
            Ws.append(p.state.W)
        same[mode] = {"bit_equal": bool(torch.equal(Ws[0], Ws[1])),
                      "max_abs_diff_W": float((Ws[0] - Ws[1]).abs().max())}
    med = {k: statistics.median(v) for k, v in times.items()}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "scens": args.scens,
        "crops_multiplier": args.cm, "superstep_s": times,
        "median_s": med,
        "cost_fraction": med["fixed_order"] / med["atomic"] - 1.0,
        "f64_farmer100_two_runs": same, "segment_sum": sums}))


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


if __name__ == "__main__":
    main()
