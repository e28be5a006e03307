"""Shows how the chunk kernel's register source compiles against an
earlier revision of `csrc/pdhg_chunk.cu`: the SASS of every
`pdhg_chunk_tiled` instantiation (A held in registers: 3 forms x f32,
f64 and bf16 storage) in the library built from this checkout, against
the same instantiation built from the earlier source with the same nvcc
flags.  Revisions whose template had a source parameter (always 0,
registers) are matched on the other arguments.

    git show <commit>:mpisppy_tpu_torch/csrc/pdhg_chunk.cu > build/old.cu
    python tests/register_sass_witness.py --parent build/old.cu

Needs nvcc and cuobjdump (no card).  Prints one JSON line a kernel
(its template arguments, form, instruction count, equal or not, and
the instructions only one of the two builds has) and a summary line.
Exits 1 unless every register kernel of this checkout is in the
earlier build and equal to it.  With `--grouped-bases` (against a
revision before the shared and split forms read matrix s / per_base,
one matrix per request of a coalesced group) the dense kernels must
still be equal, and each shared and split kernel may differ only in
its prologue, by the address of its request's matrix: its step loop
(the backward branch whose body holds the most barriers) has as many
instructions as the earlier one's, of which at most GROUPED_LOOP_SWAPS
differ once register numbers, predicates, reuse flags and branch
targets are renamed away (`normalized`; in any order, as the scheduler
may place them), and it has at most GROUPED_MAX_LINES instructions
more in all.  Instruction addresses are dropped before the comparison;
the encodings are kept in the exact comparison.
"""

import argparse
import collections
import difflib
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mpisppy_tpu_torch.ops import pdhg_chunk  # noqa: E402

# the mangled template arguments of a register instantiation:
# <TS, T, R, V, W, FORM, MINB>, or in earlier revisions <TS, T, R, V, W,
# SRC = 0, FORM, MINB>; the key drops the source
_TILED = re.compile(
    r"pdhg_chunk_tiledI(\w+?)Li8ELi1ELi8E(?:Li0E)?(Li(\d)ELi\dE)E")
#: how many instructions the grouped-base addressing may add
GROUPED_MAX_LINES = 40
#: how many step-loop instructions may differ (another register bank's
#: form of the same operation, say) under the grouped-base addressing
GROUPED_LOOP_SWAPS = 8
FORMS = ("dense", "shared", "split")


def build(src, out):
    """nvcc `src` into the shared library `out` with the kernel's own
    flags."""
    cmd = [pdhg_chunk._nvcc(), *pdhg_chunk._NVCC_FLAGS, "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return out


def normalized(lines):
    """Instruction text without encodings, register numbers, predicate
    numbers and branch targets: what a change of register allocation
    leaves the same."""
    out = []
    for line in lines:
        line = re.sub(r"/\*.*?\*/", "", line).strip()
        if not line:
            continue
        line = re.sub(r"\bU?R\d+\b", "R", line).replace(".reuse", "")
        line = re.sub(r"\bU?P\d\b", "P", line)
        line = re.sub(r"\b0x[0-9a-f]+\b", "0x", line)
        out.append(line)
    return out


def step_loop(lines):
    """The normalized body of the backward branch whose body holds the
    most barriers (the kernel's step loop)."""
    ins = []
    for line in lines:
        m = re.match(r"/\*([0-9a-f]{4,})\*/\s+(.*)", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    best = (0, [])
    for addr, i in ins:
        m = re.search(r"BRA\s+(?:\S+,\s*)?0x([0-9a-f]+)", i)
        if m and int(m.group(1), 16) < addr:
            body = [j for b, j in ins if int(m.group(1), 16) <= b <= addr]
            bars = sum("BAR.SYNC" in j for j in body)
            if bars > best[0]:
                best = (bars, body)
    return normalized(best[1])


def register_sass(lib):
    """{template arguments: [instruction lines]} of the register
    instantiations of `pdhg_chunk_tiled` in `lib`."""
    tool = os.path.join(os.path.dirname(pdhg_chunk._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = block.partition("\n")
        m = _TILED.search(name)
        if m is None:
            continue
        raw = [" ".join(line.split()) for line in body.splitlines()
               if line.strip()]
        key = m.group(1) + "Li8ELi1ELi8E" + m.group(2)
        out[key] = (FORMS[int(m.group(3))],
                    [re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
                     for line in raw], step_loop(raw))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the earlier revision's pdhg_chunk.cu")
    ap.add_argument("--build-dir", default=os.path.join("build", "sass"))
    ap.add_argument("--grouped-bases", action="store_true",
                    help="allow the shared and split forms the grouped-"
                         "base addressing (see above)")
    args = ap.parse_args()
    os.makedirs(args.build_dir, exist_ok=True)
    new = register_sass(build(str(pdhg_chunk._SRC), os.path.join(
        args.build_dir, "new.so")))
    old = register_sass(build(args.parent, os.path.join(
        args.build_dir, "parent.so")))
    equal = prologue_only = 0
    for key, (form, lines, loop) in sorted(new.items()):
        before, before_loop = old.get(key, (None, None, None))[1:]
        same = before == lines
        equal += same
        only_new = only_old = []
        loop_diff = {}
        loop_same = False
        if before_loop is not None:
            a, b = collections.Counter(before_loop), collections.Counter(loop)
            loop_diff = {"only_new": dict(b - a), "only_before": dict(a - b)}
            loop_same = (len(loop) == len(before_loop) and sum(
                (b - a).values()) <= GROUPED_LOOP_SWAPS)
        if before is not None and not same:
            diff = list(difflib.ndiff(normalized(before), normalized(lines)))
            only_new = [d[2:] for d in diff if d.startswith("+ ")]
            only_old = [d[2:] for d in diff if d.startswith("- ")]
        prologue_only += (form != "dense" and not same and loop_same
                          and 0 <= len(normalized(lines))
                          - len(normalized(before)) <= GROUPED_MAX_LINES)
        print(json.dumps({"kernel": key, "form": form,
                          "instructions": len(normalized(lines)),
                          "parent_instructions": (
                              None if before is None
                              else len(normalized(before))),
                          "found": before is not None, "equal": same,
                          "step_loop_instructions": len(loop),
                          "step_loop_as_parent": loop_same,
                          "step_loop_differences": loop_diff,
                          "only_new": only_new, "only_parent": only_old}))
    dense = sum(f == "dense" for f, _, _ in new.values())
    if args.grouped_bases:
        ok = (len(new) == 9 and dense == 3
              and equal + prologue_only == 9
              and all(old.get(k, (0, None))[1] == v[1]
                      for k, v in new.items() if v[0] == "dense"))
    else:
        ok = len(new) == 9 and equal == 9
    print(json.dumps({"register_kernels": len(new), "equal": equal,
                      "differ_only_in_prologue": prologue_only,
                      "parent_register_kernels": len(old), "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
