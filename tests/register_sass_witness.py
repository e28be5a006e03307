"""Shows that the chunk kernel's register source compiles to the same
machine code as in an earlier revision of `csrc/pdhg_chunk.cu`: the
SASS of every `pdhg_chunk_tiled` instantiation with A held in registers
(source 0: 3 forms x f32, f64 and bf16 storage) in the library built
from this checkout, against the same instantiation built from the
earlier source with the same nvcc flags.

    git show <commit>:mpisppy_tpu_torch/csrc/pdhg_chunk.cu > build/old.cu
    python tests/register_sass_witness.py --parent build/old.cu

Needs nvcc and cuobjdump (no card).  Prints one JSON line a kernel
(its template arguments, instruction count, equal or not) and a
summary line; exits 1 unless every register kernel of this checkout
is in the earlier build and equal to it.  Instruction addresses are
dropped before the comparison; the encodings are kept.
"""

import argparse
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from mpisppy_tpu_torch.ops import pdhg_chunk  # noqa: E402

# the mangled template arguments of a register instantiation:
# <TS, T, R, V, W, SRC = 0, FORM, MINB>
_TILED = re.compile(r"pdhg_chunk_tiledI(\w+?Li8ELi1ELi8ELi0ELi\dELi\dE)E")


def build(src, out):
    """nvcc `src` into the shared library `out` with the kernel's own
    flags."""
    cmd = [pdhg_chunk._nvcc(), *pdhg_chunk._NVCC_FLAGS, "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return out


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
        body = re.sub(r"/\*[0-9a-f]{4,}\*/", "", body)
        out[m.group(1)] = [" ".join(line.split())
                           for line in body.splitlines() if line.strip()]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the earlier revision's pdhg_chunk.cu")
    ap.add_argument("--build-dir", default=os.path.join("build", "sass"))
    args = ap.parse_args()
    os.makedirs(args.build_dir, exist_ok=True)
    new = register_sass(build(str(pdhg_chunk._SRC), os.path.join(
        args.build_dir, "new.so")))
    old = register_sass(build(args.parent, os.path.join(
        args.build_dir, "parent.so")))
    equal = 0
    for key, lines in sorted(new.items()):
        same = old.get(key) == lines
        equal += same
        print(json.dumps({"kernel": key, "instructions": len(lines),
                          "in_parent": key in old, "equal": same}))
    ok = len(new) == 9 and equal == len(new)
    print(json.dumps({"register_kernels": len(new), "equal": equal,
                      "parent_register_kernels": len(old), "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
