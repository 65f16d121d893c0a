#!/usr/bin/env python3
"""Compare the machine code of the port's CUDA kernels between two checkouts.

    python3 tools/torch_sass_compare.py OTHER_CHECKOUT [--source flash_fwd]

Compiles ``diffusion_rs_tpu_torch/csrc/<source>.cu`` of this checkout and of
``OTHER_CHECKOUT`` to sm_90a cubins with the port's nvcc flags, disassembles
both with ``cuobjdump -sass`` and compares every kernel present in both,
instruction by instruction (addresses, encodings and the anonymous
namespace's file hash stripped). Prints one line per kernel and exits 1 if
any shared kernel differs: a change that must leave its siblings' code as
it was (a new template flag compiled out of them) shows here as
"identical". Needs the CUDA toolkit (nvcc, cuobjdump), not a card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("diffusion_rs_tpu_torch") / "csrc"
# the port's flags (ops/_cuda.py NVCC_FLAGS) for device code only
FLAGS = ["-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
# the anonymous namespace's mangled name: _ZN<length>_GLOBAL__N__<file hash>...
_ANON = re.compile(r"(\d+)(_GLOBAL__N__\w+)")


def _strip_anon(name: str) -> str:
    """``name`` with the anonymous namespace's length-prefixed mangled name,
    which carries a hash of the file, replaced by ``<anon>``."""
    return _ANON.sub(lambda m: "<anon>" + m.group(2)[int(m.group(1)):], name)


def _tool(name: str) -> str:
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    return str(path) if path.exists() else name


def kernels(checkout: Path, source: str, out: Path) -> dict:
    """Mangled kernel name (file hash stripped) -> its SASS instructions."""
    cubin = out / f"{source}.cubin"
    subprocess.run([_tool("nvcc"), *FLAGS, "-I", str(checkout / CSRC), "-o", str(cubin),
                    str(checkout / CSRC / f"{source}.cu")], check=True)
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _strip_anon(m.group(1))
            funcs[name] = []
        elif name is not None:
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
            if ins:
                funcs[name].append(_strip_anon(ins.group(1)))
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("--source", default="flash_fwd", help="csrc/<source>.cu to compare")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "a").mkdir()
        (Path(tmp) / "b").mkdir()
        here = kernels(ROOT, args.source, Path(tmp) / "a")
        there = kernels(args.other.resolve(), args.source, Path(tmp) / "b")
    differ = 0
    for name in sorted(set(here) | set(there)):
        if name not in there or name not in here:
            print(f"only in {'this checkout' if name in here else args.other}: {name}")
            continue
        same = here[name] == there[name]
        differ += not same
        print(f"{'identical' if same else 'DIFFERS'}: {name} ({len(here[name])} vs "
              f"{len(there[name])} instructions)")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
