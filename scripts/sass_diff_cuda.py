#!/usr/bin/env python3
"""Compare, kernel by kernel, the machine code (SASS) of two builds of the
port's CUDA libraries.

    python3 scripts/sass_diff_cuda.py BUILD_A BUILD_B

BUILD_A and BUILD_B are the ``build/diffmst_torch_kernels`` directories of
two checkouts, each built first (``python3 -c "from diffmst_torch.kernels
import _build; _build.build_kernels()"`` from the checkout's root). For each
of ``scan1p.cu``, ``comp_fused.cu`` and ``iir_fused.cu`` it disassembles
both libraries with the toolkit's ``cuobjdump -sass``, matches kernels by
their demangled names (nvcc names an anonymous namespace by its file, so
mangled names differ between builds) and prints whether each kernel's
instructions are identical, or which differ, or that it exists in one build
only. It shows whether a change to a shared header left other kernels' code
as it was.
"""

from __future__ import annotations

import pathlib
import re
import shutil
import subprocess
import sys


def _tool(name: str) -> str:
    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def kernels(lib: pathlib.Path) -> dict[str, list[str]]:
    """Demangled kernel name -> its instructions, without their addresses."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m[1]
            funcs[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", ln):
            funcs[name].append(re.sub(r"^\s*/\*[0-9a-f]{4}\*/\s*", "", ln).split(";")[0].strip())
    names = subprocess.run([_tool("cu++filt")], input="\n".join(funcs), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    return dict(zip(names, funcs.values()))


def main() -> int:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    a_dir, b_dir = (pathlib.Path(p) for p in sys.argv[1:])
    for src in ("scan1p", "comp_fused", "iir_fused"):
        a = kernels(next(a_dir.glob(f"{src}-*.so")))
        b = kernels(next(b_dir.glob(f"{src}-*.so")))
        for f in sorted(set(a) | set(b)):
            if f not in a or f not in b:
                print(f"{src}: only in {'B' if f in b else 'A'}: {f[:110]}")
                continue
            differ = [i for i, (x, y) in enumerate(zip(a[f], b[f])) if x != y]
            same = a[f] == b[f]
            print(f"{src}: {'identical' if same else 'DIFFERENT'} ({len(a[f])} and {len(b[f])}"
                  f" instructions, {len(differ)} differ in place): {f[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
