#!/usr/bin/env python3
"""Compare the SASS of the PyTorch port's CUDA kernels between two trees.

    python3 scripts/torch_sass_compare.py OLD_ROOT NEW_ROOT [KERNEL ...]

Builds the kernel library of each tree (`libjitsi_tpu_torch.kernels.build`,
run in a subprocess from that tree's root, so each tree builds its own
sources), disassembles both with `cuobjdump -sass`, and for every kernel
function found in both (or only the named kernels, e.g. `srtp_protect_cm`)
compares the instruction streams with addresses and encodings removed.
Prints one JSON line: each kernel's instruction count in either tree and
whether the streams are identical, and exits 1 if a named kernel differs
or is missing.  Needs the CUDA toolkit (`nvcc`, `cuobjdump`).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

_BUILD = ("import sys; sys.path.insert(0, '.'); "
          "from libjitsi_tpu_torch.kernels import build; print(build.build())")
_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+([^;]*;)")


def kernel_name(mangled: str):
    """'srtp_protect_cm nr=10' for the mangled name of
    `srtp_protect_cm_kernel<10>` (a length-prefixed identifier ending in
    `_kernel`, then its template argument), else None.  The last such
    identifier is the function's own: a namespace's name (which may hold
    the source file's) comes before it."""
    found = None
    for m in re.finditer(r"\d+", mangled):
        digits = m.group(0)
        for i in range(len(digits)):
            n, start = int(digits[i:]), m.end()
            ident = mangled[start:start + n]
            if len(ident) == n and ident.endswith("_kernel") and \
                    re.fullmatch(r"[A-Za-z_]\w*", ident):
                nr = re.match(r"ILi(\d+)E", mangled[start + n:])
                found = ident[:-len("_kernel")] + (
                    f" nr={nr.group(1)}" if nr else "")
    return found


def build(root: str) -> str:
    out = subprocess.run([sys.executable, "-c", _BUILD], cwd=root,
                         check=True, capture_output=True, text=True,
                         timeout=900)
    return out.stdout.strip().splitlines()[-1]


def kernels(so: str) -> dict:
    """{name (and nr=), [instruction text]} of a library's kernels."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = kernel_name(m.group(1))
            if cur:
                out[cur] = []
            continue
        m = _INSN.match(line)
        if cur and m:
            out[cur].append(" ".join(m.group(1).split()))
    return out


def main(argv) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (kernels(build(os.path.abspath(r))) for r in argv[1:3])
    wanted = argv[3:]
    names = sorted(k for k in old.keys() & new.keys()
                   if not wanted or k.split(" ")[0] in wanted)
    report = {k: dict(old=len(old[k]), new=len(new[k]),
                      identical=old[k] == new[k]) for k in names}
    missing = [w for w in wanted if not any(k.split(" ")[0] == w
                                            for k in names)]
    print(json.dumps({"sass_compare": report, "missing": missing,
                      "only_old": sorted(old.keys() - new.keys()),
                      "only_new": sorted(new.keys() - old.keys())}))
    return 1 if missing or (wanted and not all(
        v["identical"] for v in report.values())) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
