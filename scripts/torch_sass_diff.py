#!/usr/bin/env python3
"""Compare the SASS of the kernels two versions of a CUDA source share.

    python3 scripts/torch_sass_diff.py OLD.cu NEW.cu [--strip-arg N]

Compiles each with the flags of latent2im_tpu_torch/ops/_build.py into a
cubin, disassembles it with cuobjdump -sass, and matches the kernels by
their demangled names. A template parameter added to NEW's kernels (a bool
appended to their argument lists) is dropped from NEW's names with
``--strip-arg``: the last N template arguments, where the name has more
arguments than OLD's. Prints, per OLD kernel, whether NEW has it with the
same instructions (addresses, and the kernel's own name in its labels,
ignored), and one JSON line; exits 1 when one differs or is missing.
Needs nvcc and cuobjdump (the CUDA toolkit).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _tool(name: str) -> str:
    from latent2im_tpu_torch.ops import _build

    return os.path.join(os.path.dirname(_build.nvcc()), name)


def sass(src: str, tmp: str) -> dict[str, list[str]]:
    """{demangled kernel name: its instructions} of ``src``."""
    from latent2im_tpu_torch.ops import _build

    cubin = os.path.join(tmp, os.path.basename(src) + ".cubin")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-cubin", "-o", cubin, src], check=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name and m:
            kernels[name].append(m.group(1))
    names = list(kernels)
    demangled = subprocess.run([shutil.which("c++filt") or "c++filt"], input="\n".join(names),
                               capture_output=True, text=True, check=True).stdout.splitlines()
    return {d: kernels[n] for n, d in zip(names, demangled)}


def _args(name: str) -> tuple[str, list[str]]:
    """(kernel name without its template arguments, the arguments)."""
    m = re.match(r"(?:void )?(.*?)<(.*)>\(.*\)$", name)
    if not m:
        return name, []
    depth, cur, out = 0, "", []
    for ch in m.group(2):
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
            continue
        depth += ch in "<(" and 1 or (-1 if ch in ">)" else 0)
        cur += ch
    out.append(cur.strip())
    return m.group(1), out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("old")
    p.add_argument("new")
    p.add_argument("--strip-arg", type=int, default=1)
    a = p.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        old, new = sass(a.old, tmp), sass(a.new, tmp)
    by_key = {}
    for name, ins in new.items():
        base, args = _args(name)
        by_key.setdefault((base, tuple(args)), []).append((name, ins))
    report, ok = [], True
    for name, ins in sorted(old.items()):
        base, args = _args(name)
        cands = []
        for (b, nargs), entries in by_key.items():
            if b == base and len(nargs) == len(args) + a.strip_arg \
                    and list(nargs[:len(args)]) == args:
                cands += entries
            elif b == base and list(nargs) == args:
                cands += entries
        same = [n for n, i in cands if i == ins]
        report.append({"kernel": name, "instructions": len(ins), "new_twins": [n for n, _ in cands],
                       "identical_in": same})
        ok &= bool(same)
        print(f"{'same' if same else 'DIFFERS'}: {name} ({len(ins)} instructions)"
              + (f" == {same[0]}" if same else f"; candidates {[n for n, _ in cands]}"), flush=True)
    print(json.dumps({"sass_identical": ok, "kernels": len(report),
                      "new_kernels": len(new), "old_kernels": len(old)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
