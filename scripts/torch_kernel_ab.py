#!/usr/bin/env python3
"""The port's kernels of two or more checkouts, timed in turns in one call
on the card: phase 3 of chip_smoke.py (every kernel at the shapes of a
256 px B=4 training step, held against its plain version, timed alone and
in a CUDA graph) for each checkout, in f32 and, where its chip_smoke.py has
them, in its bf16 instances; with --size 1024, phase 11's shapes instead
(a 1024 px B=8 training step, each call timed over 5 CUDA-event runs).

    python3 scripts/torch_kernel_ab.py <checkout A> <checkout B> [...] [--turns ABBA]
        [--size 256|1024]

Each turn is a fresh process that imports the checkout's own chip_smoke.py
and package, which builds its kernels into <checkout>/build/. --turns
names the order by letters (default ABBA for two checkouts, one turn each
otherwise). Needs a CUDA card. Prints the card's name and power limit, then
one JSON line per turn: per kernel and dtype, the device ms of one training
step's calls and the ms alone, and per styled-conv shape its device ms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TURN = r"""
import inspect, json, os, sys
checkout, size = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, checkout)
os.chdir(checkout)
import torch
import chip_smoke
from latent2im_tpu_torch.device import resolve_device
from latent2im_tpu_torch.ops import _build
import contextlib
dev = resolve_device("cuda")
_build.build()
_build.library()
out = {}
shape = {} if size == 256 else {"size": 1024, "batch": 8, "iters": 5}
dtypes = [None]
if "dtype" in inspect.signature(chip_smoke.kernel_phase).parameters:
    dtypes.append(torch.bfloat16)
for dt in dtypes:
    with contextlib.redirect_stdout(sys.stderr):
        res, _, details = chip_smoke.kernel_phase(
            dev, **shape, **({} if dt is None else {"dtype": dt}))
    key = "f32" if dt is None else "bf16"
    for name, paths in res.items():
        r = paths["train_step"]
        out.setdefault(name, {})[key] = {
            "device_ms": r["device_ms"], "ms": r["ms"], "launches": r["launches"]}
    out["styled_conv3x3"][key]["by_shape_device_ms"] = {
        d["case"]: d["device_ms"] for d in details if d["kernel"] == "styled_conv3x3"}
print(json.dumps(out))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--turns", default=None)
    ap.add_argument("--size", type=int, default=256, choices=(256, 1024))
    args = ap.parse_args(argv)
    roots = [os.path.abspath(c) for c in args.checkouts]
    letters = "ABCDEFGH"[:len(roots)]
    turns = args.turns or ("ABBA" if len(roots) == 2 else letters)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    for turn in turns:
        root = roots[letters.index(turn)]
        proc = subprocess.run([sys.executable, "-c", TURN, root, str(args.size)],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(json.dumps({"turn": turn, "checkout": root, "size": args.size,
                          "kernels": json.loads(proc.stdout.strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
