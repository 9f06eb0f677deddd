#!/usr/bin/env python3
"""Phases 47-50 of chip_smoke.py alone: the styled conv's tensor-parallel
split at the tp shard shapes, the tp training step on two gloo ranks sharing
the card (256 px f32 and bf16 at B=4, 1024 px bf16 at B=2) against the
one-process step and its f64 reference, --updateGAN on a two-rank data
mesh, and the PGGAN and StyleGAN1 edits on rows (after building the
kernels).

    python3 scripts/torch_tp_phases.py

Needs a CUDA card. Writes the phases' report to
chiprun_out/torch_tp_phases.json and prints the phases' lines.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import torch

    import chip_smoke as cs
    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.ops import _build

    card = cs.card_line()
    cs.log(card, torch.__version__, torch.version.cuda)
    _, secs = _build.build()
    _build.library()
    cs.log(f"built in {secs:.1f} s")
    t = time.perf_counter()
    out = cs.tp_phases(card, resolve_device("cuda"))
    cs.log(f"phases 47-50 in {time.perf_counter() - t:.1f} s")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "torch_tp_phases.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":  # the launched ranks import this file again
    sys.exit(main())
