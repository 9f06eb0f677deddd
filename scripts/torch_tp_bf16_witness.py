#!/usr/bin/env python3
"""How far the bf16 tp step's loss terms lie from one process's, beside how
far two correct bf16 implementations of the same step lie from each other
(256 px B=4 and 1024 px B=2, full width, the stored noise; chip_smoke.py
phase 48's editors, inputs drawn from several seeds).

    python3 scripts/torch_tp_bf16_witness.py [seeds]

For each size and seed, the first training step's loss terms in bf16 four
ways: one process through the kernels and through the plain versions, and
two gloo ranks sharing the card (1 data x 2 model, tp) through each. Prints,
per seed, the largest relative term difference of tp against one process
(kernels; plain versions) and of kernels against plain versions (one
process; tp), and one JSON line; writes chiprun_out/torch_tp_bf16_witness.json.
Needs a CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RUNS = ((256, 4), (1024, 2))


def _terms(ed, walk, z, sampled, mesh, plain):
    """The first step's loss terms from a copy of ``walk``."""
    import torch

    import chip_smoke as cs
    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step
    from latent2im_tpu_torch.parallel import mesh as M
    from latent2im_tpu_torch.tasks.transforms import get_task
    from latent2im_tpu_torch.walks import walk_map

    w = walk_map(lambda t: t.detach().clone().requires_grad_(True), walk)
    sh = None if mesh is None else M.frozen_tp_shardings(mesh, ed.frozen_params())
    step = make_train_step(ed, get_task("face"), make_optimizer(w, 1e-4), host_alpha=True,
                           mesh=mesh, frozen_shardings=sh)
    with cs.plain_kernels() if plain else contextlib.nullcontext():
        m = step(w, z, generator=torch.Generator(device=ed.device).manual_seed(45),
                 sampled=sampled)
    return {k: float(m[k]) for k in cs.STEP_TERMS}


def _all(seeds, mesh=None):
    """{size: [(kernel terms, plain terms) per seed]}."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.parallel import mesh as M

    dev = resolve_device("cuda")
    out = {}
    for size, batch in RUNS:
        ed, walk = cs._par_editor(size, batch, dev, "--bf16")
        if mesh is not None:
            _, walk = M.replicate_editor(ed, walk, mesh)
        out[size] = []
        for seed in range(seeds):
            rng = np.random.RandomState(seed)
            z = rng.randn(batch, ed.cfg.dim_z).astype(np.float32)
            sampled = rng.uniform(0, 1, (batch, 1)).astype(np.float32)
            out[size].append(tuple(_terms(ed, walk, z, sampled, mesh, plain)
                                   for plain in (False, True)))
        del ed, walk
        torch.cuda.empty_cache()
    return out


def tp_rank(seeds):
    from latent2im_tpu_torch.parallel import mesh as M

    return _all(seeds, M.make_mesh_2d(1, 2))


def _rel(a, b):
    return max(abs(a[k] - b[k]) / abs(b[k]) for k in b)


def main() -> int:
    import chip_smoke as cs
    from latent2im_tpu_torch.ops import _build
    from latent2im_tpu_torch.parallel.launch import launch

    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    card = cs.card_line()
    _build.library()
    one = _all(seeds)
    tp = launch(tp_rank, (seeds,), world_size=2, device="cuda", timeout=1200.0)
    rows = []
    for size, _ in RUNS:
        for seed, ((ok, op), (tk, tpl)) in enumerate(zip(one[size], tp[size])):
            rows.append({"size": size, "seed": seed, "tp_vs_one_kernels": _rel(tk, ok),
                         "tp_vs_one_plain": _rel(tpl, op), "kernels_vs_plain_one": _rel(ok, op),
                         "kernels_vs_plain_tp": _rel(tk, tpl)})
            cs.log(f"{size} px seed {seed}: tp against one process {rows[-1]['tp_vs_one_kernels']:.3e}"
                   f" (kernels), {rows[-1]['tp_vs_one_plain']:.3e} (plain); kernels against plain "
                   f"{rows[-1]['kernels_vs_plain_one']:.3e} (one process), "
                   f"{rows[-1]['kernels_vs_plain_tp']:.3e} (tp)")
    report = {"card": card, "rows": rows}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "torch_tp_bf16_witness.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":  # the launched ranks import this file again
    sys.exit(main())
