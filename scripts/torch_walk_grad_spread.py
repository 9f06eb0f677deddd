#!/usr/bin/env python3
"""How far an f32 walk-training step's gradient lies from an f64 reference,
on the card and on the CPU, per walk kind and per input draw: the spread
behind chip_smoke.py's phase 9/20 bound, max(1e-3, 1.5 x the CPU f32 error).

For each walk kind (linear_w, mlp_w --is_mlp, nn_w --walk_type NNz) at
256 px, full width, seeded weights, B=2, stored noise, host alphas, and for
each seed of z and the alphas, chip_smoke.py's reference_step composes the
step on the card in f32 and on the CPU in f32 and f64.
Printed per (kind, seed): the relative L2 to f64 of the walk gradient and
of the gradient wrt the edited W+ (which every walk kind backpropagates
through the same towers), on the card and on the CPU.

    python3 scripts/torch_walk_grad_spread.py [seeds...]   (default 8 18 28)

Needs a CUDA card; one JSON line per (kind, seed), then a summary line.
"""

from __future__ import annotations

import json
import os
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = (("linear_w", ()), ("mlp_w", ("--is_mlp",)), ("nn_w", ("--walk_type", "NNz")))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    seeds = [int(a) for a in argv] or [8, 18, 28]
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_walk_grad_spread: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.tasks.transforms import get_task
    from latent2im_tpu_torch.walks import walk_map

    warnings.simplefilter("ignore")
    resolve_device("cuda")
    rows = []
    for kind, flags in KINDS:
        conf = chip_smoke.train_conf("--fixed_noise", *flags)
        card, walk, _ = build_editor_from_options(conf, device="cuda")
        cpu, _, _ = build_editor_from_options(conf, device="cpu")
        w0 = walk_map(lambda t: t.detach().cpu().numpy().copy(), walk)
        for seed in seeds:
            z = np.random.RandomState(seed).randn(2, 512).astype(np.float32)
            sampled, _ = get_task("face").train_alpha_np(np.random.RandomState(seed + 1), 2, 1)
            res = {"card": chip_smoke.reference_step(card, w0, z, sampled, torch.float32),
                   "cpu": chip_smoke.reference_step(cpu, w0, z, sampled, torch.float32)}
            for m in (cpu.g, cpu.reg, cpu.vgg, cpu.d):
                m.double()
            res["f64"] = chip_smoke.reference_step(cpu, w0, z, sampled, torch.float64)
            for m in (cpu.g, cpu.reg, cpu.vgg, cpu.d):
                m.float()
            row = {"kind": kind, "seed": seed}
            for i, what in ((1, "walk_grad"), (2, "latent_grad")):
                ref = res["f64"][i]
                for dev in ("card", "cpu"):
                    row[f"{what}_{dev}_f64"] = chip_smoke.rel_l2(res[dev][i], ref)
            row["bound"] = max(1e-3, 1.5 * row["walk_grad_cpu_f64"])
            rows.append(row)
            print(json.dumps(row), flush=True)
        del card, cpu
        torch.cuda.empty_cache()
    print(json.dumps({"card": chip_smoke.card_line(),
                      "card_over_bound": [r["walk_grad_card_f64"] / r["bound"] for r in rows]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
