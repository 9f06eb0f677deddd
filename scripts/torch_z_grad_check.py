#!/usr/bin/env python3
"""Where an f32 z-space walk step's gradient error lies, on the card and on
the CPU, against an f64 reference on the card: the measurement behind the
bound of chip_smoke.py's phase 26.

For StyleGAN2 in z (--latent z --is_mlp, mlp_z) and model_256 PGGAN
(linear_z_free) at 256 px, full width, seeded weights, B=2, host alphas,
stored noise, per seed of z and the alphas and per loss configuration (all
three terms; without the GAN term; without the content term; the BCE
alone), chip_smoke.py's z_reference_step composes the step on the card in
f32 (cuDNN's default algorithms, then deterministic ones), on the CPU in
f32, and on the card in f64 (the towers in f64, the kernels' plain
versions). Printed per row: the relative L2 to f64 of the walk gradient
and of the gradient wrt the edited z, which the walk's gradient is made
from.

    python3 scripts/torch_z_grad_check.py [seeds...]   (default 30 40)

Needs a CUDA card; one JSON line per row, then a summary line.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = (("all", ()), ("no_gan", ("--no_gan_loss",)),
           ("no_content", ("--no_content_loss",)),
           ("bce", ("--no_gan_loss", "--no_content_loss")))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    seeds = [int(a) for a in argv] or [30, 40]
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_z_grad_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.tasks.transforms import get_task
    from latent2im_tpu_torch.walks import walk_map

    warnings.simplefilter("ignore")
    resolve_device("cuda")
    from latent2im_tpu_torch.ops import _build
    _build.build()
    rows = []
    models = (("stylegan2_z", lambda *f: cs.train_conf(*cs.Z_FLAGS, "--fixed_noise", *f)),
              ("pggan", cs.pggan_conf))
    for model, make_conf in models:
        for name, flags in CONFIGS:
            conf = make_conf(*flags)
            card, walk, _ = build_editor_from_options(conf, device="cuda")
            cpu, _, _ = build_editor_from_options(conf, device="cpu")
            f64 = copy.deepcopy(card)
            for m in (f64.g, f64.reg, f64.vgg, f64.d):
                if m is not None:
                    m.double()
            w0 = walk_map(lambda t: t.detach().cpu().numpy().copy(), walk)
            for seed in seeds:
                z = np.random.RandomState(seed).randn(2, 512).astype(np.float32)
                sampled, _ = get_task("face").train_alpha_np(
                    np.random.RandomState(seed + 1), 2, 1)
                with cs.plain_kernels():
                    ref = cs.z_reference_step(f64, w0, z, sampled, torch.float64)
                res = {"card": cs.z_reference_step(card, w0, z, sampled, torch.float32),
                       "cpu": cs.z_reference_step(cpu, w0, z, sampled, torch.float32)}
                torch.backends.cudnn.deterministic = True
                try:
                    res["card_deterministic"] = cs.z_reference_step(card, w0, z, sampled,
                                                                    torch.float32)
                finally:
                    torch.backends.cudnn.deterministic = False
                row = {"model": model, "losses": name, "seed": seed}
                for k, (_, grad, zgrad) in res.items():
                    row[f"walk_{k}"] = cs.rel_l2(grad, ref[1])
                    row[f"edited_z_{k}"] = cs.rel_l2(zgrad, ref[2])
                rows.append(row)
                print(json.dumps(row), flush=True)
            del card, cpu, f64
            torch.cuda.empty_cache()
    print(json.dumps({"card": cs.card_line(), "rows": len(rows),
                      "max": {k: max(r[k] for r in rows) for k in rows[0]
                              if k.startswith(("walk_", "edited_z_"))}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
