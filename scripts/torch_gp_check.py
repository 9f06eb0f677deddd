#!/usr/bin/env python3
"""Phase 16 of chip_smoke.py on any checkout of the PyTorch port: the
gradient, wrt the 256 px discriminator's parameters, of the WGAN-GP gradient
penalty on the card against f64 on the CPU, per parameter, reported without
its bound. A tree whose backward kernels are not differentiable drops the
second-order terms that run through them, and this shows by how much.

    python3 scripts/torch_gp_check.py [<checkout>]

<checkout> is the root of a checkout (the default: this repository); its
latent2im_tpu_torch builds its own kernels into <checkout>/build/. Needs a
CUDA card. Prints one JSON line: the penalty, the worst parameter, and each
parameter's relative L2 on the card and in f32 on the CPU.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    checkout = os.path.abspath(argv[0] if argv else HERE)
    sys.path.insert(0, checkout)  # its package
    import importlib.util

    import torch

    if not torch.cuda.is_available():
        print("torch_gp_check: no CUDA device", file=sys.stderr)
        return 2
    # this repository's chip_smoke.py (the checkout may have its own)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import latent2im_tpu_torch
    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.ops import _build

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(latent2im_tpu_torch.__file__)))
    assert pkg == checkout, (pkg, checkout)
    dev = resolve_device("cuda")
    _build.build()
    _build.library()
    out = chip_smoke.gp_phase(dev, enforce=False)
    print(json.dumps({"checkout": checkout, "card": chip_smoke.card_line(),
                      "gp": out["gp"], "worst": out["worst"], "launches": out["launches"],
                      "groups": out["groups"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
