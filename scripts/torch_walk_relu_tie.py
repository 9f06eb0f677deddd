#!/usr/bin/env python3
"""Where the one-thread walk-gradient gap of tests/test_torch_walks.py's
nn_w step comes from (ROADMAP C.9), on the CPU.

The step of tests/test_torch_walks.py::test_one_training_step_matches_the_jax_step
(kind nn_w, the tests' seeded towers, z and alphas of step 0) is composed
twice with the port's towers, in f32 and in f64, and the regressor term's
gradient is followed from the regressor's output back to the walk. Then the
f64 ResNet-50 runs on the f32 step's edited image and on the f64 step's, and
every ReLU input whose sign differs between the two is printed with its
value: a unit within f32 rounding of zero, on whichever side the f32
forward lands, moves the walk gradient by a step.

    OMP_NUM_THREADS=1 PYTHONPATH=. python3 scripts/torch_walk_relu_tie.py
    PYTHONPATH=. python3 scripts/torch_walk_relu_tie.py

Prints the thread count, the relative error of each stage's gradient
(max |f32 - f64| / max |f64|) and the flipped units (~20 s).
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE, os.path.join(HERE, "tests")]


def main() -> int:
    import torch

    from test_torch_train import _port_editor
    from test_torch_walks import STYLE_DIM, SIZE, _jax_walk, walk_from_jax
    from test_train_dynamics import _build_world

    from latent2im_tpu_torch.engine import losses as L
    from latent2im_tpu_torch.walks import apply_walk, walk_leaves, walk_map

    tg, td, tr, tvgg, _, zs, alphas = _build_world()
    kind = "nn_w"
    walk0 = _jax_walk(kind, dim=STYLE_DIM, n_layers=2 * int(np.log2(SIZE)) - 2, seed=3)
    print("torch threads", torch.get_num_threads())
    res = {}
    for dtype in (torch.float32, torch.float64):
        ed = _port_editor(tg, td, tr, tvgg)
        ed.cfg = type(ed.cfg)(**{**ed.cfg.__dict__, "walk_kind": kind})
        for m in (ed.g, ed.reg):
            m.to(dtype)
        z, sampled = (torch.as_tensor(a, dtype=dtype) for a in (zs[0], alphas[0]))
        w = walk_map(lambda a: a.to(dtype).requires_grad_(True), walk_from_jax(walk0))
        with torch.no_grad():
            latent = ed.g.style_forward(z)[:, None].expand(-1, ed.cfg.n_latent, -1)
            alpha_org = ed.reg(ed.g.synthesize(latent).to(dtype))[:, ed._attr_idx].to(dtype)
        latent_new = apply_walk(kind, w, latent, sampled - alpha_org, layers=ed.cfg.layers)
        latent_new.retain_grad()
        img = ed.g.synthesize(latent_new).to(dtype)
        img.retain_grad()
        out = ed.reg(img)[:, ed._attr_idx]
        out.retain_grad()
        zero = torch.zeros((), dtype=dtype)
        L.combine(L.raw_bce(out, sampled), zero, zero).backward()
        res[dtype] = {"image": img.detach().double(), "d output": out.grad.double(),
                      "d image": img.grad.double(), "d W+": latent_new.grad.double(),
                      "d walk": torch.cat([t.grad.double().ravel() for t in walk_leaves(w)])}
    a, b = res[torch.float32], res[torch.float64]
    for k in b:
        err = float((a[k] - b[k]).abs().max() / b[k].abs().max())
        print(f"{k:9s} relative error {err:.3e}")
    reg = copy.deepcopy(_port_editor(tg, td, tr, tvgg).reg).double()
    acts = {}
    for tag in ("f64", "f32"):
        store = []
        hooks = [m.register_forward_hook(lambda m, i, o, n=n, s=store: s.append((n, o.clone())))
                 for n, m in reg.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
        with torch.no_grad():
            reg((b if tag == "f64" else a)["image"], dtype=torch.float64)
        for h in hooks:
            h.remove()
        acts[tag] = store
    flips = 0
    for (name, x), (_, y) in zip(acts["f64"], acts["f32"]):
        for idx in torch.nonzero((x > 0) != (y > 0)).tolist():
            flips += 1
            print(f"ReLU input {name}{idx}: {float(x[tuple(idx)]):.3e} on the f64 step's "
                  f"image, {float(y[tuple(idx)]):.3e} on the f32 step's (layer max "
                  f"{float(x.abs().max()):.3e})")
    print("flipped units", flips)
    return 0


if __name__ == "__main__":
    sys.exit(main())
