#!/usr/bin/env python3
"""Where the f32 error of the --updateGAN gradients lies on the card.

    python3 scripts/torch_gan_grad_check.py

Needs a CUDA card. Three parts, each printed as JSON lines:

1. the styled conv's backward (ops/styled_conv.py) at 256^2 x 128, B=4, and
   at three smaller shapes: each gradient of the kernel's node and of
   autograd of the plain version, against the plain backward in f64 on the
   path's own LeakyReLU mask, and the two paths against each other (of max
   |ref|). On one mask the backward is f32 rounding; across the two
   forwards' masks it is not.
2. phase 22 of chip_smoke.py unbounded: each parameter's relative L2 from
   f64 for one D and one G step (256 px, full width, B=2), on the card
   twice under cuDNN's default algorithms, once with the styled conv's
   forward on cuDNN (its plain version) and once with deterministic cuDNN,
   and in f32 on the CPU once; the worst of G's noise maps and noise
   weights and of every other parameter per run.
3. phase 22's f64 reference on the card (the plain versions) against f64 on
   the CPU, at 64 px: the worst relative L2 over all parameters.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _max_rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def styled_conv_backward(dev):
    import torch

    from latent2im_tpu_torch import ops

    names = ("x", "w", "s", "d", "noise", "noise_w")
    for b, h, w, cin, cout in ((2, 9, 11, 20, 24), (4, 16, 16, 512, 512),
                               (2, 64, 64, 256, 256), (4, 256, 256, 128, 128)):
        gen = torch.Generator(device=dev).manual_seed(7)

        def r(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        x, wt = r(b, h, w, cin), r(3, 3, cin, cout) / math.sqrt(9 * cin)
        s = 1.0 + 0.2 * r(b, cin)
        d = torch.rsqrt(s.square() @ wt.square().sum((0, 1)) + 1e-8)
        noise, nw, bias, g = r(1, h, w), torch.full((1,), 0.3, device=dev), 0.1 * r(cout), \
            r(b, h, w, cout)
        row, grads = {"shape": [b, h, w, cin, cout]}, {}
        for name, fn in (("kernel", ops.styled_conv3x3), ("plain", ops.styled_conv3x3_plain)):
            leaves = [t.detach().clone().requires_grad_(True) for t in (x, wt, s, d, noise, nw)]
            out = fn(*leaves, bias)
            grads[name] = torch.autograd.grad(out, leaves, g)
            x64, w64, s64, d64, n64, nw64, g64 = (t.double() for t in (x, wt, s, d, noise, nw, g))
            gz = g64 * torch.where(out.detach() > 0, 1.0, 0.2).double() * math.sqrt(2)
            xs = (x64 * s64[:, None, None, :]).permute(0, 3, 1, 2)
            w_oihw = w64.permute(3, 2, 0, 1)
            gy = (gz * d64[:, None, None, :]).permute(0, 3, 1, 2)
            gxs = torch.nn.grad.conv2d_input(xs.shape, w_oihw, gy, padding=1).permute(0, 2, 3, 1)
            y = torch.nn.functional.conv2d(xs, w_oihw, padding=1).permute(0, 2, 3, 1)
            ref = (gxs * s64[:, None, None, :],
                   torch.nn.grad.conv2d_weight(xs, w_oihw.shape, gy, padding=1)
                   .permute(2, 3, 1, 0),
                   (gxs * x64).sum((1, 2)), (gz * y).sum((1, 2)),
                   (gz.sum(-1) * nw64).sum(0, keepdim=True), (gz.sum(-1) * n64).sum().reshape(1))
            row[f"{name}_vs_f64_on_its_mask"] = {
                n: _max_rel(a, b_) for n, a, b_ in zip(names, grads[name], ref)}
        row["kernel_vs_plain"] = {n: _max_rel(a, b_) for n, a, b_ in
                                  zip(names, grads["kernel"], grads["plain"])}
        print(json.dumps(row), flush=True)


@contextlib.contextmanager
def styled_conv_forward_on_cudnn():
    sc = importlib.import_module("latent2im_tpu_torch.ops.styled_conv")
    saved, sc._forward = sc._forward, sc.styled_conv3x3_plain
    try:
        yield
    finally:
        sc._forward = saved


def phase22_variants(chip_smoke, dev):
    import torch

    @contextlib.contextmanager
    def deterministic():
        torch.backends.cudnn.deterministic = True
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic = False

    runs = [("default", contextlib.nullcontext), ("default again", contextlib.nullcontext),
            ("styled conv forward on cuDNN", styled_conv_forward_on_cudnn),
            ("deterministic cuDNN", deterministic)]
    for tag, ctx in runs:
        with ctx():
            out = chip_smoke.gan_grads_phase(dev, enforce=False)
        groups = out["groups"]
        noise = {k: v for k, v in groups.items() if k.startswith("g:noises.")
                 or k.endswith("noise.weight")}
        rest = {k: v for k, v in groups.items() if k not in noise}
        summary = {"run": tag, "image_grad": out["image_grad"]}
        for name, part in (("noise", noise), ("rest", rest)):
            worst = max(part, key=lambda k: part[k]["card"])
            summary[name] = {"worst": worst, **part[worst],
                             "card_range": [min(v["card"] for v in part.values()),
                                            max(v["card"] for v in part.values())],
                             "cpu_f32_range": [min(v["cpu_f32"] for v in part.values()),
                                               max(v["cpu_f32"] for v in part.values())]}
        summary["noise_weights"] = {k: v for k, v in noise.items() if k.endswith("weight")}
        print(json.dumps(summary), flush=True)


def f64_reference_on_the_card(chip_smoke, dev, size: int = 64):
    import numpy as np
    import torch

    from latent2im_tpu_torch.models.stylegan2 import Discriminator, Generator

    gen = torch.Generator().manual_seed(25)
    g, d = Generator(size, generator=gen), Discriminator(size, generator=gen)
    with torch.no_grad():
        for n, p in g.named_parameters():
            if n.endswith("noise.weight"):
                p.fill_(chip_smoke.NOISE_WEIGHT)
    rng = np.random.RandomState(25)
    z, real, eps = (torch.from_numpy(a) for a in (
        rng.randn(2, 512), 0.5 * rng.randn(2, size, size, 3), rng.uniform(size=(2, 1, 1, 1))))
    _, cpu, _ = chip_smoke.gan_grads(copy.deepcopy(g).double(), copy.deepcopy(d).double(),
                                     z, real, eps)
    with chip_smoke.plain_kernels():
        _, card, _ = chip_smoke.gan_grads(copy.deepcopy(g).to(dev, torch.float64),
                                          copy.deepcopy(d).to(dev, torch.float64),
                                          z.to(dev), real.to(dev), eps.to(dev))
    worst = max((chip_smoke.rel_l2(card[k][n], cpu[k][n]), f"{k}:{n}")
                for k in ("d", "g") for n in cpu[k])
    print(json.dumps({"f64_card_vs_cpu": {"size": size, "worst_rel_l2": worst[0],
                                          "param": worst[1]}}), flush=True)


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("torch_gan_grad_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.ops import _build

    print(json.dumps({"card": chip_smoke.card_line()}), flush=True)
    _build.build()
    dev = resolve_device("cuda")
    styled_conv_backward(dev)
    phase22_variants(chip_smoke, dev)
    f64_reference_on_the_card(chip_smoke, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
