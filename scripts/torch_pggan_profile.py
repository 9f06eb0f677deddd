#!/usr/bin/env python3
"""Where the time of a PGGAN edit goes on the card: model_256 at step 6
(G 256 px, edits 128 px), full ladders, seeded weights, B=4.

1. ``apply_alpha`` (CUDA events, median), its peak memory, and the device
   time of its ten slowest kernels under torch.profiler.
2. Each equalized conv of G's ladder at its step-6 shape, B=4, forward
   and forward + input gradient (CUDA events, median), four ways: the
   port's ``models.pggan.conv2d``, ``F.conv2d`` on NCHW, ``F.conv2d`` on
   channels_last tensors, ``F.conv2d`` with cuDNN off (PyTorch's own
   im2col + GEMM), and the same sums as one GEMM over ``F.unfold``'s
   patches; each against the first in f32, as max error / max |ref|.

    python3 scripts/torch_pggan_profile.py

Needs a CUDA card; JSON lines.
"""

from __future__ import annotations

import json
import os
import sys
import warnings

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_pggan_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.models import pggan

    warnings.simplefilter("ignore")
    card = cs.card_line()
    ed, walk, _ = build_editor_from_options(cs.pggan_conf("--no_gan_loss",
                                                          "--no_content_loss"))
    z = torch.from_numpy(np.random.RandomState(0).randn(cs.BATCH, 512).astype(np.float32))
    a = np.full((cs.BATCH,), 0.3, np.float32)
    torch.cuda.reset_peak_memory_stats()
    ms = cs.time_ms(lambda: ed.apply_alpha(walk, z, a), warmup=2, iters=10)
    peak = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ed.apply_alpha(walk, z, a)
        torch.cuda.synchronize()
    top = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()),
                 key=lambda t: -t[1])[:10]
    print(json.dumps({"card": card, "apply_alpha_ms": ms, "peak_gb": peak,
                      "top_kernels_ms": [[k[:90], round(t, 3), c] for k, t, c in top]}),
          flush=True)

    def unfold_gemm(x, w, p):
        h = x.shape[2] + 2 * p - w.shape[2] + 1
        cols = F.unfold(x, w.shape[2:], padding=p)
        return torch.matmul(w.reshape(w.shape[0], -1), cols).reshape(x.shape[0], -1, h, h)

    def nocudnn(x, w, p):
        with torch.backends.cudnn.flags(enabled=False):
            return F.conv2d(x, w, padding=p)

    ways = {"port": lambda x, w, p: pggan.conv2d(x, w, None, p),
            "nchw": lambda x, w, p: F.conv2d(x, w, padding=p),
            "channels_last": lambda x, w, p: F.conv2d(
                x.contiguous(memory_format=torch.channels_last),
                w.contiguous(memory_format=torch.channels_last), padding=p),
            "cudnn_off": nocudnn, "unfold_gemm": unfold_gemm}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for i, (cin, cout) in enumerate(pggan.G_LADDER[:7]):
        r = 4 * 2 ** i
        for name, (ci, co, k, p) in (("conv1", (cin, cout, 4 if i == 0 else 3, 3 if i == 0 else 1)),
                                     ("conv2", (cout, cout, 3, 1))):
            hin = 1 if (i == 0 and name == "conv1") else r
            x = torch.randn((cs.BATCH, ci, hin, hin), generator=gen, device="cuda")
            w = torch.randn((co, ci, k, k), generator=gen, device="cuda") / (ci * k * k) ** 0.5
            ref = ways["nchw"](x, w, p)
            row = {"block": i, "conv": name, "shape": [cs.BATCH, ci, hin, co, k]}
            for way, fn in ways.items():
                xg = x.clone().requires_grad_(True)
                fwd = cs.time_ms(lambda: fn(x, w, p), warmup=2, iters=5)
                bwd = cs.time_ms(lambda: torch.autograd.grad(fn(xg, w, p).sum(), xg),
                                 warmup=1, iters=3)
                err = ((fn(x, w, p) - ref).abs().max() / ref.abs().max()).item()
                row[way] = [round(fwd, 4), round(bwd, 4), err]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
