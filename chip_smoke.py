#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (latent2im_tpu_torch) on one GPU.

    python3 chip_smoke.py

Two main paths run at full width on seeded random weights (StyleGAN2
style_dim 512, n_mlp 8, channel multiplier 2; ResNet-50/40; Smiling): the
edit server and the walk-training loop, at 256 px (phases 3-10) and at
1024 px (phases 11-15, with the remat and input-size options and the eval
CLI). Phases (a failed
phase raises, and the script exits non-zero):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build the hand-written kernels from ops/csrc with nvcc (sm_90a);
  3. kernels: each of the five kernels (fused_act, upfirdn2d, styled_conv3x3
     forward; fused_act and upfirdn2d backward) at every shape one 256 px
     apply_alpha (B=4) or one training step (B=4) gives it, held against its
     plain PyTorch version on the card (f32, TF32 off), then timed with CUDA
     events beside its bound, the plain version and one PyTorch library call
     computing the same function, and alone on the device (a CUDA graph of
     ten calls, no host gap); the styled conv's bound is its 3xTF32 work on
     the tensor cores (the f32 CUDA-core bound is logged beside it), with
     the tiling each shape took, and every upfirdn2d shape must take a
     templated form of its kernel;
  4. serving: the edit server (serve_batch 4, 5 panels) answers /healthz,
     /edit of 1 and 4 samples and /sweep over HTTP; the launch counts, set to
     0 just before, must show every request went through the three forward
     kernels;
  5. one apply_alpha (B=4) under torch.profiler: device time by kernel group
     and the device's busy share (trace in chiprun_out/);
  6. the same apply_alpha (B=1, same weights) on cuda and on cpu must agree;
  7. training: train_loop (Smiling, linear_w, B=4, 10*BCE + 0.05*VGG +
     0.05*GAN, Adam) for TRAIN_STEPS steps after a warmup; the launch counts,
     set to 0 just before, must equal TRAIN_STEPS times the per-step counts
     of all five kernels; losses finite, the walk moved;
  8. one training step under torch.profiler, as phase 5;
  9. one training step (B=2, same weights, stored noise, host alphas) on
     cuda and on cpu must agree in loss and walk gradient;
 10. the CLIs (chiprun_out/cli/): cli.train.run (Smiling, B=4, 8 samples,
     2 epochs) with a SIGTERM after its second step, then --resume to the
     final checkpoint, whose walk, and the last epoch's Adam state, must
     reload bit for bit; train_multi_attr (Smiling,Young, one step) through
     its main(); `python -m latent2im_tpu_torch.cli.vis_w` as two processes
     (2 samples x 5 panels; the --combine_indices grid), PNGs and
     index.html; the server with --save_path_w, warmed as its main() warms
     it, whose /edit of 4 must give apply_alpha's uint8 images exactly
     (cuDNN set to deterministic algorithms for this part). The launch
     counts, set to 0 before each
     in-process part, must show all five kernels in training and the three
     forward kernels in serving.
 11. kernels at the 1024 px shapes: phase 3 at 1024 px, B=8 (the styled
     conv at 512^2 x 64 and 1024^2 x 32, upfirdn2d and fused_act at every
     site of one edit and one training step);
 12. the 1024 px generator (tests/fullscale_ref.py's seeded full-width
     g_ema, strict) against tests/fixtures/ref_outputs_1024px.npz, relative
     L2 and max-abs within 5e-3 of scale;
 13. the 1024 px edit server (serve_batch 8): apply_alpha at B=8 (CUDA
     events, then once under torch.profiler) and one /edit of 8, counted,
     equal to apply_alpha's uint8 images under deterministic cuDNN;
 14. 1024 px walk training (B=8, Smiling, linear_w, full towers) under five
     configurations: plain, --remat_g, --remat_g block, --remat_g block
     --remat_towers, --reg_input_size 256 --content_input_size 256; G's
     noise weights set to 0.3 (the seeded init's are 0, a trained G's are
     not); per configuration ms per train_loop step (mean and spread),
     samples/s, peak GB, and launch counts equal to the plain step's plus
     one forward of each checkpointed region (remat_extra); each remat
     configuration's step held to the plain step from the same state,
     alphas and fresh noise (loss terms 1e-5 relative, the walk gradient
     within phase 9's bound, which another noise draw must exceed); one
     plain step under torch.profiler;
 15. `python -m latent2im_tpu_torch.cli.eval` at 1024 px on phase 14's walk,
     whitened and --ref_parity, two processes: eval_report.json's keys,
     identity_is_relative_only, finite numbers in the non-empty buckets.
Phase 3 times fused_act's backward as both main paths call it (dx only;
the towers are frozen), and holds its bias gradient apart at one shape.
It ends with one JSON line of the kernels' numbers and, last, the line
{"ok": true, "device": {...}}. Per-shape details go to
chiprun_out/chip_smoke.json. Exits non-zero, printing no result, without a
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
SIZE, BATCH, PANELS = 256, 4, 5
TRAIN_STEPS, TRAIN_WARMUP, CMP_BATCH = 10, 2, 2
# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s, f32 on the CUDA cores,
# TF32 on the tensor cores (3xTF32 issues three TF32 products per f32 one)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
# peak rate of the operations each kernel runs: the styled conv's f32
# multiply-adds run as 3xTF32 on the tensor cores, the others on the CUDA cores
FLOPS = {"styled_conv3x3": TF32_FLOPS / 3}
# of max|ref|; the styled conv reads ~4e-6 from its plain version (cuDNN's
# f32, itself 2e-6-4e-6 from f64), a variant without the flush of its
# partial sums ~4e-5 (it failed phase 9's walk gradient)
TOL = {"fused_act": 1e-6, "fused_act_bwd": 1e-6, "upfirdn2d": 1e-5,
       "upfirdn2d_bwd": 1e-5, "styled_conv3x3": 1e-5}
SOURCE = {
    "fused_act": ("latent2im_tpu_torch/ops/csrc/fused_act.cu",
                  "latent2im_tpu/ops/pallas_kernels.py:99"),
    "fused_act_bwd": ("latent2im_tpu_torch/ops/csrc/fused_act.cu",
                      "latent2im_tpu/ops/pallas_kernels.py:122"),
    "upfirdn2d": ("latent2im_tpu_torch/ops/csrc/upfirdn2d.cu",
                  "latent2im_tpu/ops/pallas_kernels.py:296"),
    "upfirdn2d_bwd": ("latent2im_tpu_torch/ops/csrc/upfirdn2d.cu",
                      "latent2im_tpu/ops/pallas_kernels.py:311"),
    "styled_conv3x3": ("latent2im_tpu_torch/ops/csrc/styled_conv3x3.cu",
                       "latent2im_tpu/ops/pair_conv.py:142"),
}
FORWARD = ("fused_act", "upfirdn2d", "styled_conv3x3")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 25) -> float:
    """Median of per-call CUDA-event times after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def device_ms(fn, reps: int = 10, iters: int = 5) -> float:
    """Device time of one call without the host's launch gap: `reps` calls
    captured in one CUDA graph, the graph replayed `iters` times; median per
    call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, warmup=1, iters=iters) / reps


def bound_ms(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------


def main_path_shapes(size=SIZE, b=BATCH):
    """{(kernel, case): [launches per apply_alpha, launches per training
    step]} at ``size`` px, batch ``b``. One apply_alpha = one style MLP
    (get_w) + two syntheses; one training step = the same forward, D on the
    edited image, and the backward of the edited synthesis and of D.

    Cases: fused_act / fused_act_bwd the shape; upfirdn2d / upfirdn2d_bwd
    (B, H, W, C, up, pad, gain) of the forward call (down is 1 on both
    paths); styled_conv3x3 (B, H, Cin, Cout)."""
    from collections import Counter

    from latent2im_tpu_torch.models.stylegan2 import channel_table

    ch = channel_table(2)
    res = [2 ** i for i in range(3, int(math.log2(size)) + 1)]  # 8 .. size
    serve, train = Counter(), Counter()

    def add(key, n_serve, n_train):
        serve[key] += n_serve
        train[key] += n_train

    # style MLP (8 layers); D's final_linear.0 has the same shape
    add(("fused_act", (b, 512)), 8, 9)
    for r in res:
        # up styled conv (x2 forward), its act and blur backward (edited)
        add(("fused_act", (b, r, r, ch[r])), 2, 2)
        add(("fused_act_bwd", (b, r, r, ch[r])), 0, 1)
        blur = ("upfirdn2d", (b, r + 1, r + 1, ch[r], 1, (1, 1), 4.0))
        skip = ("upfirdn2d", (b, r // 2, r // 2, 3, 2, (2, 1), 4.0))
        for key in (blur, skip):
            add(key, 2, 2)
            add(("upfirdn2d_bwd", key[1]), 0, 1)
        # non-up styled conv: forward x2, backward through fused_act_bwd
        add(("styled_conv3x3", (b, r, ch[r], ch[r])), 2, 2)
        add(("fused_act_bwd", (b, r, r, ch[r])), 0, 1)
    add(("styled_conv3x3", (b, 4, ch[4], ch[4])), 2, 2)
    add(("fused_act_bwd", (b, 4, 4, ch[4])), 0, 1)
    # D on the edited image: from_rgb, per res block conv1, conv2 (after a
    # pad (2, 2) blur) and the 1x1 skip (after a pad (1, 1) blur),
    # final_conv, final_linear.0; each backpropagated once
    d_acts = [(b, size, size, ch[size])]
    for r in reversed(res):
        d_acts += [(b, r, r, ch[r]), (b, r // 2, r // 2, ch[r // 2])]
        for pad in ((2, 2), (1, 1)):
            key = (b, r, r, ch[r], 1, pad, 1.0)
            add(("upfirdn2d", key), 0, 1)
            add(("upfirdn2d_bwd", key), 0, 1)
    d_acts.append((b, 4, 4, ch[4]))
    for shape in d_acts:
        add(("fused_act", shape), 0, 1)
        add(("fused_act_bwd", shape), 0, 1)
    add(("fused_act_bwd", (b, 512)), 0, 1)
    return {key: (serve[key], train[key]) for key in {**serve, **train}}


def _upfirdn_library(x_nhwc, k, up, down, pads):
    """One depthwise cuDNN call computing upfirdn2d (up 1, or the x2
    upsample with pad (2, 1) as a transposed conv)."""
    import torch
    import torch.nn.functional as F

    c = x_nhwc.shape[-1]
    x = x_nhwc.permute(0, 3, 1, 2)
    kh, kw = k.shape
    if up == 1:
        px0, px1, py0, py1 = pads
        wf = torch.flip(k, (0, 1)).expand(c, 1, kh, kw)
        return lambda: F.conv2d(F.pad(x, (px0, px1, py0, py1)), wf, stride=down, groups=c)
    assert up == 2 and down == 1 and pads == (2, 1, 2, 1) and k.shape == (4, 4)
    ke = k.expand(c, 1, kh, kw)
    return lambda: F.conv_transpose2d(x, ke, stride=2, padding=1, groups=c)


def kernel_cases(name, case, gen, dev):
    """-> (kernel call, plain call, library call, bytes, flops, f64 call or
    None, the input tensor). Calls return a tensor or a tuple of tensors;
    the f64 call is the plain version on the same inputs in f64 (the styled
    conv's)."""
    import torch
    import torch.nn.functional as F

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.ops.upfirdn2d import out_size

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    sqrt2 = math.sqrt(2.0)
    if name == "fused_act":
        shape = case
        x, b = randn(*shape), 0.1 * randn(shape[-1])
        n = x.numel()
        return (lambda: ops.fused_leaky_relu(x, b),
                lambda: ops.fused_leaky_relu_plain(x, b),
                lambda: F.leaky_relu(x + b, 0.2) * sqrt2,
                8 * n + 4 * b.numel(), 3 * n, None, x)
    if name == "fused_act_bwd":
        # dx only, as both main paths call it: G, D and the towers are
        # frozen, so no bias gradient is asked for (fused_act_db_check holds
        # db apart)
        shape = case
        g, out = randn(*shape), randn(*shape)
        n = g.numel()
        return (lambda: ops.fused_leaky_relu_bwd(g, out, bias_grad=False)[0],
                lambda: ops.fused_leaky_relu_bwd_plain(g, out, bias_grad=False)[0],
                lambda: torch.where(out > 0, g, 0.2 * g) * sqrt2,
                12 * n, 2 * n, None, g)
    if name in ("upfirdn2d", "upfirdn2d_bwd"):
        bsz, h, w, c, up, pad, gain = case
        k = torch.as_tensor(ops.make_kernel([1, 3, 3, 1]), device=dev) * gain
        pads = (pad[0], pad[1], pad[0], pad[1])
        oh, ow = (out_size(n, up, 1, pad[0], pad[1], 4) for n in (h, w))
        if name == "upfirdn2d":
            x = randn(bsz, h, w, c)
            out_n = bsz * oh * ow * c
            return (lambda: ops.upfirdn2d(x, k, up=up, pad=pad),
                    lambda: ops.upfirdn2d_plain(x, k, up=up, pad=pad),
                    _upfirdn_library(x, k, up, 1, pads),
                    4 * (x.numel() + out_n + 16), 2 * (16 // (up * up)) * out_n, None, x)
        g = randn(bsz, oh, ow, c)
        gup, gdown, gpads = ops.transposed_params((4, 4), up, 1, pad, (h, w), (oh, ow))
        kf = torch.flip(k, (0, 1))
        in_n = bsz * h * w * c
        return (lambda: ops.upfirdn2d_bwd(g, k, up, 1, pad, (h, w)),
                lambda: ops.upfirdn2d_plain(g, kf, gup, gdown, gpads),
                _upfirdn_library(g, kf, gup, gdown, gpads),
                4 * (g.numel() + in_n + 16), 2 * 16 * in_n, None, g)
    bsz, h, cin, cout = case
    x = randn(bsz, h, h, cin)
    w = randn(3, 3, cin, cout) / math.sqrt(9 * cin)
    s = 1.0 + 0.2 * randn(bsz, cin)
    d = torch.rsqrt(s.square() @ w.square().sum((0, 1)) + 1e-8)
    noise, nw, bias = randn(1, h, h), torch.full((1,), 0.3, device=dev), 0.1 * randn(cout)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    w_oihw = w.permute(3, 2, 0, 1).contiguous()

    def library():  # the rosinality grouped-conv form
        wt = w_oihw[None] * s[:, None, :, None, None] * d[:, :, None, None, None]
        out = F.conv2d(x_nchw.reshape(1, bsz * cin, h, h),
                       wt.reshape(bsz * cout, cin, 3, 3), padding=1, groups=bsz)
        out = out.view(bsz, cout, h, h) + nw * noise[:, None] + bias[:, None, None]
        return F.leaky_relu(out, 0.2) * sqrt2

    args = (x, w, s, d, noise, nw, bias)
    nbytes = 4 * (x.numel() + w.numel() + s.numel() + d.numel() + noise.numel()
                  + 1 + cout + bsz * h * h * cout)
    return (lambda: ops.styled_conv3x3(*args), lambda: ops.styled_conv3x3_plain(*args),
            library, nbytes, 2 * bsz * h * h * 9 * cin * cout,
            lambda: ops.styled_conv3x3_plain(*(a.double() for a in args)), x)


def kernel_variant(name, case, inp, got):
    """The kernel instance a main-path shape takes: the styled conv's tiling
    and split count, upfirdn2d's form for the launch that read `inp` and
    wrote `got` (which must be a templated one)."""
    from latent2im_tpu_torch import ops

    if name == "styled_conv3x3":
        bsz, h, cin, cout = case
        return ops.styled_conv3x3_plan(bsz, h, h, cin, cout)
    if name in ("upfirdn2d", "upfirdn2d_bwd"):
        up = case[4]  # the gradient is the op with up and down swapped
        form = ops.upfirdn2d_form(inp, got, (4, 4), *((up, 1) if name == "upfirdn2d"
                                                      else (1, up)))
        if not form.startswith("templated"):
            raise AssertionError(f"{name} {case}: takes the {form} form")
        return form
    return None


def _max_err(got, want):
    """(max abs error, max |reference|) over a result or tuple of results."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [((a - b).abs().max().item(), b.abs().max().item()) for a, b in zip(got, want)]
    return max(e for e, _ in errs), min(m for _, m in errs)


def fused_act_db_check(gen, dev):
    """The bias gradient of fused_act's backward (dx from the kernel, then a
    sum over rows), which no main path asks for, held against the plain
    version by value at the largest main-path shape; not timed."""
    import torch

    from latent2im_tpu_torch import ops

    shape = (BATCH, SIZE, SIZE, 128)
    g, out = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
    err, scale = _max_err(ops.fused_leaky_relu_bwd(g, out),
                          ops.fused_leaky_relu_bwd_plain(g, out))
    if not (math.isfinite(err) and err <= TOL["fused_act_bwd"] * scale):
        raise AssertionError(f"fused_act_bwd (dx, db) {shape}: max abs err {err:.3e}")
    log(f"    fused_act_bwd with db {shape}: max abs err {err:.3e} (not timed)")
    return err


def kernel_phase(dev, size=SIZE, batch=BATCH, iters=25):
    """Per kernel, per main path at ``size`` px, batch ``batch``: launches
    and the sums over shapes of launches x (kernel, plain, library, bound)
    ms. Each call is timed as the median of ``iters`` CUDA-event times."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {n: {p: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                       "device_ms": 0.0, "launches": 0}
                   for p in ("apply_alpha", "train_step")}
               for n in SOURCE}
    max_err = dict.fromkeys(SOURCE, 0.0)
    details = []
    for (name, case), counts in sorted(main_path_shapes(size, batch).items(), key=str):
        kern, plain, lib, nbytes, flops, f64, inp = kernel_cases(name, case, gen, dev)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err, scale = _max_err(got, want)
        ref = to_f64 = None  # the kernel's and the plain version's error / max|ref| in f64
        if f64 is not None:
            ref = f64()
            to_f64 = {k: (v.double() - ref).abs().max().item() / ref.abs().max().item()
                      for k, v in (("kernel", got), ("plain", want))}
        if not (math.isfinite(err) and err <= TOL[name] * scale):
            raise AssertionError(
                f"{name} {case}: max abs err {err:.3e} > {TOL[name]} * "
                f"max|ref| {scale:.3e}")
        max_err[name] = max(max_err[name], err)
        t_k, t_p, t_l = (time_ms(f, iters=iters) for f in (kern, plain, lib))
        t_d = device_ms(kern)
        rate = FLOPS.get(name, F32_FLOPS)
        b_ms, _ = bound_ms(nbytes, flops, rate)
        f32_ms = bound_ms(nbytes, flops)[0] if rate != F32_FLOPS else None
        variant = kernel_variant(name, case, inp, got)
        if variant is not None:
            log(f"    {name} {case}: {variant}; {t_k:.4f} ms (device {t_d:.4f}), "
                f"library {t_l:.4f}, bound {b_ms:.4f}"
                + (f" (f32 CUDA-core bound {f32_ms:.4f})" if f32_ms else ""))
        if to_f64 is not None:
            log(f"    {name} {case}: max error / max|ref| against f64: kernel "
                f"{to_f64['kernel']:.3e}, plain (cuDNN f32) {to_f64['plain']:.3e}")
        details.append({"kernel": name, "size": size, "case": repr(case), "variant": variant,
                        "err_to_f64": to_f64,
                        "f32_bound_ms": f32_ms,
                        "launches_per_apply_alpha": counts[0],
                        "launches_per_train_step": counts[1],
                        "max_abs_err": err, "max_abs_ref": scale, "ms": t_k,
                        "device_ms": t_d,
                        "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
                        "bytes": nbytes, "flops": flops})
        for path, n in zip(("apply_alpha", "train_step"), counts):
            r = results[name][path]
            r["ms"] += n * t_k
            r["device_ms"] += n * t_d
            r["plain_ms"] += n * t_p
            r["library_ms"] += n * t_l
            r["bound_ms"] += n * b_ms
            r["bytes_ms"] += n * nbytes / HBM_BYTES_PER_S * 1e3
            r["ops_ms"] += n * flops / rate * 1e3
            r["launches"] += n
        del kern, plain, lib, f64, inp, got, want, ref
    if size == SIZE:
        details.append({"kernel": "fused_act_bwd", "case": "with db (not on a main path)",
                        "max_abs_err": fused_act_db_check(gen, dev)})
    torch.cuda.empty_cache()
    for name, paths in results.items():
        for r in paths.values():
            r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
        r = paths["train_step"]
        a = paths["apply_alpha"]
        log(f"  {name} ({size} px, B={batch}): max abs err {max_err[name]:.3e}; per training step "
            f"{r['launches']} launches, {r['ms']:.4f} ms (device {r['device_ms']:.4f}, plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}; share of bound {r['bound_ms'] / r['ms']:.0%}, "
            f"on the device clock {r['bound_ms'] / r['device_ms']:.0%}); per apply_alpha "
            f"{a['launches']} launches, {a['ms']:.4f} ms")
    return results, max_err, details


# ---------------------------------------------------------------------------
# phase 4: the edit server
# ---------------------------------------------------------------------------


def png_decode(data: bytes):
    """Minimal decoder for the server's PNGs (8-bit, filter 0 rows)."""
    import numpy as np

    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    assert depth == 8 and color == 2, hdr
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def _request(url, obj) -> dict:
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        code, out = r.status, json.loads(r.read())
    if code != 200:
        raise AssertionError(f"{url}: HTTP {code}")
    return out


def _post(url, obj):
    """-> (reply, decoded images of the reply)."""
    import base64

    out = _request(url, obj)
    return out, [png_decode(base64.b64decode(b)) for b in
                 (out["images"] if "images" in out else
                  [x for row in out["panels"] for x in row])]


@contextlib.contextmanager
def serving(service):
    """The edit server on a free localhost port, in a thread -> its URL;
    shut down on exit."""
    from latent2im_tpu_torch.cli.serve import make_server

    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def serve_phase(results, dev):
    import argparse

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli.serve import build_service
    from latent2im_tpu_torch.config.options import TrainOptions
    from latent2im_tpu_torch.engine.editor import SWEEP_CHUNK, _balanced_chunk

    conf = TrainOptions().parse(
        ["--model", "stylegan_v2_real", "--transform", "face", "--walk_type",
         "linear", "--latent", "w", "--attrList", "Smiling", "--resolution",
         str(SIZE), "--models_dir", os.path.join(REPO, "chiprun_out")],
        print_opt=False)
    opt = argparse.Namespace(save_path_w=None, save_path_gan=None, attrList=None,
                             attrPath="", num_panels=PANELS, min_alpha=0.0,
                             max_alpha=1.0, serve_batch=BATCH)
    t0 = time.perf_counter()
    service = build_service(opt, conf)  # cuda: the entry point's default
    assert service.ed.device.type == dev.type
    assert service.ed.cfg.attr_idx == (31,) and service.dim_z == 512
    service.warmup()
    torch.cuda.synchronize()
    log(f"  service built and warmed in {time.perf_counter() - t0:.1f} s")
    with serving(service) as url:
        ops.reset_launches()
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["size"] == SIZE, health
        out1, im1 = _post(url + "/edit", {"seed": 1, "num_samples": 1, "alpha": 0.9})
        out4, im4 = _post(url + "/edit", {"seed": 2, "num_samples": 4, "alpha": 0.1})
        outs, ims = _post(url + "/sweep", {"seed": 3, "num_samples": 4})
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert len(im1) == 1 and len(im4) == 4 and len(ims) == PANELS * 4
        for im in im1 + im4 + ims:
            assert im.shape == (SIZE, SIZE, 3) and im.dtype == np.uint8
        for a in out1["alpha_org"] + out4["alpha_org"] + outs["alpha_org"]:
            assert all(math.isfinite(v) for v in a), a
        assert len(outs["panels"]) == PANELS
        per_alpha = {name: r["apply_alpha"]["launches"] for name, r in results.items()}
        n_chunks = -(-PANELS * BATCH // _balanced_chunk(PANELS * BATCH, SWEEP_CHUNK))
        per_synth = {"fused_act": (per_alpha["fused_act"] - 8) // 2,
                     "upfirdn2d": per_alpha["upfirdn2d"] // 2,
                     "styled_conv3x3": per_alpha["styled_conv3x3"] // 2}
        expect = {k: 2 * per_alpha[k] + (1 + n_chunks) * per_synth.get(k, 0)
                  + (8 if k == "fused_act" else 0) for k in per_alpha}
        log(f"  launches over /healthz + 2 /edit + 1 /sweep: {counts} "
            f"(expected {expect})")
        assert counts == expect, (counts, expect)
        assert all(counts[k] > 0 for k in FORWARD)

        lat, n_img = [], 0
        t_all = time.perf_counter()
        for i in range(10):  # timed to the parsed JSON reply; no client decode
            t = time.perf_counter()
            out = _request(url + "/edit", {"seed": 10 + i, "num_samples": BATCH,
                                           "alpha": 0.7})
            lat.append((time.perf_counter() - t) * 1e3)
            n_img += len(out["images"])
        wall = time.perf_counter() - t_all
    z = np.random.RandomState(0).randn(BATCH, 512).astype(np.float32)
    a = np.full((BATCH,), 0.7, np.float32)
    dev_ms = time_ms(lambda: service.ed.apply_alpha(service.walk, z, a, u8=True),
                     warmup=2, iters=10)
    serve = {"p50_request_ms": statistics.median(lat), "img_per_s": n_img / wall,
             "requests": len(lat), "images": n_img,
             "apply_alpha_b4_device_ms": dev_ms}
    return service, conf, counts, serve


# ---------------------------------------------------------------------------
# phases 5 and 8: where the device time goes
# ---------------------------------------------------------------------------

KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel name), first match
    ("styled_conv3x3 (ours)", ("styled_conv_tc_kernel", "styled_conv_splitk_reduce_kernel")),
    ("upfirdn2d (ours, forward and backward)", ("upfirdn2d_tiled_kernel",)),
    ("fused_act backward (ours)", ("fused_act_bwd_kernel",)),
    ("fused_act (ours)", ("fused_act_kernel",)),
    ("cuDNN/cuBLAS conv + GEMM", ("cudnn", "xmma", "gemm", "conv", "cutlass", "wgrad",
                                  "dgrad", "implicit", "sm90", "sm80")),
    ("PyTorch elementwise/reduce/copy", ("elementwise", "reduce", "copy", "fill",
                                        "index", "cat", "vectorized")),
)


def profile_call(fn, trace_name):
    """fn() once to warm, then once under torch.profiler: device time by
    kernel group and the device's busy share of the host-timed call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(REPO, "chiprun_out", trace_name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    kernels = [e for e in (events.get("traceEvents", events) if isinstance(events, dict)
                           else events)
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not kernels:
        return {"wall_ms": wall_ms, "device": "not measured (no kernel events in the trace)"}
    groups: dict[str, float] = {}
    for e in kernels:
        name = e["name"].lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(k.lower() in name for k in keys)),
                 "other")
        groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, -1e30
    for s, t in spans:  # union of kernel intervals
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    busy_ms = busy / 1e3
    return {"wall_ms": wall_ms, "kernels": len(kernels), "device_busy_ms": busy_ms,
            "busy_share_of_wall": busy_ms / wall_ms,
            "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}


def profile_phase(service):
    import numpy as np

    z = np.random.RandomState(1).randn(BATCH, 512).astype(np.float32)
    a = np.full((BATCH,), 0.7, np.float32)
    return profile_call(lambda: service.ed.apply_alpha(service.walk, z, a, u8=True),
                        "apply_alpha_trace.json")


# ---------------------------------------------------------------------------
# phase 6: card against CPU
# ---------------------------------------------------------------------------


def cpu_phase(service, conf):
    import numpy as np

    from latent2im_tpu_torch.engine.build import build_editor_from_options

    cpu_ed, cpu_walk, _ = build_editor_from_options(conf, device="cpu")
    z = np.random.RandomState(7).randn(1, 512).astype(np.float32)
    a = np.asarray([0.8], np.float32)
    t = time.perf_counter()
    ce, ca, co = (v.numpy() for v in cpu_ed.apply_alpha(cpu_walk, z, a))
    cpu_s = time.perf_counter() - t
    ge, ga, go = (v.cpu().numpy() for v in service.ed.apply_alpha(service.walk, z, a))
    out = {"cpu_apply_alpha_s": cpu_s}
    for name, g, c in (("edited", ge, ce), ("orig", go, co)):
        assert np.isfinite(g).all() and g.shape == (1, SIZE, SIZE, 3)
        rel = float(np.linalg.norm(g - c) / np.linalg.norm(c))
        out[f"{name}_rel_l2"] = rel
        assert rel < 1e-3, (name, rel)
    err = float(np.abs(ga - ca).max())
    out["alpha_org_abs_err"], out["alpha_org"] = err, float(ca[0, 0])
    assert err <= 1e-3 * max(1.0, float(np.abs(ca).max())), (ga, ca)
    return out


# ---------------------------------------------------------------------------
# phases 7-9: walk training
# ---------------------------------------------------------------------------


def train_conf(*flags, size=None, batch=None, root=None, print_opt=False):
    """Training options (Smiling, linear_w) at ``size`` px, batch ``batch``
    (SIZE, BATCH by default); print_opt writes opt.yml under ``root``."""
    from latent2im_tpu_torch.config.options import TrainOptions

    return TrainOptions().parse(
        ["--model", "stylegan_v2_real", "--transform", "face", "--walk_type",
         "linear", "--latent", "w", "--attrList", "Smiling", "--resolution",
         str(size or SIZE), "--batch_size", str(batch or BATCH), "--models_dir",
         root or os.path.join(REPO, "chiprun_out"), "--overwrite_config", *flags],
        print_opt=print_opt)


def train_phase(results, dev):
    """train_loop at B=4: TRAIN_WARMUP steps, then TRAIN_STEPS counted and
    timed steps (losses read back every step, as the training CLI logs)."""
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import train_loop
    from latent2im_tpu_torch.tasks.transforms import get_task

    conf = train_conf()
    t0 = time.perf_counter()
    ed, walk, _ = build_editor_from_options(conf)  # cuda: the default
    assert ed.device.type == dev.type and ed.d is not None and ed.vgg is not None
    task = get_task(conf.transform, walk_type=conf.walk_type, nsliders=1)
    run = dict(batch_size=BATCH, n_epochs=1, lr=conf.learning_rate, log_every=1)
    walk, _ = train_loop(ed, task, walk, num_samples=TRAIN_WARMUP * BATCH, **run)
    torch.cuda.synchronize()
    log(f"    editor with D and VGG19 built and {TRAIN_WARMUP} warmup steps in "
        f"{time.perf_counter() - t0:.1f} s")
    w0 = walk["w"].detach().clone()
    metrics = []
    ops.reset_launches()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev0.record()
    walk, history = train_loop(ed, task, walk, num_samples=TRAIN_STEPS * BATCH, seed=1,
                               on_step=lambda e, i, m, dt, wp: metrics.append(m), **run)
    ev1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    per_step = {n: r["train_step"]["launches"] for n, r in results.items()}
    expect = {n: TRAIN_STEPS * v for n, v in per_step.items()}
    log(f"    launches over {TRAIN_STEPS} steps: {counts} (expected {expect})")
    assert counts == expect, (counts, expect)
    assert len(metrics) == TRAIN_STEPS
    for m in metrics:
        assert all(math.isfinite(v) for v in m.values()), m
    moved = (walk["w"].detach() - w0).abs().max().item()
    assert moved > 0, "the walk did not move"
    train = {"steps": TRAIN_STEPS, "batch": BATCH,
             "step_ms_cuda_events": ev0.elapsed_time(ev1) / TRAIN_STEPS,
             "samples_per_s": TRAIN_STEPS * BATCH / wall,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "walk_max_abs_change": moved, "first": metrics[0], "last": metrics[-1]}
    return ed, walk, task, counts, train


def train_profile_phase(ed, walk, task):
    """One training step (B=4) under torch.profiler."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step

    step = make_train_step(ed, task, make_optimizer(walk, 1e-4))
    z = torch.from_numpy(np.random.RandomState(2).randn(BATCH, 512).astype(np.float32))
    gen = torch.Generator(device=ed.device).manual_seed(0)
    return profile_call(lambda: step(walk, z, gen), "train_step_trace.json")


def reference_step(ed, w0, z, sampled, dtype):
    """The step's loss terms and walk gradient at walk w0, composed here
    from the towers in ``dtype`` (an independent reference of
    make_train_step's arithmetic; the towers' f32 output casts are undone)."""
    import torch

    from latent2im_tpu_torch.engine import losses as L

    dev = ed.device
    z, sampled = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (z, sampled))
    w = torch.as_tensor(w0, dtype=dtype, device=dev).requires_grad_(True)
    with torch.no_grad():
        latent = ed.g.style_forward(z)[:, None].expand(-1, ed.cfg.n_latent, -1)
        img_org = ed.g.synthesize(latent).to(dtype)
        alpha_org = ed.reg(img_org)[:, ed._attr_idx].to(dtype)
    img_new = ed.g.synthesize(
        latent + torch.einsum("ba,ald->bld", sampled - alpha_org, w)).to(dtype)
    reg = L.raw_bce(ed.reg(img_new)[:, ed._attr_idx], sampled)
    content = L.content_loss(ed.vgg, img_org, img_new)
    gan = L.gan_loss_from_logits(ed.d(img_new))
    loss = L.combine(reg, content, gan)
    (grad,) = torch.autograd.grad(loss, w)
    terms = {"loss": loss, "reg_loss": reg, "content_loss": content, "gan_loss": gan}
    return {k: v.item() for k, v in terms.items()}, grad.double().cpu().numpy()


def train_cpu_phase():
    """One step (B=2, stored noise, host alphas) from the same seed on cuda
    and on cpu through make_train_step: loss terms within 1e-3. The walk
    gradient of an f32 step at full width is fixed only to ~1e-3 (rounding
    flips LeakyReLU/ReLU kinks; cuDNN differs run to run), so the card's is
    held to an f64 reference on the CPU, at least as close as the CPU's
    own f32 gradient (x1.5), or within 1e-3. The card's step is also run
    again, through the reference's composition, for its own spread."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step
    from latent2im_tpu_torch.tasks.transforms import get_task

    conf = train_conf("--fixed_noise")
    z = np.random.RandomState(8).randn(CMP_BATCH, 512).astype(np.float32)
    sampled, _ = get_task("face").train_alpha_np(np.random.RandomState(9), CMP_BATCH, 1)
    res, out = {}, {}
    for device in ("cuda", "cpu"):
        ed, walk, _ = build_editor_from_options(conf, device=device)
        w0 = walk["w"].detach().cpu().numpy().copy()
        walk["w"].requires_grad_(True)
        step = make_train_step(ed, None, make_optimizer(walk, conf.learning_rate),
                               host_alpha=True)
        t = time.perf_counter()
        m = step(walk, z, sampled=sampled)
        res[device] = ({k: float(v) for k, v in m.items()},
                       walk["w"].grad.detach().cpu().numpy().astype(np.float64))
        out[f"{device}_step_s"] = time.perf_counter() - t
        if device == "cuda":  # the card's own spread: the same step again
            res["cuda_again"] = reference_step(ed, w0, z, sampled, torch.float32)
        del step, walk
    t = time.perf_counter()
    for m in (ed.g, ed.reg, ed.vgg, ed.d):  # the CPU editor, in f64
        m.double()
    ref, ref_grad = reference_step(ed, w0, z, sampled, torch.float64)
    out["cpu_f64_reference_s"] = time.perf_counter() - t
    (mg, gg), (mc, gc) = res["cuda"], res["cpu"]
    for k in ("loss", "reg_loss", "content_loss", "gan_loss"):
        rel = abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30)
        out[f"{k}_rel"] = rel
        assert rel <= 1e-3, (k, mg[k], mc[k])
        assert abs(mc[k] - ref[k]) <= 1e-4 * max(abs(ref[k]), 1e-30), (k, mc[k], ref[k])
    assert np.isfinite(gg).all() and np.abs(gc).max() > 0

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    out["walk_grad_rel_l2_card_cpu"] = rel_l2(gg, gc)
    out["walk_grad_rel_l2_card_card"] = rel_l2(res["cuda_again"][1], gg)
    out["walk_grad_rel_l2_card_f64"] = rel_l2(gg, ref_grad)
    out["walk_grad_rel_l2_cpu_f64"] = rel_l2(gc, ref_grad)
    limit = max(1e-3, 1.5 * out["walk_grad_rel_l2_cpu_f64"])
    out["walk_grad_limit"] = limit
    assert out["walk_grad_rel_l2_card_f64"] <= limit, out
    out["loss"] = mc["loss"]
    return out


# ---------------------------------------------------------------------------
# phase 10: the CLI flow
# ---------------------------------------------------------------------------


def _cli_args(root, attrs, samples, epochs, *extra):
    return ["--model", "stylegan_v2_real", "--transform", "face", "--walk_type", "linear",
            "--latent", "w", "--attrList", attrs, "--resolution", str(SIZE),
            "--batch_size", str(BATCH), "--num_samples", str(samples), "--n_epochs",
            str(epochs), "--models_dir", root, "--overwrite_config", *extra]


def _vis_w(*args):
    """`python -m latent2im_tpu_torch.cli.vis_w ...` as a user types it."""
    return subprocess.Popen(
        [sys.executable, "-m", "latent2im_tpu_torch.cli.vis_w", *args], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _check_vis(proc, out_dir, names):
    try:
        text, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"vis_w exited {proc.returncode}:\n{text[-3000:]}")
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    assert [p[:len(n)] for p, n in zip(pngs, names)] == names, (pngs, names)
    assert len(pngs) == len(names) and os.path.isfile(os.path.join(out_dir, "index.html"))
    return pngs


def cli_phase():
    """The CLIs at 256 px, full width, on the card, in chiprun_out/cli/:
    train (Smiling, SIGTERM after the second step of epoch 0, --resume to
    the final checkpoint), train_multi_attr (Smiling,Young), vis_w as two
    subprocesses (panel sweep; --combine_indices grid), and serve with
    --save_path_w. The launch counts are set to 0 before each in-process part
    and read just after."""
    import base64
    import copy
    import shutil
    import signal

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.cli import train_multi_attr
    from latent2im_tpu_torch.cli.serve import build_service
    from latent2im_tpu_torch.config.options import TrainOptions, VisOptions
    from latent2im_tpu_torch.engine.train import make_optimizer
    from latent2im_tpu_torch.io import checkpoint as ckpt

    root = os.path.join(REPO, "chiprun_out", "cli")
    shutil.rmtree(root, ignore_errors=True)
    out = {"seconds": {}, "launches": {}}
    epoch_end, fired = {}, {"n": 0, "kill": True}
    real_loop = tcli.train_loop

    def loop(*a, **kw):  # SIGTERM after the 2nd step; the epochs' last state
        on_step, on_epoch_end = kw["on_step"], kw["on_epoch_end"]

        def killing_on_step(epoch, i, metrics, dt, wp):
            on_step(epoch, i, metrics, dt, wp)
            fired["n"] += 1
            if fired["kill"] and fired["n"] == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        def recording_on_epoch_end(epoch, wp, st):
            on_epoch_end(epoch, wp, st)
            epoch_end[epoch] = ({k: v.detach().clone() for k, v in wp.items()},
                                copy.deepcopy(st))

        kw.update(on_step=killing_on_step, on_epoch_end=recording_on_epoch_end)
        return real_loop(*a, **kw)

    # train, SIGTERM, --resume
    t0 = time.perf_counter()
    tcli.train_loop = loop
    try:
        ops.reset_launches()
        args = _cli_args(os.path.join(root, "single"), "Smiling", 2 * BATCH, 2,
                         "--model_save_freq", "1")
        opt = TrainOptions().parse(args, print_opt=True)
        tcli.run(opt)  # cuda: the entry point's default
        run_dir = opt.output_dir
        listing = sorted(os.listdir(run_dir))
        resume_from = ckpt.find_resume(run_dir)
        meta = ckpt.load_meta(resume_from)
        assert "model_w_2_final_walk_module.ckpt" not in listing, listing
        assert meta.get("preempted") is True, (resume_from, meta)
        fired["kill"] = False
        walk, history = tcli.run(TrainOptions().parse(args + ["--resume"], print_opt=False))
    finally:
        tcli.train_loop = real_loop
    torch.cuda.synchronize()
    out["launches"]["train"] = ops.launch_counts()
    out["seconds"]["train_sigterm_resume"] = time.perf_counter() - t0
    assert all(v > 0 for v in out["launches"]["train"].values()), out["launches"]
    assert all(math.isfinite(h) for h in history), history
    like = {"w": torch.zeros_like(walk["w"])}
    final_path = os.path.join(run_dir, "model_w_2_final_walk_module.ckpt")
    final, _, _ = ckpt.load_walk(final_path, like)
    assert torch.equal(final["w"], walk["w"].detach()), "final walk differs"
    last_walk, last_state = epoch_end[1]
    w1, st1, _ = ckpt.load_walk(os.path.join(run_dir, "model_w_1_walk_module.ckpt"), like,
                                opt_state_like=make_optimizer(like, 1e-4).state_dict())
    assert torch.equal(w1["w"], last_walk["w"]), "epoch 1 walk differs"
    for key in ("step", "exp_avg", "exp_avg_sq"):
        assert torch.equal(st1["state"][0][key].cpu(), last_state["state"][0][key].cpu()), key
    out.update(preempted_at=os.path.basename(resume_from), preempt_meta=meta,
               resumed_steps=len(history), adam_step=float(st1["state"][0]["step"]))
    del walk, final, w1, st1
    torch.cuda.empty_cache()

    # train_multi_attr, as its main() runs from the command line
    t0 = time.perf_counter()
    multi_args = _cli_args(os.path.join(root, "multi"), "Smiling,Young", BATCH, 1,
                           "--model_save_freq", "0")
    saved_argv = sys.argv
    sys.argv = ["train_multi_attr", *multi_args]
    try:
        ops.reset_launches()
        train_multi_attr.main()
        torch.cuda.synchronize()
        out["launches"]["train_multi_attr"] = ops.launch_counts()
    finally:
        sys.argv = saved_argv
    out["seconds"]["train_multi_attr"] = time.perf_counter() - t0
    assert all(v > 0 for v in out["launches"]["train_multi_attr"].values()), out["launches"]
    multi_dir = TrainOptions().parse(multi_args, print_opt=False).output_dir
    assert len(np.load(os.path.join(multi_dir, "loss_values.npy"))) == 1
    multi_final = os.path.join(multi_dir, "model_w_1_final_walk_module.ckpt")
    torch.cuda.empty_cache()

    # vis_w: the panel sweep and the 2-attribute grid, two processes at once
    t0 = time.perf_counter()
    vis_dirs = (os.path.join(root, "vis"), os.path.join(root, "vis_combine"))
    procs = [
        _vis_w(os.path.join(run_dir, "opt.yml"), "--save_path_w", final_path,
               "--output_dir", vis_dirs[0], "--num_samples", "2", "--num_panels", "5"),
        _vis_w(os.path.join(multi_dir, "opt.yml"), "--save_path_w", multi_final,
               "--output_dir", vis_dirs[1], "--num_samples", "2", "--num_panels", "5",
               "--combine_indices", "31,39")]  # Smiling, Young
    try:
        out["vis_pngs"] = (_check_vis(procs[0], vis_dirs[0], ["sample0_", "sample1_"])
                           + _check_vis(procs[1], vis_dirs[1], [
                               "combine_idx31_idx39_sample0", "combine_idx31_idx39_sample1"]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out["seconds"]["vis_w_two_processes"] = time.perf_counter() - t0

    # serve the trained walk: /edit of 4 over HTTP against apply_alpha. By
    # default cuDNN may pick algorithms that accumulate in a varying order
    # (G's transposed up convs), so two f32 calls can differ in the last bit
    # and a uint8 rounding boundary fall either side; with deterministic
    # algorithms the images must be equal
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    vo = VisOptions()
    vo.parser.add_argument("--serve_batch", type=int, default=BATCH)
    vopt, conf = vo.parse([os.path.join(run_dir, "opt.yml"), "--save_path_w", final_path,
                           "--num_panels", str(PANELS)])
    service = build_service(vopt, conf)
    service.warmup()  # as the server's main() does before it listens
    assert torch.equal(service.walk["w"], last_walk["w"]), "served walk differs"
    z = np.random.RandomState(11).randn(BATCH, 512).astype(np.float32)
    with serving(service) as url:
        ops.reset_launches()
        reply = _request(url + "/edit", {"z": z.tolist(), "alpha": 0.7})
        torch.cuda.synchronize()
        out["launches"]["serve"] = ops.launch_counts()
    out["seconds"]["serve_edit"] = time.perf_counter() - t0
    assert all(out["launches"]["serve"][k] > 0 for k in FORWARD), out["launches"]
    got = np.stack([png_decode(base64.b64decode(b)) for b in reply["images"]])

    def apply_alpha():
        edited, _, _ = service.ed.apply_alpha(
            service.walk, z, np.full(BATCH, 0.7, np.float32), u8=True)
        return edited.cpu().numpy()

    # also against a call from another thread, as the server's handler
    # thread makes it
    box = {}
    worker = threading.Thread(target=lambda: box.update(want=apply_alpha()))
    worker.start()
    worker.join(timeout=600)
    want = apply_alpha()
    torch.backends.cudnn.deterministic = False
    out["edit_vs_apply_alpha"] = {}
    for name, b in (("main_thread", want), ("other_thread", box["want"])):
        assert got.shape == b.shape and got.dtype == b.dtype == np.uint8, (name, b.shape)
        out["edit_vs_apply_alpha"][name] = int((got != b).sum())
    assert not any(out["edit_vs_apply_alpha"].values()), out["edit_vs_apply_alpha"]
    return out


# ---------------------------------------------------------------------------
# phases 11-15: the 1024 px configuration
# ---------------------------------------------------------------------------

SIZE_HI, BATCH_HI, TRAIN_HI_STEPS = 1024, 8, 6
# G's noise weights in phase 14: non-zero, so the edited synthesis's fresh
# noise reaches the gradient that the remat steps are held to
NOISE_WEIGHT = 0.3
# (name, EditorConfig fields, the CLI flags that set them)
TRAIN_HI_CONFIGS = (
    ("plain", {}, ()),
    ("remat_g", {"remat_g": "all"}, ("--remat_g",)),
    ("remat_g block", {"remat_g": "block"}, ("--remat_g", "block")),
    ("remat_g block + remat_towers", {"remat_g": "block", "remat_towers": True},
     ("--remat_g", "block", "--remat_towers")),
    ("input sizes 256", {"reg_input_size": 256, "content_input_size": 256},
     ("--reg_input_size", "256", "--content_input_size", "256")),
)
# the fixture gates of tests/test_parity_fullscale.py:32-45, of image scale
FIXTURE_REL_L2 = FIXTURE_MAX_ABS_FRAC = 5e-3


def forward_1024_phase(dev):
    """tests/fullscale_ref.py's seeded full-width 1024 px g_ema, loaded with
    strict=True, on the card against the committed torch recording
    tests/fixtures/ref_outputs_1024px.npz (stored noise buffers)."""
    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.models.stylegan2 import Generator

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from fullscale_ref import N_MLP, STYLE_DIM, fixture_z, np_state_dict

    g = Generator(SIZE_HI, STYLE_DIM, N_MLP)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in np_state_dict(SIZE_HI).items()},
                      strict=True)
    g = g.to(dev).eval().requires_grad_(False)
    ref = np.load(os.path.join(REPO, "tests", "fixtures", f"ref_outputs_{SIZE_HI}px.npz"))
    want = ref["images"].astype(np.float32)
    z = torch.from_numpy(fixture_z(SIZE_HI, want.shape[0])).to(dev)
    ops.reset_launches()
    with torch.inference_mode():
        got = g(z).cpu().numpy()
    counts = ops.launch_counts()
    scale = float(np.abs(want).max())
    out = {"rel_l2": float(np.linalg.norm(got - want) / np.linalg.norm(want)),
           "max_abs_frac": float(np.abs(got - want).max() / scale), "images": want.shape[0],
           "launches": counts}
    assert got.shape == want.shape and np.isfinite(got).all(), got.shape
    assert out["rel_l2"] < FIXTURE_REL_L2 and out["max_abs_frac"] < FIXTURE_MAX_ABS_FRAC, out
    assert all(counts[k] > 0 for k in FORWARD), counts
    return out


def edit_1024_phase(results_hi, dev):
    """The 1024 px edit server (serve_batch 8): apply_alpha at B=8 timed with
    CUDA events; one /edit of 8 over HTTP, counted, whose uint8 images must
    be apply_alpha's (cuDNN set to deterministic algorithms, as phase 10)."""
    import argparse
    import base64

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli.serve import build_service

    conf = train_conf(size=SIZE_HI, batch=BATCH_HI)
    opt = argparse.Namespace(save_path_w=None, save_path_gan=None, attrList=None,
                             attrPath="", num_panels=PANELS, min_alpha=0.0,
                             max_alpha=1.0, serve_batch=BATCH_HI)
    t0 = time.perf_counter()
    service = build_service(opt, conf)  # cuda: the entry point's default
    service.warmup()
    torch.cuda.synchronize()
    out = {"build_warmup_s": time.perf_counter() - t0}
    z = np.random.RandomState(21).randn(BATCH_HI, service.dim_z).astype(np.float32)
    a = np.full((BATCH_HI,), 0.7, np.float32)

    def apply_alpha():
        return service.ed.apply_alpha(service.walk, z, a, u8=True)[0]

    out["apply_alpha_b8_device_ms"] = time_ms(apply_alpha, warmup=1, iters=5)
    out["profile"] = profile_call(apply_alpha, f"apply_alpha_{SIZE_HI}_trace.json")
    torch.backends.cudnn.deterministic = True
    try:
        want = apply_alpha().cpu().numpy()
        with serving(service) as url:
            ops.reset_launches()
            t = time.perf_counter()
            reply = _request(url + "/edit", {"z": z.tolist(), "alpha": 0.7})
            out["edit_request_ms"] = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
            counts = ops.launch_counts()
    finally:
        torch.backends.cudnn.deterministic = False
    got = np.stack([png_decode(base64.b64decode(b)) for b in reply["images"]])
    assert got.shape == (BATCH_HI, SIZE_HI, SIZE_HI, 3) and got.dtype == np.uint8, got.shape
    out["edit_vs_apply_alpha_differing"] = int((got != want).sum())
    expect = {k: r["apply_alpha"]["launches"] for k, r in results_hi.items()}
    out["launches"] = counts
    log(f"    launches over one /edit of {BATCH_HI}: {counts} (expected {expect})")
    assert counts == expect, (counts, expect)
    assert out["edit_vs_apply_alpha_differing"] == 0, out
    return out


def remat_extra(flags) -> dict:
    """Launches a step's backward adds by recomputing its checkpointed
    regions (utils/remat.py re-runs a whole region): the edited synthesis
    ('all': conv1 and every block; 'block': the blocks), and D."""
    nb = int(math.log2(SIZE_HI)) - 2  # synthesis blocks = D's res blocks
    extra = {"fused_act": 0, "upfirdn2d": 0, "styled_conv3x3": 0}
    if flags.get("remat_g"):
        extra["fused_act"] += nb  # the up convs' activation
        extra["upfirdn2d"] += 2 * nb  # the up convs' blur and to_rgb's skip
        extra["styled_conv3x3"] += nb + (flags["remat_g"] == "all")
    if flags.get("remat_towers"):
        extra["fused_act"] += 2 * nb + 3  # from_rgb, 2 per res block, final conv, linear
        extra["upfirdn2d"] += 2 * nb  # the blurs before each stride-2 conv
    return extra


def train_1024_phase(results_hi, grad_limit, dev):
    """train_loop at 1024 px, B=8 (Smiling, linear_w, full towers) under the
    five configurations of TRAIN_HI_CONFIGS: a warmup step, then
    TRAIN_HI_STEPS counted and timed steps each; then one step of each remat
    configuration against the plain step from the same walk, z, host alphas
    and seeded noise generator. G's noise weights are NOISE_WEIGHT
    throughout. Saves the last configuration's walk and opt.yml for phase
    15."""
    import dataclasses

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.editor import Editor
    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step, train_loop
    from latent2im_tpu_torch.io import checkpoint as ckpt
    from latent2im_tpu_torch.tasks.transforms import get_task

    root = os.path.join(REPO, "chiprun_out", "train1024")
    conf = train_conf(*TRAIN_HI_CONFIGS[-1][2], size=SIZE_HI, batch=BATCH_HI, root=root,
                      print_opt=True)  # writes opt.yml
    t0 = time.perf_counter()
    base, walk, _ = build_editor_from_options(conf)  # cuda: the default
    assert base.cfg.reg_input_size == 256 and base.d is not None and base.vgg is not None
    log(f"    1024 px editor with D and VGG19 built in {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        noise_ws = [p for n, p in base.g.named_parameters() if n.endswith("noise.weight")]
        for p in noise_ws:
            p.fill_(NOISE_WEIGHT)
    assert len(noise_ws) == 2 * int(math.log2(SIZE_HI)) - 3, len(noise_ws)
    w0 = walk["w"].detach().clone()
    task = get_task("face")
    lr = conf.learning_rate
    per_step = {n: r["train_step"]["launches"] for n, r in results_hi.items()}

    def editor(fields):
        cfg = dataclasses.replace(base.cfg, **{"reg_input_size": None,
                                               "content_input_size": None, **fields})
        return Editor(cfg, base.g, base.reg, base.device, vgg=base.vgg, d=base.d)

    out = {"configs": {}}
    for name, fields, flags in TRAIN_HI_CONFIGS:
        ed = editor(fields)
        wp = {"w": w0.clone()}
        run = dict(batch_size=BATCH_HI, n_epochs=1, lr=lr, log_every=1)
        wp, _ = train_loop(ed, task, wp, num_samples=BATCH_HI, **run)  # warmup
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        metrics, step_s = [], []
        ops.reset_launches()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        ev0.record()
        wp, _ = train_loop(ed, task, wp, num_samples=TRAIN_HI_STEPS * BATCH_HI, seed=1,
                           on_step=lambda e, i, m, dt, w: (metrics.append(m),
                                                            step_s.append(dt)), **run)
        ev1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        extra = remat_extra(fields)
        expect = {k: TRAIN_HI_STEPS * (v + extra.get(k, 0)) for k, v in per_step.items()}
        assert counts == expect, (name, counts, expect)
        assert len(metrics) == TRAIN_HI_STEPS and all(
            math.isfinite(v) for m in metrics for v in m.values()), metrics
        r = {"flags": " ".join(flags), "steps": TRAIN_HI_STEPS, "batch": BATCH_HI,
             "step_ms_cuda_events": ev0.elapsed_time(ev1) / TRAIN_HI_STEPS,
             # each step's wall time up to reading its metrics (synchronising)
             "step_ms_wall": [dt * 1e3 for dt in step_s],
             "samples_per_s": TRAIN_HI_STEPS * BATCH_HI / wall,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": counts, "recompute_launches_per_step": extra,
             "last": metrics[-1]}
        out["configs"][name] = r
        log(f"    {name}: {r['step_ms_cuda_events']:.1f} ms per step (wall per step "
            f"{min(r['step_ms_wall']):.1f}-{max(r['step_ms_wall']):.1f}), "
            f"{r['samples_per_s']:.2f} samples/s, peak {r['peak_mem_gb']:.2f} GB, "
            f"launches {counts} (recompute per step {extra})")
        walk = wp
        del ed
        torch.cuda.empty_cache()

    # remat against plain from the same state: one make_train_step step
    # each, host alphas, so the seeded generator draws only the noise
    rng = np.random.RandomState(22)
    z = torch.from_numpy(rng.randn(BATCH_HI, base.cfg.dim_z).astype(np.float32))
    sampled, _ = task.train_alpha_np(rng, BATCH_HI, len(base.cfg.attr_list))

    def one_step(fields, noise_seed=5):
        w = {"w": w0.clone().requires_grad_(True)}
        step = make_train_step(editor(fields), task, make_optimizer(w, lr), host_alpha=True)
        m = step(w, z, torch.Generator(device=dev).manual_seed(noise_seed), sampled)
        terms = {k: float(m[k]) for k in ("loss", "reg_loss", "content_loss", "gan_loss")}
        grad = w["w"].grad.double().cpu().numpy()
        torch.cuda.empty_cache()
        return terms, grad

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    plain_terms, plain_grad = one_step({})
    again_terms, again_grad = one_step({})
    _, other_noise_grad = one_step({}, noise_seed=7)
    w = {"w": w0.clone().requires_grad_(True)}
    step = make_train_step(editor({}), task, make_optimizer(w, lr))
    out["profile"] = profile_call(
        lambda: step(w, z, torch.Generator(device=dev).manual_seed(6)),
        f"train_step_{SIZE_HI}_trace.json")
    del step, w
    out["plain_vs_plain"] = {"grad_rel_l2": rel_l2(again_grad, plain_grad),
                             "terms_rel": {k: abs(again_terms[k] - v) / abs(v)
                                           for k, v in plain_terms.items()}}
    # a remat step whose recompute drew other noise would be this far off
    out["other_noise_vs_plain"] = {"grad_rel_l2": rel_l2(other_noise_grad, plain_grad)}
    assert out["other_noise_vs_plain"]["grad_rel_l2"] > grad_limit, out
    out["remat_vs_plain"] = {"grad_limit": grad_limit}
    for name, fields, _ in TRAIN_HI_CONFIGS[1:4]:
        terms, grad = one_step(fields)
        cmp_ = {"grad_rel_l2": rel_l2(grad, plain_grad),
                "terms_rel": {k: abs(terms[k] - v) / abs(v) for k, v in plain_terms.items()}}
        out["remat_vs_plain"][name] = cmp_
        assert all(v <= 1e-5 for v in cmp_["terms_rel"].values()), (name, cmp_)
        assert cmp_["grad_rel_l2"] <= grad_limit, (name, cmp_, grad_limit)
    out["plain_terms"] = plain_terms
    out["walk_path"] = ckpt.save_walk(conf.output_dir, 1, walk, final=True)
    out["opt_yml"] = os.path.join(conf.output_dir, "opt.yml")
    return out


def eval_1024_phase(opt_yml, walk_path):
    """`python -m latent2im_tpu_torch.cli.eval` on the walk phase 14 saved,
    two processes at once: whitened and --ref_parity preprocessing."""
    root = os.path.join(REPO, "chiprun_out", "eval1024")
    runs = {"whitened": (), "reference": ("--ref_parity",)}
    procs = {}
    for mode, extra in runs.items():
        procs[mode] = subprocess.Popen(
            [sys.executable, "-m", "latent2im_tpu_torch.cli.eval", opt_yml,
             "--save_path_w", walk_path, "--num_samples", str(BATCH_HI),
             "--output_dir", os.path.join(root, mode), *extra],
            cwd=REPO, env={**os.environ, "PYTHONPATH": REPO}, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    out = {}
    try:
        for mode, proc in procs.items():
            text, _ = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"eval ({mode}) exited {proc.returncode}:\n{text[-3000:]}")
            with open(os.path.join(root, mode, "eval_report.json")) as f:
                report = json.load(f)
            assert set(report) == {"embedding", "embedding_preprocess",
                                   "identity_is_relative_only", "results"}, report.keys()
            assert report["embedding"] == "vgg-fallback", report
            assert report["embedding_preprocess"] == mode, report
            assert report["identity_is_relative_only"] is True, report
            res = report["results"]["Smiling"]
            counts = res["bucket_counts"]
            assert len(counts) == 3 and 0 < sum(counts) <= 10 * BATCH_HI, res
            for key in ("identity_preservation", "attribute_preservation"):
                for n, v in zip(counts, res[key]):  # nan exactly where a bucket is empty
                    assert (n > 0) == math.isfinite(v), (mode, key, res)
            out[mode] = res
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def hi_phases(card, dev, grad_limit):
    """Phases 11-15 -> the 1024 px kernel results, their launches per path
    and the phases' reports."""
    import torch

    log(f"[11] kernels against their plain versions at the {SIZE_HI} px B={BATCH_HI} "
        "shapes of apply_alpha and of a training step")
    results, max_err, details = kernel_phase(dev, SIZE_HI, BATCH_HI, iters=10)
    out = {"results": results, "max_err": max_err, "details": details, "launches": {}}

    log(f"[12] the {SIZE_HI} px generator against tests/fixtures/ref_outputs_{SIZE_HI}px.npz")
    out["forward"] = forward_1024_phase(dev)
    out["launches"]["forward_1024"] = out["forward"].pop("launches")
    log(f"    {out['forward']}")
    torch.cuda.empty_cache()

    log(f"[13] the {SIZE_HI} px edit server: apply_alpha B={BATCH_HI}, one /edit")
    out["edit"] = edit_1024_phase(results, dev)
    out["launches"]["serve_1024"] = out["edit"].pop("launches")
    log(f"    apply_alpha B={BATCH_HI} under torch.profiler: {json.dumps(out['edit']['profile'])}")
    log(f"    apply_alpha B={BATCH_HI} {out['edit']['apply_alpha_b8_device_ms']:.2f} ms "
        f"(CUDA events), /edit {out['edit']['edit_request_ms']:.1f} ms, uint8 values "
        f"where /edit differs from apply_alpha {out['edit']['edit_vs_apply_alpha_differing']}"
        f", on {card}")
    torch.cuda.empty_cache()

    log(f"[14] {SIZE_HI} px walk training, train_loop B={BATCH_HI}, five configurations")
    train = train_1024_phase(results, grad_limit, dev)
    out["launches"]["train_1024"] = {
        k: sum(c["launches"][k] for c in train["configs"].values()) for k in SOURCE}
    out["train"] = train
    log(f"    remat against plain: {json.dumps(train['remat_vs_plain'])}; plain against "
        f"itself {json.dumps(train['plain_vs_plain'])}; plain with another noise draw "
        f"{json.dumps(train['other_noise_vs_plain'])}, on {card}")
    log(f"    one plain step under torch.profiler: {json.dumps(train['profile'])}")
    torch.cuda.empty_cache()

    log(f"[15] python -m latent2im_tpu_torch.cli.eval at {SIZE_HI} px, whitened and "
        "--ref_parity")
    t = time.perf_counter()
    out["eval"] = eval_1024_phase(train["opt_yml"], train["walk_path"])
    out["eval"]["seconds"] = time.perf_counter() - t
    log(f"    {json.dumps(out['eval'])}")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "latent2im_tpu_torch")):
        print(f"chip_smoke: no latent2im_tpu_torch/ beside {__file__}: run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    dev = resolve_device("cuda")  # TF32 off for cuDNN and cuBLAS

    path, secs = _build.build()
    _build.library()
    log(f"[2] kernels built in {secs:.1f} s: {os.path.relpath(path, REPO)}")

    log(f"[3] kernels against their plain versions at the {SIZE} px B={BATCH} "
        "shapes of apply_alpha and of a training step")
    results, max_err, details = kernel_phase(dev)

    log(f"[4] main path 1: the {SIZE} px edit server over HTTP")
    service, conf, serve_counts, serve = serve_phase(results, dev)
    log(f"    p50 request latency {serve['p50_request_ms']:.1f} ms, "
        f"{serve['img_per_s']:.2f} img/s ({serve['requests']} /edit requests "
        f"of {BATCH}), apply_alpha B={BATCH} device time "
        f"{serve['apply_alpha_b4_device_ms']:.2f} ms, on {card}")

    log("[5] one apply_alpha (B=4) under torch.profiler")
    prof = profile_phase(service)
    log(f"    {json.dumps(prof)}")

    log("[6] card against CPU (B=1, same weights)")
    cmp_ = cpu_phase(service, conf)
    log(f"    {cmp_}")
    del service
    torch.cuda.empty_cache()

    log(f"[7] main path 2: {SIZE} px walk training, train_loop B={BATCH}")
    ed, walk, task, train_counts, train = train_phase(results, dev)
    log(f"    {train['step_ms_cuda_events']:.2f} ms per step (CUDA events over "
        f"{TRAIN_STEPS} steps), {train['samples_per_s']:.2f} samples/s, peak "
        f"{train['peak_mem_gb']:.2f} GB, loss {train['first']['loss']:.4f} -> "
        f"{train['last']['loss']:.4f}, on {card}")

    log(f"[8] one training step (B={BATCH}) under torch.profiler")
    train_prof = train_profile_phase(ed, walk, task)
    log(f"    {json.dumps(train_prof)}")
    del ed, walk
    torch.cuda.empty_cache()

    log(f"[9] training step, card against CPU (B={CMP_BATCH}, same weights)")
    train_cmp = train_cpu_phase()
    log(f"    {train_cmp}")
    torch.cuda.empty_cache()

    log(f"[10] the CLIs at {SIZE} px: train + SIGTERM + --resume, train_multi_attr, "
        "vis_w (python -m), serve --save_path_w")
    t = time.perf_counter()
    cli = cli_phase()
    cli["seconds"]["phase"] = time.perf_counter() - t
    log(f"    wall seconds {json.dumps(cli['seconds'])} on {card}")
    log(f"    launches {json.dumps(cli['launches'])}; preempted at "
        f"{cli['preempted_at']} {cli['preempt_meta']}, {cli['resumed_steps']} steps "
        f"after --resume, Adam step {cli['adam_step']:.0f}; vis_w wrote {cli['vis_pngs']}; "
        f"uint8 values where /edit differs from apply_alpha "
        f"{json.dumps(cli['edit_vs_apply_alpha'])}")
    torch.cuda.empty_cache()

    hi = hi_phases(card, dev, grad_limit=train_cmp["walk_grad_limit"])

    kernels = []
    for n, paths in results.items():
        r, rh = paths["train_step"], hi["results"][n]["train_step"]
        by_path = {"serve": serve_counts[n], "train": train_counts[n],
                   **{k: v[n] for k, v in hi["launches"].items()}}
        kernels.append({
            "name": n, "route": "cuda", "source": SOURCE[n][0], "replaces": SOURCE[n][1],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(max_err[n], hi["max_err"][n]), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "per": f"training step, {SIZE} px, B={BATCH}",
            "device_ms": r["device_ms"],
            "bound_share_device": r["bound_ms"] / r["device_ms"],
            "per_apply_alpha": paths["apply_alpha"] if n in FORWARD else None,
            f"per_train_step_{SIZE_HI}": {
                "per": f"training step, {SIZE_HI} px, B={BATCH_HI}", **rh,
                "bound_share_device": rh["bound_ms"] / rh["device_ms"]},
            f"per_apply_alpha_{SIZE_HI}": (hi["results"][n]["apply_alpha"]
                                           if n in FORWARD else None)})
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "kernels": kernels, "shapes": details + hi["details"], "serve": serve,
              "profile": prof, "cpu_vs_card": cmp_, "train": train,
              "train_profile": train_prof, "train_cpu_vs_card": train_cmp, "cli": cli,
              "hi": {k: v for k, v in hi.items() if k not in ("results", "details")},
              "seconds": time.perf_counter() - t_start}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"done in {report['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
