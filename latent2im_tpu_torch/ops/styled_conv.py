"""Fused StyleGAN2 styled 3x3 conv: modulate -> conv -> demodulate -> noise ->
bias -> LeakyReLU * sqrt(2).

    out = lrelu(conv3x3_same(x * s, w) * d + noise_w * noise + bias) * sqrt(2)

The same function as the JAX package's ``models/stylegan2.py:styled_conv``
for a non-up 3x3 layer, and as its Pallas kernel
``ops/pair_conv.py:fused_styled_conv3x3_pair``. On a CUDA tensor
``styled_conv3x3`` launches the hand-written kernel
``csrc/styled_conv3x3.cu`` (3xTF32 on the tensor cores: a launch that
lays the weight out K-major, the product, and at the small resolutions a
split-K reduction launch; in bf16 with Cout <= 64 and Cin <= 64 one launch
of its thin form); on a CPU tensor it runs the plain PyTorch
version. ``styled_conv3x3_tf32`` repeats the kernel's
numerics in plain PyTorch for the tests.

bf16 (the JAX package's --bf16 compute): x, w, s, d and noise bf16,
noise_w and bias f32, a bf16 result. The kernel's bf16 instance takes
A = bf16(x * s) and the bf16 weight on the tensor cores with f32
accumulation, then the epilogue in f32 and one rounding, as the TPU
kernel does (pair_conv.py:114-133); the plain version on bf16 tensors
computes the same (f32 convolution of the bf16-valued operands), and
``styled_conv3x3_xla`` rounds where the JAX package's XLA form of a bf16
styled conv does, for the tests.

The TPU kernel is forward-only (JAX trains through its XLA form), so there is
no backward kernel to port. When an operand needs a gradient the wrapper
records an autograd node whose backward is device-agnostic torch code: the
fused_act backward (a kernel on cuda, itself differentiable) on the saved
output, then cuDNN convs for the rest (the input gradient, and the weight
gradient that the joint GAN fine-tune takes), so the backward has a graph
of its own under ``create_graph``.

Tensor parallelism (parallel/tensor.py) splits the same function at the
all-reduce of a Cin-sharded (row-parallel) conv:

    acc_r = styled_conv3x3_partial(x_r, w_r, s_r)      # this rank's Cin slice
    acc = sum over ranks of acc_r                      # f32, the all-reduce
    out = styled_conv3x3_epilogue(acc, d, noise, noise_w, bias)

``styled_conv3x3_partial`` launches the kernel with its epilogue switched off
(raw f32 sums, in every form: 3xTF32, bf16 tiled, bf16 thin);
``styled_conv3x3_epilogue`` launches its split-K reduction over the summed
buffer with one split (d, noise, bias, LeakyReLU * gain and one store in
d's dtype). d is applied after the sum: it needs the sum of squares over all
of Cin. Each has its plain twin and an autograd node; the two nodes' backward
is the fused node's cut in two (the epilogue's gives gz, gbias, gnoise, gnw,
gd and gacc = gz * d; the partial's gx, gs and gw from gacc).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _build
from .fused_act import fused_leaky_relu_bwd

SQRT2 = math.sqrt(2.0)


def _conv(xs, w):
    """conv3x3_same of NHWC xs with [3, 3, Cin, Cout] w -> NHWC."""
    return F.conv2d(xs.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def _epilogue(y, d, noise, noise_w, bias, negative_slope, gain):
    out = y * d[:, None, None, :]
    if noise is not None:
        out = out + noise_w * noise[..., None]
    out = out + bias
    return (torch.where(out >= 0, out, out * negative_slope) * gain).contiguous()


def styled_conv3x3_plain(x, w, s, d, noise, noise_w, bias,
                         negative_slope: float = 0.2, gain: float = SQRT2):
    """Plain PyTorch version (same operands as ``styled_conv3x3``). On
    bf16 operands it computes what the kernel's bf16 instance computes, up
    to the order of the sums: A = bf16(x * s) (one rounding of an exact
    product), an f32 convolution of A and the bf16 weight, the epilogue in
    f32, one rounding to bf16."""
    if x.dtype != torch.bfloat16:
        return _epilogue(_conv(x * s[:, None, None, :], w), d, noise, noise_w,
                         bias, negative_slope, gain)
    f = torch.float32
    a = (x.to(f) * s.to(f)[:, None, None, :]).to(x.dtype).to(f)
    out = _epilogue(_conv(a, w.to(f)), d.to(f), None if noise is None else noise.to(f),
                    noise_w.to(f), bias.to(f), negative_slope, gain)
    return out.to(x.dtype)


def styled_conv3x3_xla(x, w, s, d, noise, noise_w, bias,
                       negative_slope: float = 0.2, gain: float = SQRT2):
    """The JAX package's XLA form of a styled conv in x's dtype, with its
    roundings (models/stylegan2.py:146-202, 353-354; ops/fused_act.py): x *
    s, the convolution (f32 sums), the demodulation, noise_w * noise, the
    noise add and the bias add each round to x's dtype, and LeakyReLU * gain
    runs in it. For the tests; no path of the port calls it."""
    dt = x.dtype
    f = torch.promote_types(dt, torch.float32)

    def r(t):  # one operation of the XLA form: f32 math, rounded to dt
        return t.to(dt)

    xs = r(x.to(f) * s.to(f)[:, None, None, :])
    out = r(_conv(xs.to(f), w.to(f)))
    out = r(out.to(f) * d.to(f)[:, None, None, :])
    if noise is not None:
        nz = r(r(noise_w.reshape(())).to(f) * noise.to(f))
        out = r(out.to(f) + nz.to(f)[..., None])
    out = r(out.to(f) + r(bias).to(f)).to(f)
    return r(r(torch.where(out >= 0, out, r(out * negative_slope).to(f))).to(f) * gain)


def tf32_round(t):
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds: add half of the 13 dropped bits' range to
    the magnitude, then clear them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t):
    """t = big + small (to within 2^-22 of |t|), both TF32."""
    big = tf32_round(t)
    return big, tf32_round(t - big)


def styled_conv3x3_tf32(x, w, s, d, noise, noise_w, bias,
                        negative_slope: float = 0.2, gain: float = SQRT2,
                        passes: int = 3):
    """The CUDA kernel's numerics in plain PyTorch (f32 operands): x * s and
    w split into TF32 halves; passes=3 sums the products small*big +
    big*small + big*big (3xTF32, what the kernel computes), passes=1 only
    big*big (single-pass TF32). TF32 products are exact in f32, so f32
    convolutions of the halves give the tensor cores' products; their sums
    round as f32 adds do, not with the tensor cores' truncating
    accumulation, which this does not model. For tests."""
    (ab, al), (bb, bl) = tf32_split(x * s[:, None, None, :]), tf32_split(w)
    if passes == 1:
        y = _conv(ab, bb)
    elif passes == 3:
        y = _conv(al, bb) + _conv(ab, bl) + _conv(ab, bb)
    else:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    return _epilogue(y, d, noise, noise_w, bias, negative_slope, gain)


@functools.lru_cache(maxsize=None)
def styled_conv3x3_plan(b: int, h: int, w: int, cin: int, cout: int,
                        dtype: torch.dtype = torch.float32) -> dict:
    """The CUDA kernel's tiling for a shape and dtype (f32 or bf16):
    {"tile": (BM, BN), "splits": S, "workspace_bytes": n}, the workspace
    holding the K-major weight (in the dtype) and, with S > 1 (split K, a
    last launch reduces), the f32 partial sums. bf16 with Cout <= 64 and
    Cin <= 64 takes the thin form: tile (64, 32) or (64, 64) (N follows
    Cout), no split, no workspace (each block reads the weight itself).
    Cached per shape; do not modify the result."""
    plan = (ctypes.c_int * 3)()
    n = _build.library().l2i_styled_conv3x3_plan(
        b, h, w, cin, cout, int(dtype == torch.bfloat16), ctypes.addressof(plan))
    return {"tile": (plan[0], plan[1]), "splits": plan[2], "workspace_bytes": n}


def _check_operands(x, w, s, d, noise, noise_w, bias):
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    expect = {"w": (3, 3, cin, cout), "s": (b, cin), "d": (b, cout),
              "noise_w": (1,), "bias": (cout,)}
    operands = {"x": x, "w": w, "s": s, "d": d, "noise_w": noise_w.reshape(1),
                "bias": bias}
    if noise is not None:
        if noise.dim() != 3 or noise.shape[0] not in (1, b) or \
                noise.shape[1:] != (h, wd):
            raise ValueError(
                f"styled_conv3x3: noise must be [1|{b}, {h}, {wd}], got "
                f"{tuple(noise.shape)}"
            )
        operands["noise"] = noise
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"styled_conv3x3: f32 or bf16 input, got {x.dtype}")
    for name, t in operands.items():
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(
                f"styled_conv3x3: {name} must be {expect[name]}, got "
                f"{tuple(t.shape)}"
            )
        # noise_w and bias stay f32 (the epilogue's); the rest in x's dtype
        dt = torch.float32 if name in ("noise_w", "bias") else x.dtype
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"styled_conv3x3: {name} must be contiguous {dt} on {x.device}"
            )
    return operands["noise_w"]


def _forward(x, w, s, d, noise, noise_w, bias, negative_slope, gain):
    if x.device.type == "cpu":
        return styled_conv3x3_plain(x, w, s, d, noise, noise_w, bias,
                                    negative_slope, gain)
    noise_w = _check_operands(x, w, s, d, noise, noise_w, bias)
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    n_ws = styled_conv3x3_plan(b, h, wd, cin, cout, x.dtype)["workspace_bytes"]
    ws = torch.empty(n_ws, dtype=torch.uint8, device=x.device)
    rc = _build.library().l2i_styled_conv3x3(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), d.data_ptr(),
        _build.ptr(noise), noise_w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), ws.data_ptr(), b, h, wd, cin, cout,
        int(noise is not None and noise.shape[0] == b and b > 1),
        int(x.dtype == torch.bfloat16), negative_slope, gain, _build.stream_of(x),
    )
    _build.check(rc, "styled_conv3x3")
    _build.count(styled_conv3x3, x)
    return out


def _nchw(t):
    """NHWC -> the NCHW view cuDNN takes (channels_last memory, no copy)."""
    return t.permute(0, 3, 1, 2)


def _input_grads(need, x, w, s, gy, xs=None):
    """(gx, gw, gs) of y = conv3x3_same(x * s, w) from gy (x's dtype) by
    cuDNN, each None where ``need`` (for x, w, s) is false; the reduction of
    gs over pixels in f32 (f64 stays). xs: _nchw(x * s) where the caller
    has it."""
    f = torch.promote_types(x.dtype, torch.float32)
    gx = gw = gs = None
    w_oihw = w.permute(3, 2, 0, 1)
    if need[1]:  # back to [3, 3, Cin, Cout]
        xs = _nchw(x * s[:, None, None, :]) if xs is None else xs
        gw = torch.nn.grad.conv2d_weight(xs, w_oihw.shape, _nchw(gy),
                                         padding=1).permute(2, 3, 1, 0)
    if need[0] or need[2]:
        gxs = torch.nn.grad.conv2d_input(
            _nchw(x).shape, w_oihw, _nchw(gy), padding=1).permute(0, 2, 3, 1)
        if need[0]:
            gx = gxs * s[:, None, None, :]
        if need[2]:
            gs = (gxs.to(f) * x.to(f)).sum((1, 2)).to(s.dtype)
    return gx, gw, gs


def _epilogue_grads(need, gz, noise, noise_w, bias_dtype):
    """(gnoise, gnw, gbias) from gz, the gradient at the pre-activation;
    ``need`` for (noise, noise_w, bias); sums over pixels in f32."""
    f = torch.promote_types(gz.dtype, torch.float32)
    gnoise = gnw = gbias = None
    if need[2]:
        gbias = gz.to(f).sum((0, 1, 2)).to(bias_dtype)
    if noise is not None and (need[0] or need[1]):
        gz_c = gz.to(f).sum(-1)  # [B, H, W]
        if need[1]:
            gnw = (gz_c * noise.to(f)).sum().reshape(noise_w.shape).to(noise_w.dtype)
        if need[0]:
            nw = noise_w.reshape(()).to(f)
            gnoise = ((gz_c * nw).sum(0, keepdim=True) if noise.shape[0] == 1
                      else gz_c * nw).to(noise.dtype)
    return gnoise, gnw, gbias


class _StyledConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, s, d, noise, noise_w, bias, negative_slope, gain):
        out = _forward(x, w, s, d, noise, noise_w, bias, negative_slope, gain)
        ctx.save_for_backward(x, w, s, d, noise, noise_w, out)
        ctx.negative_slope, ctx.gain = negative_slope, gain
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, s, d, noise, noise_w, out = ctx.saved_tensors
        need = ctx.needs_input_grad
        # gradient at the pre-activation z = y * d + noise_w * noise + bias,
        # in out's dtype; the reductions over pixels run in f32 (f64 stays)
        gz, _ = fused_leaky_relu_bwd(g.contiguous(), out, ctx.negative_slope,
                                     ctx.gain, bias_grad=False)
        f = torch.promote_types(gz.dtype, torch.float32)
        gnoise, gnw, gbias = _epilogue_grads(need[4:7], gz, noise, noise_w, ctx.bias_dtype)
        gx = gw = gs = gd = None
        xs = _nchw(x * s[:, None, None, :]) if need[1] or need[3] else None
        if need[3]:
            y = F.conv2d(xs, w.permute(3, 2, 0, 1), padding=1)
            gd = (gz.to(f) * y.permute(0, 2, 3, 1).to(f)).sum((1, 2)).to(d.dtype)
        if need[0] or need[1] or need[2]:
            gx, gw, gs = _input_grads(need[:3], x, w, s, gz * d[:, None, None, :], xs)
        return gx, gw, gs, gd, gnoise, gnw, gbias, None, None


def styled_conv3x3(x, w, s, d, noise, noise_w, bias,
                   negative_slope: float = 0.2, gain: float = SQRT2):
    """x [B,H,W,Cin] NHWC; w [3,3,Cin,Cout] pre-scaled by 1/sqrt(9 Cin);
    s [B,Cin] modulation; d [B,Cout] demodulation; noise [1|B,H,W] or None;
    noise_w a 1-element tensor; bias [Cout]. Returns [B,H,W,Cout].
    Differentiable in every operand."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"styled_conv3x3: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w, s, d, noise, noise_w, bias)):
        return _StyledConv3x3.apply(x, w, s, d, noise, noise_w, bias,
                                    negative_slope, gain)
    return _forward(x, w, s, d, noise, noise_w, bias, negative_slope, gain)


styled_conv3x3.launches = styled_conv3x3.launches_bf16 = 0


# ---------------------------------------------------------------------------
# the tensor-parallel split: partial product, all-reduce (the caller's),
# epilogue
# ---------------------------------------------------------------------------


def styled_conv3x3_partial_plain(x, w, s):
    """Plain version of ``styled_conv3x3_partial``: conv3x3_same(x * s, w) in
    f32 (f64 for f64 operands); on bf16 operands A = bf16(x * s) and the
    bf16 weight in an f32 convolution, as the kernel's bf16 forms."""
    if x.dtype != torch.bfloat16:
        return _conv(x * s[:, None, None, :], w).contiguous()
    f = torch.float32
    a = (x.to(f) * s.to(f)[:, None, None, :]).to(x.dtype).to(f)
    return _conv(a, w.to(f)).contiguous()


def styled_conv3x3_epilogue_plain(acc, d, noise, noise_w, bias,
                                  negative_slope: float = 0.2, gain: float = SQRT2):
    """Plain version of ``styled_conv3x3_epilogue``: lrelu(acc * d + noise_w
    * noise + bias) * gain in f32 (f64 stays), one rounding to d's dtype."""
    if d.dtype != torch.bfloat16:
        return _epilogue(acc, d, noise, noise_w, bias, negative_slope, gain)
    f = torch.float32
    out = _epilogue(acc, d.to(f), None if noise is None else noise.to(f), noise_w.to(f),
                    bias.to(f), negative_slope, gain)
    return out.to(d.dtype)


def _check(name, operands, expect, dtypes, device):
    for key, t in operands.items():
        if key in expect and tuple(t.shape) != expect[key]:
            raise ValueError(f"{name}: {key} must be {expect[key]}, got {tuple(t.shape)}")
        if t.device != device or t.dtype != dtypes[key] or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous {dtypes[key]} on {device}")


def _partial_forward(x, w, s):
    if x.device.type == "cpu":
        return styled_conv3x3_partial_plain(x, w, s)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"styled_conv3x3_partial: f32 or bf16 input, got {x.dtype}")
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    _check("styled_conv3x3_partial", {"x": x, "w": w, "s": s},
           {"w": (3, 3, cin, cout), "s": (b, cin)}, dict.fromkeys("xws", x.dtype), x.device)
    acc = torch.empty((b, h, wd, cout), dtype=torch.float32, device=x.device)
    ws = torch.empty(styled_conv3x3_plan(b, h, wd, cin, cout, x.dtype)["workspace_bytes"],
                     dtype=torch.uint8, device=x.device)
    rc = _build.library().l2i_styled_conv3x3_partial(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), acc.data_ptr(), ws.data_ptr(),
        b, h, wd, cin, cout, int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(rc, "styled_conv3x3_partial")
    _build.count(styled_conv3x3_partial, x)
    return acc


def _epilogue_forward(acc, d, noise, noise_w, bias, negative_slope, gain):
    if acc.device.type == "cpu":
        return styled_conv3x3_epilogue_plain(acc, d, noise, noise_w, bias,
                                             negative_slope, gain)
    if d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"styled_conv3x3_epilogue: f32 or bf16 d, got {d.dtype}")
    b, h, wd, cout = acc.shape
    noise_w = noise_w.reshape(1)
    operands = {"acc": acc, "d": d, "noise_w": noise_w, "bias": bias}
    dtypes = {"acc": torch.float32, "d": d.dtype, "noise": d.dtype,
              "noise_w": torch.float32, "bias": torch.float32}
    if noise is not None:
        if noise.dim() != 3 or noise.shape[0] not in (1, b) or noise.shape[1:] != (h, wd):
            raise ValueError(f"styled_conv3x3_epilogue: noise must be [1|{b}, {h}, {wd}], "
                             f"got {tuple(noise.shape)}")
        operands["noise"] = noise
    _check("styled_conv3x3_epilogue", operands, {"d": (b, cout), "bias": (cout,)}, dtypes,
           acc.device)
    out = torch.empty((b, h, wd, cout), dtype=d.dtype, device=acc.device)
    rc = _build.library().l2i_styled_conv3x3_epilogue(
        acc.data_ptr(), d.data_ptr(), _build.ptr(noise), noise_w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, h, wd, cout, int(noise is not None and noise.shape[0] == b and b > 1),
        int(d.dtype == torch.bfloat16), negative_slope, gain, _build.stream_of(acc))
    _build.check(rc, "styled_conv3x3_epilogue")
    _build.count(styled_conv3x3_epilogue, out)
    return out


class _StyledConv3x3Partial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, s):
        ctx.save_for_backward(x, w, s)
        return _partial_forward(x, w, s)

    @staticmethod
    def backward(ctx, gacc):
        x, w, s = ctx.saved_tensors
        # gacc = gz * d, rounded to x's dtype as the fused node's gy is
        return _input_grads(ctx.needs_input_grad, x, w, s, gacc.to(x.dtype).contiguous())


class _StyledConv3x3Epilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, acc, d, noise, noise_w, bias, negative_slope, gain):
        out = _epilogue_forward(acc, d, noise, noise_w, bias, negative_slope, gain)
        ctx.save_for_backward(acc, d, noise, noise_w, out)
        ctx.negative_slope, ctx.gain = negative_slope, gain
        ctx.bias_dtype = bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        acc, d, noise, noise_w, out = ctx.saved_tensors
        need = ctx.needs_input_grad
        gz, _ = fused_leaky_relu_bwd(g.contiguous(), out, ctx.negative_slope,
                                     ctx.gain, bias_grad=False)
        f = torch.promote_types(gz.dtype, torch.float32)
        gnoise, gnw, gbias = _epilogue_grads(need[2:5], gz, noise, noise_w, ctx.bias_dtype)
        gacc = gd = None
        if need[0]:
            gacc = (gz * d[:, None, None, :]).to(acc.dtype)
        if need[1]:
            gd = (gz.to(f) * acc.to(f)).sum((1, 2)).to(d.dtype)
        return gacc, gd, gnoise, gnw, gbias, None, None


def styled_conv3x3_partial(x, w, s):
    """The product of ``styled_conv3x3`` over one rank's Cin slice: x
    [B,H,W,Cin_r] NHWC, w [3,3,Cin_r,Cout] (scaled by 1/sqrt(9 Cin) of the
    whole Cin), s [B,Cin_r] -> conv3x3_same(x * s, w) [B,H,W,Cout] in f32
    (f64 for f64 operands), without d, noise, bias or activation: summed over
    the ranks it is what ``styled_conv3x3_epilogue`` takes. Differentiable in
    x, w and s."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"styled_conv3x3_partial: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, s)):
        return _StyledConv3x3Partial.apply(x, w, s)
    return _partial_forward(x, w, s)


def styled_conv3x3_epilogue(acc, d, noise, noise_w, bias,
                            negative_slope: float = 0.2, gain: float = SQRT2):
    """lrelu(acc * d + noise_w * noise + bias) * gain from the f32 sums acc
    [B,H,W,Cout] (f64 stays f64); d [B,Cout] and noise [1|B,H,W] or None in
    the result's dtype (f32 or bf16), noise_w (1 element) and bias [Cout]
    f32. Differentiable in every operand."""
    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"styled_conv3x3_epilogue: unsupported device {acc.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (acc, d, noise, noise_w, bias)):
        return _StyledConv3x3Epilogue.apply(acc, d, noise, noise_w, bias, negative_slope,
                                            gain)
    return _epilogue_forward(acc, d, noise, noise_w, bias, negative_slope, gain)


styled_conv3x3_partial.launches = styled_conv3x3_partial.launches_bf16 = 0
styled_conv3x3_epilogue.launches = styled_conv3x3_epilogue.launches_bf16 = 0
