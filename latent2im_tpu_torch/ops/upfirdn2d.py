"""upfirdn2d: upsample + FIR filter + downsample over NHWC images, and its
gradient.

Same function as the JAX package's latent2im_tpu/ops/upfirdn2d.py: zero-stuff
the input by ``up`` with TRAILING zeros (length H*up), pad by ``pad``
(negative pads crop), cross-correlate with the FLIPPED kernel (i.e. convolve
with the kernel), keep every ``down``-th sample:

    out_h = (in_h*up + pad0 + pad1 - kh) // down + 1

Its gradient is the same op with up and down swapped, the kernel flipped and
the transposed pads of the TPU kernel's VJP (ops/pallas_kernels.py:_ufd_bwd):

    g_pad0 = k - pad0 - 1,   g_pad1 = in*up - out*down + pad0 - up + 1

On a CUDA tensor ``upfirdn2d`` launches the hand-written kernel
``csrc/upfirdn2d.cu``, the port of ``upfirdn2d_pallas``, and when its input
needs a gradient it records an autograd node whose backward,
``upfirdn2d_bwd``, launches the same kernel with the transposed parameters,
as the TPU version runs its own forward kernel (``_ufd_impl``) backward. On a
CPU tensor both take the plain PyTorch version, through the same node.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build


def make_kernel(k) -> np.ndarray:
    """Normalized 2D FIR kernel from a 1D (outer-producted) or 2D tap list."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / np.sum(k)


def _as_pads(pad):
    """(pad0, pad1) for both dims, or (px0, px1, py0, py1)."""
    if len(pad) == 2:
        return pad[0], pad[1], pad[0], pad[1]
    if len(pad) == 4:
        return tuple(pad)
    raise ValueError(f"pad must have 2 or 4 elements, got {pad}")


def _kernel_tensor(kernel, x):
    if isinstance(kernel, torch.Tensor):
        return kernel.to(device=x.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)


def upfirdn2d_plain(x, kernel, up: int = 1, down: int = 1, pad=(0, 0)):
    """Plain PyTorch version: zero-stuff, pad/crop, depthwise conv, stride."""
    px0, px1, py0, py1 = _as_pads(pad)
    k = _kernel_tensor(kernel, x).to(x.dtype)
    b, h, w, c = x.shape
    kh, kw = k.shape
    if up > 1:
        z = x.new_zeros(b, h, up, w, up, c)
        z[:, :, 0, :, 0, :] = x
        x = z.reshape(b, h * up, w * up, c)
    x = F.pad(x, (0, 0, max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)))
    x = x[:, max(-py0, 0): x.shape[1] - max(-py1, 0),
          max(-px0, 0): x.shape[2] - max(-px1, 0), :]
    wgt = torch.flip(k, (0, 1)).expand(c, 1, kh, kw)
    out = F.conv2d(x.permute(0, 3, 1, 2), wgt, stride=down, groups=c)
    return out.permute(0, 2, 3, 1).contiguous()


def out_size(n: int, up: int, down: int, p0: int, p1: int, k: int) -> int:
    """Output length of upfirdn2d along one axis."""
    return (n * up + p0 + p1 - k) // down + 1


def _launch(x, k, up, down, pads, oh, ow):
    """One launch of ``l2i_upfirdn2d`` -> [B, oh, ow, C] (checks first)."""
    if x.dtype != torch.float32:
        raise TypeError(f"upfirdn2d: f32 input, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("upfirdn2d: input must be contiguous NHWC [B, H, W, C]")
    if up < 1 or down < 1:
        raise ValueError(f"upfirdn2d: up and down must be >= 1, got {up}, {down}")
    if k.dim() != 2:
        raise ValueError(f"upfirdn2d: kernel must be 2D, got {tuple(k.shape)}")
    b, h, w, c = x.shape
    kh, kw = k.shape
    if kh * kw > 64:
        raise ValueError(f"upfirdn2d: at most 64 taps, got {kh}x{kw}")
    if oh < 1 or ow < 1:
        raise ValueError(f"upfirdn2d: empty output {oh}x{ow}")
    px0, _, py0, _ = pads
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    lib = _build.library()
    rc = lib.l2i_upfirdn2d(
        x.data_ptr(), k.contiguous().data_ptr(), out.data_ptr(), b, h, w, c,
        oh, ow, kh, kw, up, down, px0, py0, _build.stream_of(x),
    )
    _build.check(rc, "upfirdn2d")
    return out


def upfirdn2d_form(x, out, k_shape, up: int, down: int) -> str:
    """Which instance of the CUDA kernel the launch reading ``x`` [B,H,W,C]
    and writing ``out`` takes, by the launch's own test: "templated float4"
    or "templated" (4x4 taps, (up, down) of (1, 1), (2, 1) or (1, 2); float4
    where C % 4 == 0 and both are 16-byte aligned), else "generic"."""
    form = _build.library().l2i_upfirdn2d_form(
        x.data_ptr(), out.data_ptr(), x.shape[-1], *k_shape, up, down)
    return {0: "generic", 1: "templated", 4: "templated float4"}[form]


def _forward(x, k, up, down, pads):
    if x.device.type == "cpu":
        return upfirdn2d_plain(x, k, up, down, pads)
    px0, px1, py0, py1 = pads
    kh, kw = k.shape[-2:]
    out = _launch(x, k, up, down, pads,
                  out_size(x.shape[1], up, down, py0, py1, kh),
                  out_size(x.shape[2], up, down, px0, px1, kw))
    upfirdn2d.launches += 1
    return out


class _UpFirDn2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, up, down, pads):
        ctx.save_for_backward(k)
        ctx.up, ctx.down, ctx.pads = up, down, pads
        ctx.in_hw = (x.shape[1], x.shape[2])
        return _forward(x, k, up, down, pads)

    @staticmethod
    def backward(ctx, g):
        (k,) = ctx.saved_tensors
        dx = upfirdn2d_bwd(g.contiguous(), k, ctx.up, ctx.down, ctx.pads,
                           ctx.in_hw)
        return dx, None, None, None, None


def upfirdn2d(x, kernel, up: int = 1, down: int = 1, pad=(0, 0)):
    """Upsample, FIR-filter and downsample a batch of NHWC images.

    x [B, H, W, C]; kernel [kh, kw] (numpy or tensor, unflipped);
    pad (pad0, pad1) for both dims or (px0, px1, py0, py1). Differentiable
    in x (the kernel is a constant)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"upfirdn2d: unsupported device {x.device}")
    pads = _as_pads(pad)
    k = _kernel_tensor(kernel, x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _UpFirDn2d.apply(x, k, up, down, pads)
    return _forward(x, k, up, down, pads)


upfirdn2d.launches = 0


def transposed_params(k_shape, up, down, pad, in_hw, out_hw):
    """(up, down, pads) of the op that computes upfirdn2d's input gradient
    from an output gradient of size out_hw (the pads of ``_ufd_bwd``); the
    kernel of that op is the flipped kernel."""
    px0, px1, py0, py1 = _as_pads(pad)
    kh, kw = k_shape
    (h, w), (oh, ow) = in_hw, out_hw
    fwd = (out_size(h, up, down, py0, py1, kh), out_size(w, up, down, px0, px1, kw))
    if fwd != (oh, ow):
        raise ValueError(
            f"upfirdn2d_bwd: a gradient of size {(oh, ow)} does not come "
            f"from an input of size {(h, w)} (the forward gives {fwd})"
        )
    gpads = (kw - px0 - 1, w * up - ow * down + px0 - up + 1,
             kh - py0 - 1, h * up - oh * down + py0 - up + 1)
    # the transposed op must give back exactly the input's size: the high
    # pads reach the kernel only through that size
    got = (out_size(oh, down, up, gpads[2], gpads[3], kh),
           out_size(ow, down, up, gpads[0], gpads[1], kw))
    assert got == (h, w), (gpads, got, (h, w))
    return down, up, gpads


def upfirdn2d_bwd(g, kernel, up: int, down: int, pad, in_hw):
    """Input gradient of ``upfirdn2d(x, kernel, up, down, pad)`` for x of
    spatial size in_hw = (H, W), from the output gradient g [B, OH, OW, C]:
    the same op with up and down swapped, the kernel flipped and the
    transposed pads. On cuda one launch of the upfirdn2d kernel."""
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"upfirdn2d_bwd: unsupported device {g.device}")
    k = _kernel_tensor(kernel, g)
    gup, gdown, gpads = transposed_params(tuple(k.shape), up, down, pad,
                                          tuple(in_hw), tuple(g.shape[1:3]))
    kf = torch.flip(k, (0, 1))
    if g.device.type == "cpu":
        return upfirdn2d_plain(g, kf, gup, gdown, gpads)
    dx = _launch(g, kf, gup, gdown, gpads, int(in_hw[0]), int(in_hw[1]))
    upfirdn2d_bwd.launches += 1
    return dx


upfirdn2d_bwd.launches = 0


# StyleGAN2 resampling conventions (JAX ops/upfirdn2d.py:317-343)


def upsample2d(x, kernel, factor: int = 2):
    """x``factor`` upsample with FIR smoothing; the kernel is scaled by
    factor**2 to keep the mean."""
    kh = kernel.shape[0]
    p = kh - factor
    return upfirdn2d(x, kernel * (factor ** 2), up=factor, down=1,
                     pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample2d(x, kernel, factor: int = 2):
    """FIR-smoothed downsample."""
    kh = kernel.shape[0]
    p = kh - factor
    return upfirdn2d(x, kernel, up=1, down=factor, pad=((p + 1) // 2, p // 2))


def blur2d(x, kernel, pad, upsample_factor: int = 1):
    """Plain FIR blur with explicit pads; after an x``upsample_factor``
    transposed conv the kernel is scaled by upsample_factor**2."""
    if upsample_factor > 1:
        kernel = kernel * (upsample_factor ** 2)
    return upfirdn2d(x, kernel, up=1, down=1, pad=pad)
