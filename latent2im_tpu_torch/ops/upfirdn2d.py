"""upfirdn2d: upsample + FIR filter + downsample over NHWC images.

Same function as the JAX package's latent2im_tpu/ops/upfirdn2d.py: zero-stuff
the input by ``up`` with TRAILING zeros (length H*up), pad by ``pad``
(negative pads crop), cross-correlate with the FLIPPED kernel (i.e. convolve
with the kernel), keep every ``down``-th sample:

    out_h = (in_h*up + pad0 + pad1 - kh) // down + 1

On a CUDA tensor ``upfirdn2d`` launches the hand-written kernel
``csrc/upfirdn2d.cu``, the port of the TPU kernel
``ops/pallas_kernels.py:upfirdn2d_pallas``; on a CPU tensor it runs the plain
PyTorch version. Forward only: the backward waits for the training slice.
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


def upfirdn2d(x, kernel, up: int = 1, down: int = 1, pad=(0, 0)):
    """Upsample, FIR-filter and downsample a batch of NHWC images.

    x [B, H, W, C]; kernel [kh, kw] (numpy or tensor, unflipped);
    pad (pad0, pad1) for both dims or (px0, px1, py0, py1)."""
    if x.device.type == "cpu":
        return upfirdn2d_plain(x, kernel, up, down, pad)
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn2d: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"upfirdn2d: f32 input, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("upfirdn2d: input must be contiguous NHWC [B, H, W, C]")
    if up < 1 or down < 1:
        raise ValueError(f"upfirdn2d: up and down must be >= 1, got {up}, {down}")
    px0, px1, py0, py1 = _as_pads(pad)
    k = _kernel_tensor(kernel, x).contiguous()
    if k.dim() != 2:
        raise ValueError(f"upfirdn2d: kernel must be 2D, got {tuple(k.shape)}")
    b, h, w, c = x.shape
    kh, kw = k.shape
    if kh * kw > 64:
        raise ValueError(f"upfirdn2d: at most 64 taps, got {kh}x{kw}")
    oh = (h * up + py0 + py1 - kh) // down + 1
    ow = (w * up + px0 + px1 - kw) // down + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"upfirdn2d: empty output {oh}x{ow}")
    out = torch.empty((b, oh, ow, c), dtype=x.dtype, device=x.device)
    lib = _build.library()
    rc = lib.l2i_upfirdn2d(
        x.data_ptr(), k.data_ptr(), out.data_ptr(), b, h, w, c, oh, ow, kh, kw,
        up, down, px0, py0, _build.stream_of(x),
    )
    _build.check(rc, "upfirdn2d")
    upfirdn2d.launches += 1
    return out


upfirdn2d.launches = 0


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
