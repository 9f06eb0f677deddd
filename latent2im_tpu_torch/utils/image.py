"""Image grids, PNG files and uint8 conversion — own copy of
latent2im_tpu/utils/image.py (imgrid tiling with 1 px white seams, PNG save,
to_uint8), NHWC uint8. PNG is encoded with the standard library alone (zlib
+ struct): the GPU machine has no Pillow."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def imgrid(imarray: np.ndarray, cols: int = 5, pad: int = 1) -> np.ndarray:
    """Tile [N, H, W, C] uint8 images into a grid with `pad`px white seams."""
    if imarray.dtype != np.uint8:
        raise ValueError("imgrid input imarray must be uint8")
    pad = int(pad)
    cols = int(cols)
    if pad < 0 or cols < 1:
        raise ValueError(f"imgrid: pad >= 0 and cols >= 1, got {pad}, {cols}")
    n, h, w, c = imarray.shape
    rows = int(np.ceil(n / float(cols)))
    imarray = np.pad(
        imarray,
        [[0, rows * cols - n], [0, pad], [0, pad], [0, 0]],
        "constant",
        constant_values=255,
    )
    hp, wp = h + pad, w + pad
    grid = (
        imarray.reshape(rows, cols, hp, wp, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(rows * hp, cols * wp, c)
    )
    if pad:
        grid = grid[:-pad, :-pad]
    return np.squeeze(grid)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(img_u8: np.ndarray) -> bytes:
    """uint8 [H, W, 3] (RGB) or [H, W] (gray) -> PNG file bytes. zlib level
    1: a faster encode for slightly larger payloads, as in the JAX server."""
    img = np.ascontiguousarray(img_u8, np.uint8)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"png: [H, W, 3] or [H, W] uint8, got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _png_chunk(b"IEND", b""))


def save_im(a: np.ndarray, filename: str, format: str = "png") -> None:
    """Save a uint8 array as `{filename}.{format}` (PNG only)."""
    if format != "png":
        raise ValueError(f"save_im writes png only, not {format!r}")
    with open(f"{filename}.{format}", "wb") as f:
        f.write(png_bytes(np.squeeze(np.asarray(a, dtype=np.uint8))))


_PIL_PRECISION_BITS = 22  # libImaging/Resample.c: 32 - 8 - 2


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter, a = -0.5, support 2."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_coeffs(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for one axis ->
    (first input index [out, k], fixed-point coefficients [out, k] int64);
    unused taps have coefficient 0 and index 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # C casts truncate
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _pil_bicubic((np.arange(xmax) + xmin - center + 0.5) * (1.0 / filterscale))
        ww = 0.0
        for v in w:  # sequential, as the C loop sums
            ww += v
        if ww != 0.0:
            w = w / ww
        kk[xx, :xmax] = w
        idx[xx, :xmax] = np.arange(xmax) + xmin
    one = float(1 << _PIL_PRECISION_BITS)
    fixed = np.where(kk < 0, np.trunc(-0.5 + kk * one), np.trunc(0.5 + kk * one))
    return idx, fixed.astype(np.int64)


def _pil_pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One 8-bit pass of Pillow's resample along ``axis`` of [H, W, C]:
    integer multiply-adds from a half-unit start, >> 22, clip to uint8."""
    idx, k = _pil_coeffs(img.shape[axis], out_size)
    x = np.moveaxis(img.astype(np.int64), axis, 0)  # [in, other, C]
    acc = np.full((out_size,) + x.shape[1:], 1 << (_PIL_PRECISION_BITS - 1), np.int64)
    for j in range(idx.shape[1]):
        acc += x[idx[:, j]] * k[:, j, None, None]
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_resize_bicubic(img_u8: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> [h, w, C] as Pillow's ``Image.resize((w, h))``
    computes it with its default BICUBIC filter, without Pillow: the
    two-pass fixed-point resample of libImaging/Resample.c, the horizontal
    pass first, each pass rounding and clipping to uint8, the filter's
    support widened by the downscale factor. ``size`` is (w, h) as Pillow's."""
    w, h = size
    img = np.asarray(img_u8, np.uint8)
    if img.shape[1] != w:
        img = _pil_pass(img, 1, w)
    if img.shape[0] != h:
        img = _pil_pass(img, 0, h)
    return img


def to_uint8(ims) -> np.ndarray:
    """[-1, 1] float images -> uint8 (the reference's clip_ims): clip
    ((x + 1) / 2) * 255 to [0, 255] and truncate. Already-uint8 input passes
    through."""
    ims = np.asarray(ims)
    if ims.dtype == np.uint8:
        return ims
    return np.uint8(np.clip(((ims + 1) / 2.0) * 255, 0, 255))
