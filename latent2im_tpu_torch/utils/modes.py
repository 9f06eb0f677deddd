"""Pillow's conversions of its image modes to RGB (libImaging/Convert.c),
what ``Image.convert("RGB")`` gives the image readers of this package.
Each takes Pillow's values of one mode and returns uint8 [..., 3]."""

from __future__ import annotations

import numpy as np


class NotThisKind(ValueError):
    """A reader's header check failed where Pillow's ``Image.open`` moves on
    to the next format (its plugin raised SyntaxError, IndexError,
    TypeError or struct.error), not a failure of the file."""


def gray_rgb(v) -> np.ndarray:
    """L (uint8 values) -> RGB: the value in all three channels."""
    v = np.asarray(v, np.uint8)
    return np.repeat(v[..., None], 3, axis=-1)


def i_rgb(v) -> np.ndarray:
    """I (int32) and I;16 (uint16) -> RGB: clipped to [0, 255] (i2rgb,
    I16_RGB)."""
    return gray_rgb(np.clip(np.asarray(v, np.int64), 0, 255))


def f_rgb(v) -> np.ndarray:
    """F (float32) -> RGB (f2l, then L): 0 at or below 0 and for NaN, 255 at
    or above 255, else the value truncated."""
    v = np.asarray(v, np.float64)
    with np.errstate(invalid="ignore"):
        out = np.where(v <= 0, 0, np.where(v >= 255, 255, np.nan_to_num(v, nan=0.0)))
    return gray_rgb(np.trunc(out).astype(np.uint8))


def rgba_unpremultiplied(v) -> np.ndarray:
    """Premultiplied RGBA (raw mode "RGBa") as Pillow unpacks it
    (Unpack.c:unpackRGBa) -> RGB: where the alpha a is 0 black, where 255
    as stored, else each channel c x 255 // a clipped to 255."""
    v = np.asarray(v, np.int64)
    a = v[..., 3:4]
    out = np.where(a == 0, 0, np.minimum(v[..., :3] * 255 // np.maximum(a, 1), 255))
    return np.where(a == 255, v[..., :3], out).astype(np.uint8)


def _ycc_table(k: float) -> np.ndarray:
    """ConvertYCbCr.c's tables: (i - 128) * k * 2^6, + 0.5 and truncated."""
    return np.trunc((np.arange(256) - 128) * k * 64 + 0.5).astype(np.int64)


_R_CR, _B_CB = _ycc_table(1.40200), _ycc_table(1.77200)
_G_CB, _G_CR = _ycc_table(-0.34414), _ycc_table(-0.71414)


def ycbcr_rgb(y, cb, cr) -> np.ndarray:
    """YCbCr (uint8 values) -> RGB as Pillow's ImagingConvertYCbCr2RGB: the
    chroma terms from its 6-bit fixed-point tables, shifted (floor) and
    added to Y, clipped."""
    y, cb, cr = (np.asarray(v, np.int64) & 0xFF for v in (y, cb, cr))
    r = y + (_R_CR[cr] >> 6)
    g = y + ((_G_CB[cb] + _G_CR[cr]) >> 6)
    b = y + (_B_CB[cb] >> 6)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
