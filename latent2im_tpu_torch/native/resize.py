"""The native loader's centre crop and resize (native/l2i_native.cpp
``crop_resize`` of the JAX package): the centre square of an RGB image,
resized to ``size`` x ``size`` by bilinear interpolation in float64 with no
antialias, each value written as ``uint8(v + 0.5)``.

For output pixel (y, x) the source position is ``(y + 0.5) * scale - 0.5``
with ``scale = dim / size``, its integer part ``int(max(s, 0))``, its
fraction ``s - i`` clamped at 0, the next sample clamped to the crop; the
value ``a (1 - fy)(1 - fx) + b (1 - fy) fx + c fy (1 - fx) + d fy fx``,
each product and sum in that order in float64, as the C++ (compiled
without fused multiply-adds) evaluates it.
"""

from __future__ import annotations

import numpy as np


def _axis(size: int, dim: int):
    """-> (index, next index, fraction) of each output position."""
    scale = float(dim) / size
    s = (np.arange(size, dtype=np.float64) + 0.5) * scale - 0.5
    i = np.where(s < 0, 0.0, s).astype(np.int64)
    f = s - i
    f = np.where(f < 0, 0.0, f)
    return i, np.minimum(i + 1, dim - 1), f


def crop_resize(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [size, size, 3] (see the module)."""
    h, w = img.shape[:2]
    dim = min(h, w)
    y0, x0 = (h - dim) // 2, (w - dim) // 2
    crop = img[y0:y0 + dim, x0:x0 + dim].astype(np.float64)
    iy, iy1, fy = _axis(size, dim)
    ix, ix1, fx = _axis(size, dim)
    fy, fx = fy[:, None, None], fx[None, :, None]
    gy, gx = 1 - fy, 1 - fx
    a, b = crop[iy][:, ix], crop[iy][:, ix1]
    c, d = crop[iy1][:, ix], crop[iy1][:, ix1]
    v = a * gy * gx + b * gy * fx + c * fy * gx + d * fy * fx
    return (v + 0.5).astype(np.uint8)
