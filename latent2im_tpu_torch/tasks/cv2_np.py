"""OpenCV's arithmetic in numpy for the calls the geometric tasks make
(tasks/geometric.py:get_target_np): ``resize`` with INTER_LINEAR,
``warp_affine`` and ``warp_perspective`` with INTER_LINEAR and a constant 0
border, and ``get_rotation_matrix_2d``. The GPU machine has no cv2; these
give the JAX package's host targets (which call cv2 5.0) bit for bit.

OpenCV 5 runs two different codes, by the image's dtype:

- float32 images, both warps: the SIMD warp kernels (AVX2 build, 8 lanes
  unrolled twice). The inverse map is cast to float32; a destination pixel
  (x, y) reads its source at

      sx = fma(M0, x, fl(fl(y * M1) + M2))              (x < 16 * (W // 16))
      sx = fl(fma(x, M0, fl(y * M1)) + M2)              (the scalar tail)

  (and sy, and the perspective's w the same way, then sx / w and sy / w in
  float32), its integer part floor(sx) and fraction sx - floor(sx) in
  float32, then the bilinear lerp as three fused multiply-adds:
  v0 = fma(ax, p01 - p00, p00), v1 = fma(ax, p11 - p10, p10),
  out = fma(ay, v1 - v0, v0). Taps outside the image read 0.
- float64 images (the tasks' masks), both warps: the fixed-point warps of
  imgwarp.cpp. warpAffine: AB_BITS 10 fixed point, cvRound (half to
  even) of M0 * x * 1024 and of (M1 * y + M2) * 1024, the round delta 16,
  cut to 1/32 of a pixel (INTER_BITS 5). warpPerspective: per block of
  64 x 16 destination pixels, X0 = M0 * xb + M1 * y + M2 at the block's
  first column xb, then W = 32 / (W0 + M6 * x1) (0 where that is 0), the
  coordinate cvRound((X0 + M0 * x1) * W) clamped to the int range. Then
  remap's float table of 1/32 fractions: w = fl32(ty * tx) of (1 - f, f),
  summed tap by tap in double, taps outside the image reading 0.
- resize, both dtypes: each axis's source coordinate (d + 0.5) * scale
  - 0.5 in double, its floor, the fraction (cast to float32 for float32
  images), source indices clamped to the image; the horizontal pass
  h = fma(fx, S1 - S0, S0), then the vertical pass the same on the rows,
  each fused multiply-add rounded once in the image's dtype.

The inverse of an affine map is warpAffine's own (in double); of a
perspective map cv::invert's 3 x 3 closed form. Fused multiply-adds are emulated exactly for float32 (the
product is exact in float64; where the float64 sum lands halfway between
two float32, it is rounded to odd first) and to within rounding of the last
float64 bit for float64. Each channel is computed alone, so a batch may go
through one call as channels side by side (tasks/geometric.py does).
"""

from __future__ import annotations

import math

import numpy as np

INTER_BITS, INTER_TAB_SIZE, AB_BITS = 5, 32, 10
_UNROLL = 16  # the float32 warp kernels' columns per vector iteration


# ---------------------------------------------------------------------------
# fused multiply-add
# ---------------------------------------------------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma32(a, b, c) -> np.ndarray:
    """a * b + c of float32 operands, rounded once to float32."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.asarray(b, np.float32)  # exact
    c = np.asarray(c, np.float32).astype(np.float64)
    s = p + c
    # rounding s to float32 rounds a * b + c itself unless s fell exactly
    # halfway between two float32 (or into their subnormal range) while
    # the float64 sum was inexact: there round to odd in float64 first
    low = s.view(np.int64) & 0x1FFFFFFF
    odd = (low == 0x10000000) | (np.abs(s) < 2.0 ** -125)
    if odd.any():
        p, c = np.broadcast_to(p, s.shape)[odd], np.broadcast_to(c, s.shape)[odd]
        t, e = _two_sum(p, c)
        t = np.where((e != 0) & ((t.view(np.int64) & 1) == 0), np.nextafter(t, t + e), t)
        s = s.copy()
        s[odd] = t
    return s.astype(np.float32)


def _split(x):
    t = 134217729.0 * x  # 2^27 + 1
    hi = t - (t - x)
    return hi, x - hi


def fma64(a, b, c) -> np.ndarray:
    """a * b + c of float64 operands, the product kept exact (Dekker)."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    (ah, al), (bh, bl) = _split(a), _split(b)
    pe = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s, e = _two_sum(p, c)
    return s + (e + pe)


# ---------------------------------------------------------------------------
# matrices
# ---------------------------------------------------------------------------

def get_rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: float64 [2, 3]; the centre is a float32
    point."""
    cx, cy = (float(np.float32(v)) for v in center)
    angle = float(angle) * (math.pi / 180)
    alpha, beta = math.cos(angle) * scale, math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def invert_affine(m) -> np.ndarray:
    """warpAffine's inverse of a forward 2 x 3 map -> 6 doubles."""
    m = np.asarray(m, np.float64).reshape(6).tolist()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m, np.float64)


def invert_3x3(m) -> np.ndarray:
    """cv::invert(DECOMP_LU)'s closed form for a 3 x 3 double matrix -> 9
    doubles (zeros where it is singular, as warpPerspective then maps)."""
    s = np.asarray(m, np.float64).reshape(3, 3).tolist()
    d = (s[0][0] * (s[1][1] * s[2][2] - s[1][2] * s[2][1])
         - s[0][1] * (s[1][0] * s[2][2] - s[1][2] * s[2][0])
         + s[0][2] * (s[1][0] * s[2][1] - s[1][1] * s[2][0]))
    if d == 0:
        return np.zeros(9)
    d = 1.0 / d
    return np.array([
        (s[1][1] * s[2][2] - s[1][2] * s[2][1]) * d, (s[0][2] * s[2][1] - s[0][1] * s[2][2]) * d,
        (s[0][1] * s[1][2] - s[0][2] * s[1][1]) * d, (s[1][2] * s[2][0] - s[1][0] * s[2][2]) * d,
        (s[0][0] * s[2][2] - s[0][2] * s[2][0]) * d, (s[0][2] * s[1][0] - s[0][0] * s[1][2]) * d,
        (s[1][0] * s[2][1] - s[1][1] * s[2][0]) * d, (s[0][1] * s[2][0] - s[0][0] * s[2][1]) * d,
        (s[0][0] * s[1][1] - s[0][1] * s[1][0]) * d], np.float64)


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

def _axis(n_out: int, n_in: int):
    """Each output index's two source indices (clamped) and its fraction
    in double."""
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(f)
    frac = f - s
    s = s.astype(np.int64)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), frac


def resize(img: np.ndarray, dsize) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=INTER_LINEAR) of a
    float32 or float64 image [H, W] or [H, W, C]."""
    img = np.asarray(img)
    if img.dtype not in (np.float32, np.float64):
        raise TypeError(f"resize: float32 or float64 images only, not {img.dtype}")
    width, height = int(dsize[0]), int(dsize[1])
    if (height, width) == img.shape[:2]:  # cv2 copies; the passes would too
        return img.copy()
    flat = img.ndim == 2
    src = img[..., None] if flat else img
    x0, x1, fx = _axis(width, src.shape[1])
    y0, y1, fy = _axis(height, src.shape[0])
    if src.dtype == np.float32:
        fma, fx, fy = fma32, fx.astype(np.float32), fy.astype(np.float32)
    else:
        fma = fma64
    s0, s1 = src[:, x0], src[:, x1]
    rows = fma(np.broadcast_to(fx[:, None], s0.shape), s1 - s0, s0)
    r0, r1 = rows[y0], rows[y1]
    out = fma(np.broadcast_to(fy[:, None, None], r0.shape), r1 - r0, r0)
    return out[..., 0] if flat else out


# ---------------------------------------------------------------------------
# float32 warps (the SIMD kernels)
# ---------------------------------------------------------------------------

def _taps(img, iy, ix):
    """The four bilinear taps [H, W, C] at (iy, ix) .. (iy + 1, ix + 1),
    reading 0 outside the image."""
    h, w, c = img.shape
    # a border of zeros round the image: a tap outside reads one of them
    padded = np.zeros((h + 2, w + 2, c), img.dtype)
    padded[1:-1, 1:-1] = img
    flat = padded.reshape(-1, c)
    out = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy = np.clip(iy + dy, -1, h) + 1
        xx = np.clip(ix + dx, -1, w) + 1
        out.append(flat[yy * (w + 2) + xx])
    return out


def _lerp_f32(img, sx, sy):
    lim = float(2 ** 31 - 1)
    sx = np.nan_to_num(sx, nan=-lim, posinf=lim, neginf=-lim)
    sy = np.nan_to_num(sy, nan=-lim, posinf=lim, neginf=-lim)
    fx, fy = np.floor(sx), np.floor(sy)
    ix = np.clip(fx, -lim, lim).astype(np.int64)
    iy = np.clip(fy, -lim, lim).astype(np.int64)
    ax, ay = (sx - fx).astype(np.float32), (sy - fy).astype(np.float32)
    p00, p01, p10, p11 = _taps(img, iy, ix)
    ax = np.broadcast_to(ax[..., None], p00.shape)
    ay = np.broadcast_to(ay[..., None], p00.shape)
    v0 = fma32(ax, p01 - p00, p00)
    v1 = fma32(ax, p11 - p10, p10)
    return fma32(ay, v1 - v0, v0)


def _coord_f32(m, a: int, b: int, c: int, height: int, width: int):
    """One source coordinate (or the perspective's w) of the float32 warp
    kernels for every destination pixel [height, width]."""
    shape = (height, width)
    x = np.broadcast_to(np.arange(width, dtype=np.float32)[None], shape)
    y = np.arange(height, dtype=np.float32)[:, None]
    yb = (y * m[b]).astype(np.float32)
    vec = fma32(m[a], x, np.broadcast_to(yb + m[c], shape))
    tail = fma32(x, m[a], np.broadcast_to(yb, shape)) + m[c]
    return np.where(np.arange(width) < _UNROLL * (width // _UNROLL), vec, tail)


# ---------------------------------------------------------------------------
# float64 warps (fixed point, 1/32 of a pixel)
# ---------------------------------------------------------------------------

def _bilinear_tab():
    """remap's float table: [32 * 32, 4] weights of the 1/32 fractions."""
    t = np.arange(INTER_TAB_SIZE, dtype=np.float32) * np.float32(1.0 / INTER_TAB_SIZE)
    one = np.stack([np.float32(1) - t, t], -1)  # [32, 2]
    w = one[:, None, :, None] * one[None, :, None, :]  # [fy, fx, ky, kx]
    return w.astype(np.float32).reshape(INTER_TAB_SIZE * INTER_TAB_SIZE, 4)


_TAB = _bilinear_tab()


def _remap_fixed(img, X, Y):
    """Bilinear remap at fixed-point coordinates X, Y (1/32 of a pixel)."""
    ix, iy = X >> INTER_BITS, Y >> INTER_BITS
    w = _TAB[(Y & (INTER_TAB_SIZE - 1)) * INTER_TAB_SIZE + (X & (INTER_TAB_SIZE - 1))]
    w = w.astype(img.dtype)
    p = _taps(img, iy, ix)
    out = p[0] * w[..., 0:1]
    for k in range(1, 4):
        out = out + p[k] * w[..., k:k + 1]
    return out


def _round(x):
    """cvRound of doubles (half to even), saturated to int."""
    return np.rint(np.clip(x, -2.0 ** 31, 2.0 ** 31 - 1)).astype(np.int64)


def _affine_fixed(img, m, height, width):
    x = np.arange(width, dtype=np.float64)
    y = np.arange(height, dtype=np.float64)[:, None]
    scale = 1 << AB_BITS
    delta = scale // INTER_TAB_SIZE // 2
    x0 = _round((m[1] * y + m[2]) * scale) + delta
    y0 = _round((m[4] * y + m[5]) * scale) + delta
    X = (x0 + _round(m[0] * x * scale)) >> (AB_BITS - INTER_BITS)
    Y = (y0 + _round(m[3] * x * scale)) >> (AB_BITS - INTER_BITS)
    return _remap_fixed(img, X, Y)


def _perspective_fixed(img, m, height, width):
    bh = min(16, height)
    bw = min(32 * 32 // bh, width)
    xb = (np.arange(width) // bw * bw).astype(np.float64)
    x1 = np.arange(width, dtype=np.float64) - xb
    y = np.arange(height, dtype=np.float64)[:, None]
    X0 = m[0] * xb + m[1] * y + m[2]
    Y0 = m[3] * xb + m[4] * y + m[5]
    W = (m[6] * xb + m[7] * y + m[8]) + m[6] * x1
    nz = W != 0
    W = np.where(nz, INTER_TAB_SIZE / np.where(nz, W, 1.0), 0.0)
    X = _round((X0 + m[0] * x1) * W)
    Y = _round((Y0 + m[3] * x1) * W)
    return _remap_fixed(img, X, Y)


# ---------------------------------------------------------------------------
# the warps
# ---------------------------------------------------------------------------

def _warp(img, dsize, f32, f64):
    img = np.asarray(img)
    if img.dtype not in (np.float32, np.float64):
        raise TypeError(f"warp: float32 or float64 images only, not {img.dtype}")
    width, height = int(dsize[0]), int(dsize[1])
    flat = img.ndim == 2
    src = img[..., None] if flat else img
    out = f32(src, height, width) if src.dtype == np.float32 else f64(src, height, width)
    return out[..., 0] if flat else out


def warp_affine(img: np.ndarray, m, dsize) -> np.ndarray:
    """cv2.warpAffine(img, m, (width, height)) with INTER_LINEAR and a
    constant 0 border of a float32 or float64 image [H, W] or [H, W, C]."""
    mi = invert_affine(m)

    def f32(src, height, width):
        mf = mi.astype(np.float32)
        return _lerp_f32(src, _coord_f32(mf, 0, 1, 2, height, width),
                         _coord_f32(mf, 3, 4, 5, height, width))

    return _warp(img, dsize, f32, lambda src, h, w: _affine_fixed(src, mi, h, w))


def warp_perspective(img: np.ndarray, m, dsize) -> np.ndarray:
    """cv2.warpPerspective(img, m, (width, height)) with INTER_LINEAR and a
    constant 0 border, as ``warp_affine``."""
    mi = invert_3x3(m)

    def f32(src, height, width):
        mf = mi.astype(np.float32)
        w = _coord_f32(mf, 6, 7, 8, height, width)
        return _lerp_f32(src, _coord_f32(mf, 0, 1, 2, height, width) / w,
                         _coord_f32(mf, 3, 4, 5, height, width) / w)

    return _warp(img, dsize, f32, lambda src, h, w: _perspective_fixed(src, mi, h, w))
