"""Device targets of the geometric and color tasks — PyTorch port of
latent2im_tpu/tasks/warp.py.

Every geometric target of the reference (its cv2 warpAffine /
warpPerspective / resize, all INTER_LINEAR) is an affine or projective
resample, so one bilinear homography sampler on the device covers shift,
rotate2d, zoom and rotate3d: the tasks give a 3x3 dst->src matrix in pixel
coordinates, (x, y) convention, built on the host with cv2's conventions
(the numpy builders below, copied from the JAX package bit for bit). The
color tasks shift channels in RGB or in CIE Lab. This is plain PyTorch on
tensors: the JAX counterpart reaches no Pallas kernel.

The sampler follows ``jax.scipy.ndimage.map_coordinates(order=1)`` in pixel
coordinates and in its order of operations: the ``minv @ [x, y, 1]``
matrix product in f32, the division by the third row, ``floor`` and weights
``c - floor``; an out-of-range neighbour contributes 0 (``clamp=False``, a
zero border) or has its index clipped to the image (``clamp=True``, with the
coordinates clipped into ``box`` first). A normalised-coordinate sampler
(``F.grid_sample``) would round the zero weights of an integer shift's
border pixels to ~1e-7 and flip their mask bits.

Layout NHWC.
"""

from __future__ import annotations

import numpy as np
import torch


def _sample(imgs, sy, sx, clamp: bool):
    """imgs [B, H, W, C], source coordinates sy, sx [B, H*W] -> [B, H*W, C]:
    the four neighbours weighted as map_coordinates weighs and sums them."""
    b, h, w, c = imgs.shape
    flat = imgs.reshape(b, h * w, c)
    nodes = []
    for coord, size in ((sy, h), (sx, w)):
        lower = torch.floor(coord)
        upper_w = coord - lower
        lower_w = 1 - upper_w
        index = lower.to(torch.int64)
        pair = []
        for idx, weight in ((index, lower_w), (index + 1, upper_w)):
            valid = None if clamp else (idx >= 0) & (idx < size)
            pair.append((idx.clamp(0, size - 1), valid, weight))
        nodes.append(pair)
    out = None
    for iy, vy, wy in nodes[0]:
        for ix, vx, wx in nodes[1]:
            gathered = torch.gather(flat, 1, (iy * w + ix)[..., None].expand(b, h * w, c))
            if not clamp:
                gathered = torch.where((vy & vx)[..., None], gathered,
                                       torch.zeros((), dtype=imgs.dtype, device=imgs.device))
            term = (wy * wx)[..., None] * gathered
            out = term if out is None else out + term
    return out


def warp_perspective(imgs, minv, clamp: bool = False, box=None):
    """Bilinear projective resample of NHWC ``imgs``.

    minv: [3, 3] (shared) or [B, 3, 3] dst->src homography in pixel
    coordinates, (x, y) convention: the INVERSE of the matrix cv2.warpAffine
    / cv2.warpPerspective take. clamp=False: zero border; clamp=True: edge
    replicate (cv2.resize at array edges) with the coordinates clipped into
    ``box`` = [x0, y0, x1, y1] when given (the zoom-in path resizes a crop,
    so cv2 replicates at the crop's edge)."""
    b, h, w, _ = imgs.shape
    dev = imgs.device
    minv = torch.as_tensor(minv, dtype=torch.float32, device=dev)
    if minv.dim() == 2:
        minv = minv[None].expand(b, 3, 3)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    dst = torch.stack([xs, ys, torch.ones_like(xs)]).reshape(3, h * w)
    # a matrix product, as the JAX package's einsum: one ulp of a coordinate
    # moves a bilinear sample by ~1e-5 at unit image scale
    src = torch.matmul(minv, dst)  # [B, 3, HW]
    sx, sy = src[:, 0] / src[:, 2], src[:, 1] / src[:, 2]
    if clamp and box is not None:
        box = torch.as_tensor(box, dtype=torch.float32, device=dev)
        sx = torch.minimum(torch.maximum(sx, box[0]), box[2])
        sy = torch.minimum(torch.maximum(sy, box[1]), box[3])
    return _sample(imgs, sy, sx, clamp).reshape(imgs.shape)


def warp_target_and_mask(imgs, minv, clamp: bool = False, box=None):
    """(warped target, binarized validity mask): a mask pixel is 1 where the
    warp of an all-ones image is > 0. With clamp=True every output pixel is
    valid (cv2.resize has no border), so the mask is all ones."""
    target = warp_perspective(imgs, minv, clamp=clamp, box=box)
    if clamp:
        return target, torch.ones_like(target)
    m = warp_perspective(torch.ones_like(imgs), minv, clamp=False)
    return target, (m > 0).to(imgs.dtype)


# ---------------------------------------------------------------------------
# host matrix builders, cv2's conventions (scalar numpy, as in the JAX
# package bit for bit)
# ---------------------------------------------------------------------------


def _inv3(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(np.asarray(m, np.float64)).astype(np.float32)


def shift_minv(alpha: float, axis: str) -> np.ndarray:
    """cv2.warpAffine([[1,0,ax],[0,1,ay]]) dst->src inverse
    (transforms.py:322-340 of the reference)."""
    ax, ay = (alpha, 0.0) if axis == "x" else (0.0, alpha)
    return np.array([[1, 0, -ax], [0, 1, -ay], [0, 0, 1]], np.float32)


def rotate2d_minv(alpha_deg: float, size: int) -> np.ndarray:
    """cv2.getRotationMatrix2D((size//2, size//2), alpha, 1) inverted
    (transforms.py:510-523)."""
    a = np.deg2rad(alpha_deg)
    ca, sa = np.cos(a), np.sin(a)
    cx = cy = size // 2
    m = np.array([
        [ca, sa, (1 - ca) * cx - sa * cy],
        [-sa, ca, sa * cx + (1 - ca) * cy],
        [0, 0, 1],
    ])
    return _inv3(m)


def zoom_minv(alpha: float, size: int) -> tuple[np.ndarray, bool, np.ndarray]:
    """The crop/pad + cv2.resize zoom (transforms.py:156-206) as one dst->src
    affine -> (minv, clamp, box). cv2.resize maps src = (dst + 0.5) * s - 0.5
    and replicates at the array's edges: on the crop + upsample branch
    (alpha < 1) the array is the crop, so clamp with the coordinates clipped
    to the crop [lo, hi - 1]; the pad branch samples a zero-padded plane, a
    zero border in the original image's coordinates."""
    new_size = int(alpha * size)
    if alpha < 1:  # crop [lo:hi], upsample; crop length is 2*(ns//2)
        lo = size // 2 - new_size // 2
        hi = size // 2 + new_size // 2
        s = (hi - lo) / size
        off = lo + 0.5 * s - 0.5
        clamp = True
        box = np.array([lo, lo, hi - 1, hi - 1], np.float32)
    else:  # zero-pad to new_size, downsample
        lo = new_size // 2 - size // 2
        s = new_size / size
        off = 0.5 * s - 0.5 - lo
        clamp = False
        box = np.array([0, 0, size - 1, size - 1], np.float32)
    return np.array([[s, 0, off], [0, s, off], [0, 0, 1]], np.float32), clamp, box


def rotate3d_minv(phi_deg: float, size: int, dx: float = 5.0) -> np.ndarray:
    """The reference's perspective rotation about the y axis
    (utils/rotate3d.py:46-119), inverted for dst->src sampling
    (cv2.warpPerspective inverts internally)."""
    rp = np.deg2rad(phi_deg)
    w = h = size
    d = np.sqrt(h * h + w * w)
    f = d / 1.0  # gamma=0 -> focal = d / 1
    dz = f
    a1 = np.array([[1, 0, -w / 2], [0, 1, -h / 2], [0, 0, 1], [0, 0, 1]])
    ry = np.array([
        [np.cos(rp), 0, -np.sin(rp), 0],
        [0, 1, 0, 0],
        [np.sin(rp), 0, np.cos(rp), 0],
        [0, 0, 0, 1],
    ])
    t = np.array([[1, 0, 0, dx], [0, 1, 0, 0], [0, 0, 1, dz], [0, 0, 0, 1]])
    a2 = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0]])
    return _inv3(a2 @ t @ ry @ a1)


# ---------------------------------------------------------------------------
# color targets (transforms.py:8-131 of the reference), in the images'
# dtype: f32 on the path. The Lab round trip is ill-conditioned in f32: an
# ulp of a power or of the 3x3 products moves the target by ~1e-5 at unit
# scale, as far as the JAX package's own eager and jitted results lie apart
# ---------------------------------------------------------------------------

_M_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
              (0.212671, 0.715160, 0.072169),
              (0.019334, 0.119193, 0.950227))
_WHITE = (0.95047, 1.0, 1.08883)


def _const(values, like):
    """A constant in ``like``'s dtype (f32 on the path) and on its device."""
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def rgb2lab_dev(rgb):
    """sRGB in [0, 1] (D65) -> CIE Lab, over the last axis."""
    rgb = torch.clamp(rgb, 0.0, 1.0)
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    xyz = lin @ _const(_M_RGB2XYZ, rgb).T / _const(_WHITE, rgb)
    cbrt = torch.copysign(xyz.abs() ** (1.0 / 3.0), xyz)
    f = torch.where(xyz > 0.008856, cbrt, 7.787 * xyz + 16.0 / 116.0)
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], -1)


def lab2rgb_dev(lab):
    """CIE Lab -> sRGB in [0, 1]; the XYZ -> RGB matrix is the f32 matrix's
    inverse, taken on the device as the JAX package takes it."""
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    f = torch.stack([fx, fy, fz], -1)
    xyz = torch.where(f ** 3 > 0.008856, f ** 3, (f - 16.0 / 116.0) / 7.787) * _const(_WHITE, lab)
    lin = xyz @ torch.linalg.inv(_const(_M_RGB2XYZ, lab)).T
    rgb = torch.where(lin > 0.0031308,
                      1.055 * torch.clamp(lin, min=0.0) ** (1 / 2.4) - 0.055,
                      12.92 * lin)
    return torch.clamp(rgb, 0.0, 1.0)


def color_target(imgs, alpha):
    """imgs [B, H, W, 3] + a per-sample channel shift alpha [B, 3]
    (transforms.py:30-44)."""
    return imgs + alpha[:, None, None, :], torch.ones_like(imgs)


def colorlab_target(imgs, alpha):
    """A Lab-space shift: alpha [B, 3] in [-1, 1] scaled to the L/a/b ranges
    (transforms.py:95-114)."""
    scale = _const((50.0, 128.0, 128.0), imgs)
    lab = rgb2lab_dev((imgs + 1.0) / 2.0) + (alpha * scale)[:, None, None, :]
    return lab2rgb_dev(lab) * 2.0 - 1.0, torch.ones_like(imgs)
