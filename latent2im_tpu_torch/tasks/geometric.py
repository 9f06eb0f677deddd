"""The geometric and color tasks — PyTorch port of
latent2im_tpu/tasks/geometric.py (the GAN-steerability lineage of the
reference, utils/transforms.py:8-614).

Each task samples its training slider (``train_alpha_np``, and
``train_alpha_embed_np`` under --trainEmbed), maps a test alpha to the graph
input (``scale_test_alpha``), gives the test and vis schedules, and
describes its pixel-space training target as a ``device_spec(alpha,
img_size)`` -> (kind, payload, clamp): kind 'warp' with a dst->src matrix
and a box (tasks/warp.py), or 'color'/'colorlab' with the per-sample
shift. engine/train.py builds the target and its mask on the device from it
and trains the walk on the masked L2 (engine/losses.py:masked_l2).

The host targets of the JAX package (``get_target_np``, which --host_targets
trains on, ``ImageTransformer``, ``rgb2lab``, ``lab2rgb``) are here with
cv2's resize and warps in numpy (tasks/cv2_np.py): float64 target and mask
arrays, as the reference's cv2 round-trip makes them, bit for bit. Where
the JAX package warps image by image, the batch goes through one call as
channels side by side, and the mask, the same for every image and
channel, is warped once (``_batched``, ``_mask``). Layout NHWC.
"""

from __future__ import annotations

import numpy as np

from . import cv2_np
from . import warp as warplib
from .transforms import Task

# ---------------------------------------------------------------------------
# colorspace helpers (skimage-compatible rgb <-> lab, D65), float64
# ---------------------------------------------------------------------------

_M_RGB2XYZ = np.array(warplib._M_RGB2XYZ)  # the device colorlab's constants
_WHITE = np.array(warplib._WHITE)


def rgb2lab(rgb: np.ndarray) -> np.ndarray:
    """rgb in [0, 1] (H, W, 3) -> Lab."""
    rgb = np.clip(rgb, 0, 1)
    lin = np.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    xyz = lin @ _M_RGB2XYZ.T / _WHITE

    def f(t):
        return np.where(t > 0.008856, np.cbrt(t), 7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(xyz[..., 0]), f(xyz[..., 1]), f(xyz[..., 2])
    return np.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], -1)


def lab2rgb(lab: np.ndarray) -> np.ndarray:
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def finv(t):
        return np.where(t**3 > 0.008856, t**3, (t - 16.0 / 116.0) / 7.787)

    xyz = np.stack([finv(fx), finv(fy), finv(fz)], -1) * _WHITE
    lin = xyz @ np.linalg.inv(_M_RGB2XYZ).T
    rgb = np.where(lin > 0.0031308, 1.055 * np.clip(lin, 0, None) ** (1 / 2.4) - 0.055,
                   12.92 * lin)
    return np.clip(rgb, 0, 1)


def _full_box(size: int) -> np.ndarray:
    return np.array([0, 0, size - 1, size - 1], np.float32)


def _id_payload(size: int) -> dict:
    return {"minv": np.eye(3, dtype=np.float32), "box": _full_box(size)}


def _batched(fn, batch: np.ndarray) -> np.ndarray:
    """fn (a cv2_np call on one image [H, W, C]) over a batch [B, H, W, C]
    in one call, the images side by side as channels: each channel is
    warped alone, so each image comes out as it would by itself."""
    b, h, w, c = batch.shape
    out = fn(np.ascontiguousarray(batch.transpose(1, 2, 0, 3).reshape(h, w, b * c)))
    return out.reshape(out.shape[0], out.shape[1], b, c).transpose(2, 0, 1, 3)


def _mask(fn, mask_in: np.ndarray) -> np.ndarray:
    """fn of a mask batch whose images and channels are all alike (the
    tasks' masks): one channel warped, then repeated."""
    one = fn(mask_in[0, ..., :1])
    return np.broadcast_to(one, (mask_in.shape[0], *one.shape[:2], mask_in.shape[3])).copy()


def _binarize(mask: np.ndarray) -> np.ndarray:
    mask[np.nonzero(mask)] = 1.0
    assert np.setdiff1d(mask, [0.0, 1.0]).size == 0
    return mask


class ImageTransformer:
    """Perspective rotation of an (H, W, C) image about the x/y/z axes
    (utils/rotate3d.py:46-119)."""

    def __init__(self, image_np: np.ndarray):
        self.image = image_np
        self.height, self.width = image_np.shape[:2]

    def rotate_along_axis(self, theta=0, phi=0, gamma=0, dx=0, dy=0, dz=0):
        rt, rp, rg = np.deg2rad([theta, phi, gamma])
        d = np.sqrt(self.height**2 + self.width**2)
        self.focal = d / (2 * np.sin(rg) if np.sin(rg) != 0 else 1)
        dz = self.focal
        mat = self._get_m(rt, rp, rg, dx, dy, dz)
        return cv2_np.warp_perspective(self.image, mat, (self.width, self.height))

    def _get_m(self, theta, phi, gamma, dx, dy, dz):
        w, h, f = self.width, self.height, self.focal
        a1 = np.array([[1, 0, -w / 2], [0, 1, -h / 2], [0, 0, 1], [0, 0, 1]])
        rx = np.array([[1, 0, 0, 0], [0, np.cos(theta), -np.sin(theta), 0],
                       [0, np.sin(theta), np.cos(theta), 0], [0, 0, 0, 1]])
        ry = np.array([[np.cos(phi), 0, -np.sin(phi), 0], [0, 1, 0, 0],
                       [np.sin(phi), 0, np.cos(phi), 0], [0, 0, 0, 1]])
        rz = np.array([[np.cos(gamma), -np.sin(gamma), 0, 0],
                       [np.sin(gamma), np.cos(gamma), 0, 0],
                       [0, 0, 1, 0], [0, 0, 0, 1]])
        t = np.array([[1, 0, 0, dx], [0, 1, 0, dy], [0, 0, 1, dz], [0, 0, 0, 1]])
        a2 = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0]])
        return a2 @ t @ rx @ ry @ rz @ a1


class ColorTransform(Task):
    """A channel-wise additive color shift (transforms.py:8-78)."""

    num_channels = 3

    def __init__(self, walk_type="linear", nsliders=3, channel=None):
        super().__init__(walk_type, nsliders)
        self.channel = channel

    def get_target_np(self, outputs_zs, alpha):
        mask_out = np.ones(outputs_zs.shape)
        if not np.any(alpha):
            return outputs_zs, mask_out
        target = np.copy(outputs_zs)
        for b in range(alpha.shape[0]):
            for i in range(self.num_channels):
                target[b, :, :, i] += alpha[b, i]
        return target, mask_out

    def device_spec(self, alpha, img_size):
        return ("color", np.asarray(alpha, np.float32), False)

    def train_alpha_np(self, rng, batch, n_attr=None, attr_list=None):
        if self.channel is None:
            a = rng.random_sample((batch, self.num_channels)) - 0.5
        else:
            a = np.zeros((batch, self.num_channels))
            a[:, self.channel] = rng.random_sample(batch) - 0.5
        return a.astype(np.float32), a.astype(np.float32)

    def scale_test_alpha(self, alpha, batch, n_sliders=None, contrast=False):
        if self.channel is None:
            return alpha * np.ones((batch, self.num_channels), np.float32)
        slider = (-alpha * np.ones((batch, self.nsliders), np.float32) if contrast
                  else np.zeros((batch, self.nsliders), np.float32))
        slider[:, self.channel] = alpha
        return slider

    def test_alphas(self):
        return np.linspace(-1, 1, 9)

    def vis_alphas(self, num_panels):
        return np.linspace(0, 1, num_panels)


class ColorLabTransform(ColorTransform):
    """Lab-space color shifts; alpha in [-1, 1] scales to the L/a/b ranges
    (transforms.py:80-131)."""

    def device_spec(self, alpha, img_size):
        return ("colorlab", np.asarray(alpha, np.float32), False)

    def get_target_np(self, outputs_zs, alpha):
        mask_out = np.ones(outputs_zs.shape)
        if not np.any(alpha):
            return outputs_zs, mask_out
        target = np.copy(outputs_zs)
        scaled = np.copy(alpha).astype(np.float64)
        scaled[:, 0] *= 50.0
        scaled[:, 1] *= 128.0
        scaled[:, 2] *= 128.0
        for b in range(alpha.shape[0]):
            lab = rgb2lab((target[b] + 1) / 2)
            for i in range(self.num_channels):
                lab[:, :, i] += scaled[b, i]
            target[b] = lab2rgb(lab) * 2 - 1
        return target, mask_out


class ZoomTransform(Task):
    """A log-alpha slider; a crop/pad + resize target with its validity mask
    (transforms.py:133-284)."""

    num_panel = 15  # the --trainEmbed ladder (transforms.py:138-142)

    def __init__(self, walk_type="linear", nsliders=1, img_size=256):
        super().__init__(walk_type, nsliders)
        self.img_size = img_size

    def embedding_alphas(self):
        # a geometric ladder in zoom-factor space (transforms.py:142)
        return np.exp(np.linspace(np.log(0.5), np.log(2), self.num_panel))

    def train_alpha_embed_np(self, rng, batch, n_attr=None):
        # zoom's --trainEmbed slider is log(alpha), unscaled
        # (transforms.py:211-222)
        index = int(rng.choice(self.num_panel))
        alpha_val = float(self.embedding_alphas()[index])
        slider = np.full((batch, self.nsliders), np.log(alpha_val), np.float32)
        return slider, np.float32(alpha_val), index

    def device_spec(self, alpha, img_size):
        """Crop/pad + resize as one dst->src affine (warp.zoom_minv); the
        zoom-in branch clamps to the crop box (cv2.resize's border)."""
        if alpha == 1:
            return ("warp", _id_payload(img_size), True)
        minv, clamp, box = warplib.zoom_minv(float(alpha), img_size)
        return ("warp", {"minv": minv, "box": box}, clamp)

    def get_target_np(self, outputs_zs, alpha):
        img_size = outputs_zs.shape[1]
        mask_fn = np.ones(outputs_zs.shape)
        if alpha == 1:
            return outputs_zs, mask_fn
        new_size = int(alpha * img_size)
        if alpha < 1:  # crop -> zoom in
            lo = img_size // 2 - new_size // 2
            hi = img_size // 2 + new_size // 2
            cropped = outputs_zs[:, lo:hi, lo:hi, :]
            mask_cropped = mask_fn
        else:  # pad -> zoom out
            cropped = np.zeros((outputs_zs.shape[0], new_size, new_size, outputs_zs.shape[3]))
            mask_cropped = np.zeros_like(cropped)
            lo = new_size // 2 - img_size // 2
            hi = new_size // 2 + img_size // 2
            cropped[:, lo:hi, lo:hi, :] = outputs_zs
            mask_cropped[:, lo:hi, lo:hi, :] = mask_fn
        def resize(x):
            return cv2_np.resize(x, (img_size, img_size))

        target = np.zeros(outputs_zs.shape)
        target[:] = _batched(resize, cropped)
        return target, _binarize(_mask(resize, mask_cropped))

    def train_alpha_np(self, rng, batch, n_attr=None, attr_list=None):
        coin = rng.uniform(0, 1)
        alpha_val = rng.uniform(0.5, 1.0) if coin <= 0.5 else rng.uniform(1.0, 2.0)
        slider = np.ones((batch, self.nsliders), np.float32) * np.log(alpha_val)
        return slider, alpha_val

    def scale_test_alpha(self, alpha, batch, n_sliders=None):
        return np.log(alpha) * np.ones((batch, self.nsliders), np.float32)

    def test_alphas(self):
        return np.array([0.0625, 0.083, 0.125, 0.25, 0.5, 0.8, 1, 1.2, 2, 4, 8, 12, 16])

    def vis_alphas(self, num_panels):
        alp = np.linspace(1, 8, num_panels // 2 + 1)
        b = 1 / alp
        return np.concatenate((np.delete(b[::-1], -1), alp))[::-1]


class ShiftTransform(Task):
    """Pixel shifts by an affine warp (transforms.py:286-438)."""

    axis = "x"
    alpha_max = 8
    num_panel = 15  # the --trainEmbed ladder (transforms.py:296-301)
    embed_alpha_max = 7.0

    def __init__(self, walk_type="linear", nsliders=1, img_size=256):
        super().__init__(walk_type, nsliders)
        self.img_size = img_size

    def embedding_alphas(self):
        return np.linspace(-self.embed_alpha_max, self.embed_alpha_max, self.num_panel)

    def device_spec(self, alpha, img_size):
        return ("warp", {"minv": warplib.shift_minv(float(alpha), self.axis),
                         "box": _full_box(img_size)}, False)

    def get_target_np(self, outputs_zs, alpha):
        img_size = outputs_zs.shape[1]
        mask_fn = np.ones(outputs_zs.shape)
        if alpha == 0:
            return outputs_zs, mask_fn
        if self.axis == "x":
            m = np.float32([[1, 0, alpha], [0, 1, 0]])
        else:
            m = np.float32([[1, 0, 0], [0, 1, alpha]])
        return _warp_batch(outputs_zs, mask_fn, m, cv2_np.warp_affine)

    def train_alpha_np(self, rng, batch, n_attr=None, attr_list=None):
        alpha_val = rng.randint(-self.alpha_max, self.alpha_max)
        slider = np.ones((batch, self.nsliders), np.float32) * (alpha_val / self.alpha_max)
        return slider, alpha_val

    def scale_test_alpha(self, alpha, batch, n_sliders=None):
        return (alpha / self.alpha_max) * np.ones((batch, self.nsliders), np.float32)

    def test_alphas(self):
        return np.array([-200, -150, -100, -50, 0, 50, 100, 150, 200])

    def vis_alphas(self, num_panels):
        return np.linspace(-400, 400, num_panels)


class ShiftXTransform(ShiftTransform):
    axis = "x"


class ShiftYTransform(ShiftTransform):
    axis = "y"


class Rotate2DTransform(Task):
    """In-plane rotation about the image centre (transforms.py:440-547)."""

    alpha_max = 45
    num_panel = 15  # the --trainEmbed ladder (transforms.py:445-451)
    embed_alpha_max = 45.0

    def __init__(self, walk_type="linear", nsliders=1, img_size=256):
        super().__init__(walk_type, nsliders)
        self.img_size = img_size

    def embedding_alphas(self):
        return np.linspace(-self.embed_alpha_max, self.embed_alpha_max, self.num_panel)

    def device_spec(self, alpha, img_size):
        return ("warp", {"minv": warplib.rotate2d_minv(float(alpha), img_size),
                         "box": _full_box(img_size)}, False)

    def get_target_np(self, outputs_zs, alpha):
        img_size = outputs_zs.shape[1]
        mask_fn = np.ones(outputs_zs.shape)
        if alpha == 0:
            return outputs_zs, mask_fn
        m = cv2_np.get_rotation_matrix_2d((img_size // 2, img_size // 2), alpha, 1)
        return _warp_batch(outputs_zs, mask_fn, m, cv2_np.warp_affine)

    def train_alpha_np(self, rng, batch, n_attr=None, attr_list=None):
        alpha_val = rng.randint(-self.alpha_max, self.alpha_max)
        slider = np.ones((batch, self.nsliders), np.float32) * (alpha_val / self.alpha_max)
        return slider, alpha_val

    def scale_test_alpha(self, alpha, batch, n_sliders=None):
        return (alpha / self.alpha_max) * np.ones((batch, self.nsliders), np.float32)

    def test_alphas(self):
        return np.linspace(-90, 90, 9)

    def vis_alphas(self, num_panels):
        return np.linspace(-90, 90, num_panels)


class Rotate3DTransform(Rotate2DTransform):
    """Out-of-plane (perspective) rotation about the y axis
    (transforms.py:549-614)."""

    alpha_max = 720

    def device_spec(self, alpha, img_size):
        if alpha == 0:
            return ("warp", _id_payload(img_size), True)
        return ("warp", {"minv": warplib.rotate3d_minv(float(alpha), img_size, dx=5.0),
                         "box": _full_box(img_size)}, False)

    def get_target_np(self, outputs_zs, alpha):
        mask_fn = np.ones(outputs_zs.shape)
        if alpha == 0:
            return outputs_zs, mask_fn
        def rotate(x):
            return ImageTransformer(x).rotate_along_axis(phi=alpha, dx=5)

        target = np.zeros(outputs_zs.shape)
        target[:] = _batched(rotate, outputs_zs)
        return target, _binarize(_mask(rotate, mask_fn))

    def test_alphas(self):
        return np.linspace(-720, 720, 9)

    def vis_alphas(self, num_panels):
        return np.linspace(-720, 720, num_panels)


def _warp_batch(outputs_zs, mask_fn, m, warp):
    """The images and their masks through ``warp`` (cv2_np.warp_affine)
    with the forward map m -> float64 (target, binarized mask)."""
    img_size = outputs_zs.shape[1]

    def fn(x):
        return warp(x, m, (img_size, img_size))

    target = np.zeros(outputs_zs.shape)
    target[:] = _batched(fn, outputs_zs)
    return target, _binarize(_mask(fn, mask_fn))


GEOMETRIC_TASKS = {
    "color": ColorTransform,
    "colorlab": ColorLabTransform,
    "zoom": ZoomTransform,
    "shiftx": ShiftXTransform,
    "shifty": ShiftYTransform,
    "rotate2d": Rotate2DTransform,
    "rotate3d": Rotate3DTransform,
}


def device_target(spec, imgs):
    """(kind, payload, clamp) of ``Task.device_spec`` and images [B, H, W, 3]
    on the device -> (target, mask) on the same device."""
    kind, payload, clamp = spec
    if kind == "warp":
        return warplib.warp_target_and_mask(imgs, payload["minv"], clamp=clamp,
                                            box=payload["box"])
    alpha = imgs.new_tensor(np.asarray(payload, np.float32))
    if kind == "color":
        return warplib.color_target(imgs, alpha)
    return warplib.colorlab_target(imgs, alpha)
