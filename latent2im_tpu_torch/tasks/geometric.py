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

The JAX package's host targets (``get_target_np``, ``ImageTransformer``)
need cv2, which the port does not use (ROADMAP.md queue A item 24). Layout
NHWC.
"""

from __future__ import annotations

import numpy as np

from . import warp as warplib
from .transforms import Task


def _full_box(size: int) -> np.ndarray:
    return np.array([0, 0, size - 1, size - 1], np.float32)


def _id_payload(size: int) -> dict:
    return {"minv": np.eye(3, dtype=np.float32), "box": _full_box(size)}


class ColorTransform(Task):
    """A channel-wise additive color shift (transforms.py:8-78)."""

    num_channels = 3

    def __init__(self, walk_type="linear", nsliders=3, channel=None):
        super().__init__(walk_type, nsliders)
        self.channel = channel

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

    def test_alphas(self):
        return np.linspace(-720, 720, 9)

    def vis_alphas(self, num_panels):
        return np.linspace(-720, 720, num_panels)


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
