"""latent2im_tpu_torch/tasks/cv2_np.py (OpenCV's resize and warps in numpy)
against the installed cv2, on the CPU, over a seeded sweep of each
geometric task's alpha range at 32, 64 and 256 px:

- ``get_rotation_matrix_2d``: bit for bit;
- ``warp_affine`` (float32 shift matrices, float64 rotations) and
  ``warp_perspective`` (rotate3d's matrices), on float32 images and on
  float64 masks and images: bit for bit;
- ``resize`` with INTER_LINEAR up and down, float32 and float64: masks bit
  for bit; images within one float32 ulp of their magnitude (float32 is
  bit for bit at the tasks' ratios; an extreme upscale's edge columns and a
  float64 downscale whose ratio is no binary fraction differ in the last
  bits).
"""

import numpy as np
import pytest

from latent2im_tpu_torch.tasks import cv2_np
from latent2im_tpu_torch.tasks.geometric import ImageTransformer

cv2 = pytest.importorskip("cv2")

SIZES = (32, 64, 256)


def _images(size, seed):
    rng = np.random.RandomState(seed)
    img = np.tanh(rng.randn(size, size, 3)).astype(np.float32)
    mask = np.zeros((size, size, 3))
    mask[size // 5:size - size // 7, size // 3:] = 1.0
    return img, mask, img.astype(np.float64)


def _within_an_ulp(got, want):
    ulp = np.spacing(np.abs(np.asarray(want, np.float32))).astype(np.float64)
    assert np.all(np.abs(np.asarray(got, np.float64) - want) <= ulp)


def test_get_rotation_matrix_2d_bit_for_bit():
    for alpha in list(np.random.RandomState(0).uniform(-90, 90, 40)) + [-45, 0, 45, 90]:
        for size in SIZES:
            c = (size // 2, size // 2)
            np.testing.assert_array_equal(cv2_np.get_rotation_matrix_2d(c, alpha, 1),
                                          cv2.getRotationMatrix2D(c, alpha, 1))


@pytest.mark.parametrize("size", SIZES)
def test_warp_affine_bit_for_bit(size):
    img, mask, img64 = _images(size, size)
    rng = np.random.RandomState(size + 1)
    mats = [np.float32([[1, 0, s], [0, 1, 0]]) for s in (-8, -5, 3, 7)]
    mats += [np.float32([[1, 0, 0], [0, 1, s]]) for s in (-8, 2, 7)]
    mats += [cv2.getRotationMatrix2D((size // 2, size // 2), float(a), 1)
             for a in list(rng.uniform(-45, 45, 4)) + [-45, 44]]
    for m in mats:
        for x in (img, mask, img64):
            np.testing.assert_array_equal(cv2_np.warp_affine(x, m, (size, size)),
                                          cv2.warpAffine(x, m, (size, size)))


@pytest.mark.parametrize("size", SIZES)
def test_warp_perspective_bit_for_bit(size):
    img, mask, img64 = _images(size, size + 2)
    rng = np.random.RandomState(size + 3)
    for phi in list(rng.uniform(-720, 720, 4)) + [-720, 719]:
        it = ImageTransformer(img)
        it.focal = np.sqrt(2.0 * size * size)  # rotate_along_axis's, gamma 0
        m = it._get_m(0.0, np.deg2rad(phi), 0.0, 5, 0, it.focal)
        for x in (img, mask, img64):
            with np.errstate(all="ignore"):
                got = cv2_np.warp_perspective(x, m, (size, size))
            np.testing.assert_array_equal(got, cv2.warpPerspective(x, m, (size, size)))


@pytest.mark.parametrize("size", SIZES)
def test_resize_up_and_down(size):
    img, mask, img64 = _images(size, size + 4)
    rng = np.random.RandomState(size + 5)
    for alpha in list(rng.uniform(0.5, 2.0, 4)) + [0.5, 0.75, 1.5, 2.0]:
        n = int(alpha * size)
        if alpha < 1:  # zoom's crop, float32, up to the size
            lo, hi = size // 2 - n // 2, size // 2 + n // 2
            src = [img[lo:hi, lo:hi], img64[lo:hi, lo:hi]]
            masks = [mask[lo:hi, lo:hi]]
        else:  # zoom's float64 pad, down to the size
            pad = np.zeros((n, n, 3))
            lo = n // 2 - size // 2
            pad[lo:lo + size, lo:lo + size] = img
            pmask = np.zeros((n, n, 3))
            pmask[lo:lo + size, lo:lo + size] = 1.0
            src, masks = [pad, pad.astype(np.float32)], [pmask]
        for x in src:
            _within_an_ulp(cv2_np.resize(x, (size, size)),
                           cv2.resize(x, (size, size), interpolation=cv2.INTER_LINEAR))
        for x in masks:
            np.testing.assert_array_equal(
                cv2_np.resize(x, (size, size)),
                cv2.resize(x, (size, size), interpolation=cv2.INTER_LINEAR))
    # the float32 images at the tasks' ratios: bit for bit
    np.testing.assert_array_equal(cv2_np.resize(img[8:-8, 8:-8], (size, size)),
                                  cv2.resize(img[8:-8, 8:-8], (size, size),
                                             interpolation=cv2.INTER_LINEAR))


def test_two_dimensional_inputs_and_refused_dtypes():
    img = np.random.RandomState(9).rand(32, 32).astype(np.float32)
    m = cv2.getRotationMatrix2D((16, 16), 30, 1)
    np.testing.assert_array_equal(cv2_np.warp_affine(img, m, (32, 32)),
                                  cv2.warpAffine(img, m, (32, 32)))
    np.testing.assert_array_equal(cv2_np.resize(img, (20, 40)),
                                  cv2.resize(img, (20, 40), interpolation=cv2.INTER_LINEAR))
    with pytest.raises(TypeError):
        cv2_np.resize(img.astype(np.uint8), (16, 16))
    with pytest.raises(TypeError):
        cv2_np.warp_affine(img.astype(np.uint8), m, (32, 32))
