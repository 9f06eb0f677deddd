"""The port's resizes against the JAX package, on the CPU:

- ``engine.editor.bilinear_resize`` (--reg_input_size, --content_input_size,
  the eval's whitened embedding input) against ``jax.image.resize(...,
  "linear")``, which antialiases on a downscale: forward and gradient,
  within 1e-6 absolute at unit scale;
- the Editor's regressor and content-loss inputs at those sizes against the
  JAX Editor and step (tests/test_combine_misc.py:130,
  tests/test_engine.py:342-384);
- ``utils.image.pil_resize_bicubic`` (the eval's --ref_parity input) bit for
  bit against Pillow's ``Image.resize`` with its default BICUBIC filter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch

from test_torch_remat import SIZE, TERMS, jax_step, jax_world, port_editor, port_step

from latent2im_tpu.engine.editor import Editor as JEditor
from latent2im_tpu.engine.editor import EditorConfig as JEditorConfig
from latent2im_tpu.engine.editor import _bilinear_resize
from latent2im_tpu_torch.engine.editor import bilinear_resize
from latent2im_tpu_torch.utils.image import pil_resize_bicubic

# (batch, in h, in w, channels, out h, out w)
CASES = [(2, 64, 64, 3, 16, 16), (1, 256, 256, 3, 160, 160), (2, 40, 40, 5, 16, 16),
         (2, 16, 16, 3, 32, 32), (1, 48, 30, 2, 20, 45)]


@pytest.mark.parametrize("b,h,w,c,oh,ow", CASES)
def test_bilinear_resize_matches_jax_image_resize(b, h, w, c, oh, ow):
    rng = np.random.RandomState(h + oh)
    x = rng.randn(b, h, w, c).astype(np.float32)
    g = rng.randn(b, oh, ow, c).astype(np.float32)
    want, vjp = jax.vjp(lambda t: _bilinear_resize(t, oh, ow), jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = bilinear_resize(xt, oh, ow)
    assert got.shape == (b, oh, ow, c) and got.is_contiguous()
    (got_grad,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-6)
    # the same values from a channels-last-strided NHWC view
    xv = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    torch.testing.assert_close(bilinear_resize(xv, oh, ow), got.detach(), rtol=0, atol=0)


@pytest.fixture(scope="module")
def world():
    return jax_world(seed=1)


def test_reg_input_size_resizes_before_regression(world):
    """As tests/test_combine_misc.py:130, and against the JAX Editor's
    regress_all on the same weights."""
    ed = port_editor(world, reg_input_size=16)
    plain = port_editor(world)
    img = torch.from_numpy(np.random.RandomState(1).randn(2, SIZE, SIZE, 3)
                           .astype(np.float32))
    got = ed.regress_all(img)
    want = plain.regress_all(bilinear_resize(img, 16, 16))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert plain.regress_all(img).shape == (2, 40)
    g_tree, _, reg_tree, _ = world[1]
    cfg = JEditorConfig(attr_list=("Smiling",), attr_idx=(31,), size=SIZE, dim_z=32,
                        reg_input_size=16)
    jgot = JEditor(cfg, g_tree, reg_params=reg_tree).regress_all(jnp.asarray(img.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-5, atol=1e-5)
    # the training path's scores resize too
    with torch.no_grad():
        torch.testing.assert_close(ed.scores(img), got[:, [31, 39]], rtol=0, atol=0)


def test_content_input_size_step(world):
    """As tests/test_engine.py:342-376: at the generator's resolution a
    no-op (bit-identical step); at half resolution only the content term
    changes."""
    plain, plain_grad, _ = port_step(port_editor(world), world)
    noop, noop_grad, _ = port_step(port_editor(world, content_input_size=SIZE), world)
    assert plain == noop
    np.testing.assert_array_equal(plain_grad, noop_grad)
    half, _, _ = port_step(port_editor(world, content_input_size=SIZE // 2), world)
    assert all(np.isfinite(v) for v in half.values())
    assert half["reg_loss"] == plain["reg_loss"] and half["gan_loss"] == plain["gan_loss"]
    assert half["content_loss"] != plain["content_loss"]


def test_resized_inputs_step_matches_the_jax_step(world):
    flags = dict(reg_input_size=16, content_input_size=16)
    terms, _, _ = port_step(port_editor(world, **flags), world)
    want, _ = jax_step(world, **flags)
    for k in TERMS:
        np.testing.assert_allclose(terms[k], want[k], rtol=1e-4, err_msg=k)


def test_content_input_resizes_like_reg_input(world):
    ed = port_editor(world, content_input_size=16)
    img = torch.from_numpy(np.random.RandomState(2).randn(2, SIZE, SIZE, 3)
                           .astype(np.float32))
    torch.testing.assert_close(ed._content_input(img), bilinear_resize(img, 16, 16))
    small = img[:, :16, :16]
    assert ed._content_input(small) is small


@pytest.mark.parametrize("h,w", [(1024, 1024), (256, 256), (64, 64), (47, 53), (160, 160),
                                 (100, 300)])
@pytest.mark.parametrize("size", [(160, 160), (33, 120)])
def test_pil_bicubic_is_bit_exact(h, w, size):
    rng = np.random.RandomState(h * 7 + w)
    noise = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([127.5 + 127.5 * np.sin(xx / 9.0 + yy / 13.0 + c)
                       for c in range(3)], -1).astype(np.uint8)
    for im in (noise, smooth):
        want = np.asarray(PIL.Image.fromarray(im).resize(size))
        got = pil_resize_bicubic(im, size)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
