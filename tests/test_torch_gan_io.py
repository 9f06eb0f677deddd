"""The surface of the port's joint GAN fine-tune, on the CPU, against the JAX
package:

- the real-image reader: ``utils/image.py:load_and_resize_image`` (PNG,
  centre crop, Pillow's BILINEAR) bit for bit against the JAX package's
  Pillow path, down- and up-scaling, square and not;
- the provider's real batches: ``cli/train.py:_make_real_batcher`` draws the
  JAX package's fallback index sequence and images, also after a replay of
  the stream (load=False); a baseline and a progressive JPEG are read as
  the JAX package reads them, a WEBP file is refused naming it.

The JAX package takes its native extension (``latent2im_tpu/native``, built
from ``native/l2i_native.cpp`` where a compiler and libpng/libjpeg exist)
before Pillow, and its native Loader shuffles per epoch with
``std::mt19937_64`` and resizes without Pillow's antialias; the port takes
its counterpart (``latent2im_tpu_torch/native``, tests/test_torch_native.py)
first alike. These tests hold the pure-Python fallback of both, so they hide
both modules (``sys.modules["latent2im_tpu.native"] = None``, and the same
for ``latent2im_tpu_torch.native``);

- the GAN checkpoint, both ways: a port-written one restores in the JAX
  package's ``load_pytree(path, like)`` with its full structure (weights,
  EMA, both Adam states) bit for bit, and a JAX-written one resumes in the
  port with equal weights and moments, or, without optimizer state, with
  the weights alone; ``load_gan_checkpoint`` (vis_w --save_path_gan) reads
  the port's file.
"""

import os
import sys

import numpy as np
import PIL.Image
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from latent2im_tpu.cli import train as jcli
from latent2im_tpu.engine import gan as jgan
from latent2im_tpu.io import checkpoint as jckpt
from latent2im_tpu.models import stylegan2 as jsg2
from latent2im_tpu.utils import image as jimage
from latent2im_tpu_torch.cli import train as tcli
from latent2im_tpu_torch.engine import gan
from latent2im_tpu_torch.io import checkpoint as ckpt
from latent2im_tpu_torch.io import convert
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.utils import image as imgmod

TINY = {4: 8, 8: 8, 16: 8}
SIZE, STYLE = 16, 16


@pytest.fixture
def jax_fallback(monkeypatch):
    """Both packages with their native paths hidden: Pillow and the
    RandomState index draw."""
    monkeypatch.setitem(sys.modules, "latent2im_tpu.native", None)
    monkeypatch.setitem(sys.modules, "latent2im_tpu_torch.native", None)


def _write_png(path, h, w, seed):
    img = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(imgmod.png_bytes(img))
    return str(path)


@pytest.mark.parametrize("h,w,size", [
    (40, 40, 16), (37, 53, 16), (53, 37, 24), (20, 31, 64), (16, 16, 16),
    (100, 70, 33), (9, 12, 32),
])
def test_load_and_resize_image_matches_the_jax_package(tmp_path, jax_fallback, h, w, size):
    path = _write_png(tmp_path / "a.png", h, w, h * 100 + w)
    got = imgmod.load_and_resize_image(path, size)
    want = jimage.load_and_resize_image(path, size)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)


def test_real_batches_follow_the_jax_fallback(tmp_path, jax_fallback):
    (tmp_path / "sub").mkdir()
    for i, (h, w) in enumerate([(20, 24), (24, 20), (18, 18), (30, 22), (16, 40)]):
        _write_png(tmp_path / ("sub" if i % 2 else ".") / f"im{i}.png", h, w, i)
    paths = tcli._real_paths(str(tmp_path))
    assert len(paths) == 5 and paths == sorted(paths)
    want = jcli._make_real_batcher(paths, SIZE, 3)
    got = tcli._make_real_batcher(paths, SIZE, 3)
    replayed = tcli._make_real_batcher(paths, SIZE, 3)
    for i in range(4):
        batch = want()
        np.testing.assert_array_equal(got(), batch)
        if i < 2:
            assert replayed(load=False) is None
        else:
            np.testing.assert_array_equal(replayed(), batch)


def test_real_paths_refuse_a_jpeg_naming_it(tmp_path, jax_fallback):
    """A baseline .JPG, a progressive .jpg and a WEBP file under a .jpg
    name (each refused until the reader took its kind, hence the name) are
    listed and read as the JAX package reads them."""
    _write_png(tmp_path / "a.png", 8, 8, 0)
    img = np.random.RandomState(1).randint(0, 256, (20, 26, 3)).astype(np.uint8)
    PIL.Image.fromarray(img).save(tmp_path / "b.JPG", "JPEG", quality=90)
    paths = tcli._real_paths(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == ["a.png", "b.JPG"]
    np.testing.assert_array_equal(imgmod.load_and_resize_image(paths[1], SIZE),
                                  jimage.load_and_resize_image(paths[1], SIZE))
    PIL.Image.fromarray(img).save(tmp_path / "c.jpg", "JPEG", progressive=True)
    path = tcli._real_paths(str(tmp_path))[2]
    np.testing.assert_array_equal(imgmod.load_and_resize_image(path, SIZE),
                                  jimage.load_and_resize_image(path, SIZE))
    PIL.Image.fromarray(img).save(tmp_path / "d.jpg", "WEBP")
    path = tcli._real_paths(str(tmp_path))[3]
    np.testing.assert_array_equal(imgmod.load_and_resize_image(path, SIZE),
                                  jimage.load_and_resize_image(path, SIZE))
    with pytest.raises(SystemExit, match="no images"):
        tcli._real_paths(str(tmp_path / "nothing"))


@pytest.fixture(scope="module")
def trees():
    kg, kd = jax.random.split(jax.random.PRNGKey(11))
    g = jax.jit(lambda k: jsg2.init_generator(k, SIZE, style_dim=STYLE, n_mlp=2,
                                              channels=TINY))(kg)
    d = jax.jit(lambda k: jsg2.init_discriminator(k, SIZE, channels=TINY))(kd)
    return jax.tree_util.tree_map(np.asarray, g), jax.tree_util.tree_map(np.asarray, d)


def _port_module(g_tree, d_tree):
    g = sg2.Generator(SIZE, STYLE, 2, channels=TINY)
    g.load_state_dict(convert.generator_from_jax(g_tree), strict=True)
    d = sg2.Discriminator(SIZE, channels=TINY)
    d.load_state_dict(convert.discriminator_from_jax(d_tree), strict=True)
    return gan.GANModule.create(g.requires_grad_(False), d.requires_grad_(False))


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert np.asarray(x).shape == np.asarray(y).shape
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_port_gan_checkpoint_restores_in_the_jax_package(tmp_path, trees):
    mod = _port_module(*trees)
    d_step, g_step = gan.make_gan_update_steps(lambda z: mod.g(z), mod.d, mod)
    rng = np.random.RandomState(3)
    z = torch.from_numpy(rng.randn(2, STYLE).astype(np.float32))
    real = torch.from_numpy(rng.randn(2, SIZE, SIZE, 3).astype(np.float32))
    for _ in range(2):  # moments and counts past optax's init
        d_step(z, real, gan.draw_eps(torch.Generator().manual_seed(0), 2, "cpu"))
        g_step(z)
    path = ckpt.save_gan(str(tmp_path / "model_gan_2_final.ckpt"), mod)
    jmod = jgan.GANModule.create(*trees)
    like = {"g": jmod.g_params, "g_running": jmod.g_running, "d": jmod.d_params,
            "g_opt_state": jmod.g_opt_state, "d_opt_state": jmod.d_opt_state}
    got = jckpt.load_pytree(path, like)
    want = ckpt.gan_tree(mod)
    _assert_trees_equal(got["g"], want["g"])
    _assert_trees_equal(got["g_running"], want["g_running"])
    _assert_trees_equal(got["d"], want["d"])
    for k in ("g_opt_state", "d_opt_state"):
        adam = got[k][0]
        assert int(adam.count) == 2
        _assert_trees_equal(adam.mu, want[k]["0"]["mu"])
        _assert_trees_equal(adam.nu, want[k]["0"]["nu"])
    assert float(np.abs(np.asarray(got["g"]["conv1"]["conv"]["w"])
                        - trees[0]["conv1"]["conv"]["w"]).max()) > 0
    # vis_w --save_path_gan reads it: the EMA generator, strict
    g_sd, d_sd = ckpt.load_gan_checkpoint(path)
    sg2.Generator(SIZE, STYLE, 2, channels=TINY).load_state_dict(g_sd, strict=True)
    for n, t in mod.g_running.items():
        assert torch.equal(g_sd[n], t), n
    assert set(d_sd) == set(mod.d.state_dict())


def test_jax_gan_checkpoint_resumes_in_the_port(tmp_path, trees):
    jmod = jgan.GANModule.create(*trees)
    rng = np.random.RandomState(4)

    def rand_like(t):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(rng.randn(*np.shape(a)), np.float32)), t)

    for _ in range(3):  # Adam updates of random gradients
        upd, jmod.g_opt_state = jmod.g_opt.update(rand_like(jmod.g_params),
                                                  jmod.g_opt_state, jmod.g_params)
        jmod.g_params = optax.apply_updates(jmod.g_params, upd)
        upd, jmod.d_opt_state = jmod.d_opt.update(rand_like(jmod.d_params),
                                                  jmod.d_opt_state, jmod.d_params)
        jmod.d_params = optax.apply_updates(jmod.d_params, upd)
        jmod.accumulate()
    path = str(tmp_path / "model_gan_resume.ckpt")
    jcli._save_gan(jmod, path)
    mod = _port_module(*trees)
    assert ckpt.load_gan(path, mod) is None  # the JAX package writes no meta
    want = {"g": jmod.g_params, "g_running": jmod.g_running, "d": jmod.d_params,
            "g_opt_state": {"0": {"count": jmod.g_opt_state[0].count,
                                  "mu": jmod.g_opt_state[0].mu,
                                  "nu": jmod.g_opt_state[0].nu}, "1": {}},
            "d_opt_state": {"0": {"count": jmod.d_opt_state[0].count,
                                  "mu": jmod.d_opt_state[0].mu,
                                  "nu": jmod.d_opt_state[0].nu}, "1": {}}}
    _assert_trees_equal(ckpt.gan_tree(mod), jax.tree_util.tree_map(np.asarray, want))
    assert float(mod.g_opt.state_dict()["state"][0]["step"]) == 3
    # a checkpoint without optimizer state: the weights alone
    jckpt.save_pytree(path, {"g": jmod.g_params, "g_running": jmod.g_running,
                             "d": jmod.d_params})
    fresh = _port_module(*trees)
    ckpt.load_gan(path, fresh)
    assert fresh.g_opt.state_dict()["state"] == {}
    for a, b in zip(fresh.g.parameters(), mod.g.parameters()):
        assert torch.equal(a, b)
