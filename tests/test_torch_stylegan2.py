"""The port's StyleGAN2 generator (latent2im_tpu_torch/models/stylegan2.py)
against the JAX package on the CPU, on the same weights: the JAX pytree is
carried into the port's state_dict by latent2im_tpu_torch/io/convert.py and
loaded with strict=True. z and noise come from numpy and go to both.

Images are held with tests/helpers.py:assert_images_close (CPU: 2e-3); the
committed torch recordings with the gates their own JAX tests use."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullscale_ref import N_MLP, STYLE_DIM, fixture_z, np_state_dict
from helpers import assert_close, assert_images_close
from latent2im_tpu.models import stylegan2 as jsg2
from latent2im_tpu_torch.io import convert
from latent2im_tpu_torch.models import stylegan2 as sg2

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TINY = {4: 16, 8: 16, 16: 8, 32: 8}


def _perturbed_jax_generator(size, channels, style_dim=32, n_mlp=2, seed=0):
    """A generator pytree with the structure of the JAX package's
    init_generator, filled from a numpy seed at init-like scales (style
    weights ~N(0,1)/lr_mul, modulation biases ~1) and with the terms JAX
    initializes to zero (noise weights, biases) non-zero, so the carried-over
    noise and bias paths are exercised."""
    shapes = jax.eval_shape(
        lambda k: jsg2.init_generator(k, size, style_dim=style_dim,
                                      n_mlp=n_mlp, channels=channels),
        jax.random.PRNGKey(0),
    )
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda s: np.asarray(rng.randn(*s.shape), np.float32), shapes)
    for p in params["style"]:
        p["w"] = p["w"] * np.float32(100.0)
        p["b"] = p["b"] * np.float32(0.1)
    for sc in [params["conv1"], *params["convs"]]:
        sc["noise_w"] = sc["noise_w"] * np.float32(0.5)
        sc["act_b"] = sc["act_b"] * np.float32(0.1)
    for p in [params["conv1"], *params["convs"], params["to_rgb1"],
              *params["to_rgbs"]]:
        p["conv"]["mod"]["b"] = np.float32(1.0) + np.float32(0.1) * p["conv"]["mod"]["b"]
    for p in [params["to_rgb1"], *params["to_rgbs"]]:
        p["b"] = p["b"] * np.float32(0.1)
    return params


def _port_generator(params, size, channels, style_dim=32, n_mlp=2):
    g = sg2.Generator(size, style_dim, n_mlp, channels=channels)
    g.load_state_dict(convert.generator_from_jax(params), strict=True)
    return g.eval()


def _jtree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module")
def tiny_pair():
    params = _perturbed_jax_generator(32, TINY)
    return params, _port_generator(params, 32, TINY)


def test_style_forward_matches_jax(tiny_pair):
    params, g = tiny_pair
    z = np.random.RandomState(1).randn(3, 32).astype(np.float32)
    want = jsg2.style_forward(_jtree(params), jnp.asarray(z))
    with torch.no_grad():
        got = g.style_forward(torch.from_numpy(z))
    assert_close(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_synthesize_stored_noise_matches_jax(tiny_pair):
    params, g = tiny_pair
    lat = np.random.RandomState(2).randn(2, jsg2.n_latent(32), 32).astype(np.float32)
    want = jsg2.synthesize(_jtree(params), jnp.asarray(lat))
    with torch.no_grad():
        got = g.synthesize(torch.from_numpy(lat))
    assert got.shape == (2, 32, 32, 3)
    assert_images_close(got.numpy(), want)


@pytest.mark.parametrize("noise_batch", [1, 2])
def test_synthesize_injected_noise_matches_jax(tiny_pair, noise_batch):
    params, g = tiny_pair
    rng = np.random.RandomState(3)
    lat = rng.randn(2, jsg2.n_latent(32), 32).astype(np.float32)
    noise = [rng.randn(noise_batch, h, w, 1).astype(np.float32)
             for h, w in jsg2.noise_shapes(32)]
    want = jsg2.synthesize(_jtree(params), jnp.asarray(lat),
                           noise=[jnp.asarray(n) for n in noise])
    with torch.no_grad():
        got = g.synthesize(torch.from_numpy(lat),
                           noise=[torch.from_numpy(n) for n in noise])
    assert_images_close(got.numpy(), want)


def test_generator_forward_truncation_matches_jax(tiny_pair):
    params, g = tiny_pair
    rng = np.random.RandomState(4)
    z = rng.randn(2, 32).astype(np.float32)
    t_lat = rng.randn(1, 32).astype(np.float32)
    want = jsg2.generator_forward(_jtree(params), jnp.asarray(z), truncation=0.7,
                                  truncation_latent=jnp.asarray(t_lat))
    with torch.no_grad():
        got = g(torch.from_numpy(z), truncation=0.7,
                truncation_latent=torch.from_numpy(t_lat))
    assert_images_close(got.numpy(), want)


def test_make_noise_and_mean_latent_shapes(tiny_pair):
    _, g = tiny_pair
    gen = torch.Generator().manual_seed(0)
    noise = g.make_noise(3, gen)
    assert [tuple(n.shape) for n in noise] == [
        (3, h, w, 1) for h, w in jsg2.noise_shapes(32)]
    with torch.no_grad():
        img = g(torch.zeros(3, 32), noise_generator=gen)
        assert img.shape == (3, 32, 32, 3)
        assert g.mean_latent(64, gen).shape == (1, 32)
    assert sg2.n_latent(256) == jsg2.n_latent(256) == 14
    assert sg2.noise_shapes(256) == jsg2.noise_shapes(256)
    assert sg2.channel_table(2) == jsg2.channel_table(2)


def test_size_256_skip_shift_branch_matches_jax():
    """At >= 128 px the JAX package upsamples the rgb skip by its polyphase
    shift form (SKIP_SHIFT_MIN_RES); the port runs its upfirdn2d at C=3."""
    assert jsg2.SKIP_SHIFT_MIN_RES <= 128
    ch = {r: 8 for r in (4, 8, 16, 32, 64, 128, 256)}
    params = _perturbed_jax_generator(256, ch, seed=5)
    g = _port_generator(params, 256, ch)
    lat = np.random.RandomState(6).randn(1, jsg2.n_latent(256), 32).astype(np.float32)
    want = jsg2.synthesize(_jtree(params), jnp.asarray(lat))
    with torch.no_grad():
        got = g.synthesize(torch.from_numpy(lat))
    assert_images_close(got.numpy(), want)


def test_size_1024_fast_tail_branch_matches_jax():
    """The 1024 px generator (n_latent 18, nine resolutions) at 8 channels,
    B=1, against JAX synthesize with its defaults: the s2d FAST_TAIL runs
    the 1024 px block there (channels <= FAST_TAIL_MAX_CH, output >=
    FAST_TAIL_MIN_RES); the port computes the same function directly."""
    assert jsg2.FAST_TAIL and jsg2.FAST_TAIL_MAX_CH >= 8 and jsg2.FAST_TAIL_MIN_RES <= 1024
    ch = {2 ** i: 8 for i in range(2, 11)}
    params = _perturbed_jax_generator(1024, ch, seed=7)
    g = _port_generator(params, 1024, ch)
    assert g.n_latent == jsg2.n_latent(1024) == 18
    lat = np.random.RandomState(8).randn(1, 18, 32).astype(np.float32)
    want = jax.jit(jsg2.synthesize)(_jtree(params), jnp.asarray(lat))
    with torch.no_grad():
        got = g.synthesize(torch.from_numpy(lat))
    assert got.shape == (1, 1024, 1024, 3)
    assert_images_close(got.numpy(), want)


def test_ref_g_tiny_loads_strict_and_reproduces_torch_recording():
    """The committed rosinality-layout checkpoint loads with strict=True and
    no conversion, and reproduces its recorded torch outputs (as
    tests/test_parity_fixture.py holds the JAX package to them)."""
    sd = torch.load(os.path.join(FIXDIR, "ref_g_tiny.pt"), map_location="cpu",
                    weights_only=False)["g_ema"]
    g = sg2.Generator(32, 64, 2, channels=sg2.channels_from_state_dict(sd, 32))
    g.load_state_dict(sd, strict=True)
    ref = np.load(os.path.join(FIXDIR, "ref_outputs_tiny.npz"))
    with torch.no_grad():
        got = g.eval()(torch.from_numpy(ref["z"]))
    assert_images_close(got.numpy(), ref["images"])


def test_fullscale_256_state_dict_loads_strict_and_matches_recording():
    """tests/fullscale_ref.py's seeded full-width 256 px g_ema (style_dim
    512, n_mlp 8, channel multiplier 2) loads with strict=True and one image
    matches the committed torch recording, with the gates of
    tests/test_parity_fullscale.py (relative L2 and max-abs, 5e-3)."""
    g = sg2.Generator(256, STYLE_DIM, N_MLP)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in np_state_dict(256).items()},
                      strict=True)
    ref = np.load(os.path.join(FIXDIR, "ref_outputs_256px.npz"))
    z = fixture_z(256, ref["images"].shape[0])[:1]
    with torch.no_grad():
        got = g.eval()(torch.from_numpy(z)).numpy()
    want = ref["images"][:1]
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    max_frac = np.abs(got - want).max() / np.abs(want).max()
    assert rel_l2 < 5e-3 and max_frac < 5e-3, (rel_l2, max_frac)
