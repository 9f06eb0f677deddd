"""The port's loss towers against the JAX package on the CPU: the StyleGAN2
discriminator (models/stylegan2.py), VGG19's content taps (models/vgg.py)
and the losses (engine/losses.py), on JAX-initialised pytrees carried over
by latent2im_tpu_torch/io/convert.py, forward and input gradient.

Tolerances, relative to max |reference|: D and VGG 1e-4 (chains of f32
convs summed in another order), their input gradients 2e-4; the losses
1e-5 (f32 reductions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from latent2im_tpu.engine import losses as jL
from latent2im_tpu.models import stylegan2 as jsg2
from latent2im_tpu.models import vgg as jvgg
from latent2im_tpu_torch.engine import losses as L
from latent2im_tpu_torch.io import convert
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.models import vgg as vggm

SIZE = 16
CH = {4: 32, 8: 16, 16: 8}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


@pytest.fixture(scope="module")
def d_pair():
    """A JAX D with every bias perturbed off zero, and the port's D loaded
    from it with strict=True."""
    tree = jsg2.init_discriminator(jax.random.PRNGKey(3), SIZE, channels=CH)
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32)
        if a.ndim == 1 else a, tree)
    d = sg2.Discriminator(SIZE, channels=CH)
    d.load_state_dict(convert.discriminator_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)), strict=True)
    return tree, d.requires_grad_(False)


@pytest.mark.parametrize("batch", [4, 6, 3])  # groups of 4, 3 (fallback), 3
def test_discriminator_matches_jax(d_pair, batch):
    tree, d = d_pair
    rng = np.random.RandomState(batch)
    img = rng.randn(batch, SIZE, SIZE, 3).astype(np.float32)
    g = rng.randn(batch, 1).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jsg2.discriminator_forward(tree, x),
                        jnp.asarray(img))
    (want_dx,) = vjp(jnp.asarray(g))
    x = _t(img).requires_grad_()
    got = d(x)
    _close(got, want, 1e-4)
    got.backward(_t(g))
    _close(x.grad, want_dx, 2e-4)


def test_minibatch_stddev_matches_jax():
    x = np.random.RandomState(1).randn(6, 4, 4, 5).astype(np.float32)
    _close(sg2.minibatch_stddev(_t(x)), jsg2.minibatch_stddev(jnp.asarray(x)), 1e-6)


def test_discriminator_state_dict_names_are_rosinality():
    d = sg2.Discriminator(SIZE, channels=CH)
    keys = set(d.state_dict())
    assert {"convs.0.0.weight", "convs.0.1.bias", "convs.1.conv1.0.weight",
            "convs.1.conv1.1.bias", "convs.1.conv2.1.weight",
            "convs.1.conv2.2.bias", "convs.1.skip.1.weight",
            "final_conv.0.weight", "final_conv.1.bias",
            "final_linear.0.weight", "final_linear.1.bias"} <= keys
    assert not any(k.endswith(".kernel") for k in keys)


@pytest.fixture(scope="module")
def vgg_pair():
    tree = jvgg.init_vgg(jax.random.PRNGKey(4), "vgg19")
    rng = np.random.RandomState(2)
    tree["convs"] = [{"w": c["w"], "b": c["b"] + 0.05 * rng.randn(*c["b"].shape)
                      .astype(np.float32)} for c in tree["convs"]]
    vgg = vggm.VGG19Features()
    vgg.load_state_dict(convert.vgg_from_jax(
        {"cfg": "vgg19", "convs": jax.tree_util.tree_map(np.asarray, tree["convs"])}),
        strict=True)
    return tree, vgg.requires_grad_(False)


def test_vgg_content_taps_match_jax(vgg_pair):
    tree, vgg = vgg_pair
    x = np.random.RandomState(3).randn(2, 16, 16, 3).astype(np.float32)
    want = jvgg.vgg_features(tree, jnp.asarray(x), jvgg.CONTENT_TAPS)
    got = vgg(_t(x))
    assert list(got) == list(vggm.CONTENT_TAPS)
    for tap in vggm.CONTENT_TAPS:
        _close(got[tap].permute(0, 2, 3, 1), want[tap], 1e-4)
    # other taps by the reference's names, and the early stop
    got = vgg(_t(x), ("relu_2", "pool_2"))
    want = jvgg.vgg_features(tree, jnp.asarray(x), ("relu_2", "pool_2"))
    for tap in ("relu_2", "pool_2"):
        _close(got[tap].permute(0, 2, 3, 1), want[tap], 1e-4)


def test_content_loss_matches_jax(vgg_pair):
    tree, vgg = vgg_pair
    rng = np.random.RandomState(4)
    org = np.tanh(rng.randn(2, 16, 16, 3)).astype(np.float32)
    edi = np.tanh(rng.randn(2, 16, 16, 3)).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda e: jL.content_loss(tree, jnp.asarray(org), e))(jnp.asarray(edi))
    e = _t(edi).requires_grad_()
    got = L.content_loss(vgg, _t(org), e)
    _close(got, want, 1e-5)
    got.backward()
    _close(e.grad, want_g, 2e-4)


def test_features_state_dict_takes_both_layouts():
    vgg = vggm.VGG19Features(generator=torch.Generator().manual_seed(0))
    sd = vgg.state_dict()
    bare = {k[len("features."):]: v for k, v in sd.items()}
    full = {**sd, "classifier.0.weight": torch.zeros(1)}
    assert vggm.features_state_dict(bare).keys() == sd.keys()
    assert vggm.features_state_dict(full).keys() == sd.keys()


def test_losses_match_jax():
    rng = np.random.RandomState(5)
    # raw regressor outputs on both sides of [0, 1]: the clamps engage
    pred = (1.5 * rng.randn(4, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (4, 3)).astype(np.float32)
    logits = rng.randn(4, 1).astype(np.float32)
    for port_fn, jax_fn, args in (
            (L.raw_bce, jL.raw_bce, (pred, target)),
            (L.stable_bce, jL.stable_bce, (pred, target)),
            (lambda p, t: L.reg_loss(p, t, stable=True),
             lambda p, t: jL.reg_loss(p, t, stable=True), (pred, target)),
            (L.gan_loss_from_logits, jL.gan_loss_from_logits, (logits,))):
        want, want_g = jax.value_and_grad(jax_fn)(*map(jnp.asarray, args))
        a0 = _t(args[0]).requires_grad_()
        got = port_fn(a0, *map(_t, args[1:]))
        assert got.dtype == torch.float32
        _close(got, want, 1e-5)
        got.backward()
        _close(a0.grad, want_g, 1e-5)


@pytest.mark.parametrize("no_content,no_gan,pggan", [
    (a, b, c) for a in (False, True) for b in (False, True) for c in (False, True)])
def test_combine_gating_matches_jax(no_content, no_gan, pggan):
    kw = dict(no_content_loss=no_content, no_gan_loss=no_gan, pggan_gating=pggan)
    got = L.combine(torch.tensor(1.5), torch.tensor(2.0), torch.tensor(3.0), **kw)
    want = jL.combine(jnp.float32(1.5), jnp.float32(2.0), jnp.float32(3.0), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)
