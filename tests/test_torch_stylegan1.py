"""The port's StyleGAN1 generator (latent2im_tpu_torch/models/stylegan1.py)
against the JAX package's styled_generator_forward on the CPU, on the JAX
package's init_styled_generator weights carried across by
io/convert.py:stylegan1_from_jax, with the same numpy z and noise maps, at
steps 2-3 (16 and 32 px, the 512-wide blocks): the nearest and the fused
upsampling (``fused_from`` 5 and 1), the fade-in (alpha 0.4), style mixing
(``inject_index`` and ``mixing_range``) and truncation (``mean_style``).
Images at tests/helpers.py:assert_images_close's CPU gates (rtol/atol 2e-3:
AdaIN renormalises each layer, convs summed in another order); the pieces
(blur, the fused up and down resampling, pixel norm) within 1e-5. The state
dict has rosinality's names, and the port's seeded init the JAX package's
distributions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import assert_images_close
from test_torch_cli import one_torch_thread  # noqa: F401

from latent2im_tpu.models import stylegan1 as js1
from latent2im_tpu_torch.io.convert import stylegan1_from_jax
from latent2im_tpu_torch.models import stylegan1 as s1

D = 512


@pytest.fixture(scope="module")
def tree():
    """init_styled_generator's tree with non-zero noise weights (its init
    has them at 0, which would hide the noise path)."""
    t = jax.device_get(jax.jit(js1.init_styled_generator)(jax.random.PRNGKey(3)))
    rng = np.random.RandomState(4)
    for p in t["progression"]:
        for k in ("noise1_w", "noise2_w"):
            p[k] = (0.3 * rng.randn(*p[k].shape)).astype(np.float32)
    return t


def _port(tree, fused_from=s1.FUSED_FROM):
    g = s1.StyledGenerator(fused_from=fused_from)
    g.load_state_dict(stylegan1_from_jax(tree, fused_from=fused_from), strict=True)
    return g.eval()


def _inputs(step, b=2, n_z=1, seed=0):
    rng = np.random.RandomState(seed)
    zs = [rng.randn(b, D).astype(np.float32) for _ in range(n_z)]
    noise = [rng.randn(b, 4 * 2 ** i, 4 * 2 ** i, 1).astype(np.float32)
             for i in range(step + 1)]
    return zs, noise


def _both(tree, g, step, zs, noise, fused_from=s1.FUSED_FROM, **kw):
    want = js1.styled_generator_forward(
        tree, [jnp.asarray(z) for z in zs] if len(zs) > 1 else jnp.asarray(zs[0]),
        noise=[jnp.asarray(n) for n in noise], step=step, fused_from=fused_from,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    with torch.no_grad():
        got = g([torch.from_numpy(z) for z in zs] if len(zs) > 1 else torch.from_numpy(zs[0]),
                noise=[torch.from_numpy(n) for n in noise], step=step,
                **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                   for k, v in kw.items() if k != "mean_style_latent"},
                mean_style=(torch.from_numpy(kw["mean_style_latent"])
                            if "mean_style_latent" in kw else None))
    assert got.shape == (zs[0].shape[0], 4 * 2 ** step, 4 * 2 ** step, 3)
    assert got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("step,alpha", [(2, 1.0), (3, 0.4)])
@pytest.mark.parametrize("fused_from", [s1.FUSED_FROM, 1])
def test_the_forward_matches_jax(tree, step, alpha, fused_from):
    g = _port(tree, fused_from)
    zs, noise = _inputs(step)
    got, want = _both(tree, g, step, zs, noise, fused_from=fused_from, alpha=alpha)
    assert_images_close(got, want)


def test_style_mixing_matches_jax(tree):
    g = _port(tree)
    zs, noise = _inputs(3, n_z=2, seed=1)
    for kw in ({"inject_index": [1]}, {"mixing_range": (1, 2)}):
        got, want = _both(tree, g, 3, zs, noise, **kw)
        assert_images_close(got, want)
    one, _ = _both(tree, g, 3, zs[:1], noise)
    assert np.abs(got - one).max() > 1e-2  # the second style reached the image


def test_truncation_matches_jax(tree):
    g = _port(tree)
    zm = np.random.RandomState(5).randn(64, D).astype(np.float32)
    mean = np.asarray(jnp.mean(js1.style_forward(tree, jnp.asarray(zm)), axis=0,
                               keepdims=True))
    with torch.no_grad():
        got_mean = g.style_forward(torch.from_numpy(zm)).mean(0, keepdim=True).numpy()
    np.testing.assert_allclose(got_mean, mean, rtol=1e-4, atol=1e-5)
    zs, noise = _inputs(2, seed=2)
    got, want = _both(tree, g, 2, zs, noise, mean_style_latent=mean, style_weight=0.7)
    assert_images_close(got, want)
    with torch.no_grad():
        m = g.mean_style(n=16, generator=torch.Generator().manual_seed(0))
    assert m.shape == (1, D) and torch.isfinite(m).all()


def test_the_pieces_match_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 6, 4).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    def nhwc(t):
        return t.detach().permute(0, 2, 3, 1).numpy()

    np.testing.assert_allclose(nhwc(s1.Blur(4)(xt)), np.asarray(js1.blur3(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    up, down = s1.FusedUpsample(4, 3, 3, padding=1), s1.FusedDownsample(4, 3, 3, padding=1)
    b = rng.randn(3).astype(np.float32)
    with torch.no_grad():
        up.bias.copy_(torch.from_numpy(b))
        down.bias.copy_(torch.from_numpy(b))
    # FusedUpsample [in, out, k, k] and FusedDownsample [out, in, k, k] ->
    # the JAX package's HWIO
    p_up = {"w": up.weight.detach().permute(2, 3, 0, 1).numpy(), "b": b}
    p_down = {"w": down.weight.detach().permute(2, 3, 1, 0).numpy(), "b": b}
    np.testing.assert_allclose(nhwc(up(xt)), np.asarray(js1.fused_upsample(p_up, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nhwc(down(xt)),
                               np.asarray(js1.fused_downsample(p_down, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    z = rng.randn(3, 8).astype(np.float32)
    np.testing.assert_allclose(s1.PixelNorm()(torch.from_numpy(z)).numpy(),
                               np.asarray(js1.pixel_norm(jnp.asarray(z))), rtol=1e-6)


def test_the_layout_is_rosinalitys_and_the_init_is_the_jax_packages(tree):
    g = s1.StyledGenerator(generator=torch.Generator().manual_seed(0))
    sd = g.state_dict()
    conv = stylegan1_from_jax(tree)
    assert list(conv) != [] and set(conv) == set(sd)
    assert all(conv[k].shape == sd[k].shape for k in sd)
    assert sd["generator.progression.0.conv1.input"].shape == (1, 512, 4, 4)
    assert sd["generator.progression.5.conv1.0.weight"].shape == (256, 128, 3, 3)
    assert sd["generator.progression.4.conv1.1.conv.weight_orig"].shape == (256, 512, 3, 3)
    assert sd["generator.progression.8.noise2.weight_orig"].shape == (1, 16, 1, 1)
    assert sd["style.15.linear.weight_orig"].shape == (512, 512)
    assert sd["generator.to_rgb.8.conv.weight_orig"].shape == (3, 16, 1, 1)
    for k, v in sd.items():
        if k.endswith(("weight_orig", "conv1.0.weight", "conv1.input")) and "noise" not in k:
            tol = 6 / v.numel() ** 0.5  # six standard errors of N(0, 1) draws
            assert abs(float(v.std()) - 1) < tol and abs(float(v.mean())) < tol, k
        elif "noise" in k or (k.endswith("bias") and "adain" not in k):
            assert not v.any(), k
    bias = sd["generator.progression.3.adain2.style.linear.bias"]
    assert bias[:512].eq(1).all() and bias[512:].eq(0).all()
