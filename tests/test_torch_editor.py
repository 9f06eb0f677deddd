"""The port's Editor and linear_w walk (latent2im_tpu_torch/engine/editor.py,
walks/walks.py) against the JAX package's Editor on the CPU, on the same
weights (size 32, dev_tiny widths, a ResNet-50 regressor with non-trivial BN
statistics) and the same numpy z. Images: assert_images_close (2e-3);
alpha_org: 1e-4; uint8 images: |diff| <= 1 on at most 0.1% of the values
(a truncation boundary can fall either side of an f32 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import assert_images_close
from latent2im_tpu.engine.editor import Editor as JEditor
from latent2im_tpu.engine.editor import EditorConfig as JEditorConfig
from latent2im_tpu.walks import walks as jwalks
from latent2im_tpu_torch.engine.editor import Editor, EditorConfig
from latent2im_tpu_torch.io import convert
from latent2im_tpu_torch.models import resnet as rn
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.walks import walks
from test_torch_resnet import _np_resnet_tree
from test_torch_stylegan2 import TINY, _perturbed_jax_generator

SIZE, DIM = 32, 32
ATTRS, IDX = ("Smiling", "Young"), (31, 39)


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


@pytest.fixture(scope="module")
def editors():
    g_tree = _perturbed_jax_generator(SIZE, TINY, seed=11)
    r_tree = _np_resnet_tree(seed=12)
    walk = {"w": (0.5 * np.random.RandomState(13).randn(
        len(ATTRS), sg2.n_latent(SIZE), DIM)).astype(np.float32)}
    jed = JEditor(JEditorConfig(attr_list=ATTRS, attr_idx=IDX, size=SIZE,
                                dim_z=DIM), _jtree(g_tree), reg_params=_jtree(r_tree))
    g = sg2.Generator(SIZE, DIM, 2, channels=TINY)
    g.load_state_dict(convert.generator_from_jax(g_tree), strict=True)
    reg = rn.ResNet50(num_outputs=40)
    reg.load_state_dict(convert.resnet50_from_jax(r_tree), strict=True)
    ted = Editor(EditorConfig(attr_list=ATTRS, attr_idx=IDX, size=SIZE, dim_z=DIM),
                 g, reg, device="cpu")
    return jed, _jtree(walk), ted, convert.walk_from_jax(walk)


def _z(n, seed=0):
    return np.random.RandomState(seed).randn(n, DIM).astype(np.float32)


@pytest.mark.parametrize("layers", [None, (0, 3, 5)])
def test_linear_w_matches_jax(layers):
    rng = np.random.RandomState(1)
    w = rng.randn(2, 8, 16).astype(np.float32)
    lat = rng.randn(3, 8, 16).astype(np.float32)
    alpha = rng.randn(3, 2).astype(np.float32)
    want = jwalks.apply_linear_w({"w": jnp.asarray(w)}, jnp.asarray(lat),
                                 jnp.asarray(alpha), layers=layers)
    got = walks.apply_linear_w({"w": torch.from_numpy(w)}, torch.from_numpy(lat),
                               torch.from_numpy(alpha), layers=layers)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if layers is not None:  # unmasked layers do not move
        keep = [i for i in range(8) if i not in layers]
        np.testing.assert_array_equal(got.numpy()[:, keep], lat[:, keep])


def test_registry_and_resolution_match_jax():
    assert set(walks.REGISTRY) == set(jwalks.REGISTRY)
    for kind in walks.REGISTRY:
        assert walks.walk_space(kind) == jwalks.walk_space(kind)
    for args, kw in [(("stylegan_v2_real", "linear", "w"), {}),
                     (("stylegan_v2_real", "NNz", "w"), {}),
                     (("stylegan_v2_real", "linear", "z"), {"is_mlp": True}),
                     (("stylegan_v2_real", "linear", "w"), {"train_embed": True}),
                     (("pggan", "linear", "z"), {}), (("pggan", "NNz", "z"), {}),
                     (("pggan", "NNz", "z"), {"train_embed": True})]:
        assert walks.resolve_walk_kind(*args, **kw) == jwalks.resolve_walk_kind(*args, **kw)
    for mod in (walks, jwalks):  # a linear z walk without is_mlp: the reference's gap
        with pytest.raises(NotImplementedError, match="is_mlp"):
            mod.resolve_walk_kind("stylegan_v2_real", "linear", "z")
    # the z walks apply through the registry as the JAX package's do
    # (tests/test_torch_zwalks.py holds each kind and its gradient)
    z = np.random.RandomState(2).randn(3, DIM).astype(np.float32)
    alpha = np.random.RandomState(3).uniform(-1, 1, (3, 2)).astype(np.float32)
    for kind in ("mlp_z", "embed"):
        tree = jax.tree_util.tree_map(np.array, jwalks.init_walk(
            jax.random.PRNGKey(0), kind, DIM, 8, list(ATTRS)))
        kw = {"index": 1} if kind == "embed" else {}
        got = walks.apply_walk(kind, convert.walk_from_jax(tree), torch.from_numpy(z),
                               torch.from_numpy(alpha), **kw)
        want = jwalks.apply_walk(kind, tree, jnp.asarray(z), jnp.asarray(alpha), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=kind)


def test_get_w_and_synthesize_match_jax(editors):
    jed, _, ted, _ = editors
    z = _z(2)
    want = jed.get_w(jnp.asarray(z))
    got = ted.get_w(z)
    assert got.shape == (2, sg2.n_latent(SIZE), DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert_images_close(ted.synthesize(got).numpy(), jed.synthesize(want))
    gen = torch.Generator().manual_seed(0)
    assert ted.synthesize(got, noise_generator=gen).shape == (2, SIZE, SIZE, 3)


def test_apply_alpha_float_matches_jax(editors):
    jed, jwalk, ted, twalk = editors
    z, a = _z(2, 1), np.asarray([0.2, 0.9], np.float32)
    je, ja, jo = jed.apply_alpha(jwalk, z, a)
    te, ta, to = ted.apply_alpha(twalk, z, a)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-4)
    assert_images_close(to.numpy(), jo)
    assert_images_close(te.numpy(), je)
    assert np.abs(te.numpy() - to.numpy()).max() > 1e-2  # the edit moved it


def test_apply_alpha_u8_matches_jax(editors):
    jed, jwalk, ted, twalk = editors
    z, a = _z(2, 2), np.asarray([0.4, 0.6], np.float32)
    je, _, jo = jed.apply_alpha(jwalk, z, a, u8=True)
    te, _, to = ted.apply_alpha(twalk, z, a, u8=True)
    for got, want in [(te, je), (to, jo)]:
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == np.uint8 and got.shape == want.shape
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_apply_alpha_index_branch_matches_jax(editors):
    """index= a regressor-table id: only that bank column moves to its
    target (the reference's per-attribute masking branch)."""
    jed, jwalk, ted, twalk = editors
    z, a = _z(2, 3), np.asarray([0.7, 0.1], np.float32)
    je, ja, _ = jed.apply_alpha(jwalk, z, a, index=39)
    te, ta, _ = ted.apply_alpha(twalk, z, a, index=39)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-4)
    assert_images_close(te.numpy(), je)
    with pytest.raises(ValueError, match="not in the trained bank"):
        ted.apply_alpha(twalk, z, a, index=5)


def test_sweep_matches_jax_and_chunking(editors):
    jed, jwalk, ted, twalk = editors
    z = _z(2, 4)
    panels = np.stack([np.full((2, 1), v, np.float32) for v in (0.0, 0.5, 1.0)])
    ji, ja, jo = jed.sweep(jwalk, z, panels)
    ti, ta, to = ted.sweep(twalk, z, panels)
    assert ti.shape == (3, 2, SIZE, SIZE, 3)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-4)
    assert_images_close(ti.numpy(), ji)
    # a narrower chunk (6 images in chunks of 4: 4 + 2) gives the same stack
    tc, _, _ = ted.sweep(twalk, z, panels, chunk=4)
    np.testing.assert_allclose(tc.numpy(), ti.numpy(), rtol=1e-5, atol=1e-5)
    tu, _, _ = ted.sweep(twalk, z, panels, u8=True)
    assert tu.dtype == torch.uint8 and tu.shape == ti.shape


def test_combine_edits_match_jax(editors):
    """apply_alpha_combine and the 2-attribute grid of sweep_combine (the
    first attribute's target on the outer axis) against the JAX Editor."""
    jed, jwalk, ted, twalk = editors
    z = _z(2, 7)
    ags = [np.asarray([0.2, 0.8], np.float32), np.asarray([[0.9], [0.1]], np.float32)]
    je, ja, _ = jed.apply_alpha_combine(jwalk, z, ags, indices=[31, 39])
    te, ta, _ = ted.apply_alpha_combine(twalk, z, ags, indices=[31, 39])
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-4)
    assert_images_close(te.numpy(), je)
    ji, _, _ = jed.sweep_combine(jwalk, z, [0.0, 1.0], indices=[31, 39])
    ti, _, _ = ted.sweep_combine(twalk, z, [0.0, 1.0], indices=[31, 39])
    assert ti.shape == (2, 2, 2, SIZE, SIZE, 3)
    assert_images_close(ti.numpy(), ji)
    tu, _, _ = ted.sweep_combine(twalk, z, [0.0, 1.0], indices=[31, 39], u8=True)
    assert tu.dtype == torch.uint8 and tu.shape == ti.shape
    from latent2im_tpu.engine.editor import clip_ims as jclip_ims
    from latent2im_tpu_torch.engine.editor import clip_ims

    np.testing.assert_array_equal(clip_ims(ti), jclip_ims(ti.numpy()))


@pytest.mark.parametrize("mode", ["target", "delta"])
def test_unified_alphas_match_jax(mode):
    rng = np.random.RandomState(5)
    org = rng.uniform(-0.5, 1.5, (3, 2)).astype(np.float32)
    sampled = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    jed = JEditor(JEditorConfig(alpha_mode=mode), None, None)
    ted = Editor(EditorConfig(alpha_mode=mode), sg2.Generator(8, 8, 1, channels={4: 4, 8: 4}),
                 rn.ResNet50(num_outputs=2), device="cpu")
    for got, want in zip(ted.unified_alphas(torch.from_numpy(org), torch.from_numpy(sampled)),
                         jed.unified_alphas(jnp.asarray(org), jnp.asarray(sampled))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_u8_conversion_is_to_uint8():
    """The editor's in-graph uint8 conversion ((x+1)*127.5, clip, truncate)
    equals utils.image.to_uint8 (((x+1)/2)*255) on f32 images, as the JAX
    package's _u8_graph does."""
    from latent2im_tpu_torch.engine.editor import _u8
    from latent2im_tpu_torch.utils.image import to_uint8

    x = np.random.RandomState(6).uniform(-1.2, 1.2, (4, 16, 16, 3)).astype(np.float32)
    x[0, 0, 0] = [-1.0, 1.0, 0.0]
    got = _u8(torch.from_numpy(x)).numpy()
    diff = np.abs(got.astype(int) - to_uint8(x).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
