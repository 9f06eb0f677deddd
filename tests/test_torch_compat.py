"""The port's reference-style facade (latent2im_tpu_torch/compat.py, graphs.py)
against the JAX package's (latent2im_tpu/compat.py, graphs.py) on the CPU, at
``--dev_tiny`` 16 px without D and VGG: both factories build their editors,
and the JAX editor's towers and walk are carried into the port's by
io/convert.py. Then:

- the alpha stream (``get_train_alpha``, both samplings, from the graphs'
  own RandomState(0)) is equal, and so are ``get_alphas``,
  ``scale_test_alpha_for_graph``, ``vis_image_batch_alphas`` and
  ``batch_input``;
- get_w / get_logits / get_reg_preds / get_w_new_tensor / apply_alpha agree
  (images at tests/helpers.py:assert_images_close's CPU gates, scores at
  1e-4: a ResNet-50 in another summation order);
- ``save_multi_models`` writes the JAX package's file byte for byte, each
  package's ``load_multi_models`` reads the other's, and a fine-tuned GAN
  checkpoint (``save_path_gan``) swaps G in both the same way.
"""

import jax
import numpy as np
import pytest
import torch
from helpers import assert_close, assert_images_close
from test_torch_cli import one_torch_thread  # noqa: F401

from latent2im_tpu import compat as jcompat
from latent2im_tpu import graphs as jgraphs
from latent2im_tpu.io import checkpoint as jckpt
from latent2im_tpu.models import resnet as jrn
from latent2im_tpu_torch import compat, graphs
from latent2im_tpu_torch.io.convert import (generator_from_jax, resnet50_from_jax,
                                            walk_from_jax)

KW = dict(dev_tiny=True, resolution=16, no_gan_loss=True, no_content_loss=True,
          attrList="Smiling,Young")


@pytest.fixture(scope="module")
def pair():
    """(JAX graph, port graph) over the same towers and walk."""
    init = jax.jit(jrn.init_resnet50, static_argnames="num_outputs")
    saved = jrn.init_resnet50
    jrn.init_resnet50 = init  # eager, the 53 conv inits take seconds
    try:
        jg = jgraphs.find_model_using_name("stylegan_v2_real", "face")(**KW)
    finally:
        jrn.init_resnet50 = saved
    tg = graphs.find_model_using_name("stylegan_v2_real", "face")(device="cpu", **KW)
    tg.editor.g.load_state_dict(generator_from_jax(jax.device_get(jg.editor.g_params)),
                                strict=True)
    tg.editor.reg.load_state_dict(resnet50_from_jax(jax.device_get(jg.editor.reg_params)),
                                  strict=True)
    tg.walk = walk_from_jax(jax.device_get(jg.walk))
    return jg, tg


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_the_graphs_module_is_the_compat_surface():
    assert graphs.find_model_using_name is compat.find_model_using_name
    assert graphs.CompatGraph is compat.CompatGraph and graphs.batch_input is compat.batch_input
    assert sorted(graphs.__all__) == sorted(jgraphs.__all__)


def test_the_alpha_stream_and_the_alpha_helpers_match(pair):
    jg, tg = pair
    assert (tg.attrList, tg.attrIdx, tg.Nsliders, tg.dim_z, tg.img_size) == (
        jg.attrList, jg.attrIdx, jg.Nsliders, jg.dim_z, jg.img_size)
    zs = np.zeros((3, tg.dim_z), np.float32)
    for embed in (False, True, False):
        got, want = tg.get_train_alpha(zs, trainEmbed=embed), jg.get_train_alpha(zs, trainEmbed=embed)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w))
    rng = np.random.RandomState(5)
    org, sampled = rng.uniform(0, 1, (2, 3, 2)).astype(np.float32)
    for g, w in zip(tg.get_alphas(org, sampled), jg.get_alphas(org, sampled)):
        assert np.array_equal(_np(g), np.asarray(w))
    assert np.array_equal(tg.scale_test_alpha_for_graph(0.3, zs),
                          jg.scale_test_alpha_for_graph(0.3, zs))
    for g, w in zip(tg.vis_image_batch_alphas(4, 0.2, 0.8), jg.vis_image_batch_alphas(4, 0.2, 0.8)):
        assert np.array_equal(g, w)
    inputs = {"z": rng.randn(5, 3), "name": "Smiling"}
    got, want = compat.batch_input(inputs, slice(1, 3)), jcompat.batch_input(inputs, slice(1, 3))
    assert got.keys() == want.keys() and np.array_equal(got["z"], want["z"])
    assert got["name"] == want["name"]


def test_the_editing_surface_matches(pair):
    jg, tg = pair
    z = np.random.RandomState(7).randn(2, tg.dim_z).astype(np.float32)
    w = tg.get_w(z)
    assert_close(_np(w), jg.get_w(z), rtol=1e-5, atol=1e-5)
    img = tg.get_logits({"w": w})
    assert_images_close(_np(img), jg.get_logits({"w": _np(w)}))
    assert_close(_np(tg.get_reg_preds(img)), jg.get_reg_preds(_np(img)), rtol=1e-4, atol=1e-4)
    alpha = np.array([[0.2, 0.7], [0.9, 0.1]], np.float32)
    assert_close(_np(tg.get_w_new_tensor(w, alpha)), jg.get_w_new_tensor(_np(w), alpha))
    for index in (None, tg.attrIdx[1]):
        got = tg.apply_alpha({"z": z}, alpha, index_=index)
        want = jg.apply_alpha({"z": z}, alpha, index_=index)
        for g, wnt in zip(got, want):
            assert_images_close(_np(g), np.asarray(wnt), rtol=1e-4, atol=1e-4)
    assert np.array_equal(tg.clip_ims(img), jg.clip_ims(_np(img)))


def test_save_and_load_multi_models_cross_both_ways(pair, tmp_path):
    jg, tg = pair
    tg.save_multi_models(str(tmp_path / "port"))
    jg.save_multi_models(str(tmp_path / "jax"))
    port, jaxf = (tmp_path / f"{n}_walk_module.ckpt" for n in ("port", "jax"))
    assert port.read_bytes() == jaxf.read_bytes()
    walk = {k: v.clone() for k, v in tg.walk.items()}
    with torch.no_grad():
        tg.walk["w"].mul_(0.5)
    tg.save_multi_models(str(tmp_path / "half"))
    tg.load_multi_models(str(jaxf))
    assert torch.equal(tg.walk["w"], walk["w"])
    saved = jg.walk
    try:
        jg.load_multi_models(str(tmp_path / "half_walk_module.ckpt"))
        assert np.array_equal(np.asarray(jg.walk["w"]), 0.5 * walk["w"].numpy())
    finally:
        jg.walk = saved


def test_a_fine_tuned_gan_swaps_g_in_both(pair, tmp_path):
    jg, tg = pair
    g_ft = jax.tree_util.tree_map(lambda a: np.asarray(a) * np.float32(1.01),
                                  jax.device_get(jg.editor.g_params))
    path = str(tmp_path / "model_gan_1_final.ckpt")
    jckpt.save_pytree(path, {"g": g_ft, "g_running": g_ft})
    jax_walk = str(tmp_path / "w")
    jg.save_multi_models(jax_walk)
    saved_jg, saved_tg = jg.editor.g_params, {k: v.clone() for k, v in
                                              tg.editor.g.state_dict().items()}
    try:
        tg.load_multi_models(jax_walk + "_walk_module.ckpt", save_path_gan=path)
        jg.load_multi_models(jax_walk + "_walk_module.ckpt", save_path_gan=path)
        want = generator_from_jax(g_ft)
        for k, v in tg.editor.g.state_dict().items():
            assert torch.equal(v, want[k]), k
        z = np.random.RandomState(8).randn(1, tg.dim_z).astype(np.float32)
        w = tg.get_w(z)
        assert_images_close(_np(tg.get_logits({"w": w})), jg.get_logits({"w": _np(w)}))
    finally:
        jg.editor.g_params = saved_jg
        tg.editor.g.load_state_dict(saved_tg)
