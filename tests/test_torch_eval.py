"""The port's evaluation (engine/evaluation.py, models/facenet.py,
cli/eval.py) against the JAX package, on the CPU.

- facenet: the port's InceptionResnetV1 against JAX ``facenet_forward`` at
  160x160, B=2, allclose 1e-5, on a tree the JAX package's facenet_pytorch
  converter read from the port's state_dict and carried back by
  io/convert.py:facenet_from_jax;
- the bucketing, the preservation averages and both embedding
  preprocessings against the JAX functions;
- the eval CLI flow against JAX ``cli/eval.py:run`` on the same checkpoint
  files (G, ResNet-50 and VGG19 as torch .pt files, the walk as msgpack):
  bucket counts equal, preservation numbers within 1e-4 absolute, with no
  sample's |Delta| within 1e-4 of a bucket edge, so a flipped sample cannot
  pass as agreement.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent2im_tpu.cli import eval as jeval
from latent2im_tpu.config.options import VisOptions as JVisOptions
from latent2im_tpu.engine import evaluation as jev
from latent2im_tpu.io import torch_convert as tc
from latent2im_tpu.models import facenet as jfacenet
from latent2im_tpu.models import vgg as jvgg
from latent2im_tpu_torch.cli import eval as peval
from latent2im_tpu_torch.config.options import TrainOptions, VisOptions
from latent2im_tpu_torch.engine import evaluation as ev
from latent2im_tpu_torch.io import checkpoint as ckpt
from latent2im_tpu_torch.io import convert
from latent2im_tpu_torch.models import resnet as rn
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.models import vgg as vggm
from latent2im_tpu_torch.models.facenet import InceptionResnetV1

SIZE, STYLE_DIM = 32, 32
CHANNELS = {4: 16, 8: 16, 16: 8, 32: 8}


def _faces(n, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, 64, 48, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def facenet_pair():
    """A facenet with non-trivial BatchNorm statistics as a JAX pytree (the
    port's seeded init read by the JAX package's facenet_pytorch converter),
    and the port's module loaded from that tree with strict=True."""
    seeded = InceptionResnetV1(generator=torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    bn_stats = {"weight": (1.0, 0.1), "bias": (0.0, 0.1), "running_mean": (0.0, 0.1),
                "running_var": (1.2, 0.1)}  # (centre, spread) of each BN tensor
    sd = {}
    for k, v in seeded.state_dict().items():
        parent, leaf = k.rsplit(".", 1)
        if parent.endswith("bn") and leaf in bn_stats:
            c, spread = bn_stats[leaf]
            v = torch.from_numpy((c + spread * rng.randn(*v.shape)).astype(np.float32))
        sd[k] = v
    tree = tc.convert_facenet(sd)
    net = InceptionResnetV1()
    net.load_state_dict(convert.facenet_from_jax(tree), strict=True)
    return tree, net


def test_facenet_matches_jax_facenet_forward(facenet_pair):
    tree, net = facenet_pair
    x = np.random.RandomState(1).uniform(-1, 1, (2, 160, 160, 3)).astype(np.float32)
    want = jax.jit(jfacenet.facenet_forward)(jax.tree_util.tree_map(jnp.asarray, tree),
                                             jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, rtol=1e-5)


def test_facenet_state_dict_has_the_facenet_pytorch_layout(facenet_pair):
    """The JAX package's facenet_pytorch converter reads the port's
    state_dict, so a facenet_pytorch checkpoint loads into the port with
    strict=True; one with a ``logits`` classifier loads too."""
    tree, net = facenet_pair
    back = tc.convert_facenet(net.state_dict())
    flat = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a, b: float(np.abs(np.asarray(a) - b).max()), back, tree))
    assert max(flat) == 0.0
    sd = dict(net.state_dict())
    sd["logits.weight"], sd["logits.bias"] = torch.zeros(7, 512), torch.zeros(7)
    assert InceptionResnetV1.from_state_dict(sd).logits.out_features == 7
    seeded = InceptionResnetV1(generator=torch.Generator().manual_seed(0))
    assert float(seeded.conv2d_1a.conv.weight.std()) == pytest.approx(0.05, rel=0.2)


def test_bucketing_and_preservation_match_jax():
    rng = np.random.RandomState(3)
    pred = rng.uniform(-0.5, 1.6, (12, 4))
    org = rng.uniform(0, 1, (12, 4))
    pred[0, 1] = np.nan  # dropped by both
    imgs, origs = _faces(12, 4), _faces(12, 5)
    acc, jacc = ev.EvalAccumulator(), jev.EvalAccumulator()
    acc.add_batch(pred, org, imgs, origs, target_idx=1)
    jacc.add_batch(pred, org, imgs, origs, target_idx=1)
    assert acc.counts() == jacc.counts() and sum(acc.counts()) >= 6
    np.testing.assert_allclose(ev.attribute_preservation(acc, 1),
                               jev.attribute_preservation(jacc, 1), rtol=1e-12)

    def embed(x):
        return np.mean(np.asarray(x, np.float32), axis=(1, 2))

    np.testing.assert_allclose(ev.identity_preservation(acc, embed, batch=3),
                               jev.identity_preservation(jacc, embed, batch=3),
                               rtol=1e-6)
    empty = ev.EvalAccumulator()
    assert all(np.isnan(v) for v in ev.attribute_preservation(empty, 0))


@pytest.mark.parametrize("ref_parity", [False, True])
def test_resize_for_embedding_matches_jax(ref_parity):
    imgs = _faces(3, 6)
    got = ev.resize_for_embedding(imgs, 160, ref_parity=ref_parity)
    want = np.asarray(jev.resize_for_embedding(imgs, 160, ref_parity=ref_parity))
    assert got.shape == (3, 160, 160, 3) and got.dtype == torch.float32
    if ref_parity:  # Pillow's uint8 values, bit for bit
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        # whitened values in [-1, 1] from a 0-255 input: 1e-5 is 5e-6 of
        # the input's scale (measured 3.6e-6, f32 weights of the upscale)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_vgg_embedding_matches_jax():
    vgg = vggm.VGG19Features(generator=torch.Generator().manual_seed(2))
    jtree = tc.convert_vgg_features(vgg.state_dict(), "vgg19")
    imgs = _faces(2, 7)
    got = ev.make_vgg_embed_fn(vgg)(imgs)
    want = jev.make_vgg_embed_fn(jtree)(imgs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert jvgg.CFGS["vgg19"] == list(vggm.CFG19)


def _write_run(root):
    """Checkpoint files both packages read and an opt.yml naming them ->
    (opt.yml path, walk checkpoint path)."""
    gen = torch.Generator().manual_seed(11)
    g = sg2.Generator(SIZE, STYLE_DIM, 2, channels=CHANNELS, generator=gen)
    reg = rn.ResNet50(num_outputs=40, generator=gen)
    with torch.no_grad():  # regressor scores of a useful spread
        reg.fc.weight.mul_(0.3)
    vgg = vggm.VGG19Features(generator=gen)
    paths = {name: os.path.join(root, f"{name}.pt") for name in ("g", "reg", "vgg")}
    torch.save({"g_ema": g.state_dict()}, paths["g"])
    torch.save(reg.state_dict(), paths["reg"])
    torch.save(vgg.state_dict(), paths["vgg"])
    opt = TrainOptions().parse(
        ["--model", "stylegan_v2_real", "--transform", "face", "--walk_type", "linear",
         "--latent", "w", "--attrList", "Smiling,Young", "--resolution", str(SIZE),
         "--no_gan_loss", "--models_dir", root, "--overwrite_config",
         "--g_path", paths["g"], "--reg_path", paths["reg"], "--vgg_path", paths["vgg"]])
    rng = np.random.RandomState(12)
    walk = {"w": torch.from_numpy((4.0 * rng.randn(2, sg2.n_latent(SIZE), STYLE_DIM))
                                  .astype(np.float32))}
    path = ckpt.save_walk(opt.output_dir, 1, walk, final=True)
    return os.path.join(opt.output_dir, "opt.yml"), path


def test_eval_cli_matches_the_jax_eval(tmp_path, monkeypatch):
    yml, walk_path = _write_run(str(tmp_path))
    args = [yml, "--save_path_w", walk_path, "--num_samples", "4", "--noise_seed", "3"]
    deltas = []
    real_add = ev.EvalAccumulator.add_batch

    def recording_add(self, pred, org, edited, orig, target_idx):
        deltas.extend(np.abs(pred[:, target_idx] - org[:, target_idx]))
        return real_add(self, pred, org, edited, orig, target_idx)

    monkeypatch.setattr(ev.EvalAccumulator, "add_batch", recording_add)
    vo = VisOptions()
    vo.parser.add_argument("--ref_parity", action="store_true")
    opt, conf = vo.parse(args + ["--output_dir", str(tmp_path / "port")])
    got = peval.run(opt, conf, device="cpu")
    with open(tmp_path / "port" / "eval_report.json") as f:
        report = json.load(f)
    assert report["embedding"] == "vgg-fallback"
    assert report["embedding_preprocess"] == "whitened"
    assert report["identity_is_relative_only"] is False  # --vgg_path given

    jvo = JVisOptions()
    jopt, jconf = jvo.parse(args + ["--output_dir", str(tmp_path / "jax")])
    jopt = argparse.Namespace(**{**vars(jopt), "facenet_path": "", "ref_parity": False})
    want = jeval.run(jopt, jconf)

    edges = np.asarray(jev.EPS_BUCKETS)
    gap = min(float(np.abs(d - edges).min()) for d in deltas)
    assert len(deltas) == 2 * 4 * 10 and gap > 1e-4, gap
    assert set(got) == set(want) == {"Smiling", "Young"}
    for attr in got:
        assert got[attr]["bucket_counts"] == want[attr]["bucket_counts"]
        for key in ("identity_preservation", "attribute_preservation"):
            np.testing.assert_allclose(got[attr][key], want[attr][key], rtol=0, atol=1e-4,
                                       err_msg=f"{attr} {key}")
    assert all(n > 0 for n in got["Smiling"]["bucket_counts"])  # every bucket


def test_eval_cli_with_facenet_and_ref_parity(tmp_path, facenet_pair):
    yml, walk_path = _write_run(str(tmp_path))
    torch.save(facenet_pair[1].state_dict(), tmp_path / "facenet.pt")
    vo = VisOptions()
    vo.parser.add_argument("--facenet_path", type=str, default="")
    vo.parser.add_argument("--ref_parity", action="store_true")
    opt, conf = vo.parse([yml, "--save_path_w", walk_path, "--num_samples", "1",
                          "--facenet_path", str(tmp_path / "facenet.pt"), "--ref_parity",
                          "--output_dir", str(tmp_path / "out")])
    results = peval.run(opt, conf, device="cpu")
    with open(tmp_path / "out" / "eval_report.json") as f:
        report = json.load(f)
    assert report["embedding"] == "facenet-vggface2"
    assert report["embedding_preprocess"] == "reference"
    assert report["identity_is_relative_only"] is False
    assert report["results"]["Smiling"]["bucket_counts"] == results["Smiling"]["bucket_counts"]
    counts = results["Smiling"]["bucket_counts"]
    assert sum(counts) > 0
    for n, v in zip(counts, results["Smiling"]["identity_preservation"]):
        assert np.isfinite(v) == (n > 0)


def test_eval_cli_refuses_multi_device_and_needs_a_device(monkeypatch):
    opt = argparse.Namespace(n_devices=2, sp_devices=None)
    with pytest.raises(NotImplementedError, match="item 15"):
        peval.run(opt, None, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peval.run(argparse.Namespace(), None)
