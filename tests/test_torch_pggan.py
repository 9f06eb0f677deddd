"""The port's PGGAN backends against the JAX package, on the CPU:

- model_256's G and D (models/pggan.py) at step 2 with the full ladders,
  seeded here and read by the JAX package's own converters of the
  reference's checkpoints (``io/convert.py`` maps the trees back to the
  same state_dicts): images and D's score and label logits at the
  reference's default alpha=0 (the previous resolution's rgb head in G, the
  skip path in D) and with the blend off (alpha=1); ``assert_close``'s
  CPU f32 gates, rtol 1e-5 with atol 1e-5 of scale (f32 convs summed in
  another order);
- the GAN-zoo GNet (through the JAX converter, as above) and DNet (a tree
  of the JAX ``init_discriminator``'s layout) at depths (16, 16, 8), at
  alpha 0 (fully grown) and 0.35 (fade-in), D at batch 8 (two contiguous
  minibatch-std groups of 4) and 6 (4 does not divide it: one group); the
  same gates;
- the pggan ``build_editor_from_options`` of both packages at --resolution
  16 (G at 16 px, edited images 8 px, D on the x2 re-upsample at step 2)
  on the same towers: ``apply_alpha`` (images rtol/atol 2e-3,
  ``assert_images_close``'s CPU gate), one ``make_train_step`` step and
  one --trainEmbed step against the JAX step (host alphas): loss terms rtol
  1e-4, the walk's gradient and update through
  tests/test_torch_train.py:assert_adam_moves_close;
- the zoo loaded through --g_path (``formatLayer`` selects it), and the two
  builds the JAX package cannot run, refused with its error types: a
  labelled model_256 checkpoint (502 + 10 != 512) and a zoo G twice the
  editor's resolution, whose re-upsampled image does not fit D's step.
"""

import os
import warnings
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import assert_close, assert_images_close
from test_torch_train import assert_adam_moves_close, jax_grad_capture

from latent2im_tpu.config.options import TrainOptions as JTrainOptions
from latent2im_tpu.engine import build as jbuild
from latent2im_tpu.engine import train as jtrain
from latent2im_tpu.io import torch_convert as jtc
from latent2im_tpu.models import pgan_zoo as jzoo
from latent2im_tpu.models import pggan as jpgg
from latent2im_tpu.models import resnet as jrn
from latent2im_tpu.tasks import transforms as jtasks
from latent2im_tpu_torch.config.options import TrainOptions
from latent2im_tpu_torch.engine import build
from latent2im_tpu_torch.engine import train as T
from latent2im_tpu_torch.io import convert
from latent2im_tpu_torch.models import pgan_zoo, pggan
from latent2im_tpu_torch.tasks import transforms as tasks
from latent2im_tpu_torch.walks import walks

TERMS = ("loss", "reg_loss", "content_loss", "gan_loss")
ZOO_DEPTHS = (16, 16, 8)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _close(got, want, rtol=1e-5, atol=1e-5):
    want = np.asarray(want)
    assert_close(got, want, rtol=rtol, atol=atol * max(float(np.abs(want).max()), 1.0))


def _jax_g(sd):
    """The JAX package's converter of a model_256 G state_dict (it reads the
    label embedding unconditionally; an unlabelled G gets a stand-in that
    is dropped again)."""
    if "label_embed.weight" in sd:
        return _np_tree(jtc.convert_pggan_generator(sd))
    tree = jtc.convert_pggan_generator({**sd, "label_embed.weight": torch.zeros(10, 10)})
    del tree["label_embed"]
    return _np_tree(tree)


def _same_state(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


@pytest.fixture(scope="module")
def model256():
    """Seeded full-ladder G and D of the port, in the JAX package's trees
    through its own converters (the reference's names), and back."""
    gen = torch.Generator().manual_seed(0)
    g, d = pggan.Generator(n_label=0, generator=gen), pggan.Discriminator(generator=gen)
    jg, jd = _jax_g(g.state_dict()), _np_tree(jtc.convert_pggan_discriminator(d.state_dict()))
    _same_state(convert.pggan_generator_from_jax(jg), g.state_dict())
    _same_state(convert.pggan_discriminator_from_jax(jd), d.state_dict())
    return jg, jd, g.eval(), d.eval()


@pytest.mark.parametrize("alpha", [None, 1.0])
def test_model256_generator_matches_jax(model256, alpha):
    jg, _, g, _ = model256
    z = np.random.RandomState(0).randn(2, 512).astype(np.float32)
    kw = {} if alpha is None else {"alpha": alpha}
    want = jax.jit(lambda p, z: jpgg.generator_forward(p, z, step=2, **kw))(jg, z)
    with torch.no_grad():
        got = g(torch.from_numpy(z), step=2, **kw)
    assert got.shape == (2, 16, 16, 3)
    _close(got.numpy(), want)


@pytest.mark.parametrize("alpha", [None, 1.0])
def test_model256_discriminator_matches_jax(model256, alpha):
    _, jd, _, d = model256
    img = np.random.RandomState(1).randn(3, 16, 16, 3).astype(np.float32)
    kw = {} if alpha is None else {"alpha": alpha}
    ws, wl = jax.jit(lambda p, x: jpgg.discriminator_forward(p, x, step=2, **kw))(jd, img)
    with torch.no_grad():
        gs, gl = d(torch.from_numpy(img), step=2, **kw)
    assert gs.shape == (3,) and gl.shape == (3, 10)
    _close(gs.numpy(), ws)
    _close(gl.numpy(), wl)


def test_model256_labelled_generator_and_names_match_the_reference_layout():
    g = pggan.Generator(generator=torch.Generator().manual_seed(2))  # n_label=10
    sd = g.state_dict()
    assert {"label_embed.weight", "progression.0.conv.0.conv.weight_orig",
            "progression.8.conv.3.conv.bias", "to_rgb.8.weight"} <= set(sd)
    g = pggan.Generator.from_state_dict({f"module.{k}": v for k, v in sd.items()})
    jg = _jax_g(sd)
    z = np.random.RandomState(3).randn(2, pggan.CODE_DIM).astype(np.float32)
    with torch.no_grad():
        got = g(torch.from_numpy(z), step=1, label=torch.tensor([0, 3]))
    _close(got.numpy(), jpgg.generator_forward(jg, jnp.asarray(z), step=1,
                                               label=jnp.asarray([0, 3])))


@pytest.mark.parametrize("alpha", [0.0, 0.35])
def test_zoo_generator_matches_jax(alpha):
    g = pgan_zoo.GNet(32, ZOO_DEPTHS, generator=torch.Generator().manual_seed(4))
    assert g.resolution == 16
    jg = _np_tree(jtc.convert_ganzoo_pgan({f"module.{k}": v for k, v in g.state_dict().items()}))
    _same_state(convert.zoo_generator_from_jax(jg), g.state_dict())
    z = np.random.RandomState(5).randn(2, 32).astype(np.float32)
    with torch.no_grad():
        got = g(torch.from_numpy(z), alpha=alpha)
    want = jax.jit(lambda p, z: jzoo.generator_forward(p, z, alpha=alpha))(jg, z)
    _close(got.numpy(), want)


def _zoo_d_tree(depths, seed=6):
    """A JAX zoo DNet tree (models/pgan_zoo.py:init_discriminator's layout),
    drawn with numpy (the eager JAX init compiles every op anew)."""
    rng = np.random.RandomState(seed)

    def conv(k, cin, cout):
        return {"w": rng.randn(k, k, cin, cout).astype(np.float32),
                "b": (0.1 * rng.randn(cout)).astype(np.float32)}

    d0, scales, prev = depths[0], [], depths[0]
    for d in depths[1:]:
        scales.append([conv(3, d, d), conv(3, d, prev)])
        prev = d
    lin = conv(1, d0 * 16, d0)
    dec = conv(1, d0, 1)
    return {"from_rgb": [conv(1, 3, d) for d in depths], "scales": scales,
            "group0_conv": conv(3, d0 + 1, d0),
            "group0_lin": {"w": lin["w"][0, 0], "b": lin["b"]},
            "decision": {"w": dec["w"][0, 0], "b": dec["b"]}}


def test_zoo_discriminator_matches_jax():
    """Batch 8: two contiguous minibatch-std groups of 4; batch 6: 4 does
    not divide it, one group."""
    jd = _zoo_d_tree(ZOO_DEPTHS)
    d = pgan_zoo.DNet(ZOO_DEPTHS)
    d.load_state_dict(convert.zoo_discriminator_from_jax(jd), strict=True)
    forward = jax.jit(jzoo.discriminator_forward)
    for batch in (8, 6):
        img = np.random.RandomState(7).randn(batch, 16, 16, 3).astype(np.float32)
        with torch.no_grad():
            got = d(torch.from_numpy(img))
        assert got.shape == (batch, 1)
        _close(got.numpy(), forward(jd, img))


# ---------------------------------------------------------------------------
# the pggan editor
# ---------------------------------------------------------------------------


def _args(*flags):
    return ["--model", "pggan", "--transform", "scene", "--walk_type", "linear",
            "--resolution", "16", "--attrList", "daylight", "--models_dir", "unused",
            "--no_content_loss", *flags]


def _builds(*flags):
    """The port's and the JAX package's build of the same options, on the
    same towers: the JAX build's random inits of G, D and the regressor
    return the port's seeded ones through the JAX package's converters
    (eager JAX inits of the full ladders take ~30 s here); the JAX walk is
    carried into the port."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ted, _, tinfo = build.build_editor_from_options(
            TrainOptions().parse(_args(*flags), print_opt=False), device="cpu")
        d_sd = ted.d.state_dict() if ted.d is not None else None
        with mock.patch.object(jpgg, "init_generator", lambda *a, **k: _jax_g(
                                   ted.g.state_dict())), \
                mock.patch.object(jpgg, "init_discriminator", lambda *a, **k: _np_tree(
                    jtc.convert_pggan_discriminator(d_sd))), \
                mock.patch.object(jrn, "init_resnet50", lambda *a, **k: _np_tree(
                    jtc.convert_resnet50(ted.reg.state_dict()))):
            jed, jwalk, jinfo = jbuild.build_editor_from_options(
                JTrainOptions().parse(_args(*flags), print_opt=False))
    assert jinfo["attr_idx"] == tinfo["attr_idx"] and jed.cfg.walk_kind == ted.cfg.walk_kind
    if "format" in jed.g_params:  # a --g_path zoo: the same file on both sides
        _same_state(convert.zoo_generator_from_jax(_np_tree(jed.g_params)),
                    ted.g.state_dict())
    return jed, _np_tree(jwalk), ted, walks.walk_map(
        lambda t: t.requires_grad_(True), convert.walk_from_jax(_np_tree(jwalk)))


@pytest.fixture(scope="module")
def pggan_editors():
    return _builds()


def test_pggan_build_matches_the_jax_build(pggan_editors):
    jed, _, ted, _ = pggan_editors
    assert ted.cfg.latent == jed.cfg.latent == "z" and ted.cfg.alpha_mode == "delta"
    assert ted.cfg.walk_kind == "linear_z_free" and ted.cfg.dim_z == 512
    assert isinstance(ted.g, pggan.Generator) and not hasattr(ted.g, "label_embed")
    assert isinstance(ted.d, pggan.Discriminator) and ted.vgg is None
    z = np.random.RandomState(8).randn(2, 512).astype(np.float32)
    img = ted.synthesize(z)
    assert img.shape == (2, 8, 8, 3)  # G's 16 px halved
    assert_images_close(img.numpy(), np.asarray(jed.synthesize(jnp.asarray(z))))
    _close(ted.discriminate(img).numpy(), jed.discriminate(jnp.asarray(img.numpy())))


def test_pggan_apply_alpha_matches_jax(pggan_editors):
    jed, jwalk, ted, twalk = pggan_editors
    z = np.random.RandomState(9).randn(2, 512).astype(np.float32)
    jwalk = jax.tree_util.tree_map(lambda a: jnp.asarray(a) + 0.5, jwalk)  # a visible edit
    twalk = walks.walk_map(lambda t: t.detach() + 0.5, twalk)
    a = np.asarray([0.2, 0.8], np.float32)
    je, ja, jo = jed.apply_alpha(jwalk, jnp.asarray(z), a)
    te, ta, to = ted.apply_alpha(twalk, z, a)
    assert te.shape == (2, 8, 8, 3) and not torch.equal(te, to)
    assert_images_close(te.numpy(), np.asarray(je))
    assert_images_close(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)


def _step_pair(jed, jwalk0, ted, twalk, flags_embed=False):
    task, jtask = tasks.get_task("scene"), jtasks.get_task("scene")
    z = np.random.RandomState(10).randn(2, 512).astype(np.float32)
    if flags_embed:
        sampled, _, index = task.train_alpha_embed_np(np.random.RandomState(11), 2)
    else:
        sampled, _ = task.train_alpha_np(np.random.RandomState(11), 2, 1)
        index = None
    optimizer = jax_grad_capture(jtrain.make_optimizer(1e-3))
    jwalk = jax.tree_util.tree_map(jnp.asarray, jwalk0)
    jstep = jtrain.make_train_step(jed, jtask, optimizer, host_alpha=True,
                                   train_embed=flags_embed)
    jwalk, jstate, jm = jstep(jwalk, optimizer.init(jwalk), jnp.asarray(z), jax.random.PRNGKey(0),
                         sampled=jnp.asarray(sampled), index=index)
    step = T.make_train_step(ted, task, T.make_optimizer(twalk, 1e-3), host_alpha=True,
                             train_embed=flags_embed)
    m = step(twalk, z, sampled=sampled, index=index)
    for k in TERMS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    moved_any = False
    for a, w0, b, g in zip(walks.walk_leaves(twalk), jax.tree_util.tree_leaves(jwalk0),
                           jax.tree_util.tree_leaves(jwalk),
                           jax.tree_util.tree_leaves(jstate[0])):
        moved = a.detach().numpy() - w0
        moved_any |= bool(np.abs(moved).max() > 0)
        assert_adam_moves_close(moved, np.asarray(b) - w0, a.grad.numpy(), np.asarray(g),
                                w0, 1e-3)
    assert moved_any
    return index, twalk, jwalk0


def test_pggan_training_step_matches_the_jax_step(pggan_editors):
    jed, jwalk0, ted, twalk = pggan_editors
    assert ted.cfg.model == "pggan"  # the BCE's 10x gated off by --no_content_loss
    _step_pair(jed, jwalk0, ted, twalk)


def test_train_embed_step_matches_the_jax_step():
    jed, jwalk0, ted, twalk = _builds("--trainEmbed", "--no_gan_loss")
    assert ted.cfg.walk_kind == "embed" and ted.d is None
    index, twalk, _ = _step_pair(jed, jwalk0, ted, twalk, flags_embed=True)
    bank0 = jwalk0["w"]["daylight"]
    moved = np.abs(twalk["w"]["daylight"].detach().numpy() - bank0).reshape(6, -1).max(1)
    assert moved[index] > 0 and np.all(np.delete(moved, index) == 0)  # only that entry


def test_the_zoo_loads_through_g_path_and_matches_jax(tmp_path):
    g = pgan_zoo.GNet(512, ZOO_DEPTHS, generator=torch.Generator().manual_seed(12))
    path = str(tmp_path / "zoo.pt")
    torch.save({"netG": {f"module.{k}": v for k, v in g.state_dict().items()}}, path)
    jed, jwalk, ted, twalk = _builds("--g_path", path, "--no_gan_loss", "--walk_type", "NNz")
    assert isinstance(ted.g, pgan_zoo.GNet) and ted.cfg.walk_kind == "mlp_z3"
    z = np.random.RandomState(13).randn(2, 512).astype(np.float32)
    a = np.asarray([0.5, 0.9], np.float32)
    je, _, _ = jed.apply_alpha(jax.tree_util.tree_map(jnp.asarray, jwalk), jnp.asarray(z), a)
    te, _, _ = ted.apply_alpha(twalk, z, a)
    assert te.shape == (2, 8, 8, 3)
    assert_images_close(te.numpy(), np.asarray(je))


def test_builds_the_jax_package_cannot_run_raise_its_error(tmp_path):
    """A labelled model_256 checkpoint meets the build's 512-d z (502 + 10
    channels are needed); a zoo G of twice the editor's resolution gives D
    an image its step does not fit. The JAX package raises ValueError (a
    conv's shapes) and TypeError (a matmul's); so does the port."""
    g = pggan.Generator(generator=torch.Generator().manual_seed(14))  # n_label=10
    path = str(tmp_path / "labelled.pt")
    torch.save({"g_running": g.state_dict()}, path)
    jed, jwalk, ted, twalk = _builds("--g_path", path, "--no_gan_loss")
    z = np.zeros((1, 512), np.float32)
    with pytest.raises(ValueError, match="522"):
        jed.apply_alpha(jax.tree_util.tree_map(jnp.asarray, jwalk), jnp.asarray(z), [0.5])
    with pytest.raises(ValueError, match="stem"):
        ted.apply_alpha(twalk, z, [0.5])

    g = pgan_zoo.GNet(512, (16, 16, 16, 8), generator=torch.Generator().manual_seed(15))
    path = str(tmp_path / "zoo32.pt")
    torch.save(g.state_dict(), path)
    jed, _, ted, _ = _builds("--g_path", path)
    img = ted.synthesize(z)
    assert img.shape == (1, 16, 16, 3)  # the zoo's 32 px halved, for a 16 px editor
    with pytest.raises(TypeError):
        jed.discriminate(jnp.asarray(img.numpy()))
    with pytest.raises(TypeError, match="does not fit"):
        ted.discriminate(img)


def test_the_clis_run_the_pggan(tmp_path, monkeypatch):
    """train --model pggan (--trainEmbed: no sample grids, as the JAX CLI),
    its final walk loaded by the JAX package bit for bit; then a linear run
    served by serve --save_path_w (one /edit of 8 px images)."""
    import logging
    import sys

    from latent2im_tpu.io import checkpoint as jckpt
    from latent2im_tpu_torch.cli import serve
    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.config.options import VisOptions

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # unimportable
    root = logging.getLogger()
    saved = (list(root.handlers), root.level, sys.excepthook)
    args = ["--model", "pggan", "--transform", "scene", "--attrList", "daylight",
            "--resolution", "16", "--num_samples", "2", "--batch_size", "2",
            "--n_epochs", "1", "--model_save_freq", "1", "--no_content_loss",
            "--no_gan_loss", "--overwrite_config"]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runs = {}
            for name, extra in (("embed", ["--trainEmbed"]), ("linear", [])):
                opt = TrainOptions().parse(args + ["--models_dir", str(tmp_path / name),
                                                   *extra])
                walk, hist = tcli.run(opt, device="cpu")
                assert len(hist) == 1 and np.isfinite(hist).all()
                runs[name] = (opt.output_dir, walk)
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in saved[0]:
            root.addHandler(h)
        root.setLevel(saved[1])
        sys.excepthook = saved[2]
    out_dir, walk = runs["embed"]
    assert os.listdir(os.path.join(out_dir, "results")) == []
    final = os.path.join(out_dir, "model_w_1_final_walk_module.ckpt")
    like = jax.tree_util.tree_map(np.zeros_like, walks.walk_map(lambda t: t.detach().numpy(),
                                                                walk))
    jwalk, _, _ = jckpt.load_walk(final, like)
    np.testing.assert_array_equal(np.asarray(jwalk["w"]["daylight"]),
                                  walk["w"]["daylight"].detach().numpy())

    out_dir, walk = runs["linear"]
    assert os.listdir(os.path.join(out_dir, "results"))  # the sample grids
    vo = VisOptions()
    vo.parser.add_argument("--serve_batch", type=int, default=2)
    opt, conf = vo.parse([os.path.join(out_dir, "opt.yml"), "--save_path_w",
                          os.path.join(out_dir, "model_w_1_final_walk_module.ckpt")])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        service = serve.build_service(opt, conf, device="cpu")
    assert torch.equal(service.walk["w"], walk["w"].detach())
    out = service.edit({"seed": 3, "alpha": 0.4})
    assert len(out["images"]) == 1 and np.isfinite(out["alpha_org"]).all()
