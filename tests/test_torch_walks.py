"""The port's W-space walks ``mlp_w`` (WalkMlpMultiW) and ``nn_w``
(WalkNonLinearW) against the JAX package, on the CPU:

- ``apply_walk`` on shared parameters (JAX ``init_walk`` trees, carried by
  ``io/convert.py:walk_from_jax``), with and without a layer subset, and
  its gradient wrt the walk (rtol 1e-5, atol 1e-6 of scale: f32 matmuls
  summed in another order);
- one ``make_train_step`` step of each against the JAX step on the towers
  of tests/test_train_dynamics.py (host alphas, stored noise): loss terms
  rtol 1e-4, the walk's gradient and update through
  tests/test_torch_train.py:assert_adam_moves_close (Adam's first update
  is about lr * sign(grad), so only a gradient above f32 summation noise
  decides the update's sign);
- the checkpoints: a JAX-written msgpack walk + optax.adam state loads bit
  for bit and the port's file is the same bytes; the reference's pickled
  modules cross both ways;
- the build resolves the kinds from the reference's flags.
"""

import warnings

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from test_stylegan2_torch_oracle import SIZE, STYLE_DIM
from test_torch_train import TERMS, _port_editor, assert_adam_moves_close, jax_grad_capture
from test_train_dynamics import ATTR_IDX, ATTR_LIST, LR, N_MLP, _build_world

from latent2im_tpu.engine import train as jtrain
from latent2im_tpu.engine.editor import Editor as JEditor
from latent2im_tpu.engine.editor import EditorConfig as JEditorConfig
from latent2im_tpu.io import checkpoint as jckpt
from latent2im_tpu.io import torch_convert as jtc
from latent2im_tpu.walks import walks as jwalks
from latent2im_tpu_torch.engine import train as T
from latent2im_tpu_torch.io import checkpoint as ckpt
from latent2im_tpu_torch.io import torch_convert as tc
from latent2im_tpu_torch.io.convert import walk_from_jax
from latent2im_tpu_torch.walks import walks

KINDS = ("mlp_w", "nn_w")
DIM, N_LAYERS = 32, 8


def _jax_walk(kind, dim=DIM, n_layers=N_LAYERS, seed=0):
    tree = jwalks.init_walk(jax.random.PRNGKey(seed), kind, dim, n_layers, list(ATTR_LIST))
    return jax.tree_util.tree_map(np.array, tree)


def _close_to_scale(got, want, rtol=1e-5, atol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("layers", [None, (0, 2, 3)])
@pytest.mark.parametrize("kind", KINDS)
def test_apply_walk_and_its_gradient_match_jax(kind, layers):
    tree = _jax_walk(kind)
    rng = np.random.RandomState(1)
    lat = rng.randn(3, N_LAYERS, DIM).astype(np.float32)
    alpha = rng.uniform(-1, 1, (3, len(ATTR_LIST))).astype(np.float32)
    g = rng.randn(3, N_LAYERS, DIM).astype(np.float32)
    want, vjp = jax.vjp(lambda p: jwalks.apply_walk(kind, p, jnp.asarray(lat),
                                                    jnp.asarray(alpha), layers=layers), tree)
    (want_grad,) = vjp(jnp.asarray(g))
    params = walks.walk_map(lambda t: t.requires_grad_(True), walk_from_jax(tree))
    got = walks.apply_walk(kind, params, torch.from_numpy(lat), torch.from_numpy(alpha),
                           layers=layers)
    _close_to_scale(got.detach().numpy(), want)
    if layers is not None:  # unmasked layers do not move
        keep = [i for i in range(N_LAYERS) if i not in layers]
        np.testing.assert_array_equal(got.detach().numpy()[:, keep], lat[:, keep])
    leaves = walks.walk_leaves(params)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    want_leaves = walks.walk_leaves(walk_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                         want_grad)))
    assert len(grads) == len(want_leaves) == 6
    for a, b in zip(grads, want_leaves):
        _close_to_scale(a.numpy(), b.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_init_has_the_jax_layout_and_distribution(kind):
    tree = _jax_walk(kind, dim=64)
    params = walks.init_walk(kind, 64, N_LAYERS, list(ATTR_LIST),
                             generator=torch.Generator().manual_seed(0))
    got = jax.tree_util.tree_structure(walks.walk_map(lambda t: t.numpy(), params))
    assert got == jax.tree_util.tree_structure(tree)
    for a, b in zip(walks.walk_leaves(params), jax.tree_util.tree_leaves(tree)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    for layer in params["mlp"] + ([params["embed"]] if kind == "nn_w" else []):
        bound = 1.0 / np.sqrt(layer["w"].shape[0])  # U(-1/sqrt(fan_in), ..)
        for t in (layer["w"], layer["b"]):
            assert 0.5 * bound < float(t.abs().max()) <= bound
    assert walks.walk_space(kind) == jwalks.walk_space(kind) == "w"


@pytest.fixture(scope="module")
def world():
    return _build_world()


def _jax_step(world, kind, walk0):
    tg, td, tr, tvgg, _, zs, alphas = world
    cfg = JEditorConfig(latent="w", walk_kind=kind, attr_list=ATTR_LIST, attr_idx=ATTR_IDX,
                        size=SIZE, dim_z=STYLE_DIM, alpha_mode="target", fixed_noise=True)
    editor = JEditor(
        cfg, jtc.convert_stylegan2_generator(tg.state_dict(), SIZE, n_mlp=N_MLP),
        jtc.convert_resnet50(tr.state_dict()),
        vgg_params=jtc.convert_vgg_features(tvgg.state_dict(), "vgg19"),
        d_params=jtc.convert_stylegan2_discriminator(td.state_dict(), SIZE))
    optimizer = jax_grad_capture(jtrain.make_optimizer(LR))
    walk = jax.tree_util.tree_map(jnp.asarray, walk0)
    step = jtrain.make_train_step(editor, None, optimizer, host_alpha=True)
    walk, state, metrics = step(walk, optimizer.init(walk), jnp.asarray(zs[0]),
                                jax.random.PRNGKey(0), sampled=jnp.asarray(alphas[0]))
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, walk), jax.tree_util.tree_map(np.asarray, state[0]))


@pytest.mark.parametrize("kind", KINDS)
def test_one_training_step_matches_the_jax_step(world, kind):
    tg, td, tr, tvgg, _, zs, alphas = world
    n_layers = 2 * int(np.log2(SIZE)) - 2
    walk0 = _jax_walk(kind, dim=STYLE_DIM, n_layers=n_layers, seed=3)
    want, want_walk, want_grad = _jax_step(world, kind, walk0)

    ed = _port_editor(tg, td, tr, tvgg)
    ed.cfg = type(ed.cfg)(**{**ed.cfg.__dict__, "walk_kind": kind})
    walk = walks.walk_map(lambda t: t.requires_grad_(True), walk_from_jax(walk0))
    step = T.make_train_step(ed, None, T.make_optimizer(walk, LR), host_alpha=True)
    m = step(walk, zs[0], sampled=alphas[0])
    for k in TERMS:
        np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-4, err_msg=k)
    got = walks.walk_leaves(walk)
    assert all(t.grad is not None for t in got)
    for a, w0, b, g in zip(got, walks.walk_leaves(walk_from_jax(walk0)),
                           walks.walk_leaves(walk_from_jax(want_walk)),
                           walks.walk_leaves(walk_from_jax(want_grad))):
        moved = a.detach().numpy() - w0.numpy()
        assert np.abs(moved).max() > 0
        assert_adam_moves_close(moved, b.numpy() - w0.numpy(), a.grad.numpy(), g.numpy(),
                                w0.numpy(), LR)


@pytest.mark.parametrize("kind", KINDS)
def test_msgpack_walk_and_adam_state_cross_both_ways_bit_for_bit(tmp_path, kind):
    tree = _jax_walk(kind)
    jwalk = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = jtrain.make_optimizer(1e-3)
    grad = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.random.RandomState(a.size % 97).randn(*a.shape),
                              jnp.float32), jwalk)
    upd, st = opt.update(grad, opt.init(jwalk), jwalk)
    jwalk = optax.apply_updates(jwalk, upd)
    jpath = jckpt.save_walk(str(tmp_path), 2, jwalk, opt_state=st)

    like = walks.walk_map(torch.zeros_like, walk_from_jax(tree))
    like_state = T.make_optimizer(like, 1e-3).state_dict()
    walk, state, meta = ckpt.load_walk(jpath, like, opt_state_like=like_state)
    assert meta == {"epoch": 2, "final": False}
    for a, b in zip(walks.walk_leaves(walk), jax.tree_util.tree_leaves(jwalk)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i, (m, v) in enumerate(zip(jax.tree_util.tree_leaves(st[0].mu),
                                   jax.tree_util.tree_leaves(st[0].nu))):
        np.testing.assert_array_equal(state["state"][i]["exp_avg"].numpy(), np.asarray(m))
        np.testing.assert_array_equal(state["state"][i]["exp_avg_sq"].numpy(), np.asarray(v))

    out = tmp_path / "port"
    out.mkdir()
    ppath = ckpt.save_walk(str(out), 2, walk, opt_state=state)
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()  # the same file, byte for byte
    # the port's Adam resumes from it: one more step moves every tensor
    optimizer = T.make_optimizer(walk, 1e-3)
    optimizer.load_state_dict(state)
    for t in walks.walk_leaves(walk):
        t.requires_grad_(True).grad = torch.ones_like(t)
    before = [t.detach().clone() for t in walks.walk_leaves(walk)]
    optimizer.step()
    assert all(not torch.equal(a, b) for a, b in zip(before, walks.walk_leaves(walk)))
    with pytest.raises(ValueError, match="where a list of"):
        bad = {"mlp": like["mlp"][:2]} if kind == "mlp_w" else {**like, "mlp": like["mlp"] * 2}
        ckpt.load_walk(jpath, bad)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_walk_modules_cross_both_ways(tmp_path, kind):
    cls = {"mlp_w": "WalkMlpMultiW", "nn_w": "WalkNonLinearW"}[kind]
    tree = _jax_walk(kind, seed=5)
    like = walks.walk_map(torch.zeros_like, walk_from_jax(tree))
    jref = str(tmp_path / "jax_ref_walk_module.ckpt")
    jtc.export_walk_torch(jref, kind, tree)
    walk, state, meta = ckpt.load_walk(jref, like)
    assert state is None and meta == {"source": "torch", "cls": cls}
    for a, b in zip(walks.walk_leaves(walk), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)

    pref = str(tmp_path / "port_ref_walk_module.ckpt")
    tc.export_walk_torch(pref, kind, walk)
    got_cls, st = jtc.load_walk_checkpoint(pref)
    assert got_cls == cls
    back = jtc.convert_walk_state(got_cls, st, [])
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert set(st) == set(tc.load_walk_checkpoint(jref)[1])  # the same module layout


@pytest.mark.parametrize("flags,kind", [(["--is_mlp"], "mlp_w"),
                                        (["--walk_type", "NNz"], "nn_w")])
def test_the_build_resolves_the_kinds_from_the_reference_flags(flags, kind):
    from latent2im_tpu_torch.config.options import TrainOptions
    from latent2im_tpu_torch.engine.build import build_editor_from_options

    conf = TrainOptions().parse(["--attrList", "Smiling", "--dev_tiny", "--resolution",
                                 "16", "--models_dir", "unused", "--no_gan_loss",
                                 "--no_content_loss", *flags], print_opt=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ed, walk, _ = build_editor_from_options(conf, device="cpu")
    assert ed.cfg.walk_kind == kind
    z = np.random.RandomState(0).randn(2, ed.cfg.dim_z).astype(np.float32)
    edited, alpha_org, orig = ed.apply_alpha(walk, z, np.full((2, 1), 0.7, np.float32))
    assert edited.shape == orig.shape == (2, 16, 16, 3) and torch.isfinite(edited).all()
    assert not torch.equal(edited, orig)
