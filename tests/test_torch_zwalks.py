"""The port's seven z-space walks and z-space editing against the JAX
package, on the CPU:

- each z kind (``mlp_z``, ``linear_z_free``, ``linear_z``,
  ``linear_z_dir``, ``mlp_z_norm``, ``mlp_z3``, ``embed``): ``apply_walk`` on
  the JAX ``init_walk`` tree carried across by ``io/convert.py:
  walk_from_jax``, and its gradient wrt the walk (rtol 1e-5, atol 1e-6 of
  scale: f32 matmuls and norms summed in another order); the port's own
  init has the JAX tree's structure, shapes and distribution;
- ``train_alpha_embed_np`` draws exactly what the JAX package's does;
- StyleGAN2 in z (``--latent z --is_mlp``, the ``mlp_z`` walk) on the
  towers of tests/test_train_dynamics.py: ``apply_alpha`` and ``sweep``
  (images rtol/atol 2e-3, ``assert_images_close``'s CPU gate) and one
  ``make_train_step`` step against the JAX step (host alphas, stored
  noise): loss terms rtol 1e-4, the walk's gradient and update through
  tests/test_torch_train.py:assert_adam_moves_close;
- the alpha-driven paths refuse the ``embed`` walk, and the combine paths a
  z editor, with the JAX package's error type.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import assert_images_close
from test_stylegan2_torch_oracle import SIZE, STYLE_DIM
from test_torch_train import TERMS, _port_editor, assert_adam_moves_close, jax_grad_capture
from test_train_dynamics import ATTR_IDX, ATTR_LIST, LR, N_MLP, _build_world

from latent2im_tpu.engine import train as jtrain
from latent2im_tpu.engine.editor import Editor as JEditor
from latent2im_tpu.engine.editor import EditorConfig as JEditorConfig
from latent2im_tpu.io import torch_convert as jtc
from latent2im_tpu.tasks import transforms as jtasks
from latent2im_tpu.walks import walks as jwalks
from latent2im_tpu_torch.engine import train as T
from latent2im_tpu_torch.io.convert import walk_from_jax
from latent2im_tpu_torch.tasks import transforms as tasks
from latent2im_tpu_torch.walks import walks

Z_KINDS = ("mlp_z", "linear_z_free", "linear_z", "linear_z_dir", "mlp_z_norm",
           "mlp_z3", "embed")
DIM = 32


def _jax_walk(kind, dim=DIM, seed=0, attrs=ATTR_LIST):
    tree = jwalks.init_walk(jax.random.PRNGKey(seed), kind, dim, 8, list(attrs))
    return jax.tree_util.tree_map(np.array, tree)


def _close_to_scale(got, want, rtol=1e-5, atol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("kind", Z_KINDS)
def test_z_walk_apply_and_gradient_match_jax(kind):
    tree = _jax_walk(kind)
    rng = np.random.RandomState(1)
    z = rng.randn(3, DIM).astype(np.float32)
    alpha = rng.uniform(-1, 1, (3, len(ATTR_LIST))).astype(np.float32)
    g = rng.randn(3, DIM).astype(np.float32)
    kw = {"name": ATTR_LIST[1], "index": 4} if kind == "embed" else {}

    @jax.jit
    def value_and_vjp(p, z, alpha, g):
        out, vjp = jax.vjp(lambda p: jwalks.apply_walk(kind, p, z, alpha, **kw), p)
        return out, vjp(g)[0]

    want, want_grad = value_and_vjp(tree, z, alpha, g)
    params = walks.walk_map(lambda t: t.requires_grad_(True), walk_from_jax(tree))
    if kind == "embed":  # a tensor index, as the training step passes it
        kw["index"] = torch.tensor(4)
    got = walks.apply_walk(kind, params, torch.from_numpy(z), torch.from_numpy(alpha), **kw)
    _close_to_scale(got.detach().numpy(), want)
    leaves = walks.walk_leaves(params)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g), allow_unused=True)
    want_leaves = jax.tree_util.tree_leaves(want_grad)
    assert len(grads) == len(want_leaves) >= 1
    for a, b in zip(grads, want_leaves):
        a = torch.zeros(b.shape) if a is None else a  # a bank the edit does not read
        _close_to_scale(a.numpy(), np.asarray(b))
    if kind == "embed":  # name=None takes the first bank
        first = walks.apply_walk(kind, params, torch.from_numpy(z), None, index=2)
        want0 = jwalks.apply_walk(kind, tree, jnp.asarray(z), None, index=2)
        _close_to_scale(first.detach().numpy(), want0)


@pytest.mark.parametrize("kind", Z_KINDS)
def test_z_walk_init_has_the_jax_layout_and_distribution(kind):
    tree = _jax_walk(kind, dim=64)
    params = walks.init_walk(kind, 64, 8, list(ATTR_LIST),
                             generator=torch.Generator().manual_seed(0))
    got = jax.tree_util.tree_structure(walks.walk_map(lambda t: t.numpy(), params))
    assert got == jax.tree_util.tree_structure(tree)
    for a, b in zip(walks.walk_leaves(params), jax.tree_util.tree_leaves(tree)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        if b.ndim >= 2 and kind in ("linear_z_free", "linear_z_dir", "embed"):
            assert abs(float(a.std()) - 0.02) < 0.004  # 0.02 * N(0, 1)
        else:  # nn.Linear's U(-1/sqrt(fan_in), ..)
            fan_in = next(layer["w"].shape[0] for layer in _linears(params)
                          if any(t is a for t in layer.values()))
            assert float(a.abs().max()) <= 1.0 / np.sqrt(fan_in)
    assert walks.walk_space(kind) == jwalks.walk_space(kind) == "z"


def _linears(params):
    if isinstance(params, dict):
        if set(params) == {"w", "b"}:
            return [params]
        return [x for v in params.values() for x in _linears(v)]
    if isinstance(params, list):
        return [x for v in params for x in _linears(v)]
    return []


@pytest.mark.parametrize("transform", ["face", "scene"])
def test_train_alpha_embed_np_matches_jax_exactly(transform):
    port = tasks.get_task(transform, nsliders=2)
    ref = jtasks.get_task(transform, nsliders=2)
    assert (port.num_panel, port.embed_alpha_max) == (ref.num_panel, ref.embed_alpha_max)
    np.testing.assert_array_equal(port.embedding_alphas(), ref.embedding_alphas())
    a, b = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(20):
        got, want = port.train_alpha_embed_np(a, 3), ref.train_alpha_embed_np(b, 3)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype and got[1] == want[1] and got[2] == want[2]


# ---------------------------------------------------------------------------
# StyleGAN2 in z space
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def z_world():
    """The towers of tests/test_train_dynamics.py in both packages, the
    editors set to latent 'z' and the mlp_z walk (one attribute)."""
    tg, td, tr, tvgg, _, zs, alphas = _build_world()
    attrs, idx = ATTR_LIST[:1], ATTR_IDX[:1]
    jcfg = JEditorConfig(latent="z", walk_kind="mlp_z", attr_list=attrs, attr_idx=idx,
                         size=SIZE, dim_z=STYLE_DIM, alpha_mode="target", fixed_noise=True)
    jed = JEditor(
        jcfg, jtc.convert_stylegan2_generator(tg.state_dict(), SIZE, n_mlp=N_MLP),
        jtc.convert_resnet50(tr.state_dict()),
        vgg_params=jtc.convert_vgg_features(tvgg.state_dict(), "vgg19"),
        d_params=jtc.convert_stylegan2_discriminator(td.state_dict(), SIZE))
    ted = _port_editor(tg, td, tr, tvgg)
    ted.cfg = type(ted.cfg)(**{**ted.cfg.__dict__, "latent": "z", "walk_kind": "mlp_z",
                               "attr_list": attrs, "attr_idx": idx})
    ted._attr_idx = torch.as_tensor(idx)
    walk0 = _jax_walk("mlp_z", dim=STYLE_DIM, seed=3, attrs=attrs)
    return jed, ted, walk0, zs, alphas[:, :, :1]


def test_z_apply_alpha_and_sweep_match_jax(z_world):
    jed, ted, walk0, zs, _ = z_world
    z = zs[0]
    a = np.asarray([0.3, 0.9], np.float32)
    je, ja, jo = jed.apply_alpha(jax.tree_util.tree_map(jnp.asarray, walk0), jnp.asarray(z), a)
    te, ta, to = ted.apply_alpha(walk_from_jax(walk0), z, a)
    assert_images_close(te.numpy(), np.asarray(je))
    assert_images_close(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-5)
    assert not torch.equal(te, to)  # the alpha moved z
    panels = np.linspace(0.0, 1.0, 3)[:, None].repeat(2, 1).astype(np.float32)
    ji, _, _ = jed.sweep(jax.tree_util.tree_map(jnp.asarray, walk0), jnp.asarray(z), panels)
    ti, _, _ = ted.sweep(walk_from_jax(walk0), z, panels, chunk=4)
    assert ti.shape == (3, 2, SIZE, SIZE, 3)
    assert_images_close(ti.numpy(), np.asarray(ji))
    # the combine paths are W space only; the JAX package's raise ValueError too
    with pytest.raises(ValueError):
        ted.apply_alpha_combine(walk_from_jax(walk0), z, [a], [ATTR_IDX[0]])


def test_z_training_step_matches_the_jax_step(z_world):
    jed, ted, walk0, zs, alphas = z_world
    optimizer = jax_grad_capture(jtrain.make_optimizer(LR))
    jwalk = jax.tree_util.tree_map(jnp.asarray, walk0)
    jstep = jtrain.make_train_step(jed, None, optimizer, host_alpha=True)
    jwalk, jstate, jm = jstep(jwalk, optimizer.init(jwalk), jnp.asarray(zs[0]),
                         jax.random.PRNGKey(0), sampled=jnp.asarray(alphas[0]))
    want = {k: float(v) for k, v in jm.items()}

    walk = walks.walk_map(lambda t: t.requires_grad_(True), walk_from_jax(walk0))
    step = T.make_train_step(ted, None, T.make_optimizer(walk, LR), host_alpha=True)
    m = step(walk, zs[0], sampled=alphas[0])
    for k in TERMS:
        np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-4, err_msg=k)
    for a, w0, b, g in zip(walks.walk_leaves(walk), walks.walk_leaves(walk_from_jax(walk0)),
                           jax.tree_util.tree_leaves(jwalk),
                           jax.tree_util.tree_leaves(jstate[0])):
        moved = a.detach().numpy() - w0.numpy()
        assert np.abs(moved).max() > 0
        assert_adam_moves_close(moved, np.asarray(b) - w0.numpy(), a.grad.numpy(),
                                np.asarray(g), w0.numpy(), LR)


def test_alpha_driven_paths_refuse_the_embed_walk(z_world):
    _, ted, _, zs, _ = z_world
    ted.cfg = type(ted.cfg)(**{**ted.cfg.__dict__, "walk_kind": "embed"})
    try:
        walk = walk_from_jax(_jax_walk("embed", dim=STYLE_DIM, attrs=ATTR_LIST[:1]))
        with pytest.raises(ValueError, match="embed"):
            ted.apply_alpha(walk, zs[0], np.full((2,), 0.5, np.float32))
        with pytest.raises(ValueError, match="embed"):
            ted.sweep(walk, zs[0], np.full((3, 2), 0.5, np.float32))
        # an explicit bank entry is the route the refusal names
        got = ted.edit(walk, torch.from_numpy(zs[0]), None, name=ATTR_LIST[0], index=3)
        want = zs[0] + walk["w"][ATTR_LIST[0]][3, 0].sum(-1).numpy()[None]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    finally:
        ted.cfg = type(ted.cfg)(**{**ted.cfg.__dict__, "walk_kind": "mlp_z"})
