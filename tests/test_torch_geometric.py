"""The port's geometric and color tasks (latent2im_tpu_torch/tasks/
{geometric,warp}.py, engine/train.py:geometric_train_loop) and the dsprites
sliders against the JAX package, on the CPU at 32 px:

- the numpy matrix builders and each task's samplers, --trainEmbed ladders,
  test/vis schedules and device specs: bit for bit (the same RandomState
  streams);
- every task's device target and mask against latent2im_tpu.tasks.warp on
  the same images: targets within 1e-5 absolute (colorlab: within
  max(1e-5, 2 x the gap between the JAX package's own eager and jitted
  colorlab_target on the same inputs, ~1.2e-5): the f32 Lab round trip
  moves by ~1e-5 with one ulp of a power or a 3x3 product); masks identical
  for shift and the color tasks, and for zoom, rotate2d and rotate3d
  within 1e-3 of the pixels (a borderline pixel's coordinate a rounding
  away from the border: here none differ);
- geometric_train_loop, 2 epochs of 2 steps (B=2) on the same tiny G
  (stored noise, noise weights 0.3) and walk: the loss history and the walk
  within ``assert_close``'s f32 gates of the JAX loop, for color, colorlab,
  shiftx and rotate3d (zoom through the CLIs) and for --trainEmbed on zoom
  and shiftx (a 15-step ladder over the 6-entry bank: the index past it
  takes the last entry, as JAX's clamp); a resumed run (rotate2d) equals
  the uninterrupted one bit for bit;
- color's [B, 3] slider on a 1-slider walk broadcasts in both packages,
  and color --trainEmbed raises IndexError in both (its 0-d alpha);
- a --model pggan run through both builds (edits at half G's size, the warp
  built for G's size, ROADMAP.md C.6);
- the dsprites samplers (host bit for bit, the torch.Generator one
  composed the same way and refusing a subset with ValueError) and
  train_loop's fallback to host sampling for an --attrList subset.

The CLIs on a geometric walk are in tests/test_torch_geometric_cli.py.
"""

import copy
import functools
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import assert_close
from test_warp_device import smooth_images
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse: one torch thread)

from latent2im_tpu.engine import train as jtrain
from latent2im_tpu.engine.editor import Editor as JEditor
from latent2im_tpu.engine.editor import EditorConfig as JEditorConfig
from latent2im_tpu.tasks import transforms as jtasks
from latent2im_tpu.tasks import warp as jwarp
from latent2im_tpu.walks import walks as jwalks
from latent2im_tpu_torch.engine import train as T
from latent2im_tpu_torch.engine.build import TINY_CHANNELS
from latent2im_tpu_torch.engine.editor import Editor, EditorConfig
from latent2im_tpu_torch.io.convert import generator_to_jax, walk_from_jax
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.tasks import geometric as geo
from latent2im_tpu_torch.tasks import transforms as tasks
from latent2im_tpu_torch.tasks import warp
from latent2im_tpu_torch.walks import walks

SIZE, DIM, N_MLP, LR = 32, 32, 2, 1e-2
TASKS = tuple(geo.GEOMETRIC_TASKS)
EXACT_MASKS = ("color", "colorlab", "shiftx", "shifty")


# ---------------------------------------------------------------------------
# matrices, samplers, ladders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [-37.5, -3.0, 0.0, 0.61, 1.0, 1.7, 2.0, 400.0])
def test_matrix_builders_are_bit_identical(alpha):
    for axis in ("x", "y"):
        np.testing.assert_array_equal(warp.shift_minv(alpha, axis), jwarp.shift_minv(alpha, axis))
    for size in (32, 256):
        np.testing.assert_array_equal(warp.rotate2d_minv(alpha, size),
                                      jwarp.rotate2d_minv(alpha, size))
        np.testing.assert_array_equal(warp.rotate3d_minv(alpha, size),
                                      jwarp.rotate3d_minv(alpha, size))
        if alpha > 0:
            for got, want in zip(warp.zoom_minv(alpha, size), jwarp.zoom_minv(alpha, size)):
                np.testing.assert_array_equal(got, want)


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    else:
        assert type(got) is type(want), (type(got), type(want))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", TASKS)
def test_task_samplers_ladders_and_specs_are_bit_identical(name):
    kw = {"channel": 1, "nsliders": 3} if name.startswith("color") else {}
    for extra in ({}, kw):
        t, jt = tasks.get_task(name, **extra), jtasks.get_task(name, **extra)
        assert type(t).__name__ == type(jt).__name__
        assert (t.nsliders, t.num_panel, t.embed_alpha_max) == \
            (jt.nsliders, jt.num_panel, jt.embed_alpha_max)
        r, jr = np.random.RandomState(5), np.random.RandomState(5)
        for _ in range(12):
            _same(t.train_alpha_np(r, 3), jt.train_alpha_np(jr, 3))
            _same(t.train_alpha_embed_np(r, 3), jt.train_alpha_embed_np(jr, 3))
        # the base sampler's signature, as train_loop's host branch calls it
        _same(t.train_alpha_np(r, 3, 1, attr_list=[name]), jt.train_alpha_np(jr, 3))
        _same(t.embedding_alphas(), jt.embedding_alphas())
        _same(t.test_alphas(), jt.test_alphas())
        for p in (5, 7, 8):
            _same(t.vis_alphas(p), jt.vis_alphas(p))
        for a in (0.5, 1.0, 2.0, -45.0):
            _same(t.scale_test_alpha(a, 3), jt.scale_test_alpha(a, 3))
            if name.startswith("color"):
                _same(t.scale_test_alpha(a, 3, contrast=True),
                      jt.scale_test_alpha(a, 3, contrast=True))
            if name != "zoom" or a > 0:
                _same(t.device_spec(a, SIZE), jt.device_spec(a, SIZE))
        if name.startswith("color"):  # a per-sample [B, 3] shift
            _same(t.device_spec(np.float32([[0.1, -0.2, 0.3]]), SIZE),
                  jt.device_spec(np.float32([[0.1, -0.2, 0.3]]), SIZE))
    with pytest.raises(KeyError):
        tasks.get_task("nope")
    with pytest.raises(KeyError):
        jtasks.get_task("nope")


def test_base_task_vis_alphas_match():
    for name in tasks.TASKS:
        np.testing.assert_array_equal(tasks.get_task(name).vis_alphas(6),
                                      jtasks.get_task(name).vis_alphas(6))


# ---------------------------------------------------------------------------
# device targets and masks
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_target_fn(kind, clamp, jit):
    def fn(imgs, payload):
        if kind == "warp":
            return jwarp.warp_target_and_mask(imgs, payload["minv"], clamp=clamp,
                                              box=payload["box"])
        return (jwarp.color_target if kind == "color" else jwarp.colorlab_target)(imgs, payload)

    return jax.jit(fn) if jit else fn


def _jax_target(spec, imgs, jit=False):
    kind, payload, clamp = spec
    payload = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), payload)
    return [np.asarray(x) for x in _jax_target_fn(kind, clamp, jit)(jnp.asarray(imgs), payload)]


@pytest.mark.parametrize("name", TASKS)
def test_targets_and_masks_match_jax(name):
    imgs = np.concatenate([smooth_images(b=2, size=SIZE, seed=1),
                           np.tanh(np.random.RandomState(2).randn(2, SIZE, SIZE, 3))
                           ]).astype(np.float32)
    task, rng = tasks.get_task(name), np.random.RandomState(7)
    specs = [task.device_spec(task.train_alpha_np(rng, 4)[1], SIZE) for _ in range(16)]
    if name == "zoom":  # both branches and the identity
        specs += [task.device_spec(a, SIZE) for a in (0.5, 0.77, 1.0, 1.31, 2.0)]
    if name == "rotate3d":
        specs.append(task.device_spec(0, SIZE))
    worst, jax_gap, mism, total = 0.0, 0.0, 0, 0
    for spec in specs:
        got_t, got_m = (x.numpy() for x in geo.device_target(spec, torch.from_numpy(imgs)))
        want_t, want_m = _jax_target(spec, imgs)
        if name == "colorlab":
            jitted, _ = _jax_target(spec, imgs, jit=True)
            jax_gap = max(jax_gap, float(np.abs(jitted - want_t).max()))
        worst = max(worst, float(np.abs(got_t - want_t).max()))
        assert set(np.unique(got_m)) <= {0.0, 1.0}
        mism += int((got_m != want_m).sum())
        total += got_m.size
    assert worst <= max(1e-5, 2 * jax_gap), (worst, jax_gap)
    if name in EXACT_MASKS:
        assert mism == 0
    else:
        assert mism <= 1e-3 * total, (mism, total)
    if name in ("zoom", "rotate2d", "rotate3d", "shiftx"):
        assert worst > 0 or name == "shiftx"  # the warps sample between pixels


def test_integer_shift_border_mask_is_exact():
    """An integer shift's border pixels sample at exactly -1 or W with weight
    0: mask 0 there, as map_coordinates gives (F.grid_sample would not)."""
    imgs = torch.ones(1, SIZE, SIZE, 3)
    for axis, a in (("x", 3.0), ("y", -5.0)):
        _, mask = warp.warp_target_and_mask(imgs, warp.shift_minv(a, axis))
        _, want = jwarp.warp_target_and_mask(jnp.ones((1, SIZE, SIZE, 3)),
                                             jnp.asarray(jwarp.shift_minv(a, axis)))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want))
        lost = mask[0, :, :, 0].sum().item()
        assert lost == SIZE * (SIZE - abs(a))


# ---------------------------------------------------------------------------
# geometric_train_loop against the JAX loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def g_world():
    """The tiny G of the port's --dev_tiny build (noise weights 0.3, so the
    stored noise maps count), and its JAX tree."""
    g = sg2.Generator(SIZE, DIM, N_MLP, channels=TINY_CHANNELS,
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, p in g.named_parameters():
            if k.endswith("noise.weight"):
                p.fill_(0.3)
    return g.eval(), generator_to_jax(g.state_dict())


def _editors(g_world, name, kind):
    g, tree = g_world
    kw = dict(latent="w", walk_kind=kind, attr_list=(name,), attr_idx=(0,), size=SIZE,
              dim_z=DIM)
    return Editor(EditorConfig(**kw), g, None, "cpu"), JEditor(JEditorConfig(**kw), tree, {})


def _walks(name, kind, seed=3):
    tree = jax.tree_util.tree_map(np.array, jwalks.init_walk(
        jax.random.PRNGKey(seed), kind, DIM, 8, [name]))
    return tree, walk_from_jax(tree)


LOOP = dict(num_samples=4, batch_size=2, n_epochs=2, lr=LR, seed=0, log_every=1)


def _jax_loop(jed, name, tree):
    jt = jtasks.get_task(name)
    walk, hist = jtrain.geometric_train_loop(jed, jt, jax.tree_util.tree_map(jnp.asarray, tree),
                                             **LOOP)
    return jax.tree_util.tree_map(np.asarray, walk), hist


# one task of each target kind and clamp (zoom's linear_w loop runs through
# both CLIs in tests/test_torch_geometric_cli.py), --trainEmbed on zoom and
# shiftx
@pytest.mark.parametrize("name,kind", [("color", "linear_w"), ("colorlab", "linear_w"),
                                       ("shiftx", "linear_w"), ("rotate3d", "linear_w"),
                                       ("zoom", "embed"), ("shiftx", "embed")])
def test_geometric_train_loop_matches_jax(g_world, name, kind):
    ted, jed = _editors(g_world, name, kind)
    tree, walk = _walks(name, kind)
    want_walk, want_hist = _jax_loop(jed, name, tree)
    got_walk, got_hist = T.geometric_train_loop(ted, tasks.get_task(name), walk, **LOOP)
    assert len(got_hist) == len(want_hist) == 4 and np.all(np.isfinite(got_hist))
    assert_close(got_hist, want_hist)
    got_leaves = walks.walk_leaves(got_walk)
    want_leaves = jax.tree_util.tree_leaves(want_walk)
    assert len(got_leaves) == len(want_leaves)
    for got, want, start in zip(got_leaves, want_leaves, jax.tree_util.tree_leaves(tree)):
        assert not np.array_equal(np.asarray(want), start)  # Adam moved it
        assert_close(got.detach().numpy(), want)


def test_resume_equals_the_uninterrupted_run(g_world):
    ted, _ = _editors(g_world, "rotate2d", "linear_w")
    task = tasks.get_task("rotate2d")
    _, walk = _walks("rotate2d", "linear_w")
    whole, whole_hist = T.geometric_train_loop(ted, task, walk, **LOOP)
    _, walk = _walks("rotate2d", "linear_w")
    saved, calls = {}, {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] == 4  # before epoch 1's second step

    def on_preempt(epoch, wp, st):
        saved.update(epoch=epoch, walk={k: v.detach().clone() for k, v in wp.items()},
                     state=st)

    def on_epoch_end(epoch, wp, st):  # the live Adam state: copy it, as a checkpoint does
        saved.update(end={k: v.detach().clone() for k, v in wp.items()},
                     end_state=copy.deepcopy(st))

    _, first = T.geometric_train_loop(ted, task, walk, stop_flag=stop, on_preempt=on_preempt,
                                      on_epoch_end=on_epoch_end, **LOOP)
    assert saved["epoch"] == 1 and first == whole_hist[:3]
    # resume from the last epoch's end, as the CLI's --resume does
    walk = {k: v.clone() for k, v in saved["end"].items()}
    resumed, hist = T.geometric_train_loop(ted, task, walk, start_epoch=1,
                                           opt_state=saved["end_state"], **LOOP)
    assert hist == whole_hist[2:]
    assert torch.equal(resumed["w"], whole["w"])


def test_color_broadcasts_its_three_alphas_over_the_one_slider_walk():
    """color's train_alpha_np gives [B, 3] and the walk has one slider: both
    packages' einsum broadcast the size-1 axis."""
    w = np.random.RandomState(0).randn(1, 8, DIM).astype(np.float32)
    lat = np.random.RandomState(1).randn(2, 8, DIM).astype(np.float32)
    alpha, _ = tasks.get_task("color").train_alpha_np(np.random.RandomState(2), 2)
    assert alpha.shape == (2, 3)
    got = walks.apply_walk("linear_w", {"w": torch.from_numpy(w)}, torch.from_numpy(lat),
                           torch.from_numpy(alpha))
    want = jwalks.apply_walk("linear_w", {"w": jnp.asarray(w)}, jnp.asarray(lat),
                             jnp.asarray(alpha))
    assert_close(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), lat + alpha.sum(1)[:, None, None] * w, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["color", "colorlab"])
def test_color_train_embed_raises_index_error_as_jax(g_world, name):
    ted, jed = _editors(g_world, name, "embed")
    tree, walk = _walks(name, "embed")
    with pytest.raises(IndexError):
        _jax_loop(jed, name, tree)
    with pytest.raises(IndexError):
        T.geometric_train_loop(ted, tasks.get_task(name), walk, **LOOP)


# ---------------------------------------------------------------------------
# dsprites
# ---------------------------------------------------------------------------

DSPRITES_LISTS = (None, ["scale", "x", "y", "posx", "posy"], ["scale", "posx"], ["x"],
                  ["posy", "scale"])


def test_dsprites_host_sampler_is_bit_identical():
    t, jt = tasks.get_task("dsprites"), jtasks.get_task("dsprites")
    for attr_list in DSPRITES_LISTS:
        r, jr = np.random.RandomState(9), np.random.RandomState(9)
        for _ in range(8):
            _same(t.train_alpha_np(r, 3, attr_list=attr_list),
                  jt.train_alpha_np(jr, 3, attr_list=attr_list))


def test_dsprites_device_sampler_composes_the_default_sliders():
    t = tasks.get_task("dsprites")
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([t.train_alpha(gen, 2, 5)[1] for _ in range(400)])
    slider, a = t.train_alpha(gen, 3, 5)
    assert slider.shape == (3, 5) and torch.equal(slider[1], a)
    assert set(np.round(draws[:, 0].numpy(), 6)) == set(np.float32(t.SCALE_LADDER).round(6))
    x, pos = draws[:, 1:3], draws[:, 3:]
    assert x.min() >= -1 and x.max() <= 1 and x.min() < -0.8 and x.max() > 0.8
    assert pos.min() >= 0 and pos.max() <= 1 and pos.min() < 0.1 and pos.max() > 0.9
    assert abs(float(x.mean())) < 0.1 and abs(float(pos.mean()) - 0.5) < 0.05
    with pytest.raises(ValueError, match="5-slider"):
        t.train_alpha(gen, 2, 2)
    with pytest.raises(ValueError, match="5-slider"):
        jt_ = jtasks.get_task("dsprites")
        jt_.train_alpha(jax.random.PRNGKey(0), 2, 2)


def test_train_loop_falls_back_to_host_sampling_for_a_dsprites_subset(g_world, capsys):
    from latent2im_tpu_torch.models import resnet as rn

    g, _ = g_world
    cfg = EditorConfig(attr_list=("scale", "posx"), attr_idx=(0, 3), size=SIZE, dim_z=DIM,
                       no_content_loss=True, no_gan_loss=True, fixed_noise=True)
    reg = rn.ResNet50(num_outputs=5, generator=torch.Generator().manual_seed(1))
    ed = Editor(cfg, g, reg, "cpu")
    seen = []
    real_step = T.make_train_step

    def spy(*a, **kw):
        step = real_step(*a, **kw)
        assert kw["host_alpha"] is True

        def wrapped(walk, z, gen=None, sampled=None, index=None):
            seen.append(np.asarray(sampled))
            return step(walk, z, gen, sampled, index)
        return wrapped

    walk = {"w": torch.zeros(2, 8, DIM)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(T, "make_train_step", spy)
        _, hist = T.train_loop(ed, tasks.get_task("dsprites"), walk, num_samples=2,
                               batch_size=2, n_epochs=1, lr=LR, log_every=1)
    assert "falling back to host-numpy sampling" in capsys.readouterr().out
    assert len(hist) == 1 and np.isfinite(hist[0])
    want, _ = jtasks.get_task("dsprites").train_alpha_np(
        np.random.RandomState(jtrain._alpha_seed(0, 0)), 2, 2, attr_list=["scale", "posx"])
    np.testing.assert_array_equal(seen[0], want)


# ---------------------------------------------------------------------------
# PGGAN (ROADMAP.md C.6)
# ---------------------------------------------------------------------------


def test_pggan_geometric_run_matches_jax_and_warps_for_g_size():
    """--model pggan --transform rotate2d at --resolution 16: the edits are
    8 px, the rotation matrix is built for 16 px (centre (8, 8), not (4, 4))
    in both packages, and a loop of both agrees."""
    from test_torch_pggan import _builds

    jed, jtree, ted, walk = _builds("--transform", "rotate2d", "--attrList", "",
                                    "--no_gan_loss")
    assert ted.cfg.size == jed.cfg.size == 16 and ted.cfg.attr_list == ("rotate2d",)
    z = np.random.RandomState(0).randn(2, 512).astype(np.float32)
    img = ted.synthesize(z)
    assert img.shape == (2, 8, 8, 3)
    spec = tasks.get_task("rotate2d").device_spec(30.0, ted.cfg.size)
    got_t, got_m = geo.device_target(spec, img)
    want_t, want_m = _jax_target(spec, img.numpy())
    assert_close(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    centred = geo.device_target(tasks.get_task("rotate2d").device_spec(30.0, 8), img)[1]
    assert not torch.equal(got_m, centred)  # rotated about (8, 8), outside the image
    loop = dict(LOOP, n_epochs=1)
    want_walk, want_hist = jtrain.geometric_train_loop(
        jed, jtasks.get_task("rotate2d"), jax.tree_util.tree_map(jnp.asarray, jtree), **loop)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got_walk, got_hist = T.geometric_train_loop(ted, tasks.get_task("rotate2d"), walk,
                                                    **loop)
    assert_close(got_hist, want_hist)
    for got, want in zip(walks.walk_leaves(got_walk), jax.tree_util.tree_leaves(want_walk)):
        assert_close(got.detach().numpy(), np.asarray(want))
