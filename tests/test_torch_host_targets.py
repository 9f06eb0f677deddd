"""The port's host targets of the geometric tasks (--host_targets) against
the JAX package's, on the CPU:

- every task's ``get_target_np`` (tasks/geometric.py, through tasks/
  cv2_np.py) against the JAX package's (through cv2) on the same images at
  32 and 64 px, at alphas that include each range's ends: float64 arrays,
  masks equal exactly, images within one float32 ulp of their magnitude;
- one ``make_geometric_train_step`` step against the JAX step on the same
  host target: the loss at rtol 1e-4, the walk's gradient and Adam move
  through tests/test_torch_train.py:assert_adam_moves_close;
- two epochs of 2 steps (B=2) of ``geometric_train_loop(device_targets=
  False)`` against the JAX loop's host path, for every task: the loss
  history at rtol 1e-3; and the mesh refusal, with the JAX loop's text;
- ``cli.train --transform <task> --host_targets`` trains every task, and
  under --n_devices 2 launches no ranks and trains the global batch on one
  device, as the JAX CLI runs that path with no mesh.

The JAX host step is compiled once for the module (the loops share it).
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_cli import _restoring_logging, one_torch_thread  # noqa: F401
from test_torch_geometric import LOOP, LR, SIZE, _editors, _walks, g_world  # noqa: F401
from test_torch_train import assert_adam_moves_close, jax_grad_capture

from latent2im_tpu.engine import train as jtrain
from latent2im_tpu.tasks import geometric as jgeo
from latent2im_tpu_torch.config import options
from latent2im_tpu_torch.engine import train as T
from latent2im_tpu_torch.tasks import geometric as geo
from latent2im_tpu_torch.walks import walks

TASKS = tuple(geo.GEOMETRIC_TASKS)


def _alphas(name, rng):
    """Alphas of each task's training range, its ends included."""
    if name in ("color", "colorlab"):
        return [rng.random_sample((2, 3)).astype(np.float32) - 0.5,
                np.full((2, 3), -0.5, np.float32), np.full((2, 3), 0.5, np.float32)]
    return {"zoom": [0.5, 0.61, 1.0, 1.37, 2.0], "shiftx": [-8, -3, 0, 7],
            "shifty": [-8, 5, 7], "rotate2d": [-45, -17, 0, 44],
            "rotate3d": [-720, -233, 0, 91, 719]}[name]


def _assert_target_close(got, want):
    (tg, mg), (tw, mw) = got, want
    assert tg.dtype == tw.dtype and mg.dtype == mw.dtype and tg.shape == tw.shape
    np.testing.assert_array_equal(mg, mw)
    ulp = np.spacing(np.abs(np.asarray(tw, np.float32))).astype(np.float64)
    assert np.all(np.abs(np.asarray(tg, np.float64) - tw) <= ulp)


@pytest.mark.parametrize("name", TASKS)
def test_get_target_np_matches_jax(name):
    rng = np.random.RandomState(7)
    for size in (32, 64):
        imgs = np.tanh(rng.randn(2, size, size, 3)).astype(np.float32)
        port, ref = geo.GEOMETRIC_TASKS[name](), jgeo.GEOMETRIC_TASKS[name]()
        for alpha in _alphas(name, rng):
            _assert_target_close(port.get_target_np(imgs.copy(), alpha),
                                 ref.get_target_np(imgs.copy(), alpha))


@pytest.fixture(scope="module")
def shared_jax_step():
    """jtrain.make_geometric_train_step memoised per editor, so the loops
    of this module compile the JAX host step once (the optimizer is the
    same Adam at the same lr every time)."""
    built = {}
    real = jtrain.make_geometric_train_step

    def make(editor, optimizer, train_embed=False):
        key = (id(editor), train_embed)
        if key not in built:
            built[key] = real(editor, optimizer, train_embed=train_embed)
        return built[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "make_geometric_train_step", make)
        yield


@pytest.fixture(scope="module")
def editors(g_world):  # noqa: F811
    return _editors(g_world, "rotate2d", "linear_w")


def test_one_host_target_step_matches_the_jax_step(editors):
    ted, jed = editors
    tree, walk = _walks("rotate2d", "linear_w")
    z = np.random.RandomState(4).randn(2, ted.cfg.dim_z).astype(np.float32)
    alpha_graph, alpha = np.full((2, 1), 20 / 45, np.float32), 20
    img = np.asarray(jed.synthesize(jed.get_w(jnp.asarray(z))), np.float32)
    target, mask = jgeo.Rotate2DTransform().get_target_np(img, alpha)
    assert 0 < mask.mean() < 1
    optimizer = jax_grad_capture(jtrain.make_optimizer(LR))
    jwalk = jax.tree_util.tree_map(jnp.asarray, tree)
    jstep = jtrain.make_geometric_train_step(jed, optimizer)
    jwalk, jstate, jm = jstep(jwalk, optimizer.init(jwalk), jnp.asarray(z),
                              jnp.asarray(alpha_graph), jnp.asarray(target, jnp.float32),
                              jnp.asarray(mask, jnp.float32))

    leaves = walks.walk_leaves(walk)
    start = [t.detach().numpy().copy() for t in leaves]
    for t in leaves:
        t.requires_grad_(True)
    step = T.make_geometric_train_step(ted, T.make_optimizer(walk, LR))
    m = step(walk, z, alpha_graph, np.float32(target), np.float32(mask))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["alpha_target_mean"]),
                               float(jm["alpha_target_mean"]), rtol=1e-6)
    for t, w0, b, g in zip(leaves, start, jax.tree_util.tree_leaves(jwalk),
                           jax.tree_util.tree_leaves(jstate[0])):
        moved = t.detach().numpy() - w0
        assert np.abs(moved).max() > 0
        assert_adam_moves_close(moved, np.asarray(b) - w0, t.grad.numpy(), np.asarray(g),
                                w0, LR)


@pytest.mark.parametrize("name", TASKS)
def test_host_target_loop_matches_the_jax_loop(editors, shared_jax_step, name):
    ted, jed = editors
    tree, walk = _walks(name, "linear_w")
    want_walk, want_hist = jtrain.geometric_train_loop(
        jed, jgeo.GEOMETRIC_TASKS[name](), jax.tree_util.tree_map(jnp.asarray, tree),
        device_targets=False, **LOOP)
    got_walk, got_hist = T.geometric_train_loop(ted, geo.GEOMETRIC_TASKS[name](), walk,
                                                device_targets=False, **LOOP)
    assert len(got_hist) == len(want_hist) == 4 and np.all(np.isfinite(got_hist))
    np.testing.assert_allclose(got_hist, want_hist, rtol=1e-3)
    for got, start in zip(walks.walk_leaves(got_walk), jax.tree_util.tree_leaves(tree)):
        assert not np.array_equal(got.detach().numpy(), start)


def test_host_target_loop_refuses_a_mesh_as_jax(editors):
    ted, jed = editors
    tree, walk = _walks("shiftx", "linear_w")
    want = "the host-warp geometric path is per-host; mesh requires device_targets=True"
    with pytest.raises(ValueError) as jerr:
        jtrain.geometric_train_loop(jed, jgeo.ShiftXTransform(), tree, mesh=object(),
                                    device_targets=False, **LOOP)
    with pytest.raises(ValueError) as err:
        T.geometric_train_loop(ted, geo.ShiftXTransform(), walk, mesh=object(),
                               device_targets=False, **LOOP)
    assert str(err.value) == str(jerr.value) == want


def _cli_args(models_dir, name, *extra):
    return ["--transform", name, "--models_dir", models_dir, "--overwrite_config",
            "--num_samples", "2", "--batch_size", "2", "--n_epochs", "1", "--dev_tiny",
            "--resolution", "32", "--host_targets", *extra]


@pytest.mark.parametrize("name", TASKS)
def test_train_cli_trains_each_task_on_host_targets(tmp_path, name):
    from latent2im_tpu_torch.cli.train import run

    opt = options.TrainOptions().parse(_cli_args(str(tmp_path), name), print_opt=False)
    with _restoring_logging(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        walk, hist = run(opt, device="cpu")
    assert len(hist) == 1 and np.isfinite(hist[0])
    assert os.path.isfile(os.path.join(opt.output_dir, "model_w_1_final_walk_module.ckpt"))


def test_host_targets_under_n_devices_trains_the_global_batch_in_one_process(tmp_path):
    """JAX: --n_devices 2 builds a 2-device mesh and doubles the batch, and
    the host path gets mesh=None: one program on one device. The port
    launches no ranks and steps on the batch of 2 x --batch_size."""
    import latent2im_tpu_torch.cli.train as tcli

    seen = []
    real_loop = tcli.geometric_train_loop

    def loop(*a, **kw):
        seen.append((kw["batch_size"], kw["mesh"], kw["device_targets"]))
        return real_loop(*a, **kw)

    def no_launch(*a, **kw):
        raise AssertionError("--host_targets launched ranks")

    opt = options.TrainOptions().parse(
        _cli_args(str(tmp_path), "shiftx", "--n_devices", "2", "--num_samples", "4"),
        print_opt=False)
    with _restoring_logging(), pytest.MonkeyPatch.context() as mp, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setattr(tcli, "geometric_train_loop", loop)
        mp.setattr(tcli.launchlib, "launch", no_launch)
        _, hist = tcli.run(opt, device="cpu")
    assert seen == [(4, None, False)]
    assert len(hist) == 1  # 4 samples at a global batch of 4


def _fixture_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("host_target_fixtures", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_host_targets",
        "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_committed_fixtures_match_their_recordings():
    """chip_smoke.py phase 51's inputs: the port's host targets of the
    fixture images, bit for bit the recorded cv2 ones (SHA-256 of target and
    mask), colorlab's within 1e-6 of its recorded grid, and the recorded
    warp matrices equal to the port's."""
    import hashlib
    import json

    fx = _fixture_module()
    with open(os.path.join(os.path.dirname(fx.__file__), "targets.json")) as f:
        meta = json.load(f)
    grids = np.load(os.path.join(os.path.dirname(fx.__file__), "targets.npz"))
    cases = fx.cases()
    assert len(cases) == 28 and {c[1] for c in cases} == set(TASKS)
    for name, task, size, batch, alpha in cases:
        rec = meta[name]
        imgs = fx.images(size, batch, fx.seed_of(size))
        a = np.asarray(alpha, np.float32) if task.startswith("color") else alpha
        target, mask = geo.GEOMETRIC_TASKS[task]().get_target_np(imgs.copy(), a)
        for arr, (shape, dtype, sha) in ((target, rec["target"]), (mask, rec["mask"])):
            assert list(arr.shape) == shape and str(arr.dtype) == dtype, name
            assert hashlib.sha256(arr.tobytes()).hexdigest() == sha, name
        if task == "colorlab":
            step = size // 16
            np.testing.assert_allclose(target[:, ::step, ::step], grids[name], atol=1e-6)
        if task == "rotate2d":
            np.testing.assert_array_equal(
                geo.cv2_np.get_rotation_matrix_2d((size // 2, size // 2), alpha, 1),
                rec["matrix"])
        if task == "rotate3d":
            it = geo.ImageTransformer(imgs[0])
            it.focal = np.sqrt(2.0 * size * size)
            np.testing.assert_array_equal(
                it._get_m(*np.deg2rad([0, alpha, 0]), 5, 0, it.focal), rec["matrix"])
