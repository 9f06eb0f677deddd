"""The port's walk-training step (latent2im_tpu_torch/engine/train.py)
against the JAX package's ``make_train_step`` and the committed dynamics
fixture, on the CPU.

The towers are the torch oracles of tests/test_train_dynamics.py (built from
its seed): they load into the port's modules with ``strict=True`` and, through
the JAX package's converters, into the JAX step. Both steps take the same
host-sampled alphas and the stored noise buffers. Tolerances: one step's
loss terms rtol 1e-4 (f32 towers summed in another order); six steps
against ``tests/fixtures/train_dynamics_tiny.npz`` with the tolerances of
``tests/test_train_dynamics.py:239-244`` (the raw BCE's log clamps amplify
forward differences over steps). Walk moves go through
``assert_adam_moves_close``: the gradient held to JAX's, the move held
where the gradient decides its sign, Adam's bound elsewhere.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from test_stylegan2_torch_oracle import CHANNELS, N_MLP, SIZE, STYLE_DIM
from test_train_dynamics import (ATTR_IDX, ATTR_LIST, FIXTURE, LR, N_REG_OUT,
                                 N_STEPS, _build_world)

from latent2im_tpu.engine import train as jtrain
from latent2im_tpu.engine.editor import Editor as JEditor
from latent2im_tpu.engine.editor import EditorConfig as JEditorConfig
from latent2im_tpu.io import torch_convert as tc
from latent2im_tpu.models import vgg as jvgg
from latent2im_tpu.tasks import transforms as jtasks
from latent2im_tpu_torch import ops
from latent2im_tpu_torch.engine import train as T
from latent2im_tpu_torch.engine.editor import Editor, EditorConfig
from latent2im_tpu_torch.models import resnet as rn
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.models import vgg as vggm
from latent2im_tpu_torch.tasks import transforms as tasks

TERMS = ("loss", "reg_loss", "content_loss", "gan_loss")

# The walk gradient of a step goes through every tower in f32; the port's and
# the JAX step's differ by up to 2.8e-4 * max|g| (nn_w at OMP_NUM_THREADS=1,
# 5e-6 elsewhere: there one ReLU input of the regressor lies within f32
# rounding of zero, and the port's one-thread convolutions land it on the
# other side than f64 does, ROADMAP C.9, scripts/torch_walk_relu_tie.py),
# as the loss terms differ at 1e-4: GRAD_ATOL (times
# max|g|) holds them with margin. Below SIGN_FLOOR * max|g|, about ten times
# the largest gap and just above GRAD_ATOL's sign resolution, a gradient
# entry's sign, and so its first Adam move of about lr * sign(g), may follow
# the order of the sums (the thread count).
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3
SIGN_FLOOR = 3e-3


def jax_grad_capture(optimizer):
    """``optimizer`` after a stage that keeps the gradient it is given as
    its state: the JAX step's opt_state[0] is then its gradient."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda g, state, params=None: (g, g))
    return optax.chain(keep, optimizer)


def adam_move_bound(steps, lr, b1=0.5, b2=0.99):
    """The most ``steps`` Adam steps (betas of T.make_optimizer, eps
    ignored) can move one entry, whatever its gradients: Cauchy-Schwarz
    bounds step t's |m_hat| / sqrt(v_hat) by (1 - b1) / (1 - b1^t) *
    sqrt((1 - b2^t) / (1 - b2)) * sqrt(sum_k<t (b1^2 / b2)^k), which is 1 at
    t = 1 and 1.053 at t = 2."""
    total = 0.0
    for t in range(1, steps + 1):
        geo = sum((b1 * b1 / b2) ** k for k in range(t))
        total += (1 - b1) / (1 - b1 ** t) * np.sqrt((1 - b2 ** t) / (1 - b2) * geo)
    return lr * total


def assert_adam_moves_close(moved, want_moved, grad, want_grad, w0, lr, steps=1):
    """Hold the port's Adam move of a walk tensor to the JAX one.

    - grad (the port's gradient, None where there is none to hold) against
      want_grad at GRAD_RTOL, GRAD_ATOL * max|want_grad|;
    - where |want_grad| > SIGN_FLOOR * max|want_grad| the move at rtol 5e-2,
      atol 2e-6 (Adam's first move is about lr * sign(g));
    - elsewhere only Adam's bound: |move| <= adam_move_bound(steps, lr) *
      (1 + 1e-6) (lr * (1 + 1e-6) for one step), plus the rounding of
      w0 + move to f32 (half a unit in the last place of |w0| + the move,
      once per step).
    want_grad is the first step's gradient; over ``steps`` steps a first
    sign carries on."""
    moved, want_moved = np.asarray(moved, np.float64), np.asarray(want_moved, np.float64)
    want_grad = np.asarray(want_grad, np.float64)
    scale = float(np.abs(want_grad).max())
    if grad is not None:
        np.testing.assert_allclose(np.asarray(grad), want_grad, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale,
                                   err_msg="gradient")
    decided = np.abs(want_grad) > SIGN_FLOOR * scale
    np.testing.assert_allclose(moved[decided], want_moved[decided], rtol=5e-2, atol=2e-6,
                               err_msg="move where the gradient decides its sign")
    w0 = np.abs(np.asarray(w0, np.float32))
    reach = adam_move_bound(steps, lr)
    bound = reach * (1 + 1e-6) + steps * 0.5 * np.spacing(w0 + np.float32(reach))
    excess = np.abs(moved) - bound
    assert np.all(excess[~decided] <= 0), (
        f"an undecided entry moved {float(np.abs(moved[~decided]).max())}, past Adam's "
        f"bound {reach} over {steps} steps")


def _port_editor(tg, td, tr, tvgg):
    """The oracle towers loaded into the port's modules, strict."""
    g = sg2.Generator(SIZE, STYLE_DIM, N_MLP, channels=CHANNELS)
    g.load_state_dict(tg.state_dict(), strict=True)
    d = sg2.Discriminator(SIZE, channels=CHANNELS)
    d.load_state_dict(sg2.strip_blur_kernels(td.state_dict()), strict=True)
    reg = rn.ResNet50(num_outputs=N_REG_OUT)
    reg.load_state_dict(tr.state_dict(), strict=True)
    vgg = vggm.VGG19Features()
    vgg.load_state_dict(vggm.features_state_dict(tvgg.state_dict()), strict=True)
    cfg = EditorConfig(attr_list=ATTR_LIST, attr_idx=ATTR_IDX, size=SIZE,
                       dim_z=STYLE_DIM, fixed_noise=True)
    return Editor(cfg, g, reg, "cpu", vgg=vgg, d=d)


def _port_run(n_steps):
    tg, td, tr, tvgg, walk0, zs, alphas = _build_world()
    ed = _port_editor(tg, td, tr, tvgg)
    walk = {"w": torch.from_numpy(walk0.copy()).requires_grad_()}
    step = T.make_train_step(ed, None, T.make_optimizer(walk, LR), host_alpha=True)
    metrics, traj, grads = [], [], []
    for t in range(n_steps):
        m = step(walk, zs[t], sampled=alphas[t])
        metrics.append({k: float(v) for k, v in m.items()})
        traj.append(walk["w"].detach().numpy().copy())
        grads.append(walk["w"].grad.numpy().copy())
    return metrics, np.stack(traj), walk0, grads


@pytest.fixture(scope="module")
def port_six_steps():
    return _port_run(N_STEPS)


@pytest.fixture(scope="module")
def jax_first_step():
    """The JAX step's metrics, walk after it and gradient."""
    tg, td, tr, tvgg, walk0, zs, alphas = _build_world()
    cfg = JEditorConfig(latent="w", walk_kind="linear_w", attr_list=ATTR_LIST,
                        attr_idx=ATTR_IDX, size=SIZE, dim_z=STYLE_DIM,
                        alpha_mode="target", fixed_noise=True)
    editor = JEditor(
        cfg, tc.convert_stylegan2_generator(tg.state_dict(), SIZE, n_mlp=N_MLP),
        tc.convert_resnet50(tr.state_dict()),
        vgg_params=tc.convert_vgg_features(tvgg.state_dict(), "vgg19"),
        d_params=tc.convert_stylegan2_discriminator(td.state_dict(), SIZE))
    optimizer = jax_grad_capture(jtrain.make_optimizer(LR))
    walk = {"w": jnp.asarray(walk0)}
    step = jtrain.make_train_step(editor, None, optimizer, host_alpha=True)
    walk, state, metrics = step(walk, optimizer.init(walk), jnp.asarray(zs[0]),
                                jax.random.PRNGKey(0), sampled=jnp.asarray(alphas[0]))
    return ({k: float(v) for k, v in metrics.items()}, np.asarray(walk["w"]),
            np.asarray(state[0]["w"]))


def test_one_step_matches_the_jax_step(port_six_steps, jax_first_step):
    metrics, traj, walk0, grads = port_six_steps
    want, want_w, want_g = jax_first_step
    for k in TERMS:
        np.testing.assert_allclose(metrics[0][k], want[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(metrics[0]["alpha_target_mean"],
                               want["alpha_target_mean"], rtol=1e-6)
    assert_adam_moves_close(traj[0] - walk0, want_w - walk0, grads[0], want_g, walk0, LR)


def test_six_steps_reproduce_the_dynamics_fixture(port_six_steps, jax_first_step):
    if not os.path.exists(FIXTURE):
        pytest.skip("committed fixture missing (python tests/test_train_dynamics.py)")
    fix = np.load(FIXTURE)
    metrics, traj, walk0, _ = port_six_steps
    np.testing.assert_allclose([m["loss"] for m in metrics], fix["losses"], rtol=5e-3)
    for t in range(N_STEPS):  # a first step's undecided sign carries on
        assert_adam_moves_close(traj[t] - walk0, fix["walk_traj"][t] - walk0, None,
                                jax_first_step[2], walk0, LR, steps=t + 1)


def test_step_on_cpu_counts_no_kernel_launch_and_leaves_the_walk_grad():
    ops.reset_launches()
    metrics, _, _, _ = _port_run(1)
    assert all(np.isfinite(metrics[0][k]) for k in TERMS)
    assert set(ops.launch_counts().values()) == {0}


def test_sample_epoch_z_and_alpha_seed_bit_match_jax():
    for seed in (0, 3):
        np.testing.assert_array_equal(T.sample_epoch_z(10, 16, seed),
                                      jtrain.sample_epoch_z(10, 16, seed))
    for seed, epoch in ((0, 0), (0, 5), (7, 2)):
        assert T._alpha_seed(seed, epoch) == jtrain._alpha_seed(seed, epoch)


@pytest.mark.parametrize("name", ["face", "scene"])
def test_host_sampler_bit_matches_jax_and_device_sampler_statistics(name):
    port = tasks.get_task(name)
    ref = {"face": jtasks.FaceTransform, "scene": jtasks.SceneTransform}[name]()
    a = port.train_alpha_np(np.random.RandomState(5), 3, 2)
    b = ref.train_alpha_np(np.random.RandomState(5), 3, 2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    gen = torch.Generator().manual_seed(0)
    slider, alpha = port.train_alpha(gen, 4, 3)
    assert slider.shape == (4, 3) and torch.equal(slider, alpha.expand(4, 3))
    draws = torch.stack([port.train_alpha(gen, 1, 3)[1] for _ in range(2000)])
    assert float(draws.min()) >= port.lo and float(draws.max()) <= port.hi
    assert abs(float(draws.mean()) - (port.lo + port.hi) / 2) < 0.03


def _tiny_editor(*flags):
    import warnings

    from latent2im_tpu_torch.config.options import TrainOptions
    from latent2im_tpu_torch.engine.build import build_editor_from_options

    conf = TrainOptions().parse(["--attrList", "Smiling", "--dev_tiny",
                                 "--resolution", "16", "--models_dir", "unused",
                                 *flags], print_opt=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_editor_from_options(conf, device="cpu")


def test_train_loop_resumes_to_the_same_walk_and_stops_on_the_flag():
    task = tasks.get_task("face")
    run = dict(num_samples=4, batch_size=2, lr=1e-3, seed=3)
    ed, walk, _ = _tiny_editor()
    w0 = walk["w"].clone()
    seen = []
    walk, hist = T.train_loop(ed, task, walk, n_epochs=2, log_every=1,
                              on_step=lambda e, i, m, dt, wp: seen.append((e, i)),
                              **run)
    assert seen == [(0, 0), (0, 1), (1, 0), (1, 1)] and len(hist) == 4
    assert all(np.isfinite(hist)) and float((walk["w"].detach() - w0).abs().max()) > 0
    # epoch 0, then a resume at epoch 1 from the saved walk and Adam state
    ed2, walk2, _ = _tiny_editor()
    saved = {}
    walk2, _ = T.train_loop(ed2, task, walk2, n_epochs=1, log_every=0,
                            on_epoch_end=lambda e, wp, st: saved.update(st=st),
                            **run)
    walk2, _ = T.train_loop(ed2, task, walk2, n_epochs=2, start_epoch=1,
                            opt_state=saved["st"], log_every=0, **run)
    torch.testing.assert_close(walk2["w"], walk["w"], rtol=0, atol=0)
    # host alphas: one draw per step from the epoch's RandomState
    targets = []
    T.train_loop(ed2, task, walk2, n_epochs=1, host_alpha=True, log_every=0,
                 on_step=lambda e, i, m, dt, wp: targets.append(m["alpha_target_mean"]),
                 **run)
    rng = np.random.RandomState(T._alpha_seed(run["seed"], 0))
    want = [task.train_alpha_np(rng, 2, 1)[1][0] for _ in targets]
    np.testing.assert_allclose(targets, want, rtol=1e-6)
    # stop_flag trips before the first step
    called = []
    T.train_loop(ed2, task, walk2, n_epochs=1, stop_flag=lambda: True,
                 on_preempt=lambda e, wp, st: called.append(e), **run)
    assert called == [0]


def test_build_flags():
    ed, _, _ = _tiny_editor("--no_gan_loss", "--no_content_loss", "--stable_bce",
                            "--fixed_noise")
    assert ed.d is None and ed.vgg is None
    assert ed.cfg.stable_bce and ed.cfg.fixed_noise and ed.cfg.no_gan_loss
    ed, _, _ = _tiny_editor()
    assert isinstance(ed.d, sg2.Discriminator) and isinstance(ed.vgg, vggm.VGG19Features)
    assert not any(p.requires_grad for m in (ed.g, ed.reg, ed.vgg, ed.d)
                   for p in m.parameters())
    assert ed.cfg.compute_dtype == torch.float32
    ed, _, _ = _tiny_editor("--bf16")
    assert ed.cfg.compute_dtype == torch.bfloat16
    for flags, want in ((("--remat_g",), {"remat_g": "all"}),
                        (("--remat_g", "block", "--remat_towers"),
                         {"remat_g": "block", "remat_towers": True}),
                        (("--reg_input_size", "8", "--content_input_size", "8"),
                         {"reg_input_size": 8, "content_input_size": 8})):
        ed, _, _ = _tiny_editor(*flags)
        assert {k: getattr(ed.cfg, k) for k in want} == want


def test_build_loads_d_from_g_path_and_vgg_from_vgg_path(tmp_path):
    from latent2im_tpu_torch.config.options import TrainOptions
    from latent2im_tpu_torch.engine.build import build_editor_from_options

    tg, td, tr, tvgg, _, _, _ = _build_world()
    torch.save({"g_ema": tg.state_dict(), "d": td.state_dict()}, tmp_path / "g.pt")
    torch.save(tvgg.state_dict(), tmp_path / "vgg.pt")
    conf = TrainOptions().parse(
        ["--attrList", "Smiling", "--resolution", str(SIZE), "--models_dir",
         "unused", "--g_path", str(tmp_path / "g.pt"), "--vgg_path",
         str(tmp_path / "vgg.pt")], print_opt=False)
    with pytest.warns(UserWarning, match="reg_path"):
        ed, _, info = build_editor_from_options(conf, device="cpu")
    assert info["pretrained"] == {"g": True, "reg": False, "d": True, "vgg": True}
    sd = ed.d.state_dict()
    for k, v in sg2.strip_blur_kernels(td.state_dict()).items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
    torch.testing.assert_close(ed.vgg.state_dict()["features.0.weight"],
                               tvgg.state_dict()["0.weight"], rtol=0, atol=0)
    img = torch.from_numpy(np.random.RandomState(0).randn(2, SIZE, SIZE, 3)
                           .astype(np.float32))
    with torch.no_grad():
        want = td(img.permute(0, 3, 1, 2)).numpy()
        np.testing.assert_allclose(ed.discriminate(img).numpy(), want,
                                   rtol=1e-4, atol=1e-5)
    assert jvgg.CONTENT_TAPS == vggm.CONTENT_TAPS
