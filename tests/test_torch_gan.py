"""The joint GAN fine-tune (``--updateGAN``) of the port
(latent2im_tpu_torch/engine/gan.py, cli/train.py:make_g_apply) against the
JAX package's ``engine/gan.py:make_gan_update_steps``, on the CPU.

The world is the JAX package's GAN test size (tests/test_gan_training.py:
16 px, style dim 16, 8 channels, 2 MLP layers): JAX-initialised G and D
(their 1-D leaves moved off zero, the noise weights 0.3, so every leaf,
the noise maps too, has a gradient), carried into the port with
io/convert.py and strict loads. The JAX steps run with an optimizer that
keeps the gradient as its state and moves nothing, so each leaf's gradient
comes out of the JAX package's own jitted step; the port's come from an
Adam pre-step hook. Both take the same z, real images and eps (JAX's).
Gates:

- losses and the EMA: tests/helpers.py:assert_close's f32 gate;
- every D and G gradient leaf over the plain generator: relative L2 1e-4,
  max-abs 1e-4 of the leaf's largest entry (the penalty's gate in
  tests/test_torch_double_grad.py);
- the parameters after Adam (betas (0, 0.999): a first step is about
  -lr * sign(g)) only where |g| is above 1e-3 of the leaf's largest entry:
  below, f32 noise may flip the sign of a gradient near zero;
- through the editor's g_apply, which runs the ResNet-50 regressor: the
  walk step's gates of tests/test_torch_train.py (loss rtol 1e-4; the
  gradients elementwise rtol 5e-2, atol 2e-6 of the leaf's largest entry).
"""

import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from helpers import assert_close
from latent2im_tpu.cli import train as jcli
from latent2im_tpu.engine import gan as jgan
from latent2im_tpu.engine.editor import Editor as JEditor
from latent2im_tpu.engine.editor import EditorConfig as JEditorConfig
from latent2im_tpu.models import resnet as jrn
from latent2im_tpu.models import stylegan2 as jsg2
from latent2im_tpu_torch import ops
from latent2im_tpu_torch.cli import train as tcli
from latent2im_tpu_torch.engine import gan
from latent2im_tpu_torch.engine.editor import Editor, EditorConfig
from latent2im_tpu_torch.io import convert
from latent2im_tpu_torch.models import resnet as rn
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.utils import image as imgmod

TINY = {4: 8, 8: 8, 16: 8}
SIZE, STYLE, N_MLP, BATCH, LR = 16, 16, 2, 4, 1e-4
ATTR_LIST, ATTR_IDX, N_REG_OUT = ("Smiling",), (31,), 40


def _capture():
    """An optax transform whose state is the last gradient and whose update
    is zero: the JAX step then returns its gradient as the new state."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(init=zeros,
                                        update=lambda u, s, p=None: (zeros(u), u))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def world():
    """JAX G and D trees and the step's inputs (z, real, eps)."""
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    g = _np_tree(jax.jit(lambda k: jsg2.init_generator(
        k, SIZE, style_dim=STYLE, n_mlp=N_MLP, channels=TINY))(kg))
    d = _np_tree(jax.jit(lambda k: jsg2.init_discriminator(k, SIZE, channels=TINY))(kd))
    rng = np.random.RandomState(1)

    def off_zero(path, a):
        if getattr(path[-1], "key", None) == "noise_w":
            return np.full_like(a, 0.3)
        return a + 0.1 * rng.randn(*a.shape).astype(np.float32) if a.ndim == 1 else a

    g = jax.tree_util.tree_map_with_path(off_zero, g)
    d = jax.tree_util.tree_map_with_path(off_zero, d)
    z = rng.randn(BATCH, STYLE).astype(np.float32)
    real = (0.5 * rng.randn(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    eps = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (BATCH, 1, 1, 1)))
    return {"g": g, "d": d, "z": z, "real": real, "eps": eps}


def port_module(world):
    """The port's G and D loaded from the JAX trees, frozen as the editor
    holds them, in a GANModule at the CLI's default lr."""
    g = sg2.Generator(SIZE, STYLE, N_MLP, channels=TINY)
    g.load_state_dict(convert.generator_from_jax(world["g"]), strict=True)
    d = sg2.Discriminator(SIZE, channels=TINY)
    d.load_state_dict(convert.discriminator_from_jax(world["d"]), strict=True)
    return gan.GANModule.create(g.requires_grad_(False), d.requires_grad_(False), lr=LR)


def recorded_grads(opt, names):
    """Record {name: gradient} at each step of ``opt`` (a pre-step hook)."""
    out = {}

    def hook(optimizer, args, kwargs):
        params = optimizer.param_groups[0]["params"]
        out.update({n: p.grad.detach().clone() for n, p in zip(names, params)})

    opt.register_step_pre_hook(hook)
    return out


def jax_steps(g_apply, d_apply):
    return jgan.make_gan_update_steps(g_apply, d_apply, _capture(), _capture())


@pytest.fixture(scope="module")
def jax_plain(world):
    """The JAX package's d_step and g_step (with and without a target) over
    generator_forward: gradients, metrics, and the JAX Adam + EMA after the
    G step (optax.adam on JAX's gradient, ema_accumulate)."""
    d_step, g_step = jax_steps(lambda gp, z: jsg2.generator_forward(gp, z),
                               lambda dp, img: jsg2.discriminator_forward(dp, img))
    g, d = world["g"], world["d"]
    _, d_grads, dm = d_step(d, _capture().init(d), g, world["z"], world["real"],
                            jax.random.PRNGKey(3))
    out = {"d_grads": _np_tree(d_grads), "d_metrics": {k: float(v) for k, v in dm.items()}}
    rng = np.random.RandomState(2)
    target = rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    mask = (rng.uniform(size=(BATCH, SIZE, SIZE, 1)) > 0.3).astype(np.float32)
    for name, tm in (("plain", (None, None)), ("target", (target, mask))):
        _, g_grads, _, gm = g_step(g, _capture().init(g), g, d, world["z"], *tm)
        adam = optax.adam(LR, b1=0.0, b2=0.999)
        upd, _ = adam.update(g_grads, adam.init(g), g)
        g_new = optax.apply_updates(g, upd)
        out[name] = {"grads": _np_tree(g_grads), "g_loss": float(gm["g_loss"]),
                     "g_new": _np_tree(g_new),
                     "g_running": _np_tree(jgan.ema_accumulate(g, g_new, 0.999)),
                     "target": tm}
    d_adam = optax.adam(LR, b1=0.0, b2=0.999)
    upd, _ = d_adam.update(d_grads, d_adam.init(d), d)
    out["d_new"] = _np_tree(optax.apply_updates(d, upd))
    return out


def assert_grads_match(got: dict, want: dict, tag: str):
    assert set(got) == set(want), (tag, set(got) ^ set(want))
    for name, ref in want.items():
        ref, val = ref.numpy(), got[name].numpy()
        assert np.abs(ref).max() > 0, (tag, name)
        rel = np.linalg.norm(val - ref) / np.linalg.norm(ref)
        assert rel <= 1e-4, (tag, name, rel)
        assert np.abs(val - ref).max() <= 1e-4 * np.abs(ref).max(), (tag, name)


def assert_stepped_params_match(module, want_sd: dict, grads: dict, tag: str):
    """After Adam, where |g| is above 1e-3 of the leaf's largest entry."""
    for name, p in module.named_parameters():
        g = grads[name].numpy()
        sel = np.abs(g) > 1e-3 * np.abs(g).max()
        assert sel.any(), (tag, name)
        assert_close(p.detach().numpy()[sel], want_sd[name].numpy()[sel])


def test_d_step_matches_jax(world, jax_plain):
    mod = port_module(world)
    names = [n for n, _ in mod.d.named_parameters()]
    grads = recorded_grads(mod.d_opt, names)
    d_step, _ = gan.make_gan_update_steps(lambda z: mod.g(z), mod.d, mod)
    ops.reset_launches()
    m = d_step(torch.from_numpy(world["z"]), torch.from_numpy(world["real"]),
               eps=torch.tensor(world["eps"]))
    assert set(ops.launch_counts().values()) == {0}  # CPU: the plain versions
    assert_close(m["d_loss"].item(), jax_plain["d_metrics"]["d_loss"])
    assert_close(m["grad_penalty"].item(), jax_plain["d_metrics"]["grad_penalty"])
    want = convert.discriminator_from_jax(jax_plain["d_grads"])
    assert_grads_match(grads, want, "D")
    assert_stepped_params_match(mod.d, convert.discriminator_from_jax(jax_plain["d_new"]),
                                want, "D")
    # D frozen again for the walk step; G untouched
    assert not any(p.requires_grad for p in mod.d.parameters())
    for n, p in mod.g.named_parameters():
        assert torch.equal(p, mod.g_running[n]), n


@pytest.mark.parametrize("case", ["plain", "target"])
def test_g_step_matches_jax(world, jax_plain, case):
    want = jax_plain[case]
    mod = port_module(world)
    names = [n for n, _ in mod.g.named_parameters()]
    assert sum(n.startswith("noises.") for n in names) == len(world["g"]["noises"])
    grads = recorded_grads(mod.g_opt, names)
    d_before = {n: p.clone() for n, p in mod.d.named_parameters()}
    _, g_step = gan.make_gan_update_steps(lambda z: mod.g(z), mod.d, mod)
    target, mask = (None, None) if want["target"][0] is None else \
        (torch.from_numpy(t) for t in want["target"])
    m = g_step(torch.from_numpy(world["z"]), target, mask)
    assert_close(m["g_loss"].item(), want["g_loss"])
    ref = convert.generator_from_jax(want["grads"])
    assert_grads_match(grads, ref, f"G {case}")  # the noise maps and styled convs too
    assert_stepped_params_match(mod.g, convert.generator_from_jax(want["g_new"]), ref, case)
    running = convert.generator_from_jax(want["g_running"])
    for n, t in mod.g_running.items():
        assert_close(t.numpy(), running[n].numpy())
        assert not torch.equal(t, dict(mod.g.named_parameters())[n]), n
    for n, p in mod.d.named_parameters():
        assert torch.equal(p, d_before[n]), n
    assert not any(p.requires_grad for p in mod.g.parameters())


def test_ema_accumulate_matches_jax():
    rng = np.random.RandomState(4)
    shadow = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    params = {k: rng.randn(*v.shape).astype(np.float32) for k, v in shadow.items()}
    want = jgan.ema_accumulate(shadow, params, 0.999)
    got = gan.ema_accumulate({k: torch.from_numpy(v.copy()) for k, v in shadow.items()},
                             {k: torch.from_numpy(v) for k, v in params.items()}, 0.999)
    for k in shadow:
        assert_close(got[k].numpy(), np.asarray(want[k]))


def test_adam_is_optax_adam():
    """torch Adam with make_adam's settings updates as optax.adam(b1=0,
    b2=0.999) over three steps of the same gradients."""
    rng = np.random.RandomState(5)
    params = [rng.randn(4, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    grads = [[(s * rng.randn(*p.shape)).astype(np.float32) for p in params]
             for s in (1.0, 1e-3, 10.0)]
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = gan.make_adam(tp, LR)
    jopt = optax.adam(LR, b1=0.0, b2=0.999)
    jp, st = list(params), jopt.init(list(params))
    for gs in grads:
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g)
        opt.step()
        upd, st = jopt.update(gs, st, jp)
        jp = optax.apply_updates(jp, upd)
    for p, q in zip(tp, jp):
        assert_close(p.numpy(), np.asarray(q), rtol=1e-6, atol=1e-7)


def test_styled_conv_gradcheck_with_the_weight():
    gen = torch.Generator().manual_seed(3)

    def r(*s):
        return torch.randn(s, generator=gen, dtype=torch.float64)

    operands = (r(2, 4, 4, 2), r(3, 3, 2, 3) / 3.0, 1.0 + 0.2 * r(2, 2),
                1.0 + 0.2 * r(2, 3), r(1, 4, 4), torch.full((1,), 0.3, dtype=torch.float64),
                r(3))
    operands = tuple(t.requires_grad_(True) for t in operands)
    assert torch.autograd.gradcheck(lambda *a: ops.styled_conv3x3(*a), operands,
                                    fast_mode=True)
    # the noise map's gradient keeps its [1, H, W] shape
    out = ops.styled_conv3x3(*operands)
    gnoise = torch.autograd.grad(out.sum(), operands[4])[0]
    assert gnoise.shape == (1, 4, 4)


def test_generator_weight_gradient_survives_block_remat(world):
    """G's gradient (the styled convs' weights and the noise maps with it)
    through synthesize(..., block_remat=True) equals the plain one."""
    mod = port_module(world)
    g = mod.g.requires_grad_(True)
    z = torch.from_numpy(world["z"])
    names, params = zip(*g.named_parameters())

    def grads(remat):
        lat = g.style_forward(z)[:, None].expand(-1, g.n_latent, -1)
        return torch.autograd.grad(g.synthesize(lat, block_remat=remat).square().sum(),
                                   params)

    grads = [grads(r) for r in (False, True)]
    for n, a, b in zip(names, *grads):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=n)


# ---------------------------------------------------------------------------
# the CLI's g_apply: through the editor, the walk and the ResNet-50
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def editor_world(world, tmp_path_factory):
    """The JAX CLI's own g_apply and d_apply (taken from its
    _make_gan_provider), the JAX editor's inputs, and the port's editor on
    the same weights."""
    reg = _np_tree(jax.jit(lambda k: jrn.init_resnet50(k, num_outputs=N_REG_OUT))(
        jax.random.PRNGKey(7)))
    rng = np.random.RandomState(8)
    walk0 = (0.3 * rng.randn(1, jsg2.n_latent(SIZE), STYLE)).astype(np.float32)
    alpha = rng.uniform(0, 1, (BATCH, 1)).astype(np.float32)
    jcfg = JEditorConfig(latent="w", walk_kind="linear_w", attr_list=ATTR_LIST,
                         attr_idx=ATTR_IDX, size=SIZE, dim_z=STYLE, alpha_mode="target")
    jed = JEditor(jcfg, world["g"], reg, d_params=world["d"])
    real_dir = tmp_path_factory.mktemp("real")
    with open(real_dir / "a.png", "wb") as f:
        f.write(imgmod.png_bytes(np.zeros((SIZE, SIZE, 3), np.uint8)))
    opt = types.SimpleNamespace(gan_lr=LR, output_dir=str(real_dir), resume=False,
                                real_data_dir=str(real_dir), batch_size=BATCH)
    seen = {}
    real_make = jgan.make_gan_update_steps

    def recording(g_apply, d_apply, *a, **kw):
        seen.update(g_apply=g_apply, d_apply=d_apply)
        return real_make(g_apply, d_apply, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgan, "make_gan_update_steps", recording)
        jcli._make_gan_provider(jed, opt, None, {"walk": None},
                                types.SimpleNamespace())
    batch = {"z": jnp.asarray(world["z"]), "alpha": jnp.asarray(alpha),
             "walk": {"w": jnp.asarray(walk0)}, "reg": jed.reg_params}
    port_mod = port_module(world)
    r = rn.ResNet50(num_outputs=N_REG_OUT)
    r.load_state_dict(convert.resnet50_from_jax(reg), strict=True)
    cfg = EditorConfig(attr_list=ATTR_LIST, attr_idx=ATTR_IDX, size=SIZE, dim_z=STYLE)
    ed = Editor(cfg, port_mod.g, r, "cpu", d=port_mod.d)
    port_batch = {"z": torch.from_numpy(world["z"]), "alpha": torch.from_numpy(alpha),
                  "walk": {"w": torch.from_numpy(walk0)}}
    return seen, batch, ed, port_batch


def test_cli_g_apply_and_g_step_through_the_editor_match_jax(world, editor_world):
    seen, batch, ed, port_batch = editor_world
    want_img = np.asarray(jax.jit(seen["g_apply"])(world["g"], batch))
    got_img = tcli.make_g_apply(ed)(port_batch)
    assert_close(got_img.detach().numpy(), want_img)
    _, g_step = jax_steps(seen["g_apply"], seen["d_apply"])
    g = world["g"]
    _, want_grads, _, gm = g_step(g, _capture().init(g), g, world["d"], batch, None, None)
    mod = gan.GANModule.create(ed.g, ed.d, lr=LR)
    names = [n for n, _ in ed.g.named_parameters()]
    grads = recorded_grads(mod.g_opt, names)
    _, port_g_step = gan.make_gan_update_steps(tcli.make_g_apply(ed), ed.discriminate, mod)
    m = port_g_step(port_batch)
    np.testing.assert_allclose(m["g_loss"].item(), float(gm["g_loss"]), rtol=1e-4)
    want = convert.generator_from_jax(_np_tree(want_grads))
    for n in names:
        ref = want[n].numpy()
        np.testing.assert_allclose(grads[n].numpy(), ref, rtol=5e-2,
                                   atol=2e-6 * np.abs(ref).max(), err_msg=n)
