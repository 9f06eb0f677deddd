"""The port's W+ inversion (latent2im_tpu_torch/engine/inversion.py, the
VGG16 tower, cli/bp.py) against the JAX package, on the CPU.

Shared weights: a JAX G (32 px, style dim 32, 2 MLP layers, 8-16 channels)
and a JAX VGG16, mapped into the port with io/convert.py and loaded with
strict=True. Tolerances: VGG16 taps and grams rtol 1e-5 / atol 1e-6 of
scale (f32 convolutions summed in another order); the gram loss rtol 1e-4
(a C^2-weighted sum of squared differences of nearly equal grams); W+ from
init_w 1e-5; the inverter over 5 loops at lr 5e-2: loss history rtol 1e-4,
final W+ within 1e-4 of the distance it moved (Adam divides by sqrt(v), so
a rounding-level gradient difference reaches the update at its own
relative size, and five steps compound it).
"""

import functools
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_cli import one_torch_thread  # noqa: F401 (autouse: one torch thread)

from latent2im_tpu.engine import inversion as jinv
from latent2im_tpu.models import stylegan2 as jsg2
from latent2im_tpu.models import vgg as jvgg
from latent2im_tpu_torch.engine import inversion as inv
from latent2im_tpu_torch.io import convert
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.models import vgg as vggm

SIZE, DIM, N_MLP = 32, 32, 2
CHANNELS = {4: 16, 8: 16, 16: 8, 32: 8}
NL = jsg2.n_latent(SIZE)
LOOPS, LR, BATCH = 5, 5e-2, 2


@pytest.fixture(scope="module")
def world():
    # jitted: eager JAX takes ~20 s over these inits and the synthesis
    jg = jax.jit(functools.partial(jsg2.init_generator, size=SIZE, style_dim=DIM,
                                   n_mlp=N_MLP, channels=CHANNELS))(jax.random.PRNGKey(0))
    jv = {"cfg": "vgg16",
          "convs": jax.jit(lambda k: jvgg.init_vgg(k, "vgg16")["convs"])(jax.random.PRNGKey(1))}
    g = sg2.Generator(SIZE, DIM, N_MLP, channels=CHANNELS)
    g.load_state_dict(convert.generator_from_jax(jax.tree_util.tree_map(np.asarray, jg)),
                      strict=True)
    v = vggm.VGG16Features()
    v.load_state_dict(convert.vgg_from_jax(
        {"cfg": "vgg16", "convs": jax.tree_util.tree_map(np.asarray, jv["convs"])}),
        strict=True)
    # a target G made, with one W per sample
    z = np.random.RandomState(3).randn(BATCH, DIM).astype(np.float32)
    target = np.array(jax.jit(lambda p, z: jsg2.synthesize(
        p, jnp.repeat(jsg2.style_forward(p, z)[:, None, :], NL, axis=1)))(jg, jnp.asarray(z)))
    return {"jg": jg, "jv": jv, "g": g.requires_grad_(False),
            "v": v.requires_grad_(False), "target": target}


def _close_to_scale(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), err


def test_vgg16_taps_grams_and_gram_loss_match_jax(world):
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    want = jvgg.vgg_features(world["jv"], jnp.asarray(x), jvgg.VGG16_GRAM_TAPS)
    got = world["v"](torch.from_numpy(x), vggm.VGG16_GRAM_TAPS)
    assert vggm.VGG16_GRAM_TAPS == jvgg.VGG16_GRAM_TAPS
    for tap in jvgg.VGG16_GRAM_TAPS:
        f = got[tap].permute(0, 2, 3, 1)
        _close_to_scale(f.numpy(), want[tap], 1e-5)
        _close_to_scale(vggm.gram_matrix(f).numpy(), jvgg.gram_matrix(want[tap]), 1e-5)
    np.testing.assert_allclose(
        inv.gram_perceptual_bp(world["v"], torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jinv.gram_perceptual_bp(world["jv"], jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-4)
    np.testing.assert_allclose(
        inv.nll_pixel_loss(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jinv.nll_pixel_loss(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6)


def test_vgg16_loads_a_torchvision_state_dict_strict():
    src = vggm.VGG16Features(generator=torch.Generator().manual_seed(0))
    sd = {f"features.{k}": v for k, v in src.features.state_dict().items()}
    sd["classifier.0.weight"] = torch.zeros(4, 4)  # dropped, as torchvision's head
    dst = vggm.VGG16Features()
    dst.load_state_dict(vggm.features_state_dict(sd), strict=True)
    assert [k for k in dst.state_dict() if k.endswith("weight")][-1] == "features.28.weight"
    bare = {k[len("features."):]: v for k, v in sd.items() if k.startswith("features.")}
    dst.load_state_dict(vggm.features_state_dict(bare), strict=True)


def test_init_w_matches_jax_on_the_same_z(world):
    init_w, _, _ = jinv.make_inverter(world["jg"], world["jv"], NL)
    key = jax.random.PRNGKey(7)
    want = np.asarray(init_w(key, 3))
    z = np.array(jax.random.normal(key, (4096, DIM), jnp.float32))  # as mean_latent draws
    p_init, _, _ = inv.make_inverter(world["g"], world["v"], NL, device="cpu")
    got = p_init(3, z=z)
    assert got.shape == (3, NL, DIM)
    _close_to_scale(got.numpy(), want, 1e-5)
    # drawn from a generator: the same shape, every sample and layer equal
    w = p_init(2, torch.Generator().manual_seed(0))
    assert w.shape == (2, NL, DIM) and torch.equal(w, w[:1, :1].expand_as(w))


@pytest.mark.parametrize("optim", ["Adam", "GD"])
def test_inverter_steps_match_jax(world, optim):
    init_w, step, tx = jinv.make_inverter(world["jg"], world["jv"], NL, lr=LR, optim=optim)
    target = jnp.asarray(world["target"])
    w = init_w(jax.random.PRNGKey(0), BATCH)
    w0 = np.asarray(w)
    state, want_hist = tx.init(w), []
    for _ in range(LOOPS):
        w, state, loss, _ = step(w, state, target)
        want_hist.append(float(loss))

    _, p_step, p_opt = inv.make_inverter(world["g"], world["v"], NL, lr=LR, optim=optim,
                                         device="cpu")
    pw = torch.from_numpy(w0.copy()).requires_grad_(True)
    pstate, hist = p_opt(pw), []
    grams = inv.target_grams(world["v"], torch.from_numpy(world["target"]))
    for i in range(LOOPS):
        pw, pstate, loss, out = p_step(pw, pstate, torch.from_numpy(world["target"]),
                                       grams if i % 2 else None)  # either way
        hist.append(loss.item())
    assert out.shape == (BATCH, SIZE, SIZE, 3)
    np.testing.assert_allclose(hist, want_hist, rtol=1e-4)
    moved = np.abs(np.asarray(w) - w0).max()
    assert moved > 0
    np.testing.assert_allclose(pw.detach().numpy(), np.asarray(w), rtol=0, atol=1e-4 * moved)


def test_invert_drives_the_loss_down_and_reports_each_show_freq(world):
    """The JAX package's property (tests/test_eval_inversion.py:150): an
    image G made inverts with a falling loss."""
    seen = []
    w, out, hist = inv.invert(world["g"], world["v"], world["target"], NL, n_loops=30,
                              lr=LR, show_freq=10, device="cpu",
                              on_loop=lambda loop, lv, o: seen.append((loop, lv)))
    assert [s[0] for s in seen] == [10, 20, 30] and len(hist) == 30
    assert all(np.isfinite(hist)) and hist[-1] < hist[0], hist
    assert seen[-1][1] == pytest.approx(hist[-1])
    assert w.shape == (BATCH, NL, DIM) and out.shape == (BATCH, SIZE, SIZE, 3)


def test_bp_cli_writes_the_jax_files_and_vis_w_edits_its_latents(tmp_path):
    """As tests/test_cli_e2e.py:142 and :222: bp on two PNGs at 32 px
    --dev_tiny, then vis_w --latents_dir on what it wrote."""
    from latent2im_tpu_torch.cli import bp
    from latent2im_tpu_torch.cli.vis_w import run as vis_run
    from latent2im_tpu_torch.config.options import TrainOptions, VisOptions
    from latent2im_tpu_torch.utils.image import png_bytes

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(2):
        arr = np.random.RandomState(i).randint(0, 255, (40, 48, 3), np.uint8)
        (img_dir / f"f{i}.png").write_bytes(png_bytes(arr))
    save = tmp_path / "bp"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bp.main(["--img_dir", str(img_dir), "--save_dir", str(save), "--resolution",
                 str(SIZE), "--n_loops", "5", "--show_freq", "5", "--dev_tiny",
                 "--batch_size", "2"], device="cpu")
    for f in ("org_0.png", "0_iterations_5.png", "0_final.png", "0_loss.npy"):
        assert os.path.isfile(save / f), f
    w = np.load(save / "latent" / "0_w.npy")
    assert w.shape == (2, NL, DIM) and w.dtype == np.float32
    curve = np.load(save / "0_loss.npy")
    assert curve.shape == (5,) and curve.dtype == np.float64 and np.isfinite(curve).all()
    with pytest.MonkeyPatch.context() as mp, \
            pytest.raises(RuntimeError, match="no CUDA device"):
        mp.setattr(torch.cuda, "is_available", lambda: False)
        bp.main(["--img_dir", str(img_dir), "--save_dir", str(save)])  # cuda by default

    opt = TrainOptions().parse(
        ["--transform", "face", "--attrList", "Smiling", "--models_dir",
         str(tmp_path / "m"), "--overwrite_config", "--dev_tiny", "--resolution",
         str(SIZE)], print_opt=True)  # writes the opt.yml vis_w reads
    vopt, conf = VisOptions().parse(
        [os.path.join(opt.output_dir, "opt.yml"), "--latents_dir", str(save / "latent"),
         "--output_dir", str(tmp_path / "vis"), "--num_panels", "3"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out_dir = vis_run(vopt, conf, device="cpu")
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    assert [p[:8] for p in pngs] == ["sample0_", "sample1_"], pngs
