"""--bf16 in the port against the JAX package's bf16 compute
(``compute_dtype=jnp.bfloat16``), on the CPU, where each kernel wrapper runs
its plain PyTorch version (the card's kernels compute the same, up to the
order of the sums: tests/test_torch_cuda.py and chip_smoke.py hold them to
it). Inputs come from numpy seeds; the port's weights come from the JAX
pytrees through io/convert.py (or the torch oracles through the JAX
package's converters). The Pallas kernels run in interpret mode, as
tests/test_torch_ops.py runs them.

Gates, each stated where it is used:
- kernel modules against the Pallas kernel on bf16 inputs: max-abs within
  2^-7 of max|want| (one bf16 ulp either side of a rounding boundary);
- the plain bf16 styled conv against f64 on the same bf16-rounded
  operands: 2^-8 of max|want| (one rounding of an exact-enough sum);
- modules, towers and images against JAX's bf16: relative L2 < 2e-2 and
  max-abs < 2% of max|want| (tests/helpers.py's TPU-class gates, applied
  here on the CPU: the two frameworks round bf16 at other places); losses
  within 2e-2 relative;
- the walk gradient: relative L2 within max(2e-2, 2 x the distance between
  JAX's own bf16 and f32 gradients at the same inputs), which the test
  prints;
- where JAX's own bf16 result lies further than those fixed gates from its
  f32 result at the same inputs, the walk gradient's rule holds for it too:
  within 2 x that distance (relative L2, max-abs, or the loss's relative
  error), and the port's bf16 as near the JAX f32 result. That is D's
  logits (a near-zero sum of cancelling terms: JAX's bf16 lies ~6% from
  its f32 there), an edit driven by the bf16 scores (~4%) and the step's
  content loss between two nearly equal images. Each such test prints
  both distances.
"""

import importlib
import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from latent2im_tpu.engine import losses as jL
from latent2im_tpu.engine import train as jtrain
from latent2im_tpu.engine.editor import Editor as JEditor
from latent2im_tpu.engine.editor import EditorConfig as JEditorConfig
from latent2im_tpu.io import torch_convert as tc
from latent2im_tpu.models import pggan as jpgg
from latent2im_tpu.models import resnet as jrn
from latent2im_tpu.models import stylegan2 as jsg2
from latent2im_tpu.models import vgg as jvgg
from latent2im_tpu.ops import make_kernel as j_make_kernel
from latent2im_tpu.ops import pair_conv
from latent2im_tpu.ops.pallas_kernels import upfirdn2d_pallas
from latent2im_tpu.tasks import transforms as jtasks
from latent2im_tpu_torch import ops
from latent2im_tpu_torch.engine import gan
from latent2im_tpu_torch.engine import losses as L
from latent2im_tpu_torch.engine import train as T
from latent2im_tpu_torch.engine.editor import Editor, EditorConfig
from latent2im_tpu_torch.io import convert
from latent2im_tpu_torch.models import pggan
from latent2im_tpu_torch.models import resnet as rn
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.models import vgg as vggm
from latent2im_tpu_torch.tasks import transforms as tasks
from test_torch_cli import _one_thread, _restoring_logging
from test_torch_gan import _capture, port_module, world  # noqa: F401 (a fixture)
from test_torch_resnet import _np_resnet_tree
from test_torch_stylegan2 import TINY, _perturbed_jax_generator, _port_generator
from test_stylegan2_torch_oracle import CHANNELS as W_CHANNELS
from test_stylegan2_torch_oracle import N_MLP as W_MLP
from test_stylegan2_torch_oracle import SIZE as W_SIZE
from test_stylegan2_torch_oracle import STYLE_DIM as W_DIM
from test_train_dynamics import (ATTR_IDX as W_IDX, ATTR_LIST as W_ATTRS, LR,
                                 N_REG_OUT, _build_world)

BF16, JBF16 = torch.bfloat16, jnp.bfloat16
SIZE, DIM = 32, 32
ATTRS, IDX = ("Smiling", "Young"), (31, 39)
KERNEL_FRAC = 2.0 ** -7  # kernel modules against the Pallas kernel
PLAIN_FRAC = 2.0 ** -8   # the plain bf16 styled conv against f64
TPU_REL_L2 = TPU_MAX_ABS = 0.02  # towers and images (tests/helpers.py)
LOSS_REL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    with _one_thread():
        yield


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _bf(a):
    """numpy f32 -> the nearest bf16 values, as f32 (exact in both)."""
    return _t(a).to(BF16).float().numpy()


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _kernel_close(got, want, frac=KERNEL_FRAC):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert scale > 0 and err <= frac * scale, f"max abs {err:.3e} > {frac:.3e} * {scale:.3e}"


def _tpu_close(got, want, rel_l2=TPU_REL_L2, max_abs=TPU_MAX_ABS):
    """tests/helpers.py:assert_images_close's TPU-class gate."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    rel = np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)
    scale = np.abs(want).max() + 1e-12
    assert rel < rel_l2, f"relative L2 {rel:.4f} >= {rel_l2}"
    assert np.abs(got - want).max() < max_abs * scale, (np.abs(got - want).max(), scale)


def _loss_close(got, want, rel=LOSS_REL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), (got, want)


def _rel_l2(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def _bf16_close(got, want, want_f32, tag=""):
    """The TPU-class gate, widened to 2 x JAX's own bf16 distance from its
    f32 result where that is larger (relative L2 and max-abs); the port's
    bf16 is held as near the JAX f32 result."""
    got, want, want_f32 = _np(got), _np(want), _np(want_f32)
    spread = _rel_l2(want, want_f32)
    rel_l2 = max(TPU_REL_L2, 2.0 * spread)
    max_abs = max(TPU_MAX_ABS * np.abs(want).max(), 2.0 * np.abs(want - want_f32).max())
    print(f"{tag}: port bf16 vs JAX bf16 {_rel_l2(got, want):.3e}, vs JAX f32 "
          f"{_rel_l2(got, want_f32):.3e}; JAX bf16 vs JAX f32 {spread:.3e}")
    for ref in (want, want_f32):
        assert _rel_l2(got, ref) < rel_l2, (tag, _rel_l2(got, ref), rel_l2)
        assert np.abs(got - ref).max() < max_abs, (tag, np.abs(got - ref).max(), max_abs)


def _bf16_loss_close(got, want, want_f32, tag=""):
    """LOSS_REL, widened to 2 x JAX's own bf16 relative error where larger."""
    got, want, want_f32 = float(got), float(want), float(want_f32)
    spread = abs(want - want_f32) / abs(want_f32)
    rel = max(LOSS_REL, 2.0 * spread)
    print(f"{tag}: port bf16 {got:.6g}, JAX bf16 {want:.6g}, JAX f32 {want_f32:.6g}")
    for ref in (want, want_f32):
        assert abs(got - ref) <= rel * abs(ref), (tag, got, ref, rel)


# ---------------------------------------------------------------------------
# kernel modules
# ---------------------------------------------------------------------------

# (name, x shape, up, down, pad, kernel gain): the main path's forms, B=2
UFD_CASES = [
    ("up_conv_blur", (2, 9, 9, 16), 1, 1, (1, 1), 4.0),  # 2H+1 -> 2H after the transposed conv
    ("skip_upsample_rgb", (2, 4, 4, 3), 2, 1, (2, 1), 4.0),  # ToRGB's skip, C=3
    ("skip_upsample_c8", (2, 4, 4, 8), 2, 1, (2, 1), 4.0),
    ("d_blur_pad22", (2, 8, 8, 8), 1, 1, (2, 2), 1.0),  # D's conv2 blur
    ("d_blur_pad11", (2, 8, 8, 16), 1, 1, (1, 1), 1.0),  # D's skip blur
    ("downsample", (2, 8, 8, 8), 1, 2, (1, 1), 1.0),
]


@pytest.mark.parametrize("name,shape,up,down,pad,gain", UFD_CASES,
                         ids=[c[0] for c in UFD_CASES])
def test_upfirdn2d_bf16_and_its_vjp_match_the_pallas_kernel(name, shape, up, down, pad, gain):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    k = j_make_kernel([1, 3, 3, 1]) * np.float32(gain)
    p = (up, up, down, down, pad[0], pad[1], pad[0], pad[1])
    want, vjp = jax.vjp(lambda a: upfirdn2d_pallas(a, jnp.asarray(k), *p),
                        jnp.asarray(x, JBF16))
    assert want.dtype == JBF16
    g = rng.randn(*want.shape).astype(np.float32)
    (want_dx,) = vjp(jnp.asarray(g, JBF16))

    xt = _t(x).to(BF16).requires_grad_(True)
    got = ops.upfirdn2d(xt, k, up=up, down=down, pad=pad)
    assert got.dtype == BF16
    _kernel_close(got, want)
    got.backward(_t(g).to(BF16))
    assert xt.grad.dtype == BF16
    _kernel_close(xt.grad, want_dx)
    # the backward wrapper itself, as the autograd node calls it
    _kernel_close(ops.upfirdn2d_bwd(_t(g).to(BF16), k, up, down, pad, shape[1:3]), want_dx)


def _styled_conv_tree(rng, cin, cout, style_dim=16):
    """One JAX styled-conv tree with every term non-zero."""
    return {"conv": {"w": rng.randn(3, 3, cin, cout).astype(np.float32),
                     "mod": {"w": rng.randn(style_dim, cin).astype(np.float32),
                             "b": (1.0 + 0.1 * rng.randn(cin)).astype(np.float32)}},
            "noise_w": np.float32(0.7), "act_b": (0.1 * rng.randn(cout)).astype(np.float32)}


def _jax_operands(tree, x, style):
    """s and demod as the JAX package's styled conv computes them in x's
    dtype (models/stylegan2.py:138-147), and the scaled weight."""
    p = jax.tree_util.tree_map(jnp.asarray, tree)["conv"]
    k, _, cin, _ = p["w"].shape
    scale = 1.0 / np.sqrt(cin * k * k)
    s = jsg2.equal_linear(p["mod"], style)
    w_sq = jnp.sum(jnp.square(p["w"]), axis=(0, 1))
    demod = jax.lax.rsqrt((scale * scale) * (jnp.square(s) @ w_sq) + 1e-8)
    return s, demod, (p["w"] * scale).astype(x.dtype)


@pytest.mark.parametrize("noise_b", [1, 2, None], ids=["shared", "per_sample", "none"])
def test_styled_conv3x3_bf16_matches_the_pallas_kernel_and_the_xla_form(noise_b):
    rng = np.random.RandomState(1)
    b, h, cin, cout = 2, 8, 16, 16  # the pair kernel is square in channels
    tree = _styled_conv_tree(rng, cin, cout)
    x = jnp.asarray(rng.randn(b, h, h, cin), JBF16)
    style = jnp.asarray(rng.randn(b, 16), JBF16)
    noise = None if noise_b is None else _bf(rng.randn(noise_b, h, h, 1).astype(np.float32))
    s, demod, w = _jax_operands(tree, x, style)
    ops_args = (_t(_np(x)).to(BF16), _t(_np(w)).to(BF16), _t(_np(s)).to(BF16),
                _t(_np(demod)).to(BF16),
                None if noise is None else _t(noise[..., 0]).to(BF16),
                _t(np.float32(tree["noise_w"])).reshape(1), _t(tree["act_b"]))
    got = ops.styled_conv3x3(*ops_args)
    assert got.dtype == BF16

    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    # the XLA form: the port's rounding-for-rounding copy is held tightly,
    # the kernel's numerics (one rounding) to the TPU-class gate
    xla = jsg2.styled_conv(jtree, x, style, None if noise is None else jnp.asarray(noise))
    assert xla.dtype == JBF16
    _kernel_close(ops.styled_conv3x3_xla(*ops_args), xla)
    _tpu_close(got, xla)
    if noise is not None:  # the Pallas pair kernel takes a noise map
        pallas = pair_conv.fused_styled_conv3x3_pair(
            x, w, s.astype(JBF16), demod.astype(JBF16), jnp.asarray(noise),
            jtree["noise_w"], jtree["act_b"])
        _kernel_close(got, pallas)


@pytest.mark.parametrize("cin,noise_b", [(16, 1), (40, 2), (8, None)])
def test_plain_bf16_styled_conv_is_one_rounding_of_the_f64_result(cin, noise_b):
    """What the card's bf16 kernel is held to: an f32 sum of the bf16-valued
    operands A = bf16(x * s) and w, the epilogue in f32, one rounding."""
    gen = torch.Generator().manual_seed(2)
    b, h, cout = 2, 6, 12
    x = torch.randn(b, h, h, cin, generator=gen).to(BF16)
    w = (torch.randn(3, 3, cin, cout, generator=gen) / np.sqrt(9 * cin)).to(BF16)
    s = (1.0 + 0.2 * torch.randn(b, cin, generator=gen)).to(BF16)
    d = (0.5 + torch.rand(b, cout, generator=gen)).to(BF16)
    noise = None if noise_b is None else torch.randn(noise_b, h, h, generator=gen).to(BF16)
    nw, bias = torch.full((1,), 0.3), 0.1 * torch.randn(cout, generator=gen)
    got = ops.styled_conv3x3_plain(x, w, s, d, noise, nw, bias)
    assert got.dtype == BF16
    a64 = (x.float() * s.float()[:, None, None, :]).to(BF16).double()
    want = ops.styled_conv3x3_plain(a64, w.double(), torch.ones_like(s, dtype=torch.float64),
                                    d.double(), None if noise is None else noise.double(),
                                    nw.double(), bias.double())
    _kernel_close(got, want, PLAIN_FRAC)


def test_fused_act_bf16_forward_and_bias_gradient_match_the_pallas_kernel():
    """bf16 activations with an f32 bias (every layer's); db is the sum of
    the bf16 dx over rows, in f32 here (the bias is an f32 master) where
    the TPU kernel's VJP rounds it to bf16 (pallas_kernels.py:131)."""
    from latent2im_tpu.ops.pallas_kernels import fused_leaky_relu_pallas

    rng = np.random.RandomState(3)
    x, b = rng.randn(4, 8, 8, 24).astype(np.float32), rng.randn(24).astype(np.float32)
    g = rng.randn(4, 8, 8, 24).astype(np.float32)
    want, vjp = jax.vjp(fused_leaky_relu_pallas, jnp.asarray(x, JBF16), jnp.asarray(b))
    want_dx, want_db = vjp(jnp.asarray(g, JBF16))
    xt, bt = _t(x).to(BF16).requires_grad_(True), _t(b).requires_grad_(True)
    got = ops.fused_leaky_relu(xt, bt)
    assert got.dtype == BF16
    np.testing.assert_array_equal(_np(got), _np(want))  # one rounding of the same f32
    got.backward(_t(g).to(BF16))
    assert xt.grad.dtype == BF16 and bt.grad.dtype == torch.float32
    np.testing.assert_array_equal(_np(xt.grad), _np(want_dx))
    _kernel_close(bt.grad, want_db)


# ---------------------------------------------------------------------------
# towers and the editor
# ---------------------------------------------------------------------------


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


@pytest.fixture(scope="module")
def towers():
    """JAX trees (G at --dev_tiny widths with its zero terms moved, D with
    its biases moved, a ResNet-50 with BN statistics off the identity,
    VGG19) and the port's modules loaded from them."""
    g_tree = _perturbed_jax_generator(SIZE, TINY, seed=21)
    r_tree = _np_resnet_tree(seed=22)
    rng = np.random.RandomState(23)
    d_tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.randn(*a.shape)).astype(np.float32)
        if a.ndim == 1 else np.asarray(a),
        jax.jit(lambda k: jsg2.init_discriminator(k, SIZE, channels=TINY))(
            jax.random.PRNGKey(24)))
    v_tree = {"cfg": "vgg19", "convs": jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jvgg.init_vgg(k, "vgg19")["convs"])(jax.random.PRNGKey(25)))}
    g = sg2.Generator(SIZE, DIM, 2, channels=TINY)
    g.load_state_dict(convert.generator_from_jax(g_tree), strict=True)
    d = sg2.Discriminator(SIZE, channels=TINY)
    d.load_state_dict(convert.discriminator_from_jax(d_tree), strict=True)
    reg = rn.ResNet50(num_outputs=40)
    reg.load_state_dict(convert.resnet50_from_jax(r_tree), strict=True)
    vgg = vggm.VGG19Features()
    vgg.load_state_dict(convert.vgg_from_jax(v_tree), strict=True)
    return {"g_tree": g_tree, "d_tree": d_tree, "r_tree": r_tree, "v_tree": v_tree,
            "g": g.eval().requires_grad_(False), "d": d.eval().requires_grad_(False),
            "reg": reg.eval().requires_grad_(False), "vgg": vgg.eval().requires_grad_(False)}


def _img(n, seed):
    return (0.6 * np.random.RandomState(seed).randn(n, SIZE, SIZE, 3)).astype(np.float32)


def test_synthesize_bf16_matches_jax(towers):
    rng = np.random.RandomState(26)
    latent = rng.randn(2, sg2.n_latent(SIZE), DIM).astype(np.float32)
    want = jax.jit(lambda p, w: jsg2.synthesize(p, w, dtype=JBF16))(
        _jtree(towers["g_tree"]), latent)
    with torch.no_grad():
        got = towers["g"].synthesize(_t(latent), dtype=BF16)
        f32 = towers["g"].synthesize(_t(latent))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _tpu_close(got, want)
    assert np.abs(_np(got) - _np(f32)).max() > 0  # it did compute in bf16


def test_size_1024_fast_tail_branch_bf16_matches_jax():
    """C.8: the bf16 twin of tests/test_torch_stylegan2.py's 1024 px test
    (8 channels, B=1): JAX's bf16 synthesize runs its s2d FAST_TAIL at 1024
    px, which rounds in other places than the port's direct form; held
    under _bf16_close against JAX's bf16 and f32 images."""
    assert jsg2.FAST_TAIL and jsg2.FAST_TAIL_MAX_CH >= 8 and jsg2.FAST_TAIL_MIN_RES <= 1024
    ch = {2 ** i: 8 for i in range(2, 11)}
    params = _perturbed_jax_generator(1024, ch, seed=7)
    g = _port_generator(params, 1024, ch)
    lat = np.random.RandomState(8).randn(1, 18, 32).astype(np.float32)
    want, want_f32 = (jax.jit(lambda p, w, dt=dt: jsg2.synthesize(p, w, dtype=dt))(
        _jtree(params), lat) for dt in (JBF16, jnp.float32))
    with torch.no_grad():
        got = g.synthesize(_t(lat), dtype=BF16)
    assert got.shape == (1, 1024, 1024, 3)
    _bf16_close(got, want, want_f32, "1024 px fast tail")


def test_discriminator_bf16_matches_jax(towers):
    img = _img(4, 27)
    want, want_f32 = (jax.jit(lambda p, x, dt=dt: jsg2.discriminator_forward(p, x, dtype=dt))(
        _jtree(towers["d_tree"]), img) for dt in (JBF16, jnp.float32))
    with torch.no_grad():
        got = towers["d"](_t(img), dtype=BF16)
    assert got.dtype == torch.float32
    _bf16_close(got, want, want_f32, "D logits")


def test_resnet50_bf16_matches_jax(towers):
    img = _img(2, 28)
    want, _ = jax.jit(lambda p, x: jrn.resnet50_forward(p, x, dtype=JBF16))(
        _jtree(towers["r_tree"]), img)
    with torch.no_grad():
        got = towers["reg"](_t(img), dtype=BF16)
    assert got.dtype == torch.float32
    _tpu_close(got, want)


def test_vgg_content_loss_bf16_matches_jax(towers):
    org, edi = _img(2, 29), _img(2, 30)
    want = jax.jit(lambda convs, a, b: jL.content_loss(
        {"cfg": "vgg19", "convs": convs}, a, b, dtype=JBF16))(
        _jtree(towers["v_tree"]["convs"]), org, edi)
    with torch.no_grad():
        got = L.content_loss(towers["vgg"], _t(org), _t(edi), dtype=BF16)
    assert got.dtype == torch.float32
    _loss_close(got, want)


def test_apply_alpha_bf16_matches_the_jax_editor(towers):
    kw = dict(attr_list=ATTRS, attr_idx=IDX, size=SIZE, dim_z=DIM)
    walk = {"w": (0.5 * np.random.RandomState(31).randn(
        len(ATTRS), sg2.n_latent(SIZE), DIM)).astype(np.float32)}
    z = np.random.RandomState(32).randn(2, DIM).astype(np.float32)
    a = np.asarray([0.2, 0.9], np.float32)
    want, want_f32 = (JEditor(JEditorConfig(compute_dtype=dt, **kw), _jtree(towers["g_tree"]),
                              reg_params=_jtree(towers["r_tree"])).apply_alpha(
        _jtree(walk), z, a) for dt in (JBF16, jnp.float32))
    ted = Editor(EditorConfig(compute_dtype=BF16, **kw), towers["g"], towers["reg"],
                 device="cpu")
    te, ta, to = ted.apply_alpha(convert.walk_from_jax(walk), z, a)
    assert te.dtype == to.dtype == ta.dtype == torch.float32
    _tpu_close(to, want[2])
    _bf16_close(ta, want[1], want_f32[1], "scores")
    _bf16_close(te, want[0], want_f32[0], "edited images")


# ---------------------------------------------------------------------------
# one walk-training step
# ---------------------------------------------------------------------------

TERMS = ("loss", "reg_loss", "content_loss", "gan_loss")


def _jax_step_grad(world, dtype):
    """The JAX make_train_step in ``dtype`` on the torch oracles of
    tests/test_train_dynamics.py (host alphas, stored noise) -> (metrics,
    walk gradient): its optimizer keeps the gradient as its state."""
    tg, td, tr, tvgg, walk0, zs, alphas = world
    cfg = JEditorConfig(latent="w", walk_kind="linear_w", attr_list=W_ATTRS,
                        attr_idx=W_IDX, size=W_SIZE, dim_z=W_DIM,
                        alpha_mode="target", fixed_noise=True, compute_dtype=dtype)
    editor = JEditor(
        cfg, tc.convert_stylegan2_generator(tg.state_dict(), W_SIZE, n_mlp=W_MLP),
        tc.convert_resnet50(tr.state_dict()),
        vgg_params=tc.convert_vgg_features(tvgg.state_dict(), "vgg19"),
        d_params=tc.convert_stylegan2_discriminator(td.state_dict(), W_SIZE))
    step = jtrain.make_train_step(editor, None, _capture(), host_alpha=True)
    walk = {"w": jnp.asarray(walk0)}
    _, grad, metrics = step(walk, _capture().init(walk), jnp.asarray(zs[0]),
                            jax.random.PRNGKey(0), sampled=jnp.asarray(alphas[0]))
    return {k: float(v) for k, v in metrics.items()}, np.asarray(grad["w"], np.float64)


def _port_train_editor(world, dtype=BF16):
    tg, td, tr, tvgg = world[:4]
    g = sg2.Generator(W_SIZE, W_DIM, W_MLP, channels=W_CHANNELS)
    g.load_state_dict(tg.state_dict(), strict=True)
    d = sg2.Discriminator(W_SIZE, channels=W_CHANNELS)
    d.load_state_dict(sg2.strip_blur_kernels(td.state_dict()), strict=True)
    reg = rn.ResNet50(num_outputs=N_REG_OUT)
    reg.load_state_dict(tr.state_dict(), strict=True)
    vgg = vggm.VGG19Features()
    vgg.load_state_dict(vggm.features_state_dict(tvgg.state_dict()), strict=True)
    cfg = EditorConfig(attr_list=W_ATTRS, attr_idx=W_IDX, size=W_SIZE, dim_z=W_DIM,
                       fixed_noise=True, compute_dtype=dtype)
    return Editor(cfg, g, reg, "cpu", vgg=vgg, d=d)


@pytest.fixture(scope="module")
def train_world():
    return _build_world()


def test_one_walk_step_in_bf16_matches_the_jax_step(train_world):
    world = train_world
    want, want_grad = _jax_step_grad(world, JBF16)
    want_f32, f32_grad = _jax_step_grad(world, jnp.float32)
    ed = _port_train_editor(world)
    walk0, zs, alphas = world[4:]
    walk = {"w": torch.from_numpy(walk0.copy()).requires_grad_()}
    step = T.make_train_step(ed, None, T.make_optimizer(walk, LR), host_alpha=True)
    m = step(walk, zs[0], sampled=alphas[0])
    for k in TERMS:
        _bf16_loss_close(m[k], want[k], want_f32[k], k)
    assert walk["w"].grad.dtype == torch.float32  # through the towers' casts
    got = walk["w"].grad.double().numpy()
    jax_spread = np.linalg.norm(want_grad - f32_grad) / np.linalg.norm(f32_grad)
    limit = max(2e-2, 2.0 * jax_spread)
    rel = np.linalg.norm(got - want_grad) / np.linalg.norm(want_grad)
    print(f"walk gradient: port bf16 vs JAX bf16 {rel:.3e}; JAX bf16 vs JAX f32 "
          f"{jax_spread:.3e}; limit {limit:.3e}")
    assert rel <= limit, (rel, limit)


# ---------------------------------------------------------------------------
# the path really runs in bf16
# ---------------------------------------------------------------------------


def _recording(monkeypatch, ed):
    """Wrap the kernels' public functions where the models look them up,
    and the towers' forwards: record (kernel, activation dtype, inside the
    style MLP) and (tower, dtype asked for)."""
    fa = importlib.import_module("latent2im_tpu_torch.ops.fused_act")
    sc = importlib.import_module("latent2im_tpu_torch.ops.styled_conv")
    ufd = importlib.import_module("latent2im_tpu_torch.ops.upfirdn2d")
    calls, towers, mlp = [], [], [False]

    def wrap(mod, attr, name):
        fn = getattr(mod, attr)

        def rec(x, *a, **kw):
            calls.append((name, x.dtype, mlp[0]))
            return fn(x, *a, **kw)
        monkeypatch.setattr(mod, attr, rec)

    wrap(sg2, "fused_leaky_relu", "fused_act")
    wrap(sg2, "styled_conv3x3", "styled_conv3x3")
    wrap(ufd, "upfirdn2d", "upfirdn2d")
    wrap(ufd, "upfirdn2d_bwd", "upfirdn2d_bwd")
    wrap(fa, "fused_leaky_relu_bwd", "fused_act_bwd")
    wrap(sc, "fused_leaky_relu_bwd", "fused_act_bwd")

    style_forward = ed.g.style_forward

    def in_mlp(z):
        mlp[0] = True
        try:
            return style_forward(z)
        finally:
            mlp[0] = False
    monkeypatch.setattr(ed.g, "style_forward", in_mlp)

    for tower, method in ((ed.g, "synthesize"), (ed.reg, "forward"), (ed.vgg, "forward"),
                          (ed.d, "forward")):
        fn = getattr(tower, method)

        def rec_tower(*a, _fn=fn, _name=type(tower).__name__, **kw):
            towers.append((_name, kw.get("dtype")))
            return _fn(*a, **kw)
        monkeypatch.setattr(tower, method, rec_tower)
    return calls, towers


def test_the_bf16_path_reaches_every_kernel_wrapper_in_bf16(monkeypatch, train_world):
    ed = _port_train_editor(train_world)
    calls, towers = _recording(monkeypatch, ed)
    walk0, zs, alphas = train_world[4:]
    walk = {"w": torch.from_numpy(walk0.copy())}
    ed.apply_alpha(walk, zs[1], alphas[1][:, 0])
    walk["w"].requires_grad_(True)
    step = T.make_train_step(ed, None, T.make_optimizer(walk, LR), host_alpha=True)
    step(walk, zs[0], sampled=alphas[0])
    names = {n for n, _, _ in calls}
    assert names == {"fused_act", "styled_conv3x3", "upfirdn2d", "upfirdn2d_bwd",
                     "fused_act_bwd"}, names
    for name, dtype, in_mlp in calls:
        want = torch.float32 if in_mlp else BF16  # the style MLP stays f32
        assert dtype == want, (name, dtype, in_mlp)
    assert any(in_mlp for _, _, in_mlp in calls)
    assert {n for n, _ in towers} == {"Generator", "ResNet50", "VGG19Features",
                                      "Discriminator"}
    assert all(dt == BF16 for _, dt in towers), towers


# ---------------------------------------------------------------------------
# PGGAN, geometric, --updateGAN
# ---------------------------------------------------------------------------


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


def test_pggan_model256_bf16_matches_jax():
    gen = torch.Generator().manual_seed(40)
    g, d = pggan.Generator(n_label=0, generator=gen), pggan.Discriminator(generator=gen)
    jg = _np_tree(tc.convert_pggan_generator(
        {**g.state_dict(), "label_embed.weight": torch.zeros(10, 10)}))
    del jg["label_embed"]
    jd = _np_tree(tc.convert_pggan_discriminator(d.state_dict()))
    z = np.random.RandomState(41).randn(2, 512).astype(np.float32)
    want = jax.jit(lambda p, z: jpgg.generator_forward(p, z, step=2, dtype=JBF16))(jg, z)
    with torch.no_grad():
        got = g.eval()(_t(z), step=2, dtype=BF16)
    assert got.dtype == torch.float32
    _tpu_close(got, want)
    img = np.random.RandomState(42).randn(3, 16, 16, 3).astype(np.float32)
    ws, wl = jax.jit(lambda p, x: jpgg.discriminator_forward(p, x, step=2, dtype=JBF16))(
        jd, img)
    with torch.no_grad():
        gs, gl = d.eval()(_t(img), step=2, dtype=BF16)
    _tpu_close(gs, ws)
    _tpu_close(gl, wl)


def test_geometric_zoom_step_in_bf16_matches_jax(towers):
    kw = dict(latent="w", walk_kind="linear_w", attr_list=("zoom",), attr_idx=(0,),
              size=SIZE, dim_z=DIM)
    ted = Editor(EditorConfig(compute_dtype=BF16, **kw), towers["g"], None, "cpu")
    jed = JEditor(JEditorConfig(compute_dtype=JBF16, **kw), _jtree(towers["g_tree"]), {})
    w0 = (0.1 * np.random.RandomState(43).randn(1, sg2.n_latent(SIZE), DIM)).astype(np.float32)
    loop = dict(num_samples=2, batch_size=2, n_epochs=1, lr=LR, seed=0, log_every=1)
    _, want = jtrain.geometric_train_loop(jed, jtasks.get_task("zoom"),
                                          {"w": jnp.asarray(w0)}, **loop)
    walk, got = T.geometric_train_loop(ted, tasks.get_task("zoom"),
                                       {"w": torch.from_numpy(w0.copy())}, **loop)
    assert len(got) == len(want) == 1 and walk["w"].dtype == torch.float32
    _loss_close(got[0], want[0])
    assert not np.array_equal(walk["w"].detach().numpy(), w0)


def test_update_gan_d_and_g_steps_in_bf16_match_jax(world):  # noqa: F811
    from latent2im_tpu.engine import gan as jgan

    d_step, g_step = jgan.make_gan_update_steps(
        lambda gp, z: jsg2.generator_forward(gp, z, dtype=JBF16),
        lambda dp, img: jsg2.discriminator_forward(dp, img, dtype=JBF16),
        _capture(), _capture())
    g, d = world["g"], world["d"]
    _, _, dm = d_step(d, _capture().init(d), g, world["z"], world["real"],
                      jax.random.PRNGKey(3))
    _, _, _, gm = g_step(g, _capture().init(g), g, d, world["z"], None, None)
    mod = port_module(world)
    port_d, port_g = gan.make_gan_update_steps(lambda z: mod.g(z, dtype=BF16),
                                               lambda img: mod.d(img, dtype=BF16), mod)
    m = port_d(torch.from_numpy(world["z"]), torch.from_numpy(world["real"]),
               eps=torch.tensor(world["eps"]))
    _loss_close(m["d_loss"], dm["d_loss"])
    _loss_close(m["grad_penalty"], dm["grad_penalty"])
    mod = port_module(world)  # the G step from the same D, as the JAX one
    _, port_g = gan.make_gan_update_steps(lambda z: mod.g(z, dtype=BF16),
                                          lambda img: mod.d(img, dtype=BF16), mod)
    _loss_close(port_g(torch.from_numpy(world["z"]))["g_loss"], gm["g_loss"])
    assert all(p.dtype == torch.float32 for p in mod.g.parameters())  # f32 masters


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _train_args(models_dir, *extra):
    return ["--transform", "face", "--attrList", "Smiling", "--models_dir", models_dir,
            "--overwrite_config", "--num_samples", "2", "--batch_size", "2",
            "--n_epochs", "1", "--dev_tiny", "--resolution", str(SIZE), *extra]


def test_bf16_runs_through_train_vis_w_and_serve(tmp_path, monkeypatch):
    import sys

    from latent2im_tpu.config import options as joptions
    from latent2im_tpu_torch.cli import serve
    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.cli.vis_w import run as vis_run
    from latent2im_tpu_torch.config import options
    from latent2im_tpu_torch.engine.build import (build_editor_from_options,
                                                   load_editor_for_inference)

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    opt = options.TrainOptions().parse(_train_args(str(tmp_path / "m"), "--bf16"),
                                       print_opt=True)
    with _restoring_logging(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        walk, _ = tcli.run(opt, device="cpu")
    yml = os.path.join(opt.output_dir, "opt.yml")
    with open(yml) as f:
        assert "bf16: true" in f.read().splitlines()
    final = os.path.join(opt.output_dir, "model_w_1_final_walk_module.ckpt")
    assert os.path.isfile(final) and walk["w"].dtype == torch.float32

    vopt, conf = options.VisOptions().parse(
        [yml, "--save_path_w", final, "--output_dir", str(tmp_path / "vis"),
         "--num_samples", "1", "--num_panels", "3"])
    assert conf.bf16
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ed, _, _ = load_editor_for_inference(vopt, conf, device="cpu")
        assert ed.cfg.compute_dtype == BF16
        vis_run(vopt, conf, device="cpu")
        vo = options.VisOptions()
        vo.parser.add_argument("--serve_batch", type=int, default=2)
        sopt, sconf = vo.parse([yml, "--save_path_w", final, "--num_panels", "3"])
        service = serve.build_service(sopt, sconf, device="cpu")
    assert service.ed.cfg.compute_dtype == BF16
    assert len([p for p in os.listdir(tmp_path / "vis") if p.endswith(".png")]) == 1
    z = np.random.RandomState(44).randn(2, service.dim_z).astype(np.float32)
    assert len(service.edit({"z": z.tolist(), "alpha": 0.5})["images"]) == 2

    # an opt.yml the JAX package wrote with --bf16 builds a bf16 editor here
    jopt = joptions.TrainOptions().parse(_train_args(str(tmp_path / "j"), "--bf16"),
                                         print_opt=True)
    _, jconf = options.VisOptions().parse([os.path.join(jopt.output_dir, "opt.yml")])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jed, _, _ = build_editor_from_options(jconf, device="cpu")
    assert jed.cfg.compute_dtype == BF16
