"""The port's CUDA kernels against their plain PyTorch versions ON THE CARD,
at ragged shapes the 256 px main paths do not reach (chip_smoke.py holds
them at the main-path shapes), forward and backward, and the autograd nodes
of the three wrappers against autograd of the plain versions. Marked
``cuda``: without a card every test skips. On the GPU machine, which has no
JAX (the repo's conftest imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py, relative to max |ref|: fused_act and its
backward 1e-6, upfirdn2d and its backward 1e-5, styled conv 1e-5 (a
9*Cin-term sum of 3xTF32 products in f32, in another order; the kernel reads
~4e-6 from the plain version at 512 channels, a kernel that let the tensor
cores' truncating accumulation run over all of K read ~4e-5:
tests/test_torch_tf32split.py shows why the 3xTF32 split holds it and
single-pass TF32 does not); gradients through the styled conv
2e-4 (cuDNN's convs against the plain version's, both f32 with TF32 off).
"""

import math

import numpy as np
import pytest
import torch

from latent2im_tpu_torch import ops

pytestmark = pytest.mark.cuda
SC_TOL = 1e-5  # styled conv, as chip_smoke.py TOL["styled_conv3x3"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from latent2im_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _close(got, want, tol):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(want.float().abs().max().item(), 1e-30), err


def _randn(gen, dev, *shape):
    return torch.randn(shape, generator=gen, device=dev)


@pytest.mark.parametrize("shape,bias,dtype", [
    ((7, 3), True, torch.float32), ((1, 1), True, torch.float32),
    ((2, 33, 5, 129), False, torch.float32), ((3, 1000), True, torch.bfloat16),
    ((4, 64, 64, 512), True, torch.float32),
])
def test_fused_act_kernel(dev, shape, bias, dtype):
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _randn(gen, dev, *shape).to(dtype)
    b = _randn(gen, dev, shape[-1]) if bias else None
    before = ops.fused_leaky_relu.launches
    got = ops.fused_leaky_relu(x, b)
    assert ops.fused_leaky_relu.launches == before + 1
    # bf16 output: both round the same f32 value once
    _close(got, ops.fused_leaky_relu_plain(x, b), 1e-6 if dtype == torch.float32 else 0)


ASYM = np.arange(1, 13, dtype=np.float32).reshape(3, 4) ** 1.5


@pytest.mark.parametrize("up,down,pad,taps,h,w,c", [
    (1, 1, (1, 1), [1, 3, 3, 1], 9, 9, 5),
    (2, 1, (2, 1), [1, 3, 3, 1], 8, 8, 3),
    (1, 2, (2, 2), [1, 3, 3, 1], 16, 16, 130),
    (2, 1, (1, 1), [1, 2, 1], 7, 9, 2),
    (1, 1, (-1, 2), [1, 3, 3, 1], 12, 12, 1),
    (2, 2, (1, 1), [1, 3, 3, 1], 8, 10, 33),
    (2, 1, (2, 1, 0, 3), ASYM, 6, 5, 3),
    (1, 2, (-1, 2, 3, 0), ASYM, 11, 9, 2),
    (4, 1, (3, 2), [1, 3, 3, 1], 5, 5, 3),
])
def test_upfirdn2d_kernel(dev, up, down, pad, taps, h, w, c):
    gen = torch.Generator(device=dev).manual_seed(1)
    k = np.asarray(taps, np.float32)
    k = ops.make_kernel(k) if k.ndim == 1 else k / k.sum()
    x = _randn(gen, dev, 2, h, w, c)
    _close(ops.upfirdn2d(x, k, up=up, down=down, pad=pad),
           ops.upfirdn2d_plain(x, k, up=up, down=down, pad=pad), 1e-5)


@pytest.mark.parametrize("b,h,w,cin,cout,noise_b", [
    # small tiles (grids under one wave of 128 x 128 tiles)
    (1, 4, 4, 3, 5, None), (2, 5, 7, 17, 65, 1), (3, 33, 31, 70, 16, 3),
    (2, 8, 8, 512, 512, 2), (1, 64, 64, 128, 128, 1),
    # large tiles: 16-byte path with a ragged channel tile, and scalar path
    (4, 96, 96, 36, 132, 4), (2, 97, 95, 70, 130, 1),
])
def test_styled_conv_kernel(dev, b, h, w, cin, cout, noise_b):
    gen = torch.Generator(device=dev).manual_seed(2)
    args = _styled_args(gen, dev, b, h, w, cin, cout, noise_b)
    _close(ops.styled_conv3x3(*args), ops.styled_conv3x3_plain(*args), SC_TOL)


def _styled_args(gen, dev, b, h, w, cin, cout, noise_b):
    x = _randn(gen, dev, b, h, w, cin)
    wt = _randn(gen, dev, 3, 3, cin, cout) / math.sqrt(9 * cin)
    s = 1.0 + 0.2 * _randn(gen, dev, b, cin)
    d = torch.rsqrt(s.square() @ wt.square().sum((0, 1)) + 1e-8)
    noise = None if noise_b is None else _randn(gen, dev, noise_b, h, w)
    return (x, wt, s, d, noise, torch.full((1,), 0.3, device=dev),
            0.1 * _randn(gen, dev, cout))


@pytest.mark.parametrize("h", [4, 8, 16, 32])
def test_styled_conv_kernel_small_layers_split_k_across_the_batch(dev, h):
    """The main path's 4-32 px layers (B=4, 512 -> 512): 64 x 128 tiles over
    M = B*H*W (a tile spans samples at 4 px), K split where the grid is
    under two blocks per SM."""
    gen = torch.Generator(device=dev).manual_seed(6)
    args = _styled_args(gen, dev, 4, h, h, 512, 512, 1)
    plan = ops.styled_conv3x3_plan(4, h, h, 512, 512)
    assert plan["tile"] == (64, 128)
    assert plan["splits"] > 1 or h > 16, plan
    before = ops.styled_conv3x3.launches
    got = ops.styled_conv3x3(*args)
    assert ops.styled_conv3x3.launches == before + 1  # one per call, split or not
    _close(got, ops.styled_conv3x3_plain(*args), SC_TOL)


@pytest.mark.parametrize("cin,cout", [(64, 64), (17, 30)])
def test_styled_conv_kernel_tile_ends_mid_sample(dev, cin, cout):
    """M = 3*5*7 = 105: the second 64-row tile holds the end of sample 1,
    all of sample 2 and then rows past M; per-sample noise, s and d."""
    gen = torch.Generator(device=dev).manual_seed(7)
    args = _styled_args(gen, dev, 3, 5, 7, cin, cout, 3)
    assert ops.styled_conv3x3_plan(3, 5, 7, cin, cout)["tile"] == (64, 128)
    _close(ops.styled_conv3x3(*args), ops.styled_conv3x3_plain(*args), SC_TOL)


@pytest.mark.parametrize("h,cin", [(8, 512), (64, 512)])
def test_styled_conv_kernel_is_deterministic(dev, h, cin):
    """No float atomics: split-K partial sums add in split order, so two
    calls give bit-identical results (split at 8 px, not at 64 px)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    args = _styled_args(gen, dev, 4, h, h, cin, cin, 1)
    a, b = ops.styled_conv3x3(*args), ops.styled_conv3x3(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# every upfirdn2d form of the 256 px paths, at full width: G's blur after an
# up conv (pad 1), D's blurs (pad 2 and 1), the ToRGB skip's x2 upsample (C=3)
# and their gradients (up 1 down 1; the skip's: up 1 down 2); odd, non-square
MAIN_FORMS = [
    (4, 129, 129, 256, 2, (1, 1), 4.0),
    (4, 64, 64, 512, 1, (2, 2), 1.0),
    (4, 256, 256, 128, 1, (1, 1), 1.0),
    (4, 128, 128, 3, 2, (2, 1), 4.0),
    (2, 33, 47, 128, 1, (1, 1), 4.0),
    (2, 31, 17, 3, 2, (2, 1), 4.0),
]


@pytest.mark.parametrize("b,h,w,c,up,pad,gain", MAIN_FORMS)
def test_upfirdn2d_kernel_main_path_forms(dev, b, h, w, c, up, pad, gain):
    gen = torch.Generator(device=dev).manual_seed(9)
    k = torch.as_tensor(ops.make_kernel([1, 3, 3, 1]), device=dev) * gain
    x = _randn(gen, dev, b, h, w, c)
    before = ops.upfirdn2d.launches
    got = ops.upfirdn2d(x, k, up=up, pad=pad)
    assert ops.upfirdn2d.launches == before + 1
    form = "templated float4" if c % 4 == 0 else "templated"
    assert ops.upfirdn2d_form(x, got, (4, 4), up, 1) == form
    _close(got, ops.upfirdn2d_plain(x, k, up=up, pad=pad), 1e-5)

    oh, ow = got.shape[1:3]
    g = _randn(gen, dev, b, oh, ow, c)
    gup, gdown, gpads = ops.transposed_params((4, 4), up, 1, pad, (h, w), (oh, ow))
    before = ops.upfirdn2d_bwd.launches
    dx = ops.upfirdn2d_bwd(g, k, up, 1, pad, (h, w))
    assert ops.upfirdn2d_bwd.launches == before + 1
    assert ops.upfirdn2d_form(g, dx, (4, 4), gup, gdown) == form
    _close(dx, ops.upfirdn2d_plain(g, torch.flip(k, (0, 1)), gup, gdown, gpads), 1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(2, 4, 4, 3, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_leaky_relu(x.permute(0, 2, 1, 3))
    with pytest.raises(TypeError, match="f32"):
        ops.upfirdn2d(x.double(), ops.make_kernel([1, 3, 3, 1]))
    with pytest.raises(ValueError, match="w must be"):
        ops.styled_conv3x3(x, torch.zeros(3, 3, 4, 3, device=dev),
                           torch.ones(2, 3, device=dev), torch.ones(2, 3, device=dev),
                           None, torch.zeros(1, device=dev), torch.zeros(3, device=dev))


def test_tiny_editor_on_the_card_matches_the_cpu(dev):
    from latent2im_tpu_torch.config.options import TrainOptions
    from latent2im_tpu_torch.engine.build import build_editor_from_options

    conf = TrainOptions().parse(["--attrList", "Smiling", "--dev_tiny",
                                 "--resolution", "32", "--models_dir", "unused"],
                                print_opt=False)
    z = np.random.RandomState(0).randn(2, 32).astype(np.float32)
    a = np.asarray([0.2, 0.9], np.float32)
    outs = []
    for device in (dev, "cpu"):
        ed, walk, _ = build_editor_from_options(conf, device=device)
        outs.append([v.cpu().numpy() for v in ed.apply_alpha(walk, z, a)])
    for g, c in zip(*outs):
        assert np.linalg.norm(g - c) <= 1e-4 * np.linalg.norm(c)


@pytest.mark.parametrize("shape,dtype", [
    ((7, 3), torch.float32), ((2, 33, 5, 129), torch.float32),
    ((3, 1000), torch.bfloat16), ((4, 64, 64, 512), torch.float32),
])
def test_fused_act_bwd_kernel(dev, shape, dtype):
    gen = torch.Generator(device=dev).manual_seed(3)
    g = _randn(gen, dev, *shape).to(dtype)
    out = _randn(gen, dev, *shape).to(dtype)
    before = ops.fused_leaky_relu_bwd.launches
    dx, db = ops.fused_leaky_relu_bwd(g, out)
    assert ops.fused_leaky_relu_bwd.launches == before + 1
    want_dx, want_db = ops.fused_leaky_relu_bwd_plain(g, out)
    _close(dx, want_dx, 1e-6 if dtype == torch.float32 else 0)
    _close(db, want_db, 1e-5)


@pytest.mark.parametrize("up,down,pad,taps,h,w,c", [
    # the training path's backward sites: D blurs, G blur, the skip's x2
    (1, 1, (2, 2), [1, 3, 3, 1], 9, 9, 5),
    (1, 1, (1, 1), [1, 3, 3, 1], 9, 7, 130),
    (2, 1, (2, 1), [1, 3, 3, 1], 8, 8, 3),
    # (H*up + p0 + p1 - k) % down != 0, crops, asymmetric kernel and pads
    (1, 2, (1, 1), [1, 3, 3, 1], 9, 9, 33),
    (1, 1, (-1, 2), [1, 3, 3, 1], 12, 12, 1),
    (2, 1, (2, 1, 0, 3), ASYM, 6, 5, 3),
    (1, 2, (-1, 2, 3, 0), ASYM, 11, 9, 2),
    (2, 2, (1, 1), [1, 3, 3, 1], 8, 10, 33),
    (4, 1, (3, 2), [1, 3, 3, 1], 5, 5, 3),
])
def test_upfirdn2d_bwd_kernel(dev, up, down, pad, taps, h, w, c):
    gen = torch.Generator(device=dev).manual_seed(4)
    k = np.asarray(taps, np.float32)
    k = ops.make_kernel(k) if k.ndim == 1 else k / k.sum()
    oh, ow = ops.upfirdn2d_plain(torch.zeros(1, h, w, 1), k, up, down, pad).shape[1:3]
    g = _randn(gen, dev, 2, oh, ow, c)
    before = ops.upfirdn2d_bwd.launches
    got = ops.upfirdn2d_bwd(g, k, up, down, pad, (h, w))
    assert ops.upfirdn2d_bwd.launches == before + 1
    gup, gdown, gpads = ops.transposed_params(k.shape, up, down, pad, (h, w), (oh, ow))
    kf = np.ascontiguousarray(np.flip(k, (0, 1)))
    _close(got, ops.upfirdn2d_plain(g, kf, gup, gdown, gpads), 1e-5)


def _grads(fn, leaves, g):
    leaves = {n: t.detach().clone().requires_grad_(n in NEEDS_GRAD)
              for n, t in leaves.items()}
    out = fn(**leaves)
    assert out.grad_fn is not None  # the fault: a CUDA result without a node
    out.backward(g)
    torch.cuda.synchronize()
    return out, {n: t.grad for n, t in leaves.items() if n in NEEDS_GRAD}


NEEDS_GRAD = {"x", "bias", "s", "d", "noise", "noise_w"}


def test_autograd_nodes_match_autograd_of_the_plain_versions(dev):
    """All three wrappers on CUDA tensors that need a gradient record a node
    (the launch counts rise) and give the plain versions' gradients."""
    gen = torch.Generator(device=dev).manual_seed(5)
    k = torch.as_tensor(ops.make_kernel([1, 3, 3, 1]), device=dev)
    cases = {
        "fused_act": (
            lambda x, bias: ops.fused_leaky_relu(x, bias),
            lambda x, bias: ops.fused_leaky_relu_plain(x, bias),
            {"x": _randn(gen, dev, 2, 9, 7, 33), "bias": _randn(gen, dev, 33)},
            (2, 9, 7, 33), 1e-6),
        "upfirdn2d": (
            lambda x: ops.upfirdn2d(x, k * 4, up=2, pad=(2, 1)),
            lambda x: ops.upfirdn2d_plain(x, k * 4, up=2, pad=(2, 1)),
            {"x": _randn(gen, dev, 2, 7, 9, 3)}, (2, 14, 18, 3), 1e-5),
        "styled_conv3x3": (
            lambda **a: ops.styled_conv3x3(**a),
            lambda **a: ops.styled_conv3x3_plain(**a),
            {"x": _randn(gen, dev, 2, 9, 11, 20),
             "w": _randn(gen, dev, 3, 3, 20, 24) / math.sqrt(180),
             "s": 1.0 + 0.2 * _randn(gen, dev, 2, 20),
             "d": 0.5 + torch.rand((2, 24), generator=gen, device=dev),
             "noise": _randn(gen, dev, 2, 9, 11), "noise_w": torch.full((1,), 0.3, device=dev),
             "bias": 0.1 * _randn(gen, dev, 24)},
            (2, 9, 11, 24), 2e-4),
    }
    for name, (fn, plain, leaves, out_shape, tol) in cases.items():
        g = _randn(gen, dev, *out_shape)
        before = ops.launch_counts()
        out, got = _grads(fn, leaves, g)
        after = ops.launch_counts()
        assert after[name] == before[name] + 1, name
        if name != "styled_conv3x3":
            assert after[name + "_bwd"] == before[name + "_bwd"] + 1, name
        else:
            assert after["fused_act_bwd"] == before["fused_act_bwd"] + 1
        want_out, want = _grads(plain, leaves, g)
        _close(out.detach(), want_out.detach(), SC_TOL if name == "styled_conv3x3" else tol)
        for n in got:
            _close(got[n], want[n], tol)


def test_tiny_train_step_on_the_card_matches_the_cpu(dev):
    """One tiny walk-training step (fixed noise, host alpha) on the card and
    on the CPU from the same seed: loss and walk gradient agree."""
    from latent2im_tpu_torch.config.options import TrainOptions
    from latent2im_tpu_torch.engine import train as T
    from latent2im_tpu_torch.engine.build import build_editor_from_options

    conf = TrainOptions().parse(["--attrList", "Smiling", "--dev_tiny",
                                 "--resolution", "32", "--models_dir", "unused",
                                 "--fixed_noise"], print_opt=False)
    z = np.random.RandomState(0).randn(2, 32).astype(np.float32)
    a = np.asarray([[0.2], [0.2]], np.float32)
    res = []
    for device in (dev, "cpu"):
        ed, walk, _ = build_editor_from_options(conf, device=device)
        walk["w"].requires_grad_(True)
        step = T.make_train_step(ed, None, T.make_optimizer(walk, 1e-3), host_alpha=True)
        m = step(walk, z, sampled=a)
        res.append((float(m["loss"]), walk["w"].grad.cpu()))
    (lg, gg), (lc, gc) = res
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert float((gg - gc).norm() / gc.norm()) <= 1e-4


@pytest.mark.parametrize("layout", ["nhwc", "channels_last_view"])
@pytest.mark.parametrize("h,out", [(1024, 256), (256, 160), (64, 128)])
def test_bilinear_resize_forward_and_backward_on_the_card(dev, layout, h, out):
    """editor.bilinear_resize (--reg_input_size, --content_input_size, the
    eval's whitened input) on the card against the CPU, forward and the
    antialiased backward, for the NHWC-contiguous image G hands it and for
    an NHWC view of NCHW memory."""
    from latent2im_tpu_torch.engine.editor import bilinear_resize

    gen = torch.Generator().manual_seed(h + out)
    x = torch.randn((2, h, h, 3), generator=gen)
    g = torch.randn((2, out, out, 3), generator=gen)
    results = []
    for d in ("cpu", dev):
        xd = x.to(d)
        if layout == "channels_last_view":
            xd = xd.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        xd.requires_grad_(True)
        y = bilinear_resize(xd, out, out)
        (gx,) = torch.autograd.grad(y, xd, g.to(d))
        results.append((y.detach().cpu(), gx.cpu()))
    (y0, g0), (y1, g1) = results
    torch.cuda.synchronize()
    assert (y1 - y0).abs().max().item() <= 1e-5 * y0.abs().max().item()
    assert (g1 - g0).abs().max().item() <= 1e-5 * g0.abs().max().item()


@pytest.mark.parametrize("h,cin,cout", [(512, 64, 64), (1024, 32, 32), (1024, 64, 32)])
def test_styled_conv_kernel_at_the_1024px_models_thin_layers(dev, h, cin, cout):
    """The 1024 px model's 512^2 x 64 and 1024^2 x 32 layers (Cout below the
    kernel's 128-wide N tile), B=1, against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(h + cin)
    x = _randn(gen, dev, 1, h, h, cin)
    w = _randn(gen, dev, 3, 3, cin, cout) / math.sqrt(9 * cin)
    s = 1 + 0.2 * _randn(gen, dev, 1, cin)
    d = torch.rsqrt(s.square() @ w.square().sum((0, 1)) + 1e-8)
    args = (x, w, s, d, _randn(gen, dev, 1, h, h), torch.full((1,), 0.3, device=dev),
            0.1 * _randn(gen, dev, cout))
    _close(ops.styled_conv3x3(*args), ops.styled_conv3x3_plain(*args), SC_TOL)
