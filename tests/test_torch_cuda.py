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

The bf16 instances (--bf16) against the plain versions on the same bf16
tensors, relative to max |ref| (chip_smoke.py phase 33's gates): fused_act
and upfirdn2d forward and backward 2^-8 (both sum in f32 and round once:
one bf16 ulp where the f32 sums differ), the styled conv 2^-7 (A = bf16(x *
s) and the bf16 weight on the tensor cores, f32 accumulation in another
order than cuDNN's f32 convolution of the plain version, then one rounding).

The regressor trainer's host C++ built with the kernels (the JPEG decode
and the resize, ops/csrc/*.cpp) equals the Python versions bit for bit on
every fixture of tests/fixtures/torch_jpeg/, and one train-mode ResNet-50
step on the card matches the CPU's (chip_smoke.py phase 39's gates).
"""

import math
import os

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


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (2, 9, 11, 20, 24), (4, 16, 16, 512, 512), (4, 256, 256, 128, 128),
])
def test_styled_conv_weight_gradient_matches_the_plain_version(dev, b, h, w, cin, cout):
    """The weight and noise-map gradients (the --updateGAN G step's; cuDNN's
    weight gradient on the card) against the plain backward in f64 on the
    kernel's own output mask. Against autograd of the plain version the
    forwards' last-bit differences flip a few LeakyReLU masks, and at
    256^2 x 128 those flips alone move the input and noise gradients by up
    to 1e-2 of max |ref|; on the same mask the card reads at most 7.4e-5,
    the weight's f32 sum of 262144 terms (scripts/torch_gan_grad_check.py,
    H100 80GB HBM3 at 700 W)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    x, wt, s, d, noise, nw, bias = _styled_args(gen, dev, b, h, w, cin, cout, 1)
    g = _randn(gen, dev, b, h, w, cout)
    leaves = [t.detach().clone().requires_grad_(True) for t in (wt, noise, nw)]
    before = ops.launch_counts()["styled_conv3x3"]
    out = ops.styled_conv3x3(x, leaves[0], s, d, leaves[1], leaves[2], bias)
    got = torch.autograd.grad(out, leaves, g)
    assert ops.launch_counts()["styled_conv3x3"] == before + 1
    assert got[1].shape == (1, h, w)
    # the plain backward in f64, on the kernel's mask
    x64, w64, s64, d64, n64, g64 = (t.double() for t in (x, wt, s, d, noise, g))
    gz = g64 * torch.where(out.detach() > 0, 1.0, 0.2).double() * math.sqrt(2)
    xs = (x64 * s64[:, None, None, :]).permute(0, 3, 1, 2)
    gy = (gz * d64[:, None, None, :]).permute(0, 3, 1, 2)
    want = (torch.nn.grad.conv2d_weight(xs, w64.permute(3, 2, 0, 1).shape, gy, padding=1)
            .permute(2, 3, 1, 0),
            (gz.sum(-1) * nw.double()).sum(0, keepdim=True),
            (gz.sum(-1) * n64).sum().reshape(1))
    for a, ref in zip(got, want):
        _close(a.double(), ref, 2e-4)


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
    with pytest.raises(ValueError, match="must be contiguous"):  # bf16 x, f32 w
        ops.styled_conv3x3(x.to(torch.bfloat16), torch.zeros(3, 3, 3, 4, device=dev),
                           torch.ones(2, 3, device=dev), torch.ones(2, 4, device=dev),
                           None, torch.zeros(1, device=dev), torch.zeros(4, device=dev))
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


def test_second_derivatives_through_the_backward_kernels_match_the_cpu(dev):
    """The gradient, wrt a tiny D's parameters, of a gradient penalty
    (which differentiates fused_act's and upfirdn2d's backward) on the card
    against the CPU from the same weights and input: every parameter within
    1e-4 relative L2 (f32 on both; the last bias gets no gradient on
    either), and the second-order pass launches the backward kernels
    again."""
    import copy

    from latent2im_tpu_torch.models.stylegan2 import Discriminator

    gen = torch.Generator().manual_seed(6)
    d = Discriminator(32, channels={4: 16, 8: 16, 16: 8, 32: 8}, generator=gen)
    with torch.no_grad():
        for name, p in d.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    x_hat = torch.randn((4, 32, 32, 3), generator=gen)
    res = {}
    for device in (dev, torch.device("cpu")):
        dd = copy.deepcopy(d).to(device)
        x = x_hat.to(device).requires_grad_(True)
        before = ops.launch_counts()
        (gx,) = torch.autograd.grad(dd(x).sum(), x, create_graph=True)
        first = ops.launch_counts()
        gp = (torch.sqrt(gx.square().sum((1, 2, 3)) + 1e-12) - 1.0).square().mean()
        grads = torch.autograd.grad(gp, list(dd.parameters()), allow_unused=True)
        second = ops.launch_counts()
        res[device.type] = [None if g is None else g.cpu() for g in grads]
        if device.type == "cuda":
            for k in ("fused_act_bwd", "upfirdn2d_bwd"):
                assert first[k] > before[k] and second[k] > first[k], (k, before, second)
            assert second["upfirdn2d"] > first["upfirdn2d"]  # the transposed op's own gradient
    for (name, _), a, b in zip(d.named_parameters(), res["cuda"], res["cpu"]):
        if b is None:
            assert a is None or not a.any(), name
            continue
        if not b.any():
            assert float(a.abs().max()) <= 1e-6, name
            continue
        assert float((a - b).norm() / b.norm()) <= 1e-4, name


def test_z_path_launches_the_kernels_and_matches_the_cpu(dev):
    """StyleGAN2 in z (--latent z --is_mlp, the mlp_z walk), tiny: apply_alpha
    and one training step (stored noise, host alpha) on the card launch the
    forward kernels and the backward kernels, and agree with the CPU: images
    1e-4 relative L2, loss 1e-4, walk gradient 1e-4 relative L2 (the tiny
    step's bound above)."""
    from latent2im_tpu_torch.config.options import TrainOptions
    from latent2im_tpu_torch.engine import train as T
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.walks import walk_leaves

    conf = TrainOptions().parse(["--attrList", "Smiling", "--dev_tiny", "--latent", "z",
                                 "--is_mlp", "--resolution", "32", "--models_dir",
                                 "unused", "--fixed_noise"], print_opt=False)
    z = np.random.RandomState(0).randn(2, 32).astype(np.float32)
    a = np.asarray([[0.2], [0.7]], np.float32)
    res = []
    for device in (dev, "cpu"):
        ed, walk, _ = build_editor_from_options(conf, device=device)
        assert ed.cfg.walk_kind == "mlp_z"
        ops.reset_launches()
        imgs = [v.cpu().numpy() for v in ed.apply_alpha(walk, z, a[:, 0])]
        serve = ops.launch_counts()
        for t in walk_leaves(walk):
            t.requires_grad_(True)
        step = T.make_train_step(ed, None, T.make_optimizer(walk, 1e-3), host_alpha=True)
        ops.reset_launches()
        m = step(walk, z, sampled=a)
        train = ops.launch_counts()
        grad = torch.cat([t.grad.cpu().reshape(-1) for t in walk_leaves(walk)])
        res.append((imgs, float(m["loss"]), grad))
        if device == dev:
            assert all(serve[k] > 0 for k in ("fused_act", "upfirdn2d", "styled_conv3x3"))
            assert all(v > 0 for v in train.values()), train
    (ig, lg, gg), (ic, lc, gc) = res
    for g, c in zip(ig[:1] + ig[2:], ic[:1] + ic[2:]):
        assert np.linalg.norm(g - c) <= 1e-4 * np.linalg.norm(c)
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert float((gg - gc).norm() / gc.norm()) <= 1e-4


def test_pggan_editor_on_the_card_matches_the_cpu(dev):
    """model_256 at --resolution 16 (full ladder, step 2): apply_alpha and
    one training step on the card agree with the CPU (cuDNN's and the CPU's
    f32 convs): images 1e-4 relative L2, loss 1e-4, walk gradient 1e-3
    relative L2; no hand-written kernel runs on this path."""
    from latent2im_tpu_torch.config.options import TrainOptions
    from latent2im_tpu_torch.engine import train as T
    from latent2im_tpu_torch.engine.build import build_editor_from_options

    conf = TrainOptions().parse(["--model", "pggan", "--transform", "scene",
                                 "--attrList", "daylight", "--resolution", "16",
                                 "--models_dir", "unused"], print_opt=False)
    z = np.random.RandomState(1).randn(2, 512).astype(np.float32)
    a = np.asarray([[0.3], [-0.4]], np.float32)
    res = []
    for device in (dev, "cpu"):
        ed, walk, _ = build_editor_from_options(conf, device=device)
        walk["w"].requires_grad_(True)
        ops.reset_launches()
        imgs = [v.cpu().numpy() for v in ed.apply_alpha(walk, z, a[:, 0])]
        step = T.make_train_step(ed, None, T.make_optimizer(walk, 1e-3), host_alpha=True)
        m = step(walk, z, sampled=a)
        assert set(ops.launch_counts().values()) == {0}
        res.append((imgs, float(m["loss"]), walk["w"].grad.cpu()))
    (ig, lg, gg), (ic, lc, gc) = res
    assert ig[0].shape == (2, 8, 8, 3)
    for g, c in zip(ig[:1] + ig[2:], ic[:1] + ic[2:]):
        assert np.linalg.norm(g - c) <= 1e-4 * np.linalg.norm(c)
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert float((gg - gc).norm() / gc.norm()) <= 1e-3


@pytest.mark.parametrize("name", ["color", "colorlab", "zoom", "shiftx", "shifty", "rotate2d",
                                  "rotate3d", "dsprites"])
def test_geometric_samplers_and_targets_on_the_card_match_the_cpu(dev, name):
    """The geometric tasks' targets and masks (tasks/warp.py's sampler) of the
    same images on the card and on the CPU: targets within 1e-4 absolute
    (chip_smoke.py GEO_TARGET_TOL: a matrix product's or a power's ulp moves
    a pixel by ~1e-5), masks equal for the shifts and the colour tasks and
    within 1e-3 of the pixels for the rotations and zoom-out. dsprites: its
    torch.Generator sampler on the card composes the same sliders as on the
    CPU (a ladder scale, x in [-1, 1] twice, posx and posy in [0, 1])."""
    from latent2im_tpu_torch.tasks.geometric import device_target
    from latent2im_tpu_torch.tasks.transforms import get_task

    task = get_task(name)
    if name == "dsprites":
        for device in (dev, torch.device("cpu")):
            gen = torch.Generator(device=device).manual_seed(0)
            a = torch.stack([task.train_alpha(gen, 2, 5)[1] for _ in range(200)]).cpu()
            assert set(np.round(a[:, 0].numpy(), 6)) <= set(np.float32(task.SCALE_LADDER).round(6))
            assert a[:, 1:3].abs().max() <= 1 and a[:, 3:].min() >= 0 and a[:, 3:].max() <= 1
        with pytest.raises(ValueError):
            task.train_alpha(torch.Generator(device=dev), 2, 3)
        return
    rng = np.random.RandomState(0)
    y, x = np.mgrid[0:64, 0:64] / 64.0
    imgs = np.stack([np.sin(2 * np.pi * (f * x + g * y)) for f, g in rng.uniform(0.5, 3, (6, 2))],
                    -1).reshape(64, 64, 2, 3).transpose(2, 0, 1, 3).astype(np.float32) * 0.9
    flips = total = 0
    for _ in range(6):
        spec = task.device_spec(task.train_alpha_np(rng, 2)[1], 64)
        got_t, got_m = device_target(spec, torch.from_numpy(imgs).to(dev))
        want_t, want_m = device_target(spec, torch.from_numpy(imgs))
        assert got_t.device.type == "cuda"
        assert (got_t.cpu() - want_t).abs().max().item() <= 1e-4
        flips += int((got_m.cpu() != want_m).sum())
        total += want_m.numel()
    limit = 1e-3 * total if name in ("zoom", "rotate2d", "rotate3d") else 0
    assert flips <= limit, (flips, total)


# ---------------------------------------------------------------------------
# the bf16 instances (--bf16)
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
BF_TOL, BF_SC_TOL = 2.0 ** -8, 2.0 ** -7


def test_each_wrapper_refuses_f16(dev):
    """f32 and bf16 only: a half tensor raises in every wrapper, nothing
    launches and nothing falls back."""
    h = torch.float16
    x = torch.zeros(2, 8, 8, 16, device=dev, dtype=h)
    k = ops.make_kernel([1, 3, 3, 1])
    before = ops.launch_counts()
    with pytest.raises(TypeError, match="f16|float16|Half"):
        ops.fused_leaky_relu(x, torch.zeros(16, device=dev))
    with pytest.raises(TypeError, match="f16|float16|Half"):
        ops.fused_leaky_relu_bwd(x, x)
    with pytest.raises(TypeError, match="f16|float16|Half"):
        ops.upfirdn2d(x, k, pad=(1, 1))
    with pytest.raises(TypeError, match="f16|float16|Half"):
        ops.upfirdn2d_bwd(x, k, 1, 1, (1, 1), (9, 9))
    with pytest.raises(TypeError, match="f16|float16|Half"):
        ops.styled_conv3x3(x, torch.zeros(3, 3, 16, 16, device=dev, dtype=h),
                           torch.ones(2, 16, device=dev, dtype=h),
                           torch.ones(2, 16, device=dev, dtype=h), None,
                           torch.zeros(1, device=dev), torch.zeros(16, device=dev))
    assert ops.launch_counts() == before


@pytest.mark.parametrize("b,h,w,c,up,pad,gain", MAIN_FORMS)
def test_upfirdn2d_bf16_kernel_main_path_forms(dev, b, h, w, c, up, pad, gain):
    """The bf16 instance at every main-path form, forward and gradient: the
    16-byte vector (eight bf16) where C % 8 == 0, one channel at a time at
    C = 3; each launch counted as a bf16 launch."""
    gen = torch.Generator(device=dev).manual_seed(19)
    k = torch.as_tensor(ops.make_kernel([1, 3, 3, 1]), device=dev) * gain
    x = _randn(gen, dev, b, h, w, c).to(BF16)
    before = ops.launch_counts(bf16=True)["upfirdn2d"]
    got = ops.upfirdn2d(x, k, up=up, pad=pad)
    assert got.dtype == BF16 and ops.launch_counts(bf16=True)["upfirdn2d"] == before + 1
    form = "templated bf16x8" if c % 8 == 0 else "templated"
    assert ops.upfirdn2d_form(x, got, (4, 4), up, 1) == form
    _close(got, ops.upfirdn2d_plain(x, k, up=up, pad=pad), BF_TOL)
    oh, ow = got.shape[1:3]
    g = _randn(gen, dev, b, oh, ow, c).to(BF16)
    gup, gdown, gpads = ops.transposed_params((4, 4), up, 1, pad, (h, w), (oh, ow))
    before = ops.launch_counts(bf16=True)["upfirdn2d_bwd"]
    dx = ops.upfirdn2d_bwd(g, k, up, 1, pad, (h, w))
    assert ops.launch_counts(bf16=True)["upfirdn2d_bwd"] == before + 1
    assert ops.upfirdn2d_form(g, dx, (4, 4), gup, gdown) == form
    _close(dx, ops.upfirdn2d_plain(g, torch.flip(k, (0, 1)), gup, gdown, gpads), BF_TOL)


@pytest.mark.parametrize("up,down,pad,taps,h,w,c", [
    (1, 1, (1, 1), [1, 3, 3, 1], 9, 9, 5), (2, 2, (1, 1), [1, 3, 3, 1], 8, 10, 33),
    (2, 1, (2, 1, 0, 3), ASYM, 6, 5, 3), (1, 2, (2, 2), [1, 3, 3, 1], 16, 16, 24),
])
def test_upfirdn2d_bf16_kernel_generic_and_ragged(dev, up, down, pad, taps, h, w, c):
    gen = torch.Generator(device=dev).manual_seed(20)
    k = np.asarray(taps, np.float32)
    k = ops.make_kernel(k) if k.ndim == 1 else k / k.sum()
    x = _randn(gen, dev, 2, h, w, c).to(BF16)
    _close(ops.upfirdn2d(x, k, up=up, down=down, pad=pad),
           ops.upfirdn2d_plain(x, k, up=up, down=down, pad=pad), BF_TOL)


def test_upfirdn2d_bf16_unaligned_slice_takes_the_scalar_instance(dev):
    """A bf16 tensor starting 2 bytes past a 16-byte boundary: no 16-byte
    vectors, the one-channel instance, the same values."""
    gen = torch.Generator(device=dev).manual_seed(21)
    k = ops.make_kernel([1, 3, 3, 1])
    x = _randn(gen, dev, 2 * 16 * 16 * 8 + 1).to(BF16)[1:].view(2, 16, 16, 8)
    got = ops.upfirdn2d(x, k, pad=(1, 1))
    assert ops.upfirdn2d_form(x, got, (4, 4), 1, 1) == "templated"
    _close(got, ops.upfirdn2d_plain(x, k, pad=(1, 1)), BF_TOL)


def test_fused_act_bf16_with_an_f32_bias_launches_the_kernel(dev):
    gen = torch.Generator(device=dev).manual_seed(22)
    x, b = _randn(gen, dev, 4, 16, 16, 64).to(BF16), _randn(gen, dev, 64)
    before = ops.launch_counts(bf16=True)["fused_act"]
    got = ops.fused_leaky_relu(x, b)
    assert ops.launch_counts(bf16=True)["fused_act"] == before + 1 and got.dtype == BF16
    _close(got, ops.fused_leaky_relu_plain(x, b), 0)  # one rounding of the same f32
    g = _randn(gen, dev, 4, 16, 16, 64).to(BF16)
    dx, db = ops.fused_leaky_relu_bwd(g, got)
    want_dx, want_db = ops.fused_leaky_relu_bwd_plain(g, got)
    _close(dx, want_dx, 0)
    _close(db, want_db, 1e-5)  # an f32 sum over rows in another order


def _bf16_styled_args(gen, dev, b, h, w, cin, cout, noise_b):
    x, wt, s, d, noise, nw, bias = _styled_args(gen, dev, b, h, w, cin, cout, noise_b)
    return (x.to(BF16), wt.to(BF16), s.to(BF16), d.to(BF16),
            None if noise is None else noise.to(BF16), nw, bias)


@pytest.mark.parametrize("b,h,w,cin,cout,noise_b", [
    # ragged Cin (not a multiple of 8: the one-channel loads), Cout < 128,
    # the 16-byte path with a ragged tile, large tiles, per-sample noise
    (1, 4, 4, 3, 5, None), (2, 5, 7, 17, 65, 1), (3, 33, 31, 40, 16, 3),
    (2, 8, 8, 512, 512, 2), (1, 64, 64, 128, 128, 1), (4, 96, 96, 40, 136, 4),
    (2, 97, 95, 72, 130, 1), (4, 64, 64, 256, 64, 1),
])
def test_styled_conv_bf16_kernel(dev, b, h, w, cin, cout, noise_b):
    gen = torch.Generator(device=dev).manual_seed(23)
    args = _bf16_styled_args(gen, dev, b, h, w, cin, cout, noise_b)
    before = ops.launch_counts(bf16=True)["styled_conv3x3"]
    got = ops.styled_conv3x3(*args)
    assert got.dtype == BF16
    assert ops.launch_counts(bf16=True)["styled_conv3x3"] == before + 1
    _close(got, ops.styled_conv3x3_plain(*args), BF_SC_TOL)


@pytest.mark.parametrize("h", [4, 8, 16, 32])
def test_styled_conv_bf16_kernel_split_k_at_the_small_layers(dev, h):
    """The 4-32 px layers (B=4, 512 -> 512) split K in bf16 too (64 channels
    a K step: 72 steps at 512 channels); f32 partial sums, one rounding in
    the reduction launch; two calls bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(24)
    args = _bf16_styled_args(gen, dev, 4, h, h, 512, 512, 1)
    plan = ops.styled_conv3x3_plan(4, h, h, 512, 512, BF16)
    assert plan["tile"] == (64, 128) and (plan["splits"] > 1 or h > 16), plan
    got = ops.styled_conv3x3(*args)
    _close(got, ops.styled_conv3x3_plain(*args), BF_SC_TOL)
    assert torch.equal(got, ops.styled_conv3x3(*args))


@pytest.mark.parametrize("h,cin,cout", [(512, 64, 64), (1024, 32, 32)])
def test_styled_conv_bf16_kernel_at_the_1024px_models_thin_layers(dev, h, cin, cout):
    """The thin form (N = Cout) at the 1024 px model's own layers; two calls
    bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(25)
    args = _bf16_styled_args(gen, dev, 1, h, h, cin, cout, 1)
    plan = ops.styled_conv3x3_plan(1, h, h, cin, cout, BF16)
    assert plan == {"tile": (64, cout), "splits": 1, "workspace_bytes": 0}, plan
    got = ops.styled_conv3x3(*args)
    _close(got, ops.styled_conv3x3_plain(*args), BF_SC_TOL)
    assert torch.equal(got, ops.styled_conv3x3(*args))


@pytest.mark.parametrize("cout", [32, 64, 40])
@pytest.mark.parametrize("cin", [3, 32, 64, 17])
def test_styled_conv_bf16_thin_form(dev, cin, cout):
    """bf16 with Cout <= 64 and Cin <= 64 takes the thin form: N 32 or 64,
    K in 16-channel slices (Cin 3 and 17 zero-padded, read channel by
    channel), 64-pixel row tiles (W = 70: the second tile of a row ends
    after 6 pixels), per-sample noise; held to the plain bf16 version
    within 2^-7 of max|ref|, one counted launch, two calls bit-identical."""
    gen = torch.Generator(device=dev).manual_seed(27)
    args = _bf16_styled_args(gen, dev, 3, 37, 70, cin, cout, 3)
    plan = ops.styled_conv3x3_plan(3, 37, 70, cin, cout, BF16)
    assert plan == {"tile": (64, 32 if cout <= 32 else 64), "splits": 1,
                    "workspace_bytes": 0}, plan
    before = ops.launch_counts(bf16=True)["styled_conv3x3"]
    got = ops.styled_conv3x3(*args)
    assert ops.launch_counts(bf16=True)["styled_conv3x3"] == before + 1
    _close(got, ops.styled_conv3x3_plain(*args), BF_SC_TOL)
    assert torch.equal(got, ops.styled_conv3x3(*args))


@pytest.mark.parametrize("b,h,w,noise_b", [(5, 9, 130, 1), (2, 1, 64, None), (7, 3, 5, 7)])
def test_styled_conv_bf16_thin_form_tiles_end_mid_sample(dev, b, h, w, noise_b):
    """Each warpgroup's share of the row tiles starts and ends mid-sample
    (here more warpgroups than samples, with rows of 130, 64 and 5 pixels);
    a one-row image (halo rows above and below zero); shared or no noise."""
    gen = torch.Generator(device=dev).manual_seed(28)
    args = _bf16_styled_args(gen, dev, b, h, w, 32, 32, noise_b)
    got = ops.styled_conv3x3(*args)
    _close(got, ops.styled_conv3x3_plain(*args), BF_SC_TOL)
    assert torch.equal(got, ops.styled_conv3x3(*args))


@pytest.mark.parametrize("b,h,cin,cout,tile", [
    (4, 256, 128, 128, (128, 128)), (8, 256, 256, 128, (128, 128)),
    (4, 32, 512, 512, (64, 128)), (2, 64, 128, 64, (64, 128)),
])
def test_styled_conv_bf16_plan_keeps_the_tiled_form_past_64_channels(dev, b, h, cin, cout,
                                                                     tile):
    """Cout >= 128 (every 256 px layer, the 1024 px model up to 256^2) and
    Cin > 64 keep the 128-wide N tile; f32 never takes the thin form."""
    plan = ops.styled_conv3x3_plan(b, h, h, cin, cout, BF16)
    assert plan["tile"] == tile and plan["workspace_bytes"] > 0, plan
    assert ops.styled_conv3x3_plan(b, h, h, 32, 32)["tile"][1] == 128


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("shape,offset,bias", [
    ((8, 64, 64, 32), 0, True), ((4, 16, 16, 512), 0, True), ((3, 1000), 0, False),
    ((2, 9, 11, 37), 0, True), ((5, 7, 24), 1, True), ((6, 40), 3, False),
])
def test_fused_act_forward_equals_the_plain_version_exactly(dev, dtype, shape, offset, bias):
    """The vector stream (C a multiple of 16 bytes, aligned x and y), the
    ragged-C and unaligned cases (the scalar loop; `offset` elements past an
    aligned start), with and without a bias: bit for bit the plain version
    (f32 math, one rounding), -0 kept without a bias."""
    gen = torch.Generator(device=dev).manual_seed(29)
    n = math.prod(shape)
    x = _randn(gen, dev, n + offset).to(dtype)[offset:].view(shape)
    x.view(-1)[::97] = -0.0
    b = _randn(gen, dev, shape[-1]) if bias else None
    before = ops.fused_leaky_relu.launches
    got = ops.fused_leaky_relu(x, b)
    torch.cuda.synchronize()
    assert ops.fused_leaky_relu.launches == before + 1
    want = ops.fused_leaky_relu_plain(x, b)
    assert torch.equal(got.view(-1).view(torch.int16 if dtype == BF16 else torch.int32),
                       want.view(-1).view(torch.int16 if dtype == BF16 else torch.int32))


def test_styled_conv_bf16_gradients_match_the_plain_version(dev):
    """The bf16 node's backward (fused_act's bf16 backward kernel, cuDNN's
    bf16 convs) against autograd of the plain bf16 version: each gradient in
    its operand's dtype, within 2e-2 relative L2 (bf16 convolutions summed
    in another order)."""
    gen = torch.Generator(device=dev).manual_seed(26)
    args = [a.clone().requires_grad_(True) if a is not None else None
            for a in _bf16_styled_args(gen, dev, 2, 16, 16, 64, 64, 2)]
    g = _randn(gen, dev, 2, 16, 16, 64).to(BF16)
    leaves = [a for a in args if a is not None]
    got = torch.autograd.grad(ops.styled_conv3x3(*args), leaves, g)
    want = torch.autograd.grad(ops.styled_conv3x3_plain(*args), leaves, g)
    for a, x, y in zip(leaves, got, want):
        assert x.dtype == a.dtype
        rel = (x.double() - y.double()).norm() / y.double().norm()
        assert rel <= 2e-2, rel


def test_tiny_bf16_editor_on_the_card_matches_the_cpu_in_bf16_launches(dev):
    """--bf16 at --dev_tiny: apply_alpha on the card through the bf16
    instances (every styled conv, upfirdn2d and non-MLP fused_act launch a
    bf16 one) against the CPU's plain bf16 versions: images within 2e-2
    relative L2 (bf16 roundings at other places)."""
    from latent2im_tpu_torch.config.options import TrainOptions
    from latent2im_tpu_torch.engine.build import build_editor_from_options

    conf = TrainOptions().parse(["--attrList", "Smiling", "--dev_tiny", "--bf16",
                                 "--resolution", "32", "--models_dir", "unused"],
                                print_opt=False)
    z = np.random.RandomState(0).randn(2, 32).astype(np.float32)
    a = np.asarray([0.2, 0.9], np.float32)
    outs = []
    for device in (dev, "cpu"):
        ed, walk, _ = build_editor_from_options(conf, device=device)
        assert ed.cfg.compute_dtype == BF16
        ops.reset_launches()
        outs.append([v.cpu().numpy() for v in ed.apply_alpha(walk, z, a)])
        if device == dev:
            every, bf = ops.launch_counts(), ops.launch_counts(bf16=True)
            for k in ("upfirdn2d", "styled_conv3x3"):
                assert every[k] == bf[k] > 0, (k, every, bf)
            assert every["fused_act"] - bf["fused_act"] == 2  # the 2-layer style MLP, f32
    for g, c in zip(*outs):
        assert np.linalg.norm(g - c) <= 2e-2 * np.linalg.norm(c)


# ---------------------------------------------------------------------------
# the regressor trainer's host C++ and its train-mode step
# ---------------------------------------------------------------------------

JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_jpeg")


def test_the_c_decode_and_resize_equal_python_on_every_fixture(dev):
    """The host C++ built with the kernels (nvcc) against the Python and
    numpy versions, bit for bit: decode, and decode + crop + resize."""
    import glob

    from latent2im_tpu_torch.utils import image as im
    from latent2im_tpu_torch.utils import jpeg

    paths = sorted(glob.glob(os.path.join(JPEG_DIR, "*.jpg")))
    assert len(paths) == 5
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        got, want = jpeg.jpeg_decode_rgb(data, host_cpp=True), jpeg.jpeg_decode_rgb(data)
        assert got.shape == want.shape and np.array_equal(got, want), path
        for size in (64, 256):
            assert np.array_equal(im.pillow_load_and_resize(path, size, host_cpp=True),
                                  im.pillow_load_and_resize(path, size)), (path, size)


def test_a_train_mode_resnet50_step_on_the_card_matches_the_cpu(dev):
    """One cli/train_regressor.py step (train-mode BN, Adam 1e-4) at 64 px,
    B=4 from the same seeded state: the loss and the running statistics
    within 1e-4 (relative, relative L2), the parameters within 2 lr per
    element (Adam's first move is sign-like where the gradient is ~0)."""
    from latent2im_tpu_torch.cli import train_regressor as tr
    from latent2im_tpu_torch.models.resnet import ResNet50

    lr = 1e-4
    cpu = ResNet50(40, generator=torch.Generator().manual_seed(0))
    card = ResNet50(40).to(dev, memory_format=torch.channels_last)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (4, 64, 64, 3)).astype(np.uint8)
    y = rng.uniform(0, 1, (4, 40)).astype(np.float32)
    want = float(tr.make_steps(cpu, lr)[1](tr.normalize(u8, "cpu"), torch.from_numpy(y)))
    got = float(tr.make_steps(card, lr)[1](tr.normalize(u8, dev), torch.from_numpy(y).to(dev)))
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)
    for k, w in cpu.state_dict().items():
        g = card.state_dict()[k].cpu()
        if k.endswith("num_batches_tracked"):
            assert int(g) == int(w) == 1
        elif k.endswith(("running_mean", "running_var")):
            assert float((g - w).norm() / w.norm()) <= 1e-4, k
        else:
            assert float((g - w).abs().max()) <= 2 * lr * (1 + 1e-3) + 1e-6, k
