"""The port's CUDA kernels against their plain PyTorch versions ON THE CARD,
at ragged shapes the 256 px main path does not reach (chip_smoke.py holds
them at the main-path shapes). Marked ``cuda``: without a card every test
skips. On the GPU machine, which has no JAX (the repo's conftest imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances as in chip_smoke.py, relative to max |ref|: fused_act 1e-6,
upfirdn2d 1e-5, styled conv 1e-4 (a 9*Cin-term f32 sum in another order).
"""

import math

import numpy as np
import pytest
import torch

from latent2im_tpu_torch import ops

pytestmark = pytest.mark.cuda


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
    x = _randn(gen, dev, b, h, w, cin)
    wt = _randn(gen, dev, 3, 3, cin, cout) / math.sqrt(9 * cin)
    s = 1.0 + 0.2 * _randn(gen, dev, b, cin)
    d = torch.rsqrt(s.square() @ wt.square().sum((0, 1)) + 1e-8)
    noise = None if noise_b is None else _randn(gen, dev, noise_b, h, w)
    nw = torch.full((1,), 0.3, device=dev)
    bias = 0.1 * _randn(gen, dev, cout)
    args = (x, wt, s, d, noise, nw, bias)
    _close(ops.styled_conv3x3(*args), ops.styled_conv3x3_plain(*args), 1e-4)


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
