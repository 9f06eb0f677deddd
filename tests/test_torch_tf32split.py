"""The numerics of the styled conv's CUDA kernel, emulated on the CPU.

The kernel (``ops/csrc/styled_conv3x3.cu``) runs 3xTF32 on the tensor
cores: x * s and w split into TF32 halves, big = tf32(v) and small =
tf32(v - big), and small*big + big*small + big*big accumulate in f32.
``ops.styled_conv3x3_tf32`` repeats the split and the products in plain
PyTorch. These tests give the card tolerance (1e-5 of max |ref| against the
f32 plain version) its reason on the side of the operands: 3xTF32 holds it
against an f64 reference at the main path's 512 channels, single-pass TF32
does not.

They cover the split only. The emulation sums the products with f32
rounding, so it does not model the tensor cores' truncating accumulation;
the kernel's flush of its partial sums every two K steps, which keeps that
bias in check, is held only on the card (chip_smoke.py phases 3 and 9,
tests/test_torch_cuda.py).
"""

import math

import numpy as np
import pytest
import torch

from latent2im_tpu_torch import ops
from latent2im_tpu_torch.ops.styled_conv import tf32_round, tf32_split

TOL = 1e-5  # chip_smoke.py TOL["styled_conv3x3"], tests/test_torch_cuda.py


def _operands(b, h, cin, cout, seed):
    rs = np.random.RandomState(seed)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((shift + scale * rs.randn(*shape)).astype(np.float32))

    x = t(b, h, h, cin)
    w = t(3, 3, cin, cout, scale=1 / math.sqrt(9 * cin))
    s = t(b, cin, scale=0.2, shift=1.0)
    d = torch.rsqrt(s.square() @ w.square().sum((0, 1)) + 1e-8)
    return x, w, s, d, t(1, h, h), torch.full((1,), 0.3), t(cout, scale=0.1)


def test_tf32_round_keeps_ten_mantissa_bits_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 spacing in [1, 2)
    v = torch.tensor([one, one + ulp / 2, one + ulp / 2 - 2 ** -23, -(one + ulp / 2),
                      one + 1.5 * ulp, 0.0], dtype=torch.float32)
    got = tf32_round(v)
    want = torch.tensor([one, one + ulp, one, -(one + ulp), one + 2 * ulp, 0.0],
                        dtype=torch.float32)
    assert torch.equal(got, want)
    assert (tf32_round(v).view(torch.int32) & 0x1FFF).eq(0).all()


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 1e20])  # residuals stay normal
def test_big_plus_small_reconstructs_f32_within_2_pow_minus_21(scale):
    v = torch.from_numpy((scale * np.random.RandomState(0).randn(100000)).astype(np.float32))
    big, small = tf32_split(v)
    for half in (big, small):
        assert (half.view(torch.int32) & 0x1FFF).eq(0).all()  # both TF32
    rec = big.double() + small.double()
    rel = ((rec - v.double()).abs() / v.double().abs()).max().item()
    assert rel <= 2.0 ** -21
    # one TF32 alone is ~2^-11 off
    assert ((big.double() - v.double()).abs() / v.double().abs()).max().item() > 2.0 ** -13


@pytest.mark.parametrize("h", [4, 8])
def test_3xtf32_holds_the_card_tolerance_single_pass_tf32_does_not(h):
    args = _operands(4, h, 512, 512, seed=h)
    ref = ops.styled_conv3x3_plain(*(a.double() for a in args))
    scale = ref.abs().max().item()

    def err(out):
        return (out.double() - ref).abs().max().item() / scale

    e3 = err(ops.styled_conv3x3_tf32(*args, passes=3))
    e1 = err(ops.styled_conv3x3_tf32(*args, passes=1))
    e_f32 = err(ops.styled_conv3x3_plain(*args))
    assert e3 <= TOL, e3
    assert e1 > TOL, e1
    # 3xTF32 sits at f32's own level, orders of magnitude under single pass
    assert e3 <= 10 * max(e_f32, 1e-7) and e3 * 20 < e1


def test_tf32_emulation_refuses_other_pass_counts():
    with pytest.raises(ValueError, match="passes"):
        ops.styled_conv3x3_tf32(*_operands(1, 4, 4, 4, seed=0), passes=2)
