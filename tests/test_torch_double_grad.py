"""Second derivatives through the port's kernel wrappers, on the CPU.

The backward of fused_act and of upfirdn2d is an autograd node of its own
(ops/fused_act.py:_FusedLeakyReLUBwd, ops/upfirdn2d.py:_UpFirDn2dBwd), the
same node on both devices, so a second derivative keeps every term on the
card as it does here. Held by ``gradgradcheck`` in f64 and by the gradient,
wrt D's parameters, of the WGAN-GP gradient penalty that the JAX package's
``engine/gan.py:_d_loss`` defines:

    gp = 10 * mean_b((|grad_x sum D(x_hat)|_b - 1)^2)

against ``jax.grad`` of the same expression over the JAX D (its XLA
reference path, which JAX differentiates twice), on the same weights
(``io/convert.py:discriminator_from_jax``) and the same x_hat. Tolerance:
relative L2 per parameter 1e-4 and a max-abs of 1e-4 of the largest entry
(f32 on both sides; a second derivative sums twice as many f32 products as
a first one in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_cli import one_torch_thread  # noqa: F401 (autouse: one torch thread)

from latent2im_tpu.models import stylegan2 as jsg2
from latent2im_tpu_torch import ops
from latent2im_tpu_torch.io import convert
from latent2im_tpu_torch.models import stylegan2 as sg2

SIZE = 32
TINY = {r: (16 if r <= 8 else 8) for r in (4, 8, 16, 32)}  # --dev_tiny widths
GP_WEIGHT = 10.0


def _away_from_zero(t, margin=0.05):
    return t + margin * torch.sign(t)


def _grad_fn_names(t):
    """Names of every node in t's graph."""
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    return names


def test_fused_act_backward_is_twice_differentiable():
    gen = torch.Generator().manual_seed(0)
    x = _away_from_zero(torch.randn(2, 3, 4, 5, generator=gen, dtype=torch.float64))
    x.requires_grad_(True)
    b = (0.01 * torch.randn(5, generator=gen, dtype=torch.float64)).requires_grad_(True)
    assert torch.autograd.gradgradcheck(lambda x, b: ops.fused_leaky_relu(x, b), (x, b))
    # the first-order gradient under create_graph goes through the node
    (gx,) = torch.autograd.grad(ops.fused_leaky_relu(x, b).square().sum(), x,
                                create_graph=True)
    assert "_FusedLeakyReLUBwdBackward" in _grad_fn_names(gx)
    # and the backward itself, in g and in the saved output
    g = torch.randn(2, 3, 4, 5, generator=gen, dtype=torch.float64, requires_grad=True)
    out = ops.fused_leaky_relu(x.detach(), b.detach()).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda g, o: ops.fused_leaky_relu_bwd(g, o), (g, out))
    assert torch.autograd.gradgradcheck(lambda g, o: ops.fused_leaky_relu_bwd(g, o),
                                        (g, out))


@pytest.mark.parametrize("up,down,pad,gain", [
    (1, 1, (1, 1), 1.0),  # G's blur after the up conv (gain 4 there)
    (2, 1, (2, 1), 4.0),  # to_rgb's skip upsample
    (1, 2, (1, 1), 1.0),  # a downsample
    (1, 1, (2, 2), 1.0),  # D's blur before a stride-2 conv
])
def test_upfirdn2d_backward_is_twice_differentiable(up, down, pad, gain):
    k = ops.make_kernel([1, 3, 3, 1]) * gain
    gen = torch.Generator().manual_seed(up * 10 + down)
    x = torch.randn(2, 6, 7, 3, generator=gen, dtype=torch.float64, requires_grad=True)

    def fwd(t):
        return ops.upfirdn2d(t, k, up, down, pad)

    assert torch.autograd.gradgradcheck(fwd, (x,))
    y = fwd(x)
    (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    assert "_UpFirDn2dBwdBackward" in _grad_fn_names(gx)
    g = torch.randn(y.shape, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradgradcheck(
        lambda t: ops.upfirdn2d_bwd(t, k, up, down, pad, (6, 7)), (g,))


def test_styled_conv_backward_is_twice_differentiable_in_x_s_d():
    gen = torch.Generator().manual_seed(3)

    def r(*s):
        return torch.randn(s, generator=gen, dtype=torch.float64)

    x, s, d = r(2, 5, 5, 3), 1.0 + 0.2 * r(2, 3), 1.0 + 0.2 * r(2, 4)
    w, noise, nw, bias = r(3, 3, 3, 4) / 3.0, r(1, 5, 5), torch.full((1,), 0.3,
                                                                     dtype=torch.float64), r(4)
    x, s, d = (t.requires_grad_(True) for t in (x, s, d))
    assert torch.autograd.gradgradcheck(
        lambda x, s, d: ops.styled_conv3x3(x, w, s, d, noise, nw, bias), (x, s, d))


@pytest.fixture(scope="module")
def d_pair():
    """The JAX D at the --dev_tiny widths, every bias moved off zero, and
    the port's D loaded from it with strict=True."""
    tree = jax.jit(lambda k: jsg2.init_discriminator(k, SIZE, channels=TINY))(
        jax.random.PRNGKey(5))  # jitted: eager, the init takes ~8 s
    rng = np.random.RandomState(1)
    tree = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32) if a.ndim == 1 else a,
        tree)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    d = sg2.Discriminator(SIZE, channels=TINY)
    d.load_state_dict(convert.discriminator_from_jax(tree), strict=True)
    return tree, d


def gradient_penalty(d, x_hat):
    """The penalty term of the JAX package's _d_loss (gan.py:97-102)."""
    x = x_hat.detach().requires_grad_(True)
    (gx,) = torch.autograd.grad(d(x).sum(), x, create_graph=True)
    norms = torch.sqrt(gx.square().sum((1, 2, 3)) + 1e-12)
    return GP_WEIGHT * (norms - 1.0).square().mean()


def _jax_gp_grad(tree, x_hat):
    def gp(params, xh):
        def d_sum(v):
            return jnp.sum(jsg2.discriminator_forward(params, v))

        grads = jax.grad(d_sum)(xh)
        norms = jnp.sqrt(jnp.sum(grads ** 2, axis=(1, 2, 3)) + 1e-12)
        return GP_WEIGHT * jnp.mean((norms - 1.0) ** 2)

    value, grads = jax.jit(jax.value_and_grad(gp))(tree, jnp.asarray(x_hat))
    return float(value), jax.tree_util.tree_map(np.asarray, grads)


def test_gradient_penalty_gradient_matches_jax(d_pair):
    tree, d = d_pair
    rng = np.random.RandomState(2)
    real, fake = (rng.randn(4, SIZE, SIZE, 3).astype(np.float32) for _ in range(2))
    eps = rng.uniform(size=(4, 1, 1, 1)).astype(np.float32)
    x_hat = eps * real + (1.0 - eps) * fake
    want_value, want_tree = _jax_gp_grad(tree, x_hat)
    want = convert.discriminator_from_jax(want_tree)  # the same layout map

    ops.reset_launches()
    gp = gradient_penalty(d, torch.from_numpy(x_hat))
    names, params = zip(*d.named_parameters())
    # the last layer's bias does not reach grad_x D: None here, zeros in JAX
    grads = torch.autograd.grad(gp, params, allow_unused=True)
    assert set(ops.launch_counts().values()) == {0}  # CPU: the plain versions
    np.testing.assert_allclose(gp.item(), want_value, rtol=1e-5)
    assert set(names) == set(want)
    # the biases after the minibatch-stddev layer move grad_x D only through
    # LeakyReLU masks, whose derivative is zero: exact zeros on both sides
    zero = {"final_conv.1.bias", "final_linear.0.bias", "final_linear.1.bias"}
    for name, g in zip(names, grads):
        ref = want[name].numpy()
        got = np.zeros_like(ref) if g is None else g.numpy()
        if name in zero:
            assert not ref.any() and not got.any(), name
            continue
        assert np.abs(ref).max() > 0, name
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel <= 1e-4, (name, rel)
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), name
