"""W+ inversion of real images (the reference's BP.py) — PyTorch port of
latent2im_tpu/engine/inversion.py.

W+ starts at G's mean latent (4096 mapped z) tiled to [B, n_latent, D]; then
Adam(lr, betas=(0.5, 0.9)) or SGD with momentum 0.9 moves W+ for n_loops
steps on

    loss = sum_b [ sum(diff^2)/N_px ]  +  B * mean_b [ gram perceptual ]

where the perceptual term sums the squared gram differences at VGG16's
relu1_2/2_2/3_3/4_3, each scaled by C^2. G and VGG16 are frozen: W+ is the
only leaf. G runs with its stored noise maps, as the JAX ``synthesize``
does by default, so one W+ gives one image. The target's grams do not
depend on W+: ``invert`` computes them once per batch and every step reuses
them (the same values as a per-step recompute, one VGG16 forward fewer).
The loss history stays on the device and is read back once, at the end.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..device import resolve_device
from ..models import vgg as vggm


def nll_pixel_loss(output, target):
    """Per-sample -log_likelihood / N (the reference's 'berboulli' branch):
    sum of squared differences over [H, W, C] / (H*W*C)."""
    diff = output - target
    n = output.shape[1] * output.shape[2] * output.shape[3]
    return diff.square().sum((1, 2, 3)) / n


def target_grams(vgg16, target) -> list:
    """The gram matrices of ``target``'s VGG16 taps (no gradient)."""
    with torch.no_grad():
        feats = vgg16(target, vggm.VGG16_GRAM_TAPS)
        return [vggm.gram_matrix(feats[t].permute(0, 2, 3, 1))
                for t in vggm.VGG16_GRAM_TAPS]


def gram_perceptual_bp(vgg16, target, output, grams_t=None):
    """Per-sample gram loss [B], each tap's squared gram difference x C^2.
    ``grams_t``: the target's grams from ``target_grams``, when the caller
    keeps them."""
    grams_t = target_grams(vgg16, target) if grams_t is None else grams_t
    feats = vgg16(output, vggm.VGG16_GRAM_TAPS)
    total = 0.0
    for tap, gt in zip(vggm.VGG16_GRAM_TAPS, grams_t):
        go = vggm.gram_matrix(feats[tap].permute(0, 2, 3, 1))
        total = total + (gt - go).square().sum((1, 2)) * (gt.shape[1] * gt.shape[2])
    return total


def make_inverter(g, vgg16, n_latent: int, lr: float = 1e-4, optim: str = "Adam",
                  device=None) -> tuple[Callable, Callable, Callable]:
    """-> (init_w, step, optimizer) on ``device`` (cuda unless the caller
    asks for the CPU); G and VGG16 are moved there and frozen.

    init_w(batch, generator=None, z=None) -> W+ [batch, n_latent, D]: the
    mean of G's mapping over 4096 z (drawn from ``generator``, a
    torch.Generator on the device, or given as ``z``), tiled.
    optimizer(w) -> the optimizer state over the leaf w.
    step(w, state, target, grams_t=None) -> (w, state, loss, output): one
    update of w in place; loss (a 0-dim device tensor) and output are those
    of the W+ before the update, as the JAX step returns them."""
    if optim not in ("Adam", "GD"):
        raise ValueError(f"unknown optimizer {optim}")
    dev = resolve_device(device)
    g = g.to(dev).eval().requires_grad_(False)
    vgg16 = vgg16.to(dev).eval().requires_grad_(False)

    def init_w(batch: int, generator=None, z=None):
        with torch.no_grad():
            if z is None:
                mean = g.mean_latent(4096, generator)
            else:
                mean = g.style_forward(torch.as_tensor(z, device=dev)).mean(0, keepdim=True)
        return mean[:, None, :].repeat(batch, n_latent, 1)

    def optimizer(w):
        if optim == "Adam":  # optax.adam(lr, b1=0.5, b2=0.9): eps outside the sqrt
            return torch.optim.Adam([w], lr=lr, betas=(0.5, 0.9), eps=1e-8)
        return torch.optim.SGD([w], lr=lr, momentum=0.9)  # optax.sgd(lr, momentum=0.9)

    def step(w, state, target, grams_t=None):
        state.zero_grad(set_to_none=True)
        output = g.synthesize(w).to(w.dtype)  # G's output is f32; an f64 W+ keeps f64
        nll = nll_pixel_loss(output, target)
        p = gram_perceptual_bp(vgg16, target, output, grams_t)
        loss = (nll + p.mean()).sum()  # (nll + mean(p)).sum() over the batch
        loss.backward()
        state.step()
        return w, state, loss.detach(), output.detach()

    return init_w, step, optimizer


def invert(g, vgg16, target_imgs, n_latent: int, n_loops: int = 500,
           lr: float = 1e-4, optim: str = "Adam", generator=None,
           on_loop: Callable | None = None, show_freq: int = 500, inverter=None,
           device=None):
    """-> (w [B, n_latent, D], the last step's output images, loss history
    as a list of floats).

    inverter: a (init_w, step, optimizer) from make_inverter over the same
    g and vgg16, which a caller with many batches builds once.
    on_loop(loop, loss, output) runs at every show_freq-th loop and the
    last (reading the loss synchronises)."""
    init_w, step, optimizer = inverter or make_inverter(g, vgg16, n_latent, lr, optim,
                                                        device=device)
    dev = next(vgg16.parameters()).device  # make_inverter moved the towers there
    target = torch.as_tensor(target_imgs, dtype=torch.float32, device=dev)
    grams_t = target_grams(vgg16, target)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    w = init_w(target.shape[0], generator).requires_grad_(True)
    state = optimizer(w)
    history = torch.empty(n_loops, dtype=torch.float32, device=dev)
    output = None
    for loop in range(1, n_loops + 1):
        w, state, loss, output = step(w, state, target, grams_t)
        history[loop - 1] = loss
        if on_loop is not None and (loop % show_freq == 0 or loop == n_loops):
            on_loop(loop, loss.item(), output)
    return w.detach(), output, history.double().cpu().tolist()
