"""GAN module container, EMA and the joint fine-tune's update steps
(``--updateGAN``) — PyTorch port of latent2im_tpu/engine/gan.py.

    D step: mean(D(fake)) - mean(D(real)) + 0.001 * mean(D(real)^2)
            + 10 * mean_b((|grad_x sum D(x_hat)|_b - 1)^2),
            x_hat = eps * real + (1 - eps) * fake, eps ~ U[0, 1) per sample,
            fake without a gradient
    G step: mean(softplus(-D(G(z))))
            [+ 0.1 * sum(((G(z) - target) * mask)^2) / sum(mask)],
            then the EMA of G (decay 0.999) into ``g_running``

each followed by Adam(lr, betas (0, 0.999), eps 1e-8 added after the square
root: optax.adam's update, moments and bias corrections alike).

G and D are the editor's modules, trained in place. They stay frozen
(``requires_grad`` off) outside these steps, so a walk step between them
takes no weight gradient and launches what it launches without the fine-tune.
Each step switches its own module's parameters to ``requires_grad`` only while
it runs, and takes its gradient with ``torch.autograd.grad`` with respect to
those parameters alone: the other module, the walk and the regressor get
none, as under ``jax.grad`` with respect to one tree. The penalty
differentiates D twice (``create_graph``), through the fused_act and
upfirdn2d backward nodes, which launch their kernels on the card.

Randomness: ``d_step`` takes eps from its caller, who draws it with
``draw_eps`` from an explicit ``torch.Generator`` on the images' device
(seeded 123 in the CLI). That stream cannot equal the JAX package's
``jax.random.uniform`` stream; the tests pass JAX's eps.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

# the reference's constants: the penalty's weight, the drift term's, the
# masked edit loss's (LAMBDA, pggan constants) and the EMA's decay
GP_WEIGHT, DRIFT, EDIT_WEIGHT, EMA_DECAY = 10.0, 0.001, 0.1, 0.999
BETAS = (0.0, 0.999)  # Adam's, the reference's stylegan2.py:30-36


def ema_accumulate(shadow: dict, params: dict, decay: float = EMA_DECAY) -> dict:
    """shadow = decay * shadow + (1 - decay) * params, in place, per name
    (the reference's stylegan2.py:9-16)."""
    with torch.no_grad():
        for name, s in shadow.items():
            s.mul_(decay).add_(params[name] * (1.0 - decay))
    return shadow


def make_adam(params, lr: float) -> torch.optim.Adam:
    """optax.adam(lr, *BETAS) as torch Adam: eps 1e-8 added to sqrt(v_hat)."""
    return torch.optim.Adam(list(params), lr=lr, betas=BETAS, eps=1e-8)


@dataclasses.dataclass
class GANModule:
    """G and D (the editor's modules), their Adam optimizers over
    ``named_parameters()`` in order, and the EMA shadow of G, ``g_running``
    (a dict of detached tensors by parameter name)."""

    g: torch.nn.Module
    d: torch.nn.Module
    g_running: dict
    g_opt: torch.optim.Adam
    d_opt: torch.optim.Adam

    @classmethod
    def create(cls, g, d, lr: float = 1e-4):
        return cls(g=g, d=d,
                   g_running={n: p.detach().clone() for n, p in g.named_parameters()},
                   g_opt=make_adam(g.parameters(), lr), d_opt=make_adam(d.parameters(), lr))

    def accumulate(self):
        ema_accumulate(self.g_running, dict(self.g.named_parameters()))


@contextlib.contextmanager
def _trainable(params):
    """``requires_grad`` on for ``params`` inside the block, off after."""
    for p in params:
        p.requires_grad_(True)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(False)


def draw_eps(generator, b: int, device) -> torch.Tensor:
    """The penalty's interpolation weights, U[0, 1) of shape [b, 1, 1, 1]."""
    return torch.rand((b, 1, 1, 1), generator=generator, device=device)


def _adam_step(opt, params, loss):
    """Adam on ``params`` with the gradient of ``loss`` wrt them alone (zeros
    where a parameter does not reach the loss, as jax.grad gives)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()
    for p in params:
        p.grad = None


def make_gan_update_steps(g_apply: Callable, d_apply: Callable, mod: GANModule):
    """-> (d_step, g_step) over ``mod``'s G and D.

    g_apply(batch) -> images NHWC, through the live G; d_apply(images) ->
    logits [B] or [B, 1]. d_step(batch, real, eps), eps [B, 1, 1, 1];
    g_step(batch, target=None, mask=None). Both update their module in place
    and return 0-dim metric tensors on the device ({"d_loss",
    "grad_penalty"}; {"g_loss"})."""
    g_params = list(mod.g.parameters())
    d_params = list(mod.d.parameters())

    def d_step(batch, real, eps):
        with torch.no_grad():
            fake = g_apply(batch)
        with _trainable(d_params):
            d_real = d_apply(real).reshape(-1)
            d_fake = d_apply(fake).reshape(-1)
            loss = d_fake.mean() - d_real.mean() + DRIFT * d_real.square().mean()
            x_hat = (eps * real + (1.0 - eps) * fake).requires_grad_(True)
            (gx,) = torch.autograd.grad(d_apply(x_hat).sum(), x_hat, create_graph=True)
            norms = torch.sqrt(gx.square().sum((1, 2, 3)) + 1e-12)
            gp = (norms - 1.0).square().mean()
            _adam_step(mod.d_opt, d_params, loss + GP_WEIGHT * gp)
        return {"d_loss": loss.detach(), "grad_penalty": gp.detach()}

    def g_step(batch, target=None, mask=None):
        with _trainable(g_params):
            fake = g_apply(batch)
            logits = d_apply(fake).reshape(-1)
            loss = F.softplus(-logits).mean()  # BCEWithLogits against ones
            if target is not None:
                diff = (fake - target) * mask
                loss = loss + EDIT_WEIGHT * diff.square().sum() / mask.sum()
            _adam_step(mod.g_opt, g_params, loss)
        mod.accumulate()
        return {"g_loss": loss.detach()}

    return d_step, g_step
