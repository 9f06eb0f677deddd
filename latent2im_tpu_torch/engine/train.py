"""The walk-training step and epoch loop — PyTorch port of
latent2im_tpu/engine/train.py (``make_train_step``, ``train_loop``).

One step is the reference's iteration (train.py:48-116 there): the original
image and its attribute scores with no gradient, the walk moved by the delta
to the sampled target, the edited image, then

    loss = 10 * BCE(R(edited), target) + 0.05 * VGG content + 0.05 * GAN

backpropagated through the frozen towers into the walk only, and one Adam
step. ``cfg.remat_g`` ('all' | 'block') checkpoints the edited synthesis,
whole or per block, and ``cfg.remat_towers`` the regressor, the content loss
and D on the edited image (utils/remat.py), as the JAX step does: the same
values, one more forward of each region in the backward, less memory.
``cfg.reg_input_size`` / ``cfg.content_input_size`` resize the images the
regressor and the content loss see (``editor.bilinear_resize``). PyTorch
runs it eagerly; its kernels (fused_act, upfirdn2d and the styled conv
forward, fused_act and upfirdn2d backward) launch from the models'
autograd nodes.

Randomness: the alpha targets and the per-forward noise come from a
``torch.Generator`` on the editor's device, re-seeded per step from (seed,
step index), so a resumed run replays the same stream. JAX keys cannot be
reproduced; ``host_alpha=True`` takes the targets from the host instead
(``Task.train_alpha_np``, bit-matching the JAX package) and
``EditorConfig.fixed_noise`` uses the stored noise buffers, which is how
the tests hold a step to the JAX step.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..tasks.transforms import Task
from ..utils.remat import checkpoint
from . import losses as L
from .editor import Editor


def make_optimizer(walk_params: dict, lr: float) -> torch.optim.Adam:
    """Adam(lr, betas=(0.5, 0.99)) as the reference; eps=1e-8 is added to
    sqrt(v_hat), where optax adds it too."""
    return torch.optim.Adam(list(walk_params.values()), lr=lr,
                            betas=(0.5, 0.99), eps=1e-8)


def make_train_step(editor: Editor, task: Task | None,
                    optimizer: torch.optim.Optimizer,
                    host_alpha: bool = False) -> Callable:
    """-> step(walk_params, z, generator=None, sampled=None) -> metrics.

    The step updates ``walk_params`` (leaf tensors the optimizer holds) in
    place and leaves their gradients in ``.grad``. ``generator`` (a
    torch.Generator on the editor's device) draws the alpha targets unless
    host_alpha, and the noise unless cfg.fixed_noise. ``sampled`` is the
    host-sampled alpha batch [B, A] of host_alpha mode. Metrics are 0-dim
    tensors on the device (reading one synchronises)."""
    cfg = editor.cfg
    n_attr = len(cfg.attr_list)

    def step(walk_params, z, generator=None, sampled=None):
        z = editor._tensor(z)
        b = z.shape[0]
        if host_alpha:
            if sampled is None:
                raise ValueError("host_alpha step requires the sampled batch")
            sampled = editor._tensor(sampled)
        else:
            sampled, _ = task.train_alpha(generator, b, n_attr)
        if generator is None and not cfg.fixed_noise:
            raise ValueError("fresh noise needs a generator (or fixed_noise)")

        def noise():  # None: the stored buffers
            return None if cfg.fixed_noise else editor.g.make_noise(b, generator)

        optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            latent = editor.latent_of(z)
            img_org = editor.synth(latent, noise=noise())
            alpha_org = editor.scores(img_org)
        target, delta = editor.unified_alphas(alpha_org, sampled)
        latent_new = editor.edit(walk_params, latent, delta)
        # the edited synthesis's noise is drawn here, outside any checkpoint,
        # so a recompute sees the same noise
        noise_new = noise()
        if cfg.remat_g == "block":
            img_new = editor.synth(latent_new, noise=noise_new, block_remat=True)
        elif cfg.remat_g:
            img_new = checkpoint(lambda lat: editor.synth(lat, noise=noise_new),
                                 latent_new)
        else:
            img_new = editor.synth(latent_new, noise=noise_new)

        def tower(fn, *args):
            # the loss towers are frozen and in eval mode: a recompute is exact
            return checkpoint(fn, *args) if cfg.remat_towers else fn(*args)

        reg = L.reg_loss(tower(editor.scores, img_new), target, stable=cfg.stable_bce)
        zero = torch.zeros((), device=editor.device)
        content = zero if cfg.no_content_loss else tower(
            lambda org, new: L.content_loss(editor.vgg, org, new),
            editor._content_input(img_org), editor._content_input(img_new))
        gan = zero if cfg.no_gan_loss else tower(
            lambda new: L.gan_loss_from_logits(editor.discriminate(new)), img_new)
        total = L.combine(reg, content, gan, no_content_loss=cfg.no_content_loss,
                          no_gan_loss=cfg.no_gan_loss,
                          pggan_gating=(cfg.model == "pggan"))
        total.backward()
        optimizer.step()
        return {"loss": total.detach(), "reg_loss": reg.detach(),
                "content_loss": content.detach(), "gan_loss": gan.detach(),
                "alpha_target_mean": target.mean()}

    return step


def _alpha_seed(seed: int, epoch: int) -> int:
    """Seed of the host alpha stream of an epoch, kept apart from
    sample_epoch_z's RandomState(epoch) (the JAX package's rule)."""
    return (seed * 100003 + 70001 * epoch + 35117) % (2**31)


def _step_seed(seed: int, it_global: int) -> int:
    """Seed of the device generator at one step: (seed, step) in 64 bits."""
    return ((seed % (2**31)) << 32) | (it_global % (2**32))


def sample_epoch_z(num_samples: int, dim_z: int, seed: int) -> np.ndarray:
    """Host z sampling, bit-matching the reference (graph_util.py:5-8,
    re-seeded per epoch at its train.py:45)."""
    return np.random.RandomState(seed).randn(num_samples, dim_z).astype(np.float32)


def train_loop(
    editor: Editor,
    task: Task,
    walk_params: dict,
    *,
    num_samples: int,
    batch_size: int,
    n_epochs: int,
    lr: float,
    seed: int = 0,
    log_every: int = 10,
    on_step: Callable | None = None,
    on_epoch_end: Callable | None = None,
    start_epoch: int = 0,
    opt_state: dict | None = None,
    stop_flag: Callable | None = None,
    on_preempt: Callable | None = None,
    host_alpha: bool = False,
) -> tuple[dict, list[float]]:
    """The reference's epoch/iteration structure around the step. Returns
    (walk_params, loss_history); the walk tensors are trained in place.

    opt_state: an Adam ``state_dict`` to resume from (with start_epoch).
    on_step(epoch, i, metrics as floats, seconds, walk_params) runs after a
    step; the loss history keeps every log_every-th step (and every step
    when on_step is given). on_epoch_end(epoch, walk_params, opt_state)
    runs after each epoch. stop_flag() is polled between steps; when it
    trips, on_preempt(epoch, walk_params, opt_state) runs and the loop
    returns. host_alpha draws the targets with numpy per epoch
    (RandomState(_alpha_seed(seed, epoch))) instead of on the device."""
    for p in walk_params.values():
        p.requires_grad_(True)
    optimizer = make_optimizer(walk_params, lr)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)
    step = make_train_step(editor, task, optimizer, host_alpha=host_alpha)
    n_attr = len(editor.cfg.attr_list)
    gen = torch.Generator(device=editor.device)
    history: list[float] = []
    iters = num_samples // batch_size
    it_global = start_epoch * iters
    for epoch in range(start_epoch, n_epochs):
        zs = torch.from_numpy(
            sample_epoch_z(num_samples, editor.cfg.dim_z, seed=epoch)
        ).to(editor.device)
        alpha_rng = np.random.RandomState(_alpha_seed(seed, epoch))
        for i in range(iters):
            if stop_flag is not None and stop_flag():
                if on_preempt is not None:
                    on_preempt(epoch, walk_params, optimizer.state_dict())
                return walk_params, history
            t0 = time.time()
            gen.manual_seed(_step_seed(seed, it_global))
            sampled = None
            if host_alpha:
                sampled, _ = task.train_alpha_np(alpha_rng, batch_size, n_attr)
            metrics = step(walk_params, zs[i * batch_size:(i + 1) * batch_size],
                           gen, sampled)
            if on_step is not None or (log_every and i % log_every == 0):
                metrics = {k: float(v) for k, v in metrics.items()}
                history.append(metrics["loss"])
                if on_step is not None:
                    on_step(epoch, i, metrics, time.time() - t0, walk_params)
            it_global += 1
        if on_epoch_end is not None:
            on_epoch_end(epoch, walk_params, optimizer.state_dict())
    return walk_params, history
