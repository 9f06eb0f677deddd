"""The walk-training step and epoch loop — PyTorch port of
latent2im_tpu/engine/train.py (``make_train_step``, ``train_loop``, and for
the geometric and color tasks ``make_geometric_device_step``,
``make_geometric_train_step``, ``geometric_train_loop``).

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
regressor and the content loss see (``editor.bilinear_resize``). In z space
(StyleGAN2 --latent z, PGGAN) the walk edits z itself; its input is the
clamped delta to the target in W space and in the PGGAN's delta mode, the
sampled alpha itself in a StyleGAN2 z run (the JAX step's rule), and the
PGGAN gates the 10x BCE weight off when either other loss is. --trainEmbed
(the 'embed' walk) draws one bank index per step on the host
(``Task.train_alpha_embed_np``) and trains that bank entry. PyTorch
runs it eagerly; its kernels (fused_act, upfirdn2d and the styled conv
forward, fused_act and upfirdn2d backward) launch from the models'
autograd nodes. Under ``cfg.compute_dtype`` bf16 (--bf16) the towers and
the content loss's VGG19 compute in bf16 through the editor, the walk, its
gradient (through the towers' casts) and Adam stay f32.

Randomness: the alpha targets and the per-forward noise come from a
``torch.Generator`` on the editor's device, re-seeded per step from (seed,
step index), so a resumed run replays the same stream. JAX keys cannot be
reproduced; ``host_alpha=True`` takes the targets from the host instead
(``Task.train_alpha_np``, bit-matching the JAX package) and
``EditorConfig.fixed_noise`` uses the stored noise maps, which is how
the tests hold a step to the JAX step. A task whose device sampler cannot
express the configured vocabulary (a dsprites --attrList subset) raises
ValueError when ``train_loop`` probes it, and the loop samples on the host.

The geometric and color tasks (tasks/geometric.py) train the walk on a
pixel target instead: the original synthesis, its warped or recoloured
target and mask built on the device from the task's ``device_spec``
(tasks/warp.py), the edited synthesis, the masked L2 and Adam. Both
syntheses use G's stored noise, as the JAX step passes no noise key, so the
step is deterministic and holds to the JAX step step by step. Under
--host_targets (``device_targets=False``) the loop takes the reference's
round trip instead: the original synthesized on the device, pulled to the
host as float32, warped or recoloured by the task's ``get_target_np``
(tasks/cv2_np.py's cv2 arithmetic), and the target and mask pushed back
into ``make_geometric_train_step``.

Over a mesh (``mesh=``, parallel/mesh.py; one process per rank) the steps
take the GLOBAL batch, as the JAX steps do in global-batch semantics: z,
the host alphas, the device-drawn alphas and the fresh noise are drawn at
the global shape from the same seeded streams on every rank and sliced to
the rank's rows of the 'data' axis; D's minibatch stddev gathers the global
batch (parallel/mesh.py:BatchGather); under a row plan
(parallel/spatial.py) synthesis runs on the rank's image rows. The walk
gradient is averaged over 'data' and summed over 'spatial' in one
all-reduce, so Adam steps identically on every rank (``replicate`` makes
the walk and its Adam state equal at the start); the metrics are the
global batch's. With ``frozen_shardings`` (parallel/mesh.py:
frozen_tp_shardings, on a (data x model) mesh) G runs tensor-parallel over
'model' (parallel/tensor.py); its Megatron operators leave the whole walk
gradient on every model rank, so it is averaged over 'data' alone.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import numpy as np
import torch

from ..models import hooks
from ..parallel import mesh as meshlib
from ..parallel.tensor import shard_generator, tensor_parallel
from ..tasks.geometric import device_target
from ..tasks.transforms import Task
from ..utils.remat import checkpoint
from ..walks import walk_leaves
from . import losses as L
from .editor import Editor


def make_optimizer(walk_params: dict, lr: float) -> torch.optim.Adam:
    """Adam(lr, betas=(0.5, 0.99)) as the reference, over the walk's
    tensors in ``walk_leaves`` order; eps=1e-8 is added to sqrt(v_hat),
    where optax adds it too."""
    return torch.optim.Adam(walk_leaves(walk_params), lr=lr,
                            betas=(0.5, 0.99), eps=1e-8)


class _DataParallel:
    """The part of a step that runs over a mesh: this rank's rows of the
    global batch, D's global-batch gather installed in models/hooks.py,
    and the gradient and metric reductions. Identity without a mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.gather = (meshlib.BatchGather(mesh)
                       if mesh is not None and mesh.groups.get("data") is not None else None)
        self.lo = self.hi = None

    def rows(self, n: int) -> None:
        self.lo, self.hi = (0, n) if self.mesh is None else self.mesh.data_slice(n)

    def local(self, t):
        return None if t is None else t[self.lo:self.hi]

    def __enter__(self):
        self._prev = hooks.install_batch(self.gather)
        return self

    def __exit__(self, *exc):
        hooks.restore_batch(self._prev)
        return False

    def mean(self, t):
        """t averaged over 'data' (t itself without a mesh)."""
        if self.mesh is None:
            return t
        return meshlib.all_reduce(self.mesh, t, "data") / self.mesh.shape.get("data", 1)

    def reduce(self, optimizer, metrics: dict) -> dict:
        if self.mesh is None:
            return metrics
        meshlib.average_gradients(self.mesh, [p for g in optimizer.param_groups
                                              for p in g["params"]])
        return meshlib.mean_over_data(self.mesh, metrics)


def make_train_step(editor: Editor, task: Task | None,
                    optimizer: torch.optim.Optimizer,
                    host_alpha: bool = False, train_embed: bool = False,
                    mesh=None, frozen_shardings=None) -> Callable:
    """-> step(walk_params, z, generator=None, sampled=None, index=None) ->
    metrics.

    The step updates ``walk_params`` (leaf tensors the optimizer holds) in
    place and leaves their gradients in ``.grad`` (zeros for a tensor the
    loss does not reach, as jax.grad gives, so that Adam steps every tensor
    as optax does). ``generator`` (a torch.Generator on the editor's device)
    draws the alpha targets unless host_alpha, and the noise unless
    cfg.fixed_noise. ``sampled`` is the host-sampled alpha batch [B, A] of
    host_alpha mode. train_embed (implies host_alpha): ``index``, the bank
    entry the step trains, of the first attribute's bank. Metrics are 0-dim
    tensors on the device (reading one synchronises).

    mesh: z and sampled are the global batch (the module docstring).
    frozen_shardings: ``meshlib.frozen_tp_shardings(mesh, editor.
    frozen_params())``, the JAX package's tensor-parallel towers: the
    editor's G is cut to this rank's shards by them (parallel/tensor.py:
    shard_generator, as the JAX step device_puts the towers by them), and
    each forward and backward of the step runs under a tp plan over its
    mesh's 'model' axis (which must be ``mesh``)."""
    tp = contextlib.nullcontext()
    if frozen_shardings is not None:
        if frozen_shardings.mesh is not mesh:
            raise ValueError("frozen_shardings were laid out for another mesh than the step's")
        if frozen_shardings.specs.get("g") is not None:
            shard_generator(editor.g, frozen_shardings.specs["g"], mesh)
            tp = tensor_parallel(mesh)
    dp = _DataParallel(mesh)
    cfg = editor.cfg
    n_attr = len(cfg.attr_list)
    host_alpha = host_alpha or train_embed
    # the reference trains WalkEmbed single-attribute: the first bank
    embed_name = cfg.attr_list[0] if train_embed else None

    def step(walk_params, z, generator=None, sampled=None, index=None):
        z = editor._tensor(z)
        b = z.shape[0]
        if host_alpha:
            if sampled is None:
                raise ValueError("host_alpha step requires the sampled batch")
            sampled = editor._tensor(sampled)
        else:
            sampled, _ = task.train_alpha(generator, b, n_attr)
        if train_embed and index is None:
            raise ValueError("train_embed step requires the bank index")
        if generator is None and not cfg.fixed_noise and editor.draws_noise:
            raise ValueError("fresh noise needs a generator (or fixed_noise)")

        def noise():  # None: the stored noise maps; drawn for the global batch
            nz = None if cfg.fixed_noise else editor.make_noise(b, generator)
            return None if nz is None else [dp.local(t) for t in nz]

        dp.rows(b)
        z, sampled = dp.local(z), dp.local(sampled)
        optimizer.zero_grad(set_to_none=True)
        with dp, tp:
            metrics = _forward_backward(walk_params, z, sampled, index, noise)
        _zero_missing_grads(optimizer)
        metrics = dp.reduce(optimizer, metrics)
        optimizer.step()
        return metrics

    def _forward_backward(walk_params, z, sampled, index, noise):
        with torch.no_grad():
            latent = editor.edit_latent(z)
            img_org = editor.synth(latent, noise=noise())
            alpha_org = editor.scores(img_org)
        target, delta = editor.unified_alphas(alpha_org, sampled)
        if train_embed:  # the embed walk ignores alpha
            latent_new = editor.edit(walk_params, latent, sampled, name=embed_name,
                                     index=index)
        elif cfg.latent == "w" or cfg.alpha_mode == "delta":
            latent_new = editor.edit(walk_params, latent, delta)
        else:  # a StyleGAN2 z run feeds the sampled alpha
            latent_new = editor.edit(walk_params, latent, sampled)
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
            lambda org, new: L.content_loss(editor.vgg, org, new, dtype=editor.tower_dtype),
            editor._content_input(img_org), editor._content_input(img_new))
        gan = zero if cfg.no_gan_loss else tower(
            lambda new: L.gan_loss_from_logits(editor.discriminate(new)), img_new)
        total = L.combine(reg, content, gan, no_content_loss=cfg.no_content_loss,
                          no_gan_loss=cfg.no_gan_loss,
                          pggan_gating=(cfg.model == "pggan"))
        total.backward()
        return {"loss": total.detach(), "reg_loss": reg.detach(),
                "content_loss": content.detach(), "gan_loss": gan.detach(),
                "alpha_target_mean": target.mean()}

    return step


def _zero_missing_grads(optimizer) -> None:
    """A zero gradient for every tensor the loss does not reach, as jax.grad
    gives, so that Adam steps every tensor as optax does."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def make_geometric_device_step(editor: Editor, optimizer: torch.optim.Optimizer,
                               train_embed: bool = False, mesh=None) -> Callable:
    """-> step(walk_params, z, alpha_graph, spec, index=None) -> metrics, the
    JAX package's step of the same name: with no gradient the original
    synthesis and its target and mask from ``spec`` = (kind, payload,
    clamp) of ``Task.device_spec``; then the walk-edited synthesis, the
    masked L2 against that target, and one Adam step on the walk in place.
    Both syntheses use G's stored noise. train_embed: ``index`` is the bank
    entry of the first attribute's bank that the step trains. Metrics are
    0-dim tensors on the device.

    mesh: z and alpha_graph are the global batch, and so is a colour
    spec's per-sample payload; the masked L2's mask sum is the global
    batch's (one all-reduce), so the loss and gradient are the JAX step's."""
    embed_name = editor.cfg.attr_list[0] if train_embed else None
    dp = _DataParallel(mesh)

    def step(walk_params, z, alpha_graph, spec, index=None):
        if train_embed and index is None:
            raise ValueError("train_embed step requires the bank index")
        alpha_graph = editor._tensor(alpha_graph)
        dp.rows(alpha_graph.shape[0])
        z, alpha_graph = dp.local(editor._tensor(z)), dp.local(alpha_graph)
        kind, payload, clamp = spec
        if kind in ("color", "colorlab"):  # per-sample sliders
            spec = (kind, payload[dp.lo:dp.hi], clamp)
        optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            latent = editor.edit_latent(z)
            target, mask = device_target(spec, editor.synth(latent))
        if train_embed:
            latent_new = editor.edit(walk_params, latent, alpha_graph, name=embed_name,
                                     index=index)
        else:
            latent_new = editor.edit(walk_params, latent, alpha_graph)
        img = editor.synth(latent_new)
        # the global batch's sum over its mask sum, once averaged over 'data'
        loss = L.masked_l2(img, target, mask, dp.mean(torch.sum(mask)))
        loss.backward()
        _zero_missing_grads(optimizer)
        metrics = dp.reduce(optimizer, {"loss": loss.detach(),
                                        "alpha_target_mean": alpha_graph.mean()})
        optimizer.step()
        return metrics

    return step


def make_geometric_train_step(editor: Editor, optimizer: torch.optim.Optimizer,
                              train_embed: bool = False) -> Callable:
    """-> step(walk_params, z, alpha_graph, target, mask, index=None) ->
    metrics, the JAX package's step of the same name: the walk-edited
    synthesis of z (G's stored noise), the masked L2 against the given
    target and mask (host-made, ``Task.get_target_np``), and one Adam step
    on the walk in place. Metrics (loss, alpha_target_mean) are 0-dim
    tensors on the device."""
    embed_name = editor.cfg.attr_list[0] if train_embed else None

    def step(walk_params, z, alpha_graph, target, mask, index=None):
        if train_embed and index is None:
            raise ValueError("train_embed step requires the bank index")
        alpha_graph = editor._tensor(alpha_graph)
        target, mask = editor._tensor(target), editor._tensor(mask)
        optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            latent = editor.edit_latent(editor._tensor(z))
        if train_embed:
            latent_new = editor.edit(walk_params, latent, alpha_graph, name=embed_name,
                                     index=index)
        else:
            latent_new = editor.edit(walk_params, latent, alpha_graph)
        loss = L.masked_l2(editor.synth(latent_new), target, mask)
        loss.backward()
        _zero_missing_grads(optimizer)
        optimizer.step()
        return {"loss": loss.detach(), "alpha_target_mean": alpha_graph.mean()}

    return step


def host_targets(editor: Editor, task: Task, z, alpha_target):
    """The --host_targets round trip of one batch: the original synthesis
    of z (G's stored noise, the JAX loop's ``orig_fn``) pulled to the host
    as float32, ``task.get_target_np`` on it, and the target and mask
    pushed back to the editor's device as float32."""
    with torch.no_grad():
        img = editor.synth(editor.edit_latent(editor._tensor(z)))
    target, mask = task.get_target_np(img.float().cpu().numpy(), alpha_target)
    return (torch.from_numpy(np.asarray(target, np.float32)).to(editor.device),
            torch.from_numpy(np.asarray(mask, np.float32)).to(editor.device))


def geometric_train_loop(
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
    mesh=None,
    device_targets: bool = True,
) -> tuple[dict, list[float]]:
    """The epoch loop of the geometric and color tasks around
    ``make_geometric_device_step``, with ``train_loop``'s callback, resume
    and preemption surface. device_targets=False (--host_targets): each
    step's target comes from the host round trip of ``host_targets`` and
    trains through ``make_geometric_train_step``; that path is per process
    and refuses a mesh, as the JAX loop does. Each epoch draws its z with
    ``sample_epoch_z`` and its sliders from RandomState(_alpha_seed(seed, epoch)) (one bank
    index per step under --trainEmbed), so --resume restarts an epoch
    reproducibly. The target is built for ``cfg.size``, G's resolution, as
    the JAX package builds it (a PGGAN editor's images are half that).
    mesh: batch_size is the global batch (``train_loop``). Returns
    (walk_params, loss_history)."""
    cfg = editor.cfg
    if not device_targets and mesh is not None:
        raise ValueError("the host-warp geometric path is per-host; mesh requires "
                         "device_targets=True")
    optimizer = _replicated_optimizer(walk_params, lr, opt_state, mesh)
    train_embed = cfg.walk_kind == "embed"
    if device_targets:
        step = make_geometric_device_step(editor, optimizer, train_embed=train_embed,
                                          mesh=mesh)
    else:
        host_step = make_geometric_train_step(editor, optimizer, train_embed=train_embed)

        def step(walk_params, z, alpha_graph, alpha_target, index=None):
            target, mask = host_targets(editor, task, z, alpha_target)
            return host_step(walk_params, z, alpha_graph, target, mask, index=index)
    history: list[float] = []
    iters = num_samples // batch_size
    for epoch in range(start_epoch, n_epochs):
        zs = torch.from_numpy(sample_epoch_z(num_samples, cfg.dim_z, seed=epoch)).to(
            editor.device)
        rng = np.random.RandomState(_alpha_seed(seed, epoch))
        for i in range(iters):
            if stop_flag is not None and meshlib.any_rank(mesh, stop_flag()):
                if on_preempt is not None:
                    on_preempt(epoch, walk_params, optimizer.state_dict())
                return walk_params, history
            t0 = time.time()
            index = None
            if train_embed:
                alpha_graph, alpha_target, index = task.train_alpha_embed_np(rng, batch_size)
            else:
                alpha_graph, alpha_target = task.train_alpha_np(rng, batch_size)
            # the device step takes the task's target spec, the host step its alpha
            spec = task.device_spec(alpha_target, cfg.size) if device_targets else alpha_target
            metrics = step(walk_params, zs[i * batch_size:(i + 1) * batch_size],
                           np.asarray(alpha_graph, np.float32), spec, index=index)
            if on_step is not None or (log_every and i % log_every == 0):
                metrics = {k: float(v) for k, v in metrics.items()}
                history.append(metrics["loss"])
                if on_step is not None:
                    on_step(epoch, i, metrics, time.time() - t0, walk_params)
        if on_epoch_end is not None:
            on_epoch_end(epoch, walk_params, optimizer.state_dict())
    return walk_params, history


def _replicated_optimizer(walk_params, lr, opt_state, mesh):
    """The walk as trainable leaves and its Adam (resumed from opt_state),
    both rank 0's on every rank of the mesh."""
    for p in walk_leaves(walk_params):
        p.requires_grad_(True)
    optimizer = make_optimizer(walk_params, lr)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)
    if mesh is not None:
        meshlib.replicate(mesh, walk_params)
        meshlib.replicate(mesh, optimizer)
    return optimizer


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
    frozen_provider: Callable | None = None,
    mesh=None,
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
    (RandomState(_alpha_seed(seed, epoch))) instead of on the device; the
    loop turns it on itself when the task's device sampler declines the
    vocabulary (ValueError, probed once on a generator of its own).
    frozen_provider(epoch, i) runs before each step, where the JAX package
    calls it: the --updateGAN fine-tune's D and G steps, which update the
    editor's frozen G and D in place for the walk step that follows. An
    'embed' walk (--trainEmbed) draws its slider and bank index per step
    from the same per-epoch RandomState.

    mesh (parallel/mesh.py): ``batch_size`` is the global batch, which
    the step shards over 'data'; every rank draws the same z, alphas and
    noise and steps Adam identically (the module docstring). stop_flag is
    agreed over the ranks, so all stop at the same step."""
    optimizer = _replicated_optimizer(walk_params, lr, opt_state, mesh)
    train_embed = editor.cfg.walk_kind == "embed"
    n_attr = len(editor.cfg.attr_list)
    if not (train_embed or host_alpha):
        try:
            task.train_alpha(torch.Generator(device=editor.device), 1, n_attr)
        except ValueError as e:
            # the vocabulary-mismatch signal (a dsprites --attrList subset);
            # any other error is a sampler fault and raises
            host_alpha = True
            print(f"note: device alpha sampler declined ({e}); "
                  "falling back to host-numpy sampling")
    step = make_train_step(editor, task, optimizer, host_alpha=host_alpha,
                           train_embed=train_embed, mesh=mesh)
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
            if stop_flag is not None and meshlib.any_rank(mesh, stop_flag()):
                if on_preempt is not None:
                    on_preempt(epoch, walk_params, optimizer.state_dict())
                return walk_params, history
            t0 = time.time()
            if frozen_provider is not None:
                frozen_provider(epoch, i)
            gen.manual_seed(_step_seed(seed, it_global))
            sampled = index = None
            if train_embed:
                sampled, _, index = task.train_alpha_embed_np(alpha_rng, batch_size, n_attr)
            elif host_alpha:
                sampled, _ = task.train_alpha_np(alpha_rng, batch_size, n_attr,
                                                 attr_list=list(editor.cfg.attr_list))
            metrics = step(walk_params, zs[i * batch_size:(i + 1) * batch_size],
                           gen, sampled, index)
            if on_step is not None or (log_every and i % log_every == 0):
                metrics = {k: float(v) for k, v in metrics.items()}
                history.append(metrics["loss"])
                if on_step is not None:
                    on_step(epoch, i, metrics, time.time() - t0, walk_params)
            it_global += 1
        if on_epoch_end is not None:
            on_epoch_end(epoch, walk_params, optimizer.state_dict())
    return walk_params, history
