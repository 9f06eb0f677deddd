"""Training CLI — single-attribute walk training; PyTorch port of
latent2im_tpu/cli/train.py.

    python -m latent2im_tpu_torch.cli.train --model stylegan_v2_real \
        --transform face --num_samples 20000 --learning_rate 1e-4 --latent w \
        --walk_type linear --loss l2 --attrList Smiling \
        --models_dir ./models_celeba --overwrite_config \
        [--g_path <stylegan2.pt> --reg_path <regressor.model>] [--resume]

Runs on the card (``device`` cuda unless the caller asks for the CPU). Per
epoch it writes ``model_w_{epoch}_walk_module.ckpt`` with the walk and its
Adam state (io/checkpoint.py: the JAX package's msgpack files, so either
package resumes the other's run), at the end ``model_w_{n}_final``. SIGTERM
writes a preemption checkpoint that ``--resume`` continues from.

``--updateGAN --real_data_dir DIR`` fine-tunes G and D with the walk
(engine/gan.py): before every walk step one WGAN-GP D step on real images
against the walk-edited images of the live G, and one G step through both
syntheses and the regressor, then G's EMA. The real images are DIR's PNG
and JPEG files, shuffled per epoch, decoded as libjpeg and libpng do and
resized without antialias by the native path (latent2im_tpu_torch/native,
the JAX package's native extension bit for bit), or, where that module is
hidden, drawn and decoded as the JAX package's Pillow fallback does. The GAN
goes to ``model_gan_{n}_final.ckpt`` at the end and
``model_gan_resume.ckpt`` on SIGTERM, in the JAX package's layout with both
Adam states; its ``.meta.json`` counts the GAN steps taken, so ``--resume``
also carries the fine-tune's random streams on where they stopped (the JAX
package restarts them).

``--transform color|colorlab|zoom|shiftx|shifty|rotate2d|rotate3d`` trains
the walk on the masked L2 against a target warped or recoloured on the
device (engine/train.py:geometric_train_loop), logging every step and
saving no sample grids; ``--host_targets`` takes the JAX package's cv2
host path instead (the original pulled to the host, warped by the task's
``get_target_np`` with tasks/cv2_np.py, pushed back). That path is one
process on one device: under ``--n_devices N`` it launches no ranks and
trains the global batch of ``--batch_size`` x N there, as the JAX CLI runs
it with no mesh.

``--n_devices N`` (data parallel) and ``--sp_devices S`` (G's image rows
over S ranks, for StyleGAN2 and the PGGAN backends; with N, an N x S mesh) run N x S ranks, one process each:
launched here (parallel/launch.py; gloo when ranks share a card or run on
the CPU, NCCL when each has its own card) or joined under torchrun. The
global batch is ``--batch_size`` x N, as in the JAX package; every rank
trains the same walk, and rank 0 alone writes the checkpoints, logs and
sample grids. ``--updateGAN`` under a mesh runs as the JAX package's
(cli/train.py:260-371 there): rank 0 alone draws the GAN's batches and runs
its D step, G step and EMA on the whole ``--batch_size`` batch, then
broadcasts G and D to every rank before the walk step (``replicate``), and
writes the GAN checkpoints; the bytes and milliseconds of that broadcast are
logged per iteration.
"""

from __future__ import annotations

import contextlib
import glob
import logging
import math
import os
import signal
import time

import numpy as np
import torch

from ..config.options import TrainOptions
from ..device import resolve_device
from ..models import hooks
from ..engine.build import build_editor_from_options
from ..engine.gan import GANModule, draw_eps, make_gan_update_steps
from ..engine.train import geometric_train_loop, make_optimizer, train_loop
from ..io import checkpoint as ckpt
from ..parallel import launch as launchlib
from ..parallel import mesh as meshlib
from ..parallel.spatial import make_mesh_spatial, spatial_partitioning
from ..tasks.geometric import GEOMETRIC_TASKS
from ..tasks.transforms import get_task, task_kwargs_from_options
from ..utils import image as imgmod
from ..utils import logging as logmod
from ..utils.loader import Loader
from ..walks import walk_map

N_EPOCH_SINGLE = 10  # train.py:34
GAN_RESUME = "model_gan_resume.ckpt"


def run(opt, n_epoch_default: int = N_EPOCH_SINGLE,
        save_loss_artifacts: bool = False, device=None):
    """Train the walk of ``opt`` on ``device`` (cuda unless the caller asks
    for the CPU) -> (walk_params, loss history)."""
    device = resolve_device(device)
    if opt.updateGAN:
        _refuse_gan(opt)
    n_data, n_sp = (getattr(opt, "n_devices", None) or 1), (getattr(opt, "sp_devices", None) or 1)
    geometric = opt.transform in GEOMETRIC_TASKS
    # the host-warp path runs with no mesh (the JAX CLI's mesh=None), on
    # the global batch: no ranks to launch
    host = geometric and bool(getattr(opt, "host_targets", False))
    mesh, sp_ctx = None, contextlib.nullcontext()
    if n_data * n_sp > 1 and not host:
        if not launchlib.is_rank(n_data * n_sp, device):
            return launchlib.launch(run, (opt, n_epoch_default, save_loss_artifacts, device),
                                    world_size=n_data * n_sp, device=device)
        if n_sp > 1:
            mesh = make_mesh_spatial(n_spatial=n_sp, n_data=n_data)
            sp_ctx = spatial_partitioning(mesh)
        else:
            mesh = meshlib.make_mesh(n_data)
    main_rank = mesh is None or mesh.is_main
    output_dir = opt.output_dir
    if main_rank:
        os.makedirs(os.path.join(output_dir, "results"), exist_ok=True)
        os.makedirs(os.path.join(output_dir, "logs"), exist_ok=True)
        logmod.configure(os.path.join(output_dir, "log.txt"))

    editor, walk_params, info = build_editor_from_options(opt, device=device)
    task = get_task(opt.transform, walk_type=opt.walk_type,
                    nsliders=len(info["attr_list"]), **task_kwargs_from_options(opt))

    start_epoch, opt_state = 0, None
    if getattr(opt, "resume", False):
        latest = ckpt.find_resume(output_dir)
        if latest:
            like_state = make_optimizer(walk_params, opt.learning_rate).state_dict()
            walk_params, opt_state, meta = ckpt.load_walk(
                latest, walk_params, opt_state_like=like_state
            )
            start_epoch = int((meta or {}).get("epoch", -1)) + 1
            logging.info("resuming from %s at epoch %d", latest, start_epoch)

    gan = None
    if opt.updateGAN:
        # D sees real images against the walk-EDITED images of the live G;
        # the walk step then trains against the updated G and D
        gan = _make_gan_provider(editor, opt, task, walk_params, mesh)

    n_epochs = opt.n_epochs or n_epoch_default
    # the global batch scales with the data axis only, as in the JAX package
    batch = opt.batch_size * n_data
    writer = _maybe_tensorboard(os.path.join(output_dir, "logs")) if main_rank else None
    save_freq = opt.model_save_freq
    loss_values: list[float] = []
    step_counter = {"n": 0}

    def on_step(epoch, i, metrics, dt, current_walk):
        loss = metrics["loss"]
        loss_values.append(loss)
        if writer is not None:
            writer.add_scalar("Loss/train", loss, step_counter["n"])
        logging.info(
            "T, epc, bst, lss, alpha: %.3f, %d, %d, %.5f, %.2f",
            dt, epoch, i * batch, loss, metrics["alpha_target_mean"],
        )
        step_counter["n"] += 1
        # apply_alpha regresses attribute targets, meaningless for a pixel
        # target (geometric grids come from vis_w), and an 'embed' walk
        # ignores alpha, so apply_alpha refuses it: no grids for either
        if (save_freq and i % save_freq == 0 and not geometric
                and editor.cfg.walk_kind != "embed"):
            # every rank synthesizes (under sp the rows are spread over
            # them); rank 0 writes
            _save_samples(editor, current_walk, output_dir, epoch, i, batch, main_rank)

    def on_epoch_end(epoch, wp, st):
        if main_rank:
            ckpt.save_walk(output_dir, epoch, wp, opt_state=st)
            logging.info("Save W in %s", ckpt.walk_ckpt_path(output_dir, epoch))

    # Preemption safety: a scheduler delivers SIGTERM before it reclaims the
    # machine; checkpoint walk + optimizer state and stop, so --resume
    # continues where the run stopped.
    stop_box = {"stop": False}

    def _on_sigterm(signum, frame):
        logging.warning("SIGTERM received: checkpointing and stopping")
        stop_box["stop"] = True

    def on_preempt(epoch, wp, st):
        stop_box["preempted"] = True
        if not main_rank:
            return
        # meta epoch = epoch-1 so --resume RE-RUNS the interrupted epoch
        # (repeating a few steps is benign; skipping half an epoch is not)
        path = ckpt.save_walk(output_dir, epoch, wp, opt_state=st,
                              extra_meta={"epoch": epoch - 1, "preempted": True})
        if gan is not None:
            _save_gan(gan, os.path.join(output_dir, GAN_RESUME))
            logging.warning("fine-tuned GAN preemption checkpoint written")
        logging.warning("preemption checkpoint written: %s", path)

    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        with logmod.profile_trace(getattr(opt, "profile_dir", "")), sp_ctx:
            run_kw = dict(num_samples=opt.num_samples, batch_size=batch, n_epochs=n_epochs,
                          lr=opt.learning_rate, log_every=1, on_step=on_step,
                          on_epoch_end=on_epoch_end, start_epoch=start_epoch,
                          opt_state=opt_state, stop_flag=lambda: stop_box["stop"],
                          on_preempt=on_preempt, mesh=mesh)
            if geometric:
                walk_params, history = geometric_train_loop(editor, task, walk_params,
                                                            device_targets=not host, **run_kw)
            else:
                walk_params, history = train_loop(editor, task, walk_params,
                                                  frozen_provider=gan, **run_kw)
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        if writer is not None:
            writer.close()
        if gan is not None:
            gan.close()
    if mesh is not None:  # rank 0's result crosses to the launching process
        walk_params = walk_map(lambda t: t.detach().cpu(), walk_params)
    if stop_box.get("preempted") or not main_rank:
        return walk_params, history
    ckpt.save_walk(output_dir, n_epochs, walk_params, final=True)
    if getattr(opt, "export_ref_walk", False):
        # reference-format module pickle beside the msgpack checkpoint,
        # loadable by the reference's load_multi_models
        # (transform_base.py:497-505)
        from ..io.torch_convert import export_walk_torch

        export_walk_torch(
            os.path.join(output_dir, f"model_w_{n_epochs}_final_ref_walk_module.ckpt"),
            editor.cfg.walk_kind, walk_params, attr_list=list(info["attr_list"]),
        )
    if gan is not None:  # the reference's save_path_gan surface
        _save_gan(gan, os.path.join(output_dir, f"model_gan_{n_epochs}_final.ckpt"))
    if save_loss_artifacts:
        np.save(os.path.join(output_dir, "loss_values.npy"), np.asarray(loss_values))
        _save_loss_curve(loss_values, os.path.join(output_dir, "loss_curve.png"))
    return walk_params, history


def _refuse_gan(opt):
    """The JAX package's refusals of --updateGAN (cli/train.py:38-45, 63-69,
    336 there)."""
    if "stylegan" not in opt.model:
        raise SystemExit("--updateGAN is implemented for the stylegan models only "
                         "(the reference's PGGAN updateGAN path is dead code)")
    if opt.no_gan_loss:
        raise SystemExit("--updateGAN needs a discriminator; drop --no_gan_loss")
    if opt.transform in GEOMETRIC_TASKS:
        raise SystemExit("--updateGAN with a geometric transform is unsupported: the "
                         "masked-L2 walk objective has no GAN term")
    if not opt.real_data_dir:
        raise SystemExit("--updateGAN needs --real_data_dir")


def _save_gan(provider, path):
    ckpt.save_gan(path, provider.module, meta={"gan_steps": provider.steps["n"]})


def _real_paths(root: str) -> list[str]:
    """The sorted .png/.jpg/.jpeg files under ``root`` (recursive), as the JAX
    package lists them."""
    paths = sorted(p for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                   if p.lower().endswith((".png", ".jpg", ".jpeg")))
    if not paths:
        raise SystemExit(f"no images under {root}")
    return paths


def _make_real_batcher(paths, size: int, batch_size: int, host_cpp: bool = False):
    """-> next_batch(load=True) -> [B, size, size, 3] uint8, as the JAX
    package's cli/train.py:_make_real_batcher: its native extension's
    Loader first, here the port's ``native`` counterpart
    (``_native_batcher``); where that module cannot be imported, each
    batch RandomState(0).randint(0, len(paths), B) images, as its
    pure-Python loader draws them, decoded ahead by the threaded
    utils/loader.py (``host_cpp``: through the host C++ of the card's
    path). load=False only draws the indices (a resume replaying the
    stream, before the first batch is loaded). ``next_batch.loader`` is
    the loader to close."""
    try:
        from ..native import _l2i_native as nat
    except ImportError:
        nat = None
    if nat is not None:
        return _native_batcher(nat.Loader(paths, size, batch_size, threads=2), batch_size)
    rng = np.random.RandomState(0)
    loader = Loader(lambda j: imgmod.load_and_resize_image(paths[j], size, host_cpp))
    stream = None

    def draws():
        while True:
            yield rng.randint(0, len(paths), size=batch_size)

    def next_batch(load: bool = True):
        nonlocal stream
        if not load:
            if stream is not None:  # the loader has drawn ahead
                raise RuntimeError("the real-image stream replays only before its first batch")
            rng.randint(0, len(paths), size=batch_size)
            return None
        if stream is None:
            stream = loader.batches(draws())
        return next(stream)[0]

    next_batch.loader = loader
    return next_batch


def _native_batcher(loader, batch_size: int):
    """The JAX package's ``next_native`` over a native Loader:
    ``start_epoch(seed=0)``, the next epoch's seed one more at each
    StopIteration; rows of ragged batches carried in a buffer, a full batch
    passed through where the buffer is empty. load=False replays one batch
    of indices (``Loader.skip_batch``) and decodes nothing; the rows it
    leaves in the buffer are decoded at the first batch loaded."""
    epoch = 0
    buf: list = []  # rows, or their indices while replaying
    loaded = False
    loader.start_epoch(seed=0, shuffle=True)

    def next_batch(load: bool = True):
        nonlocal epoch, loaded
        if not load and loaded:
            raise RuntimeError("the real-image stream replays only before its first batch")
        if load and not loaded:
            loaded = True
            buf[:] = [loader.load(r) if isinstance(r, int) else r for r in buf]
        while True:
            if len(buf) >= batch_size:
                out = buf[:batch_size]
                del buf[:batch_size]
                return np.stack(out) if load else None
            try:
                if load:
                    rows, idx = loader.next_batch()
                else:
                    idx = loader.skip_batch()
                    rows = list(idx)
            except StopIteration:
                epoch += 1
                loader.start_epoch(seed=epoch, shuffle=True)
                continue
            if not buf and len(idx) == batch_size:
                return rows if load else None
            buf.extend(rows)

    next_batch.loader = loader
    return next_batch


def make_g_apply(editor):
    """-> g_apply(batch) -> the walk-edited images of the editor's live G, the
    JAX package's g_apply (cli/train.py:308-316 there): w = get_w(z), orig =
    synthesize(w), delta = alpha - regress(orig), synthesize(edit(walk, w,
    delta)), with the stored noise maps and nothing detached, so a G step's
    gradient flows through both syntheses and the regressor. batch: {"z",
    "alpha", "walk"}."""
    def g_apply(batch):
        latent = editor.latent_of(batch["z"])
        orig = editor.synth(latent)
        delta = batch["alpha"] - editor.scores(orig)
        return editor.synth(editor.edit(batch["walk"], latent, delta))

    return g_apply


def _make_gan_provider(editor, opt, task, walk_params, mesh=None):
    """The per-iteration GAN update for --updateGAN (the JAX package's
    cli/train.py:_make_gan_provider): one D step and one G step on the
    editor's G and D, before each walk step. z and the alphas come from its
    own RandomState(0), the real batches from _make_real_batcher, eps from a
    torch.Generator seeded 123. With --resume and a model_gan_resume.ckpt it
    restores G, D, g_running and both Adam states, and replays the streams
    past the steps the checkpoint counts. -> provider(epoch, i), carrying
    ``.module`` (the GANModule), ``.steps`` ({"n": steps taken}) and
    ``.broadcasts`` (per iteration under a mesh: {"bytes", "ms"} of G and D
    crossing from rank 0).

    Under a mesh rank 0 alone holds the GANModule, the loader and the random
    streams and runs the steps, outside the walk step's row plan (the GAN
    runs on the whole image); every rank then takes G and D from rank 0, so
    the walk step that follows sees the updated towers everywhere. The other
    ranks draw nothing (``.module`` None)."""
    if editor.d is None:
        raise SystemExit("--updateGAN needs a discriminator")
    main = mesh is None or mesh.is_main
    towers = (list(editor.g.parameters()), list(editor.d.parameters()))  # what the steps train
    steps, broadcasts = {"n": 0}, []

    def replicate_towers():
        if mesh is None:
            return
        t0 = time.perf_counter()
        for m in towers:
            meshlib.replicate(mesh, m)
        if editor.device.type == "cuda":
            torch.cuda.synchronize(editor.device)
        broadcasts.append({"bytes": sum(map(meshlib.tree_bytes, towers)),
                           "ms": (time.perf_counter() - t0) * 1e3})

    if not main:
        replicate_towers()  # rank 0's, restored or not

        def follower(epoch, i):
            replicate_towers()
            logging.info("gan towers from rank 0: %d bytes, %.3f ms", *broadcasts[-1].values())

        follower.module, follower.steps, follower.broadcasts = None, steps, broadcasts
        follower.close = lambda: None
        return follower

    paths = _real_paths(opt.real_data_dir)
    mod = GANModule.create(editor.g, editor.d, lr=opt.gan_lr)
    resume_path = os.path.join(opt.output_dir, GAN_RESUME)
    if getattr(opt, "resume", False) and os.path.isfile(resume_path):
        meta = ckpt.load_gan(resume_path, mod)
        steps["n"] = int((meta or {}).get("gan_steps", 0))
        logging.info("restored fine-tuned GAN from %s after %d steps", resume_path,
                     steps["n"])
    replicate_towers()

    d_step, g_step = make_gan_update_steps(make_g_apply(editor), editor.discriminate, mod)
    next_real = _make_real_batcher(paths, editor.cfg.size, opt.batch_size,
                                   host_cpp=editor.device.type == "cuda")
    rng = np.random.RandomState(0)
    eps_gen = torch.Generator(device=editor.device).manual_seed(123)
    b, n_attr = opt.batch_size, len(editor.cfg.attr_idx)
    walk = walk_map(torch.Tensor.detach, walk_params)  # the live walk, no graph

    def draw(load: bool = True):
        real = next_real(load)
        z = rng.randn(b, editor.cfg.dim_z)
        alpha, _ = task.train_alpha_np(rng, b, n_attr)
        return real, z, alpha, draw_eps(eps_gen, b, editor.device)

    for _ in range(steps["n"]):
        draw(load=False)

    def provider(epoch, i):
        real, z, alpha, eps = draw()
        batch = {"z": editor._tensor(z), "alpha": editor._tensor(alpha), "walk": walk}
        prev = hooks.install(None)  # the whole image: no row plan
        try:
            dm = d_step(batch, editor._tensor(real) / 127.5 - 1.0, eps=eps)
            gm = g_step(batch)
        finally:
            hooks.restore(prev)
        steps["n"] += 1
        logging.info("gan d_loss, grad_penalty, g_loss: %.5f, %.5f, %.5f",
                     float(dm["d_loss"]), float(dm["grad_penalty"]), float(gm["g_loss"]))
        replicate_towers()
        if broadcasts:
            logging.info("gan towers to every rank: %d bytes, %.3f ms",
                         *broadcasts[-1].values())

    provider.module, provider.steps, provider.broadcasts = mod, steps, broadcasts
    provider.close = next_real.loader.close
    return provider


def _save_samples(editor, walk_params, output_dir, epoch, i, batch_size, write=True):
    """Periodic org/edited sample grids (train.py:118-122, :137-144);
    write=False synthesizes them without writing (a rank other than 0)."""
    try:
        z = np.random.RandomState(epoch * 10000 + i).randn(
            min(batch_size, 4), editor.cfg.dim_z
        ).astype(np.float32)
        target = np.full((z.shape[0], len(editor.cfg.attr_list)), 0.9, np.float32)
        edited, _, orig = editor.apply_alpha(walk_params, z, target, u8=True)
        if not write:
            return
        cols = int(math.sqrt(max(z.shape[0], 1))) or 1
        for name, im in (("org", orig), ("logit", edited)):
            grid = imgmod.imgrid(im.cpu().numpy(), cols=cols)
            imgmod.save_im(
                grid,
                os.path.join(output_dir, "results", f"{epoch}_{i * batch_size}_{name}"),
            )
    except Exception:  # sample saving must never kill training
        logging.exception("make_samples failed")


def _save_loss_curve(values, path):
    try:
        import matplotlib
    except ImportError:
        logging.warning("matplotlib unavailable; skipped loss curve png")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.plot(values)
    plt.xlabel("step")
    plt.ylabel("loss")
    plt.savefig(path)
    plt.close()


def _maybe_tensorboard(log_dir):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        logging.warning("tensorboard unavailable; scalar logging to log.txt only")
        return None
    return SummaryWriter(log_dir)


def main():
    opt = TrainOptions().parse()
    run(opt)


if __name__ == "__main__":
    main()
