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
"""

from __future__ import annotations

import logging
import math
import os
import signal

import numpy as np

from ..config.options import TrainOptions
from ..device import resolve_device
from ..engine.build import _not_ported, build_editor_from_options
from ..engine.train import make_optimizer, train_loop
from ..io import checkpoint as ckpt
from ..tasks.transforms import get_task, task_kwargs_from_options
from ..utils import image as imgmod
from ..utils import logging as logmod

N_EPOCH_SINGLE = 10  # train.py:34


def run(opt, n_epoch_default: int = N_EPOCH_SINGLE,
        save_loss_artifacts: bool = False, device=None):
    """Train the walk of ``opt`` on ``device`` (cuda unless the caller asks
    for the CPU) -> (walk_params, loss history)."""
    device = resolve_device(device)
    if opt.updateGAN:
        _not_ported("--updateGAN (the joint GAN fine-tune)", "queue A item 11")
    for flag in ("n_devices", "sp_devices"):
        if (getattr(opt, flag, None) or 1) > 1:
            _not_ported(f"--{flag} > 1 (multi-device training)", "queue A item 15")
    output_dir = opt.output_dir
    os.makedirs(os.path.join(output_dir, "results"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "logs"), exist_ok=True)
    logmod.configure(os.path.join(output_dir, "log.txt"))

    # a transform the port lacks (the geometric/color tasks, ROADMAP.md queue
    # A item 12) raises here, before the towers are built
    get_task(opt.transform)
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

    n_epochs = opt.n_epochs or n_epoch_default
    batch = opt.batch_size
    writer = _maybe_tensorboard(os.path.join(output_dir, "logs"))
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
        if save_freq and i % save_freq == 0:
            _save_samples(editor, current_walk, output_dir, epoch, i, batch)

    def on_epoch_end(epoch, wp, st):
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
        # meta epoch = epoch-1 so --resume RE-RUNS the interrupted epoch
        # (repeating a few steps is benign; skipping half an epoch is not)
        path = ckpt.save_walk(output_dir, epoch, wp, opt_state=st,
                              extra_meta={"epoch": epoch - 1, "preempted": True})
        stop_box["preempted"] = True
        logging.warning("preemption checkpoint written: %s", path)

    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        with logmod.profile_trace(getattr(opt, "profile_dir", "")):
            walk_params, history = train_loop(
                editor,
                task,
                walk_params,
                num_samples=opt.num_samples,
                batch_size=batch,
                n_epochs=n_epochs,
                lr=opt.learning_rate,
                log_every=1,
                on_step=on_step,
                on_epoch_end=on_epoch_end,
                start_epoch=start_epoch,
                opt_state=opt_state,
                stop_flag=lambda: stop_box["stop"],
                on_preempt=on_preempt,
            )
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        if writer is not None:
            writer.close()
    if stop_box.get("preempted"):
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
    if save_loss_artifacts:
        np.save(os.path.join(output_dir, "loss_values.npy"), np.asarray(loss_values))
        _save_loss_curve(loss_values, os.path.join(output_dir, "loss_curve.png"))
    return walk_params, history


def _save_samples(editor, walk_params, output_dir, epoch, i, batch_size):
    """Periodic org/edited sample grids (train.py:118-122, :137-144)."""
    try:
        z = np.random.RandomState(epoch * 10000 + i).randn(
            min(batch_size, 4), editor.cfg.dim_z
        ).astype(np.float32)
        target = np.full((z.shape[0], len(editor.cfg.attr_list)), 0.9, np.float32)
        edited, _, orig = editor.apply_alpha(walk_params, z, target, u8=True)
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
