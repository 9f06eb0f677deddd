"""Inference / latent-sweep visualization CLI — PyTorch port of
latent2im_tpu/cli/vis_w.py.

Loads the training run's opt.yml and a walk checkpoint, writes per-sample
alpha-sweep panels (num_panels linspace min->max alpha) as PNG grids named
with the original attribute score, and an index.html gallery. The panels of
a batch synthesize through Editor.sweep, not a host loop per alpha.

    python -m latent2im_tpu_torch.cli.vis_w <run_dir>/opt.yml \
        --save_path_w <run_dir>/model_w_9_walk_module.ckpt \
        --output_dir ./vis_out [--noise_seed 0] [--combine_indices 31,39] \
        [--n_devices N] [--sp_devices S]

--n_devices / --sp_devices run the sweeps over an N x S mesh of ranks
(parallel/spatial.py:setup_inference_mesh; launched here or joined under
torchrun): the batch shards over the data axis, G's rows (every generator
family) over the spatial one, and rank 0 writes the same PNGs and index.html as one process.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..config.options import VisOptions
from ..device import resolve_device
from ..engine.build import load_editor_for_inference
from ..engine.train import sample_epoch_z
from ..parallel import launch as launchlib
from ..parallel.spatial import setup_inference_mesh
from ..tasks.transforms import get_task, task_kwargs_from_options
from ..utils import html as htmlmod
from ..utils import image as imgmod

BATCH = 8  # z per sweep call; its P panels fold into the batch


def _batch_start(path):
    # bp.py names files by numeric batch start (0_w, 4_w, 12_w...);
    # lexicographic order would interleave digit widths
    stem = os.path.basename(path).split("_")[0]
    return (0, int(stem)) if stem.isdigit() else (1, path)


def run(opt, conf, device=None):
    """Sweep panels of the walk on ``device`` (cuda unless the caller asks
    for the CPU) -> the output directory."""
    device = resolve_device(device)
    n = (getattr(opt, "n_devices", None) or 1) * (getattr(opt, "sp_devices", None) or 1)
    if n > 1 and not launchlib.is_rank(n, device):
        return launchlib.launch(run, (opt, conf, device), world_size=n, device=device)
    output_dir = opt.output_dir or os.path.join(getattr(conf, "output_dir", "."), "vis")

    editor, walk_params, info = load_editor_for_inference(opt, conf, device)
    editor, walk_params, mesh, sp_ctx = setup_inference_mesh(opt, editor, walk_params)
    write = mesh is None or mesh.is_main
    if write:
        os.makedirs(output_dir, exist_ok=True)
    with sp_ctx:
        _sweeps(opt, conf, editor, walk_params, info, output_dir, write)
    if write:
        htmlmod.make_html(output_dir)
    return output_dir


def _sweeps(opt, conf, editor, walk_params, info, output_dir, write):
    """The panels of every batch; only ``write`` saves them."""
    task = get_task(conf.transform, walk_type=conf.walk_type,
                    nsliders=len(info["attr_list"]), **task_kwargs_from_options(conf))
    alphas = np.linspace(opt.min_alpha, opt.max_alpha, opt.num_panels)

    # Real-image editing: --latents_dir takes the W+ latents an inversion
    # wrote ({i}_w.npy) and sweeps those instead of sampled z
    # (transform_base.py:561-564 given_w).
    latents = None
    if getattr(opt, "latents_dir", ""):
        files = sorted(glob.glob(os.path.join(opt.latents_dir, "*_w.npy")),
                       key=_batch_start)
        if not files:
            raise FileNotFoundError(f"no *_w.npy under {opt.latents_dir}")
        latents = np.concatenate([np.load(f) for f in files]).astype(np.float32)
        opt.num_samples = len(latents)
        print(f"editing {len(latents)} inverted latents from {opt.latents_dir}")
    zs = sample_epoch_z(opt.num_samples, editor.cfg.dim_z, seed=opt.noise_seed)

    combine = getattr(opt, "combine_indices", "")
    idx = [int(i) for i in combine.split(",")] if combine else None
    if idx is not None and len(idx) != 2:
        raise ValueError("--combine_indices wants two attribute indices")
    for batch_start in range(0, opt.num_samples, BATCH):
        z = zs[batch_start:batch_start + BATCH]
        gw = None if latents is None else latents[batch_start:batch_start + BATCH]
        if idx is not None:
            # 2-attribute grid (transform_base.py:814-869): all (a_i, a_j) pairs
            imgs, _, _ = editor.sweep_combine(walk_params, z, alphas, indices=idx,
                                              given_w=gw, u8=True)
            grid = imgs.cpu().numpy()  # [P, P, B, H, W, 3]
            p = len(alphas)
            for ii in range(z.shape[0]):
                panel = grid[:, :, ii].reshape(p * p, *grid.shape[3:])
                name = f"combine_idx{idx[0]}_idx{idx[1]}_sample{batch_start + ii}"
                if write:
                    imgmod.save_im(imgmod.imgrid(panel, cols=p),
                                   os.path.join(output_dir, name))
                    print("Save in", os.path.join(output_dir, name))
            continue
        # panel slider matrix [P, B, A] (scale_test_alpha_for_graph semantics)
        panels = np.stack(
            [task.scale_test_alpha(a, z.shape[0]) for a in alphas]
        ).astype(np.float32)
        imgs, alpha_org, _ = editor.sweep(walk_params, z, panels, given_w=gw, u8=True)
        imgs = imgs.cpu().numpy()  # [P, B, H, W, 3] uint8
        alpha_org = alpha_org.cpu().numpy()
        for ii in range(z.shape[0] if write else 0):
            name = f"sample{batch_start + ii}_{float(alpha_org[ii, 0]):.2f}"
            imgmod.save_im(imgmod.imgrid(imgs[:, ii], cols=len(alphas)),
                           os.path.join(output_dir, name))
            print("Save in", os.path.join(output_dir, name))


def main(argv=None):
    opt, conf = VisOptions().parse(argv)
    run(opt, conf)


if __name__ == "__main__":
    main()
