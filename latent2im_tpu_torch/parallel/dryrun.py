"""Multi-rank dry run — the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``.

    python -m latent2im_tpu_torch.parallel.dryrun [n] [--device cpu|cuda]

Launches n ranks (parallel/launch.py: gloo on the CPU or where ranks share a
card, NCCL where each has its own) and runs, at the JAX dry run's tiny
shapes (32 px, G and D at 8-16 channels, style dim 32, a 2-layer MLP, the
full ResNet-50 and VGG19), one data-parallel walk-training step over all n
ranks and, when n is even, the JAX dry run's dp+tp step on a (n/2 x 2)
data x model mesh (G tensor-parallel, parallel/tensor.py) and one step on
a (n/s x s) data x spatial mesh, s = 4 where it divides n, else 2. It
prints the JAX dry run's lines. A rank that fails fails the run.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..engine.editor import Editor, EditorConfig
from ..engine.train import make_optimizer, make_train_step
from ..models import resnet as rn
from ..models import stylegan2 as sg2
from ..models import vgg as vggm
from ..tasks.transforms import get_task
from ..walks import init_walk
from . import launch as launchlib
from . import mesh as meshlib
from . import spatial as splib

TINY = {4: 16, 8: 16, 16: 8, 32: 8}
SIZE, STYLE_DIM = 32, 32


def _step(editor, mesh, seed, frozen_shardings=None):
    """One walk-training step on ``mesh`` (global batch 2 per data rank) ->
    the loss."""
    walk = init_walk("linear_w", STYLE_DIM, editor.cfg.n_latent, ["Smiling"],
                     generator=torch.Generator().manual_seed(7), device=editor.device)
    for t in walk.values():
        t.requires_grad_(True)
    opt = make_optimizer(walk, 1e-4)
    meshlib.replicate(mesh, walk)
    step = make_train_step(editor, get_task("face"), opt, mesh=mesh,
                           frozen_shardings=frozen_shardings)
    z = np.random.RandomState(seed).randn(2 * mesh.shape["data"], STYLE_DIM).astype(np.float32)
    gen = torch.Generator(device=editor.device).manual_seed(seed)
    loss = float(step(walk, z, generator=gen)["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"dryrun loss not finite: {loss}")
    return loss


def _dryrun_rank(n: int, device: str) -> list[str]:
    """One rank's part -> rank 0's printed lines."""
    dev = torch.device(device)
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    gen = torch.Generator().manual_seed(0)

    def generator():  # the first draws of gen's seed
        return sg2.Generator(SIZE, STYLE_DIM, 2, channels=TINY,
                             generator=torch.Generator().manual_seed(0))

    g = sg2.Generator(SIZE, STYLE_DIM, 2, channels=TINY, generator=gen)
    d = sg2.Discriminator(SIZE, channels=TINY, generator=gen)
    reg = rn.ResNet50(num_outputs=40, generator=gen)
    vgg = vggm.VGG19Features(generator=gen)
    cfg = EditorConfig(attr_list=("Smiling",), attr_idx=(31,), size=SIZE, dim_z=STYLE_DIM)
    ed = Editor(cfg, g, reg, dev, vgg=vgg, d=d)
    lines = []
    mesh = meshlib.make_mesh(n)
    lines.append(f"dryrun_multichip({n}): one {n} dp step OK, loss={_step(ed, mesh, 0):.4f} "
                 f"({mesh.backend or 'one rank'}, {mesh.transport})")
    if n % 2 == 0:
        tp_mesh = meshlib.make_mesh_2d(n // 2, 2)
        # the tp step cuts its editor's G to this rank's shards: a G of its own
        tp_ed = Editor(cfg, generator(), reg, dev, vgg=vgg, d=d)
        loss = _step(tp_ed, tp_mesh, 0, meshlib.frozen_tp_shardings(tp_mesh,
                                                                    tp_ed.frozen_params()))
        lines.append(f"dryrun_multichip({n}): one {n // 2}x2 dp+tp step OK, loss={loss:.4f}")
        n_sp = max(s for s in (2, 4) if n % s == 0)
        sp_mesh = splib.make_mesh_spatial(n_spatial=n_sp, n_data=n // n_sp)
        with splib.spatial_partitioning(sp_mesh, min_rows_per_device=2):
            loss = _step(ed, sp_mesh, 1)
        lines.append(f"dryrun_multichip({n}): one {n // n_sp}x{n_sp} dp+sp step OK, "
                     f"loss={loss:.4f}")
    return lines


def dryrun_multichip(n_devices: int, device: str = "cpu") -> list[str]:
    """Launch ``n_devices`` ranks for the dry run; print and return rank 0's
    lines (raises if a rank fails)."""
    lines = launchlib.launch(_dryrun_rank, (n_devices, device), world_size=n_devices,
                             device=device, timeout=1800.0)
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    a = p.parse_args(argv)
    dryrun_multichip(a.n, a.device)


if __name__ == "__main__":
    main()
