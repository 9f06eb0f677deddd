"""Conversion-fidelity / quality-parity harness — PyTorch port of
latent2im_tpu/cli/parity_check.py.

  record   — this build's outputs for fixed seeds (the z batch, G(z) images
             NHWC in [-1, 1], every regressor output) into an .npz;
  compare  — a recorded .npz (from the JAX package, another machine, the
             CPU, or a reference export) against this build: max |diff|,
             PSNR, the VGG-feature distance (the content loss between the
             two image sets), the largest score difference when the file has
             scores, and LPIPS-proper when --lpips_path (PerceptualSimilarity
             vgg.pth heads) and --vgg16_path (a torchvision vgg16 state dict)
             are given.

    python -m latent2im_tpu_torch.cli.parity_check record --out ref.npz \\
        --g_path stylegan2.pt [--reg_path reg.model] [--n 8 --seed 0] [--device cpu]
    python -m latent2im_tpu_torch.cli.parity_check compare --ref ref.npz \\
        --g_path stylegan2.pt [--reg_path reg.model] [--lpips_path vgg.pth \\
        --vgg16_path vgg16.pth]

Runs on the card unless --device cpu asks for the CPU. The towers are the
training build's (face, Smiling, the package's own CelebA attribute file)
with the content loss's VGG19 kept, random from the seed where no path is
given.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..config.attributes import default_attr_path
from ..config.options import TrainOptions
from ..device import resolve_device
from ..engine.build import build_editor_from_options


def _build(args, device):
    # --models_dir names a directory the parse never creates
    argv = ["--transform", "face", "--attrList", "Smiling",
            "--attrPath", default_attr_path("face"), "--models_dir", "parity_check",
            "--overwrite_config", "--no_gan_loss"]
    for flag in ("g_path", "reg_path", "vgg_path"):
        if getattr(args, flag):
            argv += [f"--{flag}", getattr(args, flag)]
    if args.resolution:
        argv += ["--resolution", str(args.resolution)]
    if args.dev_tiny:
        argv += ["--dev_tiny"]
    editor, _, _ = build_editor_from_options(TrainOptions().parse(argv, print_opt=False),
                                             device=device)
    return editor


def _generate(editor, n: int, seed: int):
    z = np.random.RandomState(seed).randn(n, editor.cfg.dim_z).astype(np.float32)
    imgs = editor.synthesize(editor.edit_latent(z))
    scores = editor.regress_all(imgs)
    return z, imgs.cpu().numpy(), scores.cpu().numpy()


@torch.inference_mode()
def vgg_distance(editor, a, b) -> float:
    """The content loss between two image sets (VGG19 conv_1..4 MSE) — the
    LPIPS-style proxy; nan without a VGG19."""
    from ..engine.losses import content_loss

    if editor.vgg is None:
        return float("nan")
    return float(content_loss(editor.vgg, editor._tensor(a), editor._tensor(b)))


@torch.inference_mode()
def lpips_distance(args, a, b, device):
    """LPIPS (models/lpips.py) from --lpips_path and --vgg16_path, averaged
    over the batch; None unless both are given."""
    if not args.lpips_path or not args.vgg16_path:
        return None
    from ..models.lpips import LPIPS

    net = LPIPS.from_state_dicts(
        torch.load(args.lpips_path, map_location="cpu", weights_only=False),
        torch.load(args.vgg16_path, map_location="cpu", weights_only=False)).to(device)
    a, b = (torch.as_tensor(x, dtype=torch.float32, device=device) for x in (a, b))
    return float(torch.mean(net(a, b)))


def main(argv=None):
    ap = argparse.ArgumentParser("parity check")
    ap.add_argument("mode", choices=["record", "compare"])
    ap.add_argument("--out", default="parity.npz")
    ap.add_argument("--ref", default="")
    ap.add_argument("--g_path", default="")
    ap.add_argument("--reg_path", default="")
    ap.add_argument("--vgg_path", default="")
    ap.add_argument("--lpips_path", default="",
                    help="official LPIPS vgg.pth lin-head weights")
    ap.add_argument("--vgg16_path", default="",
                    help="torchvision vgg16 features state dict (LPIPS backbone)")
    ap.add_argument("--resolution", type=int, default=None)
    ap.add_argument("--dev_tiny", action="store_true")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cpu to run on the CPU (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    editor = _build(args, device)
    z, imgs, scores = _generate(editor, args.n, args.seed)

    if args.mode == "record":
        np.savez(args.out, z=z, images=imgs, scores=scores)
        print(f"recorded {args.n} samples -> {args.out}")
        return None

    ref = np.load(args.ref)
    if not np.allclose(ref["z"], z):
        raise ValueError("seed/z mismatch — use the same --seed/--n")
    a, b = ref["images"], imgs
    max_abs = float(np.max(np.abs(a - b)))
    mse = float(np.mean((a - b) ** 2))
    report = {
        "max_abs_pixel_diff": max_abs,
        "psnr_db": 10 * math.log10(4.0 / mse) if mse > 0 else float("inf"),  # range [-1, 1]
        "vgg_feature_distance": vgg_distance(editor, a, b),
    }
    if "scores" in ref.files:  # a reference export may omit the scores
        report["max_abs_score_diff"] = float(np.max(np.abs(ref["scores"] - scores)))
    lpips_val = lpips_distance(args, a, b, device)
    if lpips_val is not None:
        report["lpips"] = lpips_val
    for k, v in report.items():
        print(f"{k}: {v:.6g}")
    return report


if __name__ == "__main__":
    main()
