"""Real-image W+ inversion CLI (the reference's BP.py) — PyTorch port of
latent2im_tpu/cli/bp.py, with the same flags and files.

    python -m latent2im_tpu_torch.cli.bp --img_dir <dir-of-images> \\
        --g_path <stylegan2.pt> --vgg16_path <vgg16.pth> --save_dir ./bp_out \\
        [--n_loops 500 --lr 1e-4 --optim Adam --resolution 256]

Inverts each batch of images into W+ (starting at the mean latent) and
writes ``org_{bi}.png``, ``{bi}_iterations_{loop}.png`` every --show_freq
loops, ``{bi}_final.png``, ``latent/{bi}_w.npy`` (the W+ that ``vis_w
--latents_dir`` edits) and the loss curve ``{bi}_loss.npy``. Images are
read without Pillow (``utils/image.py:read_image_rgb``: PNG, JPEG and WEBP
as Pillow decodes them; hierarchical and 12-bit JPEG raise), centre
cropped to a square and resized with Pillow's LANCZOS. Runs on the card
(``device`` cuda unless the caller asks for the CPU).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..device import resolve_device
from ..engine.inversion import invert, make_inverter
from ..models import stylegan2 as sg2
from ..models import vgg as vggm
from ..utils import image as imgmod


def load_images(img_dir: str, size: int) -> np.ndarray:
    """Load, centre-square, resize (LANCZOS), scale to [-1, 1] NHWC f32."""
    paths = sorted(
        os.path.join(img_dir, f)
        for f in os.listdir(img_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp"))
    )
    out = []
    for p in paths:
        im = imgmod.read_image_rgb(p)
        h, w = im.shape[:2]
        dim = min(w, h)
        top, left = (h - dim) // 2, (w - dim) // 2
        im = imgmod.pil_resize_lanczos(im[top:top + dim, left:left + dim], (size, size))
        out.append(im.astype(np.float32) / 127.5 - 1.0)
    if not out:
        raise FileNotFoundError(f"no images found in {img_dir}")
    return np.stack(out)


def _towers(args):
    """-> (G, VGG16) on the CPU: from --g_path / --vgg16_path, or random."""
    gen = torch.Generator().manual_seed(0)
    if args.g_path:
        ckpt = torch.load(args.g_path, map_location="cpu", weights_only=False)
        g = sg2.generator_from_state_dict(ckpt["g_ema"], args.resolution)
        # the reference loads d too (BP.py:315-332); it is unused by the
        # inversion loss, and loaded here only to validate the checkpoint
        if "d" in ckpt:
            d = sg2.Discriminator(args.resolution, channels=sg2.channels_from_state_dict(
                ckpt["g_ema"], args.resolution))
            d.load_state_dict(sg2.strip_blur_kernels(ckpt["d"]), strict=True)
            print("loaded full checkpoint surface: g_ema + d")
    else:
        print("WARNING: --g_path empty, random generator (smoke mode)")
        channels = {r: 8 for r in (4, 8, 16, 32, 64, 128, 256, 512, 1024)} \
            if args.dev_tiny else None
        g = sg2.Generator(args.resolution, 32 if args.dev_tiny else 512,
                          2 if args.dev_tiny else 8, channels=channels, generator=gen)
    vgg16 = vggm.VGG16Features(generator=torch.Generator().manual_seed(1))
    if args.vgg16_path:
        sd = torch.load(args.vgg16_path, map_location="cpu", weights_only=False)
        vgg16.load_state_dict(vggm.features_state_dict(sd), strict=True)
    else:
        print("WARNING: --vgg16_path empty, random vgg16 (smoke mode)")
    return g, vgg16


def main(argv=None, device=None):
    ap = argparse.ArgumentParser("BP inversion")
    ap.add_argument("--img_dir", required=True)
    ap.add_argument("--save_dir", default="./bp_out")
    ap.add_argument("--g_path", default="",
                    help="StyleGAN2 .pt (g_ema); random init when empty (smoke)")
    ap.add_argument("--vgg16_path", default="")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--n_loops", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--optim", default="Adam", choices=["Adam", "GD"])
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--show_freq", type=int, default=500)
    ap.add_argument("--dev_tiny", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(device)

    os.makedirs(os.path.join(args.save_dir, "latent"), exist_ok=True)
    g, vgg16 = _towers(args)
    imgs = load_images(args.img_dir, args.resolution)
    n_latent = sg2.n_latent(args.resolution)
    # one inverter for every batch, as the JAX CLI compiles one step
    inverter = make_inverter(g, vgg16, n_latent, args.lr, args.optim, device=device)

    for bi in range(0, len(imgs), args.batch_size):
        batch = imgs[bi:bi + args.batch_size]
        imgmod.save_im(imgmod.imgrid(imgmod.to_uint8(batch), cols=len(batch)),
                       os.path.join(args.save_dir, f"org_{bi}"))

        def on_loop(loop, loss, output, bi=bi, cols=len(batch)):
            print(f"[{loop}, {args.n_loops}]: MSE : {loss:.3f}")
            imgmod.save_im(imgmod.imgrid(imgmod.to_uint8(output.cpu().numpy()), cols=cols),
                           os.path.join(args.save_dir, f"{bi}_iterations_{loop}"))

        w, output, history = invert(
            g, vgg16, batch, n_latent, n_loops=args.n_loops, show_freq=args.show_freq,
            on_loop=on_loop, inverter=inverter,
            generator=torch.Generator(device=device).manual_seed(0))
        imgmod.save_im(imgmod.imgrid(imgmod.to_uint8(output.cpu().numpy()), cols=len(batch)),
                       os.path.join(args.save_dir, f"{bi}_final"))
        np.save(os.path.join(args.save_dir, "latent", f"{bi}_w.npy"), w.cpu().numpy())
        np.save(os.path.join(args.save_dir, f"{bi}_loss.npy"),
                np.asarray(history, np.float64))
        print("saved", os.path.join(args.save_dir, "latent", f"{bi}_w.npy"))


if __name__ == "__main__":
    main()
