"""Assemble an Editor + walk from parsed options — PyTorch port of the
StyleGAN2 branch of latent2im_tpu/engine/build.py:36-257.

options -> attribute vocabulary -> frozen generator, regressor, and for the
training losses the discriminator and VGG19 (loaded from PyTorch checkpoints
with ``load_state_dict``, or randomly initialized at full width from
``seed`` with a loud warning; D and VGG19 are left out under --no_gan_loss
and --no_content_loss) -> Editor + walk params, on ``device`` (cuda unless
the caller asks for the CPU).
"""

from __future__ import annotations

import logging
import warnings

import torch

from ..config import attributes as attrs
from ..device import resolve_device
from ..models import resnet as rn
from ..models import stylegan2 as sg2
from ..models import vgg as vggm
from ..walks import init_walk, resolve_walk_kind
from .editor import Editor, EditorConfig

DIM_Z = 512  # the reference's constants.py:2
RESOLUTION = 256  # constants.py:3
TINY_CHANNELS = {r: (16 if r <= 8 else 8) for r in
                 (4, 8, 16, 32, 64, 128, 256, 512, 1024)}


def _load_torch(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def build_editor_from_options(opt, seed: int = 0, device=None):
    """-> (editor, walk_params, info dict)."""
    device = resolve_device(device)
    model = opt.model
    if model == "pggan" or "stylegan" not in model:
        _not_ported(f"the {model!r} backend", "queue A item 13")
    if getattr(opt, "bf16", False):
        _not_ported("--bf16 compute", "queue A item 20")
    latent = opt.stylegan.latent
    walk_kind = resolve_walk_kind(
        model, opt.walk_type, latent, train_embed=opt.trainEmbed,
        is_mlp=getattr(opt, "is_mlp", False),
    )
    attr_list, attr_table = attrs.build_attr_vocab(
        opt.transform, attr_path=opt.attrPath, attr_list=opt.attrList
    )
    attr_idx = attrs.attr_indices(attr_list, attr_table)
    layers = attrs.parse_layers(opt.layers)

    gen = torch.Generator().manual_seed(seed)
    size = getattr(opt, "resolution", None) or RESOLUTION
    dim_z, n_mlp, channels = DIM_Z, 8, None
    if getattr(opt, "dev_tiny", False):
        dim_z, n_mlp, channels = 32, 2, TINY_CHANNELS

    g_path = getattr(opt, "g_path", "")
    d_sd = None
    if g_path:
        ckpt = _load_torch(g_path)
        # the blur/upsample FIR buffers of rosinality checkpoints are fixed
        # [1, 3, 3, 1] kernels the port rebuilds itself
        sd = sg2.strip_blur_kernels(ckpt["g_ema"])
        dim_z = int(sd["style.1.weight"].shape[1])
        n_mlp = sum(1 for k in sd if k.startswith("style.") and k.endswith(".weight"))
        channels = sg2.channels_from_state_dict(sd, size)
        g = sg2.Generator(size, dim_z, n_mlp, channels=channels)
        g.load_state_dict(sd, strict=True)
        if "d" in ckpt:
            d_sd = sg2.strip_blur_kernels(ckpt["d"])
    else:
        warnings.warn(
            "--g_path not given: using a RANDOMLY initialized generator "
            "(smoke/bench mode, not a trained model)"
        )
        g = sg2.Generator(size, dim_z, n_mlp, channels=channels, generator=gen)

    reg_path = getattr(opt, "reg_path", "")
    reg = rn.ResNet50(num_outputs=len(attr_table), generator=gen)
    if reg_path:
        ckpt = _load_torch(reg_path)
        sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
        reg.load_state_dict(sd, strict=True)
    else:
        warnings.warn(
            "--reg_path not given: using a RANDOMLY initialized regressor"
        )

    cfg = EditorConfig(
        model=model,
        latent=latent,
        walk_kind=walk_kind,
        attr_list=tuple(attr_list),
        attr_idx=tuple(attr_idx),
        size=size,
        dim_z=dim_z,
        layers=layers,
        alpha_mode="target",
        no_content_loss=bool(getattr(opt, "no_content_loss", False)),
        no_gan_loss=bool(getattr(opt, "no_gan_loss", False)),
        stable_bce=bool(getattr(opt, "stable_bce", False)),
        fixed_noise=bool(getattr(opt, "fixed_noise", False)),
        reg_input_size=getattr(opt, "reg_input_size", None),
        content_input_size=getattr(opt, "content_input_size", None),
        remat_g=getattr(opt, "remat_g", False) or False,
        remat_towers=bool(getattr(opt, "remat_towers", False)),
    )
    walk_params = init_walk(walk_kind, dim_z, cfg.n_latent, attr_list,
                            generator=gen, device=device)

    # the loss towers draw from the seed after the walk, so G, the
    # regressor and the walk are the same with or without them
    d = None
    if d_sd is not None:
        d = sg2.Discriminator(size, channels=channels)
        d.load_state_dict(d_sd, strict=True)
    elif not cfg.no_gan_loss:
        d = sg2.Discriminator(size, channels=channels, generator=gen)
    vgg_path = getattr(opt, "vgg_path", "")
    vgg = None
    if vgg_path:
        vgg = vggm.VGG19Features()
        vgg.load_state_dict(vggm.features_state_dict(_load_torch(vgg_path)),
                            strict=True)
    elif not cfg.no_content_loss:
        warnings.warn("--vgg_path not given: using a RANDOMLY initialized vgg19")
        vgg = vggm.VGG19Features(generator=gen)
    editor = Editor(cfg, g, reg, device, vgg=vgg, d=d)
    logging.info(
        "built editor: model=%s latent=%s walk=%s attrs=%s layers=%s on %s",
        model, latent, walk_kind, attr_list[:4], layers, device,
    )
    return editor, walk_params, {
        "attr_list": attr_list,
        "attr_table": attr_table,
        "attr_idx": attr_idx,
        "pretrained": {"g": bool(g_path), "reg": bool(reg_path),
                       "d": d_sd is not None, "vgg": bool(vgg_path)},
    }


def load_editor_for_inference(opt, conf, device=None):
    """Shared inference loader (vis_w / serve): apply the attrList/attrPath
    CLI overrides, build the editor on ``device``, and load the optional walk
    (--save_path_w: either package's msgpack checkpoint or the reference's
    pickled walk module) and fine-tuned GAN (--save_path_gan: the JAX
    package's msgpack tree or a torch ``.pt``) checkpoints. Returns (editor,
    walk_params, info)."""
    from ..io import checkpoint as ckpt

    for field in ("attrList", "attrPath"):
        v = getattr(opt, field, None)
        if v:
            setattr(conf, field, v)
    conf.overwrite_config = True

    editor, walk_params, info = build_editor_from_options(conf, device=device)
    if getattr(opt, "save_path_w", None):
        walk_params, _, meta = ckpt.load_walk(opt.save_path_w, walk_params,
                                              attr_list=info["attr_list"])
        logging.info("Load w in %s (%s)", opt.save_path_w,
                     (meta or {}).get("source", "native"))
    if getattr(opt, "save_path_gan", None):
        g_sd, d_sd = ckpt.load_gan_checkpoint(opt.save_path_gan)
        editor.g.load_state_dict(g_sd, strict=True)
        if d_sd is not None and editor.d is not None:
            editor.d.load_state_dict(d_sd, strict=True)
        logging.info("Load GAN in %s", opt.save_path_gan)
    return editor, walk_params, info
