"""Carry the JAX package's parameter pytrees into the port's state_dicts.

Input: the pytrees of latent2im_tpu (models/stylegan2.py:init_generator and
init_discriminator, models/resnet.py:init_resnet50, models/vgg.py:init_vgg,
models/facenet.py:init_facenet, walks/walks.py:init_walk, or the same trees converted from torch
checkpoints), as numpy arrays. Output: state_dicts that
the port's modules load with ``strict=True``. The layout rules are the inverse
of latent2im_tpu/io/torch_convert.py (read, not imported):

  conv    [kh,kw,in,out]  -> [out,in,kh,kw]
  linear  [in,out]        -> [out,in]
  modconv [k,k,I,O]       -> [1,O,I,k,k]
  NHWC buffers            -> NCHW
  D final_lin1 rows       (h,w,c) -> (c,h,w), the NCHW flatten
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _lin(w) -> torch.Tensor:
    return _t(np.transpose(np.asarray(w), (1, 0)))


def _conv(w) -> torch.Tensor:
    return _t(np.transpose(np.asarray(w), (3, 2, 0, 1)))


def _modconv(w) -> torch.Tensor:
    return _conv(w)[None]


def generator_from_jax(tree) -> dict[str, torch.Tensor]:
    """StyleGAN2 generator pytree -> rosinality ``g_ema`` state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for i, p in enumerate(tree["style"]):
        sd[f"style.{i + 1}.weight"] = _lin(p["w"])
        sd[f"style.{i + 1}.bias"] = _t(p["b"])
    sd["input.input"] = _t(np.transpose(np.asarray(tree["const"]), (0, 3, 1, 2)))

    def modconv(prefix, p):
        sd[f"{prefix}.conv.weight"] = _modconv(p["w"])
        sd[f"{prefix}.conv.modulation.weight"] = _lin(p["mod"]["w"])
        sd[f"{prefix}.conv.modulation.bias"] = _t(p["mod"]["b"])

    def styled(prefix, p):
        modconv(prefix, p["conv"])
        sd[f"{prefix}.noise.weight"] = _t(p["noise_w"]).reshape(1)
        sd[f"{prefix}.activate.bias"] = _t(p["act_b"])

    def to_rgb(prefix, p):
        modconv(prefix, p["conv"])
        sd[f"{prefix}.bias"] = _t(p["b"]).reshape(1, 3, 1, 1)

    styled("conv1", tree["conv1"])
    to_rgb("to_rgb1", tree["to_rgb1"])
    for i, p in enumerate(tree["convs"]):
        styled(f"convs.{i}", p)
    for i, p in enumerate(tree["to_rgbs"]):
        to_rgb(f"to_rgbs.{i}", p)
    for i, n in enumerate(tree["noises"]):
        sd[f"noises.noise_{i}"] = _t(np.transpose(np.asarray(n), (0, 3, 1, 2)))
    return sd


def discriminator_from_jax(tree) -> dict[str, torch.Tensor]:
    """StyleGAN2 discriminator pytree -> rosinality ``d`` state_dict
    (without the fixed blur ``.kernel`` buffers)."""
    sd: dict[str, torch.Tensor] = {}

    def conv_layer(prefix, p, down=False):
        ci = 1 if down else 0  # Sequential: [Blur?, EqualConv2d, FusedLeakyReLU?]
        sd[f"{prefix}.{ci}.weight"] = _conv(p["conv"]["w"])
        if "b" in p["conv"]:
            sd[f"{prefix}.{ci}.bias"] = _t(p["conv"]["b"])
        if "act_b" in p:
            sd[f"{prefix}.{ci + 1}.bias"] = _t(p["act_b"])

    conv_layer("convs.0", tree["from_rgb"])
    for i, blk in enumerate(tree["blocks"]):
        conv_layer(f"convs.{i + 1}.conv1", blk["conv1"])
        conv_layer(f"convs.{i + 1}.conv2", blk["conv2"], down=True)
        conv_layer(f"convs.{i + 1}.skip", blk["skip"], down=True)
    conv_layer("final_conv", tree["final_conv"])
    # the JAX rows follow its NHWC flatten (h, w, c); the port flattens NCHW
    w0 = np.asarray(tree["final_lin1"]["w"])
    cin = w0.shape[0] // 16
    perm = np.transpose(np.arange(w0.shape[0]).reshape(cin, 4, 4), (1, 2, 0)).reshape(-1)
    w_chw = np.empty_like(w0)
    w_chw[perm] = w0
    sd["final_linear.0.weight"] = _lin(w_chw)
    sd["final_linear.0.bias"] = _t(tree["final_lin1"]["b"])
    sd["final_linear.1.weight"] = _lin(tree["final_lin2"]["w"])
    sd["final_linear.1.bias"] = _t(tree["final_lin2"]["b"])
    return sd


def vgg_from_jax(tree) -> dict[str, torch.Tensor]:
    """VGG19 pytree ({"cfg": "vgg19", "convs": [...]}) -> torchvision
    ``features.N`` state_dict."""
    from ..models.vgg import CFG19

    if tree.get("cfg", "vgg19") != "vgg19":
        raise ValueError(f"the port holds vgg19 only, got {tree['cfg']!r}")
    sd: dict[str, torch.Tensor] = {}
    idx, convs = 0, iter(tree["convs"])
    for v in CFG19:
        if v == "M":
            idx += 1
            continue
        p = next(convs)
        sd[f"features.{idx}.weight"] = _conv(p["w"])
        sd[f"features.{idx}.bias"] = _t(p["b"])
        idx += 2  # Conv2d, ReLU
    return sd


def resnet50_from_jax(tree) -> dict[str, torch.Tensor]:
    """ResNet-50 pytree -> torchvision state_dict (eval-mode BN stats)."""
    sd: dict[str, torch.Tensor] = {}

    def conv_bn(conv_key, bn_key, p):
        sd[f"{conv_key}.weight"] = _conv(p["w"])
        sd[f"{bn_key}.weight"] = _t(p["gamma"])
        sd[f"{bn_key}.bias"] = _t(p["beta"])
        sd[f"{bn_key}.running_mean"] = _t(p["mean"])
        sd[f"{bn_key}.running_var"] = _t(p["var"])
        sd[f"{bn_key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    conv_bn("conv1", "bn1", tree["stem"])
    for li, blocks in enumerate(tree["layers"]):
        for bi, blk in enumerate(blocks):
            pre = f"layer{li + 1}.{bi}"
            for j in (1, 2, 3):
                conv_bn(f"{pre}.conv{j}", f"{pre}.bn{j}", blk[f"conv{j}"])
            if "down" in blk:
                conv_bn(f"{pre}.downsample.0", f"{pre}.downsample.1", blk["down"])
    sd["fc.weight"] = _lin(tree["fc"]["w"])
    sd["fc.bias"] = _t(tree["fc"]["b"])
    return sd


def facenet_from_jax(tree) -> dict[str, torch.Tensor]:
    """facenet pytree (models/facenet.py:init_facenet there) ->
    facenet_pytorch InceptionResnetV1 state_dict (without ``logits``)."""
    sd: dict[str, torch.Tensor] = {}

    def bn(prefix, p):
        sd[f"{prefix}.weight"] = _t(p["gamma"])
        sd[f"{prefix}.bias"] = _t(p["beta"])
        sd[f"{prefix}.running_mean"] = _t(p["mean"])
        sd[f"{prefix}.running_var"] = _t(p["var"])
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def basic(prefix, p):
        sd[f"{prefix}.conv.weight"] = _conv(p["w"])
        bn(f"{prefix}.bn", p["bn"])

    def block(prefix, p):
        for name, v in p.items():
            if name == "conv2d":
                sd[f"{prefix}.conv2d.weight"] = _conv(v["w"])
                sd[f"{prefix}.conv2d.bias"] = _t(v["b"])
            elif isinstance(v, list):
                for j, q in enumerate(v):
                    basic(f"{prefix}.{name}.{j}", q)
            else:
                basic(f"{prefix}.{name}", v)

    for name in ("conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b", "conv2d_4a",
                 "conv2d_4b"):
        basic(name, tree[name])
    for i, p in enumerate(tree["repeat_1"]):
        block(f"repeat_1.{i}", p)
    block("mixed_6a", tree["mixed_6a"])
    for i, p in enumerate(tree["repeat_2"]):
        block(f"repeat_2.{i}", p)
    block("mixed_7a", tree["mixed_7a"])
    for i, p in enumerate(tree["repeat_3"][:-1]):
        block(f"repeat_3.{i}", p)
    block("block8", tree["repeat_3"][-1])
    sd["last_linear.weight"] = _lin(tree["last_linear"]["w"])
    bn("last_bn", tree["last_bn"])
    return sd


def walk_from_jax(tree):
    """Walk pytree -> the same tree of tensors (the port keeps the JAX
    package's walk layouts: ``linear_w`` is {"w": [A, L, D]})."""
    if isinstance(tree, dict):
        return {k: walk_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [walk_from_jax(v) for v in tree]
    return _t(tree)
