"""Carry the JAX package's parameter pytrees into the port's state_dicts.

Input: the pytrees of latent2im_tpu (models/stylegan2.py:init_generator and
init_discriminator, models/pggan.py and models/pgan_zoo.py's
init_generator and init_discriminator, models/resnet.py:init_resnet50,
models/stylegan1.py:init_styled_generator,
models/vgg.py:init_vgg, models/lpips.py:init_lpips, models/facenet.py:init_facenet,
walks/walks.py:init_walk, or the same trees converted from torch
checkpoints), as numpy arrays. Output: state_dicts that
the port's modules load with ``strict=True``. The layout rules are the inverse
of latent2im_tpu/io/torch_convert.py (read, not imported):

  conv    [kh,kw,in,out]  -> [out,in,kh,kw]
  linear  [in,out]        -> [out,in]
  modconv [k,k,I,O]       -> [1,O,I,k,k]
  NHWC buffers            -> NCHW
  D final_lin1 rows       (h,w,c) -> (c,h,w), the NCHW flatten

``generator_to_jax``, ``discriminator_to_jax`` and ``resnet50_to_jax`` map
back: a state_dict (or
any dict of tensors of its names and shapes, as Adam's moments are) -> the
JAX package's tree of numpy arrays, lists where it keeps lists.
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


def _np(t) -> np.ndarray:
    return np.array(t.detach().cpu().numpy(), dtype=np.float32)


def _unlin(t) -> np.ndarray:
    return np.ascontiguousarray(_np(t).T)


def _unconv(t) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(_np(t), (2, 3, 1, 0)))


def _n_indexed(sd, prefix: str, suffix: str, start: int = 0) -> int:
    """How many consecutive ``{prefix}{i}{suffix}`` keys sd holds from i =
    start."""
    n = 0
    while f"{prefix}{start + n}{suffix}" in sd:
        n += 1
    return n


def generator_to_jax(sd) -> dict:
    """Rosinality ``g_ema`` state_dict -> StyleGAN2 generator pytree (the
    inverse of generator_from_jax)."""
    def modconv(prefix):
        return {"w": _unconv(sd[f"{prefix}.conv.weight"][0]),
                "mod": {"w": _unlin(sd[f"{prefix}.conv.modulation.weight"]),
                        "b": _np(sd[f"{prefix}.conv.modulation.bias"])}}

    def styled(prefix):
        return {"conv": modconv(prefix),
                "noise_w": _np(sd[f"{prefix}.noise.weight"]).reshape(()),
                "act_b": _np(sd[f"{prefix}.activate.bias"])}

    def to_rgb(prefix):
        return {"conv": modconv(prefix), "b": _np(sd[f"{prefix}.bias"]).reshape(3)}

    n_mlp = sum(1 for k in sd if k.startswith("style.") and k.endswith(".weight"))
    return {
        "style": [{"w": _unlin(sd[f"style.{i + 1}.weight"]), "b": _np(sd[f"style.{i + 1}.bias"])}
                  for i in range(n_mlp)],
        "const": np.ascontiguousarray(np.transpose(_np(sd["input.input"]), (0, 2, 3, 1))),
        "conv1": styled("conv1"),
        "to_rgb1": to_rgb("to_rgb1"),
        "convs": [styled(f"convs.{i}")
                  for i in range(_n_indexed(sd, "convs.", ".conv.weight"))],
        "to_rgbs": [to_rgb(f"to_rgbs.{i}")
                    for i in range(_n_indexed(sd, "to_rgbs.", ".conv.weight"))],
        "noises": [np.ascontiguousarray(np.transpose(_np(sd[f"noises.noise_{i}"]), (0, 2, 3, 1)))
                   for i in range(_n_indexed(sd, "noises.noise_", ""))],
    }


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


def discriminator_to_jax(sd) -> dict:
    """Rosinality ``d`` state_dict (without the blur kernels) ->
    StyleGAN2 discriminator pytree (the inverse of discriminator_from_jax)."""
    def conv_layer(prefix, down=False):
        ci = 1 if down else 0
        p = {"conv": {"w": _unconv(sd[f"{prefix}.{ci}.weight"])}}
        if f"{prefix}.{ci}.bias" in sd:
            p["conv"]["b"] = _np(sd[f"{prefix}.{ci}.bias"])
        if f"{prefix}.{ci + 1}.bias" in sd:
            p["act_b"] = _np(sd[f"{prefix}.{ci + 1}.bias"])
        return p

    blocks = [{"conv1": conv_layer(f"convs.{i}.conv1"),
               "conv2": conv_layer(f"convs.{i}.conv2", down=True),
               "skip": conv_layer(f"convs.{i}.skip", down=True)}
              for i in range(1, 1 + _n_indexed(sd, "convs.", ".conv1.0.weight", start=1))]
    # the port's rows follow the NCHW flatten (c, h, w); JAX's are (h, w, c)
    w_chw = _np(sd["final_linear.0.weight"]).T
    cin = w_chw.shape[0] // 16
    perm = np.transpose(np.arange(w_chw.shape[0]).reshape(cin, 4, 4), (1, 2, 0)).reshape(-1)
    return {
        "from_rgb": conv_layer("convs.0"),
        "blocks": blocks,
        "final_conv": conv_layer("final_conv"),
        "final_lin1": {"w": np.ascontiguousarray(w_chw[perm]),
                       "b": _np(sd["final_linear.0.bias"])},
        "final_lin2": {"w": _unlin(sd["final_linear.1.weight"]),
                       "b": _np(sd["final_linear.1.bias"])},
    }


def vgg_from_jax(tree) -> dict[str, torch.Tensor]:
    """VGG16 or VGG19 pytree ({"cfg": "vgg16" | "vgg19", "convs": [...]}) ->
    torchvision ``features.N`` state_dict."""
    from ..models.vgg import CFGS

    cfg_name = tree.get("cfg", "vgg19")
    if cfg_name not in CFGS:
        raise ValueError(f"unknown vgg config {cfg_name!r}")
    sd: dict[str, torch.Tensor] = {}
    idx, convs = 0, iter(tree["convs"])
    for v in CFGS[cfg_name]:
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


def resnet50_to_jax(sd) -> dict:
    """torchvision ResNet-50 state_dict (or a dict of tensors of its names
    and shapes, as Adam's moments are) -> the JAX package's resnet pytree of
    numpy arrays: the inverse of resnet50_from_jax. The BN statistics
    (``running_mean``/``running_var``) become the ``mean``/``var`` leaves;
    ``num_batches_tracked`` has no leaf."""
    def conv_bn(conv_key, bn_key):
        return {"w": _unconv(sd[f"{conv_key}.weight"]),
                "gamma": _np(sd[f"{bn_key}.weight"]), "beta": _np(sd[f"{bn_key}.bias"]),
                "mean": _np(sd[f"{bn_key}.running_mean"]),
                "var": _np(sd[f"{bn_key}.running_var"])}

    layers = []
    for li in range(_n_indexed(sd, "layer", ".0.conv1.weight", start=1)):
        blocks = []
        for bi in range(_n_indexed(sd, f"layer{li + 1}.", ".conv1.weight")):
            pre = f"layer{li + 1}.{bi}"
            blk = {f"conv{j}": conv_bn(f"{pre}.conv{j}", f"{pre}.bn{j}") for j in (1, 2, 3)}
            if f"{pre}.downsample.0.weight" in sd:
                blk["down"] = conv_bn(f"{pre}.downsample.0", f"{pre}.downsample.1")
            blocks.append(blk)
        layers.append(blocks)
    return {"stem": conv_bn("conv1", "bn1"), "layers": layers,
            "fc": {"w": _unlin(sd["fc.weight"]), "b": _np(sd["fc.bias"])}}


def stylegan1_from_jax(tree, fused_from: int = 5) -> dict[str, torch.Tensor]:
    """StyleGAN1 generator pytree (models/stylegan1.py:init_styled_generator
    there) -> rosinality's style-based-gan-pytorch ``StyledGenerator``
    state_dict, blocks from ``fused_from`` on with a FusedUpsample (its
    weight [in, out, k, k], the transposed conv's layout), the others an
    EqualConv2d after a nearest upsample; the Blur buffers included."""
    from ..models.stylegan1 import Blur

    sd: dict[str, torch.Tensor] = {}
    for i, p in enumerate(tree["style"]):
        sd[f"style.{2 * i + 1}.linear.weight_orig"] = _lin(p["w"])
        sd[f"style.{2 * i + 1}.linear.bias"] = _t(p["b"])
    for i, p in enumerate(tree["progression"]):
        pre = f"generator.progression.{i}"
        if i == 0:
            sd[f"{pre}.conv1.input"] = _t(np.transpose(np.asarray(p["const"]), (0, 3, 1, 2)))
        else:
            cout = np.asarray(p["conv1"]["b"]).shape[0]
            if i >= fused_from:
                sd[f"{pre}.conv1.0.weight"] = _t(np.transpose(np.asarray(p["conv1"]["w"]),
                                                              (2, 3, 0, 1)))
                sd[f"{pre}.conv1.0.bias"] = _t(p["conv1"]["b"])
                blur = f"{pre}.conv1.1"
            else:
                sd[f"{pre}.conv1.1.conv.weight_orig"] = _conv(p["conv1"]["w"])
                sd[f"{pre}.conv1.1.conv.bias"] = _t(p["conv1"]["b"])
                blur = f"{pre}.conv1.2"
            for k, v in Blur(cout).state_dict().items():
                sd[f"{blur}.{k}"] = v
        for j in (1, 2):
            sd[f"{pre}.noise{j}.weight_orig"] = _t(p[f"noise{j}_w"]).reshape(1, -1, 1, 1)
            sd[f"{pre}.adain{j}.style.linear.weight_orig"] = _lin(p[f"adain{j}"]["style"]["w"])
            sd[f"{pre}.adain{j}.style.linear.bias"] = _t(p[f"adain{j}"]["style"]["b"])
        sd[f"{pre}.conv2.conv.weight_orig"] = _conv(p["conv2"]["w"])
        sd[f"{pre}.conv2.conv.bias"] = _t(p["conv2"]["b"])
    for i, p in enumerate(tree["to_rgb"]):
        sd[f"generator.to_rgb.{i}.conv.weight_orig"] = _conv(p["w"])
        sd[f"generator.to_rgb.{i}.conv.bias"] = _t(p["b"])
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


def _conv_into(sd, prefix, p, weight="weight"):
    sd[f"{prefix}.{weight}"] = _conv(p["w"])
    sd[f"{prefix}.bias"] = _t(p["b"])


def pggan_generator_from_jax(tree) -> dict[str, torch.Tensor]:
    """models/pggan.py generator pytree -> model_256's state_dict
    (``progression.{i}.conv.{0,3}.conv.weight_orig``, ``to_rgb.{i}``,
    ``label_embed.weight`` where the tree has one)."""
    sd: dict[str, torch.Tensor] = {}
    if "label_embed" in tree:
        sd["label_embed.weight"] = _t(tree["label_embed"])
    for i, p in enumerate(tree["progression"]):
        _conv_into(sd, f"progression.{i}.conv.0.conv", p["conv1"], "weight_orig")
        _conv_into(sd, f"progression.{i}.conv.3.conv", p["conv2"], "weight_orig")
    for i, p in enumerate(tree["to_rgb"]):
        _conv_into(sd, f"to_rgb.{i}", p)
    return sd


def pggan_discriminator_from_jax(tree) -> dict[str, torch.Tensor]:
    """models/pggan.py discriminator pytree -> model_256's D state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for i, p in enumerate(tree["progression"]):
        _conv_into(sd, f"progression.{i}.conv.0.conv", p["conv1"], "weight_orig")
        _conv_into(sd, f"progression.{i}.conv.2.conv", p["conv2"], "weight_orig")
    for i, p in enumerate(tree["from_rgb"]):
        _conv_into(sd, f"from_rgb.{i}", p)
    sd["linear.weight"] = _lin(tree["linear"]["w"])
    sd["linear.bias"] = _t(tree["linear"]["b"])
    return sd


def _zoo_lin_into(sd, prefix, p):
    sd[f"{prefix}.module.weight"] = _lin(p["w"])
    sd[f"{prefix}.module.bias"] = _t(p["b"])


def zoo_generator_from_jax(tree) -> dict[str, torch.Tensor]:
    """models/pgan_zoo.py generator pytree -> the zoo GNet's state_dict."""
    sd: dict[str, torch.Tensor] = {}
    _zoo_lin_into(sd, "formatLayer", tree["format"])
    for i, p in enumerate(tree["group_scale0"]):
        _conv_into(sd, f"groupScale0.{i}.module", p)
    for s, group in enumerate(tree["scales"]):
        for j, p in enumerate(group):
            _conv_into(sd, f"scaleLayers.{s}.{j}.module", p)
    for i, p in enumerate(tree["to_rgbs"]):
        _conv_into(sd, f"toRGBLayers.{i}.module", p)
    return sd


def zoo_discriminator_from_jax(tree) -> dict[str, torch.Tensor]:
    """models/pgan_zoo.py discriminator pytree -> the zoo DNet's state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for i, p in enumerate(tree["from_rgb"]):
        _conv_into(sd, f"fromRGBLayers.{i}.module", p)
    for s, group in enumerate(tree["scales"]):
        for j, p in enumerate(group):
            _conv_into(sd, f"scaleLayers.{s}.{j}.module", p)
    _conv_into(sd, "groupScaleZero.0.module", tree["group0_conv"])
    _zoo_lin_into(sd, "groupScaleZero.1", tree["group0_lin"])
    _zoo_lin_into(sd, "decisionLayer", tree["decision"])
    return sd


def walk_from_jax(tree):
    """Walk pytree of any kind -> the same tree of tensors (the port keeps
    the JAX package's walk layouts: ``linear_w`` is {"w": [A, L, D]},
    ``embed`` {"w": {attribute: [n_panel, 1, D, nsliders]}})."""
    if isinstance(tree, dict):
        return {k: walk_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [walk_from_jax(v) for v in tree]
    return _t(tree)


def lpips_from_jax(tree) -> dict[str, torch.Tensor]:
    """LPIPS pytree ({"vgg": vgg16 tree, "lins": [{"w": [C]}, ...]}) ->
    models.lpips.LPIPS state_dict (the release's head names)."""
    sd = {f"vgg.{k}": v for k, v in vgg_from_jax(tree["vgg"]).items()}
    for i, lin in enumerate(tree["lins"]):
        sd[f"lin{i}.model.1.weight"] = _t(lin["w"]).reshape(1, -1, 1, 1)
    return sd
