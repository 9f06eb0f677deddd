"""Latent walks, the only trained parameters in the system — PyTorch port.

The counterpart of latent2im_tpu/walks/walks.py: the registry,
``resolve_walk_kind``, the layer mask and every walk kind. W-space (the
reference's graphs/stylegan_v2_real/transform_base.py:21-243), latent
[B, L, D]:

  linear_w   WalkLinearMultiW  — per-attribute direction bank [A, L, D],
                                 w[l] += alpha @ W[:, l, :]
  mlp_w      WalkMlpMultiW     — D->2D->2D->D LeakyReLU MLP,
                                 w[l] += alpha_0 * MLP(w[l])
  nn_w       WalkNonLinearW    — alpha-embed(10->D/2) ++ w[l] -> MLP,
                                 unit-normalized delta

z-space (StyleGAN2 z, PGGAN; graphs/pggan/transform_base.py:12-188),
latent [B, D]:

  mlp_z          WalkMlpMultiZ    — one-hot embed(10->D) ++ z -> MLP,
                                    normalized delta * alpha_0
  linear_z_free  WalkLinearZ_free — elementwise gate z += (alpha @ w) * z
  linear_z       WalkLinearZ      — z += alpha_0 * 3 * Lin(z)/||Lin(z)||
  linear_z_dir   WalkLinear       — z += alpha @ W
  mlp_z_norm     WalkMlpZ2        — D->2D->2D->D MLP, normalized delta * 3
  mlp_z3         WalkMlpZ3        — z += alpha_0 * MLP(z)
  embed          WalkEmbed        — per-attribute bank, z += bank[index]

Walk params are dicts (and lists) of tensors, keyed as in the JAX package's
pytrees: a linear layer is {"w": [fan_in, fan_out], "b": [fan_out]}, so
that its checkpoints carry them unchanged. ``walk_leaves`` lists the
tensors in a fixed order (the optimizer's).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

Params = dict


def walk_leaves(params) -> list:
    """The walk's tensors, depth first, dicts in sorted key order and lists
    in order: the order of ``jax.tree_util.tree_leaves``."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in walk_leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in walk_leaves(v)]
    return [params]


def walk_map(fn: Callable, params):
    """The walk's tree with ``fn`` applied to each tensor, in walk_leaves
    order."""
    if isinstance(params, dict):
        return {k: walk_map(fn, params[k]) for k in sorted(params)}
    if isinstance(params, (list, tuple)):
        return [walk_map(fn, v) for v in params]
    return fn(params)


def _layer_mask(n_layers: int, layers, device=None) -> torch.Tensor:
    mask = torch.zeros((n_layers,), dtype=torch.float32, device=device)
    if layers is None:
        return mask + 1.0
    mask[list(layers)] = 1.0
    return mask


def _init_linear(fan_in, fan_out, generator=None, device=None):
    """torch nn.Linear's default init: U(-b, b), b = 1/sqrt(fan_in)."""
    bound = 1.0 / math.sqrt(fan_in)

    def u(*shape):
        return ((torch.rand(shape, generator=generator) * 2 - 1) * bound).to(device)

    return {"w": u(fan_in, fan_out), "b": u(fan_out)}


def _linear(p, x):
    return x @ p["w"] + p["b"]


def _mlp(layers, x, slope: float = 0.2):
    """Linear layers with a plain LeakyReLU(slope) between them."""
    for i, p in enumerate(layers):
        x = _linear(p, x)
        if i < len(layers) - 1:
            x = F.leaky_relu(x, slope)
    return x


def init_linear_w(dim_z, n_layers, attr_list, generator=None, device=None):
    w = 0.02 * torch.randn((len(attr_list), n_layers, dim_z), generator=generator)
    return {"w": w.to(device)}


def apply_linear_w(params, latent, alpha, layers=None):
    # latent [B, L, D], alpha [B, A], w [A, L, D]
    delta = torch.einsum("ba,ald->bld", alpha, params["w"].to(latent.dtype))
    mask = _layer_mask(latent.shape[1], layers, latent.device).to(latent.dtype)
    return latent + delta * mask[None, :, None]


def init_mlp_w(dim_z, n_layers, attr_list, generator=None, device=None):
    return {"mlp": [_init_linear(dim_z, 2 * dim_z, generator, device),
                    _init_linear(2 * dim_z, 2 * dim_z, generator, device),
                    _init_linear(2 * dim_z, dim_z, generator, device)]}


def apply_mlp_w(params, latent, alpha, layers=None):
    al = alpha[:, :1]  # the reference uses alpha[:, 0] (transform_base.py:184)
    delta = _mlp(params["mlp"], latent)  # batched over [B, L, D]
    mask = _layer_mask(latent.shape[1], layers, latent.device).to(latent.dtype)
    return latent + al[:, None, :] * delta * mask[None, :, None]


def init_nn_w(dim_z, n_layers, attr_list, generator=None, device=None):
    return {"embed": _init_linear(10, dim_z // 2, generator, device),
            "mlp": [_init_linear(dim_z // 2 + dim_z, 2 * dim_z, generator, device),
                    _init_linear(2 * dim_z, dim_z, generator, device)]}


def apply_nn_w(params, latent, alpha, layers=None):
    b, n_layers, _ = latent.shape
    emb = _linear(params["embed"], alpha[:, :1].repeat(1, 10))  # [B, D/2]
    h = torch.cat([emb[:, None, :].expand(b, n_layers, emb.shape[-1]), latent], dim=-1)
    delta = _mlp(params["mlp"], h)
    if layers is None:
        # unit-normalized per layer (transform_base.py:228)
        return latent + delta / torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    # with an explicit layer subset the reference skips normalization (:236-238)
    mask = _layer_mask(n_layers, layers, latent.device).to(latent.dtype)
    return latent + delta * mask[None, :, None]


# ---------------------------------------------------------------------------
# z-space walks (the reference's graphs/pggan/transform_base.py:12-188 and
# the stylegan backend's z modules); latent z [B, D]
# ---------------------------------------------------------------------------


def _bank(shape, generator, device):
    return (0.02 * torch.randn(shape, generator=generator)).to(device)


def init_mlp_z(dim_z, n_layers, attr_list, generator=None, device=None):
    return {"embed": _init_linear(10, dim_z, generator, device),
            "mlp": [_init_linear(2 * dim_z, dim_z, generator, device),
                    _init_linear(dim_z, dim_z, generator, device),
                    _init_linear(dim_z, dim_z, generator, device)]}


def apply_mlp_z(params, z, alpha, layers=None):
    """WalkMlpMultiZ: one-hot embed(10 -> D) ++ z -> MLP, the delta
    unit-normalized and scaled by alpha[:, 0]."""
    direction = torch.zeros((z.shape[0], 10), dtype=z.dtype, device=z.device)
    direction[:, 0] = 1.0
    out = _mlp(params["mlp"], torch.cat([_linear(params["embed"], direction), z], -1))
    return z + alpha[:, :1] * out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def init_linear_z_free(dim_z, n_layers, attr_list, generator=None, device=None):
    return {"w": _bank((len(attr_list), dim_z), generator, device)}


def apply_linear_z_free(params, z, alpha, layers=None):
    """WalkLinearZ_free: an elementwise gate per attribute, z += (alpha @ w) * z."""
    return z + (alpha @ params["w"].to(z.dtype)) * z


def init_linear_z(dim_z, n_layers, attr_list, generator=None, device=None):
    return {"lin": _init_linear(dim_z, dim_z, generator, device)}


def apply_linear_z(params, z, alpha, layers=None):
    """WalkLinearZ: z += alpha[:, 0] * 3 * Lin(z) / ||Lin(z)||."""
    out = _linear(params["lin"], z)
    return z + alpha[:, :1] * out / torch.linalg.vector_norm(out, dim=-1, keepdim=True) * 3.0


def init_linear_z_dir(dim_z, n_layers, attr_list, generator=None, device=None):
    return {"w": _bank((len(attr_list), dim_z), generator, device)}


def apply_linear_z_dir(params, z, alpha, layers=None):
    """WalkLinear (the stylegan backend's per-slider z bank): z + alpha @ W."""
    return z + alpha @ params["w"].to(z.dtype)


def _init_mlp3(dim_z, generator, device):
    return {"mlp": [_init_linear(dim_z, 2 * dim_z, generator, device),
                    _init_linear(2 * dim_z, 2 * dim_z, generator, device),
                    _init_linear(2 * dim_z, dim_z, generator, device)]}


def init_mlp_z_norm(dim_z, n_layers, attr_list, generator=None, device=None):
    return _init_mlp3(dim_z, generator, device)


def apply_mlp_z_norm(params, z, alpha, layers=None):
    """WalkMlpZ2: the MLP's delta unit-normalized, scaled by 3 * alpha[:, 0]."""
    out = _mlp(params["mlp"], z)
    return z + alpha[:, :1] * out / torch.linalg.vector_norm(out, dim=-1, keepdim=True) * 3.0


def init_mlp_z3(dim_z, n_layers, attr_list, generator=None, device=None):
    return _init_mlp3(dim_z, generator, device)


def apply_mlp_z3(params, z, alpha, layers=None):
    """WalkMlpZ3 (the paper's PGGAN walk): z += alpha[:, 0] * MLP(z)."""
    return z + alpha[:, :1] * _mlp(params["mlp"], z)


def init_embed(dim_z, n_layers, attr_list, generator=None, device=None,
               nsliders: int = 1, n_panel: int = 6):
    """WalkEmbed: per attribute a bank [n_panel, 1, D, nsliders]."""
    return {"w": {name: _bank((n_panel, 1, dim_z, nsliders), generator, device)
                  for name in attr_list}}


def apply_embed(params, z, alpha, name=None, index=0, layers=None):
    """z += bank[index] summed over its sliders (transform_base.py:21-41);
    alpha is not used. ``name`` picks the attribute's bank, None the first
    (--trainEmbed trains one attribute); ``index`` may be a tensor. An index
    past the bank takes its last entry, as the JAX package's indexing clamps
    it (a geometric task's 15-step ladder over the 6-entry bank)."""
    bank = params["w"][name] if name is not None else next(iter(params["w"].values()))
    index = torch.as_tensor(index, device=bank.device).clamp(max=bank.shape[0] - 1)
    return z + torch.sum(bank[index, 0], dim=-1)[None, :]


# kind -> (init, apply, latent_space)
REGISTRY: dict[str, tuple[Callable, Callable, str]] = {
    "linear_w": (init_linear_w, apply_linear_w, "w"),
    "mlp_w": (init_mlp_w, apply_mlp_w, "w"),
    "nn_w": (init_nn_w, apply_nn_w, "w"),
    "mlp_z": (init_mlp_z, apply_mlp_z, "z"),
    "linear_z_free": (init_linear_z_free, apply_linear_z_free, "z"),
    "linear_z": (init_linear_z, apply_linear_z, "z"),
    "linear_z_dir": (init_linear_z_dir, apply_linear_z_dir, "z"),
    "mlp_z_norm": (init_mlp_z_norm, apply_mlp_z_norm, "z"),
    "mlp_z3": (init_mlp_z3, apply_mlp_z3, "z"),
    "embed": (init_embed, apply_embed, "z"),
}


def resolve_walk_kind(model: str, walk_type: str, latent: str,
                      train_embed: bool = False, is_mlp: bool = False) -> str:
    """Map the reference's CLI coordinates (--model/--walk_type/--latent/
    --trainEmbed/is_mlp) to a walk kind, as the JAX package does
    (latent2im_tpu/walks/walks.py:274)."""
    if model == "pggan":
        if train_embed:
            return "embed"
        return "linear_z_free" if walk_type == "linear" else "mlp_z3"
    if "NN" in walk_type:
        return "nn_w"
    if walk_type == "linear":
        if train_embed:
            return "embed"
        if latent == "z":
            if is_mlp:
                return "mlp_z"
            raise NotImplementedError(
                "linear z-space walk without is_mlp is unimplemented in the "
                "reference (transform_base.py:305-308)"
            )
        if latent == "w":
            return "mlp_w" if is_mlp else "linear_w"
        raise NotImplementedError(f"unknown latent space {latent!r}")
    raise NotImplementedError(f"unknown walk_type {walk_type!r}")


def init_walk(kind, dim_z, n_layers, attr_list, generator=None,
              device=None) -> Params:
    init, _, _ = REGISTRY[kind]
    return init(dim_z, n_layers, attr_list, generator=generator, device=device)


def apply_walk(kind, params, latent, alpha, layers=None, **kw):
    """kw: the embed walk's ``name`` and ``index``."""
    _, apply, _ = REGISTRY[kind]
    return apply(params, latent, alpha, layers=layers, **kw)


def walk_space(kind: str) -> str:
    return REGISTRY[kind][2]
