"""Latent walks, the only trained parameters in the system — PyTorch port.

The counterpart of latent2im_tpu/walks/walks.py. This slice ports the
registry, ``resolve_walk_kind``, the layer mask and the ``linear_w`` walk
(WalkLinearMultiW: a per-attribute direction bank [A, L, D], w[l] +=
alpha @ W[:, l, :]). The other nine kinds are registered and raise
``NotImplementedError`` naming their ROADMAP item.

Walk params are dicts of tensors, keyed as in the JAX package's pytrees.
"""

from __future__ import annotations

from typing import Callable

import torch

Params = dict


def _layer_mask(n_layers: int, layers, device=None) -> torch.Tensor:
    mask = torch.zeros((n_layers,), dtype=torch.float32, device=device)
    if layers is None:
        return mask + 1.0
    mask[list(layers)] = 1.0
    return mask


def init_linear_w(dim_z, n_layers, attr_list, generator=None, device=None):
    w = 0.02 * torch.randn((len(attr_list), n_layers, dim_z), generator=generator)
    return {"w": w.to(device)}


def apply_linear_w(params, latent, alpha, layers=None):
    # latent [B, L, D], alpha [B, A], w [A, L, D]
    delta = torch.einsum("ba,ald->bld", alpha, params["w"].to(latent.dtype))
    mask = _layer_mask(latent.shape[1], layers, latent.device).to(latent.dtype)
    return latent + delta * mask[None, :, None]


def _not_ported(kind: str) -> Callable:
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"walk kind {kind!r} is not ported yet (ROADMAP.md queue A "
            "item 18: the nine remaining walk kinds)"
        )

    return fn


# kind -> (init, apply, latent_space)
REGISTRY: dict[str, tuple[Callable, Callable, str]] = {
    "linear_w": (init_linear_w, apply_linear_w, "w"),
    **{k: (_not_ported(k), _not_ported(k), "w") for k in ("mlp_w", "nn_w")},
    **{k: (_not_ported(k), _not_ported(k), "z") for k in (
        "mlp_z", "linear_z_free", "linear_z", "linear_z_dir", "mlp_z_norm",
        "mlp_z3", "embed")},
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


def apply_walk(kind, params, latent, alpha, layers=None):
    _, apply, _ = REGISTRY[kind]
    return apply(params, latent, alpha, layers=layers)


def walk_space(kind: str) -> str:
    return REGISTRY[kind][2]
