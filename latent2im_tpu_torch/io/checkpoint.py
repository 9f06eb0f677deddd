"""Checkpoint save/load/resume — PyTorch port of latent2im_tpu/io/checkpoint.py,
in the same files: a msgpack tree as ``flax.serialization`` writes it
(io/msgpack_codec.py, no flax or msgpack needed), a ``.meta.json`` beside it,
and the ``model_w_{epoch}[_final]_walk_module.ckpt`` names.

A walk checkpoint is ``{"walk": {...}, "opt_state": ...}``. The optimizer
state is stored in optax's layout, so that either package resumes the
other's run::

    {"0": {"count": int32 [], "mu": {"w": ...}, "nu": {"w": ...}}, "1": {}}

(``optax.adam``: scale_by_adam, then the learning-rate scale, whose state is
empty; the moments are trees of the walk's structure, lists written as
{"0": .., "1": ..} maps). ``adam_state_to_optax`` / ``adam_state_from_optax`` map it to and
from ``torch.optim.Adam.state_dict()`` (``step``, ``exp_avg``,
``exp_avg_sq``): both optimizers update by lr * m_hat / (sqrt(v_hat) + eps)
with both bias corrections, so the moments carry over as they are.

The reference's pickled walk modules are read through io/torch_convert.py.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable

import numpy as np
import torch

from ..walks import walk_leaves, walk_map
from . import msgpack_codec


def _to_numpy(tree):
    # dict keys in sorted order, as the JAX package's device_get leaves them,
    # so that the same tree gives the same file
    if isinstance(tree, dict):
        return {str(k): _to_numpy(tree[k]) for k in sorted(tree, key=str)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _to_numpy(v) for i, v in enumerate(tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save_pytree(path: str, tree, meta: dict | None = None) -> None:
    """Write ``tree`` (dicts and lists of tensors, arrays or scalars; lists
    become {'0': .., '1': ..} maps, as flax writes them) as msgpack."""
    with open(path, "wb") as f:
        f.write(msgpack_codec.packb(_to_numpy(tree)))
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_pytree(path: str, like=None):
    """Restore a tree saved by either package's save_pytree. With ``like``
    (a tree of the same structure), its keys and array shapes are checked and
    the leaves come back as tensors on the device and in the dtype of like's
    tensors."""
    with open(path, "rb") as f:
        tree = msgpack_codec.unpackb(f.read())
    return tree if like is None else _restore_like(tree, like, path)


def _restore_like(tree, like, where: str):
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != {str(k) for k in like}:
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{where}: keys {got} where {sorted(map(str, like))} "
                             "were expected")
        return {k: _restore_like(tree[str(k)], v, f"{where}/{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        # a list is written as {'0': .., '1': ..}, as flax writes it
        if isinstance(tree, dict) and set(tree) == {str(i) for i in range(len(like))}:
            tree = [tree[str(i)] for i in range(len(like))]
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"{where}: {type(tree).__name__} where a list of "
                             f"{len(like)} was expected")
        return [_restore_like(t, v, f"{where}/{i}") for i, (t, v) in enumerate(zip(tree, like))]
    if isinstance(like, torch.Tensor):
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{where}: shape {arr.shape}, expected {tuple(like.shape)}")
        return torch.as_tensor(arr, dtype=like.dtype, device=like.device).clone()
    if isinstance(like, np.ndarray):
        arr = np.asarray(tree, dtype=like.dtype)
        if arr.shape != like.shape:
            raise ValueError(f"{where}: shape {arr.shape}, expected {like.shape}")
        return arr
    return tree


def load_meta(path: str) -> dict | None:
    mp = path + ".meta.json"
    if os.path.exists(mp):
        with open(mp) as f:
            return json.load(f)
    return None


def walk_ckpt_path(output_dir: str, epoch, final: bool = False) -> str:
    """model_w_{epoch}[_final]_walk_module.ckpt naming (train.py:124-132)."""
    tag = f"model_w_{epoch}_final" if final else f"model_w_{epoch}"
    return os.path.join(output_dir, f"{tag}_walk_module.ckpt")


# ---------------------------------------------------------------------------
# Adam state: torch.optim.Adam <-> optax.adam
# ---------------------------------------------------------------------------


def adam_state_to_optax(state_dict: dict, params: list, to_tree: Callable) -> dict:
    """torch Adam ``state_dict()`` over ``params`` (the tensors it holds, in
    its order) -> optax.adam's state tree, each moment laid out by
    ``to_tree`` (a list of tensors in that order -> the params' tree in the
    JAX package's layout); zero moments and count 0 before the first step,
    as ``optax.adam().init`` makes them."""
    st = state_dict["state"]
    if not st:
        zeros = [torch.zeros(tuple(p.shape)) for p in params]
        return {"0": {"count": np.asarray(0, np.int32), "mu": to_tree(zeros),
                      "nu": to_tree(zeros)}, "1": {}}
    if set(st) != set(range(len(params))):
        raise ValueError(f"Adam state holds params {sorted(st)} for {len(params)} tensors")
    steps = {int(st[i]["step"]) for i in st}
    if len(steps) != 1:
        raise ValueError(f"the tensors have taken different step counts {steps}")

    def moments(key):
        return to_tree([st[i][key] for i in range(len(params))])

    return {"0": {"count": np.asarray(steps.pop(), np.int32),
                  "mu": moments("exp_avg"), "nu": moments("exp_avg_sq")},
            "1": {}}


def adam_state_from_optax(tree: dict, like: dict, from_tree: Callable) -> dict:
    """optax.adam's state tree -> a torch Adam ``state_dict`` whose
    hyperparameters are those of ``like`` (a state_dict of the optimizer the
    run makes); ``from_tree`` maps a moment tree to the tensors in Adam's
    param order (checking its structure and shapes)."""
    adam = tree["0"]
    if set(adam) != {"count", "mu", "nu"} or tree.get("1", {}) != {}:
        raise ValueError(f"not an optax.adam state: keys {sorted(tree)} / {sorted(adam)}")
    groups = [dict(g) for g in like["param_groups"]]
    step = float(np.asarray(adam["count"]))
    if step == 0:  # optax's init state; torch Adam has none before a step
        return {"state": {}, "param_groups": groups}
    mu, nu = from_tree(adam["mu"]), from_tree(adam["nu"])
    state = {i: {"step": torch.tensor(step), "exp_avg": m, "exp_avg_sq": v}
             for i, (m, v) in enumerate(zip(mu, nu))}
    return {"state": state, "param_groups": groups}


def _walk_moments_tree(walk_params):
    """A list of tensors in ``walk_leaves`` order (engine.train.make_optimizer's
    Adam order) -> a tree of the walk's structure."""
    def to_tree(tensors):
        it = iter(tensors)
        return walk_map(lambda _: next(it), walk_params)

    return to_tree


# ---------------------------------------------------------------------------
# walk checkpoints
# ---------------------------------------------------------------------------


def save_walk(
    output_dir: str,
    epoch,
    walk_params,
    opt_state=None,
    final: bool = False,
    extra_meta: dict | None = None,
) -> str:
    """opt_state: the run's torch Adam ``state_dict()``, stored as optax's."""
    path = walk_ckpt_path(output_dir, epoch, final=final)
    tree = {"walk": walk_params}
    if opt_state is not None:
        tree["opt_state"] = adam_state_to_optax(opt_state, walk_leaves(walk_params),
                                                _walk_moments_tree(walk_params))
    meta = {"epoch": int(epoch) if isinstance(epoch, (int, np.integer)) else epoch,
            "final": final}
    meta.update(extra_meta or {})
    save_pytree(path, tree, meta)
    return path


def _looks_like_torch(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(8)
    return head.startswith(b"PK") or head.startswith(b"\x80")


def load_walk(path: str, walk_like, opt_state_like=None, attr_list=None):
    """-> (walk_params, opt_state|None, meta|None).

    walk_like: the walk tensors the run built (their keys, shapes, device and
    dtype); opt_state_like: a torch Adam ``state_dict`` to take the
    hyperparameters from, when the optimizer state is wanted. The reference's
    torch pickle is recognised by its head bytes; attr_list orders the
    per-attribute banks of such checkpoints."""
    if _looks_like_torch(path):
        from .torch_convert import convert_walk_state, load_walk_checkpoint

        cls, state = load_walk_checkpoint(path)
        converted = convert_walk_state(cls, state, list(attr_list or []))
        return (_restore_like(converted, walk_like, path), None,
                {"source": "torch", "cls": cls})
    tree = load_pytree(path)
    if not isinstance(tree, dict) or "walk" not in tree:
        raise ValueError(f"{path}: not a walk checkpoint (no 'walk' entry)")
    walk = _restore_like(tree["walk"], walk_like, path + ":walk")
    opt_state = None
    if opt_state_like is not None and "opt_state" in tree:
        opt_state = adam_state_from_optax(
            tree["opt_state"], opt_state_like,
            lambda m: walk_leaves(_restore_like(m, walk, "Adam moment")))
    return walk, opt_state, load_meta(path)


def merge_walk_banks(base_walk: dict, singles: list[tuple[str, dict]],
                     attr_list: list[str]) -> dict:
    """Merge single-attribute linear-walk checkpoints into one direction bank
    (the reference's load_multi_models_from_single, transform_base.py:511-520):
    each single ckpt's first direction row replaces the bank row of the named
    attribute."""
    w = torch.as_tensor(base_walk["w"]).clone()
    for name, single in singles:
        if name not in attr_list:
            raise KeyError(f"attribute {name!r} not in bank {attr_list}")
        w[attr_list.index(name)] = torch.as_tensor(single["w"])[0].to(w)
    out = dict(base_walk)
    out["w"] = w
    return out


def find_resume(output_dir: str) -> str | None:
    """Latest epoch checkpoint in output_dir, or None."""
    if not os.path.isdir(output_dir):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(output_dir):
        if name.startswith("model_w_") and name.endswith("_walk_module.ckpt"):
            mid = name[len("model_w_"):-len("_walk_module.ckpt")]
            if mid.endswith("_final"):
                continue
            try:
                ep = int(mid)
            except ValueError:
                continue
            if ep > best_epoch:
                best, best_epoch = os.path.join(output_dir, name), ep
    return best


# ---------------------------------------------------------------------------
# GAN checkpoints
# ---------------------------------------------------------------------------


class _Layout:
    """A module's parameters in Adam's order (``named_parameters``) and the
    map between a list of tensors in that order and the JAX package's tree
    (io/convert.py)."""

    def __init__(self, module, to_jax, from_jax):
        self.names = [n for n, _ in module.named_parameters()]
        self._to_jax, self._from_jax = to_jax, from_jax

    def to_tree(self, tensors) -> dict:
        return self._to_jax(dict(zip(self.names, tensors)))

    def from_tree(self, tree) -> list:
        sd = self._from_jax(tree)
        return [sd[n] for n in self.names]


def _gan_layouts(mod) -> dict:
    from .convert import (discriminator_from_jax, discriminator_to_jax,
                          generator_from_jax, generator_to_jax)

    return {"g": _Layout(mod.g, generator_to_jax, generator_from_jax),
            "d": _Layout(mod.d, discriminator_to_jax, discriminator_from_jax)}


def gan_tree(mod) -> dict:
    """A GANModule (engine/gan.py) -> the JAX package's GAN checkpoint tree
    {"g", "g_running", "d", "g_opt_state", "d_opt_state"}: the parameters in
    its layout, the Adam states in optax's (cli/train.py:_save_gan there)."""
    g, d = _gan_layouts(mod).values()
    g_params, d_params = list(mod.g.parameters()), list(mod.d.parameters())
    return {"g": g.to_tree(g_params),
            "g_running": g.to_tree([mod.g_running[n] for n in g.names]),
            "d": d.to_tree(d_params),
            "g_opt_state": adam_state_to_optax(mod.g_opt.state_dict(), g_params, g.to_tree),
            "d_opt_state": adam_state_to_optax(mod.d_opt.state_dict(), d_params, d.to_tree)}


def save_gan(path: str, mod, meta: dict | None = None) -> str:
    """Write a GANModule as the JAX package's ``_save_gan`` does (flax's
    msgpack of ``gan_tree``), which its ``load_pytree(path, like)`` restores
    with the optimizer states; ``meta`` goes to ``path + .meta.json``."""
    save_pytree(path, gan_tree(mod), meta)
    return path


def load_gan(path: str, mod) -> dict | None:
    """Restore a GAN checkpoint of either package into ``mod`` in place: G,
    D, g_running and, where the file holds them, both Adam states (a file
    without them restores the weights only, the moments restarting, as the
    JAX package's resume does). -> the file's meta, or None."""
    lay = _gan_layouts(mod)
    raw = load_pytree(path)
    like = gan_tree(mod)
    with_opt = raw.get("g_opt_state") is not None and raw.get("d_opt_state") is not None
    if not with_opt:
        logging.warning("%s: no optimizer state: Adam moments reinitialized", path)
        like = {k: like[k] for k in ("g", "g_running", "d")}
        raw = {k: raw.get(k) for k in like}
    tree = _restore_like(raw, like, path)
    with torch.no_grad():
        for key, module in (("g", mod.g), ("d", mod.d)):
            for p, t in zip(module.parameters(), lay[key].from_tree(tree[key])):
                p.copy_(t)
        for n, t in zip(lay["g"].names, lay["g"].from_tree(tree["g_running"])):
            mod.g_running[n].copy_(t)
    if with_opt:
        for key, opt in (("g", mod.g_opt), ("d", mod.d_opt)):
            opt.load_state_dict(adam_state_from_optax(
                tree[f"{key}_opt_state"], opt.state_dict(), lay[key].from_tree))
    return load_meta(path)


def load_gan_checkpoint(path: str):
    """Load a fine-tuned GAN checkpoint -> (g state_dict, d state_dict|None)
    in the port's rosinality layout, which models.stylegan2.Generator and
    Discriminator load with ``strict=True``.

    Accepts the JAX package's ``model_gan_{n}_final.ckpt`` msgpack tree
    {"g", "g_running", "d"} written by its --updateGAN trainer (the EMA
    ``g_running`` is preferred, the standard eval choice), converted by
    io/convert.py, or a torch ``.pt`` with ``g_ema``/``d`` state dicts (the
    fixed blur kernels stripped). The reference's save_path_gan surface
    (vis_w.py --save_path_gan -> load_multi_models,
    transform_base.py:501-509)."""
    from ..models import stylegan2 as sg2
    from .convert import discriminator_from_jax, generator_from_jax

    if _looks_like_torch(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("g_ema", ckpt.get("g", ckpt))
        if not any(k.startswith("to_rgbs.") for k in sd):
            raise ValueError(
                f"{path}: no 'to_rgbs.*' keys in the state dict — expected a "
                "rosinality-layout StyleGAN2 generator (g_ema/g) checkpoint; "
                f"top-level keys: {sorted(sd)[:8]}..."
            )
        d = sg2.strip_blur_kernels(ckpt["d"]) if "d" in ckpt else None
        return sg2.strip_blur_kernels(sd), d
    tree = load_gan_state(path)
    g = tree.get("g_running", tree.get("g"))
    d = tree.get("d")
    return generator_from_jax(g), (None if d is None else discriminator_from_jax(d))


def load_gan_state(path: str) -> dict:
    """Raw {'g', 'g_running', 'd'} dict from a GAN checkpoint written by the
    JAX package's cli.train._save_gan (structure-free restore)."""
    return _relistify(load_pytree(path))


# pytree keys whose values are Python LISTS in the JAX package's model params
# (sg2/pggan/resnet/walk trees). The digit-dict -> list conversion is scoped
# to these so a genuinely str-digit-keyed dict elsewhere (e.g. per-attribute
# banks named '0','1') survives a structure-free restore.
_LIST_KEYS = {"style", "convs", "to_rgbs", "noises", "blocks", "layers", "mlp",
              "progression", "to_rgb", "from_rgb"}


def _relistify(tree, parent_key: str | None = None):
    """A structure-free restore returns Python lists as {'0': ..., '1': ...}
    dicts; convert those back to lists under the known list-bearing keys."""
    if isinstance(tree, dict):
        keys = list(tree)
        if parent_key in _LIST_KEYS and keys and all(k.isdigit() for k in keys):
            idx = sorted(int(k) for k in keys)
            if idx == list(range(len(idx))):
                return [_relistify(tree[str(i)], parent_key) for i in idx]
        return {k: _relistify(v, k) for k, v in tree.items()}
    return tree
