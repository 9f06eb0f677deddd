"""Checkpoint save/load/resume — PyTorch port of latent2im_tpu/io/checkpoint.py,
in the same files: a msgpack tree as ``flax.serialization`` writes it
(io/msgpack_codec.py, no flax or msgpack needed), a ``.meta.json`` beside it,
and the ``model_w_{epoch}[_final]_walk_module.ckpt`` names.

A walk checkpoint is ``{"walk": {...}, "opt_state": ...}``. The optimizer
state is stored in optax's layout, so that either package resumes the
other's run::

    {"0": {"count": int32 [], "mu": {"w": ...}, "nu": {"w": ...}}, "1": {}}

(``optax.adam``: scale_by_adam, then the learning-rate scale, whose state is
empty). ``adam_state_to_optax`` / ``adam_state_from_optax`` map it to and
from ``torch.optim.Adam.state_dict()`` (``step``, ``exp_avg``,
``exp_avg_sq``): both optimizers update by lr * m_hat / (sqrt(v_hat) + eps)
with both bias corrections, so the moments carry over as they are.

The reference's pickled walk modules are read through io/torch_convert.py.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

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
    if isinstance(like, torch.Tensor):
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{where}: shape {arr.shape}, expected {tuple(like.shape)}")
        return torch.as_tensor(arr, dtype=like.dtype, device=like.device).clone()
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


def adam_state_to_optax(state_dict: dict, walk_params: dict) -> dict:
    """torch Adam ``state_dict()`` over the walk's tensors (in the order of
    ``walk_params``, as engine.train.make_optimizer lists them) ->
    optax.adam's state tree of numpy arrays (zero moments and count 0 before
    the first step, as ``optax.adam().init`` makes them)."""
    keys = list(walk_params)
    st = state_dict["state"]
    if not st:
        zeros = {k: np.zeros(tuple(p.shape), np.float32) for k, p in walk_params.items()}
        return {"0": {"count": np.asarray(0, np.int32), "mu": zeros,
                      "nu": {k: z.copy() for k, z in zeros.items()}}, "1": {}}
    if set(st) != set(range(len(keys))):
        raise ValueError(f"Adam state holds params {sorted(st)} for walk keys {keys}")
    steps = {int(st[i]["step"]) for i in st}
    if len(steps) != 1:
        raise ValueError(f"the walk's tensors have taken different step counts {steps}")
    return {
        "0": {"count": np.asarray(steps.pop(), np.int32),
              "mu": {k: st[i]["exp_avg"].detach().cpu().numpy() for i, k in enumerate(keys)},
              "nu": {k: st[i]["exp_avg_sq"].detach().cpu().numpy()
                     for i, k in enumerate(keys)}},
        "1": {},
    }


def adam_state_from_optax(tree: dict, like: dict, walk_params: dict) -> dict:
    """optax.adam's state tree -> a torch Adam ``state_dict`` whose
    hyperparameters are those of ``like`` (a state_dict of the optimizer
    the run makes, engine.train.make_optimizer), with the moments on the
    walk's device."""
    adam = tree["0"]
    if set(adam) != {"count", "mu", "nu"} or tree.get("1", {}) != {}:
        raise ValueError(f"not an optax.adam state: keys {sorted(tree)} / {sorted(adam)}")
    keys = list(walk_params)
    if set(adam["mu"]) != set(keys) or set(adam["nu"]) != set(keys):
        raise ValueError(f"Adam moments for {sorted(adam['mu'])}, walk has {keys}")
    step = float(np.asarray(adam["count"]))
    if step == 0:  # optax's init state; torch Adam has none before a step
        return {"state": {}, "param_groups": [dict(g) for g in like["param_groups"]]}
    state = {}
    for i, k in enumerate(keys):
        p = walk_params[k]

        def moment(a, k=k, p=p):
            a = np.asarray(a)
            if a.shape != tuple(p.shape):
                raise ValueError(f"Adam moment of {k!r}: shape {a.shape}, walk {tuple(p.shape)}")
            return torch.as_tensor(a, dtype=p.dtype, device=p.device).clone()

        state[i] = {"step": torch.tensor(step), "exp_avg": moment(adam["mu"][k]),
                    "exp_avg_sq": moment(adam["nu"][k])}
    return {"state": state, "param_groups": [dict(g) for g in like["param_groups"]]}


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
        tree["opt_state"] = adam_state_to_optax(opt_state, walk_params)
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
        opt_state = adam_state_from_optax(tree["opt_state"], opt_state_like, walk)
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
