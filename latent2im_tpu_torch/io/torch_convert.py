"""The reference's walk checkpoints (pickled whole ``nn.Module``s) — the walk
part of latent2im_tpu/io/torch_convert.py, ported — and the regressor
trainer's torch export (``export_resnet50_torch``).

The reference saves ``torch.save(self.walk, save_path_w +
'_walk_module.ckpt')`` (transform_base.py:492-505): a pickle that names the
walk's class by its qualified name. Stub classes under those names let it
load without the reference package, and an instance of the stub carrying
real parameters in the reference's attribute layout is what the reference
unpickles onto its real class. Every walk kind has its class: ``linear_w``
(WalkLinearMultiW, [A, L, 512], the same layout on both sides), ``mlp_w``
(WalkMlpMultiW: ``linear``, a Sequential of Linear layers at indices 0, 2,
4 with LeakyReLUs between), ``nn_w`` (WalkNonLinearW: ``embed``, a
Linear(10, D/2), and ``linear`` at indices 0, 2), ``mlp_z`` (WalkMlpMultiZ:
``embed`` Linear(10, D), ``linear`` at 0, 2, 4, the one-hot ``direction``),
``linear_z_dir`` (WalkLinear: a ParameterDict of [1, D, Nsliders] per
attribute), ``embed`` (WalkEmbed / walk_embed: a ParameterDict ``w`` or
``w_embed`` of per-attribute banks), ``linear_z_free`` (WalkLinearZ_free:
``w`` [A, D]), ``linear_z`` (WalkLinearZ: one Linear(D, D)), ``mlp_z_norm``
and ``mlp_z3`` (WalkMlpZ2 / WalkMlpZ3 / WalkMlpZ: ``linear`` at even
indices); a Linear's weight is [out, in], the port's ``w`` [in, out].
"""

from __future__ import annotations

import sys

import numpy as np
import torch

_WALK_CLASS_NAMES = [
    "WalkEmbed",
    "WalkLinear",
    "WalkMlpMultiZ",
    "WalkLinearMultiW",
    "WalkMlpMultiW",
    "WalkNonLinearW",
    "WalkLinearZ",
    "WalkLinearZ_free",
    "WalkMlpZ",
    "WalkMlpZ2",
    "WalkMlpZ3",
    "walk_embed",
]

_REF_MODULES = [
    "graphs",
    "graphs.stylegan_v2_real",
    "graphs.stylegan_v2_real.transform_base",
    "graphs.pggan",
    "graphs.pggan.transform_base",
]

# walk kind -> (reference class, reference module)
_SG = "graphs.stylegan_v2_real.transform_base"
_PG = "graphs.pggan.transform_base"
_KIND_CLASS = {
    "linear_w": ("WalkLinearMultiW", _SG),
    "mlp_w": ("WalkMlpMultiW", _SG),
    "nn_w": ("WalkNonLinearW", _SG),
    "mlp_z": ("WalkMlpMultiZ", _SG),
    "linear_z_dir": ("WalkLinear", _SG),
    "embed": ("WalkEmbed", _SG),
    "linear_z_free": ("WalkLinearZ_free", _PG),
    "linear_z": ("WalkLinearZ", _PG),
    "mlp_z_norm": ("WalkMlpZ2", _PG),
    "mlp_z3": ("WalkMlpZ3", _PG),
}


def _register_walk_stubs():
    """Register stub modules/classes so pickled reference walk modules load
    without importing the reference package (whose op/ JIT-builds CUDA)."""
    import types

    import torch.nn as nn

    for mod_name in _REF_MODULES:
        if mod_name not in sys.modules:
            sys.modules[mod_name] = types.ModuleType(mod_name)
    for mod_name in (_SG, _PG):
        mod = sys.modules[mod_name]
        for cls_name in _WALK_CLASS_NAMES:
            if not hasattr(mod, cls_name):
                # Unpickling never calls __init__; a bare nn.Module subclass
                # with the right qualified name is enough to restore state.
                cls = type(cls_name, (nn.Module,),
                           {"__module__": mod_name, "__qualname__": cls_name})
                setattr(mod, cls_name, cls)


def load_walk_checkpoint(path: str) -> tuple[str, dict]:
    """Load a reference ``*_walk_module.ckpt`` -> (class_name, state arrays).
    It unpickles a whole module: read only files a trusted run wrote."""
    _register_walk_stubs()
    obj = torch.load(path, map_location="cpu", weights_only=False)
    state = {k: v.detach().cpu().numpy() for k, v in obj.state_dict().items()}
    return type(obj).__name__, state


def _lin_from_state(state, prefix):
    return {"w": np.asarray(state[f"{prefix}.weight"], np.float32).T.copy(),
            "b": np.asarray(state[f"{prefix}.bias"], np.float32)}


def convert_walk_state(cls: str, state: dict, attr_list: list[str]) -> dict:
    """Map a reference walk module's state_dict onto the port's walk params
    (numpy; see walks/walks.py for the layouts)."""
    if cls == "WalkLinearMultiW":
        return {"w": np.asarray(state["w"], np.float32)}  # [A, L, 512], same layout
    if cls == "WalkMlpMultiW":
        return {"mlp": [_lin_from_state(state, f"linear.{i}") for i in (0, 2, 4)]}
    if cls == "WalkNonLinearW":
        return {"embed": _lin_from_state(state, "embed"),
                "mlp": [_lin_from_state(state, f"linear.{i}") for i in (0, 2)]}
    if cls == "WalkMlpMultiZ":
        # stylegan z-space MLP walk (transform_base.py:86-111)
        return {"embed": _lin_from_state(state, "embed"),
                "mlp": [_lin_from_state(state, f"linear.{i}") for i in (0, 2, 4)]}
    if cls == "WalkLinear":
        # stylegan z-space direction bank (transform_base.py:66-83)
        names = list(attr_list) or sorted(
            {k.split(".", 1)[1] for k in state if k.startswith("w.")})
        if not names:
            raise ValueError("WalkLinear checkpoint has no direction banks")
        rows = []
        for n in names:
            bank = np.asarray(state[f"w.{n}"], np.float32)  # [1, D, Nsliders]
            if bank.shape[-1] != 1:
                raise ValueError(
                    f"WalkLinear attr {n!r} has Nsliders={bank.shape[-1]}; "
                    "only Nsliders=1 maps onto the linear_z_dir layout")
            rows.append(bank[0, :, 0])
        return {"w": np.stack(rows)}
    if cls == "WalkLinearZ":
        # pggan normalized-linear z walk (pggan transform_base.py:63-83)
        return {"lin": _lin_from_state(state, "linear")}
    if cls == "WalkLinearZ_free":
        return {"w": np.asarray(state["w"], np.float32)}  # [A, 512]
    if cls in ("WalkMlpZ3", "WalkMlpZ2", "WalkMlpZ"):
        return {"mlp": [_lin_from_state(state, f"linear.{i}") for i in range(0, 12, 2)
                        if f"linear.{i}.weight" in state]}
    if cls in ("WalkEmbed", "walk_embed"):
        key = "w" if any(k.startswith("w.") for k in state) else "w_embed"
        names = list(attr_list) or sorted(
            {k.split(".", 1)[1] for k in state if k.startswith(f"{key}.")})
        bank = {name: np.asarray(state[f"{key}.{name}"], np.float32) for name in names
                if f"{key}.{name}" in state}
        if not bank:
            raise ValueError(f"WalkEmbed checkpoint has no banks matching attrs {names}")
        return {"w": bank}
    raise ValueError(f"unknown walk checkpoint class: {cls}")


def export_walk_torch(path: str, kind: str, params: dict,
                      attr_list: list[str] | None = None,
                      nsliders: int = 1) -> None:
    """Save a walk trained by the port as the reference's pickled-module
    checkpoint, loadable by reference tooling (load_multi_models,
    transform_base.py:497-505) and by load_walk_checkpoint."""
    import torch.nn as nn

    if kind not in _KIND_CLASS:
        raise ValueError(f"no reference checkpoint format for walk kind {kind!r}")
    _register_walk_stubs()
    cls_name, mod_name = _KIND_CLASS[kind]
    m = getattr(sys.modules[mod_name], cls_name)()
    m.Nsliders = nsliders

    def t(a):
        return torch.as_tensor(a).detach().to("cpu", torch.float32).clone()

    def lin(layer):  # the port's [in, out] -> torch Linear [out, in]
        w = t(layer["w"])
        out = nn.Linear(w.shape[0], w.shape[1])
        out.weight, out.bias = nn.Parameter(w.T.contiguous()), nn.Parameter(t(layer["b"]))
        return out

    def seq(layers):  # Sequential(Linear, LeakyReLU, ..., Linear)
        mods = []
        for i, layer in enumerate(layers):
            mods.append(lin(layer))
            if i < len(layers) - 1:
                mods.append(nn.LeakyReLU(0.2, True))
        return nn.Sequential(*mods)

    m.step = None
    if kind == "linear_w":
        w = t(params["w"])
        m.w = nn.Parameter(w)  # [A, L, D]
        m.dim_z, m.step = w.shape[2], w.shape[1] // 2 - 1
    elif kind == "mlp_w":
        m.linear = seq(params["mlp"])
        m.dim_z = params["mlp"][0]["w"].shape[0]
    elif kind == "nn_w":
        m.embed = lin(params["embed"])
        m.linear = seq(params["mlp"])
        m.dim_z = params["embed"]["b"].shape[0] * 2
    elif kind == "mlp_z":
        m.embed = lin(params["embed"])
        m.linear = seq(params["mlp"])
        m.dim_z = params["embed"]["b"].shape[0]
        direction = torch.zeros((1, 10))
        direction[0, 0] = 1
        m.direction = direction
    elif kind == "linear_z_dir":
        w = t(params["w"])  # [A, D] -> a ParameterDict of [1, D, 1]
        names = list(attr_list or [f"attr{i}" for i in range(w.shape[0])])
        m.w = nn.ParameterDict({n: nn.Parameter(w[i][None, :, None].clone())
                                for i, n in enumerate(names)})
        m.dim_z = w.shape[1]
    elif kind == "embed":
        m.w = nn.ParameterDict({n: nn.Parameter(t(b)) for n, b in params["w"].items()})
        m.dim_z = next(iter(params["w"].values())).shape[2]
    elif kind == "linear_z_free":
        m.w = nn.Parameter(t(params["w"]))
        m.dim_z = params["w"].shape[1]
    elif kind == "linear_z":
        m.linear = lin(params["lin"])
        m.dim_z = params["lin"]["b"].shape[0]
    else:  # mlp_z_norm / mlp_z3
        m.linear = seq(params["mlp"])
        m.dim_z = params["mlp"][0]["w"].shape[0]
    torch.save(m, path)


def export_resnet50_torch(model) -> dict:
    """A ResNet50 (models/resnet.py) -> its torchvision-layout state_dict on
    the CPU, as the JAX package's export_resnet50_torch writes a trained
    regressor for the reference's torch pipeline: ``num_batches_tracked`` 0
    in every BN (the JAX package writes 0; torch's train-mode BN counts the
    steps), so both packages' exports load the same."""
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    for k in sd:
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0, dtype=torch.int64)
    return sd
