"""The reference's walk checkpoints (pickled whole ``nn.Module``s) — the walk
part of latent2im_tpu/io/torch_convert.py, ported.

The reference saves ``torch.save(self.walk, save_path_w +
'_walk_module.ckpt')`` (transform_base.py:492-505): a pickle that names the
walk's class by its qualified name. Stub classes under those names let it
load without the reference package, and an instance of the stub carrying
real parameters in the reference's attribute layout is what the reference
unpickles onto its real class. The port holds ``linear_w``
(WalkLinearMultiW, [A, L, 512], the same layout on both sides); the other
walk classes wait for their walk kinds (ROADMAP.md queue A item 18).
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


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A item 18: the nine "
        "remaining walk kinds)")


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


def convert_walk_state(cls: str, state: dict, attr_list: list[str]) -> dict:
    """Map a reference walk module's state_dict onto the port's walk params
    (numpy; see walks/walks.py for the layouts)."""
    if cls == "WalkLinearMultiW":
        return {"w": np.asarray(state["w"], np.float32)}  # [A, L, 512], same layout
    if cls in _WALK_CLASS_NAMES:
        raise _not_ported(f"the reference walk class {cls!r}")
    raise ValueError(f"unknown walk checkpoint class: {cls}")


def export_walk_torch(path: str, kind: str, params: dict,
                      attr_list: list[str] | None = None,
                      nsliders: int = 1) -> None:
    """Save a walk trained by the port as the reference's pickled-module
    checkpoint, loadable by reference tooling (load_multi_models,
    transform_base.py:497-505) and by load_walk_checkpoint."""
    if kind not in _KIND_CLASS:
        raise ValueError(f"no reference checkpoint format for walk kind {kind!r}")
    if kind != "linear_w":
        raise _not_ported(f"exporting the {kind!r} walk")
    _register_walk_stubs()
    cls_name, mod_name = _KIND_CLASS[kind]
    m = getattr(sys.modules[mod_name], cls_name)()
    m.Nsliders = nsliders
    w = torch.as_tensor(params["w"]).detach().to("cpu", torch.float32).clone()
    m.w = torch.nn.Parameter(w)  # [A, L, D]
    m.dim_z, m.step = w.shape[2], w.shape[1] // 2 - 1
    torch.save(m, path)
