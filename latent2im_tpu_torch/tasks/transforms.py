"""Per-transform alpha semantics (copy of latent2im_tpu/tasks/transforms.py:
25-196 for the attribute tasks).

Each task maps a scalar test alpha to the graph input; ``lo``/``hi`` record
the transform's alpha range. Two training samplers, both one uniform draw
per attribute shared by the batch, as in the reference:

  * ``train_alpha_np(rng, batch, n_attr)``  numpy RandomState, bit-matching
    the JAX package's host sampler;
  * ``train_alpha(generator, batch, n_attr)``  the same statistics on a
    ``torch.Generator``, on the generator's device.

Both return (alpha_for_graph [B, A], alpha_for_target [A]);
``test_alphas`` gives the eval CLI's panels. The geometric/color tasks and
the dsprites slider composition wait for ROADMAP.md queue A item 12.
"""

from __future__ import annotations

import numpy as np
import torch


class Task:
    """Base: uniform alpha in [lo, hi]."""

    lo: float = 0.0
    hi: float = 1.0

    def __init__(self, walk_type: str = "linear", nsliders: int = 1):
        self.walk_type = walk_type
        self.nsliders = nsliders

    def train_alpha_np(self, rng: np.random.RandomState, batch: int,
                       n_attr: int):
        a = rng.uniform(self.lo, self.hi, n_attr).astype(np.float32)
        return np.ones((batch, n_attr), np.float32) * a, a

    def train_alpha(self, generator: torch.Generator, batch: int, n_attr: int):
        a = torch.rand((n_attr,), generator=generator, device=generator.device)
        a = a * (self.hi - self.lo) + self.lo
        return a.expand(batch, n_attr), a

    def scale_test_alpha(self, alpha: float, batch: int,
                         n_sliders: int | None = None):
        n = n_sliders or self.nsliders
        return np.full((batch, n), alpha, np.float32)

    def test_alphas(self):
        """The eval CLI's panel targets."""
        return np.linspace(0, 1, 10)


class FaceTransform(Task):
    """CelebA attributes: alpha in [0, 1]."""

    lo, hi = 0.0, 1.0

    def test_alphas(self):
        if self.walk_type == "linear":
            return np.linspace(0, 1, 10)
        raise ValueError("face test_alphas defined for linear walks only")


class SceneTransform(Task):
    lo, hi = -1.0, 1.0


class XrayTransform(Task):
    lo, hi = 0.0, 1.0

    def test_alphas(self):
        return np.linspace(0, 1, 9)


class ChairTransform(Task):
    lo, hi = -1.0, 1.0


class DspritesTransform(Task):
    lo, hi = -1.0, 1.0

    def train_alpha_np(self, *args, **kwargs):
        raise NotImplementedError(
            "the dsprites training sliders (a scale ladder, two x sliders) are "
            "not ported yet (ROADMAP.md queue A item 12)"
        )

    train_alpha = train_alpha_np


TASKS = {
    "face": FaceTransform,
    "scene": SceneTransform,
    "xray": XrayTransform,
    "chair": ChairTransform,
    "dsprites": DspritesTransform,
}


def task_kwargs_from_options(opt) -> dict:
    """Transform-specific constructor kwargs from the grouped option
    namespaces. Accepts argparse Namespaces or yaml dicts."""
    kw: dict = {}
    if getattr(opt, "transform", "") in ("color", "colorlab"):
        grp = getattr(opt, "color", None)
        ch = (grp.get("channel") if isinstance(grp, dict)
              else getattr(grp, "channel", None))
        if ch is not None:
            kw["channel"] = int(ch)
    return kw


def get_task(transform: str, walk_type: str = "linear", nsliders: int = 1,
             **kw) -> Task:
    if transform in TASKS:
        return TASKS[transform](walk_type=walk_type, nsliders=nsliders)
    raise NotImplementedError(
        f"transform '{transform}' is not ported yet (have {sorted(TASKS)}; "
        "the geometric/color tasks are ROADMAP.md queue A item 12)"
    )
