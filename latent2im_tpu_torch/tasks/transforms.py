"""Per-transform alpha semantics (copy of latent2im_tpu/tasks/transforms.py:
25-196; the geometric and color tasks are in tasks/geometric.py).

Each task maps a scalar test alpha to the graph input; ``lo``/``hi`` record
the transform's alpha range. Two training samplers, both one uniform draw
per attribute shared by the batch, as in the reference:

  * ``train_alpha_np(rng, batch, n_attr)``  numpy RandomState, bit-matching
    the JAX package's host sampler;
  * ``train_alpha(generator, batch, n_attr)``  the same statistics on a
    ``torch.Generator``, on the generator's device.

Both return (alpha_for_graph [B, A], alpha_for_target [A]);
``test_alphas`` gives the eval CLI's panels and ``vis_alphas`` a vis
schedule. --trainEmbed draws one index into a discrete alpha ladder per
step instead (``train_alpha_embed_np``). dsprites composes its sliders per
factor (a scale ladder, two x sliders, posx, posy); its device sampler
covers the 5-slider default vocabulary only and raises ValueError for
another, which the training loop takes as the signal to sample on the host.
"""

from __future__ import annotations

import numpy as np
import torch


class Task:
    """Base: uniform alpha in [lo, hi]."""

    lo: float = 0.0
    hi: float = 1.0
    # --trainEmbed's discrete panel (utils/transforms.py:640-656 of the
    # reference): each step trains the bank entry of one index of this ladder
    num_panel: int = 6
    embed_alpha_max: float = 1.0

    def __init__(self, walk_type: str = "linear", nsliders: int = 1):
        self.walk_type = walk_type
        self.nsliders = nsliders

    def embedding_alphas(self) -> np.ndarray:
        """The discrete --trainEmbed alpha ladder."""
        return np.linspace(0.0, 1.0, self.num_panel)

    def train_alpha_embed_np(self, rng: np.random.RandomState, batch: int,
                             n_attr: int | None = None):
        """--trainEmbed sampling: one ladder index per step, drawn as the JAX
        package draws it -> (slider [B, nsliders] = alpha / embed_alpha_max,
        the ladder's alpha, the index of the bank entry the step trains)."""
        index = int(rng.choice(self.num_panel))
        alpha_val = float(self.embedding_alphas()[index])
        slider = np.full((batch, self.nsliders), alpha_val / self.embed_alpha_max,
                         np.float32)
        return slider, np.float32(alpha_val), index

    def train_alpha_np(self, rng: np.random.RandomState, batch: int,
                       n_attr: int, attr_list=None):
        """attr_list: the configured attributes, which only dsprites'
        composition reads."""
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

    def vis_alphas(self, num_panels: int):
        return np.linspace(0, 1, num_panels)


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
    """Composes per-factor sliders (transforms.py:785-861 of the reference):
    'scale' draws from a discrete ladder {0.5 .. 1.0}, 'x' gives TWO U(-1, 1)
    sliders, 'posx'/'posy' draw U(0, 1); 'y' gives no slider of its own, as
    in the reference."""

    lo, hi = -1.0, 1.0
    SCALE_LADDER = (0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

    def train_alpha(self, generator: torch.Generator, batch: int, n_attr: int = 5):
        """The default 5-slider vocabulary (scale, x, y, posx, posy) on the
        generator's device; another vocabulary raises ValueError."""
        if n_attr != 5:
            raise ValueError(
                f"dsprites device sampler covers the default 5-slider vocabulary; "
                f"got n_attr={n_attr} (train_loop falls back to the host sampler)")
        dev = generator.device
        ladder = torch.tensor(self.SCALE_LADDER, dtype=torch.float32, device=dev)
        scale = ladder[torch.randint(len(self.SCALE_LADDER), (1,), generator=generator,
                                     device=dev)]
        u = torch.rand((4,), generator=generator, device=dev)
        lo = torch.tensor([-1.0, -1.0, 0.0, 0.0], device=dev)
        hi = torch.tensor([1.0, 1.0, 1.0, 1.0], device=dev)
        a = torch.cat([scale, u * (hi - lo) + lo])
        return a.expand(batch, n_attr), a

    def train_alpha_np(self, rng, batch, n_attr=None, attr_list=None):
        attr_list = attr_list or ["scale", "x", "y", "posx", "posy"]
        alpha_vals, sliders = [], []
        if "scale" in attr_list:
            a = self.SCALE_LADDER[rng.choice(len(self.SCALE_LADDER))]
            alpha_vals.append(a)
            sliders.append(np.ones((batch, 1)) * a)
        if "x" in attr_list:
            for _ in range(2):
                a = rng.uniform(-1, 1)
                alpha_vals.append(a)
                sliders.append(np.ones((batch, 1)) * a)
        for name in ("posx", "posy"):
            if name in attr_list:
                a = rng.uniform(0, 1)
                alpha_vals.append(a)
                sliders.append(np.ones((batch, 1)) * a)
        return (
            np.hstack(sliders).astype(np.float32),
            np.hstack([np.atleast_1d(v) for v in alpha_vals]).astype(np.float32),
        )


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
    from .geometric import GEOMETRIC_TASKS

    if transform in GEOMETRIC_TASKS:
        return GEOMETRIC_TASKS[transform](walk_type=walk_type, nsliders=nsliders, **kw)
    raise KeyError(f"unknown transform '{transform}' "
                   f"(have {sorted(TASKS) + sorted(GEOMETRIC_TASKS)})")
