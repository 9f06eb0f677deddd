"""Per-transform alpha semantics at inference (numpy-only copy of
latent2im_tpu/tasks/transforms.py:25-196).

Each task maps a scalar test alpha to the graph input; ``lo``/``hi`` record
the transform's alpha range. The training samplers and the test/vis
schedules wait for the training and vis slices; the geometric/color tasks
for ROADMAP.md queue A item 12.
"""

from __future__ import annotations

import numpy as np


class Task:
    """Base: uniform alpha in [lo, hi]."""

    lo: float = 0.0
    hi: float = 1.0

    def __init__(self, walk_type: str = "linear", nsliders: int = 1):
        self.walk_type = walk_type
        self.nsliders = nsliders

    def scale_test_alpha(self, alpha: float, batch: int,
                         n_sliders: int | None = None):
        n = n_sliders or self.nsliders
        return np.full((batch, n), alpha, np.float32)


class FaceTransform(Task):
    """CelebA attributes: alpha in [0, 1]."""

    lo, hi = 0.0, 1.0


class SceneTransform(Task):
    lo, hi = -1.0, 1.0


class XrayTransform(Task):
    lo, hi = 0.0, 1.0


class ChairTransform(Task):
    lo, hi = -1.0, 1.0


class DspritesTransform(Task):
    lo, hi = -1.0, 1.0


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
