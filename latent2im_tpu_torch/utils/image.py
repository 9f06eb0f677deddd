"""Image conversion (own copy of latent2im_tpu/utils/image.py:to_uint8)."""

from __future__ import annotations

import numpy as np


def to_uint8(ims) -> np.ndarray:
    """[-1, 1] float images -> uint8 (the reference's clip_ims): clip
    ((x + 1) / 2) * 255 to [0, 255] and truncate. Already-uint8 input passes
    through."""
    ims = np.asarray(ims)
    if ims.dtype == np.uint8:
        return ims
    return np.uint8(np.clip(((ims + 1) / 2.0) * 255, 0, 255))
