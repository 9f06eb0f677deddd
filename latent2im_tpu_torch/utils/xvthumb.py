"""XV thumbnail decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its XVThumbImagePlugin), bit for
bit: the GPU machine has no Pillow.

    xvthumb_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As XVThumbImageFile reads it: ``P7 332`` and the rest of its line, comment
lines (``#``), then the first other line's first two words as width and
height; one byte a pixel from there, through the fixed 3-3-2 palette
(red r x 255 // 7, green g x 255 // 7, blue b x 255 // 3). No size line
passes the file on; a size that is no number, and data short of the image,
fail.
"""

from __future__ import annotations

import io

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind
from .raw import unpack

_PALETTE = np.array([(r * 255 // 7, g * 255 // 7, b * 255 // 3)
                     for r in range(8) for g in range(8) for b in range(4)], np.uint8)


def accepts(prefix: bytes) -> bool:
    """XVThumbImagePlugin._accept."""
    return prefix.startswith(b"P7 332")


def xvthumb_decode_rgb(data: bytes) -> np.ndarray:
    """XV thumbnail file bytes -> uint8 [H, W, 3] (see the module)."""
    fp = io.BytesIO(bytes(data))
    if not accepts(fp.read(6)):
        raise NotThisKind("xvthumb: not an XV thumbnail file")
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise NotThisKind("xvthumb: no size line")
        if s[0] != 35:  # '#'
            break
    words = s.strip().split(maxsplit=2)[:2]
    if len(words) < 2:
        raise ValueError("xvthumb: a size line of fewer than two words")
    try:
        w, h = int(words[0]), int(words[1])
    except ValueError as e:
        raise ValueError("xvthumb: a size that is no number") from e
    if w <= 0 or h <= 0:
        raise NotThisKind(f"xvthumb: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"xvthumb: a {w}x{h} image: more pixels than Pillow opens")
    return _PALETTE[unpack(fp.getvalue(), fp.tell(), w, h, "P")[..., 0]]
