"""McIdas area file decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its McIdasImagePlugin), bit for
bit: the GPU machine has no Pillow.

    mcidas_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As McIdasImageFile reads it: a 256-byte area directory of 64 big-endian
words starting 00 00 00 00 00 00 00 04; word 11 (counting from 1) the
bytes a sample, 1 (L), 2 (I;16B) or 4 (I;32B as I), words 10 and 9 the
width and height, the rows at word 34 + word 15 and a stride of word 15 +
width x word 11 x word 14. I is then clipped to 0-255 as ``convert``
does. Another sample size passes the file on; a stride shorter than a row
and data short of the image fail. Where Pillow maps the file (L and
I;16B; ``raw.mapped_lines``), any stride reads, and the data must hold the
image at it.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind
from .raw import mapped_lines, to_rgb, unpack


def accepts(prefix: bytes) -> bool:
    """McIdasImagePlugin._accept."""
    return prefix[:8] == b"\0\0\0\0\0\0\0\x04"


def mcidas_decode_rgb(data: bytes) -> np.ndarray:
    """McIdas area file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    if len(data) < 256 or not accepts(data):
        raise NotThisKind("mcidas: not a McIdas area file")
    wd = (0,) + struct.unpack(">64i", data[:256])
    kinds = {1: ("L", "L"), 2: ("I;16B", "I;16B"), 4: ("I", "I;32B")}
    if wd[11] not in kinds:
        raise NotThisKind(f"mcidas: {wd[11]} bytes a sample")
    mode, rawmode = kinds[wd[11]]
    w, h = wd[10], wd[9]
    if w <= 0 or h <= 0:
        raise NotThisKind(f"mcidas: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"mcidas: a {w}x{h} image: more pixels than Pillow opens")
    stride = wd[15] + w * wd[11] * wd[14]  # 0: a row's own size; short of it fails
    if mode == rawmode:  # opened by its path, Pillow maps the file
        lines = mapped_lines(data, wd[34] + wd[15], w, h, mode, stride)
        if lines is not None:
            return to_rgb(mode, unpack(lines.tobytes(), 0, w, h, rawmode))
    return to_rgb(mode, unpack(data, wd[34] + wd[15], w, h, rawmode, stride))
