"""PIXAR raster decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its PixarImagePlugin), bit for
bit: the GPU machine has no Pillow.

    pixar_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As PixarImageFile reads it: the magic 80 E8 00 00, a 512-byte header whose
little-endian words at 418 and 416 are the width and height and at 424 and
426 the storage (14, 2 is RGB, the only mode it takes), then raw RGB rows
from byte 1024. Another storage or a header cut short passes the file
on; data short of the image fails.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind
from .raw import unpack


def accepts(prefix: bytes) -> bool:
    """PixarImagePlugin._accept."""
    return prefix[:4] == b"\x80\xe8\x00\x00"


def pixar_decode_rgb(data: bytes) -> np.ndarray:
    """PIXAR file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    if not accepts(data) or len(data) < 428:
        raise NotThisKind("pixar: not a PIXAR file")
    h, w = struct.unpack("<HH", data[416:420])
    if struct.unpack("<HH", data[424:428]) != (14, 2):
        raise NotThisKind("pixar: a storage other than RGB")
    if w <= 0 or h <= 0:
        raise NotThisKind(f"pixar: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"pixar: a {w}x{h} image: more pixels than Pillow opens")
    return unpack(data, 1024, w, h, "RGB").astype(np.uint8)
