"""GIMP brush (GBR) decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its GbrImagePlugin), bit for bit:
the GPU machine has no Pillow.

    gbr_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As GbrImageFile reads it: big-endian words of the header size (at least
20), the version (1, or 2 with ``GIMP`` and a spacing word after the five
words), the width, height and colour depth (1: L, 4: RGBA, whose alpha
``convert("RGB")`` drops); a comment of the header size less 20 (28 in
version 2) bytes, then width x height x depth bytes of pixels (a negative
comment length reads the rest of the file as comment). What the header
does not allow passes the file on; pixels short of the image fail.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind, gray_rgb


def accepts(prefix: bytes) -> bool:
    """GbrImagePlugin._accept."""
    return len(prefix) >= 8 and struct.unpack(">I", prefix[:4])[0] >= 20 and \
        struct.unpack(">I", prefix[4:8])[0] in (1, 2)


def gbr_decode_rgb(data: bytes) -> np.ndarray:
    """GBR file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    if len(data) < 20 or not accepts(data):
        raise NotThisKind("gbr: not a GIMP brush")
    size, version, w, h, depth = struct.unpack(">5I", data[:20])
    if w == 0 or h == 0:
        raise NotThisKind("gbr: an empty brush")
    if depth not in (1, 4):
        raise NotThisKind(f"gbr: colour depth {depth}")
    pos = 20
    if version == 1:
        comment = size - 20
    else:
        comment = size - 28
        if data[20:24] != b"GIMP":
            raise NotThisKind("gbr: no GIMP magic")
        if len(data) < 28:
            raise NotThisKind("gbr: the spacing cut by the end of the file")
        pos = 28
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"gbr: a {w}x{h} image: more pixels than Pillow opens")
    pos = len(data) if comment < 0 else pos + comment
    need = w * h * depth
    body = data[pos:pos + need]
    if len(body) < need:
        raise ValueError("gbr: not enough image data")
    v = np.frombuffer(body, np.uint8).reshape(h, w, depth)
    return gray_rgb(v[..., 0]) if depth == 1 else np.ascontiguousarray(v[..., :3])
