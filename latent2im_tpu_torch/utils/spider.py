"""SPIDER image decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its SpiderImagePlugin), bit for
bit: the GPU machine has no Pillow. SPIDER has no signature: the reader
tries a file where Pillow's order of plugins comes to it.

    spider_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As SpiderImageFile reads it: 27 float32 header values, big-endian if that
passes ``isSpiderHeader`` (words 1, 2, 5, 12, 13, 22 and 23 whole numbers,
IFORM, word 5, one of 1, 3, -11, -12, -21, -22, the header bytes LABBYT
equal to LABREC x LENBYT and not 0), else little-endian; IFORM 1 (a 2D
image) only. Word 12 is the width, word 2 the height; a single image's
float32s (in that byte order) follow the header, a stack's first image
follows the stack header and its own header (2 x LABBYT). Then F to RGB:
truncated to 0-255 (``utils/modes.py:f_rgb``). A header of neither byte
order or of another IFORM passes the file on; an image number without a
stack, data short of the image fail.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind, f_rgb
from .raw import unpack

_IFORMS = (1, 3, -11, -12, -21, -22)


def _whole(f: float) -> bool:
    """SpiderImagePlugin.isInt."""
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _header_len(t) -> int:
    """isSpiderHeader: the header's bytes, or 0."""
    h = (99,) + tuple(t)
    if not all(_whole(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in _IFORMS:
        return 0
    labbyt = int(h[22])
    if labbyt != int(h[13]) * int(h[23]):
        return 0
    return labbyt


def spider_decode_rgb(data: bytes) -> np.ndarray:
    """SPIDER file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    if len(data) < 108:
        raise NotThisKind("spider: a header cut short")
    for order, rawmode in ((">", "F;32BF"), ("<", "F;32F")):
        t = struct.unpack(order + "27f", data[:108])
        hdrlen = _header_len(t)
        if hdrlen:
            break
    else:
        raise NotThisKind("spider: not a SPIDER file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NotThisKind("spider: not a 2D image")
    w, ht = int(h[12]), int(h[2])
    try:
        istack, imgnumber = int(h[24]), int(h[27])
    except (ValueError, OverflowError) as e:  # not a number, or infinite
        raise ValueError("spider: a stack word that is no number") from e
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        raise ValueError("spider: an image number without a stack (Pillow has no stack "
                         "offset to read it from)")
    else:
        raise NotThisKind("spider: inconsistent stack header values")
    if w <= 0 or ht <= 0:
        raise NotThisKind(f"spider: a {w}x{ht} image")
    if w * ht > PILLOW_MAX_PIXELS:
        raise ValueError(f"spider: a {w}x{ht} image: more pixels than Pillow opens")
    return f_rgb(unpack(data, offset, w, ht, rawmode)[..., 0])
