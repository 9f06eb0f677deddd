"""ICO and CUR decoding in Python and numpy, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its IcoImagePlugin and
CurImagePlugin), bit for bit: the GPU machine has no Pillow.

    ico_decode_rgb(data: bytes) -> uint8 [H, W, 3]

ICO: of the directory's entries (a width or height of 0 is 256), the one
Pillow loads: sorted by colour depth (the bit count, else log2 of the
colour count rounded up, else 256), then by area, largest first, the first
one. A PNG frame goes through ``utils/image.py:png_decode_rgb``; a bitmap
frame through ``utils/bmp.py:dib_decode_rgb`` at half its header's height,
its AND mask (rows of width padded to 32 bits, at the end of the entry's
bytes) read as Pillow reads it, which must be there whole, although the
alpha it makes is dropped by ``convert("RGB")`` (a 32-bit frame's alpha
comes from its own fourth bytes instead).

CUR: the first entry, or a later one both wider and taller than the one
kept, read as a bitmap at half its header's height (Pillow applies no
mask to a cursor).

What fails (ValueError, as Pillow fails): no ICO or CUR signature, no
entry, an entry whose frame Pillow cannot read (a cursor's PNG frame among
them), a mask that ends early.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .bmp import dib_decode_rgb
from .modes import NotThisKind

_PNG = b"\x89PNG\r\n\x1a\n"


def ico_decode_rgb(data: bytes) -> np.ndarray:
    """ICO or CUR file bytes -> uint8 [H, W, 3] (see the module); ValueError
    where Pillow fails."""
    data = bytes(data)
    if data[:4] == b"\0\0\2\0":
        return _cur(data)
    if data[:4] != b"\0\0\1\0":
        raise ValueError("ico: not an ICO or CUR file")
    if len(data) < 6:
        raise NotThisKind("ico: a short header")
    n = struct.unpack("<H", data[4:6])[0]
    entries = []
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise NotThisKind("ico: the directory runs past the end of the file")
        w, h, colors = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack("<HII", s[6:16])
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append((w, h, bpp, size, offset, depth))
    if not entries:
        raise NotThisKind("ico: no entries")
    entries.sort(key=lambda e: e[5])
    entries.sort(key=lambda e: e[0] * e[1], reverse=True)
    w, h, bpp, size, offset, _ = entries[0]
    if data[offset:offset + 8] == _PNG:
        from .image import png_decode_rgb  # image.py imports this module
        return png_decode_rgb(data[offset:])
    img = dib_decode_rgb(data, offset, halve=True)
    if bpp != 32:  # the AND mask: 1 bit a pixel, rows padded to 32 bits
        h, w = img.shape[:2]
        mw = w + (-w) % 32
        total = mw * h // 8
        start = offset + size - total
        # Pillow's raw decoder reads no padding after the mask's last row
        if start < 0 or len(data[start:start + total]) < mw // 8 * (h - 1) + (w + 7) // 8:
            raise ValueError("ico: the AND mask ends before the image does")
    return img


def _cur(data: bytes) -> np.ndarray:
    if len(data) < 6:
        raise NotThisKind("cur: a short header")
    n = struct.unpack("<H", data[4:6])[0]
    m = b""
    for i in range(n):
        s = data[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif len(s) < 2:
            raise NotThisKind("cur: the directory runs past the end of the file")
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise NotThisKind("cur: no cursors")
    if len(m) < 16:  # i32 of a short entry: struct.error, and Pillow moves on
        raise NotThisKind("cur: a short entry")
    at = struct.unpack("<I", m[12:16])[0]
    # at 0, Pillow reads the bitmap from where the directory ends
    return dib_decode_rgb(data, at or 6 + 16 * n, halve=True)
