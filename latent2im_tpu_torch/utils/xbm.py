"""XBM (X11 bitmap) decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its XbmImagePlugin and
XbmDecode.c), bit for bit: the GPU machine has no Pillow.

    xbm_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As XbmImageFile reads it: its header regex over the first 512 bytes
(``#define ..._width``, ``_height``, an optional hot spot, up to the
``_bits[]`` that ends the match); then XbmDecode.c from there: each value
is the two characters after the next ``x`` (a character other than a hex
digit counts 0), bytes of (width + 7) // 8 a row, bits least significant
first, a set bit white (raw mode 1;R). A header the regex does not match
passes the file on; data that ends before the image does fails.
"""

from __future__ import annotations

import re

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind

_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
# XbmDecode.c's HEX(): a hex digit's value, any other character 0
_HEX = np.zeros(256, np.uint8)
for _c, _v in zip(b"0123456789abcdefABCDEF", list(range(16)) + list(range(10, 16))):
    _HEX[_c] = _v


def accepts(prefix: bytes) -> bool:
    """XbmImagePlugin._accept."""
    return prefix.lstrip().startswith(b"#define")


def xbm_decode_rgb(data: bytes) -> np.ndarray:
    """XBM file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    m = _HEAD.match(data[:512])
    if not m:
        raise NotThisKind("xbm: not an XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise NotThisKind(f"xbm: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"xbm: a {w}x{h} image: more pixels than Pillow opens")
    stride = (w + 7) // 8
    need = stride * h
    body = np.frombuffer(data[m.end():], np.uint8)
    xs = np.flatnonzero(body == ord("x"))
    # the decoder skips to an x and takes it with the two bytes after it
    # when all three are there; the next search starts past them
    vals, nxt = [], 0
    for at in xs:
        if at < nxt:
            continue
        if at + 3 > len(body) or len(vals) == need:
            break
        vals.append(at)
        nxt = at + 3
    if len(vals) < need:
        raise ValueError("xbm: the data ends before the image does (image file is truncated)")
    at = np.asarray(vals[:need], np.int64)
    byte = (_HEX[body[at + 1]] << 4) | _HEX[body[at + 2]]
    bits = np.unpackbits(byte.astype(np.uint8).reshape(h, stride), axis=1, bitorder="little")
    return np.repeat((bits[:, :w] * 255)[..., None], 3, -1)
