"""IM Tools (IMT) decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its ImtImagePlugin), bit for bit:
the GPU machine has no Pillow. IMT has no signature: the reader tries a
file where Pillow's order of plugins comes to it.

    imt_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As ImtImageFile reads it: a newline within the first 100 bytes, then
lines of ``<word> <value>`` (``width``, ``height``, ``pixel n8``: mode L;
lines starting with ``*`` are comments) until a form feed (0x0C), after
which the pixels lie, raw, one byte each. A line of one character or more
than 100, or one that is no field, ends the header without data (Pillow
then has no image to load and fails); no ``pixel n8`` or no size passes
the file on.
"""

from __future__ import annotations

import io
import re

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind, gray_rgb
from .raw import unpack

_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def imt_decode_rgb(data: bytes) -> np.ndarray:
    """IMT file bytes -> uint8 [H, W, 3] (see the module)."""
    fp = io.BytesIO(bytes(data))
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise NotThisKind("imt: not an IM Tools file")
    w = h = 0
    mode, offset = None, None
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":
            offset = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError as e:
            raise ValueError(f"imt: a {k.decode()} that is no number") from e
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if mode is None or w <= 0 or h <= 0:
        raise NotThisKind("imt: no mode or no size")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"imt: a {w}x{h} image: more pixels than Pillow opens")
    if offset is None:
        raise ValueError("imt: no image data (Pillow cannot load this image)")
    return gray_rgb(unpack(data, offset, w, h, "L")[..., 0])
