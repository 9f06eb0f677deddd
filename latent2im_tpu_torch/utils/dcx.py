"""DCX (Intel's multi-page PCX) decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its DcxImagePlugin), bit for bit:
the GPU machine has no Pillow.

    dcx_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As DcxImageFile reads it: the magic 0x3ADE68B1 (little-endian), then up
to 1024 page offsets ending at a 0; the first page is a PCX image at its
offset (``utils/pcx.py:pcx_decode_rgb``, whose 256-colour palette still
lies at the end of the whole file). A directory cut by the end of the
file, or no page, passes the file on (Pillow's ``_open`` raises
struct.error or EOFError there); what the PCX reader fails fails.
"""

from __future__ import annotations

import struct

import numpy as np

from .modes import NotThisKind
from .pcx import pcx_decode_rgb


def accepts(prefix: bytes) -> bool:
    """DcxImagePlugin._accept."""
    return prefix[:4] == b"\xb1\x68\xde\x3a"


def dcx_decode_rgb(data: bytes) -> np.ndarray:
    """DCX file bytes -> its first page as uint8 [H, W, 3]."""
    data = bytes(data)
    if not accepts(data):
        raise NotThisKind("dcx: not a DCX file")
    pos = 4
    first = None
    for _ in range(1024):
        if pos + 4 > len(data):
            raise NotThisKind("dcx: the page directory cut by the end of the file")
        (off,) = struct.unpack("<I", data[pos:pos + 4])
        pos += 4
        if not off:
            break
        if first is None:
            first = off
    if first is None:
        raise NotThisKind("dcx: no page")
    return pcx_decode_rgb(data, first)
