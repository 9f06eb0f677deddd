"""MSP (Microsoft Paint 1 and 2) decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its MspImagePlugin and Python
MspDecoder), bit for bit: the GPU machine has no Pillow.

    msp_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As MspImageFile reads it: ``DanM`` (version 1) or ``LinS`` (version 2), a
32-byte header whose sixteen little-endian words XOR to 0, the size at
bytes 4-7; mode 1, a set bit white. Version 1 is raw rows of
(width + 7) // 8 bytes from byte 32. Version 2 has a row map of height
words after the header, then each row's run-length bytes: a type byte 0
repeats the byte after the count that follows it, any other type copies
that many bytes (fewer where the row ends first); a map entry of 0 is a
white row. The runs are one stream, cut into rows only at the end, so a
row that decodes long or short shifts the rows after it. A bad checksum
passes the file on; a row map or a row cut by the end of the file, a run
of type 0 cut by the end of its row and data short of the image fail.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind
from .raw import to_rgb, unpack


def accepts(prefix: bytes) -> bool:
    """MspImagePlugin._accept."""
    return prefix[:4] in (b"DanM", b"LinS")


def _rows(data: bytes, w: int, h: int) -> bytes:
    """MspDecoder: the row map and each row's runs -> the image's bytes."""
    stride = (w + 7) // 8
    rowmap = data[32:32 + 2 * h]
    if len(rowmap) < 2 * h:
        raise ValueError("msp: a row map cut by the end of the file")
    out = bytearray()
    pos = 32 + 2 * h
    for y, n in enumerate(struct.unpack(f"<{h}H", rowmap)):
        if n == 0:
            out += b"\xff" * stride
            continue
        row = data[pos:pos + n]
        pos += n
        if len(row) != n:
            raise ValueError(f"msp: row {y} cut by the end of the file")
        i = 0
        while i < n:
            kind = row[i]
            i += 1
            if kind == 0:
                if i + 2 > n:
                    raise ValueError(f"msp: a run cut by the end of row {y}")
                out += row[i + 1:i + 2] * row[i]
                i += 2
            else:
                out += row[i:i + kind]
                i += kind
    return bytes(out)


def msp_decode_rgb(data: bytes) -> np.ndarray:
    """MSP file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    head = data[:32]
    if not accepts(head):
        raise NotThisKind("msp: not an MSP file")
    if len(head) < 32:
        raise NotThisKind("msp: a header cut short")
    words = struct.unpack("<16H", head)
    check = 0
    for v in words:
        check ^= v
    if check:
        raise NotThisKind("msp: a bad checksum")
    w, h = words[2], words[3]
    if w <= 0 or h <= 0:
        raise NotThisKind(f"msp: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"msp: a {w}x{h} image: more pixels than Pillow opens")
    if head[:4] == b"DanM":
        return to_rgb("1", unpack(data, 32, w, h, "1"))
    return to_rgb("1", unpack(_rows(data, w, h), 0, w, h, "1"))
