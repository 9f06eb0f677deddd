"""QOI decoding in Python, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its QoiImagePlugin), bit for bit: the
GPU machine has no Pillow.

    qoi_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As QoiDecoder reads it: the 14-byte header (``qoif``, big-endian width and
height, channels: 3 is RGB, anything else RGBA; the colour space byte
skipped), then the ops from the pixel (0, 0, 0, 255): QOI_OP_RGB (alpha
kept), QOI_OP_RGBA, QOI_OP_INDEX into the 64 pixels last seen by hash
(an empty slot is (0, 0, 0, 0)), QOI_OP_DIFF, QOI_OP_LUMA and QOI_OP_RUN
(which adds no pixel to the index), until the image is full; a run may
overshoot it, and a short final read makes a short pixel, as there.
``convert("RGB")`` drops the alpha.

What fails (ValueError, as Pillow fails): no ``qoif``, a zero size, more
pixels than Pillow opens, ops that end before the image does.
"""

from __future__ import annotations

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind


def qoi_decode_rgb(data: bytes) -> np.ndarray:
    """QOI file bytes -> uint8 [H, W, 3] (see the module); ValueError where
    Pillow fails."""
    data = bytes(data)
    if data[:4] != b"qoif" or len(data) < 14:
        raise NotThisKind("qoi: not a QOI file")
    w, h = int.from_bytes(data[4:8], "big"), int.from_bytes(data[8:12], "big")
    bands = 3 if data[12] == 3 else 4
    if w <= 0 or h <= 0:
        raise NotThisKind(f"qoi: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"qoi: a {w}x{h} image: more pixels than Pillow opens")
    need, pos, n = w * h * bands, 14, len(data)
    out = bytearray()
    prev = bytearray((0, 0, 0, 255))
    seen = {}
    while len(out) < need:
        if pos >= n:
            raise ValueError("qoi: the data ends before the image does")
        byte = data[pos]
        pos += 1
        if byte == 0xFE:  # QOI_OP_RGB
            value = bytearray(data[pos:pos + 3]) + prev[3:]
            pos += 3
        elif byte == 0xFF:  # QOI_OP_RGBA
            value = bytearray(data[pos:pos + 4])
            pos += 4
        else:
            op = byte >> 6
            if op == 0:  # QOI_OP_INDEX
                value = seen.get(byte & 63, bytearray(4))
            elif op == 1:  # QOI_OP_DIFF
                value = bytearray(((prev[0] + ((byte >> 4) & 3) - 2) % 256,
                                   (prev[1] + ((byte >> 2) & 3) - 2) % 256,
                                   (prev[2] + (byte & 3) - 2) % 256, prev[3]))
            elif op == 2:  # QOI_OP_LUMA
                if pos >= n:
                    raise ValueError("qoi: the data ends before the image does")
                second = data[pos]
                pos += 1
                dg = (byte & 63) - 32
                dr, db = (second >> 4) - 8, (second & 15) - 8
                value = bytearray(((prev[0] + dg + dr) % 256, (prev[1] + dg) % 256,
                                   (prev[2] + dg + db) % 256)) + prev[3:]
            else:  # QOI_OP_RUN
                out += (prev if bands == 4 else prev[:3]) * ((byte & 63) + 1)
                continue
        prev = value
        if len(value) == 4:
            r, g, b, a = value
            seen[(r * 3 + g * 5 + b * 7 + a * 11) % 64] = value
        else:  # a short final read: Pillow's hash of it fails
            raise ValueError("qoi: the data ends inside a pixel")
        out += value if bands == 4 else value[:3]
    px = np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, w, bands)
    return np.ascontiguousarray(px[..., :3])
