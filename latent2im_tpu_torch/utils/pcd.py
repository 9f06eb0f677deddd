"""Kodak PhotoCD base image decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its PcdImagePlugin and
PcdDecode.c), bit for bit: the GPU machine has no Pillow. PCD has no
signature: the reader tries a file where Pillow's order of plugins comes
to it.

    pcd_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As PcdImageFile reads it: ``PCD_`` at byte 2048 and 1539 bytes of header
there, whose last byte's low two bits are the orientation; the 768 x 512
base image at 96 x 2048, in chunks of two rows of luma (768 bytes each),
then 384 bytes each of C1 and C2 for both rows (nearest: sample x // 2).
Pillow's decoder does convert the samples: its raw mode YCC;P takes
PhotoYCC to RGB (UnpackYCC.c) through tables of trunc(k x v + 0.5) (C's
cast, toward zero): L = 1.3584 Y, C1' = 2.2179 (C1 - 156), C2' = 1.8215
(C2 - 137), R = L + C2', G = L - 0.194 C1' - 0.509 C2' (each term its own
table), B = L + C1', each clipped to 0-255. Orientation 1 turns the image
90 degrees counterclockwise, 3 by 270. No ``PCD_`` or a header cut short
passes the file on; data short of the image fails.
"""

from __future__ import annotations

import numpy as np

from .modes import NotThisKind

_I = np.arange(256, dtype=np.float64)
_L, _CR, _CB, _GB, _GR = (np.trunc(v + 0.5).astype(np.int64) for v in (
    1.3584 * _I, 1.8215 * (_I - 137), 2.2179 * (_I - 156), -0.194 * 2.2179 * (_I - 156),
    -0.509 * 1.8215 * (_I - 137)))


def photoycc_rgb(y, c1, c2) -> np.ndarray:
    """UnpackYCC.c's PhotoYCC to RGB of uint8 samples -> uint8 [..., 3]."""
    lum = _L[y]
    rgb = np.stack([lum + _CR[c2], lum + _GR[c2] + _GB[c1], lum + _CB[c1]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def pcd_decode_rgb(data: bytes) -> np.ndarray:
    """PhotoCD file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    head = data[2048:2048 + 1539]
    if not head.startswith(b"PCD_") or len(head) < 1539:
        raise NotThisKind("pcd: not a PhotoCD file")
    orientation = head[1538] & 3
    start, need = 96 * 2048, 3 * 768 * 256
    body = data[start:start + need]
    if len(body) < need:
        raise ValueError("pcd: the data ends before the image does (image file is truncated)")
    chunks = np.frombuffer(body, np.uint8).reshape(256, 3 * 768)
    y = chunks[:, :1536].reshape(512, 768)
    cols = np.arange(768) // 2
    c1 = np.repeat(chunks[:, 1536:1920][:, cols], 2, axis=0)
    c2 = np.repeat(chunks[:, 1920:2304][:, cols], 2, axis=0)
    img = photoycc_rgb(y, c1, c2)
    if orientation == 1:
        return np.ascontiguousarray(np.rot90(img, 1))
    if orientation == 3:
        return np.ascontiguousarray(np.rot90(img, -1))
    return img
