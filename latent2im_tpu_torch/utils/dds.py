"""DDS decoding in numpy, as Pillow 12.1 reads a DirectDraw Surface
(``PIL.Image.open(p).convert("RGB")``, its DdsImagePlugin), bit for bit: the
GPU machine has no Pillow.

    dds_decode_rgb(data: bytes) -> uint8 [H, W, 3]

The 124-byte header (its size field must say so), then the pixel format as
the plugin tries it: RGB flag (uncompressed pixels by bit masks, each
channel's value shifted down by its mask's trailing zeros, divided by the
mask so shifted and scaled by 255 in float64, truncated; the data read a
pixel at a time, zeros past its end), luminance (8-bit gray, or 16-bit gray
and alpha), an 8-bit palette (1024 bytes of RGBA after the header), FourCC
DXT1/3/5, ATI1/BC4U, ATI2/BC5U, BC5S, or a DX10 header whose DXGI format is
BC1-BC7 or R8G8B8A8 (``utils/bcn.py`` for the blocks). Only the top mip level
of the first face is read, from just after the header, as Pillow reads it;
``convert("RGB")`` drops alpha and replicates gray.

What fails (ValueError, as Pillow fails): another magic or header size, a
header cut short, a format the plugin does not map, luminance of other
bits, data that ends before the image does (all but the mask-based form),
more pixels than Pillow opens.
"""

from __future__ import annotations

import struct

import numpy as np

from .bcn import bcn_decode
from .jpeg import PILLOW_MAX_PIXELS

_ALPHAPIXELS, _FOURCC, _PALETTE8, _RGB, _LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000
# FourCC -> (bcn decoder, signed)
_FOURCC_BCN = {b"DXT1": (1, False), b"DXT3": (2, False), b"DXT5": (3, False),
               b"BC4U": (4, False), b"ATI1": (4, False), b"BC5S": (5, True),
               b"BC5U": (5, False), b"ATI2": (5, False)}
# DXGI format -> (bcn decoder, signed), or 0 for raw RGBA
_DXGI = {70: (1, False), 71: (1, False), 73: (2, False), 74: (2, False), 76: (3, False),
         77: (3, False), 79: (4, False), 80: (4, False), 82: (5, False), 83: (5, False),
         84: (5, True), 95: (6, False), 96: (6, True), 97: (7, False), 98: (7, False),
         99: (7, False), 27: 0, 28: 0, 29: 0}


def accepts(prefix: bytes) -> bool:
    return prefix[:4] == b"DDS "


def _raw(body: bytes, w: int, h: int, bpp: int) -> np.ndarray:
    """Pillow's raw decoder: rows of w * bpp bytes, failing where the data
    ends first."""
    need = w * h * bpp
    if len(body) < need:
        raise ValueError("dds: the data ends before the image does (Pillow: image file is "
                         "truncated)")
    return np.frombuffer(body, np.uint8, need).reshape(h, w, bpp)


def _masked(body: bytes, w: int, h: int, bitcount: int, masks) -> np.ndarray:
    """DdsRgbDecoder: each pixel's little-endian value of bitcount // 8
    bytes (zeros past the data), each mask's channel scaled to 8 bits."""
    nbytes = bitcount // 8
    need = w * h * nbytes
    raw = np.frombuffer(body[:need] + bytes(max(0, need - len(body))), np.uint8)
    v = np.zeros(w * h, np.uint64)
    for i in range(nbytes):
        v |= raw[i::nbytes].astype(np.uint64) << np.uint64(8 * i)
    out = []
    for mask in masks:
        off = (mask & -mask).bit_length() - 1 if mask else 0
        total = mask >> off
        if not total:
            out.append(np.zeros(w * h, np.uint8))
            continue
        x = ((v & np.uint64(mask)) >> np.uint64(off)).astype(np.float64)
        out.append((x / total * 255).astype(np.int64).astype(np.uint8))
    return np.stack(out, -1).reshape(h, w, len(masks))


def dds_decode_rgb(data: bytes) -> np.ndarray:
    """DDS file bytes -> uint8 [H, W, 3] (see the module); ValueError where
    Pillow fails."""
    data = bytes(data)
    if not accepts(data):
        raise ValueError("dds: not a DDS file")
    if len(data) < 8 or struct.unpack("<I", data[4:8])[0] != 124:
        raise ValueError("dds: a header size other than 124")
    if len(data) < 128:
        raise ValueError("dds: the header is cut short")
    hdr = data[8:128]
    _, h, w = struct.unpack("<3I", hdr[:12])
    if not w or not h:  # ImageFile: no such image, Pillow identifies no file
        raise ValueError(f"dds: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"dds: a {w}x{h} image: more pixels than Pillow opens")
    _, pfflags, fourcc, bitcount = struct.unpack("<4I", hdr[68:84])
    fourcc = struct.pack("<I", fourcc)
    body = data[128:]
    if pfflags & _RGB:
        n = 4 if pfflags & _ALPHAPIXELS else 3
        img = _masked(body, w, h, bitcount, struct.unpack(f"<{n}I", hdr[84:84 + 4 * n]))
        return np.ascontiguousarray(img[..., :3])
    if pfflags & _LUMINANCE:
        if bitcount == 8:
            g = _raw(body, w, h, 1)
        elif bitcount == 16 and pfflags & _ALPHAPIXELS:
            g = _raw(body, w, h, 2)[..., :1]
        else:
            raise ValueError(f"dds: luminance of {bitcount} bits")
        return np.repeat(g, 3, axis=-1)
    if pfflags & _PALETTE8:
        pal = np.frombuffer(body[:1024], np.uint8)
        table = np.zeros((256, 3), np.uint8)  # entries the file does not hold: black
        table[:len(pal) // 4] = pal[:len(pal) // 4 * 4].reshape(-1, 4)[:, :3]
        return table[_raw(body[1024:], w, h, 1)[..., 0]]
    if not pfflags & _FOURCC:
        raise ValueError(f"dds: unknown pixel format flags {pfflags}")
    if fourcc == b"DX10":
        if len(body) < 4:
            raise ValueError("dds: the DX10 header is cut short")
        (dxgi,) = struct.unpack("<I", body[:4])
        if dxgi not in _DXGI:
            raise ValueError(f"dds: DXGI format {dxgi} (Pillow has no decoder for it)")
        kind, body = _DXGI[dxgi], body[20:]
        if kind == 0:
            return np.ascontiguousarray(_raw(body, w, h, 4)[..., :3])
    elif fourcc in _FOURCC_BCN:
        kind = _FOURCC_BCN[fourcc]
    else:
        raise ValueError(f"dds: pixel format {fourcc!r} (Pillow has no decoder for it)")
    n, signed = kind
    img = bcn_decode(body, w, h, n, signed)
    if n == 4:
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])
