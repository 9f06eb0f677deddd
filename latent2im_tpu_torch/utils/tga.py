"""TGA decoding in Python and numpy, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its TgaImagePlugin), bit for bit: the
GPU machine has no Pillow.

    tga_decode_rgb(data: bytes) -> uint8 [H, W, 3]

TGA has no signature: Pillow tries it after every other format, and so does
``utils/image.py:read_image_rgb``. As TgaImageFile reads it: the 18-byte
header (a colour map type of 0 or 1, a size above 0, a depth of 1, 8, 16,
24 or 32), the image ID skipped, the colour map (entries from its first
index on; those before it black, as are indices past it; 16-bit entries
5-5-5, 24-bit BGR, 32-bit BGRA; at most 256 entries in all), then the
pixels raw or run-length coded (types 9-11: a packet of 1-128 pixels, a run
of one pixel, which may not pass its row's end, or that many literal ones,
which go on into the next rows). Modes:
colour-mapped 8 bits; gray of 1 (set bits white), 8 or 16 bits (gray and
alpha; a gray image with a 16- or 24-bit colour map goes through it, as
Pillow puts the map on it); true colour of 16 bits (5-5-5 BGR, each channel v x 255 // 31), 24
(BGR) or 32 (BGRA). Rows run bottom up unless bit 5 of the descriptor is
set; bit 4 mirrors them. ``convert("RGB")`` drops the alpha.

What fails (ValueError, as Pillow fails): a header out of those bounds (so
the file is no TGA), an image type or type and depth pair Pillow has no
raw mode for (a colour-mapped type without a map among them), a colour map
of another depth, of 32 bits, past 256 entries or on a true-colour or
bilevel image, 1-bit run-length data (Pillow's
decoder reads no whole byte a pixel there), a run that passes its
row, data that ends before the image does, more pixels than Pillow opens.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind

_RAW = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
        (2, 24): "BGR", (2, 32): "BGRA"}


def _bgr15(v: np.ndarray) -> np.ndarray:
    """16-bit 5-5-5 pixels (little-endian, bit 15 alpha) -> RGB."""
    return np.stack([((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31,
                     (v & 31) * 255 // 31], -1).astype(np.uint8)


def _rle(data: bytes, pos: int, h: int, row: int, size: int) -> bytes:
    """TgaRleDecode: h rows of ``row`` bytes from packets of ``size``-byte
    pixels starting at data[pos]: a run may not pass its row's end; a
    literal packet goes on into the rows after it, what passes the last
    row dropped."""
    out = bytearray()
    n, need = len(data), h * row
    while len(out) < need:
        if pos >= n:
            raise ValueError("tga: the run-length data ends before the image does")
        head = data[pos]
        count = ((head & 0x7F) + 1) * size
        if head & 0x80:
            if len(out) % row + count > row:
                raise ValueError("tga: a run-length packet runs past its row")
            px = data[pos + 1:pos + 1 + size]
            if len(px) < size:
                raise ValueError("tga: the run-length data ends before the image does")
            out += px * (count // size)
            pos += 1 + size
        else:
            lit = data[pos + 1:pos + 1 + count]
            if len(lit) < count:
                raise ValueError("tga: the run-length data ends before the image does")
            out += lit
            pos += 1 + count
    return bytes(out[:need])


def tga_decode_rgb(data: bytes) -> np.ndarray:
    """TGA file bytes -> uint8 [H, W, 3] (see the module); ValueError where
    Pillow fails."""
    data = bytes(data)
    if len(data) < 18:
        raise NotThisKind("tga: not a TGA file (short header)")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    w, h = struct.unpack("<HH", data[12:16])
    depth, flags = data[16], data[17]
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise NotThisKind("tga: not a TGA file")
    if itype not in (1, 2, 3, 9, 10, 11):
        raise NotThisKind(f"tga: image type {itype}")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"tga: a {w}x{h} image: more pixels than Pillow opens")
    pos = 18 + id_len
    table = None
    if cmap_type:
        start, size, mdepth = struct.unpack("<HHB", data[3:8])
        if mdepth not in (16, 24, 32):
            raise NotThisKind(f"tga: a colour map of {mdepth} bits")
        k = mdepth // 8
        raw = bytes(k * start) + data[pos:pos + k * size]
        pos += k * size
        n = len(raw) // k
        if n > 256:
            raise ValueError(f"tga: a colour map of {n} entries (Pillow takes 256)")
        ent = np.frombuffer(raw[:n * k], np.uint8).reshape(n, k)
        table = np.zeros((256, 3), np.uint8)  # past the map: black
        if k == 2:
            table[:n] = _bgr15(ent[:, 0].astype(np.int64) | (ent[:, 1].astype(np.int64) << 8))
        else:
            table[:n] = ent[:, 2::-1]
    key = (itype & 7, depth)
    if key not in _RAW or (itype & 7 == 1 and not cmap_type):
        raise ValueError(f"tga: image type {itype} at {depth} bits: Pillow has no raw mode")
    if cmap_type and (itype & 7 == 2 or depth == 1 or k == 4):
        # Pillow puts the map on the image: a true-colour or bilevel image
        # takes none, and it has no raw mode for a 32-bit map
        raise ValueError(f"tga: a {8 * k}-bit colour map on a type {itype} image at {depth} "
                         "bits (Pillow fails it)")
    raw_mode = _RAW[key]
    row = (w * depth + 7) // 8
    if itype & 8:
        if depth == 1:
            raise ValueError("tga: 1-bit run-length data (Pillow fails it)")
        body = _rle(data, pos, h, row, depth // 8)
    else:
        body = data[pos:pos + row * h]
        if len(body) < row * h:
            raise ValueError("tga: the pixel data ends before the image does")
    rows = np.frombuffer(body, np.uint8).reshape(h, row)
    if raw_mode == "1":
        img = np.unpackbits(rows, axis=1)[:, :w] * 255
        img = np.repeat(img[..., None], 3, axis=-1)
    elif raw_mode in ("L", "LA"):  # through the colour map where there is one
        v = rows.reshape(h, w, -1)[..., 0]
        img = table[v] if table is not None else np.repeat(v[..., None], 3, axis=-1)
    elif raw_mode == "P":
        img = table[rows]
    elif raw_mode == "BGRA;15Z":
        px = rows.reshape(h, w, 2).astype(np.int64)
        img = _bgr15(px[..., 0] | (px[..., 1] << 8))
    else:
        img = rows.reshape(h, w, -1)[..., 2::-1] if raw_mode == "BGR" else \
            rows.reshape(h, w, 4)[..., 2::-1]
    orient = flags & 0x30
    if orient in (0x00, 0x10):  # bottom up
        img = img[::-1]
    if orient in (0x10, 0x30):
        img = img[:, ::-1]
    return np.ascontiguousarray(img, np.uint8)
