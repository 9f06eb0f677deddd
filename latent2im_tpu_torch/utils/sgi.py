"""SGI image decoding in Python and numpy, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its SgiImagePlugin and
SgiRleDecode.c), bit for bit: the GPU machine has no Pillow.

    sgi_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As SgiImageFile reads it: the 512-byte header (magic 474, storage 0
verbatim or 1 run-length, 1 or 2 bytes a channel, dimension and channel
count as Pillow pairs them: gray of dimension 1 or 2, RGB and RGBA of 3),
rows bottom up, each channel a plane. A 2-byte channel keeps its high byte.
Run-length rows come through the offset and length tables after the header
(big-endian, a row's channels ysize apart): each packet's count is the low
seven bits of its byte (of its 2-byte word's low byte), bit 7 set copies
that many values, clear repeats the next value; a count of 0 ends the row.
SgiRleDecode.c's quirks are kept: the row buffer is not cleared between
rows (a row that ends early keeps the last row's values after it), a row
that reaches its length in packets without a 0 ends the decode there (the
rows not reached stay black), a row's length is a C int (one of 2^31 or
more packets is negative and decodes nothing, the row buffer kept), and a
literal run may not end on the file's last byte. ``convert("RGB")`` drops
the alpha.

What fails (ValueError, as Pillow fails): no magic, another channel size,
dimension or channel count, a table past the data or an offset into the
header, a row longer than the width, a read past the data, data that ends
before the image does, more pixels than Pillow opens.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS

_MODES = {(1, 1, 1): 1, (1, 2, 1): 1, (2, 1, 1): 1, (2, 2, 1): 1, (1, 3, 3): 3, (2, 3, 3): 3,
          (1, 3, 4): 4, (2, 3, 4): 4}


def accepts(prefix: bytes) -> bool:
    """SgiImagePlugin._accept: does Pillow try a file as SGI?"""
    return len(prefix) >= 2 and prefix[:2] == b"\x01\xda"


def _expand(src: bytes, at: int, n: int, xsize: int, bpc: int, dest: list, ch: int,
            bands: int) -> int:
    """expandrow / expandrow2 into dest (the row buffer, bpc-byte values at
    ch, ch + bands, ...) -> 0 at a row's end, 1 where n packets pass with
    no end, -1 at an overrun."""
    last, x = len(src) - 1, 0
    d = ch
    for left in range(n, 0, -1):
        if at + bpc - 1 > last:
            return -1
        pixel = src[at + bpc - 1]
        at += bpc
        if left == 1 and pixel != 0:
            return 1
        count = pixel & 0x7F
        if not count:
            return 0
        if x + count > xsize:
            return -1
        x += count
        if pixel & 0x80:
            if at + bpc * count > last:
                return -1
            for _ in range(count):
                dest[d] = src[at:at + bpc]
                at += bpc
                d += bands
        else:
            if at + bpc > last:
                return -1
            v = src[at:at + bpc]
            at += bpc
            for _ in range(count):
                dest[d] = v
                d += bands
    return 0


def sgi_decode_rgb(data: bytes) -> np.ndarray:
    """SGI file bytes -> uint8 [H, W, 3] (see the module); ValueError where
    Pillow fails."""
    data = bytes(data)
    if len(data) < 512 or not accepts(data):
        raise ValueError("sgi: not an SGI image file")
    comp, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack(">HHHH", data[4:12])
    if (bpc, dim, z) not in _MODES:
        raise ValueError(f"sgi: {bpc} bytes a channel, dimension {dim}, {z} channels")
    bands = _MODES[(bpc, dim, z)]
    if w <= 0 or h <= 0:
        raise ValueError(f"sgi: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"sgi: a {w}x{h} image: more pixels than Pillow opens")
    if comp == 0:
        need = w * h * bpc * bands
        body = data[512:512 + need]
        if len(body) < need:
            raise ValueError("sgi: the data ends before the image does")
        planes = np.frombuffer(body, np.uint8).reshape(bands, h, w, bpc)[..., 0]
        img = planes.transpose(1, 2, 0)
    elif comp == 1:
        src = data[512:]
        tab = h * bands
        if len(src) < 8 * tab:
            raise ValueError("sgi: the run-length tables run past the data")
        starts = struct.unpack(f">{tab}I", src[:4 * tab])
        # SgiRleDecode.c counts a row's packets in a C int: a length of 2^31
        # or more is negative there, and such a row decodes nothing
        lengths = struct.unpack(f">{tab}i", src[4 * tab:8 * tab])
        row = [bytes(bpc)] * (w * bands)
        img = np.zeros((h, w, bands), np.uint8)
        done = False
        for r in range(h):
            for c in range(bands):
                off, n = starts[r + c * h], lengths[r + c * h]
                if off < 512:
                    raise ValueError("sgi: a run-length row offset into the header")
                st = _expand(src, off - 512, n, w, bpc, row, c, bands)
                if st == -1:
                    raise ValueError("sgi: a run-length row past its width or the data")
                if st == 1:
                    done = True
                    break
            if done:
                break
            img[r] = np.frombuffer(b"".join(row), np.uint8).reshape(w, bands, bpc)[..., 0]
    else:
        raise ValueError(f"sgi: storage {comp}")
    img = img[::-1]
    if bands == 1:
        return np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])
