"""Sun raster decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its SunImagePlugin and
SunRleDecode.c), bit for bit: the GPU machine has no Pillow.

    sun_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As SunImageFile reads it: the 32-byte big-endian header (magic
0x59A66A95, width, height, depth, length, type, colormap type and
length); depth 1 (raw mode 1;I: a set bit black), 4 (L;4), 8 (L, or P
through a colormap), 24 and 32 (BGR and BGRX, RGB and RGBX where the type
is 3). A colormap of up to 1024 bytes (its type must be 1) is planar:
its first third red, then green, then blue; entries past it keep the gray
ramp. Types 0, 1, 3, 4 and 5 are raw rows padded to 16 bits; type 2 is
run-length coded (SunRleDecode.c): 0x80 0 a literal 0x80, 0x80 n v
n + 1 bytes of v (a run may cross into the rows after), any other byte
itself, into rows of (width x depth + 7) // 8 bytes with no padding. What
the header does not allow passes the file on (Pillow's SyntaxError);
data short of the image fails.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind
from .raw import line_bytes, palette_table, to_rgb, unpack


def accepts(prefix: bytes) -> bool:
    """SunImagePlugin._accept."""
    return prefix[:4] == b"\x59\xa6\x6a\x95"


def _rle(data: bytes, pos: int, need: int) -> bytes:
    """SunRleDecode.c -> the first ``need`` bytes it writes from
    data[pos:]: bytes below 0x80 or above are themselves, runs are whole
    slices (numpy over the positions of the escapes)."""
    src = np.frombuffer(data, np.uint8)
    out = bytearray()
    n = len(src)
    esc = np.flatnonzero(src[pos:] == 0x80) + pos
    k = 0
    while len(out) < need:
        while k < len(esc) and esc[k] < pos:
            k += 1
        nxt = esc[k] if k < len(esc) else n
        if nxt > pos:  # literal bytes up to the next escape
            take = min(nxt - pos, need - len(out))
            out += src[pos:pos + take].tobytes()
            pos += take
            continue
        if pos + 2 > n:
            break
        count = int(src[pos + 1])
        if count == 0:
            out.append(0x80)
            pos += 2
            continue
        if pos + 3 > n:
            break
        out += bytes([int(src[pos + 2])]) * (count + 1)
        pos += 3
    if len(out) < need:
        raise ValueError("sun: the run-length data ends before the image does (image file is "
                         "truncated)")
    return bytes(out[:need])


def sun_decode_rgb(data: bytes) -> np.ndarray:
    """Sun raster file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    if len(data) < 32 or not accepts(data):
        raise NotThisKind("sun: not a Sun raster file")
    w, h, depth, _, ftype, ptype, plen = struct.unpack(">7I", data[4:32])
    if depth == 1:
        mode, rawmode = "1", "1;I"
    elif depth == 4:
        mode, rawmode = "L", "L;4"
    elif depth == 8:
        mode = rawmode = "L"
    elif depth == 24:
        mode, rawmode = "RGB", "RGB" if ftype == 3 else "BGR"
    elif depth == 32:
        mode, rawmode = "RGB", "RGBX" if ftype == 3 else "BGRX"
    else:
        raise NotThisKind(f"sun: depth {depth}")
    offset, palette = 32, None
    if plen:
        if plen > 1024:
            raise NotThisKind("sun: a colormap of more than 1024 bytes")
        if ptype != 1:
            raise NotThisKind(f"sun: colormap type {ptype}")
        raw = np.frombuffer(data[32:32 + plen], np.uint8)
        n = len(raw) // 3
        palette = palette_table(np.stack([raw[:n], raw[n:2 * n], raw[2 * n:3 * n]], -1))
        offset += plen
        if mode == "L":
            mode, rawmode = "P", "P"
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise NotThisKind(f"sun: type {ftype}")
    if w <= 0 or h <= 0:
        raise NotThisKind(f"sun: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"sun: a {w}x{h} image: more pixels than Pillow opens")
    if ftype == 2:
        rows = _rle(data, offset, line_bytes(w, rawmode) * h)
        v = unpack(rows, 0, w, h, rawmode)
    else:
        v = unpack(data, offset, w, h, rawmode, ((w * depth + 15) // 16) * 2)
    return to_rgb(mode, v, palette)
