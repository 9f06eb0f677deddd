"""PCX decoding in Python and numpy, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its PcxImagePlugin and PcxDecode.c),
bit for bit: the GPU machine has no Pillow. The file is read from its path,
as the JAX package's readers open every image (``PIL.Image.open(path)``).

    pcx_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As PcxImageFile reads it: the 128-byte header (byte 0 is 10, the version
0, 2, 3 or 5), the window's size, then by bits and planes: 1 x 1 bilevel
(set bits white); 1 x 2 or 1 x 4 bit planes indexing the header's 16-colour
palette; version 5 8 x 1, through the 256-colour palette 769 bytes from the
end where it starts with 12 (gray where that palette is the identity, or
there is none); version 5 8 x 3 as planar RGB. Each line is planes x the
stride of (width x bits + 7) // 8 bytes, made even where the header's
bytes-per-line disagree; its run-length code (a byte with both top bits
set repeats the next byte its low six bits times) never runs past the
line. Bit planes lie a (padded) stride apart; 8-bit lines whose bytes are
more than and no multiple of the width have each plane but the first moved
back to width x plane bytes before unpacking, as PcxDecode.c does, whatever
that makes of them.

What fails (ValueError, as Pillow fails): another first byte or version,
an empty window, another bits and planes pairing, an 8-bit file shorter
than 769 bytes (Pillow's seek back from the end of the file fails; from
memory it would read), a run past its line, data that ends before the
image does, more pixels than Pillow opens.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind


def accepts(prefix: bytes) -> bool:
    """PcxImagePlugin._accept: does Pillow try a file as PCX?"""
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def _lines(data: bytes, pos: int, h: int, line: int) -> list:
    """PcxDecode: h lines of ``line`` bytes from data[pos]."""
    out, n = [], len(data)
    buf = bytearray()
    while len(out) < h:
        if pos >= n:
            raise ValueError("pcx: the data ends before the image does")
        b = data[pos]
        if b & 0xC0 == 0xC0:
            if pos + 1 >= n:
                raise ValueError("pcx: the data ends before the image does")
            count = b & 0x3F
            if len(buf) + count > line:
                raise ValueError("pcx: a run past its line")
            buf += bytes([data[pos + 1]]) * count
            pos += 2
        else:
            buf.append(b)
            pos += 1
        if len(buf) >= line:
            out.append(bytes(buf))
            buf = bytearray()
    return out


def pcx_decode_rgb(data: bytes, at: int = 0) -> np.ndarray:
    """PCX file bytes -> uint8 [H, W, 3] (see the module); ValueError where
    Pillow fails. at: where the header lies (a DCX file's page); the lines
    follow it, and the 256-colour palette is still read from the file's
    end."""
    data = bytes(data)
    head = data[at:at + 128]
    if len(head) < 68 or not accepts(head):
        raise NotThisKind("pcx: not a PCX file")
    x0, y0, x1, y1 = struct.unpack("<HHHH", head[4:12])
    x1, y1 = x1 + 1, y1 + 1
    if x1 <= x0 or y1 <= y0:
        raise NotThisKind("pcx: an empty window")
    version, bits, planes = head[1], head[3], head[65]
    provided = struct.unpack("<H", head[66:68])[0]
    w, h = x1 - x0, y1 - y0
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"pcx: a {w}x{h} image: more pixels than Pillow opens")
    table = None
    if bits == 1 and planes == 1:
        kind = "1"
    elif bits == 1 and planes in (2, 4):
        kind = "P"
        table = np.zeros((256, 3), np.uint8)
        table[:16] = np.frombuffer(head[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        kind = "L"
        if len(data) < 769:
            # PcxImageFile seeks 769 bytes back from the end of the file it
            # opened, which fails on a shorter one (OSError)
            raise ValueError("pcx: an 8-bit file shorter than 769 bytes (Pillow's seek back "
                             "to its palette fails)")
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12 and \
                tail[1:] != bytes(np.repeat(np.arange(256, dtype=np.uint8), 3)):
            kind = "P"
            table = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
    elif version == 5 and bits == 8 and planes == 3:
        kind = "RGB"
    else:
        raise ValueError(f"pcx: {bits} bits in {planes} planes (version {version})")
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    line = planes * stride
    rows = []
    for buf in _lines(data, at + 128, h, line):
        buf = bytearray(buf)
        if bits == 8 and line % w and line > w:  # each plane but the first moved back
            bands = line // w
            step = line // bands
            for i in range(1, bands):
                buf[i * w:i * w + w] = buf[i * step:i * step + w]
        rows.append(bytes(buf))
    lines = np.frombuffer(b"".join(rows), np.uint8).reshape(h, line)
    if kind == "1":
        v = np.unpackbits(lines[:, :(w + 7) // 8], axis=1)[:, :w] * 255
        return np.repeat(v[..., None], 3, axis=-1)
    if kind == "RGB":  # RGB;L: the three planes' first w bytes each
        return np.ascontiguousarray(
            np.stack([lines[:, i * w:(i + 1) * w] for i in range(3)], -1))
    if bits == 1:  # P;2L, P;4L: bit plane p (weight 2^p) at p x the stride
        idx = np.zeros((h, w), np.int64)
        for p in range(planes):
            idx |= np.unpackbits(lines[:, p * stride:(p + 1) * stride], axis=1)[:, :w].astype(
                np.int64) << p
        return table[idx]
    v = lines[:, :w]
    return table[v] if kind == "P" else np.repeat(v[..., None], 3, axis=-1)
