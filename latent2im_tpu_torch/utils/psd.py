"""PSD decoding in numpy, as Pillow 12.1 reads a Photoshop file's composite
image (``PIL.Image.open(p).convert("RGB")``, its PsdImagePlugin), bit for
bit: the GPU machine has no Pillow.

    psd_decode_rgb(data: bytes) -> uint8 [H, W, 3]

The 26-byte header (version 1; the mode and depth as ``MODES`` maps them:
bitmap, gray, duotone and multichannel as gray, an indexed image with a
768-byte planar palette, RGB, RGB with a fourth channel as RGBA, CMYK
read inverted, LAB), the colour mode data, the image resources and the
layer section skipped as the plugin walks them, then the composite image:
raw planes (each ``width x height`` bytes after the last) or PackBits
(a row byte count table, each plane's stream from the sum of the counts
before it, runs and literals that overrun a row cut at its end, 0x80 a
no-op, rows filled one after another). ``convert("RGB")`` drops alpha,
converts CMYK as Pillow does and replicates gray; an indexed image with no
768-byte palette is black, as Pillow's empty palette gives it.

What fails (ValueError, as Pillow fails): no signature or another version,
a mode or depth Pillow has no mode for (16 and 32 bits), fewer channels
than the mode needs, a structure cut by the end of the file, compression
other than raw and PackBits, data that ends before the image does, more
pixels than Pillow opens; LAB, which Pillow converts with LittleCMS, raises
naming ROADMAP item 28.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS, cmyk_to_rgb

_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
          (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
          (9, 8): ("LAB", 3)}


def accepts(prefix: bytes) -> bool:
    return prefix[:4] == b"8BPS"


class _Reader:
    """The plugin's ``fp.read`` with the struct readers that fail on a
    short read (i8, i16, i32 big-endian)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        got = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(got)
        return got

    def int(self, n: int) -> int:
        got = self.read(n)
        if len(got) < n:
            raise ValueError("psd: the file ends inside its structure")
        return int.from_bytes(got, "big")


def _packbits_rows(data: bytes, at: int, rows: int, row: int) -> np.ndarray:
    """PackBitsDecode.c from ``at`` until ``rows`` rows of ``row`` bytes
    are full (runs and literals cut at a row's end)."""
    out = np.zeros((rows, row), np.uint8)
    buf, y, n = bytearray(), 0, len(data)
    while y < rows:
        if at >= n:
            raise ValueError("psd: the PackBits data ends before the image does")
        c = data[at]
        if c == 0x80:
            at += 1
            continue
        if c > 0x80:
            if at + 2 > n:
                raise ValueError("psd: the PackBits data ends before the image does")
            buf += data[at + 1:at + 2] * min(257 - c, row - len(buf))
            at += 2
        else:
            if at + c + 2 > n:
                raise ValueError("psd: the PackBits data ends before the image does")
            buf += data[at + 1:at + 2 + c][:row - len(buf)]
            at += c + 2
        if len(buf) >= row:
            out[y] = np.frombuffer(bytes(buf), np.uint8)
            buf, y = bytearray(), y + 1
    return out


def _plane(mode: str, rows: np.ndarray, w: int) -> np.ndarray:
    if mode == "1":
        return np.unpackbits(rows, axis=1)[:, :w] * np.uint8(255)
    return rows[:, :w]


def psd_decode_rgb(data: bytes) -> np.ndarray:
    """PSD file bytes -> uint8 [H, W, 3] (see the module); ValueError where
    Pillow fails."""
    data = bytes(data)
    if len(data) < 26 or not accepts(data) or data[4:6] != b"\0\x01":
        raise ValueError("psd: not a PSD file")
    nch, h, w, bits, pmode = struct.unpack(">HIIHH", data[12:26])
    if (pmode, bits) not in _MODES:
        raise ValueError(f"psd: mode {pmode} at {bits} bits (Pillow has no mode for it)")
    mode, channels = _MODES[(pmode, bits)]
    if channels > nch:
        raise ValueError("psd: not enough channels")
    if mode == "RGB" and nch == 4:
        mode, channels = "RGBA", 4
    if not w or not h:  # ImageFile: no such image, Pillow identifies no file
        raise ValueError(f"psd: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"psd: a {w}x{h} image: more pixels than Pillow opens")
    r = _Reader(data, 26)
    size = r.int(4)
    pal = None
    if size:
        body = r.read(size)
        if mode == "P" and size == 768:
            pal = np.frombuffer(body, np.uint8).reshape(3, 256).T
    size = r.int(4)
    if size:  # image resources
        end = r.pos + size
        while r.pos < end:
            r.read(4)
            r.int(2)
            name = r.read(r.int(1))
            if not len(name) & 1:
                r.read(1)
            if len(r.read(r.int(4))) & 1:
                r.read(1)
    size = r.int(4)
    if size:  # layer and mask information
        end = r.pos + size
        r.int(4)
        r.pos = end
    comp = r.int(2)
    row = (w + 7) // 8 if mode == "1" else w
    planes = []
    if comp == 0:
        at = r.pos
        for _ in range(channels):
            body = data[at:at + row * h]
            if len(body) < row * h:
                raise ValueError("psd: the image data ends before the image does")
            planes.append(_plane(mode, np.frombuffer(body, np.uint8).reshape(h, row), w))
            at += w * h
    elif comp == 1:
        counts = r.read(channels * h * 2)
        if len(counts) < channels * h * 2:
            raise ValueError("psd: the row byte counts are cut short")
        counts = np.frombuffer(counts, ">u2").astype(np.int64)
        starts = r.pos + np.concatenate([[0], np.cumsum(counts.reshape(channels, h).sum(1))])
        for c in range(channels):
            planes.append(_plane(mode, _packbits_rows(data, int(starts[c]), h, row), w))
    else:
        raise ValueError(f"psd: compression {comp} (Pillow cannot load it)")
    if mode == "LAB":  # Image.convert goes through LittleCMS (ImageCms)
        raise ValueError("psd: LAB is not supported (Pillow converts it with LittleCMS; "
                         "ROADMAP item 28)")
    if mode == "CMYK":
        return cmyk_to_rgb(*(255 - p.astype(np.int64) for p in planes))
    if mode == "P":
        table = pal if pal is not None else np.zeros((256, 3), np.uint8)
        return table[planes[0]]
    if mode in ("RGB", "RGBA"):
        return np.stack(planes[:3], -1)
    return np.repeat(planes[0][..., None], 3, -1)
