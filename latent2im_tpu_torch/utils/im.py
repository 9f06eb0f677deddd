"""IM (IFUNC Image Memory) decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its ImImagePlugin), bit for bit:
the GPU machine has no Pillow. IM has no signature: the reader tries a
file where Pillow's order of plugins comes to it.

    im_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As ImImageFile reads it: a newline within the first 100 bytes, then
``key: value`` lines (at most 100 bytes each, CR skipped) up to a NUL, a
0x1A or the end; ``Image size (x*y)`` (numbers, ``*`` or ``,`` apart),
``Image type`` (its names -> mode and raw mode: ``OPEN``), at least one
of the known keys; then the bytes up to the 0x1A. With a ``Lut`` key 768
bytes of planar palette follow: L, LA, P and PA images whose palette is
not a gray one become P or PA (raw mode PA;L) through it; a gray palette,
and any palette of another mode, change nothing (Pillow keeps it as a
``lut`` it never applies). The first frame's rows follow, bottom up
(``utils/raw.py``), RGB3 and RYB3 images as three planes (G, R, B), and
the bit-packed ``L*n`` types (n not 8, 16 or 32) through Pillow's bit
decoder (most significant bit first into float32s). Then Pillow's
``convert("RGB")`` of the mode. A header line that is no ``key: value``,
no known key, no size or mode and no 0x1A pass the file on; a value that
is no number, a mode or raw mode Pillow has no decoder for and data short
of the image fail.
"""

from __future__ import annotations

import io
import re

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind
from .raw import palette_table, to_rgb, unpack

_TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
         "Name", "Scale (x,y)", "Image size (x*y)", "Image type")
OPEN = {
    "0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
    "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
    "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
    "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
    "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
    "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
    "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
    "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L"),
}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
def _number(s: str):
    """ImImagePlugin.number: int, else float (ValueError otherwise)."""
    try:
        return int(s)
    except ValueError:
        return float(s)


def _bits(data: bytes, offset: int, w: int, h: int, bits: int) -> np.ndarray:
    """BitDecode.c with (bits, pad 8, fill 3, unsigned, bottom up): each
    byte ORed into the bit buffer above the bits it holds, each field taken
    from the buffer's bottom; at a row's end the bit count restarts at 0
    while the bits left stay in the buffer, under the next row's first
    bytes."""
    mask = (1 << bits) - 1
    out = np.zeros((h, w), np.float64)
    buf = count = x = 0
    y = h - 1
    pos = offset
    while True:
        if pos >= len(data):
            raise ValueError("im: the data ends before the image does (image file is "
                             "truncated)")
        byte = data[pos]
        pos += 1
        buf |= byte << count
        count += 8
        while count >= bits:
            out[y, x] = buf & mask
            if count > 32:
                buf = byte >> (8 - (count - bits))
            else:
                buf >>= bits
            count -= bits
            x += 1
            if x >= w:
                y -= 1
                if y < 0:
                    return out.astype(np.float32).astype(np.float64)[..., None]
                x = count = 0


def im_decode_rgb(data: bytes) -> np.ndarray:
    """IM file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    fp = io.BytesIO(data)
    if b"\n" not in fp.read(100):
        raise NotThisKind("im: not an IM file")
    fp.seek(0)
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    rawmode, n = "L", 0
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + fp.readline()
        if len(s) > 100:
            raise NotThisKind("im: a header line of more than 100 bytes")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _SPLIT.match(s)
        if not m:
            raise NotThisKind("im: a syntax error in the header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            try:
                v = tuple(_number(x) for x in v.replace("*", ",").split(","))
            except ValueError as e:
                raise ValueError(f"im: {k} is no number") from e
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in OPEN:
            v, rawmode = OPEN[v]
        info[k] = v
        if k in _TAGS:
            n += 1
    if not n:
        raise NotThisKind("im: no IM header key")
    size, mode = info["Image size (x*y)"], info["Image type"]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise NotThisKind("im: no end of header (file truncated)")
    palette = None
    if "Lut" in info:
        lut = fp.read(768)
        gray = linear = True
        for i in range(256):  # Pillow's chained test; a byte past the end: IndexError
            if i + 256 >= len(lut) or (lut[i] == lut[i + 256] and i + 512 >= len(lut)):
                raise NotThisKind("im: a palette cut by the end of the file")
            if lut[i] == lut[i + 256] == lut[i + 512]:
                if lut[i] != i:
                    linear = False
            else:
                gray = False
        if mode in ("L", "LA", "P", "PA") and not gray:
            if mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
            raw = np.frombuffer(lut, np.uint8)
            k = len(raw) // 3  # raw mode RGB;L: planes of a third of the bytes each
            palette = palette_table(np.stack([raw[:k], raw[k:2 * k], raw[2 * k:3 * k]], -1))
    # a size of one number is no tuple (Pillow's TypeError passes the file on)
    if not isinstance(size, tuple) or not mode or not (size[0] > 0 and size[1] > 0):
        raise NotThisKind(f"im: image type {mode!r}, size {size!r}")
    if len(size) != 2 or not all(isinstance(x, int) for x in size):
        raise ValueError(f"im: an image size {size} Pillow cannot make an image of")
    w, h = size
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"im: a {w}x{h} image: more pixels than Pillow opens")
    offs = fp.tell()
    if mode in ("P", "PA") and palette is None:
        palette = palette_table(np.zeros((0, 3), np.uint8))
    if rawmode.startswith("F;"):
        try:
            bits = int(rawmode[2:])
        except ValueError:
            bits = None
        if bits is not None and bits not in (8, 16, 32):
            return to_rgb(mode, _bits(data, offs, w, h, bits))
    if rawmode in ("RGB;T", "RYB;T"):  # mode RGB: three tiles, each a band
        plane = w * h
        v = np.zeros((h, w, 3), np.int64)
        for band, at in ((1, offs), (0, offs + plane), (2, offs + 2 * plane)):
            v[..., band] = unpack(data, at, w, h, "G", 0, -1)[..., 0]
        return to_rgb(mode, v)
    if not _fits(mode, rawmode):  # an unknown mode too: Pillow makes no such image
        raise ValueError(f"im: no raw mode {rawmode} for a {mode} image in Pillow")
    return to_rgb(mode, unpack(data, offs, w, h, rawmode, 0, -1), palette)


def _fits(mode: str, rawmode: str) -> bool:
    """Has Pillow an unpacker from ``rawmode`` into ``mode``?"""
    ok = {
        "1": ("1",), "L": ("L",), "P": ("P", "P;2", "P;4"), "LA": ("LA;L",), "PA": ("PA;L",),
        "RGB": ("RGB;L", "RGB", "RGBX;L"), "RGBA": ("RGBA;L",), "CMYK": ("CMYK;L",),
        "YCbCr": ("YCbCr;L",), "I": ("I;32", "I;32S"), "I;16": ("I;16",), "I;16L": ("I;16L",),
        "I;16B": ("I;16B",),
        "F": ("F;8", "F;8S", "F;16", "F;16S", "F;32", "F;32S", "F;32F"),
    }
    return rawmode in ok.get(mode, ())
