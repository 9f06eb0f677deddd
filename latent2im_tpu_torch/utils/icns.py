"""ICNS decoding, as Pillow 12.1 reads a Mac OS icon file
(``PIL.Image.open(p).convert("RGB")``, its IcnsImagePlugin), bit for bit:
the GPU machine has no Pillow.

    icns_decode_rgb(data: bytes, host_cpp: bool = False) -> uint8 [H, W, 3]

The file's blocks (type, length) from the header's file size on, a later
block of a type replacing an earlier one; the largest (width, height,
scale) of the plugin's table whose types the file holds; then every reader
of that size, in the table's order:

- PNG and JPEG 2000 members (``ic07``-``ic14``, ``icp4``-``icp6``): a PNG
  read from the member's start through ``png_decode_rgb`` (the PNG may run
  past its block, as Pillow reads it from the file), a J2K or JP2 member of
  the block's bytes through ``utils/jpeg2000.py`` (``host_cpp``: its tier-1
  in the host C++); such a member is the image;
- RGB members (``is32``, ``il32``, ``ih32``, ``it32`` after its four zero
  bytes): three raw planes where the block holds exactly w x h x 3 bytes,
  else each plane run-length coded (a byte with bit 7 set repeats the next
  byte (it - 125) times, else copies it + 1 bytes), read on past the block
  where a plane needs it, each plane's count met exactly;
- masks (``s8mk`` ...): w x h bytes, read and dropped by the convert.

What fails (ValueError, as Pillow fails): a member of another signature, a
plane whose runs overrun or come short, a block cut by the end of the file,
a member whose size is none of the file's, what the PNG or JPEG 2000 reader
fails; a file with no block Pillow reads is not taken as ICNS
(``NotThisKind``), as Pillow moves on to the next format.
"""

from __future__ import annotations

import struct

import numpy as np

from .modes import NotThisKind

# (width, height, scale) -> [(type, reader)], in the plugin's order
_SIZES = {
    (512, 512, 2): [(b"ic10", "png")], (512, 512, 1): [(b"ic09", "png")],
    (256, 256, 2): [(b"ic14", "png")], (256, 256, 1): [(b"ic08", "png")],
    (128, 128, 2): [(b"ic13", "png")],
    (128, 128, 1): [(b"ic07", "png"), (b"it32", "32t"), (b"t8mk", "mk")],
    (64, 64, 1): [(b"icp6", "png")], (32, 32, 2): [(b"ic12", "png")],
    (48, 48, 1): [(b"ih32", "32"), (b"h8mk", "mk")],
    (32, 32, 1): [(b"icp5", "png"), (b"il32", "32"), (b"l8mk", "mk")],
    (16, 16, 2): [(b"ic11", "png")],
    (16, 16, 1): [(b"icp4", "png"), (b"is32", "32"), (b"s8mk", "mk")],
}


def accepts(prefix: bytes) -> bool:
    return prefix[:4] == b"icns"


def _blocks(data: bytes) -> dict:
    """IcnsFile.__init__: {type: (start, length)}."""
    if len(data) < 8:
        raise NotThisKind("icns: a short header")
    _, filesize = struct.unpack(">4sI", data[:8])
    dct, i = {}, 8
    while i < filesize:
        if i + 8 > len(data):
            raise NotThisKind("icns: a block header past the end of the file")
        sig, size = struct.unpack(">4sI", data[i:i + 8])
        if size <= 0:
            raise NotThisKind("icns: an invalid block header")
        dct[sig] = (i + 8, size - 8)
        i += size
    return dct


def _rgb32(data: bytes, start: int, length: int, w: int, h: int) -> np.ndarray:
    n = w * h
    if length == n * 3:
        body = data[start:start + length]
        if len(body) < length:
            raise ValueError("icns: not enough image data")
        return np.frombuffer(body, np.uint8).reshape(h, w, 3)
    planes, at = [], start
    for _ in range(3):
        out, left = bytearray(), n
        while left > 0:
            if at >= len(data):
                break
            b = data[at]
            at += 1
            if b & 0x80:
                size = b - 125
                out += data[at:at + 1] * size
                at += 1
            else:
                size = b + 1
                out += data[at:at + size]
                at += size
            left -= size
        if left != 0:
            raise ValueError(f"icns: error reading a channel ({left} left)")
        if len(out) < n:
            raise ValueError("icns: not enough image data")
        planes.append(np.frombuffer(bytes(out[:n]), np.uint8).reshape(h, w))
    return np.stack(planes, -1)


def _member(data: bytes, start: int, length: int, host_cpp: bool) -> np.ndarray:
    from .image import _PNG_SIGNATURE, png_decode_rgb
    from .jpeg2000 import jpeg2000_decode_rgb

    sig = data[start:start + 12]
    if sig[:8] == _PNG_SIGNATURE:
        return png_decode_rgb(data[start:])
    if sig[:4] in (b"\xff\x4f\xff\x51", b"\r\n\x87\n") or sig == b"\0\0\0\x0cjP  \r\n\x87\n":
        return jpeg2000_decode_rgb(data[start:start + length], host_cpp=host_cpp)
    raise ValueError("icns: an unsupported icon subimage format")


def icns_decode_rgb(data: bytes, host_cpp: bool = False) -> np.ndarray:
    """ICNS file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    if not accepts(data):
        raise ValueError("icns: not an ICNS file")
    dct = _blocks(data)
    sizes = [s for s, fmts in _SIZES.items() if any(f in dct for f, _ in fmts)]
    if not sizes:
        raise NotThisKind("icns: no 32-bit icon resources")
    best = max(sizes)
    w, h = best[0] * best[2], best[1] * best[2]
    image = rgb = None
    for code, kind in _SIZES[best]:
        if code not in dct:
            continue
        start, length = dct[code]
        if kind == "png":
            image = _member(data, start, length, host_cpp)
        elif kind == "32t":
            if data[start:start + 4] != b"\0\0\0\0":
                raise ValueError("icns: an it32 block without its zero signature")
            rgb = _rgb32(data, start + 4, length - 4, w, h)
        elif kind == "32":
            rgb = _rgb32(data, start, length, w, h)
        elif len(data[start:start + w * h]) < w * h:
            raise ValueError("icns: a mask cut short")
    if image is None:
        if rgb is None:
            raise ValueError("icns: a mask with no image")
        image = rgb
    ih, iw = image.shape[:2]
    # IcnsImageFile.size's setter: the image's size must be one of the file's
    for s in sizes:
        sw, sh = s[0] * s[2], s[1] * s[2]
        if iw and ih and sh / ih == sw // iw:
            return np.ascontiguousarray(image)
    raise ValueError(f"icns: a {iw}x{ih} member, none of the file's sizes")
