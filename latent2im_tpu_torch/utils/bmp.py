"""BMP decoding in Python and numpy, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``), bit for bit: the GPU machine has no
Pillow.

    bmp_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As BmpImagePlugin reads it: the file header's pixel-data offset (moved past
the colour table where it points right after the header, as Pillow does);
the OS/2 v1 header (12 bytes: 16-bit sizes, 3-byte table entries) or the
Windows headers of 40 to 124 bytes (a negative height: rows top down);
1, 4 and 8 bits through the colour table (a table that is black and white,
or the identity grayscale, counts as none: "1" or "L"), 16 bits as 5-5-5,
24 as BGR, 32 as BGRX; ``BI_BITFIELDS`` with the masks Pillow knows (16-bit
5-6-5 and 5-5-5, 24-bit BGR, and its eight 32-bit layouts; an alpha mask
makes RGBA, whose alpha ``convert("RGB")`` drops); RLE8 and RLE4 through
Pillow's own decoder, its quirks included (a delta reads two bytes more than
its own, an odd RLE4 literal run loses its last pixel, literal runs align
to an even position in the file). Each row is the stride of
((width x bits + 31) >> 3) & ~3 bytes; a 5-bit or 6-bit channel scales as
v x 255 // 31 or v x 255 // 63; a colour index past the table is black.

A file is read as Pillow reads it opened by its path (as the JAX package
opens every image): where its raw mode is the image's mode (L, P, RGBA),
Pillow maps the file (``raw.mapped_lines``), which reads rows of any
stride, 4-bit rows read as L among them; an icon's or cursor's bitmap,
which Pillow reads from memory, is decoded.

What fails (ValueError, as Pillow fails): no "BM", another header size, bit
depth, compression or bitfields layout, a colour table of more than 65536
entries, pixel data that ends before the image does.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .raw import mapped_lines

_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW_MODES = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}
# the bytes of a row of w pixels each unpacker reads
_ROW_BYTES = {"P;1": lambda w: (w + 7) // 8, "1": lambda w: (w + 7) // 8,
              "P;4": lambda w: (w + 1) // 2, "P": lambda w: w, "L": lambda w: w,
              "BGR;15": lambda w: 2 * w, "BGR;16": lambda w: 2 * w, "BGR": lambda w: 3 * w}


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool) -> bytes:
    """BmpImagePlugin.BmpRleDecoder from file position pos -> the indices
    it makes (at most a little past w x h)."""
    out = bytearray()
    x, need = 0, w * h
    while len(out) < need:
        if pos + 2 > len(data):
            break
        n, b = data[pos], data[pos + 1]
        pos += 2
        if n:  # encoded: n pixels of b (RLE4: its two nibbles in turn)
            n = max(0, w - x) if x + n > w else n
            if rle4:
                out += bytes([b >> 4, b & 15] * (n // 2) + [b >> 4] * (n % 2))
            else:
                out += bytes([b]) * n
            x += n
        elif b == 0:  # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif b == 1:  # end of bitmap
            break
        elif b == 2:  # delta: Pillow reads two bytes, then its offsets from the next two
            if pos + 2 > len(data):
                break
            pos += 2
            if pos + 2 > len(data):
                raise ValueError("bmp: an RLE delta runs past the end of the file")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # absolute: b literal pixels (RLE4: b // 2 bytes of two)
            count = b // 2 if rle4 else b
            lit = data[pos:pos + count]
            pos += len(lit)
            if rle4:
                out += bytes(v for c in lit for v in (c >> 4, c & 15))
            else:
                out += lit
            if len(lit) < count:
                break
            x += b
            pos += pos % 2  # to an even position in the file
    return bytes(out)


def _unpack(rows: np.ndarray, w: int, raw: str) -> np.ndarray:
    """Rows [h, stride] uint8 -> [h, w] indices or [h, w, 3] RGB as Pillow's
    unpacker ``raw`` gives them."""
    h = rows.shape[0]
    if raw in ("P;1", "1"):
        return np.unpackbits(rows, axis=1)[:, :w]
    if raw == "P;4":
        return np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
    if raw in ("P", "L"):
        return rows[:, :w]
    if raw in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * w].astype(np.uint16).reshape(h, w, 2)
        v = v[..., 0] | (v[..., 1] << 8)
        if raw == "BGR;15":
            r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
            gmax = 31
        else:
            r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
            gmax = 63
        return np.stack([r * 255 // 31, g * 255 // gmax, b * 255 // 31], -1).astype(np.uint8)
    size = 3 if raw == "BGR" else 4
    px = rows[:, :size * w].reshape(h, w, size)
    return px[..., [raw.index(c) for c in "RGB"]]


def bmp_decode_rgb(data: bytes) -> np.ndarray:
    """BMP file bytes -> uint8 [H, W, 3] (see the module); ValueError where
    Pillow fails."""
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError("bmp: not a BMP file")
    return dib_decode_rgb(data, 14, struct.unpack("<I", data[10:14])[0])


def dib_decode_rgb(data: bytes, at: int, offset=None, halve: bool = False) -> np.ndarray:
    """The bitmap whose info header starts at data[at] -> uint8 [H, W, 3],
    as BmpImageFile._bitmap reads it: offset, the pixel data's position (a
    BMP file header's), or None where it follows the header, its bitfield
    masks and its colour table (a DIB, as in ICO and CUR files); halve: an
    icon's or cursor's bitmap, whose header gives twice the height of its
    colour rows (the rows of its AND mask follow)."""
    hsize = struct.unpack("<I", data[at:at + 4])[0] if at + 4 <= len(data) else 0
    hdr = data[at + 4:at + hsize]
    if len(hdr) < hsize - 4 or hsize < 4:
        raise ValueError("bmp: the header runs past the end of the file")
    masks, tail = None, at + hsize  # tail: what the header reads up to
    if hsize == 12:  # OS/2 v1, BITMAPCOREHEADER
        w, h, _, bits = struct.unpack("<HHHH", hdr[:8])
        comp, colors, pad, direction = 0, 0, 3, -1
    elif hsize in (40, 52, 56, 64, 108, 124):
        y_flip = hdr[7] == 0xFF
        w = struct.unpack("<I", hdr[0:4])[0]
        h = struct.unpack("<I", hdr[4:8])[0]
        h = 2 ** 32 - h if y_flip else h
        direction = 1 if y_flip else -1
        bits, comp = struct.unpack("<HI", hdr[10:16])
        colors = struct.unpack("<I", hdr[28:32])[0]
        pad = 4
        if comp == 3:  # BI_BITFIELDS
            if len(hdr) >= 48:
                m = struct.unpack("<III", hdr[36:48])
                a = struct.unpack("<I", hdr[48:52])[0] if len(hdr) >= 52 else 0
            else:  # a 40-byte header: three masks after it
                if tail + 12 > len(data):
                    raise ValueError("bmp: the bitfield masks run past the end of the file")
                m = struct.unpack("<III", data[tail:tail + 12])
                a = 0
                tail += 12
            masks = (m, m + (a,))
    else:
        raise ValueError(f"bmp: unsupported header size {hsize}")
    colors = colors or (1 << bits)
    if offset is not None and offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"bmp: a {w}x{h} bitmap: more pixels than Pillow opens")
    if halve:
        h //= 2
    if bits not in _RAW_MODES:
        raise ValueError(f"bmp: unsupported bit depth {bits}")
    raw, rle = _RAW_MODES[bits], None
    if comp == 3:
        if bits == 32 and masks[1] in [k[1] for k in _MASK_MODES if k[0] == 32]:
            raw = _MASK_MODES[(32, masks[1])]
        elif bits in (24, 16) and (bits, masks[0]) in _MASK_MODES:
            raw = _MASK_MODES[(bits, masks[0])]
        else:
            raise ValueError("bmp: unsupported bitfields layout")
    elif comp in (1, 2):
        rle = comp == 2
    elif comp != 0:
        raise ValueError(f"bmp: unsupported compression {comp}")
    table = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise ValueError(f"bmp: unsupported colour table size {colors}")
        pal = data[tail:tail + pad * colors]  # read where the header ends
        tail += len(pal)
        gray = (0, 255) if colors == 2 else range(colors)
        if all(pal[i * pad:i * pad + 3] == bytes([v]) * 3 for i, v in enumerate(gray)):
            raw = "1" if colors == 2 else "L"  # Pillow unpacks the rows so whatever the depth
        else:
            n = len(pal) // pad
            table = np.zeros((256, 3), np.uint8)  # entries past the table: black
            ent = np.frombuffer(pal[:n * pad], np.uint8).reshape(n, pad)[:256, 2::-1]
            table[:len(ent)] = ent
    if rle is not None:
        if bits not in (4, 8):
            raise ValueError("bmp: an RLE image that is not 4 or 8 bits")
        idx = np.frombuffer(_rle(data, tail if offset is None else offset, w, h, rle), np.uint8)
        if idx.size < w * h:
            raise ValueError("bmp: not enough RLE image data")
        img = idx[:w * h].reshape(h, w)
    else:
        offset = tail if offset is None else offset
        stride = ((w * bits + 31) >> 3) & ~3
        lines = None
        if not halve and raw in ("L", "P", "RGBA"):  # the raw mode is the image's mode:
            lines = mapped_lines(data, offset, w, h, raw, stride)  # opened by its path,
        if lines is not None:  # Pillow maps the file
            img = _unpack(lines, w, raw)
        else:
            if _ROW_BYTES.get(raw, lambda w: 4 * w)(w) > stride:  # the raw decoder refuses it
                raise ValueError(f"bmp: {bits}-bit rows read as {raw!r}: Pillow fails them")
            body = data[offset:offset + stride * h]
            # Pillow's raw decoder reads no padding after the last row
            if len(body) < stride * (h - 1) + _ROW_BYTES.get(raw, lambda w: 4 * w)(w):
                raise ValueError("bmp: the pixel data ends before the image does")
            body += bytes(stride * h - len(body))
            img = _unpack(np.frombuffer(body, np.uint8).reshape(h, stride), w, raw)
    if direction == -1:
        img = img[::-1]
    if img.ndim == 3:
        return np.ascontiguousarray(img)
    if raw == "1":
        img = img * 255
    if table is not None:
        return table[img]
    return np.repeat(img[..., None], 3, axis=-1).astype(np.uint8)
