"""BLP and FTEX textures in numpy, as Pillow 12.1 reads them
(``PIL.Image.open(p).convert("RGB")``, its BlpImagePlugin and
FtexImagePlugin), bit for bit: the GPU machine has no Pillow.

    blp_decode_rgb(data: bytes) -> uint8 [H, W, 3]
    ftex_decode_rgb(data: bytes) -> uint8 [H, W, 3]

BLP1 and BLP2 as the plugin reads them: the header (BLP1: compression,
alpha flag, size, encoding; BLP2: compression, encoding, alpha flag, alpha
encoding, size), 16 mip offsets and 16 lengths, then only the top mip:

- BLP1 JPEG (compression 0): the shared JPEG header plus the mip's bytes,
  decoded by ``utils/jpeg.py`` as Pillow decodes any JPEG, laid into the BLP's size as Pillow's raw "BGR" rows, so red and blue
  swap;
- palette (BLP1 compression 1 with encoding 4 or 5, BLP2 compression 1
  encoding 1): 256 BGRA entries, then each index byte of the mip's length
  looked up (BLP1 reads the indices just after the palette, not at the
  mip's offset), whatever the alpha depth;
- BLP2 DXT (encoding 2, alpha encoding 0, 1 or 7): the plugin's own Python
  decode_dxt1/3/5, RGB565 widened by shifts alone (no bit replication), a
  row of blocks at a time; RGBA (DXT3, DXT5, and DXT1 with alpha) or RGB
  pixels 4 x ceil(w/4) a row, which Pillow's raw decoder then reads w a
  row (an image of a width not a multiple of 4 is sheared, as there).

FTEX: format 0 is BC1 (``utils/bcn.py``), format 1 raw RGB, from the
mipmap the format entry points at.

What fails (ValueError, as Pillow fails): a file cut inside the header,
the offset tables, the palette or the data, an index past the palette,
the raw BGRA encoding (3) and any other the plugin does not decode, fewer
pixels than the image needs, more pixels than Pillow opens.
"""

from __future__ import annotations

import struct

import numpy as np

from .bcn import bc1_color, bc3_alpha, bcn_decode
from .jpeg import PILLOW_MAX_PIXELS, jpeg_decode_rgb


def _cut(what: str) -> ValueError:
    return ValueError(f"blp: the file ends inside {what} (Pillow: Truncated File Read)")


def _read(data: bytes, at: int, n: int, what: str) -> bytes:
    """ImageFile._safe_read: n bytes, or fail."""
    if n <= 0:
        return b""
    got = data[at:at + n]
    if len(got) < n:
        raise _cut(what)
    return got


def _raw_rgb(flat: bytes, w: int, h: int, bpp: int, order=slice(None)) -> np.ndarray:
    """set_as_raw: the bytes read as rows of w pixels of bpp bytes."""
    if len(flat) < w * h * bpp:
        raise ValueError("blp: not enough image data")
    return np.frombuffer(flat, np.uint8, w * h * bpp).reshape(h, w, bpp)[..., :3][..., order]


def _palette(data: bytes, at: int) -> np.ndarray:
    return np.frombuffer(_read(data, at, 1024, "the palette"), np.uint8).reshape(256, 4)


def _indexed(data: bytes, at: int, n: int, pal: np.ndarray, alpha: bool, w: int, h: int):
    idx = np.frombuffer(_read(data, at, n, "the image data"), np.uint8)
    rgb = pal[idx][:, [2, 1, 0, 3] if alpha else [2, 1, 0]]
    return _raw_rgb(rgb.tobytes(), w, h, 4 if alpha else 3)


def _dxt(data: bytes, at: int, w: int, h: int, kind: int, alpha: bool) -> np.ndarray:
    """decode_dxt1/3/5 a row of blocks at a time -> the pixel bytes."""
    size = 8 if kind == 0 else 16
    bw, bh = -(-w // 4), -(-h // 4)
    line = bw * size
    rows = []
    for yb in range(bh):
        b = np.frombuffer(_read(data, at + yb * line, line, "the DXT data"), np.uint8)
        rows.append(b.reshape(bw, size))
    blocks = np.concatenate(rows) if rows else np.zeros((0, size), np.uint8)
    if kind == 0:
        px = bc1_color(blocks, False, replicate=False)
    else:
        px = bc1_color(blocks[:, 8:], True, replicate=False)
        if kind == 1:
            a = blocks[:, :8].astype(np.int64)
            px[..., 3] = np.stack([a & 0xF, a >> 4], -1).reshape(-1, 16) * 17
        else:
            px[..., 3] = bc3_alpha(blocks[:, :8], False)
    bpp = 4 if kind != 0 or alpha else 3
    img = px[..., :bpp].reshape(bh, bw, 4, 4, bpp).transpose(0, 2, 1, 3, 4)
    return _raw_rgb(img.astype(np.uint8).tobytes(), w, h, 4 if alpha else 3)


def blp_decode_rgb(data: bytes) -> np.ndarray:
    """BLP file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    magic = data[:4]
    if magic not in (b"BLP1", b"BLP2"):
        raise ValueError("blp: not a BLP file")
    hdr = _read(data, 0, 28 if magic == b"BLP1" else 20, "the header")
    if magic == b"BLP1":
        comp, alpha, w, h, enc = struct.unpack("<iIIIi", hdr[4:24])
        alpha, offset = alpha != 0, 28
    else:
        comp, enc, alpha, aenc = struct.unpack("<ibbb", hdr[4:11])
        w, h = struct.unpack("<II", hdr[12:20])
        alpha, offset = alpha != 0, 20
    if not w or not h:  # ImageFile: no such image, Pillow identifies no file
        raise ValueError(f"blp: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"blp: a {w}x{h} image: more pixels than Pillow opens")
    tables = struct.unpack("<32I", _read(data, offset, 128, "the mip tables"))
    off0, len0, at = tables[0], tables[16], offset + 128
    if magic == b"BLP1":
        if comp == 0:
            (n,) = struct.unpack("<I", _read(data, at, 4, "the JPEG header size"))
            head = _read(data, at + 4, n, "the JPEG header")
            at += 4 + n
            at += len(_read(data, at, off0 - at, "the JPEG data"))
            body = _read(data, at, len0, "the JPEG data")
            img = jpeg_decode_rgb(head + body)
            if img.shape[0] * img.shape[1] > PILLOW_MAX_PIXELS:
                raise ValueError("blp: a JPEG of more pixels than Pillow opens")
            return _raw_rgb(img.tobytes(), w, h, 3, slice(None, None, -1))
        if comp != 1 or enc not in (4, 5):
            raise ValueError(f"blp: BLP1 compression {comp}, encoding {enc} (Pillow has no "
                             "decoder for it)")
        return _indexed(data, at + 1024, len0, _palette(data, at), alpha, w, h)
    pal = _palette(data, at)
    if comp != 1:
        raise ValueError(f"blp: BLP2 compression {comp} (Pillow has no decoder for it)")
    if enc == 1:
        return _indexed(data, off0, len0, pal, alpha, w, h)
    if enc == 2 and aenc in (0, 1, 7):
        return _dxt(data, off0, w, h, {0: 0, 1: 1, 7: 2}[aenc], alpha)
    raise ValueError(f"blp: BLP2 encoding {enc}, alpha encoding {aenc} (Pillow has no "
                     "decoder for it)")


def ftex_decode_rgb(data: bytes) -> np.ndarray:
    """FTEX file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    if data[:4] != b"FTEX" or len(data) < 32:
        raise ValueError("ftex: not an FTEX file, or its header is cut short")
    w, h, _, nformats, fmt, where = struct.unpack("<6i", data[8:32])
    if where < 0:
        raise ValueError("ftex: a negative mipmap offset")
    if nformats != 1:
        raise ValueError(f"ftex: {nformats} formats (Pillow reads one)")
    if w <= 0 or h <= 0 or w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"ftex: a {w}x{h} image")
    if len(data[where:where + 4]) < 4:
        raise ValueError("ftex: the mipmap size past the end of the file")
    (size,) = struct.unpack("<i", data[where:where + 4])
    body = data[where + 4:where + 4 + size] if size >= 0 else data[where + 4:]  # read(-n): all
    if fmt == 0:
        return np.ascontiguousarray(bcn_decode(body, w, h, 1)[..., :3])
    if fmt == 1:
        if len(body) < w * h * 3:
            raise ValueError("ftex: the data ends before the image does")
        return np.frombuffer(body, np.uint8, w * h * 3).reshape(h, w, 3).copy()
    raise ValueError(f"ftex: texture format {fmt}")
