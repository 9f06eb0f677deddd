"""Pillow's raw decoder (libImaging/RawDecode.c and the unpackers of
Unpack.c it calls) for the raw modes of the legacy readers (``utils/im.py``,
``sun.py``, ``fits.py``, ``spider.py``, ``mcidas.py``, ``msp.py``,
``pixar.py``, ``xvthumb.py``, ``imt.py``, ``gbr.py``), and Pillow's
``convert("RGB")`` of the modes they give, bit for bit: the GPU machine
has no Pillow.

    unpack(data, offset, w, h, rawmode, stride=0, ystep=1) -> values
    to_rgb(mode, values, palette=None) -> uint8 [H, W, 3]
    mapped_lines(data, offset, w, h, mode, stride) -> lines or None

Values are [H, W, bands] int64 (float64 for mode F, whose samples are
float32s). A line takes (w x bits + 7) // 8 bytes; ``stride`` (0: the
line's own size) sets where the next begins, and the padding after the
last line is never read. ``ystep`` -1 fills the image bottom up. Data that
ends before the image does raises, as Pillow's ``load`` fails such a
file ("image file is truncated").

``mapped_lines`` is what ``ImageFile.load`` does in the raw decoder's
place for a file opened by its path (as the JAX package opens every image)
whose one tile is raw and whose raw mode is the image's mode, one of
``MAP_MODES``: it maps the file and reads its bytes as the whole image.
"""

from __future__ import annotations

import numpy as np

from .jpeg import cmyk_to_rgb
from .modes import f_rgb, gray_rgb, i_rgb, ycbcr_rgb

# raw mode -> (bits a pixel, bands, sample kind): "bits" MSB-first
# fields, "bits;R" LSB-first, "u8" bytes, "<u2", ">u2", "<i4", ... numpy
# dtypes, "planar" a line of one plane after another
_RAW = {
    "1": (1, 1, "bits"), "1;I": (1, 1, "bits"), "1;R": (1, 1, "bits;R"),
    "L;4": (4, 1, "bits"), "P;2": (2, 1, "bits"), "P;4": (4, 1, "bits"),
    "L": (8, 1, "u1"), "P": (8, 1, "u1"),
    "RGB": (24, 3, "u1"), "BGR": (24, 3, "u1"), "RGBX": (32, 4, "u1"), "BGRX": (32, 4, "u1"),
    "RGBA": (32, 4, "u1"), "CMYK": (32, 4, "u1"), "YCbCr": (24, 3, "u1"), "LA": (16, 2, "u1"),
    "RGB;L": (24, 3, "planar"), "RGBA;L": (32, 4, "planar"), "RGBX;L": (32, 4, "planar"),
    "CMYK;L": (32, 4, "planar"), "YCbCr;L": (24, 3, "planar"), "LA;L": (16, 2, "planar"),
    "PA;L": (16, 2, "planar"),
    "I;16": (16, 1, "<u2"), "I;16L": (16, 1, "<u2"), "I;16B": (16, 1, ">u2"),
    "I": (32, 1, "<i4"), "I;32": (32, 1, "<i4"), "I;32S": (32, 1, "<i4"),
    "I;32B": (32, 1, ">i4"),
    "F": (32, 1, "<f4"), "F;32F": (32, 1, "<f4"), "F;32BF": (32, 1, ">f4"),
    "F;8": (8, 1, "u1"), "F;8S": (8, 1, "i1"), "F;16": (16, 1, "<u2"), "F;16S": (16, 1, "<i2"),
    "F;32": (32, 1, "<u4"), "F;32S": (32, 1, "<i4"),
    "G": (8, 1, "u1"),  # one band of an RGB image, as IM's RGB3 planes are read
}


# Image._MAPMODES: the modes ImageFile.load maps, and their bytes a pixel
MAP_MODES = {"L": 1, "P": 1, "RGBX": 4, "RGBA": 4, "CMYK": 4, "I;16": 2, "I;16L": 2,
             "I;16B": 2}
_PAGE = 4096


def mapped_lines(data: bytes, offset: int, w: int, h: int, mode: str,
                 stride: int) -> np.ndarray | None:
    """ImageFile.load's map of a file opened by its path (its one raw tile
    at ``offset``, its tile arguments' ``stride``, its raw mode the image's
    ``mode``) -> the image's h lines [h, w x bytes a pixel] uint8, in the
    file's order: line y from offset + y x the stride (``Image.core.
    map_buffer``'s: the tile's, or where that is 0 or less the mode's own
    line), however few rows the tile itself covers and however short the
    stride; a line past the file reads the zeros of its last page. None
    where offset + h x the tile's stride passes the file's end (Pillow then
    runs the raw decoder, as from memory); ValueError where the offset is
    negative or the lines at map_buffer's stride pass the file's end ("buffer
    is not large enough")."""
    if offset < 0:
        raise ValueError("a negative tile offset (Pillow fails it)")
    if offset + h * stride > len(data):
        return None
    nb = w * MAP_MODES[mode]
    line = stride if stride > 0 else nb
    if offset + h * line > len(data):
        raise ValueError("the file is shorter than the image Pillow maps from it (buffer is "
                         "not large enough)")
    if not h or not w:
        return np.zeros((h, nb), np.uint8)
    end = offset + (h - 1) * line + nb
    if end > -(-len(data) // _PAGE) * _PAGE:
        raise ValueError("a mapped line past the file's last page (Pillow would read past "
                         "its map)")
    buf = np.frombuffer(data + bytes(max(end - len(data), 0)), np.uint8)
    return buf[offset + np.arange(h)[:, None] * line + np.arange(nb)]


def line_bytes(w: int, rawmode: str) -> int:
    return (w * _RAW[rawmode][0] + 7) // 8


def unpack(data: bytes, offset: int, w: int, h: int, rawmode: str, stride: int = 0,
           ystep: int = 1) -> np.ndarray:
    """RawDecode over data[offset:] -> [h, w, bands] (see the module);
    ValueError where the data ends first, or where the stride is shorter
    than a line (IMAGING_CODEC_CONFIG)."""
    bits, bands, kind = _RAW[rawmode]
    nb = (w * bits + 7) // 8
    stride = stride or nb
    if stride < nb:
        raise ValueError(f"a {stride}-byte stride for {nb}-byte lines (Pillow's raw decoder "
                         "refuses it)")
    if offset < 0:
        raise ValueError("a negative data offset")
    need = h * nb + (h - 1) * (stride - nb) if h else 0
    body = data[offset:offset + need]
    if len(body) < need:
        raise ValueError("the data ends before the image does (image file is truncated)")
    buf = np.frombuffer(body + bytes(stride - nb), np.uint8).reshape(h, stride)[:, :nb]
    if kind.startswith("bits"):
        bitrows = np.unpackbits(buf, axis=1, bitorder="little" if kind == "bits;R" else "big")
        fields = bitrows[:, :w * bits].reshape(h, w, bits).astype(np.int64)
        v = (fields << np.arange(bits - 1, -1, -1)).sum(-1)
        if rawmode == "1" or rawmode == "1;R":
            v = v * 255
        elif rawmode == "1;I":
            v = (1 - v) * 255
        elif rawmode == "L;4":
            v = v * 17
        v = v[..., None]
    elif kind == "planar":
        v = buf.reshape(h, bands, w).transpose(0, 2, 1).astype(np.int64)
    else:
        dt = np.dtype(kind)
        v = np.ascontiguousarray(buf).view(dt).reshape(h, w, -1)
        with np.errstate(invalid="ignore"):  # NaN payloads of float samples
            v = v.astype(np.float32).astype(np.float64) if rawmode.startswith("F") \
                else v.astype(np.int64)
        if rawmode in ("BGR", "BGRX"):
            v = v[..., [2, 1, 0] + ([3] if bands == 4 else [])]
    if ystep < 0:
        v = v[::-1]
    return v


def palette_table(palette) -> np.ndarray:
    """A palette as Pillow converts a P image through it -> [256, 3]
    uint8: the entries given, black past them."""
    table = np.zeros((256, 3), np.uint8)
    p = np.asarray(palette, np.uint8).reshape(-1, 3)[:256]
    table[:len(p)] = p
    return table


def to_rgb(mode: str, v: np.ndarray, palette=None) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of mode ``mode``'s values [H, W, bands]
    (palette: [256, 3] uint8 for P and PA)."""
    if mode in ("1", "L", "LA"):
        return gray_rgb(v[..., 0])
    if mode in ("P", "PA"):
        return palette[v[..., 0] & 0xFF]
    if mode in ("I", "I;16", "I;16L", "I;16B"):
        return i_rgb(v[..., 0])
    if mode == "F":
        return f_rgb(v[..., 0])
    if mode == "CMYK":
        return cmyk_to_rgb(*(v[..., k] for k in range(4)))
    if mode == "YCbCr":
        return ycbcr_rgb(v[..., 0], v[..., 1], v[..., 2])
    if mode in ("RGB", "RGBA", "RGBX"):
        return np.ascontiguousarray(v[..., :3]).astype(np.uint8)
    raise ValueError(f"mode {mode} has no conversion to RGB here")
