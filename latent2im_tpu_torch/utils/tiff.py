"""TIFF decoding in Python and numpy, as Pillow 12.1 decodes a file's first
image (``PIL.Image.open(p).convert("RGB")``, its TiffImagePlugin over its
libtiff 4.7), bit for bit: the GPU machine has no Pillow.

    tiff_decode_rgb(data: bytes) -> uint8 [H, W, 3]

The first IFD of a little- or big-endian TIFF or BigTIFF; the pixel layout
looked up as Pillow does (``_LAYOUTS``, its OPEN_INFO: photometric, sample
format, fill order, bits and extra samples; a single BitsPerSample repeated
for every sample, extra ones cut). Two paths, as in Pillow:

- no compression: where there is one strip or tile and its raw mode is
  the image's mode (L, P, RGBA, CMYK, I;16), the file as Pillow maps it
  opened by its path (``raw.mapped_lines``: the whole image from that
  offset, whatever the strip covers); else Pillow's own raw decoder, strip
  by strip or tile by tile from each offset (the strip byte counts not
  read; one strip covering the image reads from the last offset; fewer
  offsets than the image needs leave the rest black), each row unpacked by
  the layout's raw mode, a fill order of 2 reversing the bits of each byte
  where the layout has such a mode; planar data (configuration 2) reads each plane through
  one 8-bit band of the raw mode, whatever its bits;
- any compression: libtiff reads the IFD again itself (``_libtiff_dir``:
  every entry; of the tags it must have, a wrong type, count or value or
  one past the end fails; the strip arrays read no further than the image
  has strips; any other tag it cannot read dropped; byte counts missing
  estimated for one strip), lays out the strips or tiles from its reading
  and decodes each (PackBits, LZW new and old style, a new-style stream
  beginning with a clear code, deflate 8 and 32946, JPEG 7 through
  ``utils/jpeg.py``, CCITT 2, 3, 4 and RLEW 32771 through
  ``utils/ccitt.py``, ThunderScan 32809, LZMA 34925 through the
  liblzma of stdlib ``lzma`` (libtiff's loop, ``_lzma``), ZSTD 50000
  through ``utils/zstd.py``; where the CCITT and ThunderScan codecs
  leave part of Pillow's buffer unwritten, it keeps the chunk before's
  bytes, and the first chunk's uninitialised memory fails the file;
  old-style JPEG 6 through ``utils/ojpeg.py``; YCbCr through its RGBA
  interface, which goes on past a strip it fails to decode, keeping what
  the codec wrote over the strip before), reversing
  bits first under fill order 2,
  undoing the horizontal predictor (2) at 8, 16 and 32 bits for LZW,
  deflate, LZMA and ZSTD or the floating-point one (3), and hands Pillow
  the samples in
  native (little-endian) order, which its raw modes read as such except
  the big-endian signed and float ones (read byte-swapped, as Pillow does);
  planar data per plane.

Pixels then as Pillow's modes take them and ``convert("RGB")`` converts
them: bilevel, gray (2 and 4 bits scaled by 0x55, 0x11; WhiteIsZero
inverted, except at 16 bits), 12 and 16-bit gray and 16 and 32-bit integers
clipped to 0-255 (``modes.i_rgb``), floats as ``modes.f_rgb``, palettes
(the ColorMap's values >> 8, an index past it black), RGB and CMYK of 8
bits or the high byte of 16 (CMYK through ``jpeg.cmyk_to_rgb``), alpha
dropped, associated alpha divided out first (``modes.rgba_unpremultiplied``
on the high bytes), YCbCr of one sample as gray, of three through libjpeg's
colour conversion where JPEG-compressed and libtiff's TIFFYCbCrtoRGB (its
ReferenceBlackWhite and YCbCrCoefficients, chroma subsampling by
replication) otherwise; an uncompressed one reads 4 bytes a pixel, as
Pillow does, and fails where the data ends. Then the Orientation tag as
``ImageOps.exif_transpose`` applies it (2-8).

What raises ValueError: what Pillow fails (no TIFF header, no image, a
layout it has no mode for, data that ends before the image does, a
compression Pillow does not know, or SGILog and WEBP, which its libtiff
fails, a strip libtiff fails, a predictor at other bits); and what Pillow
reads but this module does not, naming ROADMAP item 28: LAB (Pillow
converts it with LittleCMS) and the OJPEG forms ``utils/ojpeg.py`` names.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS, cmyk_to_rgb
from .modes import f_rgb, gray_rgb, i_rgb, rgba_unpremultiplied
from .raw import MAP_MODES, mapped_lines

ITEM = "ROADMAP item 28"
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _refuse(what: str) -> ValueError:
    return ValueError(f"tiff: {what} is not supported (Pillow reads it; {ITEM})")


# TiffImagePlugin.COMPRESSION_INFO's keys: Pillow fails any other compression
# at open; of these, libtiff 4.7 fails SGILog but for photometric LogL and
# LogLuv (for which Pillow has no mode) and has no WEBP codec in Pillow 12.1
_PILLOW_COMPRESSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946, 34676, 34677, 34925,
                        50000, 50001)
_FAILED = {34676: "SGILog, which libtiff reads only as LogL or LogLuv",
           34677: "SGILog, which libtiff reads only as LogL or LogLuv",
           50001: "WEBP, which Pillow's libtiff is built without"}


# ---------------------------------------------------------------------------
# layouts (TiffImagePlugin.OPEN_INFO): (photometric, sample format, fill
# order, bits, extra samples) -> (mode, raw mode); the big-endian table is
# the little-endian one less the four marked LE only, its 16-bit and float
# raw modes big-endian
# ---------------------------------------------------------------------------

def _layouts() -> dict:
    out = {}
    for fill, r in ((1, ""), (2, "R")):
        for inv, photo in (("I", 0), ("", 1)):
            out[(photo, (1,), fill, (1,), ())] = ("1", f"1;{inv}{r}".rstrip(";"))
            out[(photo, (1,), fill, (2,), ())] = ("L", f"L;2{inv}{r}")
            out[(photo, (1,), fill, (4,), ())] = ("L", f"L;4{inv}{r}")
            out[(photo, (1,), fill, (8,), ())] = ("L", f"L;{inv}{r}".rstrip(";"))
        for bits in (1, 2, 4):
            out[(3, (1,), fill, (bits,), ())] = ("P", f"P;{bits}{r}")
        out[(3, (1,), fill, (8,), ())] = ("P", f"P;{r}".rstrip(";"))
    out[(2, (1,), 2, (8, 8, 8), ())] = ("RGB", "RGB;R")
    out[(3, (1,), 1, (8, 8), (0,))] = ("P", "PX")
    out[(3, (1,), 1, (8, 8), (2,))] = ("PA", "PA")
    out[(0, (1,), 1, (16,), ())] = ("I;16", "I;16")  # LE only
    out[(0, (3,), 1, (32,), ())] = ("F", "F;32F")
    out[(1, (1,), 1, (8, 8), (2,))] = ("LA", "LA")
    out[(1, (1,), 1, (12,), ())] = ("I;16", "I;12")  # LE only
    out[(1, (1,), 1, (16,), ())] = ("I;16", "I;16")
    out[(1, (1,), 1, (32,), ())] = ("I", "I;32N")  # LE only
    out[(1, (1,), 2, (16,), ())] = ("I;16", "I;16R")  # LE only
    out[(1, (2,), 1, (8,), ())] = ("L", "L")
    out[(1, (2,), 1, (16,), ())] = ("I", "I;16S")
    out[(1, (2,), 1, (32,), ())] = ("I", "I;32S")
    out[(1, (3,), 1, (32,), ())] = ("F", "F;32F")
    rgb = {(): ("RGBA", "RGBA"), (0,): ("RGB", "RGBX"), (1,): ("RGBA", "RGBa"),
           (2,): ("RGBA", "RGBA"), (999,): ("RGBA", "RGBA")}
    out[(2, (1,), 1, (8, 8, 8), ())] = ("RGB", "RGB")
    for extra, v in rgb.items():
        out[(2, (1,), 1, (8,) * 4, extra)] = v
        if extra != (999,):
            out[(2, (1,), 1, (16,) * 4, extra)] = (v[0], v[1] + ";16L")
            if extra:
                out[(2, (1,), 1, (8,) * 5, extra + (0,))] = (v[0], v[1] + "X")
                out[(2, (1,), 1, (8,) * 6, extra + (0, 0))] = (v[0], v[1] + "XX")
    out[(2, (1,), 1, (16, 16, 16), ())] = ("RGB", "RGB;16L")
    out[(5, (1,), 1, (8,) * 4, ())] = ("CMYK", "CMYK")
    out[(5, (1,), 1, (8,) * 5, (0,))] = ("CMYK", "CMYKX")
    out[(5, (1,), 1, (8,) * 6, (0, 0))] = ("CMYK", "CMYKXX")
    out[(5, (1,), 1, (16,) * 4, ())] = ("CMYK", "CMYK;16L")
    out[(6, (1,), 1, (8,), ())] = ("L", "L")
    out[(6, (1,), 1, (8, 8, 8), ())] = ("RGB", "RGBX")
    out[(8, (1,), 1, (8, 8, 8), ())] = ("LAB", "LAB")
    return out


_LE_LAYOUTS = _layouts()
_LE_ONLY = {(0, (1,), 1, (16,), ()), (1, (1,), 1, (12,), ()), (1, (1,), 1, (32,), ()),
            (1, (1,), 2, (16,), ())}


def _layout(bo: str, key):
    """-> (mode, raw mode) of a layout key, or None (Pillow: unknown pixel
    mode)."""
    got = _LE_LAYOUTS.get(key)
    if got is None or bo == "<":
        return got
    if key in _LE_ONLY:
        return None
    mode, raw = got
    if raw == "I;16" and key[0] == 1:
        return "I;16B", "I;16B"
    return mode, raw.replace(";16L", ";16B").replace(";16S", ";16BS").replace(
        ";32S", ";32BS").replace(";32F", ";32BF")


def _raw_bits(raw: str) -> int:
    """The bits a pixel of raw mode ``raw`` reads."""
    base = raw.split(";")[0]
    if base == "1":
        return 1
    if raw.startswith(("L;2", "P;2")):
        return 2
    if raw.startswith(("L;4", "P;4")):
        return 4
    if raw.startswith("P;1"):
        return 1
    if raw == "I;12":
        return 12
    if raw.startswith("I;16"):
        return 16
    if raw.startswith(("I;32", "F;32")):
        return 32
    wide = ";16" in raw
    return len(base) * (16 if wide else 8)


# ---------------------------------------------------------------------------
# the IFD
# ---------------------------------------------------------------------------

def _tags(data: bytes) -> tuple[str, dict]:
    """The first IFD as Pillow reads it -> (byte order, {tag: values}): the
    tags before an entry or a value cut by the end of the file (libtiff
    reads the IFD again itself: ``_libtiff_dir``)."""
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError("tiff: not a TIFF file")
    (magic,) = struct.unpack(bo + "H", data[2:4])
    big = magic == 43
    if magic not in (42, 43):
        raise ValueError("tiff: not a TIFF file")
    if big and bo == ">":
        raise ValueError("tiff: a big-endian BigTIFF (Pillow fails it)")
    if big:
        if len(data) < 16:
            raise ValueError("tiff: a short BigTIFF header")
        (ifd,) = struct.unpack(bo + "Q", data[8:16])
        cfmt, efmt, esize, slot = "Q", "HHQ", 20, 8
    else:
        (ifd,) = struct.unpack(bo + "I", data[4:8])
        cfmt, efmt, esize, slot = "H", "HHI", 12, 4
    csize = struct.calcsize(cfmt)
    tags = {}
    if ifd + csize > len(data):  # Pillow reads no tags (and fails for want of them)
        return bo, tags
    (n,) = struct.unpack(bo + cfmt, data[ifd:ifd + csize])
    for i in range(n):
        # ImageFileDirectory_v2.load: an entry, or a tag's values, that runs
        # past the end of the file ends the IFD there, keeping what came before
        e = ifd + csize + esize * i
        if e + esize > len(data):
            return bo, tags
        tag, typ, count = struct.unpack(bo + efmt, data[e:e + esize - slot])
        if typ not in _TYPES or count == 0:
            continue
        fmt, size = _TYPES[typ]
        nbytes = size * count
        if nbytes <= slot:
            raw = data[e + esize - slot:e + esize - slot + nbytes]
        else:
            (off,) = struct.unpack(bo + ("Q" if big else "I"), data[e + esize - slot:e + esize])
            raw = data[off:off + nbytes]
            if len(raw) < nbytes:
                return bo, tags
        if typ == 2:
            tags[tag] = raw
        elif typ in (5, 10):  # rationals, as libtiff's floats
            v = struct.unpack(bo + fmt * count, raw)
            tags[tag] = tuple(float(np.float32(n / d)) if d else 0.0 for n, d in zip(v[::2], v[1::2]))
        else:
            tags[tag] = struct.unpack(bo + fmt * count, raw)
    return bo, tags


# libtiff's integer readers (TIFFReadDirEntryShort, Long, ...): the types
# each takes; any other is "Incompatible type" where the tag is one libtiff
# must have
_INT_TYPES = (1, 3, 4, 6, 8, 9, 16, 17)
_OFFSET_TYPES = _INT_TYPES + (13, 18)


def _libtiff_dir(data: bytes) -> dict:
    """The first IFD as libtiff's TIFFReadDirectory reads it -> {tag:
    values}, or ValueError where it fails the file. It reads every entry
    (an entry array cut by the end of the file fails), and of the tags it
    must have it fails a wrong type, count or value and a value past the
    end (SamplesPerPixel, Compression, the dimensions, PlanarConfiguration,
    RowsPerStrip, ExtraSamples, the per-sample shorts, the strip or tile
    offsets and byte counts); any other tag it cannot read it drops (the
    ones Pillow stops at: ``_tags``), and JPEGTables it reads where Pillow
    stopped before it."""
    bo = "<" if data[:2] == b"II" else ">"
    big = struct.unpack(bo + "H", data[2:4])[0] == 43
    cfmt, efmt, esize, slot = ("Q", "HHQ", 20, 8) if big else ("H", "HHI", 12, 4)
    (ifd,) = struct.unpack(bo + ("Q" if big else "I"), data[8:16] if big else data[4:8])
    csize = struct.calcsize(cfmt)
    if ifd + csize > len(data):
        raise ValueError("tiff: the IFD's entry count past the end of the file (libtiff "
                         "fails it)")
    (n,) = struct.unpack(bo + cfmt, data[ifd:ifd + csize])
    if ifd + csize + n * esize > len(data):
        raise ValueError("tiff: an IFD cut short by the end of the file (libtiff fails it)")
    ents = {}
    for i in range(n):
        e = ifd + csize + esize * i
        tag, typ, count = struct.unpack(bo + efmt, data[e:e + esize - slot])
        ents.setdefault(tag, (typ, count, e + esize - slot))

    def ints(tag, limit=None):
        """The entry's integers (at most ``limit`` of them, from where all
        would lie), or the reason libtiff cannot read them."""
        typ, count, at = ents[tag]
        if typ not in (_OFFSET_TYPES if tag in (273, 279, 324, 325) else _INT_TYPES):
            return "type"
        fmt, size = _TYPES[typ]
        if size * count > slot:
            (at,) = struct.unpack(bo + ("Q" if big else "I"), data[at:at + slot])
        count = count if limit is None else min(count, limit)
        raw = data[at:at + size * count]
        if len(raw) < size * count:
            return "past the end"
        v = struct.unpack(bo + fmt * count, raw)
        if min(v, default=0) < 0:
            return "range"
        return v

    def need(tag, default, one=True, persample=False, limit=0xFFFF, most=None):
        if tag not in ents:
            return default
        v = ints(tag, most)
        if isinstance(v, tuple) and one and len(v) != 1:
            if not persample or len(v) < spp:
                v = "count"
            elif len(set(v[:spp])) != 1:
                v = "per-sample values"
            else:
                v = v[:1]
        if isinstance(v, tuple) and max(v, default=0) > limit:
            v = "range"
        if isinstance(v, str):
            raise ValueError(f"tiff: tag {tag}: {v} (libtiff fails it)")
        return v

    spp = need(277, (1,))[0]
    t = {tag: need(tag, None, persample=tag == 259) for tag in (259, 277, 284) if tag in ents}
    for tag in (256, 257, 322, 323, 278, 32997):  # LONGs (TIFF_SETGET_UINT32)
        if tag in ents:
            t[tag] = need(tag, None, limit=0xFFFFFFFF)
    if t.get(277) == (0,) or t.get(284, (1,))[0] not in (1, 2) or t.get(278) == (0,):
        raise ValueError("tiff: a bad SamplesPerPixel, PlanarConfiguration or RowsPerStrip "
                         "(libtiff fails it)")
    if 338 in ents:
        t[338] = need(338, (), one=False)
        if len(t[338]) > spp or any(x > 2 and x != 999 for x in t[338]):
            raise ValueError("tiff: bad ExtraSamples (libtiff fails it)")
    for tag in (258, 339, 280, 281, 32996):
        if tag in ents:
            t[tag] = need(tag, None, persample=True)
    if not 1 <= t.get(339, (1,))[0] <= 6:
        raise ValueError("tiff: a bad SampleFormat (libtiff fails it)")
    # TIFFFetchStripThing reads no more values than the image has strips
    w, h = t.get(256, (1,))[0], t.get(257, (1,))[0]
    if 322 in t or 323 in t:
        tw, th = t.get(322, (0,))[0], t.get(323, (0,))[0]
        chunks = -(-w // tw) * -(-h // th) if tw and th else 0
    else:
        chunks = -(-h // min(t.get(278, (h,))[0], h or 1))
    chunks *= spp if t.get(284, (1,))[0] == 2 else 1
    for tag in (273, 279, 324, 325):
        if tag in ents:
            t[tag] = need(tag, None, one=False, limit=1 << 64, most=chunks)
    if 256 not in t or 257 not in t:
        raise ValueError("tiff: no ImageLength (libtiff fails it)")
    for tag in (266, 317):  # FillOrder, Predictor: dropped where they cannot be read
        if tag in ents and ents[tag][0] in _INT_TYPES and ents[tag][1] == 1:
            v = ints(tag)
            if isinstance(v, tuple) and v[0] <= 0xFFFF:
                t[tag] = v
    if 347 in ents and ents[347][0] in (1, 2, 6, 7):  # JPEGTables, read where Pillow stopped
        _, count, at = ents[347]
        if count > slot:
            (at,) = struct.unpack(bo + ("Q" if big else "I"), data[at:at + slot])
        if at + count <= len(data):
            t[347] = data[at:at + count]
    return t


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

def _lzw(data: bytes, need: int, partial: bool = False) -> bytes:
    """libtiff's LZW (tif_lzw.c) -> at most ``need`` bytes: new style (codes
    most significant bit first, the width growing one code early; a first
    code other than a clear is not in the table), or old style where the
    data starts with a clear code written least significant bit first
    (LZWDecodeCompat: the width grows as the table passes it). A code past
    the table raises, or with ``partial`` ends the output there."""
    compat = len(data) >= 2 and data[0] == 0 and data[1] & 1
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    append, n = table.append, len(data)
    # the table's size at which the width grows: 2^width, or one less
    width, grow, prev, acc, nacc, pos = 9, 512 - (not compat), None, 0, 0, 0
    cleared = compat  # LZWPreDecode leaves no code to extend before a clear
    while len(out) < need:
        if nacc < width:
            if not compat and pos + 2 <= n:  # two bytes at a time: width <= 12
                acc = (acc << 16) | (data[pos] << 8) | data[pos + 1]
                pos += 2
                nacc += 16
            while nacc < width:
                if pos >= n:
                    return bytes(out)
                if compat:
                    acc |= data[pos] << nacc
                else:
                    acc = (acc << 8) | data[pos]
                pos += 1
                nacc += 8
        nacc -= width
        if compat:
            code = acc & ((1 << width) - 1)
            acc >>= width
        else:
            code = acc >> nacc
            acc &= (1 << nacc) - 1  # the bits not yet read, and no more
        if code == 256:  # clear
            del table[258:]
            width, grow, prev, cleared = 9, 512 - (not compat), None, True
            continue
        if code == 257:  # end of information
            break
        size = len(table)
        if code < size and cleared:
            entry = table[code]
            if prev is not None:
                append(prev + entry[:1])
        elif code == size and prev is not None:
            entry = prev + prev[:1]
            append(entry)
        else:
            if partial:
                break
            raise ValueError("tiff: an LZW code past the table (corrupt data)")
        out += entry
        prev = entry
        if len(table) >= grow and width < 12:
            width += 1
            grow = (1 << width) - (not compat)
    return bytes(out[:need])


# the codecs that set up libtiff's predictors
_PREDICTED = (5, 8, 32946, 34925, 50000)
_TWO_BIT = (0, 1, 0, -1)
_THREE_BIT = (0, 1, 2, 3, 0, -3, -2, -1)


def _thunder(raw: bytes, occ: int, width: int, scanline: int, buf: bytearray, hi: bytearray,
             lo: bytearray):
    """tif_thunder.c's ThunderDecodeRow into Pillow's buffer ``buf``: occ
    bytes of rows ``scanline`` apart (the image's scanline, also in a tile),
    each of ``width`` 4-bit pixels (the image's width) from its codes (a run
    of the last pixel, three 2-bit or two 3-bit deltas, a raw pixel; a run
    past the row's end writes nothing); hi, lo: per byte, whether
    its high and low nibbles are known. ValueError where a row's pixels
    are too few or too many (libtiff fails it)."""
    if occ % scanline:
        raise ValueError("tiff: ThunderScan rows of another size than the image's scanline "
                         "(libtiff fails them)")
    bp, cc = 0, len(raw)
    for row in range(occ // scanline):
        op, last, npix = row * scanline, 0, 0
        while cc > 0 and npix < width:
            n = raw[bp]
            bp += 1
            cc -= 1
            code = n & 0xC0
            if code == 0:  # a run of the last pixel, n times
                if npix & 1:
                    buf[op] |= last
                    last = buf[op]
                    op += 1
                    npix += 1
                    n -= 1
                else:
                    last |= last << 4
                npix += n
                if npix <= width:
                    while n > 0:
                        buf[op], hi[op], lo[op] = last, 1, 1
                        op += 1
                        n -= 2
                if n == -1:
                    op -= 1
                    buf[op] &= 0xF0
                    lo[op] = 1
                last &= 0xF
                continue
            if code == 0x40:  # three 2-bit deltas, each on the pixel before
                deltas = [_TWO_BIT[d] for d in ((n >> 4) & 3, (n >> 2) & 3, n & 3) if d != 2]
            elif code == 0x80:  # two 3-bit deltas
                deltas = [_THREE_BIT[d] for d in ((n >> 3) & 7, n & 7) if d != 4]
            else:  # a raw pixel
                deltas = None
            for v in ([n] if deltas is None else deltas):
                last = (v if deltas is None else last + v) & 0xF
                if npix < width:
                    if npix & 1:
                        buf[op] |= last
                        op += 1
                    else:
                        buf[op], hi[op], lo[op] = last << 4, 1, 1
                    npix += 1
        if npix != width:
            raise ValueError(f"tiff: ThunderScan row {row} of {npix} pixels where {width} "
                             "are due (libtiff fails it)")


def _packbits(data: bytes, need: int) -> bytes:
    out, pos = bytearray(), 0
    while len(out) < need and pos < len(data):
        n = data[pos]
        pos += 1
        if n < 128:
            out += data[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            out += data[pos:pos + 1] * (257 - n)
            pos += 1
    return bytes(out[:need])


class _LzmaStream(ctypes.Structure):
    """liblzma's lzma_stream (LZMA_STREAM_INIT: all zero)."""
    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t),
                ("total_in", ctypes.c_uint64), ("next_out", ctypes.c_void_p),
                ("avail_out", ctypes.c_size_t), ("total_out", ctypes.c_uint64),
                ("allocator", ctypes.c_void_p), ("internal", ctypes.c_void_p),
                ("reserved", ctypes.c_void_p * 4), ("reserved_int", ctypes.c_uint64 * 2),
                ("reserved_size", ctypes.c_size_t * 2), ("reserved_enum", ctypes.c_int * 2)]


@functools.lru_cache(maxsize=1)
def _liblzma():
    """The liblzma that stdlib ``lzma`` is built on (its extension module's
    own library, or liblzma.so.5), for libtiff's lzma_code loop: the
    module's API drops the output of a call that fails, where libtiff keeps
    it. RuntimeError where neither loads: LZMA TIFFs cannot be read then."""
    import _lzma  # stdlib lzma's extension, linked to liblzma

    for name in (_lzma.__file__, "liblzma.so.5"):
        try:
            lib = ctypes.CDLL(name)
            lib.lzma_stream_decoder.argtypes = [ctypes.POINTER(_LzmaStream), ctypes.c_uint64,
                                                ctypes.c_uint32]
        except (OSError, AttributeError):
            continue
        lib.lzma_code.argtypes = [ctypes.POINTER(_LzmaStream), ctypes.c_int]
        lib.lzma_end.argtypes = [ctypes.POINTER(_LzmaStream)]
        return lib
    raise RuntimeError("tiff: liblzma, which stdlib lzma is built on, cannot be loaded")


def _lzma(raw: bytes, need: int):
    """LZMADecode as libtiff runs it: liblzma's xz stream decoder (no flags,
    no memory limit) called until the strip's bytes are out, the stream ends
    or it reports an error, which counts only where the bytes are not all
    out (one met in a check once they are is ignored, and what follows them
    is not read) -> (the bytes written, liblzma's last return code or None
    where they are all out)."""
    lib = _liblzma()
    s = _LzmaStream()
    ret = lib.lzma_stream_decoder(ctypes.byref(s), (1 << 64) - 1, 0)
    if ret != 0:
        return b"", ret
    src = ctypes.create_string_buffer(raw, len(raw))
    dst = ctypes.create_string_buffer(max(need, 1))
    s.next_in, s.avail_in = ctypes.cast(src, ctypes.c_void_p), len(raw)
    s.next_out, s.avail_out = ctypes.cast(dst, ctypes.c_void_p), need
    try:
        while s.avail_out > 0:
            ret = lib.lzma_code(ctypes.byref(s), 0)  # LZMA_RUN
            if ret != 0:  # not LZMA_OK
                break
    finally:
        lib.lzma_end(ctypes.byref(s))
    return dst.raw[:need - s.avail_out], None if s.avail_out == 0 else ret


def _codec(raw: bytes, comp: int, need: int, partial: bool = False) -> bytes:
    """One strip's or tile's data through libtiff's codec -> ``need`` bytes;
    with ``partial``, what the codec wrote before it failed or ran out (the
    RGBA interface ignores the error)."""
    if comp == 32773:
        out = _packbits(raw, need)
    elif comp == 5:
        out = _lzw(raw, need, partial)
    elif comp in (8, 32946):
        try:  # ZIPDecode stops once it has the chunk's bytes, before the checksum
            out = zlib.decompressobj().decompress(raw, need)
        except zlib.error as e:
            if not partial:
                raise ValueError(f"tiff: bad deflate data ({e})") from e
            out, d = bytearray(), zlib.decompressobj()
            try:  # inflate writes its output as it goes: keep what came before the error
                for i in range(len(raw)):
                    out += d.decompress(raw[i:i + 1], need - len(out))
                    if len(out) >= need:
                        break
            except zlib.error:
                pass
            out = bytes(out)
    elif comp == 34925:
        out, ret = _lzma(raw, need)
        if ret is not None and not partial:
            raise ValueError(f"tiff: bad LZMA data (liblzma returns {ret} before the strip's "
                             "bytes are out)")
    elif comp == 50000:
        from .zstd import zstd_stream

        out, err = zstd_stream(raw, need)
        if err and not partial:
            raise ValueError(f"tiff: bad ZSTD data ({err})")
    else:
        raise ValueError(f"tiff: compression {comp} (Pillow fails it)")
    if len(out) < need and not partial:
        raise ValueError("tiff: a strip or tile ends before its data does")
    return out


def _unpredict(block: np.ndarray, predictor: int, bits: int, spp: int, width: int) -> np.ndarray:
    """libtiff's predictors on rows [r, row bytes] of native samples: the
    horizontal one (2) as a running sum per sample at 8, 16 or 32 bits, the
    floating-point one (3) as a running byte sum, then the byte planes
    (most significant first) back into little-endian samples."""
    rows = block.shape[0]
    if predictor == 2:
        if bits not in (8, 16, 32):
            raise ValueError(f"tiff: the horizontal predictor at {bits} bits (libtiff fails it)")
        dt = {8: np.uint8, 16: "<u2", 32: "<u4"}[bits]
        v = block.view(dt).reshape(rows, -1, spp)[:, :width]
        v = np.cumsum(v, axis=1, dtype=v.dtype)
        out = block.copy()
        out.view(dt).reshape(rows, -1, spp)[:, :width] = v
        return out
    if predictor == 3:
        if bits not in (16, 32, 64):
            raise ValueError(f"tiff: the floating-point predictor at {bits} bits")
        nb = bits // 8
        wc = width * spp
        acc = np.cumsum(block[:, :wc * nb].reshape(rows, wc * nb // spp, spp), axis=1,
                        dtype=np.uint8).reshape(rows, wc * nb)
        planes = acc.reshape(rows, nb, wc)[:, ::-1]  # most significant plane first
        out = block.copy()
        out[:, :wc * nb] = planes.transpose(0, 2, 1).reshape(rows, wc * nb)
        return out
    if predictor != 1:
        raise ValueError(f"tiff: predictor {predictor}")
    return block


# ---------------------------------------------------------------------------
# raw modes (Unpack.c) -> Pillow's mode values
# ---------------------------------------------------------------------------

def _samples(rows: np.ndarray, width: int, raw: str, order: str) -> np.ndarray:
    """Rows [r, bytes] read as ``width`` pixels of raw mode ``raw`` (its
    16/32-bit samples in byte order ``order``) -> int64 or float64
    [r, width, bands], Pillow's values of the mode."""
    r = rows.shape[0]
    if raw.endswith("R") and not raw.startswith("RGB;") or raw == "RGB;R":
        rows = _REVERSE[rows]  # fill order 2: each byte's bits reversed
        raw = raw[:-1].rstrip(";")
    bits = _raw_bits(raw)
    if bits < 8:
        px = np.unpackbits(rows, axis=1)[:, :width * bits].reshape(r, width, bits)
        v = (px.astype(np.int64) << np.arange(bits - 1, -1, -1)).sum(-1)
        if raw.startswith("1"):
            v = v * 255
            if ";I" in raw:
                v = 255 - v
        elif raw.startswith("L"):
            v = v * (255 // ((1 << bits) - 1))
            if "I" in raw[1:]:
                v = 255 - v
        return v[..., None]
    b = rows[:, :(width * bits + 7) // 8]
    if raw == "I;12":  # two pixels in three bytes, big-endian
        t = b[:, :width // 2 * 3].reshape(r, -1, 3).astype(np.int64)
        v = np.stack([(t[..., 0] << 4) | (t[..., 1] >> 4), ((t[..., 1] & 15) << 8) | t[..., 2]],
                     -1).reshape(r, -1)
        if width % 2:
            last = b[:, width // 2 * 3:width // 2 * 3 + 2].astype(np.int64)
            v = np.concatenate([v, ((last[:, :1] << 4) | (last[:, 1:] >> 4))], 1)
        return v[..., None]
    if raw.startswith(("I;16", "I;32", "F;32")):
        big = "B" in raw[4:]
        signed = raw.endswith("S")
        kind = "f" if raw.startswith("F") else ("i" if signed or raw == "I;32N" else "u")
        dt = np.dtype((">" if big else "<") + kind + str(bits // 8))
        v = np.frombuffer(b.tobytes(), dt).reshape(r, width)
        return v.astype(np.float64 if kind == "f" else np.int64)[..., None]
    wide = ";16" in raw
    bands = len(raw.split(";")[0])
    if wide:
        v = np.frombuffer(b.tobytes(), np.dtype(("<" if raw.endswith(("L", "N")) else ">") + "u2"))
        v = (v.reshape(r, width, bands) >> 8).astype(np.int64)
    else:
        v = b.reshape(r, width, bands).astype(np.int64)
    if raw.startswith("L;I"):
        v = 255 - v
    return v


def _to_rgb(mode: str, raw: str, v: np.ndarray, t: dict) -> np.ndarray:
    """Pillow's mode values [h, w, bands] -> RGB as ``convert("RGB")`` gives
    them."""
    if mode in ("1", "L", "LA"):
        return gray_rgb(v[..., 0])
    if mode in ("I;16", "I;16B", "I"):
        return i_rgb(v[..., 0])
    if mode == "F":
        return f_rgb(v[..., 0])
    if mode in ("P", "PA"):
        cmap = np.array(t[320], np.int64) // 256
        n = len(cmap) // 3
        lut = np.zeros((256, 3), np.uint8)  # entries past the map: black
        lut[:n] = np.stack([cmap[:n], cmap[n:2 * n], cmap[2 * n:3 * n]], -1)[:256]
        return lut[np.clip(v[..., 0], 0, 255)]
    if mode == "CMYK":
        return cmyk_to_rgb(*(v[..., i] for i in range(4)))
    if raw.startswith("RGBa"):
        return rgba_unpremultiplied(v[..., :4])
    return np.ascontiguousarray(v[..., :3].astype(np.uint8))


# ---------------------------------------------------------------------------
# libtiff's YCbCr -> RGB (tif_color.c, tif_getimage.c)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _ycbcr_tables(luma: tuple, ref: tuple):
    """TIFFYCbCrToRGBInit's tables (float32 arithmetic, SHIFT 16)."""
    f32 = np.float32
    one_half = 1 << 15

    def fix(x):
        return int(f32(x) * f32(65536) + f32(0.5))

    lr, lg, lb = (f32(x) for x in luma)
    f1 = f32(2) - f32(2) * lr
    d1 = fix(min(max(f1, f32(0)), f32(2)))
    f2 = lr * f1 / lg
    d2 = -fix(min(max(f2, f32(0)), f32(2)))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(min(max(f3, f32(0)), f32(2)))
    f4 = lb * f3 / lg
    d4 = -fix(min(max(f4, f32(0)), f32(2)))

    def code2v(c, rb, rw, cr):
        den = f32(rw) - f32(rb)
        return (f32(c) - f32(rb)) * f32(cr) / (den if den != 0 else f32(1))

    def clampw(x, lo, hi):
        return f32(lo) if x < lo else f32(hi) if x > hi else x

    tabs = np.zeros((5, 256), np.int64)
    for i, x in enumerate(range(-128, 128)):
        cr = int(clampw(code2v(x, f32(ref[4]) - f32(128), f32(ref[5]) - f32(128), 127), -4096, 4096))
        cb = int(clampw(code2v(x, f32(ref[2]) - f32(128), f32(ref[3]) - f32(128), 127), -4096, 4096))
        tabs[0, i] = (d1 * cr + one_half) >> 16
        tabs[1, i] = (d3 * cb + one_half) >> 16
        tabs[2, i] = d2 * cr
        tabs[3, i] = d4 * cb + one_half
        tabs[4, i] = int(clampw(code2v(x + 128, ref[0], ref[1], 255), -4096, 4096))
    return tabs


def _ycbcr_rgb(y, cb, cr, t: dict) -> np.ndarray:
    """TIFFYCbCrtoRGB on 8-bit samples."""
    luma = t.get(529, (0.299, 0.587, 0.114))
    ref = t.get(532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0))
    cr_r, cb_b, cr_g, cb_g, y_tab = _ycbcr_tables(tuple(luma), tuple(ref))
    yv = y_tab[np.minimum(y, 255)]
    r = yv + cr_r[cr]
    g = yv + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yv + cb_b[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _ycbcr_image(chunks, w: int, h: int, cw: int, ch: int, t: dict,
                 tiled: bool) -> np.ndarray:
    """libtiff's RGBA interface over YCbCr chunks (each ch rows of cw pixels
    as stored: blocks of sh x sv luma samples then Cb, Cr) -> RGB [h, w, 3],
    each block's chroma over its luma, as gtStripContig and gtTileContig
    with the putcontig8bitYCbCr put functions lay them out: a tile past
    the image's right edge skips its blocks there by (skipped pixels // sh)
    x the block size, except at 4 x 4, where libtiff counts 10 bytes a
    block in place of 18."""
    sh, sv = t.get(530, (2, 2))
    if (sh, sv) not in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)):
        raise ValueError(f"tiff: YCbCr subsampling {sh}x{sv} (libtiff fails it)")
    bx = -(-cw // sh)
    size = sh * sv + 2
    # gtStripContig reads a strip's rows (rounded up to the subsampling) x
    # its scanline size, which TIFFScanlineSize truncates to a whole byte
    scanline = bx * size // sv
    out = np.zeros((h, w, 3), np.uint8)
    across = -(-w // cw)
    for k, raw in enumerate(chunks):
        ty, tx = divmod(k, across)
        y0, x0 = ty * ch, tx * cw
        rows = min(ch, h - y0)
        npix = min(cw, w - x0)
        nby = -(-rows // sv) if not tiled else -(-ch // sv)
        if len(raw) < nby * bx * size:
            raise ValueError("tiff: a strip or tile ends before its data does")
        if not tiled:  # the bytes past what gtStripContig reads stay zero
            got = -(-rows // sv) * sv * scanline
            raw = raw[:got] + bytes(max(0, nby * bx * size - got))
        skip = (cw - npix) // sh * (10 if (sh, sv) == (4, 4) else size) if tiled else 0
        used = -(-npix // sh)
        src = np.frombuffer(raw, np.uint8)
        p = 0
        for r in range(-(-rows // sv)):
            blk = src[p:p + used * size]
            if blk.size < used * size:  # past the tile's data: libtiff's buffer
                blk = np.concatenate([blk, np.zeros(used * size - blk.size, np.uint8)])
            blk = blk.reshape(used, size).astype(np.int64)
            p += used * size + skip
            luma = blk[:, :sh * sv].reshape(used, sv, sh).transpose(1, 0, 2).reshape(sv, -1)
            cb = np.repeat(blk[:, sh * sv], sh)[None].repeat(sv, 0)
            cr = np.repeat(blk[:, sh * sv + 1], sh)[None].repeat(sv, 0)
            rgb = _ycbcr_rgb(luma, cb, cr, t)
            yy = y0 + r * sv
            hh = min(sv, y0 + rows - yy)
            out[yy:yy + hh, x0:x0 + npix] = rgb[:hh, :npix]
    return out


# ---------------------------------------------------------------------------
# the image
# ---------------------------------------------------------------------------

def _orient(img: np.ndarray, o: int) -> np.ndarray:
    """ImageOps.exif_transpose of an Orientation value."""
    if o == 2:
        return img[:, ::-1]
    if o == 3:
        return img[::-1, ::-1]
    if o == 4:
        return img[::-1]
    if o == 5:
        return img.transpose(1, 0, 2)
    if o == 6:
        return np.rot90(img, -1)
    if o == 7:
        return img[::-1, ::-1].transpose(1, 0, 2)
    if o == 8:
        return np.rot90(img, 1)
    return img


def tiff_decode_rgb(data: bytes) -> np.ndarray:
    """TIFF file bytes -> uint8 [H, W, 3] of its first image (see the
    module); ValueError where it fails."""
    data = bytes(data)
    bo, t = _tags(data)
    if 256 not in t or 257 not in t:
        raise ValueError("tiff: missing dimensions")
    w, h = t[256][0], t[257][0]
    if w < 1 or h < 1:
        raise ValueError(f"tiff: a {w}x{h} image (Pillow fails it)")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"tiff: a {w}x{h} image: more pixels than Pillow opens")
    comp = t.get(259, (1,))[0]
    photo = t.get(262, (0,))[0]
    planar = t.get(284, (1,))[0]
    fill = t.get(266, (1,))[0]
    sf = tuple(t.get(339, (1,)))
    if len(sf) > 1 and max(sf) == min(sf) == 1:
        sf = (1,)
    bps = tuple(t.get(258, (1,)))
    extra = tuple(t.get(338, ()))
    spp = t.get(277, (1,))[0]
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError("tiff: unknown data organization (Pillow fails it)")
    key = (photo, sf, fill, bps, extra)
    got = _layout(bo, key)
    if got is None:
        raise ValueError(f"tiff: no mode for photometric {photo}, sample format {sf}, fill "
                         f"order {fill}, bits {bps}, extra samples {extra} (Pillow fails it)")
    mode, raw = got
    if mode == "LAB":
        raise _refuse("LAB (photometric 8)")
    if mode in ("P", "PA") and 320 not in t:
        raise ValueError("tiff: a palette image without a ColorMap (Pillow fails it)")
    if comp not in _PILLOW_COMPRESSIONS:
        raise ValueError(f"tiff: compression {comp}, which Pillow does not know (it fails "
                         "the file)")
    if comp in (34676, 34677, 50001):
        raise ValueError(f"tiff: compression {comp} ({_FAILED[comp]}; Pillow fails it)")
    if comp == 6:  # libtiff's OJPEG codec on its own reading of the IFD
        from .ojpeg import ojpeg_decode_rgb

        lt = _libtiff_dir(data)
        img = ojpeg_decode_rgb(data, {**t, **lt}, lt[256][0], lt[257][0],
                               lt.get(324, lt.get(273, ())), lt.get(325, lt.get(279, ())),
                               _ycbcr_rgb)
        return np.ascontiguousarray(_orient(img, t.get(274, (1,))[0]))
    # Pillow's raw decoder takes strip offsets over tile offsets where the
    # IFD has both; libtiff's path lays out its own below
    tiled = (273 not in t and 324 in t) if comp == 1 else 322 in t
    if tiled:
        if (322 not in t or 323 not in t) and comp == 1:
            raise ValueError("tiff: no tile width or length (Pillow fails it)")
        tw, th = t.get(322, (1,))[0], t.get(323, (1,))[0]
        offsets, counts = t.get(324, ()), t.get(325, ())
    else:
        tw, th = w, t.get(278, (h,))[0]
        offsets, counts = t.get(273, ()), t.get(279, ())
    if tw < 1 or th < 1:
        raise ValueError(f"tiff: {tw}x{th} strips or tiles (Pillow fails them)")
    th = min(th, h) if not tiled else th
    if comp == 1:
        counted = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(extra)
        vals = _raw_path(data, w, h, tw, th, offsets, planar, bps, raw, bo, counted, mode)
        img = _to_rgb(mode, raw, vals, t)
    else:
        # Pillow's tags give the mode; libtiff lays out and decodes the
        # strips or tiles from its own reading of the IFD
        lt = _libtiff_dir(data)
        tiled = 322 in lt or 323 in lt
        lw, lh = lt[256][0], lt[257][0]
        tw, th = ((lt.get(322, (0,))[0], lt.get(323, (0,))[0]) if tiled
                  else (lw, min(lt.get(278, (lh,))[0], lh)))
        if tw < 1 or th < 1:
            raise ValueError(f"tiff: {tw}x{th} tiles (libtiff fails them)")
        planar = lt.get(284, (1,))[0]
        offsets = lt.get(324 if tiled else 273)
        if offsets is None:
            raise ValueError("tiff: no strip or tile offsets (libtiff fails it)")
        counts = lt.get(325 if tiled else 279)
        if counts is None:
            counts = _estimate_counts(data, lt, offsets, lw, lh, tw, th, planar)
        # Pillow's decoder fails where its raw mode unpacks rows of another
        # size than libtiff's samples make (a tag Pillow stopped before:
        # its own SamplesPerPixel taken as 1)
        rgba_interface = photo == 6 and len(bps) == 3 and not (comp == 7 and planar == 1)
        pillow_bits = 24 if photo == 6 and comp == 7 and planar == 1 else _raw_bits(raw)
        if planar == 1 and not rgba_interface and (
                lt.get(277, (1,))[0] * lt.get(258, (1,))[0] != pillow_bits):
            raise ValueError("tiff: Pillow's raw mode and libtiff's samples disagree on a "
                             "row's size (Pillow's decoder fails it)")
        t = {**t, **{k: lt[k] for k in (259, 266, 317, 347) if k in lt}}
        for k in (266, 317):
            if k not in lt:
                t.pop(k, None)
        img = _libtiff_path(data, t, w, h, tw, th, tiled, offsets, counts, planar, bps,
                            lt.get(259, (1,))[0], lt.get(266, (1,))[0], key, bo,
                            lt.get(338, ()))
    return np.ascontiguousarray(_orient(img, t.get(274, (1,))[0]))


# the bands Pillow has a one-band unpacker for, by mode
_PLANE_BANDS = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "L": "L", "P": "P", "1": "1",
                "I": "I", "F": "F"}


def _raw_path(data, w, h, tw, th, offsets, planar, bps, raw, bo, counted, mode):
    """Pillow's raw decoder over each strip or tile (see the module) ->
    the mode's values [h, w, bands]; counted: Pillow's count of bands,
    which divides a planar right-edge tile's stride."""
    if planar != 2 and tw == w and th == h:
        offsets = offsets[-1:]
    if len(offsets) == 1 and (raw[0] if planar == 2 else raw) == mode and mode in MAP_MODES:
        # one tile whose raw mode is the image's: opened by its path, Pillow
        # maps the file, the whole image from the tile's offset
        stride = int(tw * sum(bps) / 8 / (counted if planar == 2 else 1)) if tw > w else 0
        lines = mapped_lines(data, offsets[0], w, h, mode, stride)
        if lines is not None:
            return _samples(lines, w, "L" if planar == 2 else raw, "<" if planar == 2 else bo)
    vals = None  # fewer offsets than the image needs leave the rest black
    x = y = layer = 0
    for off in offsets:
        x1, y1 = min(x + tw, w), min(y + th, h)
        ew, eh = x1 - x, y1 - y
        if planar == 2:  # the raw mode's letter for the plane, one band's unpacker
            band = raw[layer] if layer < len(raw) else ""
            if band not in _PLANE_BANDS.get(mode, ""):
                raise ValueError(f"tiff: plane {layer} of raw mode {raw!r} (Pillow fails it)")
            bbits = {"1": 1, "I": 32, "F": 32}.get(band, 8)
            row = int(tw * sum(bps) / 8 / counted) if x + tw > w else (ew * bbits + 7) // 8
        else:
            row = int(tw * sum(bps) / 8) if x + tw > w else (ew * _raw_bits(raw) + 7) // 8
        body = data[off:off + row * eh]
        last = (ew * (bbits if planar == 2 else _raw_bits(raw)) + 7) // 8
        if len(body) < row * (eh - 1) + last:  # no padding read after the last row
            raise ValueError("tiff: the image data ends before the image does")
        rows = np.frombuffer(body + bytes(row * eh - len(body)), np.uint8).reshape(eh, row)
        if planar == 2:
            v = _samples(rows, ew, {"1": "1", "I": "I;32S", "F": "F;32F"}.get(band, "L"), "<")
            if vals is None:
                vals = np.zeros((h, w, len(_PLANE_BANDS[mode])), v.dtype)
            vals[y:y1, x:x1, layer] = v[..., 0]
        else:
            v = _samples(rows, ew, raw, bo)
            if vals is None:
                vals = np.zeros((h, w, v.shape[-1]), v.dtype)
            vals[y:y1, x:x1] = v
        x += tw
        if x >= w:
            x, y = 0, y + th
            if y >= h:
                y, layer = 0, layer + 1
    if vals is None:
        raise ValueError("tiff: no image data")
    return vals


def _estimate_counts(data, lt, offsets, w, h, tw, th, planar):
    """EstimateStripByteCounts for a compressed image without byte counts:
    libtiff takes one strip (or one a plane) only, each running over the
    file less the header, the IFD and its values stored apart, the last one
    cut at the end of the file."""
    spp = lt.get(277, (1,))[0]
    strips = -(-h // th) * (spp if planar == 2 else 1)
    if strips != (spp if planar == 2 else 1) or tw != w:
        raise ValueError("tiff: no strip byte counts for more than one strip (libtiff "
                         "fails it)")
    bo = "<" if data[:2] == b"II" else ">"
    big = struct.unpack(bo + "H", data[2:4])[0] == 43
    (ifd,) = struct.unpack(bo + ("Q" if big else "I"), data[8:16] if big else data[4:8])
    csize, esize, slot = (8, 20, 8) if big else (2, 12, 4)
    (n,) = struct.unpack(bo + ("Q" if big else "H"), data[ifd:ifd + csize])
    space = (16 + 8 + 20 * n + 8) if big else (8 + 2 + 12 * n + 4)
    for i in range(n):
        e = ifd + csize + esize * i
        typ, count = struct.unpack(bo + ("HQ" if big else "HI"), data[e + 2:e + esize - slot])
        if typ not in _TYPES and typ != 0:  # TIFFDataWidth counts type 0 a byte
            raise ValueError(f"tiff: an entry of unknown type {typ} (libtiff fails it)")
        size = _TYPES.get(typ, ("B", 1))[1] * count
        space += size if size > slot else 0
    space = (len(data) if len(data) < space else len(data) - space) // (
        spp if planar == 2 else 1)
    counts = [space] * strips
    if offsets and offsets[-1] + space > len(data):
        counts[-1] = max(len(data) - offsets[-1], 0)
    return tuple(counts)


def _libtiff_path(data, t, w, h, tw, th, tiled, offsets, counts, planar, bps, comp, fill,
                  key, bo, extra=()):
    """libtiff's decode of each strip or tile, then Pillow's raw mode over
    the native samples (see the module); ``extra``: libtiff's ExtraSamples,
    by which Pillow's decoder divides the alpha of planar RGBA out
    (unspecified or associated), whatever its own reading of the IFD."""
    if fill == 2:
        got = _layout(bo, key[:2] + (1,) + key[3:])
        if got is None:
            raise ValueError("tiff: no mode for fill order 1 (Pillow fails it)")
        mode, raw = got
    else:
        mode, raw = _layout(bo, key)
    photo = key[0]
    if raw == "I;16" or raw.endswith((";16B", ";16L")):
        raw = raw.replace(";16B", ";16N").replace(";16L", ";16N")
        if raw == "I;16":
            raw = "I;16N"
    spp = len(bps)
    if spp == 1:  # one plane: the chunky layout
        planar = 1
    if photo == 6 and spp != 3:
        raise ValueError("tiff: YCbCr of other than 3 samples (libtiff fails it)")
    bands = {"1": 1, "L": 1, "P": 1, "I": 1, "F": 1, "I;16": 1, "I;16B": 1, "LA": 2, "PA": 2,
             "RGB": 3, "RGBA": 4, "CMYK": 4}[mode]
    if planar == 2 and spp != bands:
        raise ValueError(f"tiff: {spp} planes for Pillow's {bands}-band mode {mode} "
                         "(Pillow fails it)")
    planes = spp if planar == 2 else 1
    per_plane = -(-w // tw) * -(-h // th)
    if len(offsets) < per_plane * planes:
        raise ValueError("tiff: fewer strips or tiles than the image needs")
    bits = bps[0]
    sample_bits = bits * (1 if planar == 2 else spp)
    row_bytes = (tw * sample_bits + 7) // 8
    predictor = t.get(317, (1,))[0]
    across = -(-w // tw)
    chunks = []
    rgba_interface = photo == 6 and len(bps) == 3 and not (comp == 7 and planar == 1)
    for k in range(per_plane * planes):
        ty, tx = divmod(k % per_plane, across)
        rows = th if tiled else min(th, h - ty * th)
        off = offsets[k]
        cnt = counts[k] if k < len(counts) else len(data) - off
        # TIFFFillStrip / TIFFFillTile: a count of 0 fails, one far past the
        # chunk's size is cut to 10 x it + 4096, and bytes past the file fail
        size = th * row_bytes
        if cnt > 1 << 20 and (cnt - 4096) // 10 > size:
            cnt = size * 10 + 4096
        if cnt == 0 or off + cnt > len(data):
            if rgba_interface and chunks:  # libtiff's RGBA interface goes on
                chunks.append((k, ty, tx, rows, None))
                continue
            raise ValueError(f"tiff: strip or tile {k}'s {cnt} bytes at {off} pass the end of "
                             "the file (libtiff fails it)")
        rawb = data[off:off + cnt]
        if fill == 2:  # libtiff reverses the stored bytes' bits
            rawb = _REVERSE[np.frombuffer(rawb, np.uint8)].tobytes()
        chunks.append((k, ty, tx, rows, rawb, off))
    if rgba_interface:
        if comp in (2, 3, 4, 32771):
            raise ValueError("tiff: CCITT YCbCr (libtiff fails it)")
        sh, sv = t.get(530, (2, 2))
        need = lambda rows: -(-rows // max(sv, 1)) * -(-tw // max(sh, 1)) * (sh * sv + 2)  # noqa: E731
        # gtStripContig / gtTileContig go on past a chunk libtiff fails to
        # decode: its buffer (zeroed once) keeps what the codec wrote over
        # what the chunk before left
        dec, buf = [], bytearray(max(need(c[3]) for c in chunks))
        for _, _, _, rows, r, _ in chunks:
            got = b"" if r is None else _codec(r, comp, need(rows), partial=True)
            buf[:len(got)] = got
            dec.append(bytes(buf[:need(rows)]))
        return _ycbcr_image(dec, w, h, tw, th, t, tiled)
    out = None
    # Pillow's strip or tile buffer, which the CCITT and ThunderScan codecs
    # may leave in part as the chunk before left it (uninitialised memory
    # before the first): the bits or bytes, and which of them are known
    kept = None
    if comp in (2, 3, 4, 32771):
        from .ccitt import CcittDecoder
        fax = CcittDecoder(comp, tw, t.get(292, (0,))[0], t.get(293, (0,))[0])
    elif comp == 32809 and (bits != 4 or tiled):
        raise ValueError(f"tiff: ThunderScan {'tiles' if tiled else f'at {bits} bits'} "
                         "(libtiff fails it)")
    for k, ty, tx, rows, rawb, off in chunks:
        plane = k // per_plane
        y0, x0 = ty * th, tx * tw
        hh, ww = min(rows, h - y0), min(tw, w - x0)
        if comp == 7:
            from .jpeg import jpeg_tiff_chunk
            block = jpeg_tiff_chunk(bytes(t.get(347, ())), rawb, photo == 6 and planar == 1,
                                    tw, rows, sample_bits // 8)
        elif comp in (2, 3, 4, 32771):
            if kept is None:
                kept = (np.zeros((th, tw), np.uint8), np.zeros(th, bool))
            bits_, written = fax.decode(rawb, rows, off, kept[0][:rows])
            kept[1][:rows] |= written
            if not kept[1][:hh].all():
                raise ValueError("tiff: a CCITT strip or tile ends before its rows do and the "
                                 "rows past it are Pillow's uninitialised memory")
            block = np.packbits(bits_, axis=1)
        elif comp == 32809:
            occ = rows * row_bytes
            if kept is None:
                kept = (bytearray(th * row_bytes), bytearray(th * row_bytes),
                        bytearray(th * row_bytes))
            _thunder(rawb, occ, w, (w * 4 + 7) // 8, *kept)
            known = np.frombuffer(bytes(kept[1][:occ]), np.uint8), np.frombuffer(
                bytes(kept[2][:occ]), np.uint8)
            nib = np.stack(known, -1).reshape(rows, 2 * row_bytes)[:hh, :ww]
            if not nib.all():
                raise ValueError("tiff: ThunderScan data that leaves pixels of its first "
                                 "strip or tile unwritten (Pillow's uninitialised memory)")
            block = np.frombuffer(bytes(kept[0][:occ]), np.uint8).reshape(rows, row_bytes)
        else:
            block = np.frombuffer(_codec(rawb, comp, rows * row_bytes), np.uint8).reshape(
                rows, row_bytes)
            if bo == ">" and bits in (16, 32) and not (predictor == 3 and comp in _PREDICTED):
                # libtiff swabs to native order (the floating-point predictor
                # gives native samples itself)
                block = block.reshape(rows, -1, bits // 8)[..., ::-1].reshape(rows, row_bytes)
            if comp in _PREDICTED:
                block = _unpredict(np.ascontiguousarray(block), predictor, bits,
                                   1 if planar == 2 else spp, tw)
            elif predictor not in (1, 2, 3):
                raise ValueError(f"tiff: predictor {predictor}")
        if photo == 6 and comp == 7 and planar == 1:
            v = block[:, :tw * 3].reshape(rows, tw, 3).astype(np.int64)
        elif planar == 2:
            v = _plane_samples(block, tw, bits)
        else:
            v = _samples(block, tw, raw, "<")
        if out is None:
            out = np.zeros((h, w, spp if planar == 2 else v.shape[-1]), v.dtype)
        if planar == 2:
            out[y0:y0 + hh, x0:x0 + ww, plane] = v[:hh, :ww]
        else:
            out[y0:y0 + hh, x0:x0 + ww] = v[:hh, :ww]
    if photo == 6 and comp == 7 and planar == 1:
        return out.astype(np.uint8)
    if planar == 2 and mode == "RGBA":
        raw = "RGBa" if extra and extra[0] in (0, 1) else "RGBA"
    return _to_rgb(mode, raw, out, t)


def _plane_samples(block: np.ndarray, width: int, bits: int) -> np.ndarray:
    """One plane's native samples [rows, width] as its band of the raw mode
    takes them: 8 bits, or the high byte of 16 (the layouts of more than
    one sample have no others)."""
    if bits == 8:
        return block[:, :width].astype(np.int64)
    return (np.frombuffer(block[:, :2 * width].tobytes(), "<u2").reshape(-1, width) >> 8
            ).astype(np.int64)
