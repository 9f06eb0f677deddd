"""TIFF decoding in Python and numpy, as Pillow 12.1 decodes a file's first
image (``PIL.Image.open(p).convert("RGB")``), bit for bit: the GPU machine
has no Pillow.

    tiff_decode_rgb(data: bytes) -> uint8 [H, W, 3]

What it reads: the first IFD of a little- or big-endian TIFF; strips or
tiles (edge tiles cropped), chunky samples; no compression, PackBits, LZW
(libtiff's codes, most significant bit first, the width growing one code
early) or deflate (8 and 32946), each strip or tile on its own; the
horizontal predictor (2) undone per row and sample at 8 bits after LZW and
deflate, the codecs libtiff runs it for (Pillow's own decoder of
uncompressed data, and libtiff's PackBits, leave the differences as they
are); fill order 2 (bits reversed in each stored byte, before the codec). Pixels as Pillow's modes take them: bilevel
("1": 0 or 255, black where the sample is 1 under WhiteIsZero), gray of 2, 4
or 8 bits (scaled by 0x55 or 0x11, inverted under WhiteIsZero), palette of
1, 2, 4 or 8 bits (the ColorMap's 16-bit values >> 8, an index past it
black), RGB of 8 bits (with an unassociated alpha or an unspecified extra
sample, which ``convert("RGB")`` drops).

What raises ValueError: what Pillow fails (no TIFF header, no image, data
that ends before the image does, an unknown compression); and what Pillow
reads but this module does not, naming ROADMAP item 28 (BigTIFF, planar
samples, 16-bit and other sample formats, CMYK, YCbCr, LAB, JPEG, CCITT,
old-style LZW, associated alpha, orientations that swap the axes).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

ITEM = "ROADMAP item 28"
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          16: ("Q", 8)}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _refuse(what: str) -> ValueError:
    return ValueError(f"tiff: {what} is not supported (Pillow reads it; {ITEM})")


def _tags(data: bytes) -> tuple[str, dict]:
    if data[:4] == b"II*\x00":
        bo = "<"
    elif data[:4] == b"MM\x00*":
        bo = ">"
    elif data[:4] in (b"II+\x00", b"MM\x00+"):
        raise _refuse("BigTIFF")
    else:
        raise ValueError("tiff: not a TIFF file")
    (ifd,) = struct.unpack(bo + "I", data[4:8])
    if ifd + 2 > len(data):
        raise ValueError("tiff: the first IFD lies past the end of the file")
    (n,) = struct.unpack(bo + "H", data[ifd:ifd + 2])
    tags = {}
    for i in range(n):
        e = ifd + 2 + 12 * i
        if e + 12 > len(data):
            raise ValueError("tiff: the IFD runs past the end of the file")
        tag, typ, count = struct.unpack(bo + "HHI", data[e:e + 8])
        if typ not in _TYPES:
            continue
        fmt, size = _TYPES[typ]
        nbytes = size * count
        if nbytes <= 4:
            raw = data[e + 8:e + 8 + nbytes]
        else:
            (off,) = struct.unpack(bo + "I", data[e + 8:e + 12])
            raw = data[off:off + nbytes]
            if len(raw) < nbytes:
                raise ValueError(f"tiff: tag {tag}'s values run past the end of the file")
        if typ == 2:
            tags[tag] = raw
        else:
            tags[tag] = struct.unpack(bo + fmt * count, raw)
    return bo, tags


def _lzw(data: bytes, need: int) -> bytes:
    """libtiff's LZW (tif_lzw.c, new style) -> at most ``need`` bytes."""
    if data[:2] == b"\x00\x01" or (len(data) >= 2 and data[0] == 0 and data[1] & 1):
        raise _refuse("old-style LZW")
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    width, prev, acc, nacc, pos = 9, None, 0, 0, 0
    while len(out) < need:
        while nacc < width:
            if pos >= len(data):
                return bytes(out)
            acc = (acc << 8) | data[pos]
            pos += 1
            nacc += 8
        code = (acc >> (nacc - width)) & ((1 << width) - 1)
        nacc -= width
        if code == 256:  # clear
            del table[258:]
            width, prev = 9, None
            continue
        if code == 257:  # end of information
            break
        if prev is None:
            entry = table[code] if code < len(table) else None
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            entry = None
        if entry is None:
            raise ValueError("tiff: an LZW code past the table (corrupt data)")
        out += entry
        prev = entry
        if len(table) + 1 >= 1 << width and width < 12:  # one code early
            width += 1
    return bytes(out[:need])


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


def _chunk(raw: bytes, comp: int, need: int) -> bytes:
    if comp == 1:
        out = raw[:need]
    elif comp == 32773:
        out = _packbits(raw, need)
    elif comp == 5:
        out = _lzw(raw, need)
    elif comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw)[:need]
        except zlib.error as e:
            raise ValueError(f"tiff: bad deflate data ({e})") from e
    else:
        raise _refuse(f"compression {comp}")
    if len(out) < need:
        raise ValueError("tiff: a strip or tile ends before its data does")
    return out


def tiff_decode_rgb(data: bytes) -> np.ndarray:
    """TIFF file bytes -> uint8 [H, W, 3] of its first image (see the
    module); ValueError where it fails."""
    data = bytes(data)
    bo, t = _tags(data)
    if 256 not in t or 257 not in t:
        raise ValueError("tiff: missing dimensions")
    w, h = t[256][0], t[257][0]
    comp = t.get(259, (1,))[0]
    photo = t.get(262, (0,))[0]
    spp = t.get(277, (1,))[0]
    bps = t.get(258, (1,))
    extra = t.get(338, ())
    if t.get(284, (1,))[0] == 2 and spp > 1:
        raise _refuse("planar configuration 2")
    if t.get(339, (1,))[0] != 1:
        raise _refuse(f"sample format {t[339][0]}")
    if t.get(274, (1,))[0] in (5, 6, 7, 8):
        raise _refuse(f"orientation {t[274][0]}")
    if comp not in (1, 5, 8, 32773, 32946):
        raise _refuse(f"compression {comp}")
    if len(bps) == 1 and spp > 1:
        bps = bps * spp
    bits = bps[0]
    if photo == 2:
        if spp < 3 or set(bps) != {8} or len(extra) != spp - 3 or \
                any(e not in (0, 2) for e in extra):
            raise _refuse(f"RGB of {spp} samples at {bps} bits, extra samples {extra}")
    elif photo in (0, 1, 3):
        if spp != 1 or bits not in ((1, 2, 4, 8) if photo == 3 else (1, 2, 4, 8)) or extra:
            raise _refuse(f"photometric {photo} with {spp} samples at {bps} bits")
        if photo == 3 and 320 not in t:
            raise ValueError("tiff: a palette image without a ColorMap")
    else:
        raise _refuse(f"photometric interpretation {photo}")
    if 322 in t:  # tiles
        tw, th = t[322][0], t[323][0]
        offsets, counts = t.get(324, ()), t.get(325, ())
    else:
        tw, th = w, t.get(278, (h,))[0]
        offsets, counts = t.get(273, ()), t.get(279, ())
    row_bytes = (tw * spp * bits + 7) // 8
    across = -(-w // tw)
    out = np.zeros((h, row_bytes * across), np.uint8)  # rows of whole tiles
    n_chunks = across * -(-h // th)
    if len(offsets) < n_chunks:
        raise ValueError("tiff: fewer strips or tiles than the image needs")
    predictor = t.get(317, (1,))[0]
    for k in range(n_chunks):
        ty, tx = divmod(k, across)
        rows = min(th, h - ty * th) if 322 not in t else th
        need = rows * row_bytes
        off = offsets[k]
        cnt = counts[k] if k < len(counts) else len(data) - off
        raw = data[off:off + cnt]
        if comp == 1 and len(raw) < need:
            raise ValueError("tiff: the image data ends before the image does")
        if t.get(266, (1,))[0] == 2:  # libtiff reverses the stored bytes' bits
            raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        block = np.frombuffer(_chunk(raw, comp, need), np.uint8).reshape(rows, row_bytes)
        if predictor == 2 and comp in (5, 8, 32946):  # libtiff's codecs with a predictor
            if bits != 8:
                raise _refuse(f"the horizontal predictor at {bits} bits")
            block = np.cumsum(block.reshape(rows, tw, spp), axis=1, dtype=np.uint8).reshape(
                rows, row_bytes)
        elif predictor not in (1, 2):
            raise _refuse(f"predictor {predictor}")
        y0 = ty * th
        y1 = min(y0 + rows, h)
        out[y0:y1, tx * row_bytes:(tx + 1) * row_bytes] = block[:y1 - y0]
    # unpack each tile column's samples, then crop to the image
    cols = []
    for tx in range(across):
        part = out[:, tx * row_bytes:(tx + 1) * row_bytes]
        if bits == 8:
            cols.append(part.reshape(h, tw, spp))
        else:
            px = np.unpackbits(part, axis=1)[:, :tw * bits].reshape(h, tw, bits)
            cols.append((px * (1 << np.arange(bits - 1, -1, -1))).sum(-1, dtype=np.uint8)[..., None])
    img = np.concatenate(cols, axis=1)[:, :w]
    if photo == 2:
        return np.ascontiguousarray(img[..., :3])
    v = img[..., 0]
    if photo == 3:
        cmap = np.array(t[320], np.int64) // 256
        n = len(cmap) // 3
        lut = np.zeros((256, 3), np.uint8)  # entries past the map: black
        lut[:n] = np.stack([cmap[:n], cmap[n:2 * n], cmap[2 * n:3 * n]], -1)[:256]
        return lut[v]
    scale = {1: 255, 2: 0x55, 4: 0x11, 8: 1}[bits]
    v = (v * scale).astype(np.uint8)
    if photo == 0:
        v = 255 - v
    return np.repeat(v[..., None], 3, axis=-1)
