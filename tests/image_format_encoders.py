"""Small GIF, BMP and TIFF writers for the tests: the forms Pillow cannot
write or writes one way only (a GIF's local colour table, interlace, a
frame off the canvas; RLE4 and RLE8 BMP, OS/2 headers, bitfields, top-down
rows; TIFF tiles, big-endian files, the horizontal predictor, fill order 2,
2- and 4-bit gray, WhiteIsZero). Each returns the file's bytes."""

from __future__ import annotations

import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

def gif_lzw(idx, min_bits: int) -> bytes:
    """GIF LZW of the indices: a clear code first, the table reset when full."""
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    table = {bytes([i]): i for i in range(clear)}
    nxt, size, codes, w = end + 1, min_bits + 1, [(clear, min_bits + 1)], b""
    for px in bytes(idx):
        wc = w + bytes([px])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], size))
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
            if nxt - 1 == (1 << size) and size < 12:
                size += 1
        else:
            codes.append((clear, size))
            table = {bytes([i]): i for i in range(clear)}
            nxt, size = end + 1, min_bits + 1
        w = bytes([px])
    if w:
        codes.append((table[w], size))
    codes.append((end, size))
    acc = n = 0
    out = bytearray()
    for c, s in codes:
        acc |= c << n
        n += s
        while n >= 8:
            out.append(acc & 255)
            acc >>= 8
            n -= 8
    if n:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        out.append(len(data[i:i + 255]))
        out += data[i:i + 255]
    return bytes(out) + b"\x00"


def _table(pal):
    n = len(pal)
    bits = max(1, (n - 1).bit_length())
    full = np.zeros((1 << bits, 3), np.uint8)
    full[:n] = pal
    return bits, full.tobytes()


def gif(screen, idx, gpal=None, lpal=None, pos=(0, 0), interlace=False, trns=None,
        min_bits=8, cut=None) -> bytes:
    """One frame of indices idx [h, w] at pos on a screen (w, h)."""
    w, h = screen
    flags, gtab = 0, b""
    if gpal is not None:
        bits, gtab = _table(gpal)
        flags = 0x80 | (bits - 1)
    out = b"GIF89a" + struct.pack("<HHBBB", w, h, flags, 0, 0) + gtab
    if trns is not None:
        out += b"\x21\xf9\x04\x01\x00\x00" + bytes([trns]) + b"\x00"
    idx = np.asarray(idx, np.uint8)
    fh, fw = idx.shape
    lflags, ltab = 0, b""
    if lpal is not None:
        bits, ltab = _table(lpal)
        lflags = 0x80 | (bits - 1)
    rows = idx
    if interlace:
        lflags |= 0x40
        rows = idx[np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                   np.arange(2, fh, 4), np.arange(1, fh, 2)])]
    data = gif_lzw(rows.ravel(), min_bits)
    if cut is not None:
        data = data[:cut]
    out += b"\x2c" + struct.pack("<HHHHB", pos[0], pos[1], fw, fh, lflags) + ltab
    return out + bytes([min_bits]) + _sub_blocks(data) + b"\x3b"


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

def bmp_rows(vals, bits: int, w: int) -> bytes:
    """Samples [h, w] (or bytes [h, n] at 8 bits) -> rows padded to 4 bytes."""
    vals = np.asarray(vals)
    h = vals.shape[0]
    stride = ((w * bits + 31) >> 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    if bits < 8:
        per = 8 // bits
        padded = np.zeros((h, -(-w // per) * per), np.int64)
        padded[:, :w] = vals
        packed = np.zeros((h, padded.shape[1] // per), np.int64)
        for k in range(per):
            packed |= padded[:, k::per] << (8 - bits * (k + 1))
        out[:, :packed.shape[1]] = packed
    else:
        raw = vals.astype(np.uint8).reshape(h, -1)
        out[:, :raw.shape[1]] = raw
    return out.tobytes()


def bmp_rle(v, rle4: bool, seed: int = 0, delta_after_row=None) -> bytes:
    """RLE8 / RLE4 of indices v [h, w], bottom row first as stored: runs,
    literal runs of odd and even length (padded to 16 bits), an end of
    line after each row, a delta (as Pillow reads it: two bytes, then the
    offsets) after one row, the end of the bitmap."""
    rng = np.random.RandomState(seed)
    out = bytearray()
    h, w = v.shape
    for y in range(h):
        row, x = [int(c) for c in v[y]], 0
        while x < w:
            if rng.rand() < 0.4 and w - x >= 3:
                n = int(rng.randint(3, min(w - x, 9) + 1))
                lit = row[x:x + n]
                if rle4:
                    lit = lit + [0] * (n % 2)
                    body = bytes((lit[i] << 4) | lit[i + 1] for i in range(0, len(lit), 2))
                else:
                    body = bytes(lit)
                out += bytes([0, n]) + body + b"\x00" * (len(body) % 2)
                x += n
            else:
                n = 1
                while x + n < w and row[x + n] == row[x] and n < 255:
                    n += 1
                out += bytes([n, (row[x] << 4 | row[x]) if rle4 else row[x]])
                x += n
        if delta_after_row == y:
            out += bytes([0, 2, 0, 0, 1, 0])
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp(w, h, bits, pixels: bytes, pal=None, comp=0, hsize=40, topdown=False, masks=None,
        colors=0, os2=False, after_header=b"") -> bytes:
    """A BMP of the given pixel bytes (rows or RLE as stored)."""
    if os2:
        hdr = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hdr = struct.pack("<IiiHHIIiiII", hsize, w, -h if topdown else h, 1, bits, comp,
                          len(pixels), 2835, 2835, colors, 0)
        if hsize > 40:
            hdr += struct.pack("<IIII", *(list(masks or (0, 0, 0, 0)) + [0] * 4)[:4])
            hdr += bytes(hsize - len(hdr))
    table = b""
    if pal is not None:
        p = np.asarray(pal, np.uint8)[:, ::-1]
        table = p.tobytes() if os2 else np.concatenate(
            [p, np.zeros((len(p), 1), np.uint8)], 1).tobytes()
    body = hdr + after_header + table
    return (b"BM" + struct.pack("<IHHI", 14 + len(body) + len(pixels), 0, 0, 14 + len(body))
            + body + pixels)


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

def tiff_lzw(data: bytes) -> bytes:
    """libtiff's LZW: codes most significant bit first, the width growing one
    code early, a clear before the table fills."""
    table = {bytes([i]): i for i in range(256)}
    nxt, width, codes, w = 258, 9, [(256, 9)], b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        codes.append((table[w], width))
        table[wc] = nxt
        nxt += 1
        if nxt + 1 >= (1 << width) and width < 12:
            width += 1
        if nxt >= 4093:
            codes.append((256, width))
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        w = bytes([b])
    if w:
        codes.append((table[w], width))
    codes.append((257, width))
    acc = n = 0
    out = bytearray()
    for c, s in codes:
        acc = (acc << s) | c
        n += s
        while n >= 8:
            out.append((acc >> (n - 8)) & 255)
            n -= 8
    if n:
        out.append((acc << (8 - n)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 126:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1)]) + data[i:i + 1]
            i = j + 1
        else:
            k = i
            while k < len(data) and k - i < 127 and not (k + 1 < len(data)
                                                         and data[k + 1] == data[k]):
                k += 1
            k = max(k, i + 1)
            out += bytes([k - i - 1]) + data[i:k]
            i = k
    return bytes(out)


def _reverse_bits(b: bytes) -> bytes:
    return bytes(int(f"{x:08b}"[::-1], 2) for x in b)


def tiff(img, bits, photo, bo="<", comp=1, rps=None, tile=None, predictor=1, fill=1,
         cmap=None, extra=()) -> bytes:
    """A one-image TIFF of samples img [h, w, spp] at ``bits``."""
    img = np.asarray(img)
    h, w, spp = img.shape

    def rows_bytes(a):
        hh, ww = a.shape[:2]
        if bits == 8:
            a = a.astype(np.int64)
            if predictor == 2:
                d = a.copy()
                d[:, 1:] = (a[:, 1:] - a[:, :-1]) & 255
                a = d
            return a.astype(np.uint8).reshape(hh, -1)
        planes = ((a.reshape(hh, ww, 1) >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8)
        return np.packbits(planes.reshape(hh, -1), axis=1)

    def encode(b: bytes) -> bytes:
        b = {5: tiff_lzw, 8: zlib.compress, 32946: zlib.compress, 32773: packbits}.get(
            comp, lambda x: x)(b)
        return _reverse_bits(b) if fill == 2 else b

    chunks = []
    if tile:
        tw, th = tile
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                blk = np.zeros((th, tw, spp), img.dtype)
                part = img[ty:ty + th, tx:tx + tw]
                blk[:part.shape[0], :part.shape[1]] = part
                chunks.append(encode(rows_bytes(blk).tobytes()))
    else:
        rps = rps or h
        for y in range(0, h, rps):
            chunks.append(encode(rows_bytes(img[y:y + rps]).tobytes()))
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [comp]),
               (262, 3, [photo]), (277, 3, [spp])]
    if fill != 1:
        entries.append((266, 3, [fill]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if cmap is not None:
        entries.append((320, 3, list(cmap)))
    if extra:
        entries.append((338, 3, list(extra)))
    data = bytearray((b"II*\x00" if bo == "<" else b"MM\x00*") + bytes(4))
    offs = []
    for c in chunks:
        offs.append(len(data))
        data += c
    data += bytes(len(data) % 2)
    if tile:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, offs),
                    (325, 4, [len(c) for c in chunks])]
    else:
        entries += [(273, 4, offs), (278, 4, [rps]), (279, 4, [len(c) for c in chunks])]
    entries.sort()
    ifd = len(data)
    base = ifd + 2 + 12 * len(entries) + 4
    ifdb, ext = struct.pack(bo + "H", len(entries)), bytearray()
    for tag, typ, vals in entries:
        raw = struct.pack(bo + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(raw) <= 4:
            ifdb += struct.pack(bo + "HHI", tag, typ, len(vals)) + raw + bytes(4 - len(raw))
        else:
            ifdb += struct.pack(bo + "HHII", tag, typ, len(vals), base + len(ext))
            ext += raw + bytes(len(raw) % 2)
    data += ifdb + bytes(4) + ext
    data[4:8] = struct.pack(bo + "I", ifd)
    return bytes(data)
