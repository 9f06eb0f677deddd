"""Small image writers for the tests: the forms Pillow cannot write or
writes one way only (a GIF's local colour table, interlace, a frame off the
canvas; RLE4 and RLE8 BMP, OS/2 headers, bitfields, top-down rows; TIFF
tiles, big-endian files, the horizontal predictor, fill order 2, 2- and
4-bit gray, WhiteIsZero, CCITT strips written without Pillow; DDS headers,
BLP, FTEX, PSD and ICNS files; JPEG 2000 codestreams rewritten from
Pillow's; the legacy formats' MSP v2, Sun raster, FLI/FLC, FITS, PIXAR,
McIdas, GBR, PhotoCD, XV thumbnail, IMT, IPTC, XPM and DCX files). Each
returns the file's bytes."""

from __future__ import annotations

import functools
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
        if nxt == 4094:  # tif_lzw.c LZWEncode: the table full, a clear
            codes.append((256, width))
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
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
        acc &= (1 << n) - 1
    if n:
        out.append((acc << (8 - n)) & 255)
    return bytes(out)


def tiff_lzw_old(data: bytes) -> bytes:
    """Old-style LZW (libtiff's LZWDecodeCompat): codes least significant bit
    first, the width growing once the next free code passes 2^width."""
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
        if nxt == 4094:
            codes.append((256, width))
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        elif nxt > (1 << width):
            width += 1
        w = bytes([b])
    if w:
        codes.append((table[w], width))
    codes.append((257, width))
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


def _ccitt_runs():
    from latent2im_tpu_torch.utils import ccitt as c

    def codes(term, makeup):
        out = dict(enumerate(term))
        out.update({64 * (i + 1): k for i, k in enumerate(makeup)})
        out.update({1792 + 64 * i: k for i, k in enumerate(c._EXT_MAKEUP)})
        return out

    modes = {v: k for k, v in c._MODES.items()}
    return codes(c._WHITE_TERM, c._WHITE_MAKEUP), codes(c._BLACK_TERM, c._BLACK_MAKEUP), modes


def _ccitt_run(r: int, table: dict) -> str:
    out = ""
    while r >= 2560:
        out += table[2560]
        r -= 2560
    if r >= 64:
        out += table[r // 64 * 64]
    return out + table[r % 64]


def _ccitt_1d(ch: list, w: int, runs) -> str:
    out, a0 = [], 0
    for i, c in enumerate(ch + [w]):
        out.append(_ccitt_run(c - a0, runs[i % 2]))
        a0 = c
    return "".join(out)


def _ccitt_2d(ch: list, ref: list, w: int, runs, modes) -> str:
    """T.4 4.2.1.3's pass, vertical and horizontal modes of a row's changing
    elements ``ch`` against the reference row's ``ref``."""
    import bisect

    out, a0, color = [], -1, 0
    cur, refs = ch + [w, w], ref + [w, w]
    while a0 < w:
        j = bisect.bisect_right(cur, a0) if a0 >= 0 else 0
        a1 = cur[j]
        i = bisect.bisect_right(ref, a0) if a0 >= 0 else 0
        i = min(i + (i % 2 != color), len(ref))
        b1, b2 = refs[i], refs[i + 1]
        if b2 < a1:
            out.append(modes["P"])
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out.append(modes[a1 - b1])
            a0, color = a1, color ^ 1
        else:
            a2 = cur[j + 1]
            out += [modes["H"], _ccitt_run(a1 - max(a0, 0), runs[color]),
                    _ccitt_run(a2 - a1, runs[color ^ 1])]
            a0 = a2
    return "".join(out)


def ccitt(black, compression: int, two_d_every: int = 0) -> bytes:
    """One strip of bilevel rows ``black`` [h, w] (1 black) in CCITT
    modified Huffman (2: each row 1D from a byte boundary; 32771, RLEW: from
    a 16-bit word boundary of the strip), T.4 (3: an EOL before each row;
    where ``two_d_every``, T4Options bit 0, a row's tag bit, and every
    that-many-th row 1D, the rest 2D) or T.6 (4: every row 2D), most
    significant bit first."""
    white_runs, black_runs, modes = _ccitt_runs()
    runs = (white_runs, black_runs)
    black = np.asarray(black, np.uint8)
    w = black.shape[1]
    bits, ref = [], []
    for y, row in enumerate(black):
        ch = np.flatnonzero(np.diff(np.concatenate([[0], row]))).tolist()
        if compression in (2, 32771):
            code = _ccitt_1d(ch, w, runs)
            code += "0" * (-(len(code) + sum(map(len, bits))) % (8 if compression == 2 else 16))
        elif compression == 3:
            one_d = not two_d_every or y % two_d_every == 0
            code = "0" * 11 + "1" + ("" if not two_d_every else "1" if one_d else "0")
            code += _ccitt_1d(ch, w, runs) if one_d else _ccitt_2d(ch, ref, w, runs, modes)
        else:
            code = _ccitt_2d(ch, ref, w, runs, modes)
        bits.append(code)
        ref = ch
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


_TWO_BIT_CODE = {0: 0, 1: 1, -1: 3}
_THREE_BIT_CODE = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}


def thunderscan(v, runs_to_the_end: bool = False, raw_only: bool = False) -> bytes:
    """Rows v [h, w] of 4-bit pixels in ThunderScan's codes (tif_thunder.c,
    each row from a last pixel of 0): a run of the last pixel (at most 63),
    three 2-bit deltas (-1, 0, +1; skip code 2 past the row's end), two
    3-bit deltas (-3 to +3; skip code 4), or a raw pixel, the shortest that
    fits first; the last pixel of a row is never part of a run unless
    ``runs_to_the_end``; ``raw_only`` codes every pixel raw."""
    out = bytearray()
    for row in np.asarray(v, np.int64):
        w, i, last = len(row), 0, 0
        while i < w:
            if raw_only:
                out.append(0xC0 | int(row[i]))
                last = int(row[i])
                i += 1
                continue
            run = 0
            while i + run < w and run < 63 and row[i + run] == last:
                run += 1
            if i + run >= w and not runs_to_the_end:
                run = w - i - 1
            if run >= 2:
                out.append(run)
                i += run
                continue
            prev = [last] + list(row[i:i + 2])
            d = [((int(x) - p + 8) % 16) - 8 for p, x in zip(prev, row[i:i + 3])]
            if all(x in _TWO_BIT_CODE for x in d):
                codes = [_TWO_BIT_CODE[x] for x in d] + [2] * (3 - len(d))
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
                last = int(row[i + len(d) - 1])
                i += len(d)
            elif all(x in _THREE_BIT_CODE for x in d[:2]):
                codes = [_THREE_BIT_CODE[x] for x in d[:2]] + [4] * (2 - len(d[:2]))
                out.append(0x80 | codes[0] << 3 | codes[1])
                last = int(row[i + len(d[:2]) - 1])
                i += len(d[:2])
            else:
                out.append(0xC0 | int(row[i]))
                last = int(row[i])
                i += 1
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
         cmap=None, extra=(), planar=1, sample_format=None, big=False, tags=None,
         encode_chunk=None) -> bytes:
    """A one-image TIFF of samples img [h, w, spp] at ``bits`` (1-8 packed,
    16 or 32 in the file's byte order; float32 where ``sample_format`` is
    3), chunky or planar (each sample's plane its own strips or tiles, one
    after another), classic or BigTIFF (``big``); ``tags``: more entries
    {tag: (type, values)}; ``encode_chunk``: a codec of one strip's or
    tile's bytes (e.g. JPEG) in place of ``comp``'s."""
    img = np.asarray(img)
    h, w, spp = img.shape
    dt = {16: "u2", 32: "f4" if sample_format == 3 else "u4"}.get(bits)

    def rows_bytes(a):
        hh, ww = a.shape[:2]
        if bits in (16, 32):
            a = a.astype(bo + dt)
            if predictor == 2:
                d = a.copy()
                d[:, 1:] = a[:, 1:] - a[:, :-1]
                a = d
            if predictor == 3:  # libtiff's fpDiff: byte planes, most significant first
                nb = bits // 8
                le = np.frombuffer(a.astype("<" + dt).tobytes(), np.uint8).reshape(hh, -1, nb)
                planes = le[..., ::-1].transpose(0, 2, 1).reshape(hh, -1)
                d = planes.astype(np.int64)
                d[:, a.shape[2]:] = (planes[:, a.shape[2]:].astype(np.int64)
                                     - planes[:, :-a.shape[2]]) & 255
                return d.astype(np.uint8)
            return np.frombuffer(a.tobytes(), np.uint8).reshape(hh, -1)
        if bits == 8:
            a = a.astype(np.int64)
            if predictor == 2:
                d = a.copy()
                d[:, 1:] = (a[:, 1:] - a[:, :-1]) & 255
                a = d
            return a.astype(np.uint8).reshape(hh, -1)
        planes = ((a.reshape(hh, -1, 1) >> np.arange(bits - 1, -1, -1)) & 1).astype(np.uint8)
        return np.packbits(planes.reshape(hh, -1), axis=1)

    def encode(b: bytes) -> bytes:
        if encode_chunk is not None:
            return encode_chunk(b)
        b = {5: tiff_lzw, 8: zlib.compress, 32946: zlib.compress, 32773: packbits}.get(
            comp, lambda x: x)(b)
        return _reverse_bits(b) if fill == 2 else b

    chunks = []
    layers = [img[..., i:i + 1] for i in range(spp)] if planar == 2 else [img]
    for layer in layers:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, layer.shape[2]), img.dtype)
                    part = layer[ty:ty + th, tx:tx + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(rows_bytes(blk).tobytes()))
        else:
            rps = rps or h
            for y in range(0, h, rps):
                chunks.append(encode(rows_bytes(layer[y:y + rps]).tobytes()))
    long_t = 16 if big else 4
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [comp]),
               (262, 3, [photo]), (277, 3, [spp])]
    if fill != 1:
        entries.append((266, 3, [fill]))
    if planar != 1:
        entries.append((284, 3, [planar]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if cmap is not None:
        entries.append((320, 3, list(cmap)))
    if extra:
        entries.append((338, 3, list(extra)))
    if sample_format is not None:
        entries.append((339, 3, [sample_format] * spp))
    for tag, (typ, vals) in (tags or {}).items():
        entries.append((tag, typ, list(vals)))
    head = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "H", 43 if big else 42)
    head += struct.pack(bo + "HHQ", 8, 0, 0) if big else bytes(4)
    data = bytearray(head)
    offs = []
    for c in chunks:
        offs.append(len(data))
        data += c
    data += bytes(len(data) % 2)
    if tile:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, long_t, offs),
                    (325, long_t, [len(c) for c in chunks])]
    else:
        entries += [(273, long_t, offs), (278, 4, [rps]), (279, long_t, [len(c) for c in chunks])]
    entries.sort()
    ifd = len(data)
    fmt = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 7: "B", 11: "f", 12: "d", 16: "Q"}
    if big:
        base = ifd + 8 + 20 * len(entries) + 8
        ifdb, ext = struct.pack(bo + "Q", len(entries)), bytearray()
    else:
        base = ifd + 2 + 12 * len(entries) + 4
        ifdb, ext = struct.pack(bo + "H", len(entries)), bytearray()
    slot = 8 if big else 4
    for tag, typ, vals in entries:
        count = len(vals) // 2 if typ == 5 else len(vals)
        raw = struct.pack(bo + fmt[typ][0] * len(vals), *vals)
        head_e = struct.pack(bo + ("HHQ" if big else "HHI"), tag, typ, count)
        if len(raw) <= slot:
            ifdb += head_e + raw + bytes(slot - len(raw))
        else:
            ifdb += head_e + struct.pack(bo + ("Q" if big else "I"), base + len(ext))
            ext += raw + bytes(len(raw) % 2)
    data += ifdb + bytes(slot) + ext
    if big:
        data[8:16] = struct.pack(bo + "Q", ifd)
    else:
        data[4:8] = struct.pack(bo + "I", ifd)
    return bytes(data)


# ---------------------------------------------------------------------------
# formats Pillow writes in a few forms only: TGA, SGI run-length, ICO, CUR
# ---------------------------------------------------------------------------

def tga_file(w, h, itype, depth, pixels: bytes, flags=0x20, cmap=None, cstart=0,
             cdepth=24, image_id=b"", cmap_type=None) -> bytes:
    """A TGA file: its 18-byte header, ID, colour map and pixel bytes as
    given (run-length packets already coded where ``itype`` says so)."""
    clen = 0 if cmap is None else len(cmap) // (cdepth // 8)
    cmap_type = (cmap is not None) if cmap_type is None else cmap_type
    hdr = struct.pack("<BBBHHBHHHHBB", len(image_id), int(cmap_type), itype, cstart, clen,
                      cdepth if cmap is not None else 0, 0, 0, w, h, depth, flags)
    return hdr + image_id + (cmap or b"") + pixels


def tga_rle(rows, size: int, seed: int = 0) -> bytes:
    """Rows of pixels (bytes of ``size``-byte pixels) run-length coded as
    TGA packets, runs and literals mixed at random, none across a row."""
    rng = np.random.RandomState(seed)
    out = bytearray()
    for row in rows:
        px = [row[i:i + size] for i in range(0, len(row), size)]
        i = 0
        while i < len(px):
            j = i
            while j + 1 < len(px) and px[j + 1] == px[i] and j - i < 127:
                j += 1
            if j > i and rng.rand() < 0.8:
                out += bytes([0x80 | (j - i)]) + px[i]
                i = j + 1
            else:
                n = min(len(px) - i, rng.randint(1, 6))
                out += bytes([n - 1]) + b"".join(px[i:i + n])
                i += n
    return bytes(out)


def sgi_file(planes, bpc: int = 1, rle: bool = False, dim=None, terminate=True,
             lengths=None) -> bytes:
    """An SGI file of channel planes [z, h, w] (top row first; stored bottom
    up), verbatim or run-length coded (runs of repeats and literals, each
    row ending in a 0 count unless ``terminate`` is False; ``lengths``
    overrides the length table)."""
    planes = np.asarray(planes)
    z, h, w = planes.shape
    dim = dim or (3 if z > 1 else 2)
    hdr = struct.pack(">HBBHHHH", 474, int(rle), bpc, dim, w, h, z)
    hdr += struct.pack(">ii", 0, 255) + bytes(4) + bytes(80) + struct.pack(">i", 0)
    hdr += bytes(512 - len(hdr))
    fmt = ">u2" if bpc == 2 else np.uint8
    rows = [[planes[c, h - 1 - r].astype(fmt).tobytes() for r in range(h)] for c in range(z)]
    if not rle:
        return hdr + b"".join(b"".join(rs) for rs in rows)
    starts, lens, body = [], [], bytearray()
    base = 512 + 8 * z * h
    for c in range(z):
        for r in range(h):
            vals = [rows[c][r][i:i + bpc] for i in range(0, len(rows[c][r]), bpc)]
            code = bytearray()
            i = 0
            while i < len(vals):
                j = i
                while j + 1 < len(vals) and vals[j + 1] == vals[i] and j - i < 126:
                    j += 1
                if j > i:
                    code += (j - i + 1).to_bytes(bpc, "big") + vals[i]
                    i = j + 1
                else:
                    n = min(len(vals) - i, 5)
                    code += (0x80 | n).to_bytes(bpc, "big") + b"".join(vals[i:i + n])
                    i += n
            if terminate:
                code += bytes(bpc)
            starts.append(base + len(body))
            lens.append(len(code))
            body += code
    lens = lengths if lengths is not None else lens
    tables = struct.pack(f">{len(starts)}I", *starts) + struct.pack(f">{len(lens)}I", *lens)
    return hdr + tables + bytes(body)


def icon_file(frames, kind: int = 1) -> bytes:
    """An ICO (kind 1) or CUR (kind 2) file of frames (width, height, bit
    count, colour count, image bytes), the images after the directory."""
    out = struct.pack("<HHH", 0, kind, len(frames))
    offset = 6 + 16 * len(frames)
    blobs = b""
    for w, h, bpp, colors, blob in frames:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colors, 0, 1, bpp, len(blob),
                           offset + len(blobs))
        blobs += blob
    return out + blobs


def dib_frame(idx, bits: int, pal=None, and_mask: bool = True) -> bytes:
    """An icon's bitmap: a 40-byte header at twice the height, the colour
    table, the rows bottom up (4-byte aligned), then the AND mask."""
    idx = np.asarray(idx)
    h, w = idx.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    rows = []
    for r in range(h - 1, -1, -1):
        if bits >= 24:
            row = idx[r][..., ::-1].astype(np.uint8).tobytes() if bits == 24 else \
                idx[r][..., [2, 1, 0, 3]].astype(np.uint8).tobytes()
        else:
            vals = idx[r].astype(np.int64)
            row = np.packbits(((vals[:, None] >> np.arange(bits - 1, -1, -1)) & 1)
                              .astype(np.uint8).ravel()).tobytes()
        rows.append(row + bytes(stride - len(row)))
    colors = 0 if pal is None else len(pal)
    hdr = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0, colors, 0)
    table = b"" if pal is None else b"".join(bytes([b, g, r, 0]) for r, g, b in pal)
    mask = b""
    if and_mask:
        mstride = ((w + 31) >> 5) * 4
        mask = bytes(mstride * h)
    return hdr + table + b"".join(rows) + mask


# ---------------------------------------------------------------------------
# photo-sized files of the slowest forms, written without Pillow
# ---------------------------------------------------------------------------

BAND = 64  # rows of the band an LZW TIFF's or a TGA's image repeats


def photo_forms(size: int, seed: int = 0) -> dict:
    """{name: (file bytes, the RGB its decode must give or None)} of a
    size x size photo (a gradient with noise, from ``seed``) in the forms
    the Python readers take longest over: TIFF with LZW (16-bit CMYK; 8-bit
    RGB with the horizontal predictor) and deflate (16-bit RGBA with the
    predictor; 8-bit CMYK), group 4 and 2D group 3, Netpbm P6 at maxval 1000
    and plain P2, and run-length TGA. The LZW and TGA images repeat a
    ``BAND``-row band, one strip or run of rows each, so that the pure-Python
    writers code it once; each strip is decoded on its own all the same."""
    import functools

    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size]
    base = np.stack([x * 255 // (size - 1), y * 255 // (size - 1),
                     (x + y) * 127 // (2 * size - 2)], -1)
    p = np.clip(base + rng.randint(-40, 41, (size, size, 3)), 0, 255).astype(np.uint8)
    band = p[:BAND]
    reps = size // BAND
    tiled = np.tile(band, (reps, 1, 1))
    k = rng.randint(0, 256, (size, size, 1)).astype(np.int64)
    lzw = functools.lru_cache(maxsize=None)(tiff_lzw)
    black = (p[..., 0] > 128).astype(np.uint8)

    def g4(b, comp, every=0):
        rows = np.unpackbits(np.frombuffer(b, np.uint8)).reshape(-1, -(-size // 8) * 8)
        return ccitt(rows[:, :size], comp, every)

    gray = p[..., 0].astype(np.int64)
    mono = np.repeat(((1 - black) * 255).astype(np.uint8)[..., None], 3, -1)
    return {
        "tiff_cmyk16_lzw": (tiff(np.concatenate([tiled, np.tile(k[:BAND], (reps, 1, 1))], -1)
                                 * 257, 16, 5, "<", 5, rps=BAND, encode_chunk=lzw), None),
        "tiff_rgb_lzw_predictor": (tiff(tiled, 8, 2, "<", 5, rps=BAND, predictor=2,
                                        encode_chunk=lzw), tiled),
        "tiff_rgba16_deflate_predictor": (tiff(np.concatenate([p, k.astype(np.uint8)], -1)
                                               .astype(np.int64) * 257, 16, 2, ">", 8,
                                               rps=BAND, predictor=2, extra=(2,)), p),
        "tiff_cmyk_deflate": (tiff(np.concatenate([p, k.astype(np.uint8)], -1), 8, 5, "<", 8,
                                   rps=BAND), None),
        "tiff_g4": (tiff(black[..., None], 1, 0, "<", 4,
                         encode_chunk=lambda b: g4(b, 4)), mono),
        "tiff_g3_2d": (tiff(black[..., None], 1, 0, "<", 3, tags={292: (4, [1])},
                            encode_chunk=lambda b: g4(b, 3, 4)), mono),
        "ppm_p6_max1000": (b"P6\n%d %d\n1000\n" % (size, size)
                           + (p.astype(np.int64) * 1000 // 255).astype(">u2").tobytes(), None),
        "pgm_p2_plain": (b"P2\n# plain\n%d %d\n255\n" % (size, size) + b"\n".join(
            b" ".join(b"%d" % v for v in row) for row in gray) + b"\n",
            np.repeat(p[..., :1], 3, -1)),
        "tga_rle": (tga_file(size, size, 10, 24, tga_rle(
            [row[:, ::-1].tobytes() for row in band], 3, seed) * reps, flags=0x20), tiled),
    }


# ---------------------------------------------------------------------------
# textures and Photoshop files (what Pillow 12.1 cannot write)
# ---------------------------------------------------------------------------

def dds_file(w: int, h: int, body: bytes, fourcc: bytes = b"", dxgi: int = 0, pfflags: int = 0,
             bitcount: int = 0, masks=(0, 0, 0, 0)) -> bytes:
    """A DDS file: the 124-byte header (FourCC ``fourcc`` with the FourCC
    flag, else ``pfflags``, ``bitcount`` and ``masks``), a DX10 header where
    ``fourcc`` is DX10, then ``body``."""
    flags = pfflags | (0x4 if fourcc else 0)
    hdr = struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 1) + bytes(44)
    hdr += struct.pack("<2I4s5I", 32, flags, fourcc.ljust(4, b"\0"), bitcount, *masks)
    hdr += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    ext = struct.pack("<5I", dxgi, 3, 0, 1, 0) if fourcc == b"DX10" else b""
    return b"DDS " + hdr + ext + body


def blp_file(version: int, w: int, h: int, mip: bytes, comp: int = 1, enc: int = 1,
             alpha: int = 0, aenc: int = 0, palette: bytes = b"", jpeg_header: bytes = b"",
             gap: bytes = b"") -> bytes:
    """A BLP1 or BLP2 file of one mip: the header, the 16 offsets and
    lengths, the palette (or BLP1's JPEG header), ``gap``, then ``mip``."""
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIiI", comp, alpha, w, h, enc, 0)
    else:
        head = b"BLP2" + struct.pack("<ibbbbII", comp, enc, alpha, aenc, 1, w, h)
    mid = (struct.pack("<I", len(jpeg_header)) + jpeg_header) if comp == 0 else palette
    off = len(head) + 128 + len(mid) + len(gap)
    tables = struct.pack("<16I", off, *[0] * 15) + struct.pack("<16I", len(mip), *[0] * 15)
    return head + tables + mid + gap + mip


def ftex_file(w: int, h: int, fmt: int, body: bytes) -> bytes:
    """An FTEX file of one format and one mipmap."""
    head = b"FTEX" + struct.pack("<i2i2i2i", 1, w, h, 1, 1, fmt, 32)
    return head + struct.pack("<i", len(body)) + body


def psd_packbits_rows(plane: np.ndarray) -> list:
    return [packbits(row.tobytes()) for row in np.asarray(plane, np.uint8)]


def psd_file(planes, mode: int, bits: int = 8, comp: int = 0, palette: bytes = b"",
             resources: bytes = b"", layers: bytes = b"") -> bytes:
    """A PSD file of the composite ``planes`` [C, H, W] uint8 (bitmap
    planes packed 8 pixels a byte), raw or PackBits."""
    planes = np.asarray(planes, np.uint8)
    c, h, w = planes.shape
    if bits == 1:
        planes = np.packbits(planes.astype(bool), axis=2)
    head = b"8BPS" + struct.pack(">H6sHIIHH", 1, bytes(6), c, h, w, bits, mode)
    out = head + struct.pack(">I", len(palette)) + palette
    out += struct.pack(">I", len(resources)) + resources
    out += struct.pack(">I", len(layers)) + layers
    if comp == 0:
        return out + struct.pack(">H", 0) + planes.tobytes()
    rows = [r for p in planes for r in psd_packbits_rows(p)]
    return (out + struct.pack(">H", 1) + np.array([len(r) for r in rows], ">u2").tobytes()
            + b"".join(rows))


# ---------------------------------------------------------------------------
# JPEG 2000: codestreams rewritten from Pillow's, and JP2 boxes
# ---------------------------------------------------------------------------

def _j2k_marker(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def j2k_main_header(cs: bytes):
    """A codestream -> ([(marker, body)] of its main header after SIZ, the
    SIZ body, the rest from the first SOT)."""
    pos = 2
    segs = []
    while True:
        marker, n = struct.unpack(">HH", cs[pos:pos + 4])
        if marker == 0xFF90:
            break
        segs.append((marker, cs[pos + 4:pos + 2 + n]))
        pos += 2 + n
    siz = segs.pop(0)
    assert siz[0] == 0xFF51
    return segs, siz[1], cs[pos:]


def j2k_rebuild(siz: bytes, segs, rest: bytes) -> bytes:
    return (b"\xff\x4f" + _j2k_marker(0xFF51, siz)
            + b"".join(_j2k_marker(m, b) for m, b in segs) + rest)


def j2k_with(cs: bytes, extra=(), siz=None, cod=None) -> bytes:
    """``cs`` with marker segments ``extra`` [(marker, body)] added to its
    main header, and its SIZ or COD body replaced."""
    segs, s, rest = j2k_main_header(cs)
    if cod is not None:
        segs = [(m, cod if m == 0xFF52 else b) for m, b in segs]
    return j2k_rebuild(siz if siz is not None else s, list(segs) + list(extra), rest)


@functools.lru_cache(maxsize=16)
def _j2k_packets(cs: bytes):
    """{tile: (its tile-part header segments, [(header, body)] of each
    packet)} as utils/jpeg2000.py's tier-2 walks them (one tile-part a tile,
    headers in the packets)."""
    from latent2im_tpu_torch.utils import jpeg2000 as j2k

    h, tiles = j2k._codestream(cs)
    out = {}
    for index, t in sorted(tiles.items()):
        j2k._decode_tile(h, t, index, False)
        data = bytes(t.data)
        out[index] = [(data[s:e1], data[e1:e2]) for s, e1, e2 in t.spans]
    return out


def j2k_repack(cs: bytes, sop: bool = False, eph: bool = False, headers: str = "") -> bytes:
    """``cs`` (one tile-part a tile, no SOP, EPH or packed headers) with SOP
    before each packet, EPH after each packet header, and the headers moved
    into PPT (each tile's) or PPM (the main header's) segments."""
    segs, siz, _ = j2k_main_header(cs)
    packets = _j2k_packets(cs)
    segs = [(m, bytes([b[0] | (2 if sop else 0) | (4 if eph else 0)]) + b[1:]) if m == 0xFF52
            else (m, b) for m, b in segs]
    tiles, ppm = b"", b""
    for index, pk in packets.items():
        body, heads = b"", b""
        for k, (head, data) in enumerate(pk):
            head = head + (b"\xff\x92" if eph else b"")
            mark = struct.pack(">HHH", 0xFF91, 4, k % 65536) if sop else b""
            if headers:
                heads += head
                body += mark + data
            else:
                body += mark + head + data
        tph = b""
        if headers == "ppt":
            tph = b"".join(_j2k_marker(0xFF61, bytes([z]) + heads[o:o + 60000])
                           for z, o in enumerate(range(0, max(len(heads), 1), 60000)))
        if headers == "ppm":
            ppm += struct.pack(">I", len(heads)) + heads
        psot = 12 + len(tph) + 2 + len(body)
        tiles += (_j2k_marker(0xFF90, struct.pack(">HIBB", index, psot, 0, 1)) + tph
                  + b"\xff\x93" + body)
    if headers == "ppm":
        segs += [(0xFF60, bytes([z]) + ppm[o:o + 60000])
                 for z, o in enumerate(range(0, len(ppm), 60000))]
    return j2k_rebuild(siz, segs, tiles + b"\xff\xd9")


def j2k_merge(streams, dx, dy) -> bytes:
    """One codestream of the components of single-component codestreams
    ``streams`` (one tile, LRCP, one layer, one precinct a resolution, the
    same coding parameters), component c subsampled by (dx[c], dy[c]): the
    packets interleaved resolution by resolution."""
    segs, siz, _ = j2k_main_header(streams[0])
    packs = [_j2k_packets(s)[0] for s in streams]
    f = list(struct.unpack(">HIIIIIIIIH", siz[:36]))
    f[-1] = len(streams)
    comps = b"".join(bytes([siz[36], dx[c], dy[c]]) for c in range(len(streams)))
    body = b"".join(packs[c][r][0] + packs[c][r][1] for r in range(len(packs[0]))
                    for c in range(len(streams)))
    segs = [(m, b[:4] + b"\x00" + b[5:]) if m == 0xFF52 else (m, b) for m, b in segs]  # no MCT
    tile = _j2k_marker(0xFF90, struct.pack(">HIBB", 0, 14 + len(body), 0, 1)) + b"\xff\x93" + body
    return j2k_rebuild(struct.pack(">HIIIIIIIIH", *f) + comps, segs, tile + b"\xff\xd9")


def jp2_box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_file(cs: bytes, w: int, h: int, nc: int, bpc: int = 7, colr: bytes = b"",
             extra: bytes = b"") -> bytes:
    """A JP2 file around codestream ``cs``: signature, ftyp, jp2h (ihdr,
    ``colr`` (a colr box's body; none if empty), ``extra`` boxes), jp2c."""
    ihdr = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    head = ihdr + (jp2_box(b"colr", colr) if colr else b"") + extra
    return (b"\0\0\0\x0cjP  \r\n\x87\n" + jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + jp2_box(b"jp2h", head) + jp2_box(b"jp2c", cs))


def icns_file(members) -> bytes:
    """An ICNS file of ``members`` [(type, body)]."""
    body = b"".join(t + struct.pack(">I", 8 + len(b)) + b for t, b in members)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rle(planes) -> bytes:
    """ICNS's run-length coding of each plane [3, H, W] in turn: runs of 3
    to 130 as (n - 3) | 0x80 and the byte, literals of 1 to 128 as n - 1
    and the bytes."""
    out = bytearray()
    for plane in np.asarray(planes, np.uint8):
        v = plane.tobytes()
        i, lit = 0, bytearray()
        while i < len(v):
            run = 1
            while i + run < len(v) and v[i + run] == v[i] and run < 130:
                run += 1
            if run >= 3:
                while lit:
                    out += bytes([min(len(lit), 128) - 1]) + lit[:128]
                    lit = lit[128:]
                out += bytes([(run - 3) | 0x80, v[i]])
                i += run
            else:
                lit.append(v[i])
                i += 1
        while lit:
            out += bytes([min(len(lit), 128) - 1]) + lit[:128]
            lit = lit[128:]
    return bytes(out)


# ---------------------------------------------------------------------------
# the legacy formats
# ---------------------------------------------------------------------------

def msp_file(bits, version: int = 2, rowmap=None, rows=None) -> bytes:
    """MSP of a [h, w] 0/1 array (1 white): version 1 raw, version 2 each
    row's bytes as runs (a type-0 run where 3 or more bytes repeat, else
    literal runs); rowmap and rows override the coded ones."""
    h, w = bits.shape
    packed = np.packbits(np.asarray(bits, np.uint8), axis=1)
    words = [0] * 16
    words[0], words[1] = (0x6144, 0x4D6E) if version == 1 else (0x694C, 0x536E)
    words[2], words[3], words[4:8], words[8:10] = w, h, [1, 1, 1, 1], [w, h]
    check = 0
    for v in words:
        check ^= v
    words[12] = check
    head = struct.pack("<16H", *words)
    if version == 1:
        return head + packed.tobytes()
    if rows is None:
        rows = []
        for r in packed:
            out, i, r = bytearray(), 0, bytes(r)
            while i < len(r):
                j = i
                while j < len(r) and r[j] == r[i] and j - i < 255:
                    j += 1
                if j - i >= 3:
                    out += bytes([0, j - i, r[i]])
                    i = j
                else:
                    k = min(len(r), i + 255)
                    lit = r[i:k]
                    out += bytes([len(lit)]) + lit
                    i = k
            rows.append(bytes(out))
    rowmap = [len(r) for r in rows] if rowmap is None else rowmap
    return head + struct.pack(f"<{h}H", *rowmap) + b"".join(rows)


def sun_rle(data: bytes) -> bytes:
    """Sun's byte RLE: 0x80 n v for runs of 3 or more (n + 1 bytes), 0x80 0
    for a literal 0x80, other bytes as they are."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 256:
            j += 1
        if j - i >= 3:
            out += bytes([0x80, j - i - 1, data[i]])
            i = j
        elif data[i] == 0x80:
            out += b"\x80\x00"
            i += 1
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def sun_file(w: int, h: int, depth: int, rows: bytes, ftype: int = 1, cmap: bytes = b"",
             ptype: int = 1) -> bytes:
    """A Sun raster file of already laid out rows (raw padded to 16 bits, or
    run-length coded for type 2)."""
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(rows), ftype,
                       ptype if cmap else 0, len(cmap)) + cmap + rows


def sun_rows(v: np.ndarray, depth: int, pad: bool = True) -> bytes:
    """[h, w] values (depth 1, 4, 8) or [h, w, c] bytes (24, 32) -> rows,
    each padded to 16 bits where ``pad``."""
    h, w = v.shape[:2]
    if depth in (1, 4):
        per = 8 // depth
        vv = np.zeros((h, -(-w // per) * per), np.uint8)
        vv[:, :w] = v
        b = np.zeros((h, vv.shape[1] // per), np.uint8)
        for k in range(per):
            b |= vv[:, k::per] << (8 - depth * (k + 1))
    else:
        b = np.asarray(v, np.uint8).reshape(h, -1)
    if pad and b.shape[1] % 2:
        b = np.concatenate([b, np.zeros((h, 1), np.uint8)], 1)
    return b.tobytes()


def fli_chunk(kind: int, body: bytes) -> bytes:
    n = 6 + len(body)
    n += n % 2
    return struct.pack("<IH", n, kind) + body + bytes(n - 6 - len(body))


def fli_color(pal, kind: int = 4) -> bytes:
    """A COLOR_256 (4) or COLOR_64 (11) chunk of one packet of 256."""
    p = np.asarray(pal, np.uint8)
    return fli_chunk(kind, struct.pack("<HBB", 1, 0, 0) + p.tobytes())


def fli_brun(img) -> bytes:
    """BRUN: each line as runs (a run of 2 or more repeats, else literals)."""
    out = bytearray()
    for r in np.asarray(img, np.uint8):
        line, i, r = bytearray(), 0, bytes(r)
        packets = 0
        while i < len(r):
            j = i
            while j < len(r) and r[j] == r[i] and j - i < 127:
                j += 1
            if j - i >= 2:
                line += bytes([j - i, r[i]])
                i = j
            else:
                k = min(len(r), i + 128)
                line += bytes([256 - (k - i)]) + r[i:k]
                i = k
            packets += 1
        out += bytes([packets & 255]) + line
    return fli_chunk(15, bytes(out))


def fli_lc(prev, img) -> bytes:
    """LC: the lines that changed, each as (skip, literal count) packets."""
    prev, img = np.asarray(prev, np.uint8), np.asarray(img, np.uint8)
    rows = np.flatnonzero((prev != img).any(1))
    if not len(rows):
        return fli_chunk(12, struct.pack("<HH", 0, 0))
    y0, y1 = rows[0], rows[-1] + 1
    out = bytearray(struct.pack("<HH", y0, y1 - y0))
    for y in range(y0, y1):
        diff = np.flatnonzero(prev[y] != img[y])
        packets, x, body = 0, 0, bytearray()
        for d in diff:
            if d < x:
                continue
            skip = d - x
            while skip > 255:
                body += bytes([255, 0])
                packets += 1
                skip -= 255
            end = min(d + 100, img.shape[1])
            body += bytes([skip, end - d]) + img[y, d:end].tobytes()
            packets += 1
            x = end
        out += bytes([packets]) + body
    return fli_chunk(12, bytes(out))


def fli_ss2(prev, img) -> bytes:
    """SS2: each line as word packets, a skip-lines word before changed
    lines (width even)."""
    prev, img = np.asarray(prev, np.uint8), np.asarray(img, np.uint8)
    out, lines, skip = bytearray(), 0, 0
    for y in range(img.shape[0]):
        if (prev[y] == img[y]).all():
            skip += 1
            continue
        if skip:
            out += struct.pack("<H", 65536 - skip)
        skip = 0
        words = img[y].reshape(-1, 2)
        packets = [words[i:i + 127] for i in range(0, len(words), 127)]
        out += struct.pack("<H", len(packets))
        for p in packets:
            out += bytes([0, len(p)]) + p.tobytes()
        lines += 1
    return fli_chunk(7, struct.pack("<H", lines) + bytes(out))


def fli_file(w: int, h: int, frames, magic: int = 0xAF12, prefix: bytes = b"") -> bytes:
    """An FLI/FLC file of frames, each a list of chunk bytes."""
    body = b""
    for chunks in frames:
        data = b"".join(chunks)
        body += struct.pack("<IHH8x", 16 + len(data), 0xF1FA, len(chunks)) + data
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(prefix) + len(body), magic, len(frames),
                     w, h, 8, 0, 70)
    return bytes(head) + prefix + body


def fits_file(cards, data: bytes, pad: bool = True) -> bytes:
    """A FITS HDU of (keyword, value) cards and its data (padded to 2880)."""
    text = b"".join(f"{k:<8}= {v:>20}".ljust(80).encode() for k, v in cards)
    text += b"END".ljust(80)
    text += b" " * (-len(text) % 2880)
    return text + data + (bytes(-len(data) % 2880) if pad else b"")


def fits_gzip(v, bits: int) -> bytes:
    """A primary HDU without data and a BINTABLE GZIP_1 tile-compressed
    image of [h, w] values (ZBITPIX ``bits``), each pixel in 4 bytes, rows
    bottom up."""
    v = np.asarray(v)
    h, w = v.shape
    raw = v[::-1].astype(">i4").tobytes()
    import gzip as _gzip

    comp = _gzip.compress(raw, mtime=0)
    prim = fits_file([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 0)], b"")
    ext = fits_file([("XTENSION", "'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2),
                     ("NAXIS1", 8), ("NAXIS2", 1), ("ZIMAGE", "T"),
                     ("ZCMPTYPE", "'GZIP_1  '"), ("ZBITPIX", bits), ("ZNAXIS", 2),
                     ("ZNAXIS1", w), ("ZNAXIS2", h)], bytes(8) + comp)
    return prim + ext


def pixar_file(img, storage=(14, 2)) -> bytes:
    img = np.asarray(img, np.uint8)
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", head, 416, img.shape[0], img.shape[1])
    struct.pack_into("<HH", head, 424, *storage)
    return bytes(head) + img.tobytes()


def mcidas_file(v, size: int, prefix: int = 0, bands: int = 1) -> bytes:
    """A McIdas area of [h, w] samples of ``size`` bytes (big-endian), each
    line after ``prefix`` bytes."""
    v = np.asarray(v)
    h, w = v.shape
    words = [0] * 64
    words[1] = 4
    words[8], words[9], words[10], words[13], words[14], words[33] = h, w, size, bands, prefix, 256
    rows = v.astype({1: "u1", 2: ">u2", 4: ">i4"}[size]).reshape(h, -1).view(np.uint8)
    body = b"".join(bytes(prefix) + r.tobytes() + bytes(w * size * (bands - 1)) for r in rows)
    return struct.pack(">64i", *words) + body


def gbr_file(v, version: int = 2, comment: bytes = b"brush\0") -> bytes:
    """A GIMP brush of [h, w] (L) or [h, w, 4] (RGBA) bytes."""
    v = np.asarray(v, np.uint8)
    h, w = v.shape[:2]
    depth = 1 if v.ndim == 2 else 4
    size = (20 if version == 1 else 28) + len(comment)
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", 25)
    return head + comment + v.tobytes()


def pcd_file(y, c1, c2, orientation: int = 0) -> bytes:
    """A PhotoCD base image: y [512, 768], c1 and c2 [256, 384]."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    y, c1, c2 = (np.asarray(a, np.uint8) for a in (y, c1, c2))
    chunks = np.concatenate([y.reshape(256, 1536), c1, c2], 1)
    return bytes(head) + chunks.tobytes()


def xvthumb_file(idx, comments=(b"#XVVERSION:Version 2.28",)) -> bytes:
    idx = np.asarray(idx, np.uint8)
    h, w = idx.shape
    return (b"P7 332\n" + b"".join(c + b"\n" for c in comments)
            + b"%d %d 255\n" % (w, h) + idx.tobytes())


def imt_file(v, extra=()) -> bytes:
    v = np.asarray(v, np.uint8)
    h, w = v.shape
    lines = [b"width %d" % w, b"height %d" % h, b"pixel n8", *extra]
    return b"\n".join(lines) + b"\n\x0c" + v.tobytes()


def iptc_field(rec: int, tag: int, data: bytes) -> bytes:
    """A 5-byte field header and its data; from 32 KiB the size in 4 bytes
    after it, flagged as Pillow reads it (byte 3 0x84, byte 4 unused)."""
    if len(data) < 0x8000:
        return struct.pack(">BBBH", 0x1C, rec, tag, len(data)) + data
    return struct.pack(">BBBBBI", 0x1C, rec, tag, 0x84, 0, len(data)) + data


def iptc_file(w: int, h: int, bands, layers: int, component: int, compression: int = 1,
              band=None, split: int = 0) -> bytes:
    """An IPTC/NAA image: its header fields, then (8, 10) fields of each
    band's data (``split`` bytes a field where set)."""
    out = iptc_field(3, 60, bytes([layers, component]))
    out += iptc_field(3, 20, struct.pack(">I", w)) + iptc_field(3, 30, struct.pack(">I", h))
    out += iptc_field(3, 120, bytes([compression]))
    if band is not None:
        out += iptc_field(3, 65, bytes([band]))
    for data in bands:
        step = split or max(len(data), 1)
        for i in range(0, max(len(data), 1), step):
            out += iptc_field(8, 10, data[i:i + step])
    return out


def xpm_file(idx, pal, cpp: int = 1, none_key=None, pixels_comment: bool = True) -> bytes:
    """An XPM of [h, w] indices into pal [n, 3] (keys of ``cpp`` letters;
    ``none_key`` adds a transparent colour)."""
    idx = np.asarray(idx)
    h, w = idx.shape
    letters = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    keys = []
    for i in range(len(pal)):
        k, n = "", i
        for _ in range(cpp):
            k += letters[n % len(letters)]
            n //= len(letters)
        keys.append(k)
    ncol = len(pal) + (none_key is not None)
    out = [b"/* XPM */", b"static char *x[] = {", b'"%d %d %d %d",' % (w, h, ncol, cpp)]
    for k, c in zip(keys, np.asarray(pal, np.uint8)):
        out.append(b'"%s c #%02X%02X%02X",' % (k.encode(), c[0], c[1], c[2]))
    if none_key is not None:
        out.append(b'"%s c None",' % none_key.encode())
    if pixels_comment:
        out.append(b"/* pixels */")
    for r in idx:
        out.append(b'"' + "".join(keys[i] for i in r).encode() + b'",')
    return b"\n".join(out) + b"\n};\n"


def dcx_file(pages) -> bytes:
    """A DCX of PCX pages."""
    offs, at = [], 4 + 4 * (len(pages) + 1)
    for p in pages:
        offs.append(at)
        at += len(p)
    return struct.pack(f"<I{len(pages) + 1}I", 0x3ADE68B1, *offs, 0) + b"".join(pages)
