"""JPEG decoding in numpy and the standard library, as Pillow decodes it
(``PIL.Image.open(p).convert("RGB")`` with libjpeg-turbo's defaults), bit
for bit: the GPU machine has no Pillow.

    jpeg_decode_rgb(data: bytes, native: bool = False) -> uint8 [H, W, 3]

``native=True`` runs the same decode, bit for bit and with the same
errors, in the host C++ of ops/csrc/jpeg_huffman.cpp (the card's loaders).

What it reads: SOF0, SOF1 (sequential) and SOF2 (progressive) Huffman
frames at 8-bit precision with one component (grayscale, repeated into
three channels as ``convert("RGB")`` does), three (YCbCr; RGB where an
Adobe APP14 marker says transform 0, as libjpeg decides) or four (CMYK, or
YCCK where an Adobe marker says a transform other than 0), any integral
sampling factors, scans interleaved or not, restart intervals. The pieces
are libjpeg's:

- the sequential entropy decoder reads each restart interval's unstuffed
  bytes as 32-bit words and decodes each Huffman symbol with one lookup of
  the next 16 bits, in a table that also holds the symbol's value bits
  where code and value fit in them (``_lut``, cached per table): the one
  Python loop;
- the progressive decoder (``jdphuff.c``) keeps every block's
  coefficients over all scans: DC first and DC refine scans, AC first scans
  with their end-of-band runs, AC refine scans with their correction bits,
  restart intervals resetting the DC predictors and the run; a
  non-interleaved scan walks the component's own block grid. The image is
  made once after the last scan. libjpeg-turbo smooths the blocks of a
  progressive image whose first AC coefficients are not all refined to
  full precision by then (``jdcoefct.c:smoothing_ok``); no complete file
  from Pillow's or a camera's encoder leaves them so, and such a file
  raises;
- dequantisation and ``jidctint.c``'s integer ISLOW IDCT (CONST_BITS 13,
  PASS1_BITS 2, its wrapping range limit), over all blocks at once in
  integer numpy (libjpeg-turbo's SIMD islow is bit-exact with that C code);
- ``jdsample.c``'s upsampling: ``h2v1_fancy_upsample`` (4:2:2),
  ``h2v2_fancy_upsample`` (4:2:0, the rows above and below as context) and
  ``h1v2_fancy_upsample`` (4:4:0), each with its rounding biases and the
  edge samples replicated at the component's own (downsampled) width and
  height, box replication where the downsampled width is 2 or less, and
  ``int_upsample`` replication for other integral factors;
- ``jdcolor.c``'s ``ycc_rgb_convert`` (SCALEBITS 16 tables, ONE_HALF
  rounding) and ``ycck_cmyk_convert``; a CMYK image as Pillow takes it
  (raw mode ``CMYK;I``, the Adobe convention, every channel inverted) and
  converts it (``Convert.c:cmyk2rgb``: nk = 255 - K, R = nk - nk * C / 255
  with Pillow's MULDIV255 rounding);
- the output cropped from the MCU-padded planes to the frame's size.

What raises ``ValueError``, naming ROADMAP item 26: lossless and
hierarchical (SOF3, SOF5-7) and arithmetic-coded (SOF9-15, DAC) files,
12-bit precision, a height given only by a DNL marker, a progressive image
libjpeg-turbo would smooth; and data that ends before the image does
(truncated, or a progressive file with no EOI) or holds an invalid Huffman
code or progressive scan.
"""

from __future__ import annotations

import functools
import re

import numpy as np

ITEM = "ROADMAP item 26"

# natural (row-major) index of the k-th coefficient in zigzag order
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_UNZIGZAG = np.argsort(_ZIGZAG)  # natural order <- zigzag order

_SOF_REFUSED = {
    0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)", 0xC9: "arithmetic-coded (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)", 0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
}
_ENTROPY_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")  # a marker other than RSTn
_RST = re.compile(rb"\xff[\xd0-\xd7]")


def _refuse(what: str) -> ValueError:
    return ValueError(f"jpeg: {what} files are not supported (baseline only; {ITEM})")


def _corrupt(what: str) -> ValueError:
    return ValueError(f"jpeg: {what}")


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------

def _extend(bits, size):
    """JPEG's EXTEND: `size` value bits -> the signed value (numpy)."""
    return np.where(bits < (1 << np.maximum(size - 1, 0)), bits - (1 << size) + 1, bits)


@functools.lru_cache(maxsize=64)
def _lut(counts: bytes, symbols: bytes, dc: bool) -> list:
    """``_lut_rows`` as a list of tuples, what the Python loop indexes."""
    return list(map(tuple, _lut_rows(counts, symbols, dc).tolist()))


def _code_table(counts: bytes, symbols: bytes):
    """(code length, symbol) of every 16-bit window, int64 [65536] each
    (length 0: no code)."""
    length = np.zeros(1 << 16, np.int64)
    symbol = np.zeros(1 << 16, np.int64)
    code, i = 0, 0
    for n_bits in range(1, 17):
        for _ in range(counts[n_bits - 1]):
            if code >= 1 << n_bits:
                raise _corrupt("bad Huffman table")
            lo = code << (16 - n_bits)
            length[lo:lo + (1 << (16 - n_bits))] = n_bits
            symbol[lo:lo + (1 << (16 - n_bits))] = symbols[i]
            code, i = code + 1, i + 1
        code <<= 1
    return length, symbol


@functools.lru_cache(maxsize=64)
def _sym_lut(counts: bytes, symbols: bytes, dc: bool) -> list:
    """The progressive decoder's table: (code length, symbol) for every
    16-bit window, length 0 where no code starts."""
    if dc and any(s > 15 for s in symbols[:sum(counts)]):
        raise _corrupt("bad Huffman table")  # jdhuff.c: a DC size past 15
    length, symbol = _code_table(counts, symbols)
    return list(zip(length.tolist(), symbol.tolist()))


@functools.lru_cache(maxsize=64)
def _lut_rows(counts: bytes, symbols: bytes, dc: bool) -> np.ndarray:
    """The lookup table of one Huffman table for every 16-bit window, as
    int32 rows [65536, 2] (DC) or [65536, 3] (AC):
    DC: (n, v): n > 0 bits consumed for code and value bits, v the value;
    n < 0: -n code bits, then v value bits to read. AC: (n, run, v): n > 0
    consumed, v the value's low 16 bits (0 for ZRL, run 15), run -1 for end
    of block; n < 0: -n code bits, then v value bits. AC runs are in units of
    2^16 (the decoder's packed position). n == 0: no code."""
    if dc and any(s > 15 for s in symbols[:sum(counts)]):
        raise _corrupt("bad Huffman table")  # jdhuff.c: a DC size past 15
    length, symbol = _code_table(counts, symbols)
    window = np.arange(1 << 16, dtype=np.int64)
    size = symbol if dc else symbol & 15
    fits = length + size <= 16
    shift = np.maximum(16 - length - size, 0)
    value = _extend((window >> shift) & ((1 << size) - 1), size)
    value = np.where(size > 0, value, 0)
    n = np.where(length == 0, 0, np.where(fits, length + size, -length))
    if dc:
        rows = [n, np.where(fits, value, size)]
    else:
        run = symbol >> 4
        run = np.where(size == 0, np.where(run == 15, 15, -1), run) << 16
        rows = [n, run, np.where(fits, value & 0xFFFF, size)]
    out = np.ascontiguousarray(np.stack(rows, -1).astype(np.int32))
    out.flags.writeable = False  # shared by every decode (and thread)
    return out


def _decode_interval(words, blocks, dcls, acls, preds, out_ac, out_dc) -> int:
    """Decode the blocks of one restart interval from its unstuffed bytes as
    big-endian 32-bit words (zero-padded past the end) -> the bits it used.
    blocks: (block number, component of the scan) in decode order. Each
    non-zero AC coefficient goes to out_ac packed as block << 23 | zigzag
    position << 16 | value & 0xFFFF (a position past 63 is corrupt data,
    checked by the caller); each DC value (the predictor's running sum) to
    out_dc."""
    buf = nb = wi = 0
    put, put_dc = out_ac.append, out_dc.append
    one, end = 1 << 16, 64 << 16
    for blk, ci in blocks:
        if nb < 32:
            buf = ((buf & ((1 << nb) - 1)) << 32) | words[wi]
            wi += 1
            nb += 32
        n, v = dcls[ci][(buf >> (nb - 16)) & 0xFFFF]
        if n > 0:
            nb -= n
        elif n < 0:
            nb += n
            if v:
                nb -= v
                bits = (buf >> nb) & ((1 << v) - 1)
                v = bits - (1 << v) + 1 if bits < 1 << (v - 1) else bits
        else:
            raise _corrupt("invalid Huffman code (corrupt data)")
        preds[ci] += v
        put_dc(preds[ci])
        acl = acls[ci]
        bk = blk << 23
        kk = one
        while kk < end:
            if nb < 32:
                buf = ((buf & ((1 << nb) - 1)) << 32) | words[wi]
                wi += 1
                nb += 32
            n, r, v = acl[(buf >> (nb - 16)) & 0xFFFF]
            if n > 0:
                nb -= n
                if r < 0:
                    break
                kk += r
                if v:
                    put(bk + kk + v)
                kk += one
            elif n < 0:
                nb += n - v
                bits = (buf >> nb) & ((1 << v) - 1)
                kk += r
                put(bk + kk + ((bits - (1 << v) + 1 if bits < 1 << (v - 1) else bits) & 0xFFFF))
                kk += one
            else:
                raise _corrupt("invalid Huffman code (corrupt data)")
    return wi * 32 - nb


# ---------------------------------------------------------------------------
# progressive scans (jdphuff.c)
# ---------------------------------------------------------------------------

class _Bits:
    """The bit reader of one restart interval of a progressive scan: its
    unstuffed bytes as big-endian 32-bit words, zero-padded; ``used()`` the
    bits consumed (an IndexError reads past the padding)."""

    __slots__ = ("words", "wi", "buf", "nb")

    def __init__(self, words):
        self.words, self.wi, self.buf, self.nb = words, 0, 0, 0

    def get(self, n: int) -> int:
        if self.nb < 32:
            self.buf = ((self.buf & ((1 << self.nb) - 1)) << 32) | self.words[self.wi]
            self.wi += 1
            self.nb += 32
        self.nb -= n
        return (self.buf >> self.nb) & ((1 << n) - 1)

    def huff(self, lut) -> int:
        if self.nb < 32:
            self.buf = ((self.buf & ((1 << self.nb) - 1)) << 32) | self.words[self.wi]
            self.wi += 1
            self.nb += 32
        n, sym = lut[(self.buf >> (self.nb - 16)) & 0xFFFF]
        if not n:
            raise _corrupt("invalid Huffman code (corrupt data)")
        self.nb -= n
        return sym

    def used(self) -> int:
        return self.wi * 32 - self.nb


def _w16(v: int) -> int:
    """v as a JCOEF (int16, wrapping)."""
    return ((v + 32768) & 0xFFFF) - 32768


def _ext(bits: int, size: int) -> int:
    return bits - (1 << size) + 1 if bits < 1 << (size - 1) else bits


def _progressive_interval(rd: _Bits, blocks, luts, coef: list, ss, se, ah, al) -> None:
    """Decode one restart interval of a progressive scan into coef (every
    block's 64 coefficients in zigzag order, a flat list): jdphuff.c's
    decode_mcu_DC_first, _DC_refine, _AC_first and _AC_refine. A position
    past 63 is coefficient 63 (libjpeg's padded natural-order table)."""
    if ss == 0 and ah == 0:  # DC first
        preds = [0] * len(luts)
        for blk, ci in blocks:
            size = rd.huff(luts[ci])
            preds[ci] += _ext(rd.get(size), size) if size else 0
            coef[blk * 64] = _w16(preds[ci] << al)
        return
    if ss == 0:  # DC refine: one bit a block
        p1 = 1 << al
        for blk, _ in blocks:
            if rd.get(1):
                coef[blk * 64] |= p1
        return
    lut, eobrun = luts[0], 0
    if ah == 0:  # AC first
        for blk, _ in blocks:
            if eobrun:
                eobrun -= 1
                continue
            base, k = blk * 64, ss
            while k <= se:
                rs = rd.huff(lut)
                r, size = rs >> 4, rs & 15
                if size:
                    k += r
                    coef[base + min(k, 63)] = _w16(_ext(rd.get(size), size) << al)
                elif r == 15:  # ZRL
                    k += 15
                else:  # EOBr
                    eobrun = (1 << r) + (rd.get(r) if r else 0) - 1
                    break
                k += 1
        return
    p1, m1 = 1 << al, -1 << al  # AC refine
    for blk, _ in blocks:
        base, k = blk * 64, ss
        if not eobrun:
            while k <= se:
                rs = rd.huff(lut)
                r, size = rs >> 4, rs & 15
                if size:  # a newly nonzero coefficient (size 1; libjpeg warns on others)
                    size = p1 if rd.get(1) else m1
                elif r != 15:
                    eobrun = (1 << r) + (rd.get(r) if r else 0)
                    break
                while True:  # past r zero-history coefficients, correcting the rest
                    c = coef[base + k]
                    if c:
                        if rd.get(1) and not c & p1:
                            coef[base + k] = _w16(c + (p1 if c >= 0 else m1))
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                    if k > se:
                        break
                if size:
                    coef[base + min(k, 63)] = size
                k += 1
        if eobrun:  # the end-of-band run: correction bits only
            while k <= se:
                c = coef[base + k]
                if c and rd.get(1) and not c & p1:
                    coef[base + k] = _w16(c + (p1 if c >= 0 else m1))
                k += 1
            eobrun -= 1


# ---------------------------------------------------------------------------
# IDCT, upsampling, colour
# ---------------------------------------------------------------------------

def _islow_butterfly(c):
    """jidctint.c's 1-D ISLOW stage on 8 int64 arrays -> its 8 outputs
    before the descale."""
    z1 = (c[2] + c[6]) * 4433                      # FIX_0_541196100
    tmp2 = z1 + c[6] * -15137                      # FIX_1_847759065
    tmp3 = z1 + c[2] * 6270                        # FIX_0_765366865
    tmp0 = (c[0] + c[4]) << 13
    tmp1 = (c[0] - c[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                          # FIX_1_175875602
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995               # FIX_0_899976223, FIX_2_562915447
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5     # FIX_1_961570560, FIX_0_390180644
    t0, t1 = t0 + z1 + z3, t1 + z2 + z4
    t2, t3 = t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _idct_range_table() -> np.ndarray:
    """libjpeg's post-IDCT range limit, indexed by (value & 1023): x + 128
    for x in [-128, 127], 255 above, 0 below, wrapping past +-512."""
    i = np.arange(1024)
    return np.select([i < 128, i < 512, i < 896], [i + 128, 255, 0], i - 896).astype(np.uint8)


_RANGE = _idct_range_table()


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """Dequantised coefficients [N, 8, 8] (row = vertical frequency) ->
    samples [N, 8, 8] uint8, jpeg_idct_islow's arithmetic."""
    c = coef.astype(np.int64)
    cols = _islow_butterfly([c[:, k, :] for k in range(8)])  # pass 1: columns
    ws = np.stack([(v + 1024) >> 11 for v in cols], axis=1)  # DESCALE(, 11)
    rows = _islow_butterfly([ws[:, :, k] for k in range(8)])  # pass 2: rows
    out = np.stack([(v + (1 << 17)) >> 18 for v in rows], axis=2)  # DESCALE(, 18)
    return _RANGE[out & 1023]


def _edges(p, axis):
    """p's neighbours before and after along `axis`, the edge replicated."""
    first = np.take(p, [0], axis=axis)
    last = np.take(p, [p.shape[axis] - 1], axis=axis)
    n = p.shape[axis]
    before = np.concatenate([first, np.take(p, range(n - 1), axis=axis)], axis=axis)
    after = np.concatenate([np.take(p, range(1, n), axis=axis), last], axis=axis)
    return before, after


def _interleave(even, odd, axis):
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def _upsample(p: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """One component's valid samples [dh, dw] -> [dh * fv, dw * fw] as
    jdsample.c upsamples with fancy upsampling on (libjpeg's default)."""
    p = p.astype(np.int32)
    if (fh, fv) == (1, 1):
        return p
    if (fh, fv) in ((2, 1), (2, 2)) and p.shape[1] <= 2:  # h2v1_/h2v2_upsample
        return p.repeat(fv, axis=0).repeat(fh, axis=1)
    if (fh, fv) == (2, 1):  # h2v1_fancy_upsample
        left, right = _edges(p, 1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1)
    if (fh, fv) == (1, 2):  # h1v2_fancy_upsample
        above, below = _edges(p, 0)
        return _interleave((3 * p + above + 1) >> 2, (3 * p + below + 2) >> 2, 0)
    if (fh, fv) == (2, 2):  # h2v2_fancy_upsample
        above, below = _edges(p, 0)
        rows = []
        for cs in (3 * p + above, 3 * p + below):
            left, right = _edges(cs, 1)
            rows.append(_interleave((3 * cs + left + 8) >> 4, (3 * cs + right + 7) >> 4, 1))
        return _interleave(rows[0], rows[1], 0)
    return p.repeat(fv, axis=0).repeat(fh, axis=1)  # int_upsample


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    return ((_fix(1.40200) * x + half) >> 16, (_fix(1.77200) * x + half) >> 16,
            -_fix(0.71414) * x, -_fix(0.34414) * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert on uint8-valued planes."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# markers and scans
# ---------------------------------------------------------------------------

def _segment(data: bytes, pos: int) -> tuple[bytes, int]:
    """The payload of the marker segment whose length field is at `pos`,
    and the position after it."""
    if pos + 2 > len(data):
        raise _corrupt("truncated data (a marker segment runs past the end)")
    n = int.from_bytes(data[pos:pos + 2], "big")
    if n < 2 or pos + n > len(data):
        raise _corrupt("truncated data (a marker segment runs past the end)")
    return data[pos + 2:pos + n], pos + n


class _Frame:
    def __init__(self, body: bytes, progressive: bool = False):
        if len(body) < 6:
            raise _corrupt("short SOF segment")
        precision = body[0]
        self.height = int.from_bytes(body[1:3], "big")
        self.width = int.from_bytes(body[3:5], "big")
        n = body[5]
        if precision != 8:
            raise _refuse(f"{precision}-bit")
        if n not in (1, 3, 4):
            raise _refuse(f"{n}-component")
        if self.height == 0:
            raise _refuse("DNL-height")
        if self.width == 0 or len(body) < 6 + 3 * n:
            raise _corrupt("bad SOF segment")
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                raise _corrupt("bad sampling factors")
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.h), max(self.v)
        for h, v in zip(self.h, self.v):
            if self.hmax % h or self.vmax % v:
                raise _refuse("fractional-sampling")
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        # each component's block grid covers the MCU-padded image
        self.bw = [self.mcux * h for h in self.h]
        self.bh = [self.mcuy * v for v in self.v]
        self.offset = np.cumsum([0] + [w * h * 64 for w, h in zip(self.bw, self.bh)])
        self.coef = np.zeros(int(self.offset[-1]), np.int64)
        self.quant = [None] * n  # latched at the component's first scan
        self.scanned = [False] * n
        self.progressive = progressive
        if progressive:  # every coefficient over all scans; -1: never scanned
            self.pcoef = [0] * int(self.offset[-1])
            self.coef_bits = [[-1] * 64 for _ in range(n)]

    def downsampled(self, c):
        """(width, height) of component c's real samples."""
        return (-(-self.width * self.h[c] // self.hmax), -(-self.height * self.v[c] // self.vmax))


def _scan_blocks(fr: _Frame, comps: list) -> tuple[list, int]:
    """(block number in fr.coef, index in the scan) of every block in decode
    order, and the blocks per MCU."""
    if len(comps) == 1:  # non-interleaved: the component's own block raster
        c = comps[0]
        w, h = fr.downsampled(c)
        by, bx = np.mgrid[0:-(-h // 8), 0:-(-w // 8)]
        base = fr.offset[c] // 64 + (by * fr.bw[c] + bx).ravel()
        return list(zip(base.tolist(), [0] * base.size)), 1
    my, mx = np.mgrid[0:fr.mcuy, 0:fr.mcux]
    my, mx = my.ravel()[:, None], mx.ravel()[:, None]
    bases, sel = [], []
    for i, c in enumerate(comps):
        yy, xx = np.mgrid[0:fr.v[c], 0:fr.h[c]]
        block = (my * fr.v[c] + yy.ravel()) * fr.bw[c] + mx * fr.h[c] + xx.ravel()
        bases.append(fr.offset[c] // 64 + block)
        sel.append(np.full(block.shape, i))
    base, sel = np.concatenate(bases, 1), np.concatenate(sel, 1)
    return list(zip(base.ravel().tolist(), sel.ravel().tolist())), base.shape[1]


def _decode_scan(fr, body, data, pos, qt, dc_tabs, ac_tabs, restart) -> int:
    """Decode one sequential scan starting at data[pos] into fr.coef ->
    the position of the marker after its entropy-coded data."""
    ns = body[0] if body else 0
    if ns < 1 or ns > len(fr.ids) or len(body) < 4 + 2 * ns:  # at most 4, as libjpeg
        raise _corrupt("bad SOS segment")
    comps, dcls, acls = [], [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i:3 + 2 * i]
        if cid not in fr.ids:
            raise _corrupt(f"scan names component {cid}, not in the frame")
        c = fr.ids.index(cid)
        if (t >> 4) not in dc_tabs or (t & 15) not in ac_tabs:
            raise _corrupt("scan uses an undefined Huffman table")
        if fr.quant[c] is None:
            if fr.tq[c] not in qt:
                raise _corrupt("component uses an undefined quantization table")
            fr.quant[c] = qt[fr.tq[c]]
        fr.scanned[c] = True
        comps.append(c)
        dcls.append(_lut(*dc_tabs[t >> 4], True))
        acls.append(_lut(*ac_tabs[t & 15], False))
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    if (ss, se, a) != (0, 63, 0):
        raise _refuse("progressive (a spectral-selection scan)")

    m = _ENTROPY_END.search(data, pos)
    end = m.start() if m else len(data)
    blocks, per_mcu = _scan_blocks(fr, comps)
    n_mcu = len(blocks) // per_mcu
    span = restart if restart else n_mcu
    pieces = _RST.split(data[pos:end]) if restart else [data[pos:end]]
    n_int = -(-n_mcu // span)
    if len(pieces) < n_int:
        raise _corrupt("truncated data (fewer restart intervals than the image needs)")
    out_ac, out_dc = [], []
    for s in range(n_int):
        raw = pieces[s].replace(b"\xff\x00", b"\xff")
        words = np.frombuffer(raw + bytes(12 - len(raw) % 4), ">u4").tolist()
        try:
            used = _decode_interval(words, blocks[s * span * per_mcu:(s + 1) * span * per_mcu],
                                    dcls, acls, [0] * ns, out_ac, out_dc)
        except IndexError:  # read past the padding
            used = 8 * len(words) * 4
        if used > 8 * len(raw):
            raise _corrupt("truncated data (the scan ends before its last block)")
    blk = np.fromiter((b for b, _ in blocks), np.int64, len(blocks))
    fr.coef[blk * 64] = np.asarray(out_dc, np.int64).astype(np.int16)  # JCOEF
    ac = np.asarray(out_ac, np.int64)
    pos = (ac >> 16) & 127
    if pos.size and pos.max() > 63:
        raise _corrupt("coefficient past the end of a block (corrupt data)")
    fr.coef[(ac >> 23) * 64 + pos] = (ac & 0xFFFF).astype(np.uint16).view(np.int16)
    return end


def _decode_progressive_scan(fr, body, data, pos, qt, dc_tabs, ac_tabs, restart) -> int:
    """Decode one progressive scan starting at data[pos] into fr.pcoef ->
    the position of the marker after its entropy-coded data."""
    ns = body[0] if body else 0
    if ns < 1 or ns > len(fr.ids) or len(body) < 4 + 2 * ns:  # at most 4, as libjpeg
        raise _corrupt("bad SOS segment")
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    # jdphuff.c start_pass_phuff_decoder's checks
    if (ss == 0 and se != 0) or (ss > 0 and (se < ss or se > 63 or ns != 1)) or \
            (ah and al != ah - 1) or al > 13:
        raise _corrupt("bad progressive scan parameters")
    comps, luts = [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i:3 + 2 * i]
        if cid not in fr.ids:
            raise _corrupt(f"scan names component {cid}, not in the frame")
        c = fr.ids.index(cid)
        tabs, key = (dc_tabs, t >> 4) if ss == 0 else (ac_tabs, t & 15)
        if not (ss == 0 and ah) and key not in tabs:  # DC refine reads no table
            raise _corrupt("scan uses an undefined Huffman table")
        if fr.quant[c] is None:
            if fr.tq[c] not in qt:
                raise _corrupt("component uses an undefined quantization table")
            fr.quant[c] = qt[fr.tq[c]]
        fr.scanned[c] = True
        comps.append(c)
        luts.append(None if ss == 0 and ah else _sym_lut(*tabs[key], ss == 0))
        for k in range(ss, se + 1):
            fr.coef_bits[c][k] = al

    m = _ENTROPY_END.search(data, pos)
    end = m.start() if m else len(data)
    blocks, per_mcu = _scan_blocks(fr, comps)
    n_mcu = len(blocks) // per_mcu
    span = restart if restart else n_mcu
    pieces = _RST.split(data[pos:end]) if restart else [data[pos:end]]
    n_int = -(-n_mcu // span)
    if len(pieces) < n_int:
        raise _corrupt("truncated data (fewer restart intervals than the image needs)")
    for i in range(n_int):
        raw = pieces[i].replace(b"\xff\x00", b"\xff")
        rd = _Bits(np.frombuffer(raw + bytes(12 - len(raw) % 4), ">u4").tolist())
        try:
            _progressive_interval(rd, blocks[i * span * per_mcu:(i + 1) * span * per_mcu],
                                  luts, fr.pcoef, ss, se, ah, al)
            used = rd.used()
        except IndexError:  # read past the padding
            used = 8 * len(rd.words) * 4
        if used > 8 * len(raw):
            raise _corrupt("truncated data (the scan ends before its last block)")
    return end


# the quantizer positions (natural order) jdcoefct.c:smoothing_ok needs
# nonzero, and the coefficients whose precision it looks at
_SMOOTH_Q = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)
_SMOOTH_COEFS = 10


def _smoothed(fr: _Frame) -> bool:
    """Would libjpeg-turbo smooth this progressive image's blocks
    (jdcoefct.c:smoothing_ok once every scan is in)?"""
    useful = False
    for c in range(len(fr.ids)):
        q, bits = fr.quant[c], fr.coef_bits[c]
        if q is None or any(q[i] == 0 for i in _SMOOTH_Q) or bits[0] < 0:
            return False
        useful |= any(b != 0 for b in bits[1:_SMOOTH_COEFS])
    return useful


def jpeg_decode_rgb(data: bytes, native: bool = False) -> np.ndarray:
    """Baseline JPEG file bytes -> uint8 [H, W, 3], equal to Pillow's
    ``Image.open(f).convert("RGB")`` (libjpeg-turbo: ISLOW IDCT, fancy
    upsampling). Raises ValueError on what it does not read (see the
    module docstring), naming ROADMAP item 26.

    native: the whole decode in one call of the host C++
    ``l2i_jpeg_decode`` (ops/csrc/jpeg_huffman.cpp, built with the kernels at
    first use; a failed build raises), the same function bit for bit with
    the same errors; the Python and numpy version of this module runs
    otherwise, and stays the plain version the tests hold it to. The card's
    entry points ask for it."""
    data = bytes(data)
    if native:
        return _decode_c(data)
    if data[:2] != b"\xff\xd8":
        raise _corrupt("not a JPEG file (no SOI marker)")
    qt, dc_tabs, ac_tabs = {}, {}, {}
    restart, jfif, adobe = 0, False, None
    fr, eoi = None, False
    pos = 2
    while True:
        nxt = data.find(b"\xff", pos)
        if nxt < 0:
            break  # no EOI: the scans decoded so far must cover the image
        pos = nxt + 1
        while pos < len(data) and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= len(data):
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            eoi = True
            break
        if marker in (0x00, 0x01, 0xD8) or 0xD0 <= marker <= 0xD7:
            continue
        if marker in _SOF_REFUSED:
            raise _refuse(_SOF_REFUSED[marker])
        if marker == 0xCC:
            raise _refuse("arithmetic-coded (DAC)")
        body, after = _segment(data, pos)
        if marker in (0xC0, 0xC1, 0xC2):
            if fr is not None:
                raise _corrupt("a second frame")
            fr = _Frame(body, progressive=marker == 0xC2)
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc_th, counts = body[i], body[i + 1:i + 17]
                n = sum(counts)
                if len(counts) < 16 or i + 17 + n > len(body) or tc_th >> 4 > 1:
                    raise _corrupt("bad DHT segment")
                (ac_tabs if tc_th >> 4 else dc_tabs)[tc_th & 15] = (
                    bytes(counts), bytes(body[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                if i + 1 + size > len(body):
                    raise _corrupt("bad DQT segment")
                q = np.frombuffer(body[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
                qt[tq] = q.astype(np.int64)[_UNZIGZAG]  # natural order
                i += 1 + size
        elif marker == 0xDD:  # DRI
            restart = int.from_bytes(body[:2], "big")
        elif marker == 0xDC:
            raise _refuse("DNL-height")
        elif marker == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:  # SOS
            if fr is None:
                raise _corrupt("scan before the frame header")
            scan = _decode_progressive_scan if fr.progressive else _decode_scan
            after = scan(fr, body, data, after, qt, dc_tabs, ac_tabs, restart)
        pos = after
    if fr is None or not all(fr.scanned):
        raise _corrupt("truncated data (no scan for every component)")
    if fr.progressive:
        if not eoi:  # more scans may have been to come
            raise _corrupt("truncated data (a progressive file with no EOI)")
        if _smoothed(fr):
            raise _refuse("block-smoothed progressive (AC coefficients left unrefined)")
        fr.coef = np.asarray(fr.pcoef, np.int64)
    return _assemble(fr, jfif, adobe)


def _assemble(fr: _Frame, jfif: bool, adobe) -> np.ndarray:
    """IDCT, upsampling and colour conversion of a decoded frame."""
    planes = []
    for c in range(len(fr.ids)):
        coef = fr.coef[fr.offset[c]:fr.offset[c + 1]].reshape(-1, 64)[:, _UNZIGZAG]
        blocks = _idct_islow((coef * fr.quant[c][_ZIGZAG][_UNZIGZAG]).reshape(-1, 8, 8))
        bh, bw = fr.bh[c], fr.bw[c]
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        w, h = fr.downsampled(c)
        up = _upsample(plane[:h, :w], fr.hmax // fr.h[c], fr.vmax // fr.v[c])
        planes.append(up[:fr.height, :fr.width])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=-1)
    if len(planes) == 4:
        return _cmyk_to_rgb(*_ycck_to_cmyk(planes) if adobe not in (None, 0) else planes)
    # jdapimin.c default_decompress_parms: JFIF means YCbCr, else Adobe's
    # transform (0: RGB), else the component ids ('R', 'G', 'B': RGB)
    rgb = (not jfif and adobe == 0) or (
        not jfif and adobe is None and fr.ids == [82, 71, 66])
    if rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


def _ycck_to_cmyk(planes):
    """jdcolor.c's ycck_cmyk_convert: (C, M, Y) = 255 - the YCbCr -> RGB
    of the first three planes, clamped; K unchanged."""
    y, cb, cr, k = (p.astype(np.int64) for p in planes)
    return (np.clip(255 - (y + _CR_R[cr]), 0, 255),
            np.clip(255 - (y + ((_CB_G[cb] + _CR_G[cr]) >> 16)), 0, 255),
            np.clip(255 - (y + _CB_B[cb]), 0, 255), k)


def _muldiv255(a, b):
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def _cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """libjpeg's CMYK samples as Pillow takes them (raw mode "CMYK;I":
    each inverted) and converts them to RGB (Convert.c:cmyk2rgb)."""
    nk = np.asarray(k, np.int64)  # 255 - (255 - K)
    out = [nk - _muldiv255(255 - np.asarray(v, np.int64), nk) for v in (c, m, y)]
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


# the C entry's error codes (jpeg_huffman.cpp) -> the Python version's errors
_C_ERRORS = {
    -10: lambda v: _corrupt("not a JPEG file (no SOI marker)"),
    -11: lambda v: _refuse(_SOF_REFUSED[v]),
    -12: lambda v: _refuse("arithmetic-coded (DAC)"),
    -13: lambda v: _corrupt("truncated data (a marker segment runs past the end)"),
    -14: lambda v: _corrupt("a second frame"),
    -15: lambda v: _corrupt("short SOF segment"),
    -16: lambda v: _refuse(f"{v}-bit"),
    -18: lambda v: _refuse(f"{v}-component"),
    -19: lambda v: _refuse("DNL-height"),
    -20: lambda v: _corrupt("bad SOF segment"),
    -21: lambda v: _corrupt("bad sampling factors"),
    -22: lambda v: _refuse("fractional-sampling"),
    -23: lambda v: _corrupt("bad DHT segment"),
    -24: lambda v: _corrupt("bad DQT segment"),
    -25: lambda v: _corrupt("scan before the frame header"),
    -26: lambda v: _corrupt("bad SOS segment"),
    -27: lambda v: _corrupt(f"scan names component {v}, not in the frame"),
    -28: lambda v: _corrupt("scan uses an undefined Huffman table"),
    -29: lambda v: _corrupt("component uses an undefined quantization table"),
    -30: lambda v: _corrupt("bad Huffman table"),
    -31: lambda v: _refuse("progressive (a spectral-selection scan)"),
    -32: lambda v: _corrupt("truncated data (fewer restart intervals than the image needs)"),
    -33: lambda v: _corrupt("invalid Huffman code (corrupt data)"),
    -34: lambda v: _corrupt("truncated data (the scan ends before its last block)"),
    -35: lambda v: _corrupt("coefficient past the end of a block (corrupt data)"),
    -36: lambda v: _corrupt("truncated data (no scan for every component)"),
    -38: lambda v: MemoryError("jpeg: out of memory"),
    -39: lambda v: _corrupt("bad progressive scan parameters"),
    -40: lambda v: _corrupt("truncated data (a progressive file with no EOI)"),
    -41: lambda v: _refuse("block-smoothed progressive (AC coefficients left unrefined)"),
}
_OUT_SIZE = -37


def _decode_c(data: bytes) -> np.ndarray:
    """``jpeg_decode_rgb`` through the C entry ``l2i_jpeg_decode``, into an
    array sized by ``l2i_jpeg_dims`` (again by the decode's own frame where
    the two disagree, which takes a second call)."""
    import ctypes

    from ..ops import _build

    lib = _build.library()
    hw = (ctypes.c_int * 2)()
    info = (ctypes.c_longlong * 2)()
    shape = (hw[0], hw[1], 3) if lib.l2i_jpeg_dims(data, len(data), hw) == 0 else (0, 0, 3)
    for _ in range(2):
        out = np.empty(shape, np.uint8)
        rc = lib.l2i_jpeg_decode(data, len(data), out.ctypes.data if out.size else None,
                                 out.size, info)
        if rc == 0:
            return out
        if rc != _OUT_SIZE:
            raise _C_ERRORS[rc](int(info[0]))
        shape = (int(info[0]), int(info[1]), 3)
    raise RuntimeError(f"l2i_jpeg_decode: no room for a {shape} frame after a second call")
