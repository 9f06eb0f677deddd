"""JPEG decoding in numpy and the standard library, as Pillow decodes it
(``PIL.Image.open(p).convert("RGB")`` with libjpeg-turbo's defaults), bit
for bit: the GPU machine has no Pillow.

    jpeg_decode_rgb(data: bytes, host_cpp: bool = False) -> uint8 [H, W, 3]

``host_cpp=True`` runs the same decode, bit for bit and with the same
errors, in the host C++ of ops/csrc/jpeg_huffman.cpp (the card's loaders).

What it reads: SOF0, SOF1 (sequential), SOF2 (progressive) and SOF3
(lossless) Huffman frames and SOF9 (sequential) and SOF10 (progressive)
arithmetic-coded ones at 8-bit precision with one component (grayscale,
repeated into
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
  made once after the last scan;
- the arithmetic decoder (``jdarith.c``, T.81 Annex D): the Qe table and
  its state machine, one statistics area per table (64 DC bins, 256 AC,
  conditioned by the DAC segment's L, U and Kx, defaults 0, 1, 5) reset
  at every restart, DC and AC coding of sequential scans and the four
  progressive scan kinds, and libjpeg's behaviour where the data turns
  bad (a magnitude or spectral overflow ends the interval's decoding). A
  marker supplies zeros once the decoder meets it; where the file ends
  without one, or where the decoder would read past Pillow's first 64 KiB
  read (libjpeg cannot suspend inside arithmetic-coded data, so Pillow
  fails such files), the decode raises as Pillow fails;
- ``jdcoefct.c``'s block smoothing (``_smooth``) of a progressive image
  whose first AC coefficients are not all refined to full precision
  (``smoothing_ok``): each still-zero coefficient among the first nine
  estimated from the 5 x 5 DC values around its block, and the DC too
  where no AC coefficient was scanned at all;
- the lossless decoder (``jdlhuff.c``, ``jdpred.c``, ``jdlossls.c``):
  each sample's difference coded as a DC category (0-16), the seven
  predictors, each restart interval's first row predicted from the left,
  the point transform; libjpeg-turbo upsamples a lossless frame by
  replication and converts no colour (a lossless YCbCr or YCCK file fails
  in Pillow, and here);
- dequantisation and ``jidctint.c``'s integer ISLOW IDCT (CONST_BITS 13,
  PASS1_BITS 2) as libjpeg-turbo's SSE2/AVX2 code computes it on x86-64,
  in Pillow's 3.1.3 and the JAX package's 2.1 alike: 16-bit products and
  sums where it has them, each pass saturated (``_idct_islow_simd``; equal
  to the C code until corrupt data makes it overflow), over all blocks at
  once in integer numpy;
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

Corrupt data, as libjpeg decodes on past it with a warning (each rule read
off Pillow 12.1's libjpeg-turbo 3.1.3 fed ``PILLOW_BLOCK`` bytes at a time
and off libjpeg-turbo 2.1.5 over a whole buffer, with a libjpeg program
linked here printing each warning; the two agree on all of it):

- a scan's restart intervals (``_Walk``): each interval's data ends at the
  next marker, whatever it is; the decoder never reads past one but reads
  zero bits on (JWRN_HIT_MARKER), and once a Huffman decode has read past
  its interval's data the MCU in progress ends on zeros and the rest of the
  interval decodes nothing (jdhuff.c insufficient_data: those blocks keep
  what earlier scans left, zero in a first scan). At each restart the
  marker met, or the next one past any bytes between (JWRN_EXTRANEOUS_DATA;
  a run of 0xFF then 0x00 is one 0xFF data byte, in a scan and between
  markers alike), is taken where it is the RSTn due (n counting 0-7 from the
  scan's start); else ``jpeg_resync_to_restart`` (JWRN_MUST_RESYNC) skips
  it (the RSTn due, or one three or more ahead), reads on to the next
  marker (a marker code below SOF0, or one of the two RSTn before the one
  due) or leaves it unread (any other marker, or one of the next two RSTn):
  then each interval up to it is empty, its first MCU read from zeros
  where the interval before did not run out, and nothing after;
- a Huffman code that is no code (JWRN_HUFF_BAD_CODE) reads 17 bits and
  decodes as symbol 0 (a zero DC difference, an end of block, an
  end-of-band run of one in a refinement scan); a coefficient position past
  63 writes coefficient 63 (libjpeg's padded natural-order table); a
  refinement scan's new coefficient of a size other than 1 is read as 1;
- a lossless scan (Pillow mode only: libjpeg-turbo 2.1 has no lossless
  decoder) walks its intervals and markers as above, but jdlhuff.c decodes
  an MCU row a call: the row in which the data runs out reads zero bits on,
  and each row that starts after it gets zero differences and restarts the
  predictors (jddiffct.c), so that it is predicted as the image's first
  row; a scan whose data runs to the end of the file fails, and so does a
  multi-scan file with no EOI;
- a sequential scan whose Ss, Se, Ah, Al are not 0, 63, 0, 0
  (JWRN_NOT_SEQUENTIAL) and a progressive scan out of the progression's
  order (JWRN_BOGUS_PROGRESSION) decode as they are; an Adobe transform
  other than 0-2 (JWRN_ADOBE_XFORM) means YCbCr (three components) or YCCK
  (four); an arithmetic-coded bad code or overflow (JWRN_ARITH_BAD_CODE)
  leaves the rest of its interval undecoded;
- a sequential Huffman file's first scan takes ``jstdhuff.c``'s tables into
  the DC and AC slots 0 and 1 no DHT segment has defined (a progressive one
  does not: a scan with no table fails, as in both libraries);
- a file whose first scan holds every component has one scan: a second SOS
  fails (JERR_EOI_EXPECTED). Pillow reads such an image out as it decodes,
  so what follows its scan is read only from Pillow's reads so far
  (``_tail_end``), and a marker segment that runs past them ends the decode
  with the image kept (``_runs_out``), unless libjpeg finds fault with the
  part it has; a file of more scans is read to its EOI before any output;
- where a scan's data runs to the end of the file with no marker after it
  (no EOI), Pillow fails the file once libjpeg's bit reader asks for more:
  its slow path reads 57 bits ahead, its fast path six bytes where 16 bits
  or fewer are left (``_runs_dry`` follows both, and Pillow's blocks); the
  libjpeg mode reads its buffer's fake EOI marker there instead;
- a JPEG-compressed TIFF strip (``jpeg_tiff_chunk``, libjpeg mode) as
  libtiff has libjpeg read it: its JPEGTables first as a stream of their
  own (fake EOI markers where the tag's bytes end, even inside a segment),
  the strip's stream after with those tables kept, and nothing after a
  single-scan strip's scan (libtiff takes the error of
  ``jpeg_finish_decompress`` for success).

What raises ``ValueError``, naming ROADMAP item 26 (Pillow 12.1 fails each
of these too): hierarchical files (SOF5-7, SOF13-15), arithmetic-coded
lossless ones (SOF11), 12-bit precision, a height given only by a DNL
marker. What raises as Pillow fails it: data that ends where libjpeg reads
on (above), a multi-scan file with no EOI, a progressive scan's parameters
libjpeg refuses, a scan naming a Huffman table never defined, a marker or
segment libjpeg or Pillow's own parser refuses (an unknown marker, a second
SOI, SOF or single-scan SOS, a DRI, SOS or SOF of the wrong length, a DQT
or DHT naming a table past 3), and a frame of more pixels than Pillow opens
(its DecompressionBombError).
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
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)", 0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
}
# jdmarker.c next_marker: a run of 0xFF then a byte that is neither 0x00 (a
# stuffed data byte) nor 0xFF; inside entropy-coded data a run of 0xFF then
# 0x00 is one 0xFF data byte (jdhuff.c jpeg_fill_bit_buffer, jdarith.c)
_MARKER = re.compile(rb"\xff+[^\x00\xff]")
_STUFFED = re.compile(rb"\xff+\x00")


def _refuse(what: str) -> ValueError:
    return ValueError(f"jpeg: {what} files are not supported (Pillow fails them too; {ITEM})")


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


def _decode_interval(words, blocks, dcls, acls, preds, out_ac, out_dc,
                     per_mcu: int = 1, limit=None) -> int:
    """Decode the blocks of one restart interval from its unstuffed bytes as
    big-endian 32-bit words (zero-padded past the end) -> the bits it used.
    blocks: (block number, component of the scan) in decode order. Each
    non-zero AC coefficient goes to out_ac packed as block << 23 | zigzag
    position << 16 | value & 0xFFFF (a position past 63, from corrupt
    data, is clamped to 63 by ``_decode_scan``: libjpeg's padded natural
    order); each DC value (the predictor's running sum) to out_dc. limit:
    libjpeg's run out of data (``_huffman_intervals``): no MCU starts once
    more than ``limit`` bits are used."""
    buf = nb = wi = 0
    put, put_dc = out_ac.append, out_dc.append
    one, end = 1 << 16, 64 << 16
    for i, (blk, ci) in enumerate(blocks):
        if limit is not None and i % per_mcu == 0 and wi * 32 - nb > limit:
            break
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
        else:  # JWRN_HUFF_BAD_CODE: 17 bits read, a zero symbol (a 0 difference)
            nb -= 17
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
            else:  # JWRN_HUFF_BAD_CODE: 17 bits read, a zero symbol (end of block)
                nb -= 17
                break
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
        if not n:  # JWRN_HUFF_BAD_CODE: jpeg_huff_decode reads 17 bits, gives 0
            self.nb -= 17
            return 0
        self.nb -= n
        return sym

    def used(self) -> int:
        return self.wi * 32 - self.nb


def _until(rd: _Bits, blocks, per_mcu: int, limit: int, last: list):
    """The blocks of an interval, ending before the first MCU that starts
    with more than ``limit`` bits of ``rd`` used; last[0]: the last one
    given, (block number, index in the scan)."""
    for i, b in enumerate(blocks):
        if i % per_mcu == 0 and rd.used() > limit:
            return
        last[0] = b
        yield b


def _w16(v: int) -> int:
    """v as a JCOEF (int16, wrapping)."""
    return ((v + 32768) & 0xFFFF) - 32768


def _ext(bits: int, size: int) -> int:
    return bits - (1 << size) + 1 if bits < 1 << (size - 1) else bits


def _progressive_interval(rd: _Bits, blocks, luts, coef: list, ss, se, ah, al,
                          per_mcu: int = 1, limit=None, last=None) -> None:
    """Decode one restart interval of a progressive scan into coef (every
    block's 64 coefficients in zigzag order, a flat list): jdphuff.c's
    decode_mcu_DC_first, _DC_refine, _AC_first and _AC_refine. A position
    past 63 is coefficient 63 (libjpeg's padded natural-order table).
    limit: as ``_decode_interval``'s; last: ``_until``'s."""
    if limit is not None:  # the MCUs that start within the data
        blocks = _until(rd, blocks, per_mcu, limit, last)
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
# arithmetic-coded scans (T.81 Annex D and F.1.4, G.1.3; libjpeg's jdarith.c)
# ---------------------------------------------------------------------------

def _aritab():
    """jaricom.c's jpeg_aritab (T.81 Table D.2) as (Qe, Next_Index_LPS with
    Switch_MPS in bit 7, Next_Index_MPS) per state; state 113 is the fixed
    probability 0.5 bin."""
    rows = (
        (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
        (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
        (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
        (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
        (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
        (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
        (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
        (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
        (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
        (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
        (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
        (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
        (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
        (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
        (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
        (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
        (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
        (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
        (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
        (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
        (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
        (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
        (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
        (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
        (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
        (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
        (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
        (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
        (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))
    return tuple((qe, nl | (sw << 7), nm) for qe, nl, nm, sw in rows)


ARITAB = _aritab()
# Pillow's ImageFile.load hands the decoder the file this many bytes at a
# time (MAXBLOCK), and a next block only where libjpeg suspends
PILLOW_BLOCK = 65536


# Pillow's Image.open refuses more pixels than this (DecompressionBombError)
PILLOW_MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def _bomb(h: int, w: int) -> ValueError:
    return _corrupt(f"a {w}x{h} image: more pixels than Pillow opens ({PILLOW_MAX_PIXELS})")


def _pillow_block() -> ValueError:
    return _corrupt(f"arithmetic-coded data past a {PILLOW_BLOCK}-byte read: Pillow's "
                    "libjpeg cannot suspend there and fails the file")
_FIXED = 113  # the fixed-probability bin's state, which never changes
DC_BINS, AC_BINS = 64, 256


class _ArithBits:
    """jdarith.c's arith_decode over one restart interval's entropy-coded
    bytes data[start:end] (stuffed): past ``end`` a marker follows and
    supplies zeros, as libjpeg supplies them once it meets a marker; where
    no marker follows (``eof``: the file ends there) a read past the end
    raises, as libjpeg's get_byte cannot suspend. For the same reason a
    read at or past ``limit`` raises: Pillow hands libjpeg the file
    ``PILLOW_BLOCK`` bytes at a time, more only where libjpeg suspends, and
    it cannot suspend inside arithmetic-coded data (``_pillow_block``).
    ``ct`` -1 is libjpeg's error state after a bad code: the rest of the
    interval decodes nothing."""

    __slots__ = ("data", "p", "end", "eof", "limit", "c", "a", "ct", "marker")

    def __init__(self, data, start, end, eof, limit):
        self.data, self.p, self.end, self.eof, self.limit = data, start, end, eof, limit
        self.c, self.a, self.ct, self.marker = 0, 0, -16, False

    def _byte(self) -> int:
        """jdarith.c's next input byte: a stuffed 0xFF 0x00 is 0xFF; a
        marker (0xFF not followed by 0x00, or the interval's end) gives 0
        from then on."""
        if self.marker:
            return 0
        data, p, end = self.data, self.p, self.end
        if p < end and data[p] != 0xFF:
            if p >= self.limit:
                raise _pillow_block()
            self.p = p + 1
            return data[p]
        while p < end and data[p] == 0xFF:  # fill bytes
            p += 1
        if p >= end and self.eof:
            raise _corrupt("truncated data (the scan ends before its last block)")
        if (p if p < end else end + 1) >= self.limit:  # the last byte libjpeg reads
            raise _pillow_block()
        if p < end and data[p] == 0:
            self.p = p + 1
            return 0xFF
        self.p, self.marker = p, True
        return 0

    def bit(self, st, i: int) -> int:
        a = self.a
        while a < 0x8000:
            self.ct -= 1
            if self.ct < 0:
                self.c = (self.c << 8) | self._byte()
                self.ct += 8
                if self.ct < 0:
                    self.ct += 1
                    if self.ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        qe, nl, nm = ARITAB[sv & 0x7F]
        a -= qe
        temp = a << self.ct
        if self.c >= temp:
            self.c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a = a
        return sv >> 7


def _arith_dc(rd, st, ctx: int, lo: int, hi: int):
    """F.19-F.24 for one DC difference from bin S0 = ctx -> (diff, next
    context), or None at a magnitude overflow."""
    if not rd.bit(st, ctx):
        return 0, 0
    sign = rd.bit(st, ctx + 1)
    i = ctx + 2 + sign
    m = rd.bit(st, i)
    if m:
        i = 20
        while rd.bit(st, i):
            m <<= 1
            if m == 0x8000:
                return None
            i += 1
    if m < (1 << lo) >> 1:
        nxt = 0
    elif m > (1 << hi) >> 1:
        nxt = 12 + sign * 4
    else:
        nxt = 4 + sign * 4
    v = m
    i += 14
    while m > 1:
        m >>= 1
        if rd.bit(st, i):
            v |= m
    v += 1
    return (-v if sign else v), nxt


def _arith_ac_value(rd, st, i: int, k: int, kx: int):
    """An AC coefficient's magnitude after its sign, bin i = SP of
    position k -> |v|, or None at a magnitude overflow."""
    m = rd.bit(st, i)
    if m and rd.bit(st, i):
        m = 2
        i = 189 if k <= kx else 217
        while rd.bit(st, i):
            m <<= 1
            if m == 0x8000:
                return None
            i += 1
    v = m
    i += 14
    while m > 1:
        m >>= 1
        if rd.bit(st, i):
            v |= m
    return v + 1


def _arith_interval(rd: _ArithBits, blocks, comps, dcs, acs, dac, coef: list,
                    progressive: bool, ss: int, se: int, ah: int, al: int) -> None:
    """One restart interval of an arithmetic-coded scan into coef (every
    block's 64 coefficients in zigzag order, a flat list): jdarith.c's
    decode_mcu (sequential), decode_mcu_DC_first, _AC_first, _DC_refine and
    _AC_refine. blocks: the interval's (block, index in the scan) in decode
    order; comps: the scan's components' (DC table, AC table); dcs/acs:
    the statistics bins by table, reset by the caller at the interval's
    start; dac: (L, U, K) by table."""
    fixed = [_FIXED]
    lo, hi, kx = dac
    if not progressive or ss == 0 and ah == 0:  # the DC of a block, then its AC
        dc_first = progressive
        ctxs, last = [0] * len(comps), [0] * len(comps)
        for blk, ci in blocks:
            if rd.ct == -1:
                return
            dt, at = comps[ci]
            got = _arith_dc(rd, dcs[dt], ctxs[ci], lo[dt], hi[dt])
            if got is None:
                rd.ct = -1
                return
            v, ctxs[ci] = got
            base = blk * 64
            if dc_first:
                last[ci] += v
                coef[base] = _w16(last[ci] << al)
                continue
            last[ci] = (last[ci] + v) & 0xFFFF
            coef[base] = _w16(last[ci])
            st, k = acs[at], 1
            while k <= 63:
                i = 3 * (k - 1)
                if rd.bit(st, i):  # end of block
                    break
                while not rd.bit(st, i + 1):
                    i += 3
                    k += 1
                    if k > 63:
                        rd.ct = -1
                        return
                sign = rd.bit(fixed, 0)
                v = _arith_ac_value(rd, st, i + 2, k, kx[at])
                if v is None:
                    rd.ct = -1
                    return
                coef[base + k] = _w16(-v if sign else v)
                k += 1
        return
    if ss == 0:  # DC refine: the next bit of each DC, at probability 0.5
        p1 = 1 << al
        for blk, _ in blocks:
            if rd.bit(fixed, 0):
                coef[blk * 64] |= p1
        return
    at = comps[0][1]
    st, ktab = acs[at], kx[at]
    if ah == 0:  # AC first
        for blk, _ in blocks:
            if rd.ct == -1:
                return
            base, k = blk * 64, ss
            while k <= se:
                i = 3 * (k - 1)
                if rd.bit(st, i):
                    break
                while not rd.bit(st, i + 1):
                    i += 3
                    k += 1
                    if k > se:
                        rd.ct = -1
                        return
                sign = rd.bit(fixed, 0)
                v = _arith_ac_value(rd, st, i + 2, k, ktab)
                if v is None:
                    rd.ct = -1
                    return
                coef[base + k] = _w16((-v if sign else v) << al)
                k += 1
        return
    p1, m1 = 1 << al, -1 << al  # AC refine
    for blk, _ in blocks:
        if rd.ct == -1:
            return
        base = blk * 64
        kex = se
        while kex > 0 and not coef[base + kex]:
            kex -= 1
        k = ss
        while k <= se:
            i = 3 * (k - 1)
            if k > kex and rd.bit(st, i):
                break
            while True:
                c = coef[base + k]
                if c:  # previously nonzero: a correction bit
                    if rd.bit(st, i + 2):
                        coef[base + k] = _w16(c + (m1 if c < 0 else p1))
                    break
                if rd.bit(st, i + 1):  # newly nonzero
                    coef[base + k] = m1 if rd.bit(fixed, 0) else p1
                    break
                i += 3
                k += 1
                if k > se:
                    rd.ct = -1
                    return
            k += 1


def _decode_arith_scan(fr, body, data, pos, qt, restart, dac, limit, fill=False) -> int:
    """Decode one arithmetic-coded scan (sequential or progressive)
    starting at data[pos] into fr.pcoef -> the position of the marker after
    its entropy-coded data. limit: the end of what Pillow has handed
    libjpeg so far; a restart marker that the decoder has not met already
    must lie inside it too (jdarith.c process_restart cannot suspend).
    fill: libjpeg over a whole buffer, which has no such limit and ends in a
    fake EOI marker: past the data every interval decodes from zeros."""
    ns = body[0] if body else 0
    if ns < 1 or ns > len(fr.ids) or len(body) != 4 + 2 * ns or \
            len(set(body[1:1 + 2 * ns:2])) != ns:  # at most 4, each once, as libjpeg
        raise _corrupt("bad SOS segment")
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if fr.progressive:  # jdarith.c start_pass's checks
        if (ss == 0 and se != 0) or (ss > 0 and (se < ss or se > 63 or ns != 1)) or \
                (ah and al != ah - 1) or al > 13:
            raise _corrupt("bad progressive scan parameters")
    # a sequential scan's Ss, Se, Ah, Al: JWRN_NOT_SEQUENTIAL, read as 0, 63, 0, 0
    comps, tabs = [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i:3 + 2 * i]
        if cid not in fr.ids:
            raise _corrupt(f"scan names component {cid}, not in the frame")
        c = fr.ids.index(cid)
        if fr.quant[c] is None:
            if fr.tq[c] not in qt:
                raise _corrupt("component uses an undefined quantization table")
            fr.quant[c] = qt[fr.tq[c]]
        fr.scanned[c] = True
        comps.append(c)
        tabs.append((t >> 4, t & 15))
        if fr.progressive:
            for k in range(ss, se + 1):
                fr.coef_bits[c][k] = al

    blocks, per_mcu = _scan_blocks(fr, comps)
    n_mcu = len(blocks) // per_mcu
    span = restart if restart else n_mcu
    n_int = -(-n_mcu // span)
    # fill: the buffer's fake EOI, a marker, zeros past the data, no limit
    walk = _Walk(data, pos, fill, None if fill else limit)
    met = True
    for i in range(n_int):
        if i:  # read_restart_marker reads to the marker unless the decoder met it
            walk.restart(met)
        got = walk.interval()
        lim = len(data) + 2 if fill else limit
        if got is None:  # a marker left unread: zeros (jdarith.c's unread_marker)
            rd = _ArithBits(data, walk.end(), walk.end(), False, lim)
            rd.marker = True
        else:
            rd = _ArithBits(data, got[0], got[1], got[2], lim)
        dcs = [bytearray(DC_BINS) for _ in range(16)]  # statistics reset at
        acs = [bytearray(AC_BINS) for _ in range(16)]  # every restart
        _arith_interval(rd, blocks[i * span * per_mcu:(i + 1) * span * per_mcu], tabs,
                        dcs, acs, dac, fr.pcoef, fr.progressive, ss, se, ah, al)
        met = rd.marker
    return walk.end()


# ---------------------------------------------------------------------------
# lossless scans (T.81 Annex H; libjpeg-turbo's jdlhuff.c, jddiffct.c,
# jdpred.c, jdlossls.c)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _diff_lut(counts: bytes, symbols: bytes) -> list:
    """A lossless scan's table: (code length, category) for every 16-bit
    window; categories run to 16 (jdhuff.c takes no DC symbol past it)."""
    if any(s > 16 for s in symbols[:sum(counts)]):
        raise _corrupt("bad Huffman table")
    length, symbol = _code_table(counts, symbols)
    return list(zip(length.tolist(), symbol.tolist()))


def _undifference(diff: np.ndarray, psv: int, pt: int, first_rows) -> np.ndarray:
    """jdpred.c over one component's differences [h, w] -> its sample
    values modulo 2^16: a row that starts the image or a restart interval
    predicts its first sample as 2^(7 - Pt) and the rest from the left;
    any other row its first sample from above and the rest by the scan's
    predictor (1 Ra, 2 Rb, 3 Rc, 4 Ra + Rb - Rc, 5 Ra + (Rb - Rc) / 2,
    6 Rb + (Ra - Rc) / 2, 7 (Ra + Rb) / 2, the halvings arithmetic
    shifts)."""
    rows = diff.tolist()
    init = 1 << (8 - pt - 1)
    out, prev = [], None
    for y, row in enumerate(rows):
        cur = [0] * len(row)
        if y in first_rows:
            ra = init
            for x, d in enumerate(row):
                ra = (d + ra) & 0xFFFF
                cur[x] = ra
        else:
            rb = prev[0]
            ra = cur[0] = (row[0] + rb) & 0xFFFF
            for x in range(1, len(row)):
                rc, rb = rb, prev[x]
                if psv == 1:
                    p = ra
                elif psv == 2:
                    p = rb
                elif psv == 3:
                    p = rc
                elif psv == 4:
                    p = ra + rb - rc
                elif psv == 5:
                    p = ra + ((rb - rc) >> 1)
                elif psv == 6:
                    p = rb + ((ra - rc) >> 1)
                else:
                    p = (ra + rb) >> 1
                ra = cur[x] = (row[x] + p) & 0xFFFF
        out.append(cur)
        prev = cur
    return np.asarray(out, np.int64).reshape(diff.shape)


def _decode_lossless_scan(fr, body, data, pos, dc_tabs, restart) -> int:
    """Decode one lossless scan starting at data[pos]: each sample's
    difference (jdlhuff.c: a category 0-16 from the scan's DC table, its
    value bits, 32768 for 16), undifferenced per component into
    fr.samples -> where the markers after its entropy-coded data are read
    from. The restart intervals and the markers as ``_Walk`` reads them
    (Pillow's source: no fill); a bad code as ``_Bits.huff`` reads it.
    jdlhuff.c's decode_mcus decodes an MCU row a call: the row in which the
    data runs out reads zero bits on, and each row that starts after it
    (insufficient_data, kept over a restart that leaves a marker unread)
    gets zero differences and restarts the predictors (jddiffct.c, as a
    restart does): it is predicted as the image's first row is."""
    ns = body[0] if body else 0
    if ns < 1 or ns > len(fr.ids) or len(body) != 4 + 2 * ns or \
            len(set(body[1:1 + 2 * ns:2])) != ns:  # at most 4, each once, as libjpeg
        raise _corrupt("bad SOS segment")
    psv, se, a = body[1 + 2 * ns:4 + 2 * ns]
    pt = a & 15
    if not 1 <= psv <= 7 or se or a >> 4 or pt >= 8:  # jdlossls.c start_pass_lossless
        raise _corrupt("bad lossless scan parameters")
    comps, luts = [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i:3 + 2 * i]
        if cid not in fr.ids:
            raise _corrupt(f"scan names component {cid}, not in the frame")
        c = fr.ids.index(cid)
        if (t >> 4) not in dc_tabs:
            raise _corrupt("scan uses an undefined Huffman table")
        fr.scanned[c] = True
        comps.append(c)
        luts.append(_diff_lut(*dc_tabs[t >> 4]))
    per_row = fr.downsampled(comps[0])[0] if ns == 1 else fr.mcux
    if restart % per_row:  # jdpred.c: whole MCU rows only
        raise _corrupt("a restart interval of no whole number of MCU rows")

    blocks, per_mcu = _scan_blocks(fr, comps)
    n_mcu = len(blocks) // per_mcu
    span = restart if restart else n_mcu
    n_int = -(-n_mcu // span)
    row = per_row * per_mcu  # the samples of an MCU row: one decode_mcus call
    pad = _FILL_PAD + 4 * row  # zeros past the data: 32 bits a sample at most
    walk = _Walk(data, pos, False)
    fresh = {0}  # the MCU rows whose undifferencing starts afresh
    short = False  # jdhuff.c's insufficient_data
    diffs = fr.coef
    diffs[np.fromiter((b for b, _ in blocks), np.int64, len(blocks))] = 0
    for k in range(n_int):
        if k:
            if not walk.restart():
                short = False
            fresh.add(k * span // per_row)
        span_k = walk.interval()
        if span_k is not None and span_k[2]:  # libjpeg-turbo reads ahead, and Pillow has no more
            raise _corrupt("truncated data (a lossless file with no EOI)")
        raw, bits = walk.raw(span_k, pad)
        rd = _Bits(np.frombuffer(raw, ">u4").tolist())
        for r0 in range(k * span * per_mcu, min((k + 1) * span * per_mcu, len(blocks)), row):
            if short:  # zero differences, the predictors restarted
                fresh.add(r0 // row)
                continue
            for blk, ci in blocks[r0:r0 + row]:
                s = rd.huff(luts[ci])
                diffs[blk] = 0 if not s else 32768 if s == 16 else _ext(rd.get(s), s)
            short = rd.used() > bits
    for c in comps:
        w, h = fr.downsampled(c)
        v = 1 if ns == 1 else fr.v[c]
        plane = fr.coef[fr.offset[c]:fr.offset[c + 1]].reshape(fr.bh[c], fr.bw[c])[:h, :w]
        fr.samples[c] = _undifference(plane, psv, pt, {m * v for m in fresh})
        fr.pt[c] = pt
    return walk.end()


def _assemble_lossless(fr: _Frame, jfif: bool, adobe) -> np.ndarray:
    """The samples shifted back by their Pt (jdlossls.c, 8-bit samples),
    each component replicated up to the frame's size (libjpeg-turbo does
    not smooth a lossless frame's upsampling) and, as libjpeg-turbo takes
    the colour space of a lossless file, returned as they are: gray, RGB
    (no JFIF marker, and an Adobe transform 0 or none), CMYK (no YCCK
    transform) as Pillow converts it; a YCbCr or YCCK one raises, as
    libjpeg-turbo converts no colour in lossless mode and Pillow fails
    it."""
    planes = []
    for c in range(len(fr.ids)):
        p = (fr.samples[c] << fr.pt[c]) & 0xFF
        p = p.repeat(fr.vmax // fr.v[c], axis=0).repeat(fr.hmax // fr.h[c], axis=1)
        planes.append(p[:fr.height, :fr.width])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=-1)
    if len(planes) == 4:
        if adobe not in (None, 0):
            raise _corrupt("a lossless YCCK file: libjpeg-turbo converts no colour in "
                           "lossless mode, and Pillow fails it")
        return _cmyk_to_rgb(*planes)
    if jfif or adobe not in (None, 0):
        raise _corrupt("a lossless YCbCr file: libjpeg-turbo converts no colour in "
                       "lossless mode, and Pillow fails it")
    return np.stack(planes, -1).astype(np.uint8)


# ---------------------------------------------------------------------------
# IDCT, upsampling, colour
# ---------------------------------------------------------------------------

def _w16a(v):
    """int64 values as int16 lanes: wrapped to 16 bits."""
    return ((v + 32768) & 0xFFFF) - 32768


def _simd_butterfly(c):
    """jidctint.c's 1-D ISLOW stage (CONST_BITS 13) on 8 int64 arrays -> its
    8 outputs before the descale, as libjpeg-turbo's SSE2 and AVX2 ISLOW
    (jidctint-sse2.asm, -avx2.asm) compute it on int16 lanes: the C code's
    32-bit products and sums, but c0 + c4, c0 - c4, c7 + c3 and c5 + c1
    added in 16 bits, wrapping."""
    c = list(c)
    s04, d04 = _w16a(c[0] + c[4]), _w16a(c[0] - c[4])
    z3, z4 = _w16a(c[7] + c[3]), _w16a(c[5] + c[1])
    z1 = (c[2] + c[6]) * 4433
    tmp2 = z1 + c[6] * -15137
    tmp3 = z1 + c[2] * 6270
    tmp0, tmp1 = s04 << 13, d04 << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z5 = (z3 + z4) * 9633
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    u0 = t0 * 2446 + (t0 + t3) * -7373 + z3
    u1 = t1 * 16819 + (t1 + t2) * -20995 + z4
    u2 = t2 * 25172 + (t1 + t2) * -20995 + z3
    u3 = t3 * 12299 + (t0 + t3) * -7373 + z4
    return [tmp10 + u3, tmp11 + u2, tmp12 + u1, tmp13 + u0,
            tmp13 - u0, tmp12 - u1, tmp11 - u2, tmp10 - u3]


def _idct_islow_simd(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """Coefficients [N, 8, 8] (natural order) and their quantiser steps
    [8, 8] -> samples [N, 8, 8] uint8 as libjpeg-turbo computes them on
    x86-64 (its SIMD ISLOW, in the JAX package's libjpeg-turbo 2.1 and in
    Pillow's 3.1.3 alike): the dequantisation a 16-bit multiply; a block
    whose rows 1-7 are all zero takes pass 1's shortcut (the DC << 2 in 16
    bits, every row); pass 1's output saturated to int16, pass 2's to int16
    and then to [-128, 127] before the +128. Equal to jidctint.c's C code
    (PASS1_BITS 2, its wrapping range limit) wherever nothing overflows,
    which corrupt data makes it do."""
    raw = coef.astype(np.int64)
    c = _w16a(raw * quant.astype(np.int64)[None])
    cols = _simd_butterfly([c[:, k, :] for k in range(8)])
    ws = np.clip(np.stack([(v + 1024) >> 11 for v in cols], axis=1), -32768, 32767)
    dc_only = ~raw[:, 1:].any(axis=(1, 2))
    if dc_only.any():
        ws[dc_only] = _w16a(c[dc_only, :1, :] << 2)
    rows = _simd_butterfly([ws[:, :, k] for k in range(8)])
    out = np.clip(np.stack([(v + (1 << 17)) >> 18 for v in rows], axis=2), -128, 127)
    return (out + 128).astype(np.uint8)


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
    def __init__(self, body: bytes, progressive: bool = False, arith: bool = False,
                 lossless: bool = False, libjpeg: bool = False, tiff=None):
        """tiff: a TIFF strip's colour as libtiff has libjpeg-turbo 3.1
        decode it (``jpeg_tiff_chunk``, libjpeg mode): "ycc" YCbCr to RGB
        whatever the markers say, "raw" the components as they are."""
        raw_color = tiff == "raw"
        if len(body) < 6:
            raise _corrupt("short SOF segment")
        precision = body[0]
        self.height = int.from_bytes(body[1:3], "big")
        self.width = int.from_bytes(body[3:5], "big")
        n = body[5]
        if precision != 8:
            raise _refuse(f"{precision}-bit")
        if n not in (1, 3, 4) and not (raw_color and n == 2):
            raise _refuse(f"{n}-component")
        if self.height == 0:
            raise _refuse("DNL-height")
        if self.width == 0 or len(body) != 6 + 3 * n:
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
        if libjpeg:  # JPEG_MAX_DIMENSION; no colour conversion of 4 components to RGB
            if max(self.width, self.height) > 65500:
                raise _corrupt("an image past libjpeg's 65500 pixels a side")
            if n == 4 and not raw_color:
                raise _corrupt("a 4-component file: libjpeg converts no CMYK or YCCK to RGB")
        elif self.width * self.height > PILLOW_MAX_PIXELS:
            raise _bomb(self.height, self.width)
        # a data unit: an 8 x 8 block, or one sample of a lossless frame
        self.lossless, self.unit = lossless, 1 if lossless else 8
        self.mcux = -(-self.width // (self.unit * self.hmax))
        self.mcuy = -(-self.height // (self.unit * self.vmax))
        # each component's grid of data units covers the MCU-padded image
        self.bw = [self.mcux * h for h in self.h]
        self.bh = [self.mcuy * v for v in self.v]
        self.per = self.unit * self.unit
        self.offset = np.cumsum([0] + [w * h * self.per for w, h in zip(self.bw, self.bh)])
        self.coef = np.zeros(int(self.offset[-1]), np.int64)
        self.quant = [None] * n  # latched at the component's first scan
        self.scanned = [False] * n
        self.progressive, self.arith = progressive, arith
        if progressive or arith:  # every coefficient over all scans
            self.pcoef = [0] * int(self.offset[-1])
        if progressive:  # each coefficient's Al so far; -1: never scanned
            self.coef_bits = [[-1] * 64 for _ in range(n)]
            # libjpeg-turbo 2.1: the Al values before each component's last
            # scan, and the last iMCU row decoded with data (libjpeg mode)
            self.prev_bits = [[0] * 64 for _ in range(n)]
            self.last_good = None
        self.scans = 0  # scans started
        self.libjpeg, self.tiff = libjpeg, tiff
        self.ojpeg_failed = None
        # libjpeg-turbo 2.1's smoothing window (_smooth); a TIFF strip's is 3.1's
        self.window21 = libjpeg and tiff is None
        if lossless:  # each component's samples (after its scan) and their Pt
            self.samples, self.pt = [None] * n, [0] * n

    def downsampled(self, c):
        """(width, height) of component c's real samples."""
        return (-(-self.width * self.h[c] // self.hmax), -(-self.height * self.v[c] // self.vmax))


def _scan_blocks(fr: _Frame, comps: list) -> tuple[list, int]:
    """(block number in fr.coef, index in the scan) of every block (data
    unit) in decode order, and the blocks per MCU."""
    if len(comps) == 1:  # non-interleaved: the component's own block raster
        c = comps[0]
        w, h = fr.downsampled(c)
        by, bx = np.mgrid[0:-(-h // fr.unit), 0:-(-w // fr.unit)]
        base = fr.offset[c] // fr.per + (by * fr.bw[c] + bx).ravel()
        return list(zip(base.tolist(), [0] * base.size)), 1
    my, mx = np.mgrid[0:fr.mcuy, 0:fr.mcux]
    my, mx = my.ravel()[:, None], mx.ravel()[:, None]
    bases, sel = [], []
    for i, c in enumerate(comps):
        yy, xx = np.mgrid[0:fr.v[c], 0:fr.h[c]]
        block = (my * fr.v[c] + yy.ravel()) * fr.bw[c] + mx * fr.h[c] + xx.ravel()
        bases.append(fr.offset[c] // fr.per + block)
        sel.append(np.full(block.shape, i))
    base, sel = np.concatenate(bases, 1), np.concatenate(sel, 1)
    return list(zip(base.ravel().tolist(), sel.ravel().tolist())), base.shape[1]


def _next_marker(data: bytes, p: int, fill: bool):
    """jdmarker.c next_marker from data[p]: bytes skipped to the first
    marker -> (the position of its first 0xFF, its code, the position after
    it); at the end of the data None, or in fill mode the buffer's fake EOI
    (at the 0xFF bytes the data ends with, the first byte of that marker)."""
    m = _MARKER.search(data, p)
    if m:
        return m.start(), data[m.end() - 1], m.end()
    if not fill:
        return None
    end = len(data)
    while end > p and data[end - 1] == 0xFF:
        end -= 1
    return end, 0xD9, len(data)


def _resync(code: int, want: int) -> int:
    """jdmarker.c jpeg_resync_to_restart's action for marker ``code`` where
    RST``want`` was due: 1 discard it and decode on, 2 skip to the next
    marker and decide again, 3 leave it unread (the interval is empty)."""
    if code < 0xC0:
        return 2
    if not 0xD0 <= code <= 0xD7:
        return 3
    if code in (0xD0 + ((want + 1) & 7), 0xD0 + ((want + 2) & 7)):
        return 3
    if code in (0xD0 + ((want - 1) & 7), 0xD0 + ((want - 2) & 7)):
        return 2
    return 1


class _Walk:
    """A scan's restart intervals as libjpeg reads them. Each interval's
    data runs from where the last restart left the input to the next marker
    (the decoder never reads past one: jdhuff.c's bit reader stops there
    and supplies zeros, JWRN_HIT_MARKER). At each restart (jdmarker.c
    read_restart_marker) the marker met, or the next one past skipped bytes
    (JWRN_EXTRANEOUS_DATA), is taken if it is the RSTn due (n counting 0-7
    from the scan's start); else jpeg_resync_to_restart decides
    (JWRN_MUST_RESYNC), and a marker it leaves unread makes every interval
    up to it empty. fill: libjpeg over a whole buffer, whose end reads as an
    EOI marker; else (Pillow) the end of the file is where Pillow, with no
    more data to give, fails the file once libjpeg must read on. limit: the
    bytes Pillow has handed libjpeg, where a marker search must end
    (arithmetic-coded scans cannot suspend there)."""

    __slots__ = ("data", "fill", "at", "unread", "rst", "limit", "frame", "count")

    def __init__(self, data: bytes, pos: int, fill: bool, limit=None, frame=None):
        self.data, self.fill, self.at, self.limit = data, fill, pos, limit
        self.unread, self.rst = None, 0
        # libtiff's OJPEG codec (frame.tiff "ojpeg"): its resync_to_restart
        # fails the strip; the frame records the first interval it fails at
        # and the intervals from there decode empty
        self.frame, self.count = frame, 0

    def _marker(self, p: int, check: bool = True):
        m = _next_marker(self.data, p, self.fill)
        if m is None:
            raise _corrupt("truncated data (fewer restart intervals than the image needs)")
        if check and self.limit is not None and m[2] > self.limit:
            raise _pillow_block()
        return m

    def interval(self):
        """The next interval's data -> (start, end, at_eof): end the next
        marker's position; at_eof where no marker follows (Pillow mode); None
        where the interval starts at an unread marker."""
        if self.unread is not None:
            return None
        m = _next_marker(self.data, self.at, self.fill)
        if m is None:
            end = len(self.data)
            while end > self.at and self.data[end - 1] == 0xFF:
                end -= 1
            return self.at, end, True
        return self.at, m[0], False

    def restart(self, met: bool = False) -> bool:
        """read_restart_marker -> whether a marker stays unread."""
        self.count += 1
        if self.unread is None:
            self.unread = self._marker(self.at, not met)
        while True:
            _, code, after = self.unread
            action = 1 if code == 0xD0 + self.rst else _resync(code, self.rst)
            if action != 1 and self.frame is not None:
                if self.frame.ojpeg_failed is None:
                    self.frame.ojpeg_failed = self.count
                break
            if action == 1:
                self.at, self.unread = after, None
                break
            if action == 3:
                break
            self.unread = self._marker(after)
        self.rst = (self.rst + 1) & 7
        return self.unread is not None

    def end(self) -> int:
        """Where the markers after the scan are read from."""
        return self.unread[0] if self.unread is not None else self.at

    def raw(self, span, pad: int):
        """An interval's data unstuffed and zero-padded by ``pad`` bytes (to
        a multiple of 4) -> (its bytes, its bits)."""
        if span is None:
            raw = b""
        else:
            raw = _STUFFED.sub(b"\xff", self.data[span[0]:span[1]])
        return raw + bytes(pad - len(raw) % 4), 8 * len(raw)


# zero bytes past an interval's data: more than an MCU of up to 10 blocks
# reads (each block at most 16 + 15 bits of DC, 63 x (17 + 15) of AC, or the
# same of refinement bits)
_FILL_PAD = 4096


def _huffman_intervals(walk: _Walk, n_int: int):
    """jdhuff.c's and jdphuff.c's run of the data over a scan's intervals:
    yields (interval, its words, its bits, at_eof) for each interval to
    decode and is sent back the bits the decode used. Where a decode reads
    past its interval's bits, the MCU in progress reads zeros and the rest
    of the interval decodes nothing (insufficient_data: its blocks stay as
    they were); an interval that starts at an unread marker reads zeros in
    its first MCU, or nothing where the one before ran out (process_restart
    keeps the flag while a marker is unread)."""
    short = False
    for i in range(n_int):
        if i and not walk.restart():
            short = False
        if short:
            continue
        span = walk.interval()
        raw, bits = walk.raw(span, _FILL_PAD)
        used = yield i, np.frombuffer(raw, ">u4").tolist(), bits, span is not None and span[2]
        short = used > bits


# libjpeg-turbo's bit reader (jdhuff.c): a slow-path fill reads bytes until
# MIN_GET_BITS are buffered (64-bit bit buffer), the fast path (decode_mcu_fast,
# without restart intervals and with BUFSIZE bytes an MCU block in the buffer)
# reads six bytes whenever 16 bits or fewer are left
_MIN_GET_BITS = 57
_BUFSIZE = 512


def _runs_dry(data: bytes, start: int, blocks, per_mcu: int, dcs, acs, restart: int,
              avail: int) -> bool:
    """Does libjpeg-turbo, decoding the blocks of a sequential scan's last
    interval from data[start:] to the end of the file (no marker after it:
    ``_decode_scan``'s at_eof), ever read ahead past that end, as Pillow
    feeds it? Pillow hands it the file ``PILLOW_BLOCK`` bytes at a time
    (``avail``: the end of what it has so far) and a read past them
    suspends the MCU, to be decoded again once the next block is in; past
    the end of the file there is none, and Pillow fails the file. dcs, acs:
    the scan's tables as ``_sym_lut`` gives them, by index in the scan."""
    ub, ends, multi_ff = bytearray(), [], []
    p, n = start, len(data)
    while p < n:
        c, q = data[p], p + 1
        if c == 0xFF:
            while q < n and data[q] == 0xFF:
                q += 1
            if q >= n:
                break  # 0xFF bytes that end the file: a marker libjpeg cannot finish
            multi_ff.append(q - p > 1)
            q += 1  # the stuffed 0x00
        else:
            multi_ff.append(False)
        ub.append(c)
        ends.append(q)
        p = q
    padded = bytes(ub) + bytes(8)
    n_units = len(ub)
    unit_end = [start] + ends  # file position after i units

    def code(bp, lut):
        i = bp >> 3
        w = int.from_bytes(padded[i:i + 4], "big")
        length, sym = lut[(w >> (16 - (bp & 7))) & 0xFFFF]
        return (length or 17), sym

    state = [0, 0, 0]  # bits consumed, units read, bits left in the buffer

    class Dry(Exception):
        pass

    def fill():  # jpeg_fill_bit_buffer: to MIN_GET_BITS, suspending at the buffer's end
        u, left = state[1], state[2]
        while left < _MIN_GET_BITS:
            if u >= n_units or ends[u] > avail[0]:
                raise Dry
            u += 1
            left += 8
        state[1], state[2] = u, left

    def need(k):
        if state[2] < k:
            fill()

    def take(k):
        state[0] += k
        state[2] -= k

    def huff_slow(lut):
        need(8)  # HUFF_DECODE: the lookahead (a marker is never met here)
        length, sym = code(state[0], lut)
        if length <= 8:
            take(length)
            return sym
        need(9)  # jpeg_huff_decode: min_bits 9, then a bit at a time
        take(9)
        for _ in range(length - 9):
            need(1)
            take(1)
        return sym

    def fill_fast():  # FILL_BIT_BUFFER_FAST; a 0xFF 0xFF pair reads as a marker
        if state[2] <= 16:
            for _ in range(6):
                u = state[1]
                if u >= n_units or multi_ff[u]:
                    raise Dry  # decode_mcu_fast backs out: the slow path decodes the MCU
                state[1] = u + 1
                state[2] += 8

    def huff_fast(lut):
        fill_fast()
        length, sym = code(state[0], lut)
        take(length)
        return sym

    def mcu(ms, huff, get):
        for blk in ms:
            ci = blk[1]
            s = huff(dcs[ci])
            if s:
                get(s)
            k = 1
            while k < 64:
                rs = huff(acs[ci])
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    get(s)
                elif r != 15:
                    break
                else:
                    k += 15
                k += 1

    def get_slow(s):
        need(s)
        take(s)

    def get_fast(s):
        fill_fast()
        take(s)

    avail = [min(avail, n)]
    for m in range(0, len(blocks), per_mcu):
        ms = blocks[m:m + per_mcu]
        while True:
            saved = list(state)
            try:
                fast = not restart and avail[0] - unit_end[state[1]] >= _BUFSIZE * per_mcu
                if fast:
                    try:
                        mcu(ms, huff_fast, get_fast)
                        break
                    except Dry:
                        state[:] = saved  # a marker: decoded again by the slow path
                mcu(ms, huff_slow, get_slow)
                break
            except Dry:  # suspended: Pillow's next block, or the end of the file
                state[:] = saved
                if avail[0] >= n:
                    return True
                avail[0] = min(avail[0] + PILLOW_BLOCK, n)
    return False


def _decode_scan(fr, body, data, pos, qt, dc_tabs, ac_tabs, restart, fill=False,
                 limit=PILLOW_BLOCK) -> int:
    """Decode one sequential scan starting at data[pos] into fr.coef ->
    the position of the marker after its entropy-coded data. fill: libjpeg
    over a whole buffer (``_Walk``); limit: the end of Pillow's reads so
    far (``_runs_dry``)."""
    ns = body[0] if body else 0
    if ns < 1 or ns > len(fr.ids) or len(body) != 4 + 2 * ns or \
            len(set(body[1:1 + 2 * ns:2])) != ns:  # at most 4, each once, as libjpeg
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
    # Ss, Se, Ah, Al other than 0, 63, 0, 0: JWRN_NOT_SEQUENTIAL, read as they were
    dsyms = [_sym_lut(*dc_tabs[t >> 4], True) for t in body[2:2 + 2 * ns:2]]
    asyms = [_sym_lut(*ac_tabs[t & 15], False) for t in body[2:2 + 2 * ns:2]]

    blocks, per_mcu = _scan_blocks(fr, comps)
    n_mcu = len(blocks) // per_mcu
    span = restart if restart else n_mcu
    n_int = -(-n_mcu // span)
    walk = _Walk(data, pos, fill, frame=fr if fr.tiff == "ojpeg" else None)
    out_ac, out_dc, decoded = [], [], []
    run = _huffman_intervals(walk, n_int)
    step = next(run, None)
    while step is not None:
        i, words, bits, at_eof = step
        mine = blocks[i * span * per_mcu:(i + 1) * span * per_mcu]
        n0 = len(out_dc)
        used = _decode_interval(words, mine, dcls, acls, [0] * ns, out_ac, out_dc, per_mcu, bits)
        decoded.extend(mine[:len(out_dc) - n0])
        if at_eof and used > bits:
            raise _corrupt("truncated data (the scan ends before its last block)")
        if at_eof and _runs_dry(data, walk.at, mine, per_mcu, dsyms, asyms, restart, max(
                limit, PILLOW_BLOCK * (1 + (walk.at - 1) // PILLOW_BLOCK))):
            raise _corrupt("truncated data (Pillow's libjpeg reads ahead past the end of "
                           "the file)")
        step = _send(run, used)
    blk = np.fromiter((b for b, _ in decoded), np.int64, len(decoded))
    fr.coef[blk * 64] = np.asarray(out_dc, np.int64).astype(np.int16)  # JCOEF
    ac = np.asarray(out_ac, np.int64)
    zz = np.minimum((ac >> 16) & 127, 63)  # past 63: libjpeg's padded natural order
    fr.coef[(ac >> 23) * 64 + zz] = (ac & 0xFFFF).astype(np.uint16).view(np.int16)
    return walk.end()


def _send(gen, value):
    try:
        return gen.send(value)
    except StopIteration:
        return None


def _decode_progressive_scan(fr, body, data, pos, qt, dc_tabs, ac_tabs, restart,
                             fill=False) -> int:
    """Decode one progressive scan starting at data[pos] into fr.pcoef ->
    the position of the marker after its entropy-coded data. fill: as
    ``_decode_scan``'s."""
    ns = body[0] if body else 0
    if ns < 1 or ns > len(fr.ids) or len(body) != 4 + 2 * ns or \
            len(set(body[1:1 + 2 * ns:2])) != ns:  # at most 4, each once, as libjpeg
        raise _corrupt("bad SOS segment")
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    # jdphuff.c start_pass_phuff_decoder's checks (a scan out of the
    # progression's order is JWRN_BOGUS_PROGRESSION: read as it is)
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
        for k in range(min(ss, 1), max(se, 9) + 1):  # jdphuff.c start_pass
            fr.prev_bits[c][k] = fr.coef_bits[c][k] if fr.scans > 1 else 0
        for k in range(ss, se + 1):
            fr.coef_bits[c][k] = al

    blocks, per_mcu = _scan_blocks(fr, comps)
    n_mcu = len(blocks) // per_mcu
    span = restart if restart else n_mcu
    n_int = -(-n_mcu // span)
    walk = _Walk(data, pos, fill, frame=fr if fr.tiff == "ojpeg" else None)
    last, good = [None], None
    run = _huffman_intervals(walk, n_int)
    step = next(run, None)
    while step is not None:
        i, words, bits, at_eof = step
        rd = _Bits(words)
        _progressive_interval(rd, blocks[i * span * per_mcu:(i + 1) * span * per_mcu],
                              luts, fr.pcoef, ss, se, ah, al, per_mcu, bits, last)
        good = last[0]
        if at_eof and rd.used() > bits:
            raise _corrupt("truncated data (the scan ends before its last block)")
        step = _send(run, rd.used())
    if good is not None:
        # libjpeg-turbo's last_good_iMCU_row (jdcoefct.c): the iMCU row of
        # the last MCU decoded with data
        blk, ci = good
        c = comps[ci]
        fr.last_good = (blk - fr.offset[c] // fr.per) // fr.bw[c] // fr.v[c]
    return walk.end()


# the quantizer positions (natural order) jdcoefct.c:smoothing_ok needs
# nonzero, and the coefficients whose precision it looks at
_SMOOTH_Q = (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)
_SMOOTH_COEFS = 10


# jdcoefct.c decompress_smooth_data: each estimated coefficient's zigzag
# position, its coef_bits index, and the weights of the 5 x 5 DC values
# around the block (rows above to below, columns left to right), without
# and with DC interpolation (only when no AC coefficient was ever scanned)
def _weights(pairs):
    w = np.zeros(25, np.int64)
    for k, v in pairs:
        w[k - 1] = v
    return w


_SMOOTH_AC = (
    (1, _weights([(11, -7), (12, 50), (14, -50), (15, 7)]),  # AC01
     _weights([(1, -1), (2, -1), (4, 1), (5, 1), (6, -3), (7, 13), (9, -13), (10, 3),
               (11, -3), (12, 38), (14, -38), (15, 3), (16, -3), (17, 13), (19, -13), (20, 3),
               (21, -1), (22, -1), (24, 1), (25, 1)])),
    (2, _weights([(3, -7), (8, 50), (18, -50), (23, 7)]),  # AC10
     _weights([(1, -1), (2, -3), (3, -3), (4, -3), (5, -1), (6, -1), (7, 13), (8, 38),
               (9, 13), (10, -1), (16, 1), (17, -13), (18, -38), (19, -13), (20, 1), (21, 1),
               (22, 3), (23, 3), (24, 3), (25, 1)])),
    (3, _weights([(3, -1), (8, 13), (13, -24), (18, 13), (23, -1)]),  # AC20
     _weights([(3, 1), (7, 2), (8, 7), (9, 2), (12, -5), (13, -14), (14, -5), (17, 2),
               (18, 7), (19, 2), (23, 1)])),
    (4, _weights([(10, 1), (16, 1), (17, -10), (19, 10), (2, -1), (20, -1), (22, 1),  # AC11
                  (24, -1), (4, 1), (6, -1), (7, 10), (9, -10)]),
     _weights([(1, -1), (5, 1), (7, 9), (9, -9), (17, -9), (19, 9), (21, 1), (25, -1)])),
    (5, _weights([(11, -1), (12, 13), (13, -24), (14, 13), (15, -1)]),  # AC02
     _weights([(7, 2), (8, -5), (9, 2), (11, 1), (12, 7), (13, -14), (14, 7), (15, 1),
               (17, 2), (18, -5), (19, 2)])),
    (6, None, _weights([(7, 1), (9, -1), (12, 2), (14, -2), (17, 1), (19, -1)])),  # AC03
    (7, None, _weights([(7, 1), (8, -3), (9, 1), (17, -1), (18, 3), (19, -1)])),  # AC12
    (8, None, _weights([(7, 1), (9, -1), (12, -3), (14, 3), (17, 1), (19, -1)])),  # AC21
    (9, None, _weights([(7, 1), (8, 2), (9, 1), (17, -1), (18, -2), (19, -1)])),  # AC30
)
_SMOOTH_DC = _weights([(1, -2), (2, -6), (3, -8), (4, -6), (5, -2), (6, -6), (7, 6), (8, 42),
                       (9, 6), (10, -6), (11, -8), (12, 42), (13, 152), (14, 42), (15, -8),
                       (16, -6), (17, 6), (18, 42), (19, 6), (20, -6), (21, -2), (22, -6),
                       (23, -8), (24, -6), (25, -2)])


def _smooth_rows(v: int, total: int, height: int):
    """The block rows decompress_smooth_data outputs and each one's five
    rows of DC values (two above to two below), with its clamping at the
    image's edges, quirk included: in the last iMCU row, short of
    ``v`` block rows, its row numbers are counted in that row's height."""
    out = []
    for i in range(total):
        rows = v if i < total - 1 else (height % v or v)
        count = rows * total
        for b in range(rows):
            at, row = i * rows + b, i * v + b
            up = row - 1 if at > 0 else row
            up2 = row - 2 if at > 1 else up
            down = row + 1 if at < count - 1 else row
            down2 = row + 2 if at < count - 2 else down
            out.append((row, (up2, up, row, down, down2)))
    return out


def _smooth_rows_21(v: int, total: int, height: int):
    """``_smooth_rows`` as libjpeg-turbo 2.1 takes them (its native
    extension's libjpeg): a row two above or below is read only where the
    iMCU rows accessed hold it: in the second iMCU row the row two above is
    the row above, in the one before the last the row two below the row
    below."""
    out = []
    for i in range(total):
        rows = v if i < total - 1 else (height % v or v)
        for b in range(rows):
            row = i * v + b
            up = row - 1 if b > 0 or i > 0 else row
            up2 = row - 2 if b > 1 or i > 1 else up
            down = row + 1 if b < rows - 1 or i < total - 1 else row
            down2 = row + 2 if b < rows - 2 or i + 1 < total - 1 else down
            out.append((row, (up2, up, row, down, down2)))
    return out


def _smooth_cols_21(cols: int) -> np.ndarray:
    """The five DC columns around each block as libjpeg-turbo 2.1 slides
    them, five registers shifted left after each block: all start at
    column 0; the first block of a row wider than one block reads column 1
    into the fourth, block b reads column b + 2 into the fifth only while
    b + 1 < cols - 1 (so in a two-block row the fifth stays column 0)."""
    regs, out = [0] * 5, []
    for b in range(cols):
        if b == 0 and b < cols - 1:
            regs[3] = 1
        if b + 1 < cols - 1:
            regs[4] = b + 2
        out.append(list(regs))
        regs = regs[1:] + regs[4:]
    return np.array(out, np.int64)


def _smooth(fr: _Frame) -> np.ndarray:
    """jdcoefct.c decompress_smooth_data over a progressive frame whose low
    AC coefficients are not all refined (``_smoothed``): in each block
    still zero at one of the first nine AC positions, that coefficient
    estimated from the 5 x 5 DC values around it, within 2^Al - 1 of
    zero, and, where no AC coefficient was ever scanned, the DC smoothed
    too; the DC values read are the coded ones -> the coefficients to
    transform."""
    coef = fr.coef.copy()
    for c in range(len(fr.ids)):
        q = fr.quant[c]
        grid = fr.coef[fr.offset[c]:fr.offset[c + 1]].reshape(fr.bh[c], fr.bw[c], 64)
        out = coef[fr.offset[c]:fr.offset[c + 1]].reshape(fr.bh[c], fr.bw[c], 64)
        w, h = fr.downsampled(c)
        cols, height = -(-w // 8), -(-h // 8)
        rows = (_smooth_rows_21 if fr.window21 else _smooth_rows)(fr.v[c], fr.mcuy, height)
        r, nb = np.array([x for x, _ in rows]), np.array([y for _, y in rows])
        x5 = _smooth_cols_21(cols) if fr.window21 else \
            np.clip(np.arange(cols)[:, None] + np.arange(-2, 3), 0, cols - 1)
        dc = grid[:, :, 0][nb[:, :, None, None], x5[None, None]]  # [rows, 5, cols, 5]
        dc = dc.transpose(0, 2, 1, 3).reshape(len(rows), cols, 25)
        ws = _estimate(out[r, :cols], dc, fr.coef_bits[c][:_SMOOTH_COEFS], q)
        if fr.last_good is not None:
            # libjpeg-turbo 2.1: the iMCU rows past the last one decoded with
            # data take the coefficient bits from before the last scan
            late = r // fr.v[c] > fr.last_good
            if late.any():
                prev = [-1] * _SMOOTH_COEFS if fr.scans <= 1 else fr.prev_bits[c][:_SMOOTH_COEFS]
                ws[late] = _estimate(out[r, :cols], dc, prev, q)[late]
        out[r, :cols] = ws
    return coef


def _estimate(blocks: np.ndarray, dc: np.ndarray, bits, q) -> np.ndarray:
    """decompress_smooth_data's estimates for one component's output rows
    of blocks [rows, cols, 64] from their 5 x 5 DC values ``dc``, under the
    coefficient bits ``bits`` (positions 1-9 read)."""
    change_dc = all(b == -1 for b in bits[1:])
    ws = blocks.copy()
    for zz, plain, interp in _SMOOTH_AC:
        al = bits[zz]
        weights = interp if change_dc else plain
        if al == 0 or weights is None:
            continue
        qk = int(q[_ZIGZAG[zz]])
        num = int(q[0]) * (dc @ weights)
        mag = ((qk << 7) + np.abs(num)) // (qk << 8)
        if al > 0:
            mag = np.minimum(mag, (1 << al) - 1)
        pred = np.where(num >= 0, mag, -mag)
        ws[..., zz] = np.where(ws[..., zz] == 0, ((pred + 32768) & 0xFFFF) - 32768,
                               ws[..., zz])
    if change_dc:
        num = int(q[0]) * (dc @ _SMOOTH_DC)
        mag = ((int(q[0]) << 7) + np.abs(num)) // (int(q[0]) << 8)
        ws[..., 0] = ((np.where(num >= 0, mag, -mag) + 32768) & 0xFFFF) - 32768
    return ws


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


def _tables(marker: int, body: bytes, qt: dict, dc_tabs: dict, ac_tabs: dict, dac,
            restart: int) -> int:
    """A DAC, DHT, DQT or DRI segment (jdmarker.c get_dac, get_dht, get_dqt,
    get_dri) into the tables -> the restart interval."""
    if marker == 0xCC:  # DAC
        if len(body) % 2:
            raise _corrupt("bad DAC segment")
        for i in range(0, len(body), 2):
            index, val = body[i], body[i + 1]
            if index >= 32 or (index < 16 and val & 15 > val >> 4):
                raise _corrupt("bad DAC segment")
            if index >= 16:
                dac[2][index - 16] = val
            else:
                dac[0][index], dac[1][index] = val & 15, val >> 4
    elif marker == 0xC4:  # DHT
        i = 0
        while i < len(body):
            tc_th, counts = body[i], body[i + 1:i + 17]
            n = sum(counts)
            if len(counts) < 16 or i + 17 + n > len(body) or tc_th >> 4 > 1 or \
                    tc_th & 15 > 3 or n > 256:
                raise _corrupt("bad DHT segment")
            (ac_tabs if tc_th >> 4 else dc_tabs)[tc_th & 15] = (
                bytes(counts), bytes(body[i + 17:i + 17 + n]))
            i += 17 + n
    elif marker == 0xDB:  # DQT
        i = 0
        while i < len(body):
            pq, tq = body[i] >> 4, body[i] & 15
            size = 128 if pq else 64
            if i + 1 + size > len(body) or tq > 3:
                raise _corrupt("bad DQT segment")
            q = np.frombuffer(body[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
            qt[tq] = q.astype(np.int64)[_UNZIGZAG]  # natural order
            i += 1 + size
    else:  # DRI
        if len(body) != 2:
            raise _corrupt("bad DRI segment")
        restart = int.from_bytes(body, "big")
    return restart


# jstdhuff.c's tables (T.81 K.3): DC and AC, luminance (0) and chrominance (1)
_STD_DC = {
    0: (bytes.fromhex("00010501010101010100000000000000"), bytes(range(12))),
    1: (bytes.fromhex("00030101010101010101010000000000"), bytes(range(12))),
}
_STD_AC = {
    0: (bytes.fromhex("0002010303020403050504040000017d"), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718"
        "191a25262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475"
        "767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    1: (bytes.fromhex("00020102040403040705040400010277"), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125"
        "f11718191a262728292a35363738393a434445464748494a535455565758595a636465666768696a7374"
        "75767778797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9ba"
        "c2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}


def _start_scan(fr, body: bytes, scans: int, multi: bool, dc_tabs: dict, ac_tabs: dict) -> bool:
    """An SOS marker's checks before its scan -> has_multiple_scans. The
    first starts the decompression: jdinput.c decides whether the file has
    more than one scan (progressive, or a first scan short of a component),
    and a sequential Huffman frame's decoder (jdhuff.c jinit_huff_decoder)
    takes jstdhuff.c's tables into the DC and AC slots 0 and 1 left
    undefined. A second scan where only one was to come is libjpeg's
    JERR_EOI_EXPECTED."""
    if fr is None:
        raise _corrupt("scan before the frame header")
    if scans == 0:
        if not (fr.progressive or fr.arith or fr.lossless):
            for t in (0, 1):
                dc_tabs.setdefault(t, _STD_DC[t])
                ac_tabs.setdefault(t, _STD_AC[t])
        return fr.progressive or (body[0] if body else 0) < len(fr.ids)
    if not multi:
        raise _corrupt("a second scan in a single-scan file (libjpeg: more than one "
                       "scan not expected)")
    return multi


def _tail_end(data: bytes, end: int, limit: int, arith: bool) -> int:
    """The end of what Pillow has handed libjpeg once a single-scan image's
    scan is decoded: the blocks of ``PILLOW_BLOCK`` bytes up to the code of
    the marker after the scan's data, which the Huffman decoder reads
    ahead to (and ``limit``, the blocks read so far, for an
    arithmetic-coded scan, which reads no further than it decodes)."""
    if arith:
        return min(limit, len(data))
    m = _MARKER.search(data, end)
    if m is None:
        return len(data)
    return min(max(limit, PILLOW_BLOCK * (1 + (m.end() - 1) // PILLOW_BLOCK)), len(data))


def _runs_out(marker: int, seg: bytes) -> bool:
    """Does libjpeg, reading a marker segment cut short by the end of the
    file (``seg``: its length field on), run out of data before it finds
    fault with it (jdmarker.c get_dht, get_dri, get_dqt, get_dac, get_sos;
    the rest are skipped; a second SOF fails at once)?"""
    if len(seg) < 2:
        return True
    n = int.from_bytes(seg[:2], "big") - 2
    body = seg[2:]
    if marker == 0xDD:  # get_dri checks the length first
        return n == 2
    if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
        return False
    if marker == 0xC4:  # get_dht: each table's counts, then its symbols
        i = 0
        while n > 16:
            if i + 17 > len(body):
                return True
            count = sum(body[i + 1:i + 17])
            n -= 17
            if count > 256 or count > n:
                return False
            if i + 17 + count > len(body):
                return True
            if body[i] & 0x0F > 3 or body[i] >> 4 > 1:
                return False
            n -= count
            i += 17 + count
        return False  # a length left over (all read: the segment was not cut)
    if marker == 0xDB:  # get_dqt: a table index past 3
        return not body or body[0] & 0x0F <= 3
    if marker == 0xCC:  # get_dac: an index past 31 or a bad L, U pair
        for i in range(0, len(body) - 1, 2):
            index, val = body[i], body[i + 1]
            if index >= 32 or (index < 16 and val & 15 > val >> 4):
                return False
        return True
    if marker == 0xDA:  # get_sos: its length against its component count
        return not body or (1 <= body[0] <= 4 and n == 4 + 2 * body[0])
    return True


def jpeg_decode_rgb(data: bytes, host_cpp: bool = False, libjpeg: bool = False) -> np.ndarray:
    """JPEG file bytes -> uint8 [H, W, 3], equal to Pillow's
    ``Image.open(f).convert("RGB")`` (libjpeg-turbo: ISLOW IDCT, fancy
    upsampling, block smoothing). Raises ValueError on what it does not
    read (see the module docstring), naming ROADMAP item 26, and where
    Pillow fails the file.

    host_cpp: the whole decode in one call of the host C++
    ``l2i_jpeg_decode`` (ops/csrc/jpeg_huffman.cpp, built with the kernels at
    first use; a failed build raises), the same function bit for bit with
    the same errors; the Python and numpy version of this module runs
    otherwise, and stays the plain version the tests hold it to. The card's
    entry points ask for it.

    libjpeg: decode as libjpeg-turbo 2.1 alone does from a whole buffer
    (``jpeg_mem_src``, ``out_color_space = JCS_RGB``), the JAX package's
    native extension: where the data runs out the buffer's fake EOI marker
    supplies zeros (``_Walk``), so a truncated file decodes; no
    Pillow block limit, bomb check or missing-EOI test; 4-component (CMYK,
    YCCK) and lossless files fail, as they do there. Only whether a file
    fails matters on that path, not which error it raises."""
    data = bytes(data)
    if host_cpp:
        return _decode_c(data, libjpeg)
    if libjpeg:
        return _decode_libjpeg(data)
    if data[:3] != b"\xff\xd8\xff":  # Pillow's test: SOI and a marker
        raise _corrupt("not a JPEG file (no SOI marker)")
    qt, dc_tabs, ac_tabs = {}, {}, {}
    dac = ([0] * 16, [1] * 16, [5] * 16)  # arithmetic conditioning: L, U, K
    restart, jfif, adobe = 0, False, None
    fr, eoi, limit, scans, multi = None, False, PILLOW_BLOCK, 0, True
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
        if marker == 0x00 or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0x01 and scans:  # TEM (Pillow's own parser refuses it before a scan)
            continue
        if marker < 0xC0 or marker in (0xC8, 0xD8, 0xDE, 0xDF) or 0xF0 <= marker <= 0xFD:
            raise _corrupt(f"marker 0x{marker:02X} where libjpeg and Pillow take none")
        if marker in _SOF_REFUSED:
            raise _refuse(_SOF_REFUSED[marker])
        try:
            body, after = _segment(data, pos)
        except ValueError:
            if not multi and _runs_out(marker, data[pos:]):
                break  # a single-scan image is out: jpeg_finish_decompress suspends,
            raise      # and Pillow keeps the image
        while after > limit:  # libjpeg suspends in a marker; Pillow reads on
            limit += PILLOW_BLOCK
        if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA):
            if fr is not None:
                raise _corrupt("a second frame")
            fr = _Frame(body, progressive=marker in (0xC2, 0xCA), arith=marker >= 0xC9,
                        lossless=marker == 0xC3)
        elif marker in (0xCC, 0xC4, 0xDB, 0xDD):
            restart = _tables(marker, body, qt, dc_tabs, ac_tabs, dac, restart)
        elif marker == 0xDC:
            raise _refuse("DNL-height")
        elif marker == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:  # SOS
            multi = _start_scan(fr, body, scans, multi, dc_tabs, ac_tabs)
            scans += 1
            fr.scans = scans
            if fr.lossless:
                after = _decode_lossless_scan(fr, body, data, after, dc_tabs, restart)
            elif fr.arith:
                after = _decode_arith_scan(fr, body, data, after, qt, restart, dac, limit)
            else:
                if fr.progressive:
                    after = _decode_progressive_scan(fr, body, data, after, qt, dc_tabs,
                                                     ac_tabs, restart)
                else:
                    after = _decode_scan(fr, body, data, after, qt, dc_tabs, ac_tabs, restart,
                                         limit=limit)
            if not multi:  # the image is out: jpeg_finish_decompress reads the
                # rest from Pillow's read so far, and a suspension ends the decode
                data = data[:_tail_end(data, after, limit, fr.arith)]
        pos = after
    if fr is None or not all(fr.scanned):
        raise _corrupt("truncated data (no scan for every component)")
    if multi and not eoi and not fr.lossless:  # more scans may have been to come:
        # jpeg_start_decompress reads to the EOI before any output
        raise _corrupt(f"truncated data (a {'progressive' if fr.progressive else 'multi-scan'} "
                       "file with no EOI)")
    if fr.lossless:
        if multi and not eoi:  # jpeg_start_decompress reads a multi-scan file to its EOI
            raise _corrupt("truncated data (a lossless file with no EOI)")
        return _assemble_lossless(fr, jfif, adobe)
    if fr.progressive or fr.arith:
        fr.coef = np.asarray(fr.pcoef, np.int64)
    if fr.progressive and _smoothed(fr):
        fr.coef = _smooth(fr)
    return _assemble(fr, jfif, adobe)


# fake EOI markers: what jpeg_mem_src reads past the end of its buffer
_FAKE_EOI = b"\xff\xd9" * 32768


def _libjpeg_marker(data: bytes, pos: int):
    """jdmarker.c next_marker from ``pos`` -> (the marker, the position
    after it), or None where the data ends first; a marker libjpeg-turbo
    fails raises."""
    nxt = data.find(b"\xff", pos)
    if nxt < 0:
        return None
    pos = nxt + 1
    while pos < len(data) and data[pos] == 0xFF:
        pos += 1
    if pos >= len(data):
        return None
    marker = data[pos]
    if marker in _SOF_REFUSED or marker in (0xC3, 0xC8) or (0x01 < marker < 0xC0) or \
            marker in (0xD8, 0xDE, 0xDF) or 0xF0 <= marker <= 0xFD:
        raise _corrupt(f"marker 0x{marker:02X}: libjpeg-turbo fails it")
    return marker, pos + 1


def _libjpeg_tables(tables: bytes):
    """A TIFF's JPEGTables as libtiff has libjpeg read them
    (tif_jpeg.c:JPEGSetupDecode): a stream of their own from their own
    source, which supplies fake EOI markers where the tag's bytes end, even
    inside a segment; ``jpeg_read_header(FALSE)`` must reach its EOI before
    any scan -> the quantisation and Huffman tables (qt, dc, ac), which
    the strips' own streams keep."""
    if tables[:2] != b"\xff\xd8":
        raise _corrupt("JPEGTables without an SOI marker (libtiff fails it)")
    data = tables + _FAKE_EOI
    qt, dc_tabs, ac_tabs = {}, {}, {}
    dac = ([0] * 16, [1] * 16, [5] * 16)
    pos, frame = 2, False
    while True:
        marker, pos = _libjpeg_marker(data, pos)
        if marker == 0xD9:
            return qt, dc_tabs, ac_tabs
        if marker in (0x00, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        body, pos = _segment(data, pos)
        if marker == 0xDA:
            raise _corrupt("a scan in JPEGTables (libtiff: bogus JPEGTables field)")
        if marker in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
            if frame:
                raise _corrupt("a second frame")
            _Frame(body, progressive=marker in (0xC2, 0xCA), arith=marker >= 0xC9, libjpeg=True)
            frame = True
        elif marker in (0xCC, 0xC4, 0xDB, 0xDD):
            _tables(marker, body, qt, dc_tabs, ac_tabs, dac, 0)


def _decode_libjpeg(data: bytes, tiff=None, tables=None) -> np.ndarray:
    """``jpeg_decode_rgb(data, libjpeg=True)``: jdmarker.c's read_markers
    (RSTn and TEM outside a scan skipped, DNL skipped, SOF3, JPG and other
    unknown markers an error), a marker segment past the end read from the
    fake EOI bytes, each scan through its decoder with ``fill``. tiff: a
    TIFF strip's colour mode (``_Frame``); libtiff ignores what
    ``jpeg_finish_decompress`` fails once a single-scan strip's rows are
    out (tif_jpeg.c's CALLJPEG returns -1 there, which JPEGDecode takes for
    success), so nothing after such a scan is read. tables: the
    quantisation and Huffman tables loaded before the stream
    (``_libjpeg_tables``)."""
    if data[:2] != b"\xff\xd8":
        raise _corrupt("not a JPEG file (no SOI marker)")
    qt, dc_tabs, ac_tabs = ({}, {}, {}) if tables is None else (dict(t) for t in tables)
    dac = ([0] * 16, [1] * 16, [5] * 16)
    restart, jfif, adobe = 0, False, None
    fr, scans, pos, multi = None, 0, 2, True
    while pos < len(data):
        found = _libjpeg_marker(data, pos)
        if found is None:
            break
        marker, pos = found
        if marker == 0xD9:
            break
        if marker in (0x00, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        try:
            body, after = _segment(data, pos)
        except ValueError:  # the segment runs into the fake EOI bytes, and so
            data += _FAKE_EOI  # does what follows it
            body, after = _segment(data, pos)
        if marker in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
            if fr is not None:
                raise _corrupt("a second frame")
            fr = _Frame(body, progressive=marker in (0xC2, 0xCA), arith=marker >= 0xC9,
                        libjpeg=True, tiff=tiff)
        elif marker in (0xCC, 0xC4, 0xDB, 0xDD):
            restart = _tables(marker, body, qt, dc_tabs, ac_tabs, dac, restart)
        elif marker == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            multi = _start_scan(fr, body, scans, multi, dc_tabs, ac_tabs)
            scans += 1
            fr.scans = scans
            if fr.arith:
                after = _decode_arith_scan(fr, body, data, after, qt, restart, dac, 0, True)
            else:
                scan = _decode_progressive_scan if fr.progressive else _decode_scan
                after = scan(fr, body, data, after, qt, dc_tabs, ac_tabs, restart, True)
            if tiff is not None and not multi:
                break
        pos = after
    if not scans:  # jpeg_read_header's JERR_NO_IMAGE
        raise _corrupt("no scan before the end of the data")
    if fr.progressive or fr.arith:
        fr.coef = np.asarray(fr.pcoef, np.int64)
    if fr.progressive and _smoothed(fr):
        fr.coef = _smooth(fr)
    return _assemble(fr, jfif, adobe)


def jpeg_tiff_chunk(tables: bytes, strip: bytes, ycbcr: bool, width: int, rows: int,
                    nbytes: int) -> np.ndarray:
    """One strip or tile of a JPEG-compressed TIFF (compression 7) as
    libtiff's codec has libjpeg decode it: the JPEGTables, where the tag has
    bytes, read first as a stream of their own (``_libjpeg_tables``), then
    the strip's stream with those tables loaded, each read from memory with
    a fake EOI past the end, YCbCr converted to RGB where libtiff asks for
    that (photometric 6, chunky), the components as they are otherwise ->
    uint8 rows [rows, width x nbytes]."""
    loaded = _libjpeg_tables(tables) if tables else None
    img = _decode_libjpeg(strip, "ycc" if ycbcr else "raw", loaded)
    if img.shape[0] < rows or img.shape[1] < width or img.shape[2] != nbytes:
        raise _corrupt(f"a {img.shape[1]}x{img.shape[0]}x{img.shape[2]} JPEG strip where "
                       f"{width}x{rows}x{nbytes} is due")
    return np.ascontiguousarray(img[:rows, :width]).reshape(rows, width * nbytes)


def _assemble(fr: _Frame, jfif: bool, adobe) -> np.ndarray:
    """IDCT, upsampling and colour conversion of a decoded frame (a TIFF
    strip's as its ``fr.tiff`` says)."""
    planes = []
    for c in range(len(fr.ids)):
        coef = fr.coef[fr.offset[c]:fr.offset[c + 1]].reshape(-1, 64)[:, _UNZIGZAG]
        q = fr.quant[c] if fr.quant[c] is not None else np.zeros(64, np.int64)  # no scan
        blocks = _idct_islow_simd(coef.reshape(-1, 8, 8), q.reshape(8, 8))
        bh, bw = fr.bh[c], fr.bw[c]
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        if fr.tiff == "ojpeg":  # jpeg_read_raw_data: each component's blocks as they are
            planes.append(plane.astype(np.uint8))
            continue
        w, h = fr.downsampled(c)
        up = _upsample(plane[:h, :w], fr.hmax // fr.h[c], fr.vmax // fr.v[c])
        planes.append(up[:fr.height, :fr.width])
    if fr.tiff == "ojpeg":  # the planes, and the first restart interval libtiff fails
        return planes, fr.ojpeg_failed
    if fr.tiff == "raw":
        if len(set(zip(fr.h, fr.v))) > 1:
            raise _corrupt("subsampled components with no colour conversion (libtiff fails "
                           "them: improper JPEG sampling factors)")
        return np.stack(planes, -1).astype(np.uint8)
    if fr.tiff == "ycc":
        return _ycc_to_rgb(*planes)
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


def cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """Pillow's CMYK -> RGB (Convert.c:cmyk2rgb) on its CMYK values: nk =
    255 - K, each of R, G, B = nk - nk x C / 255 with MULDIV255 rounding."""
    nk = 255 - np.asarray(k, np.int64)
    out = [nk - _muldiv255(np.asarray(v, np.int64), nk) for v in (c, m, y)]
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


def _cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """libjpeg's CMYK samples as Pillow takes them (raw mode "CMYK;I":
    each inverted) and converts them to RGB."""
    return cmyk_to_rgb(*(255 - np.asarray(v, np.int64) for v in (c, m, y, k)))


# the C entry's error codes (jpeg_huffman.cpp) -> the Python version's errors
_C_ERRORS = {
    -10: lambda v: _corrupt("not a JPEG file (no SOI marker)"),
    -11: lambda v: _refuse(_SOF_REFUSED[v]),
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
    -32: lambda v: _corrupt("truncated data (fewer restart intervals than the image needs)"),
    -34: lambda v: _corrupt("truncated data (the scan ends before its last block)"),
    -36: lambda v: _corrupt("truncated data (no scan for every component)"),
    -38: lambda v: MemoryError("jpeg: out of memory"),
    -39: lambda v: _corrupt("bad progressive scan parameters"),
    -40: lambda v: _corrupt(f"truncated data (a {'progressive' if v else 'multi-scan'} "
                            "file with no EOI)"),
    -42: lambda v: _corrupt("bad DAC segment"),
    -43: lambda v: _pillow_block(),
    -44: lambda v: _corrupt(f"marker 0x{v:02X} where libjpeg and Pillow take none"),
    -45: lambda v: _corrupt("bad DRI segment"),
    -46: lambda v: _bomb(v >> 16, v & 0xFFFF),
    -47: lambda v: _corrupt("bad lossless scan parameters"),
    -48: lambda v: _corrupt("a restart interval of no whole number of MCU rows"),
    -49: lambda v: _corrupt("a lossless YCbCr file: libjpeg-turbo converts no colour in "
                            "lossless mode, and Pillow fails it"),
    -50: lambda v: _corrupt("a lossless YCCK file: libjpeg-turbo converts no colour in "
                            "lossless mode, and Pillow fails it"),
    -51: lambda v: _corrupt("truncated data (a lossless file with no EOI)"),
    -52: lambda v: _corrupt("a file libjpeg-turbo 2.1 fails (libjpeg mode)"),
    -53: lambda v: _corrupt("a second scan in a single-scan file (libjpeg: more than one "
                            "scan not expected)"),
    -54: lambda v: _corrupt("truncated data (Pillow's libjpeg reads ahead past the end of "
                            "the file)"),
}
_OUT_SIZE = -37


def _decode_c(data: bytes, libjpeg: bool = False) -> np.ndarray:
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
                                 out.size, info, int(libjpeg))
        if rc == 0:
            return out
        if rc != _OUT_SIZE:
            raise _C_ERRORS[rc](int(info[0]))
        shape = (int(info[0]), int(info[1]), 3)
    raise RuntimeError(f"l2i_jpeg_decode: no room for a {shape} frame after a second call")
