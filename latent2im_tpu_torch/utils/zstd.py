"""Zstandard (RFC 8878) decoding in Python and numpy, as libzstd 1.5.7
decodes it for Pillow 12.1's libtiff (tif_zstd.c): the GPU machine's
Python has no zstd module, and the port imports no decoder package.

    zstd_stream(data, need) -> (out bytes, error or None)

``zstd_stream`` is libtiff's ZSTDDecode: ``ZSTD_decompressStream`` into a
buffer of ``need`` bytes until it is full, the input is used up or the
frame ends; the strip fails where libzstd reports an error on the way, or
where the frame gives fewer bytes. What libzstd checks, and when:

- the frame header (magic, the reserved bit, a window log over 31 or a
  window over 2^27 + 1 bytes, a dictionary ID, which no dictionary
  matches); a skippable frame gives nothing;
- where the frame states its content size, the output can hold it and the
  whole frame lies in the input, the single-pass decoder: every block, the
  content size and the checksum; otherwise block by block, each decoded
  whole before its bytes are handed on: raw, RLE and compressed blocks,
  each no larger than min(window, 128 KiB), and a raw block cut by the
  end of the input handed on as far as it goes; once the output is full,
  the block under way is the last one read, or, where it ended exactly at
  the output's end, the next block with bytes (or the frame's end and
  its checksum);
- a compressed block: its literals (raw, RLE, or Huffman-coded in one or
  four streams with their own table or the last one's: ``HUF_readStats``'
  weights, direct or FSE-coded, each stream ending exactly at its start
  bit), then its sequences (``FSE_readNCount``'s normalised counts, the
  predefined, RLE, compressed or repeated tables of the literal length,
  offset and match length codes; the repeat offsets; each match inside
  the frame's output so far; the bit stream ending exactly), the block's
  output no larger than its maximum;
- the XXH64 checksum (its low 32 bits) where the frame has one.
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1
_MAGIC = 0xFD2FB528
_BLOCK_MAX = 1 << 17
_WINDOW_MAX = (1 << 27) + 1  # ZSTD_MAXWINDOWSIZE_DEFAULT
# a set that collects the names of the decoder's paths as they are taken,
# where a caller puts one here (the tests do); None: nothing is recorded
PATHS: set | None = None


class ZstdError(ValueError):
    """What libzstd reports as an error."""


# ---------------------------------------------------------------------------
# XXH64
# ---------------------------------------------------------------------------

_P1, _P2, _P3, _P4, _P5 = (11400714785074694791, 14029467366897019727, 1609587929392839161,
                           9650029242287828579, 2870177450012600261)


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``."""
    n, p = len(data), 0
    if n >= 32:
        v1, v2, v3, v4 = ((seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
                          (seed - _P1) & _M64)
        lanes = np.frombuffer(data[:n // 32 * 32], "<u8").tolist()
        for i in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        p = n // 32 * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# the backward bit stream (BIT_DStream_t)
# ---------------------------------------------------------------------------

class _Back:
    """libzstd's backward bit reader over src: a 64-bit container read from
    the end, ``consumed`` of its bits taken."""
    __slots__ = ("src", "ptr", "c", "consumed")

    def __init__(self, src: bytes):
        n = len(src)
        if n < 1:
            raise ZstdError("an empty bit stream")
        last = src[-1]
        if last == 0:
            raise ZstdError("a bit stream with no end mark")
        self.src = src
        if n >= 8:
            self.ptr = n - 8
            self.c = int.from_bytes(src[n - 8:], "little")
            self.consumed = 8 - last.bit_length() + 1
        else:
            self.ptr = 0
            self.c = int.from_bytes(src, "little")
            self.consumed = 8 - last.bit_length() + 1 + (8 - n) * 8

    def read(self, n: int) -> int:
        v = ((self.c << (self.consumed & 63)) & _M64) >> 1 >> ((63 - n) & 63)
        self.consumed += n
        return v

    def reload(self) -> int:
        """0 unfinished, 1 end of buffer, 2 completed, 3 overflow."""
        if self.consumed > 64:
            return 3
        if self.ptr >= 8:
            self.ptr -= self.consumed >> 3
            self.consumed &= 7
            self.c = int.from_bytes(self.src[self.ptr:self.ptr + 8], "little")
            return 0
        if self.ptr == 0:
            return 1 if self.consumed < 64 else 2
        nb, res = self.consumed >> 3, 0
        if self.ptr - nb < 0:
            nb, res = self.ptr, 1
        self.ptr -= nb
        self.consumed -= nb * 8
        self.c = int.from_bytes(self.src[self.ptr:self.ptr + 8], "little")
        return res

    def ended(self) -> bool:
        return self.ptr == 0 and self.consumed == 64


# ---------------------------------------------------------------------------
# FSE tables
# ---------------------------------------------------------------------------

def _highbit(v: int) -> int:
    return v.bit_length() - 1


def _read_ncount(src: bytes, max_sv: int):
    """FSE_readNCount -> (normalised counts, max symbol, table log, bytes
    read); ZstdError where libzstd fails it."""
    if len(src) < 8:
        norm, msv, log, size = _read_ncount(bytes(src) + bytes(8 - len(src)), max_sv)
        if size > len(src):
            raise ZstdError("a short FSE table description")
        return norm, msv, log, size
    end = len(src)

    def le32(p):
        return int.from_bytes(src[p:p + 4], "little")

    norm = [0] * (max_sv + 1)
    ip = 0
    bs = le32(0)
    nbits = (bs & 0xF) + 5
    if nbits > 15:
        raise ZstdError("an FSE table log past 15")
    bs >>= 4
    bc = 4
    log = nbits
    remaining = (1 << nbits) + 1
    threshold = 1 << nbits
    nbits += 1
    charnum, max1, prev0 = 0, max_sv + 1, False
    while True:
        if prev0:
            repeats = ((~bs | 0x80000000) & -(~bs | 0x80000000)).bit_length() - 1 >> 1
            while repeats >= 12:
                charnum += 3 * 12
                if ip <= end - 7:
                    ip += 3
                else:
                    bc -= 8 * (end - 7 - ip)
                    bc &= 31
                    ip = end - 4
                bs = le32(ip) >> bc
                repeats = ((~bs | 0x80000000) & -(~bs | 0x80000000)).bit_length() - 1 >> 1
            charnum += 3 * repeats
            bs >>= 2 * repeats
            bc += 2 * repeats
            charnum += bs & 3
            bc += 2
            if charnum >= max1:
                break
            if ip <= end - 7 or ip + (bc >> 3) <= end - 4:
                ip += bc >> 3
                bc &= 7
            else:
                bc -= 8 * (end - 4 - ip)
                bc &= 31
                ip = end - 4
            bs = le32(ip) >> bc
        mx = (2 * threshold - 1) - remaining
        if (bs & (threshold - 1)) < mx:
            count = bs & (threshold - 1)
            bc += nbits - 1
        else:
            count = bs & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bc += nbits
        count -= 1
        remaining -= count if count >= 0 else -count
        norm[charnum] = count
        charnum += 1
        prev0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nbits = _highbit(remaining) + 1
            threshold = 1 << (nbits - 1)
        if charnum >= max1:
            break
        if ip <= end - 7 or ip + (bc >> 3) <= end - 4:
            ip += bc >> 3
            bc &= 7
        else:
            bc -= 8 * (end - 4 - ip)
            bc &= 31
            ip = end - 4
        bs = le32(ip) >> bc
    if remaining != 1:
        raise ZstdError("FSE counts that do not fill the table")
    if charnum > max1:
        raise ZstdError("FSE counts past the largest symbol")
    if bc > 32:
        raise ZstdError("a bad FSE table description")
    ip += (bc + 7) >> 3
    return norm[:charnum], charnum - 1, log, ip


def _spread(norm, log: int):
    """The symbols' cells (FSE_buildDTable's spread) -> (symbol of each
    cell, each symbol's first next state)."""
    size = 1 << log
    cells = [0] * size
    high = size - 1
    nxt = []
    for s, n in enumerate(norm):
        if n == -1:
            cells[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(n)
    step = (size >> 1) + (size >> 3) + 3
    mask, pos = size - 1, 0
    for s, n in enumerate(norm):
        for _ in range(max(n, 0)):
            cells[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE counts that do not spread")
    return cells, nxt


def _fse_table(norm, log: int):
    """FSE_buildDTable -> [(symbol, nbBits, newState)]."""
    cells, nxt = _spread(norm, log)
    size, out = 1 << log, []
    for s in cells:
        ns = nxt[s]
        nxt[s] += 1
        nb = log - _highbit(ns)
        out.append((s, nb, (ns << nb) - size))
    return out


def _seq_table(norm, log: int, base, bits):
    """ZSTD_buildFSETable -> (table log, [(baseValue, extra bits, nbBits,
    nextState)])."""
    return log, [(base[s], bits[s], nb, st) for s, nb, st in _fse_table(norm, log)]


_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
                               4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
                                  2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
# offset codes: the base is 1 << code (RFC 8878's Offset_Value), bits = code
_OF_BASE = [1 << c for c in range(32)]
_OF_BITS = list(range(32))
_LL_NORM = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1,
            1, 1, 1, -1, -1, -1, -1]
_ML_NORM = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1]
_OF_NORM = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1,
            -1]
# (max symbol, max log, base, bits, predefined table) of the literal
# length, offset and match length codes
_FIELDS = (
    (35, 9, _LL_BASE, _LL_BITS, _seq_table(_LL_NORM, 6, _LL_BASE, _LL_BITS)),
    (31, 8, _OF_BASE, _OF_BITS, _seq_table(_OF_NORM, 5, _OF_BASE, _OF_BITS)),
    (52, 9, _ML_BASE, _ML_BITS, _seq_table(_ML_NORM, 6, _ML_BASE, _ML_BITS)))


# ---------------------------------------------------------------------------
# Huffman literals
# ---------------------------------------------------------------------------

def _fse_weights(src: bytes):
    """FSE_decompress_wksp of the Huffman weights (at most 255, table log
    at most 6): two states in turn until the stream overflows."""
    norm, msv, log, size = _read_ncount(src, 255)
    if log > 6:
        raise ZstdError("a Huffman weights' table log past 6")
    table = _fse_table(norm, log)
    d = _Back(src[size:])
    s1 = d.read(log)
    d.reload()
    s2 = d.read(log)
    if d.reload() == 3:
        raise ZstdError("Huffman weights past their stream")
    out = []
    states = [s1, s2]
    i = 0
    while True:
        if len(out) > 253:
            raise ZstdError("too many Huffman weights")
        sym, nb, ns = table[states[i]]
        out.append(sym)
        states[i] = ns + d.read(nb)
        i ^= 1
        if d.reload() == 3:
            out.append(table[states[i]][0])
            break
    return out


# HUF_selectDecoder's timings: (table, per 256 symbols) of the single and
# double-symbol decoders by the compressed share in sixteenths
_ALGO_TIME = (((0, 0), (1, 1)), ((0, 0), (1, 1)), ((150, 216), (381, 119)),
              ((170, 205), (514, 112)), ((177, 199), (539, 110)), ((197, 194), (644, 107)),
              ((221, 192), (735, 107)), ((256, 189), (881, 106)), ((359, 188), (1167, 105)),
              ((582, 187), (1570, 104)), ((688, 187), (1712, 104)), ((825, 186), (1965, 104)),
              ((976, 185), (2131, 104)), ((1180, 186), (2070, 103)), ((1377, 185), (1731, 103)),
              ((1412, 185), (1695, 102)))


def _select_x2(size: int, csize: int) -> bool:
    """HUF_selectDecoder: the double-symbol decoder where it is timed faster."""
    q = 15 if csize >= size else csize * 16 // size
    d256 = size >> 8
    t0 = _ALGO_TIME[q][0][0] + _ALGO_TIME[q][0][1] * d256
    t1 = _ALGO_TIME[q][1][0] + _ALGO_TIME[q][1][1] * d256
    return t1 + (t1 >> 5) < t0


def _huf_table(src: bytes):
    """HUF_readStats then the decoding table -> ((symbol list, length list)
    over every table-log-bit value, table log), bytes read."""
    if not src:
        raise ZstdError("no Huffman table")
    isize = src[0]
    if isize >= 128:
        osize = isize - 127
        isize = (osize + 1) // 2
        if isize + 1 > len(src):
            raise ZstdError("a short Huffman table")
        if osize >= 256:
            raise ZstdError("too many Huffman weights")
        w = []
        for n in range(0, osize, 2):
            w += [src[1 + n // 2] >> 4, src[1 + n // 2] & 15]
        w = w[:osize]
    else:
        if isize + 1 > len(src):
            raise ZstdError("a short Huffman table")
        w = _fse_weights(bytes(src[1:1 + isize]))
    total = 0
    for x in w:
        if x > 12:
            raise ZstdError("a Huffman weight past 12")
        total += (1 << x) >> 1
    if total == 0:
        raise ZstdError("all Huffman weights zero")
    log = _highbit(total) + 1
    if log > 12:
        raise ZstdError("a Huffman table log past 12")
    rest = (1 << log) - total
    if rest & (rest - 1):
        raise ZstdError("Huffman weights that do not complete a tree")
    w = w + [_highbit(rest) + 1]
    ranks = [0] * 13
    for x in w:
        ranks[x] += 1
    if ranks[1] < 2 or ranks[1] & 1:
        raise ZstdError("Huffman weights that do not complete a tree")
    syms, lens = [], []
    for weight in range(1, log + 1):
        for s, x in enumerate(w):
            if x == weight:
                syms += [s] * (1 << (weight - 1))
                lens += [log + 1 - weight] * (1 << (weight - 1))
    return (np.array(syms, np.uint8), np.array(lens, np.int64), log), isize + 1


def _huf_stream(src: bytes, n: int, table) -> bytes:
    """One Huffman stream of n symbols, read from its end
    (HUF_decompress1X1): the codes must end exactly at its first bit."""
    syms, lens, log = table[:3]
    if not src:
        raise ZstdError("an empty Huffman stream")
    last = src[-1]
    if last == 0:
        raise ZstdError("a Huffman stream with no end mark")
    bits = np.unpackbits(np.frombuffer(bytes(src)[::-1], np.uint8))[9 - last.bit_length():]
    avail = len(bits)
    if n * log < avail:  # more bits than any n codes take
        raise ZstdError("a Huffman stream longer than its symbols")
    chain, c = _chain(bits, 0, n, lens, log)
    if len(chain) < n or c != avail:
        raise ZstdError("a Huffman stream that does not end at its symbols")
    return syms[chain].tobytes()


def _windows(bits: np.ndarray, log: int) -> np.ndarray:
    """The ``log``-bit value at every bit of ``bits`` (zeros past its end)."""
    b = np.concatenate([bits, np.zeros(log, np.uint8)])
    m = len(bits)
    win = np.zeros(m, np.int64)
    for i in range(log):
        win = (win << 1) | b[i:i + m]
    return win


def _chain(bits: np.ndarray, c: int, n: int, lens, log: int):
    """The codes from bit c on, at most n of them, while they start inside
    ``bits`` -> (the window of each code, the bit after the last)."""
    win = _windows(bits, log)
    step = lens[win].tolist()
    m, pos = len(bits), []
    for _ in range(n):
        if c >= m:
            break
        pos.append(c)
        c += step[c]
    return win[np.array(pos, np.int64)] if pos else np.zeros(0, np.int64), c


def _lookup(table, v11: int):
    """An 11-bit window (or 12 for a table log of 12) -> (symbol, bits)."""
    syms, lens, log = table[:3]
    i = v11 >> (max(log, 11) - log)
    return int(syms[i]), int(lens[i])


def _x2(table) -> bool:
    return len(table) > 3 and table[3]


def _dt_log(table) -> int:
    return 11 if table[2] <= 11 else 12


def _decode_x1(d: _Back, n: int, table) -> bytes:
    """HUF_decodeStreamX1's n symbols from d (its reload pattern kept)."""
    dl = _dt_log(table)
    out = bytearray()

    def one():
        sym, nb = _lookup(table, _look(d, dl))
        d.consumed += nb
        out.append(sym)

    if n > 3:
        while d.reload() == 0 and len(out) < n - 3:
            for _ in range(4):
                one()
    else:
        d.reload()
    while len(out) < n:
        one()
    return bytes(out)


def _look(d: _Back, n: int) -> int:
    return ((d.c << (d.consumed & 63)) & _M64) >> ((64 - n) & 63)


def _decode_x2(d: _Back, n: int, table) -> bytes:
    """HUF_decodeStreamX2's n symbols from d: a lookup of the table log's
    bits gives two symbols where the second code fits in what the first
    leaves; the last symbol of a pair entry takes the pair's bits, as far
    as the stream goes."""
    dl = _dt_log(table)
    out = bytearray()

    def entry():
        v = _look(d, dl)
        s1, l1 = _lookup(table, v)
        rest = dl - l1
        if rest > 0:
            s2, l2 = _lookup(table, (v << l1) & ((1 << dl) - 1))
            if l2 <= rest:
                return (s1, s2), l1 + l2
        return (s1,), l1

    def one():
        seq, nb = entry()
        d.consumed += nb
        out.extend(seq)

    if n >= 8:
        if dl <= 11:
            while d.reload() == 0 and len(out) < n - 9:
                for _ in range(5):
                    one()
        else:
            while d.reload() == 0 and len(out) < n - 7:
                for _ in range(4):
                    one()
    else:
        d.reload()
    if n - len(out) >= 2:
        while d.reload() == 0 and len(out) <= n - 2:
            one()
        while len(out) <= n - 2:
            one()
    if len(out) < n:  # HUF_decodeLastSymbolX2
        seq, nb = entry()
        out.append(seq[0])
        if len(seq) == 1:
            d.consumed += nb
        elif d.consumed < 64:
            d.consumed = min(d.consumed + nb, 64)
    return bytes(out[:n])


def _huf4(streams: bytes, size: int, table) -> bytes:
    """Four Huffman streams (HUF_decompress4X1/4X2): through libzstd's fast
    loop where it takes them (a table log of at most 11, every stream of 8
    bytes or more, more than three segments of output), which reads each
    stream on into the bytes before it and checks no stream's end; else
    stream by stream, each ending exactly at its first bit."""
    if len(streams) < 10:
        raise ZstdError("four Huffman streams too short")
    lens4 = [int.from_bytes(streams[i:i + 2], "little") for i in (0, 2, 4)]
    lens4.append(len(streams) - (sum(lens4) + 6))
    if lens4[3] < 0:
        raise ZstdError("four Huffman streams past their data")
    seg = (size + 3) // 4
    starts = [6, 6 + lens4[0], 6 + lens4[0] + lens4[1], 6 + sum(lens4[:3])]
    ends = starts[1:] + [len(streams)]
    x2 = _x2(table)
    if _dt_log(table) == 11 and min(lens4) >= 8 and 3 * seg < size:
        _note("literals: libzstd's fast 4-stream loop")
        return _huf4_fast(streams, size, table, seg, starts, ends, x2)
    if 3 * seg > size:
        raise ZstdError("four Huffman streams of too few literals")
    out = b""
    for i in range(4):
        n = seg if i < 3 else size - 3 * seg
        src = bytes(streams[starts[i]:ends[i]])
        if x2:
            d = _Back(src)
            out += _decode_x2(d, n, table)
            if not d.ended():
                raise ZstdError("a Huffman stream that does not end at its symbols")
        else:
            out += _huf_stream(src, n, table)
    return out


def _huf4_fast(streams: bytes, size: int, table, seg: int, starts, ends, x2: bool) -> bytes:
    """HUF_decompress4X{1,2}_usingDTable_internal_fast as it runs: the C
    loop's iterations (5 lookups a stream each, while the input and output
    bounds allow), the check that no stream has read more than 8 bytes into
    the one before, then each stream's rest through HUF_decodeStream, which
    reads on past the first stream's start."""
    syms, lens, log = table[:3]
    data = bytes(streams)
    # the 11-bit window and code length at every bit, counted from the data's
    # end; stream i's bit c (from its own end) is bit c + base[i]
    win = _windows(np.unpackbits(np.frombuffer(data[::-1], np.uint8)), 11)
    step = lens[win >> (11 - log)].tolist()
    base = [(len(data) - e) * 8 for e in ends]
    ip = [e - 8 for e in ends]
    outs = [[] for _ in range(4)]
    seg_end = [min(seg * (i + 1), size) for i in range(4)]
    # the bit each stream has reached
    at = [base[i] + (8 - data[e - 1].bit_length() + 1 if data[e - 1] else 0)
          for i, e in enumerate(ends)]
    # a second symbol's code length past the data's start: the last one's
    step2 = step + step[-1:] * 11

    def run(i, groups, until):
        """Stream i's part of the loop's iterations: 5 lookups (the bit each
        symbol's code starts at; the symbols come after the loop), then a
        reload, ``groups`` times, or where that is None until its output
        reaches ``until`` -> the iterations run. The streams do not meet
        inside the loop, so each runs its iterations in turn."""
        c, out, p, skip = at[i], outs[i], ip[i], base[i] + (ends[i] - 8) * 8
        n = 0
        while (seg * i + len(out) < until) if groups is None else n < groups:
            for _ in range(5):
                l1 = step[c]
                if x2 and l1 < 11 and step2[c + l1] <= 11 - l1:
                    out += (c, c + l1)  # HUF_DEltX2: a second symbol where its code fits
                    c += l1 + step2[c + l1]
                else:
                    out.append(c)
                    c += l1
            p -= (c - skip + p * 8) >> 3  # the whole bytes taken since the last load
            n += 1
        at[i], ip[i] = c, p
        return n

    def taken(i):  # the bits taken since the last load
        return at[i] - base[i] - (ends[i] - 8 - ip[i]) * 8

    op = lambda i: seg * i + len(outs[i])  # noqa: E731
    while True:
        if x2:
            iters = ip[0] // 7
            for i in range(4):
                iters = min(iters, ((seg * (i + 1) if i < 3 else size) - op(i)) // 10)
        else:
            iters = min((size - op(3)) // 5, ip[0] // 7)
        if iters <= 0 or any(ip[i] < ip[i - 1] for i in (1, 2, 3)):
            break
        # the C loop runs until stream 3's output reaches its limit
        n = run(3, None, op(3) + 5 * iters)
        for i in range(3):
            run(i, n, 0)
    out = bytearray()
    padded = np.concatenate([win, np.zeros(12, np.int64)])  # zeros past the data's start
    for i in range(4):
        if op(i) > seg_end[i] or ip[i] < starts[i] - 8:
            raise ZstdError("a Huffman stream read past the one before it")
        d = _Back.__new__(_Back)
        d.src, d.ptr = data, ip[i]
        d.c = int.from_bytes(data[ip[i]:ip[i] + 8], "little")
        d.consumed = taken(i)
        n = seg_end[i] - op(i)
        rest = (_decode_x2 if x2 else _decode_x1)(d, n, table)
        out += syms[padded[np.array(outs[i], np.int64)] >> (11 - log)].tobytes() + rest
    return bytes(out)


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

class _State:
    """A frame's decoding state: its output, repeat offsets, last tables."""

    def __init__(self, block_max: int):
        self.out = bytearray()
        self.rep = [1, 4, 8]
        self.huf = None
        self.tables = [None, None, None]
        self.seq_seen = False
        self.block_max = block_max


def _literals(st: _State, src: bytes, cap: int):
    """ZSTD_decodeLiteralsBlock -> (literals, bytes read)."""
    if len(src) < 2:
        raise ZstdError("a compressed block too short")
    kind = src[0] & 3
    lhl = (src[0] >> 2) & 3
    most = min(st.block_max, cap)
    if kind in (2, 3):
        if kind == 3 and st.huf is None:
            raise ZstdError("treeless literals with no table before")
        if len(src) < 5:
            raise ZstdError("a compressed block too short")
        lhc = int.from_bytes(src[:4], "little")
        single = lhl == 0
        if lhl in (0, 1):
            lh, size, csize = 3, (lhc >> 4) & 0x3FF, (lhc >> 14) & 0x3FF
        elif lhl == 2:
            lh, size, csize = 4, (lhc >> 4) & 0x3FFF, lhc >> 18
        else:
            lh, size, csize = 5, (lhc >> 4) & 0x3FFFF, (lhc >> 22) + (src[4] << 10)
        if size > st.block_max:
            raise ZstdError("literals past the block's maximum")
        if not single and size < 6:
            raise ZstdError("four Huffman streams of fewer than 6 literals")
        if csize + lh > len(src):
            raise ZstdError("literals past the block")
        if most < size:
            raise ZstdError("literals past the output")
        body = bytes(src[lh:lh + csize])
        if kind == 2:
            table, hsize = _huf_table(body)
            if hsize >= csize:
                raise ZstdError("a Huffman table with no streams")
            streams = body[hsize:]
        else:
            table, streams = st.huf, body
        if kind == 2 and not single:  # HUF_selectDecoder: X1 or X2
            table = table[:3] + (_select_x2(size, csize),)
        _note(f"literals: {'Huffman' if kind == 2 else 'treeless'}, "
                  f"{'1 stream' if single else '4 streams'}"
                  f"{', double-symbol table' if _x2(table) else ''}")
        if single and _x2(table):  # a treeless stream over a double-symbol table
            d = _Back(bytes(streams))
            lits = _decode_x2(d, size, table)
            if not d.ended():
                raise ZstdError("a Huffman stream that does not end at its symbols")
        elif single:
            lits = _huf_stream(streams, size, table)
        else:
            lits = _huf4(streams, size, table)
        st.huf = table
        return lits, lh + csize
    if lhl in (0, 2):
        lh, size = 1, src[0] >> 3
    elif lhl == 1:
        lh, size = 2, int.from_bytes(src[:2], "little") >> 4
    else:
        if len(src) < (3 if kind == 0 else 4):
            raise ZstdError("a literals header past the block")
        lh, size = 3, int.from_bytes(src[:3], "little") >> 4
    if kind == 1 and lhl == 1 and len(src) < 3:
        raise ZstdError("a literals header past the block")
    if size > st.block_max:
        raise ZstdError("literals past the block's maximum")
    if most < size:
        raise ZstdError("literals past the output")
    _note("literals: raw" if kind == 0 else "literals: RLE")
    if kind == 0:
        if lh + size > len(src):
            raise ZstdError("raw literals past the block")
        return bytes(src[lh:lh + size]), lh + size
    return bytes(src[lh:lh + 1]) * size, lh + 1


def _seq_tables(st: _State, src: bytes, nseq: int) -> int:
    """The three code tables (ZSTD_buildSeqTable) -> bytes read."""
    if not src:
        raise ZstdError("no sequence table modes")
    modes = src[0]
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence table modes")
    p = 1
    for i, mode in enumerate(((modes >> 6) & 3, (modes >> 4) & 3, (modes >> 2) & 3)):
        max_sv, max_log, base, bits, predefined = _FIELDS[i]
        _note(f"{('literal length', 'offset', 'match length')[i]} codes: "
                  f"{('predefined', 'RLE', 'FSE', 'repeat')[mode]}")
        if mode == 0:
            st.tables[i] = predefined
        elif mode == 1:
            if p >= len(src):
                raise ZstdError("an RLE sequence table past the block")
            s = src[p]
            if s > max_sv:
                raise ZstdError("an RLE sequence code past the largest")
            st.tables[i] = (0, [(base[s], bits[s], 0, 0)])
            p += 1
        elif mode == 3:
            if not st.seq_seen:
                raise ZstdError("a repeated sequence table with none before")
        else:
            norm, msv, log, size = _read_ncount(bytes(src[p:]), max_sv)
            if log > max_log:
                raise ZstdError("a sequence table log past its maximum")
            st.tables[i] = _seq_table(norm, log, base, bits)
            p += size
    return p


def _sequences(st: _State, src: bytes, lits: bytes, block_start: int):
    """ZSTD_decompressSequences: the sequences of src over the literals
    into st.out."""
    if not src:
        raise ZstdError("no sequence section")
    nseq = src[0]
    p = 1
    if nseq > 0x7F:
        if nseq == 0xFF:
            if p + 2 > len(src):
                raise ZstdError("a sequence count past the block")
            nseq = int.from_bytes(src[1:3], "little") + 0x7F00
            p = 3
        else:
            if p >= len(src):
                raise ZstdError("a sequence count past the block")
            nseq = ((nseq - 0x80) << 8) + src[1]
            p = 2
    out = st.out
    _note("sequences: none" if nseq == 0 else "sequences")
    if nseq == 0:
        if p != len(src):
            raise ZstdError("data after an empty sequence section")
        if len(lits) > st.block_max - (len(out) - block_start):
            raise ZstdError("a block past its maximum")
        out += lits
        return
    p += _seq_tables(st, bytes(src[p:]), nseq)
    st.seq_seen = True
    (lllog, lltab), (oflog, oftab), (mllog, mltab) = st.tables
    d = _Back(bytes(src[p:]))
    rd = d.read
    sll = rd(lllog)
    d.reload()
    sof = rd(oflog)
    d.reload()
    sml = rd(mllog)
    d.reload()
    rep = list(st.rep)
    lp, nlit = 0, len(lits)
    limit = block_start + st.block_max
    for k in range(nseq, 0, -1):
        llb, llbits, llnb, llns = lltab[sll]
        mlb, mlbits, mlnb, mlns = mltab[sml]
        ofb, ofbits, ofnb, ofns = oftab[sof]
        if ofbits > 1:
            off = ofb + rd(ofbits) - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], off
        else:
            ll0 = llb == 0
            _note("repeat offsets")
            if ofbits == 0:
                off = rep[ll0]
                rep[1] = rep[not ll0]
                rep[0] = off
            else:
                idx = 1 + ll0 + rd(1)
                tmp = (rep[0] - 1) & _M64 if idx == 3 else rep[idx]
                if tmp == 0:
                    tmp = _M64
                if idx != 1:
                    rep[2] = rep[1]
                rep[1] = rep[0]
                rep[0] = off = tmp
        ml = mlb + (rd(mlbits) if mlbits else 0)
        if ofbits + mlbits + llbits >= 31:
            d.reload()
        ll = llb + (rd(llbits) if llbits else 0)
        if k > 1:
            sll = llns + rd(llnb)
            sml = mlns + rd(mlnb)
            sof = ofns + rd(ofnb)
            d.reload()
        if len(out) + ll + ml > limit:
            raise ZstdError("a block past its maximum")
        if lp + ll > nlit:
            raise ZstdError("a sequence past the literals")
        out += lits[lp:lp + ll]
        lp += ll
        if off > len(out):
            raise ZstdError("a match before the frame's start")
        start = len(out) - off
        if off >= ml:
            out += out[start:start + ml]
        else:
            seg = out[start:]
            out += (seg * (ml // off + 1))[:ml]
    if not d.ended():
        raise ZstdError("a sequence bit stream that does not end at its sequences")
    st.rep = [r & 0xFFFFFFFF for r in rep]
    if len(out) + nlit - lp > limit:
        raise ZstdError("a block past its maximum")
    out += lits[lp:]


def _note(what: str):
    if PATHS is not None:
        PATHS.add(what)


def _block(st: _State, kind: int, body: bytes, size: int, cap: int):
    """One block's output onto st.out; cap: the output it may still write."""
    start = len(st.out)
    _note(("raw block", "RLE block", "compressed block")[kind])
    if kind == 0:
        st.out += body
    elif kind == 1:
        st.out += body[:1] * size
    else:
        if len(body) > st.block_max:
            raise ZstdError("a compressed block past the block maximum")
        lits, n = _literals(st, body, cap)
        _sequences(st, bytes(body[n:]), lits, start)
    if len(st.out) - start > st.block_max:
        raise ZstdError("a block's output past the block maximum")


def _header(data: bytes):
    """The frame header -> (header size, content size or None, window size,
    checksum flag), None where the input is too short, ZstdError where
    libzstd fails it."""
    if len(data) < 5:
        return None
    magic = int.from_bytes(data[:4], "little")
    if magic & 0xFFFFFFF0 == 0x184D2A50:
        raise ZstdError("a skippable frame")
    if magic != _MAGIC:
        raise ZstdError("not a zstd frame")
    fhd = data[4]
    fcs_id, single, dict_id = fhd >> 6, (fhd >> 5) & 1, fhd & 3
    size = 5 + (not single) + (0, 1, 2, 4)[dict_id] + ((1 if single else 0), 2, 4, 8)[fcs_id]
    if len(data) < size:
        return None
    if fhd & 8:
        raise ZstdError("the frame header's reserved bit is set")
    p = 5
    window = 0
    if not single:
        wl = data[p]
        p += 1
        log = (wl >> 3) + 10
        if log > 31:
            raise ZstdError("a window log past 31")
        window = (1 << log) + ((1 << log) >> 3) * (wl & 7)
    nd = (0, 1, 2, 4)[dict_id]
    did = int.from_bytes(data[p:p + nd], "little")
    p += nd
    nf = ((1 if single else 0), 2, 4, 8)[fcs_id]
    fcs = int.from_bytes(data[p:p + nf], "little") if nf else None
    if nf == 2:
        fcs += 256
    if single:
        window = fcs
    return size, fcs, window, (fhd >> 2) & 1, did, min(window, _BLOCK_MAX)


def _block_header(data: bytes, p: int):
    h = int.from_bytes(data[p:p + 3], "little")
    kind = (h >> 1) & 3
    if kind == 3:
        raise ZstdError("a reserved block type")
    return h & 1, kind, h >> 3


def _single_pass(data: bytes, hsize: int, fcs, bmax: int, check: bool, need: int):
    """ZSTD_findFrameCompressedSize, then ZSTD_decompressFrame -> the
    frame's output, or None where the frame does not lie whole in data."""
    p = hsize
    while True:
        if p + 3 > len(data):
            return None
        try:
            last, kind, size = _block_header(data, p)
        except ZstdError:
            return None
        csize = 1 if kind == 1 else size
        if p + 3 + csize > len(data):
            return None
        p += 3 + csize
        if last:
            break
    if check and p + 4 > len(data):
        return None
    st = _State(bmax)
    _note("single-pass frame (content size stated)")
    p = hsize
    while True:
        last, kind, size = _block_header(data, p)
        csize = 1 if kind == 1 else size
        if kind == 2 and size > bmax:
            raise ZstdError("a compressed block past the block maximum")
        body = data[p + 3:p + 3 + csize]
        if kind != 2 and len(st.out) + size > need:
            raise ZstdError("a block past the output")
        _block(st, kind, body, size, need - len(st.out))
        p += 3 + csize
        if last:
            break
    if fcs is not None and len(st.out) != fcs:
        raise ZstdError("a frame whose content is not its stated size")
    if check:
        _note("XXH64 checksum")
        if int.from_bytes(data[p:p + 4], "little") != xxh64(bytes(st.out)) & 0xFFFFFFFF:
            raise ZstdError("a frame whose checksum is wrong")
    return bytes(st.out)


def zstd_stream(data: bytes, need: int):
    """libtiff's ZSTDDecode of one strip or tile -> (the bytes decoded, at
    most ``need``; the error that fails it, or None). See the module."""
    data = bytes(data)
    try:
        head = _header(data)
        if head is None:
            return b"", "the data ends inside the frame header"
        hsize, fcs, window, check, did, bmax = head
        if fcs is not None and need >= fcs:
            got = _single_pass(data, hsize, fcs, bmax, check, need)
            if got is not None:
                if did:
                    raise ZstdError("a dictionary ID and no dictionary")
                return got, None if len(got) >= need else "the frame ends before the strip"
        if did:
            raise ZstdError("a dictionary ID and no dictionary")
        window = max(window, 1 << 10)
        if window > _WINDOW_MAX:
            raise ZstdError("a window past 2^27 + 1 bytes")
        st = _State(bmax)
        _note("streamed frame, single segment" if (data[4] >> 5) & 1 else
              "streamed frame, window descriptor")
        p, full = hsize, False
        while True:
            if p + 3 > len(data):
                break
            last, kind, size = _block_header(data, p)
            csize = 1 if kind == 1 else size
            if csize > st.block_max:
                raise ZstdError("a block past the block maximum")
            before = len(st.out)
            body = data[p + 3:p + 3 + csize]
            if len(body) < csize:  # cut by the end of the input
                if kind == 0:  # a raw block is handed on as far as it goes
                    st.out += body
                break
            if csize:  # an empty block is skipped, whatever its type
                _block(st, kind, body, size, st.block_max)
                if last and fcs is not None and len(st.out) != fcs:
                    raise ZstdError("a frame whose content is not its stated size")
            p += 3 + csize
            if full and len(st.out) > before:
                break
            if len(st.out) > need:
                break
            if len(st.out) == need:
                full = True
            if last:
                if check and p + 4 <= len(data):
                    _note("XXH64 checksum")
                    if int.from_bytes(data[p:p + 4], "little") != \
                            xxh64(bytes(st.out)) & 0xFFFFFFFF:
                        raise ZstdError("a frame whose checksum is wrong")
                break
        out = bytes(st.out[:need])
        return out, None if len(out) == need else "the data ends before the strip"
    except ZstdError as e:
        return b"", str(e)
