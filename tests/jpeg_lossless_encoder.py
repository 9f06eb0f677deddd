"""A lossless JPEG encoder (T.81 Annex H, SOF3, as libjpeg-turbo's
jclhuff.c/jcdiffct.c code it) for the tests: nothing on this machine writes
one, so the tests write lossless files from seeded sample planes here and
hold the port's decode of each to Pillow's.

    lossless_jpeg(planes, sampling, predictor=1, pt=0, restart_rows=0,
                  interleave=True, marker="jfif", symbols=ZERO_TO_16) -> bytes

planes: one uint8 array per component at its own (subsampled) size;
sampling: each component's (h, v) factors; predictor: the selection value
1-7; pt: the point transform; restart_rows: MCU rows per restart interval
(0: none); interleave: one scan of every component, else one scan each;
marker: "jfif" (APP0: YCbCr), "adobe-rgb" (APP14 with transform 0) or
None; symbols: the categories 0-16 in the order of the table's 5-bit codes
(the all-zero code is the first's: what bits past the data decode to).
"""

from __future__ import annotations

import struct

import numpy as np

ZERO_TO_16 = bytes(range(17))


def _seg(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> bytes:
        while self.n:
            self.put(1, 1)
        return bytes(self.out)


def _predict(ps: int, ra: int, rb: int, rc: int) -> int:
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[ps]


def _differences(plane: np.ndarray, ps: int, pt: int, first_rows) -> np.ndarray:
    """jdpred.c's prediction run forwards: each sample's difference from its
    prediction, modulo 2^16 as a signed value. first_rows: the rows that
    start a restart interval (the first row predicts from the left only)."""
    x = plane.astype(np.int64) >> pt
    h, w = x.shape
    d = np.zeros_like(x)
    for y in range(h):
        for c in range(w):
            if y in first_rows:
                pred = (1 << (8 - pt - 1)) if c == 0 else x[y, c - 1]
            elif c == 0:
                pred = x[y - 1, 0]
            else:
                pred = _predict(ps, x[y, c - 1], x[y - 1, c], x[y - 1, c - 1])
            v = (x[y, c] - pred) & 0xFFFF
            d[y, c] = v - 65536 if v >= 32768 else v
    return d


def _code(bits: _Bits, diff: int, symbols: bytes = ZERO_TO_16):
    """A difference as its category (a 5-bit code: the table gives each
    of 0-16 five bits, in the order of ``symbols``) and its value bits;
    32768 is category 16 alone."""
    if diff == -32768:
        diff = 32768
    s = 0 if diff == 0 else 16 if diff == 32768 else abs(diff).bit_length()
    bits.put(symbols.index(s), 5)
    if 0 < s < 16:
        bits.put(diff if diff > 0 else diff + (1 << s) - 1, s)


def lossless_jpeg(planes, sampling, predictor=1, pt=0, restart_rows=0, interleave=True,
                  marker="jfif", width=None, height=None, symbols=ZERO_TO_16) -> bytes:
    n = len(planes)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    if width is None:  # the image size the full-resolution plane gives
        c0 = next(i for i, (h, v) in enumerate(sampling) if (h, v) == (hmax, vmax))
        height, width = planes[c0].shape
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    out = bytearray(b"\xff\xd8")
    if marker == "jfif":
        out += _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif marker == "adobe-rgb":
        out += _seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    sof = bytes([8]) + struct.pack(">HH", height, width) + bytes([n])
    for i, (h, v) in enumerate(sampling):
        sof += bytes([i + 1, h << 4 | v, 0])
    out += _seg(0xC3, sof)
    counts = [0] * 16
    counts[4] = 17  # 17 five-bit codes
    out += _seg(0xC4, bytes([0x00]) + bytes(counts) + bytes(symbols))
    if restart_rows:
        out += _seg(0xDD, struct.pack(">H", restart_rows * mcux))
    scans = [list(range(n))] if interleave else [[c] for c in range(n)]
    for comps in scans:
        body = bytes([len(comps)]) + b"".join(bytes([c + 1, 0x00]) for c in comps)
        out += _seg(0xDA, body + bytes([predictor, 0, pt]))
        single = len(comps) == 1
        rows_per_mcu = {c: (1 if single else sampling[c][1]) for c in comps}
        firsts = {}
        n_mcu_rows = -(-planes[comps[0]].shape[0] // 1) if single else mcuy
        for c in comps:
            step = restart_rows * rows_per_mcu[c] if restart_rows else 0
            rows = planes[c].shape[0]
            firsts[c] = set(range(0, rows, step)) if step else {0}
        diffs = {c: _differences(planes[c], predictor, pt, firsts[c]) for c in comps}
        pieces, bits = [], _Bits()
        for my in range(n_mcu_rows):
            if restart_rows and my and my % restart_rows == 0:
                pieces.append(bits.flush())
                bits = _Bits()
            n_mx = planes[comps[0]].shape[1] if single else mcux
            for mx in range(n_mx):
                for c in comps:
                    hh, vv = (1, 1) if single else sampling[c]
                    for yy in range(vv):
                        for xx in range(hh):
                            y, x = my * vv + yy, mx * hh + xx
                            d = diffs[c]
                            # MCU padding past the plane: a zero difference
                            _code(bits, int(d[y, x]) if y < d.shape[0] and x < d.shape[1]
                                  else 0, symbols)
        pieces.append(bits.flush())
        for i, piece in enumerate(pieces):
            if i:
                out += bytes([0xFF, 0xD0 + (i - 1) % 8])
            out += piece
    return bytes(out + b"\xff\xd9")
