"""An arithmetic-coding JPEG encoder (T.81 Annex D, F.1.4 and G.1.3, as
libjpeg's jcarith.c codes them) for the tests: nothing on this machine writes
an arithmetic-coded JPEG, so the tests re-code the quantised coefficients of a
Huffman JPEG that Pillow wrote into SOF9 (sequential) or SOF10 (progressive)
files, with restart intervals and DAC conditioning as asked, and then hold the
port's decode of each to Pillow's.

    arith_jpeg(huffman_jpeg_bytes, progressive=False, restart=0, dac=None,
               script=None) -> bytes
"""

from __future__ import annotations

from unittest import mock

from latent2im_tpu_torch.utils import jpeg

ARITAB = jpeg.ARITAB


class ArithEncoder:
    """jcarith.c's arith_encode, its byte output and finish_pass."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st, i, val):
        sv = st[i]
        qe, nl, nm = ARITAB[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:  # renormalisation and output, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _magnitude(enc, st, i, v, x1, j, ac):
    """F.23/F.24 for |v| - 1 = v from bin i (then x1[j:] for the rest of
    the category), AC coding the first two decisions in bin i."""
    m = 0
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v >> 1
        if ac:
            if v2:
                enc.encode(st, i, 1)
                m <<= 1
                st, i = x1, j
                v2 >>= 1
                while v2:
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        else:
            st, i = x1, j
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
    enc.encode(st, i, 0)
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1


def _dc(enc, st, ctx, v, lo, hi):
    """One DC difference from bin S0 = ctx -> the next context."""
    if v == 0:
        enc.encode(st, ctx, 0)
        return 0
    enc.encode(st, ctx, 1)
    sign = 1 if v < 0 else 0
    enc.encode(st, ctx + 1, sign)
    v = abs(v) - 1
    m = 1 << (v.bit_length() - 1) if v else 0  # the decoder's category bit
    _magnitude(enc, st, ctx + 2 + sign, v, st, 20, False)
    if m < (1 << lo) >> 1:
        return 0
    if m > (1 << hi) >> 1:
        return 12 + sign * 4
    return 4 + sign * 4


def _ac_block(enc, st, fixed, vals, ss, se, kx):
    """The AC coefficients vals[ss..se] (already point-transformed)."""
    ke = se
    while ke >= ss and vals[ke] == 0:
        ke -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc.encode(st, i, 0)
        while vals[k] == 0:
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        enc.encode(st, i + 1, 1)
        v = vals[k]
        enc.encode(fixed, 0, 1 if v < 0 else 0)
        _magnitude(enc, st, i + 2, abs(v) - 1, st, 189 if k <= kx else 217, True)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _ac_refine(enc, st, fixed, coef, ss, se, al):
    """G.1.3.3: one AC refinement of the true coefficients coef[0..63]."""
    absv = [abs(int(c)) for c in coef]
    ke = se
    while ke > 0 and not absv[ke] >> al:
        ke -= 1
    kex = ke
    while kex > 0 and not absv[kex] >> (al + 1):
        kex -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.encode(st, i, 0)
        while absv[k] >> al == 0:
            enc.encode(st, i + 1, 0)
            i += 3
            k += 1
        t = absv[k] >> al
        if t >> 1:
            enc.encode(st, i + 2, t & 1)
        else:
            enc.encode(st, i + 1, 1)
            enc.encode(fixed, 0, 1 if coef[k] < 0 else 0)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def frame_of(data: bytes):
    """The port's decoded frame of a Huffman JPEG (its coefficients)."""
    with mock.patch.object(jpeg, "_assemble", lambda fr, jfif, adobe: fr):
        return jpeg.jpeg_decode_rgb(data)


def simple_progression(n):
    """jcparam.c's jpeg_simple_progression: (components, Ss, Se, Ah, Al)."""
    if n == 3:
        return [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                ((0,), 1, 63, 1, 0)]
    all_c = tuple(range(n))
    out = [(all_c, 0, 0, 0, 1)] if n <= 4 else []
    for c in range(n):
        out.append(((c,), 1, 5, 0, 2))
    for c in range(n):
        out.append(((c,), 6, 63, 0, 2))
    for c in range(n):
        out.append(((c,), 1, 63, 2, 1))
    out.append((all_c, 0, 0, 1, 0))
    for c in range(n):
        out.append(((c,), 1, 63, 1, 0))
    return out


def _segments(data: bytes):
    """(marker, whole segment bytes) of a JPEG up to its first SOS."""
    pos, out = 2, []
    while True:
        assert data[pos] == 0xFF
        marker = data[pos + 1]
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((marker, data[pos:pos + 2 + n]))
        if marker == 0xDA:
            return out
        pos += 2 + n


def _seg(marker, body):
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def arith_jpeg(data: bytes, progressive=False, restart=0, dac=None, script=None,
               tables=None) -> bytes:
    """The Huffman JPEG ``data`` re-coded with arithmetic coding. dac: {table
    index (0-15 DC, 16-31 AC): value} for a DAC segment; script: the
    progressive scans as simple_progression gives them; tables: each
    component's (DC, AC) conditioning table (default (0, 0), then (1, 1))."""
    fr = frame_of(data)
    coef = fr.coef.reshape(-1, 64)
    n = len(fr.ids)
    tables = tables or [(0, 0)] + [(1, 1)] * (n - 1)
    lo, hi, kx = [0] * 16, [1] * 16, [5] * 16
    for idx, val in (dac or {}).items():
        if idx >= 16:
            kx[idx - 16] = val
        else:
            lo[idx], hi[idx] = val & 15, val >> 4
    out = bytearray(b"\xff\xd8")
    sof = None
    for marker, seg in _segments(data):
        if marker in (0xC0, 0xC1, 0xC2):
            sof = seg[4:]
        elif marker in (0xDB,) or 0xE0 <= marker <= 0xEF:
            out += seg
    if dac:
        out += _seg(0xCC, b"".join(bytes([i, v]) for i, v in sorted(dac.items())))
    out += _seg(0xCA if progressive else 0xC9, sof)
    if restart:
        out += _seg(0xDD, restart.to_bytes(2, "big"))
    scans = (script or simple_progression(n)) if progressive else [(tuple(range(n)), 0, 63, 0, 0)]
    for comps, ss, se, ah, al in scans:
        body = bytes([len(comps)])
        for c in comps:
            body += bytes([fr.ids[c], tables[c][0] << 4 | tables[c][1]])
        out += _seg(0xDA, body + bytes([ss, se, ah << 4 | al]))
        blocks, per_mcu = jpeg._scan_blocks(fr, list(comps))
        n_mcu = len(blocks) // per_mcu
        span = restart or n_mcu
        for r in range(-(-n_mcu // span)):
            enc = ArithEncoder()
            dcs = [bytearray(64) for _ in range(16)]
            acs = [bytearray(256) for _ in range(16)]
            fixed = [113]
            ctx, last = [0] * len(comps), [0] * len(comps)
            for blk, ci in blocks[r * span * per_mcu:(r + 1) * span * per_mcu]:
                c = coef[blk].tolist()
                dt, at = tables[comps[ci]]
                if ss == 0 and ah == 0:  # a DC, then (sequential) its AC
                    dcv = c[0] >> al
                    ctx[ci] = _dc(enc, dcs[dt], ctx[ci], dcv - last[ci], lo[dt], hi[dt])
                    last[ci] = dcv
                    if not progressive:
                        _ac_block(enc, acs[at], fixed, c, 1, 63, kx[at])
                elif ss == 0:  # DC refine
                    enc.encode(fixed, 0, (c[0] >> al) & 1)
                elif ah == 0:  # AC first: the point transform rounds towards 0
                    v = [(-(-x >> al) if x < 0 else x >> al) for x in c]
                    _ac_block(enc, acs[at], fixed, v, ss, se, kx[at])
                else:
                    _ac_refine(enc, acs[at], fixed, c, ss, se, al)
            out += enc.finish()
            if (r + 1) * span < n_mcu:
                out += bytes([0xFF, 0xD0 + r % 8])
    return bytes(out + b"\xff\xd9")

