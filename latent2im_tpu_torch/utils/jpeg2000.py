"""JPEG 2000 decoding in Python and numpy, as Pillow 12.1 reads a J2K
codestream or a JP2 file (``PIL.Image.open(p).convert("RGB")``: its
Jpeg2KImagePlugin over OpenJPEG 2.5, its Jpeg2KDecode.c unpackers), bit for
bit: the GPU machine has no Pillow.

    jpeg2000_decode_rgb(data: bytes, host_cpp: bool = False) -> uint8 [H, W, 3]

As OpenJPEG decodes it (``reduce`` 0, every layer):

- markers: SIZ, COD/COC, QCD/QCC, RGN, POC, PPM/PPT, PLT/PLM and TLM (read
  past), COM, SOT/SOD over tile-parts and tiles, EOC;
- tier-2 (``_packets``): packet headers read with OpenJPEG's bit reader
  (a byte after 0xFF gives 7 bits), tag trees for inclusion and zero bit
  planes, the number of passes, Lblock and the codeword segments (one a pass
  under TERMALL; 10, then 2 and 1 under BYPASS), SOP markers (skipped
  where present) and EPH markers (required where announced), the
  five progression orders and POC, precincts, empty packets;
- tier-1 (``_t1_block``; ``host_cpp`` runs it in ops/csrc/jpeg2000_t1.cpp):
  the MQ decoder (with its two 0xFF bytes after each segment) and the
  significance, refinement and cleanup passes, their context tables,
  run-length mode, every code-block style (bypass, reset, termall,
  vertically causal, predictable termination, segmentation symbols), the
  coefficients kept at twice their size with OpenJPEG's half-step
  reconstruction, the ROI shift undone;
- reconstruction: reversible blocks halved (C division), irreversible ones
  ``(float)value * (0.5f * stepsize)`` in float32; the 5/3 integer and
  9/7 float32 inverse DWT in OpenJPEG's lifting order (its 9/7 with
  ``two_invK`` for the high bands, each product and sum rounded to float32,
  no FMA); RCT/ICT, the DC shift and the clamp (``lrintf``, half to even);
- JP2: the boxes Pillow and OpenJPEG read (ihdr, colr: sRGB, greyscale and
  sYCC; pclr/cmap; cdef);
- Pillow's unpackers: gray, gray and alpha, RGB(A) and YCbCr (sYCC, or
  a 3 or 4-component image whose first subsampled component is the second
  or the third), each
  sample's precision shifted to 8 bits with rounding, then convert("RGB").

What fails (ValueError, as Pillow fails): a codestream or box structure
cut short or corrupt where OpenJPEG fails it, a component count or colour
space Pillow has no unpacker for, more pixels than Pillow opens.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS

_J2K_MAGIC = b"\xff\x4f\xff\x51"
_JP2_MAGIC = b"\0\0\0\x0cjP  \r\n\x87\n"

# code-block styles
_LAZY, _RESET, _TERMALL, _VSC, _PTERM, _SEGSYM = 1, 2, 4, 8, 16, 32


def accepts(prefix: bytes) -> bool:
    """Jpeg2KImagePlugin._accept."""
    return prefix[:4] == _J2K_MAGIC or prefix[:12] == _JP2_MAGIC


def _corrupt(what: str) -> ValueError:
    return ValueError(f"jpeg2000: {what}")


# ---------------------------------------------------------------------------
# the MQ decoder (ISO 15444-1 Annex C, as OpenJPEG's mqc.c)
# ---------------------------------------------------------------------------

# (Qe, next index on MPS, next index on LPS, switch)
_MQ = ((0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
       (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
       (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
       (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
       (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
       (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
       (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
       (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
       (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
       (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
       (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
       (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))

# tier-1 contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run
# length, 18 uniform
_CTX_SC, _CTX_MAG, _CTX_AGG, _CTX_UNI = 9, 14, 17, 18


class _MQDecoder:
    """One code-block's MQ (and raw) decoder; its contexts persist across
    the block's segments."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.ctx = [[0, 0] for _ in range(19)]  # [state index, mps]
        self.ctx[_CTX_UNI] = [46, 0]
        self.ctx[_CTX_AGG] = [3, 0]
        self.ctx[0] = [4, 0]

    def init(self, data: bytes, raw: bool):
        self.buf = bytes(data) + b"\xff\xff"
        self.bp = 0
        if raw:
            self.c, self.ct = 0, 0
            return
        self.c = (0xFF if not data else data[0]) << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        b = self.buf
        if b[self.bp] == 0xFF:
            if b[self.bp + 1] > 0x8F:
                self.c = (self.c + 0xFF00) & 0xFFFFFFFF
                self.ct = 8
            else:
                self.bp += 1
                self.c = (self.c + (b[self.bp] << 9)) & 0xFFFFFFFF
                self.ct = 7
        else:
            self.bp += 1
            self.c = (self.c + (b[self.bp] << 8)) & 0xFFFFFFFF
            self.ct = 8

    def decode(self, cx: int) -> int:
        st = self.ctx[cx]
        qe, nmps, nlps, sw = _MQ[st[0]]
        self.a -= qe
        if (self.c >> 16) < qe:
            if self.a < qe:  # LPS exchange
                d = st[1]
                st[0] = nmps
            else:
                d = 1 - st[1]
                if sw:
                    st[1] = d
                st[0] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return st[1]
            if self.a < qe:  # MPS exchange
                d = 1 - st[1]
                if sw:
                    st[1] = d
                st[0] = nlps
            else:
                d = st[1]
                st[0] = nmps
        while True:  # renormalise
            if self.ct == 0:
                self._bytein()
            self.a <<= 1
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a >= 0x8000:
                return d

    def raw(self) -> int:
        if self.ct == 0:
            if self.c == 0xFF:
                if self.buf[self.bp] > 0x8F:
                    self.c, self.ct = 0xFF, 8
                else:
                    self.c = self.buf[self.bp]
                    self.bp += 1
                    self.ct = 7
            else:
                self.c = self.buf[self.bp]
                self.bp += 1
                self.ct = 8
        self.ct -= 1
        return (self.c >> self.ct) & 1


# ---------------------------------------------------------------------------
# tier-1 context tables (ISO 15444-1 Tables D.1-D.3)
# ---------------------------------------------------------------------------

def _zc_table(orient: int) -> list:
    """[h][v][d] -> zero-coding context; orient 0 LL, 1 HL, 2 LH, 3 HH."""
    t = [[[0] * 5 for _ in range(3)] for _ in range(3)]
    for h in range(3):
        for v in range(3):
            for d in range(5):
                hh, vv = (v, h) if orient == 1 else (h, v)
                if orient == 3:
                    hv = hh + vv
                    if d >= 3:
                        c = 8
                    elif d == 2:
                        c = 7 if hv >= 1 else 6
                    elif d == 1:
                        c = 5 if hv >= 2 else 4 if hv == 1 else 3
                    else:
                        c = 2 if hv >= 2 else 1 if hv == 1 else 0
                elif hh == 2:
                    c = 8
                elif hh == 1:
                    c = 7 if vv >= 1 else 6 if d >= 1 else 5
                else:
                    c = 4 if vv == 2 else 3 if vv == 1 else 2 if d >= 2 else 1 if d == 1 else 0
                t[h][v][d] = c
    return t


_ZC = [_zc_table(o) for o in range(4)]
# (hc, vc) -> (sign context, xor bit)
_SC = {(1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0), (0, 1): (10, 0), (0, 0): (9, 0),
       (0, -1): (10, 1), (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1)}


def _t1_block(data: bytes, segs, numbps: int, orient: int, sty: int, w: int, h: int,
              roishift: int) -> np.ndarray:
    """One code-block's tier-1 decode (opj_t1_decode_cblk) -> int32 [h, w]
    at twice the coefficients' size. segs: [(length, passes)] in order."""
    out = np.zeros((h, w), np.int64)
    if not w or not h:
        return out.astype(np.int32)
    # padded planes: significance, sign (0 positive / 1 negative), value,
    # visited in this bit plane, refined before
    W, H = w + 2, h + 2
    sig = [0] * (W * H)
    neg = [0] * (W * H)
    val = [0] * (W * H)
    vis = [0] * (W * H)
    ref = [0] * (W * H)
    zc = _ZC[orient]
    mq = _MQDecoder()
    vsc = sty & _VSC
    bpno = roishift + numbps
    if bpno >= 31:
        raise _corrupt("a code-block of 31 or more bit planes")
    passtype = 2
    pos = 0

    def nb(i, y):
        """Significant neighbours (h, v, d) of padded index i in stripe row y."""
        south = not (vsc and y % 4 == 3)
        hh = sig[i - 1] + sig[i + 1]
        vv = sig[i - W] + (sig[i + W] if south else 0)
        dd = sig[i - W - 1] + sig[i - W + 1] + (sig[i + W - 1] + sig[i + W + 1] if south else 0)
        return hh, vv, dd

    def sign_ctx(i, y):
        south = not (vsc and y % 4 == 3)

        def con(j):
            return (1 - 2 * neg[j]) if sig[j] else 0

        hc = max(-1, min(1, con(i - 1) + con(i + 1)))
        vc = max(-1, min(1, con(i - W) + (con(i + W) if south else 0)))
        return _SC[(hc, vc)]

    def decode_sign(i, y, raw):
        if raw:
            return mq.raw()
        cx, xb = sign_ctx(i, y)
        return mq.decode(cx) ^ xb

    for length, npasses in segs:
        raw = bool(sty & _LAZY) and passtype < 2 and bpno <= numbps - 4
        mq.init(data[pos:pos + length], raw)
        pos += length
        for _ in range(npasses):
            if bpno < 1:
                break
            one = 1 << bpno
            half = one >> 1
            oph = one | half
            if passtype == 0:  # significance propagation
                for y0 in range(0, h, 4):
                    for x in range(w):
                        for y in range(y0, min(y0 + 4, h)):
                            i = (y + 1) * W + x + 1
                            if sig[i]:
                                continue
                            hh, vv, dd = nb(i, y)
                            if not (hh or vv or dd):
                                continue
                            vis[i] = 1
                            bit = mq.raw() if raw else mq.decode(zc[hh][vv][dd])
                            if bit:
                                s = decode_sign(i, y, raw)
                                neg[i], sig[i], val[i] = s, 1, oph
            elif passtype == 1:  # magnitude refinement
                for y0 in range(0, h, 4):
                    for x in range(w):
                        for y in range(y0, min(y0 + 4, h)):
                            i = (y + 1) * W + x + 1
                            if not sig[i] or vis[i]:
                                continue
                            if raw:
                                bit = mq.raw()
                            else:
                                if ref[i]:
                                    cx = _CTX_MAG + 2
                                else:
                                    hh, vv, dd = nb(i, y)
                                    cx = _CTX_MAG + (1 if hh or vv or dd else 0)
                                bit = mq.decode(cx)
                            val[i] += half if bit else -half
                            ref[i] = 1
            else:  # cleanup
                for y0 in range(0, h, 4):
                    for x in range(w):
                        y = y0
                        if y0 + 4 <= h:
                            run = True
                            for k in range(4):
                                i = (y0 + k + 1) * W + x + 1
                                if sig[i] or vis[i] or any(nb(i, y0 + k)):
                                    run = False
                                    break
                            if run:
                                if not mq.decode(_CTX_AGG):
                                    continue
                                k = mq.decode(_CTX_UNI) << 1
                                k |= mq.decode(_CTX_UNI)
                                y = y0 + k
                                i = (y + 1) * W + x + 1
                                s = decode_sign(i, y, False)
                                neg[i], sig[i], val[i] = s, 1, oph
                                y += 1
                        for y in range(y, min(y0 + 4, h)):
                            i = (y + 1) * W + x + 1
                            if sig[i] or vis[i]:
                                continue
                            hh, vv, dd = nb(i, y)
                            if mq.decode(zc[hh][vv][dd]):
                                s = decode_sign(i, y, False)
                                neg[i], sig[i], val[i] = s, 1, oph
                if sty & _SEGSYM:
                    for _ in range(4):
                        mq.decode(_CTX_UNI)
                vis = [0] * (W * H)
            if sty & _RESET and not raw:
                mq.reset()
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
    for y in range(h):
        r = (y + 1) * W + 1
        out[y] = [(-v if n else v) for v, n in zip(val[r:r + w], neg[r:r + w])]
    if roishift:
        mag = np.abs(out)
        big = mag >= (1 << roishift)
        out = np.where(big, np.sign(out) * (mag >> roishift), out)
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# the codestream's main and tile-part headers
# ---------------------------------------------------------------------------

class _Coding:
    """COD/COC's coding style of one component (and the tile's)."""

    def __init__(self, body: bytes, at: int, scod: int):
        if len(body) < at + 5:
            raise _corrupt("a COD or COC segment cut short")
        self.levels, xcb, ycb, self.sty, self.qmfbid = body[at:at + 5]
        self.xcb, self.ycb = xcb + 2, ycb + 2
        if self.levels > 32 or self.xcb > 10 or self.ycb > 10 or self.xcb + self.ycb > 12 \
                or self.qmfbid > 1:
            raise _corrupt("a bad COD or COC segment")
        n = self.levels + 1
        if scod & 1:
            if len(body) < at + 5 + n:
                raise _corrupt("a COD or COC segment's precinct sizes cut short")
            pp = body[at + 5:at + 5 + n]
            self.ppx = [b & 15 for b in pp]
            self.ppy = [b >> 4 for b in pp]
            if any((x == 0 or y == 0) for x, y in zip(self.ppx[1:], self.ppy[1:])):
                raise _corrupt("a precinct size of 1 above resolution 0")
        else:
            self.ppx, self.ppy = [15] * n, [15] * n


class _Quant:
    """QCD/QCC: guard bits and each band's (exponent, mantissa)."""

    def __init__(self, body: bytes, at: int):
        if len(body) < at + 1:
            raise _corrupt("a QCD or QCC segment cut short")
        sq = body[at]
        self.style, self.guard = sq & 31, sq >> 5
        rest = body[at + 1:]
        if self.style == 0:
            self.steps = [(b >> 3, 0) for b in rest]
        elif self.style in (1, 2):
            v = struct.unpack(f">{len(rest) // 2}H", rest[:len(rest) // 2 * 2])
            self.steps = [(x >> 11, x & 0x7FF) for x in v]
        else:
            raise _corrupt(f"quantization style {self.style}")
        if not self.steps:
            raise _corrupt("a QCD or QCC segment with no step sizes")

    def step(self, band: int):
        """The band's (exponent, mantissa); band 0 LL, then 3 a resolution."""
        if self.style == 1:
            e, m = self.steps[0]
            return max(e - (band - 1) // 3, 0) if band else e, m
        if band >= len(self.steps):
            return (0, 0)
        return self.steps[band]


class _Header:
    """The main header's coding parameters (a tile's copy its tile-part
    headers amend): as OpenJPEG reads them, a COD or QCD sets every
    component, a COC or QCC one."""

    def copy(self):
        h = _Header.__new__(_Header)
        h.__dict__.update(self.__dict__)
        h.coding, h.quant, h.roi = list(self.coding), list(self.quant), dict(self.roi)
        h.poc = list(self.poc)  # a main header's POC reaches every tile
        return h


def _siz(body: bytes) -> _Header:
    if len(body) < 36:
        raise _corrupt("a SIZ segment cut short")
    h = _Header()
    (_, h.xsiz, h.ysiz, h.xo, h.yo, h.xt, h.yt, h.xto, h.yto, h.csiz) = struct.unpack(
        ">HIIIIIIIIH", body[:36])
    if len(body) < 36 + 3 * h.csiz or h.csiz == 0:
        raise _corrupt("a SIZ segment's components cut short")
    h.prec, h.sgnd, h.dx, h.dy = [], [], [], []
    for c in range(h.csiz):
        sz, dx, dy = body[36 + 3 * c:39 + 3 * c]
        h.prec.append((sz & 0x7F) + 1)
        h.sgnd.append(sz >> 7)
        h.dx.append(dx)
        h.dy.append(dy)
    if (h.xo >= h.xsiz or h.yo >= h.ysiz or not h.xt or not h.yt or h.xto > h.xo
            or h.yto > h.yo or h.xto + h.xt <= h.xo or h.yto + h.yt <= h.yo
            or min(h.dx + h.dy) == 0 or max(h.prec) > 31):
        raise _corrupt("a bad SIZ segment")
    h.ntx = -(-(h.xsiz - h.xto) // h.xt)
    h.nty = -(-(h.ysiz - h.yto) // h.yt)
    h.coding, h.quant, h.roi, h.poc = [None] * h.csiz, [None] * h.csiz, {}, []
    h.scod = h.prog = h.layers = h.mct = None
    return h


def _comp_index(h: _Header, body: bytes):
    n = 2 if h.csiz >= 257 else 1
    if len(body) < n:
        raise _corrupt("a segment's component index cut short")
    c = int.from_bytes(body[:n], "big")
    if c >= h.csiz:
        raise _corrupt("a component index past the image's components")
    return c, n


def _header_segment(h: _Header, marker: int, body: bytes):
    """COD, COC, QCD, QCC, RGN or POC into h."""
    if marker == 0xFF52:
        if len(body) < 5:
            raise _corrupt("a COD segment cut short")
        h.scod, h.prog = body[0], body[1]
        h.layers, h.mct = struct.unpack(">H", body[2:4])[0], body[4]
        if h.prog > 4 or h.layers == 0 or h.mct > 1 or h.scod & ~7:
            raise _corrupt("a bad COD segment")
        h.coding = [_Coding(body, 5, h.scod)] * h.csiz
    elif marker == 0xFF53:
        c, n = _comp_index(h, body)
        if len(body) < n + 1:
            raise _corrupt("a COC segment cut short")
        h.coding[c] = _Coding(body, n + 1, body[n])
    elif marker == 0xFF5C:
        h.quant = [_Quant(body, 0)] * h.csiz
    elif marker == 0xFF5D:
        c, n = _comp_index(h, body)
        h.quant[c] = _Quant(body, n)
    elif marker == 0xFF5E:
        c, n = _comp_index(h, body)
        if len(body) < n + 2:
            raise _corrupt("an RGN segment cut short")
        h.roi[c] = body[n + 1]
    elif marker == 0xFF5F:
        n = 2 if h.csiz >= 257 else 1
        size = 5 + 2 * n
        if len(body) % size or not body:
            raise _corrupt("a POC segment of a bad length")
        for k in range(len(body) // size):
            e = body[k * size:(k + 1) * size]
            h.poc.append((e[0], int.from_bytes(e[1:1 + n], "big"),
                          int.from_bytes(e[1 + n:3 + n], "big"), e[3 + n],
                          int.from_bytes(e[4 + n:4 + 2 * n], "big") or 256, e[4 + 2 * n]))


# ---------------------------------------------------------------------------
# tier-2: packet headers (OpenJPEG's bio.c, tgt.c and t2.c)
# ---------------------------------------------------------------------------

class _Bits:
    """opj_bio reading: MSB first, 7 bits in the byte after a 0xFF, zeros
    past the end."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.start, self.bp, self.end = data, pos, pos, end
        self.buf, self.ct = 0, 0

    def _bytein(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.bp < self.end:
            self.buf |= self.data[self.bp]
            self.bp += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def inalign(self):
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0


class _TagTree:
    """opj_tgt over a w x h grid of leaves."""

    def __init__(self, w: int, h: int):
        self.parent, self.value, self.low = [], [], []
        sizes = []
        while True:
            sizes.append((w, h))
            if w * h <= 1:
                break
            w, h = -(-w // 2), -(-h // 2)
        base = 0
        for lvl, (lw, lh) in enumerate(sizes):
            nxt = base + lw * lh
            for j in range(lh):
                for i in range(lw):
                    if lvl + 1 < len(sizes):
                        pw = sizes[lvl + 1][0]
                        self.parent.append(nxt + (j // 2) * pw + i // 2)
                    else:
                        self.parent.append(-1)
            base = nxt
        n = len(self.parent)
        self.value, self.low = [999] * n, [0] * n

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> int:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()
        return 1 if self.value[node] < threshold else 0


class _Block:
    """A code-block: its box in its band, its coding state and data."""

    __slots__ = ("x0", "y0", "x1", "y1", "segs", "numbps", "numlenbits", "data", "newpasses")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.segs = []  # [maxpasses, passes, length]
        self.numbps = self.numlenbits = 0
        self.data = bytearray()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _Band:
    def __init__(self, kind: int, x0, y0, x1, y1, numbps: int, step, expn: int):
        self.kind, self.x0, self.y0, self.x1, self.y1 = kind, x0, y0, x1, y1
        self.numbps, self.step, self.expn = numbps, step, expn


class _Resolution:
    pass


class _TileComp:
    """A tile-component's resolutions, bands, precincts and code-blocks
    (opj_tcd_init_tile)."""

    def __init__(self, h: _Header, c: int, tx0, ty0, tx1, ty1):
        cod, q = h.coding[c], h.quant[c]
        if cod is None or q is None:
            raise _corrupt("no COD or QCD for a component")
        self.cod, self.quant = cod, q
        dx, dy = h.dx[c], h.dy[c]
        self.x0, self.y0 = _ceil_div(tx0, dx), _ceil_div(ty0, dy)
        self.x1, self.y1 = _ceil_div(tx1, dx), _ceil_div(ty1, dy)
        nl = cod.levels
        self.res = []
        for r in range(nl + 1):
            lv = nl - r
            R = _Resolution()
            R.x0, R.y0 = _ceil_div(self.x0, 1 << lv), _ceil_div(self.y0, 1 << lv)
            R.x1, R.y1 = _ceil_div(self.x1, 1 << lv), _ceil_div(self.y1, 1 << lv)
            pdx, pdy = cod.ppx[r], cod.ppy[r]
            R.pdx, R.pdy = pdx, pdy
            px0, py0 = (R.x0 >> pdx) << pdx, (R.y0 >> pdy) << pdy
            px1, py1 = _ceil_div(R.x1, 1 << pdx) << pdx, _ceil_div(R.y1, 1 << pdy) << pdy
            R.pw = 0 if R.x0 == R.x1 else (px1 - px0) >> pdx
            R.ph = 0 if R.y0 == R.y1 else (py1 - py0) >> pdy
            if r == 0:
                cbx0, cby0, cgw, cgh = px0, py0, pdx, pdy
                kinds = (0,)
            else:
                cbx0, cby0, cgw, cgh = _ceil_div(px0, 2), _ceil_div(py0, 2), pdx - 1, pdy - 1
                kinds = (1, 2, 3)
            cbw, cbh = min(cod.xcb, cgw), min(cod.ycb, cgh)
            R.bands = []
            for kind in kinds:
                if r == 0:
                    bx0, by0, bx1, by1 = R.x0, R.y0, R.x1, R.y1
                    bi = 0
                else:
                    xb, yb = kind & 1, kind >> 1
                    bx0 = _ceil_div(self.x0 - (xb << lv), 1 << (lv + 1))
                    by0 = _ceil_div(self.y0 - (yb << lv), 1 << (lv + 1))
                    bx1 = _ceil_div(self.x1 - (xb << lv), 1 << (lv + 1))
                    by1 = _ceil_div(self.y1 - (yb << lv), 1 << (lv + 1))
                    bi = 3 * (r - 1) + kind
                expn, mant = q.step(bi)
                gain = 0 if cod.qmfbid == 0 else (0, 1, 1, 2)[kind]
                step = (1.0 + mant / 2048.0) * 2.0 ** (h.prec[c] + gain - expn)
                band = _Band(kind, bx0, by0, bx1, by1, expn + q.guard - 1, step, expn)
                band.precincts = []
                for p in range(R.pw * R.ph):
                    gx0 = cbx0 + (p % R.pw) * (1 << cgw)
                    gy0 = cby0 + (p // R.pw) * (1 << cgh)
                    x0, y0 = max(gx0, bx0), max(gy0, by0)
                    x1, y1 = min(gx0 + (1 << cgw), bx1), min(gy0 + (1 << cgh), by1)
                    sx, sy = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                    ex = _ceil_div(x1, 1 << cbw) << cbw
                    ey = _ceil_div(y1, 1 << cbh) << cbh
                    cw = max((ex - sx) >> cbw, 0) if x1 > x0 else 0
                    ch = max((ey - sy) >> cbh, 0) if y1 > y0 else 0
                    blocks = []
                    for k in range(cw * ch):
                        ux, uy = sx + (k % cw) * (1 << cbw), sy + (k // cw) * (1 << cbh)
                        blocks.append(_Block(max(ux, x0), max(uy, y0), min(ux + (1 << cbw), x1),
                                             min(uy + (1 << cbh), y1)))
                    band.precincts.append((cw, ch, blocks, _TagTree(cw, ch), _TagTree(cw, ch)))
                R.bands.append(band)
            self.res.append(R)


def _numpasses(bits: _Bits) -> int:
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    n = bits.read(2)
    if n != 3:
        return 3 + n
    n = bits.read(5)
    if n != 31:
        return 6 + n
    return 37 + bits.read(7)


def _new_seg(blk: _Block, sty: int, first: bool):
    if sty & _TERMALL:
        most = 1
    elif sty & _LAZY:
        most = 10 if first else (2 if blk.segs[-1][0] in (1, 10) else 1)
    else:
        most = 109
    blk.segs.append([most, 0, 0])


def _packet(tile, data: bytes, pos: int, end: int, hdr, c: int, r: int, p: int, layer: int,
            sop: bool, eph: bool) -> int:
    """Reads one packet (opj_t2_read_packet_header and _data) -> the data
    position after it. ``hdr``: None to read the header in the data, else
    [bytes, position] of its PPM or PPT packed headers."""
    tc = tile.comps[c]
    R = tc.res[r]
    sty = tc.cod.sty
    if sop and end - pos >= 6 and data[pos] == 0xFF and data[pos + 1] == 0x91:
        pos += 6
    if hdr is None:
        bits = _Bits(data, pos, end)
    else:
        bits = _Bits(hdr[0], hdr[1], len(hdr[0]))
    if p >= R.pw * R.ph:
        return pos
    present = bits.bit()
    included = []
    if present:
        for band in R.bands:
            cw, ch, blocks, incl, imsb = band.precincts[p]
            for k, blk in enumerate(blocks):
                if not blk.segs:
                    inc = incl.decode(bits, k, layer + 1)
                else:
                    inc = bits.bit()
                if not inc:
                    continue
                if not blk.segs:
                    i = 0
                    while not imsb.decode(bits, k, i):
                        i += 1
                        if i > 74:  # no more bit planes than a coefficient has
                            raise _corrupt("a zero bit-plane count past 74")
                    blk.numbps = band.numbps + 1 - i
                    blk.numlenbits = 3
                    _new_seg(blk, sty, True)
                elif blk.segs[-1][1] == blk.segs[-1][0]:
                    _new_seg(blk, sty, False)
                n = _numpasses(bits)
                while bits.bit():
                    blk.numlenbits += 1
                segno = len(blk.segs) - 1
                news = []
                while n > 0:
                    seg = blk.segs[segno]
                    take = min(seg[0] - seg[1], n)
                    nbits = blk.numlenbits + take.bit_length() - 1
                    if nbits > 32:
                        raise _corrupt("a code-block length of more than 32 bits")
                    news.append((segno, take, bits.read(nbits)))
                    n -= take
                    if n > 0:
                        _new_seg(blk, sty, False)
                        segno += 1
                included.append((blk, news))
    bits.inalign()
    hp = bits.bp
    if eph:  # a missing EPH fails in OpenJPEG (a missing SOP does not)
        buf, lim = (data, end) if hdr is None else (hdr[0], len(hdr[0]))
        if lim - hp < 2 or buf[hp] != 0xFF or buf[hp + 1] != 0x92:
            raise _corrupt("an EPH marker expected after a packet header")
        hp += 2
    start = pos
    if hdr is None:
        pos = hp
    else:
        hdr[1] = hp
    head_end = pos
    for blk, news in included:
        for segno, take, length in news:
            if pos + length > end:
                raise _corrupt("a code-block segment past the end of its tile's data")
            blk.data += data[pos:pos + length]
            seg = blk.segs[segno]
            seg[1] += take
            seg[2] += length
            pos += length
    tile.spans.append((start, head_end, pos))
    return pos


# ---------------------------------------------------------------------------
# progression orders (OpenJPEG's pi.c)
# ---------------------------------------------------------------------------

def _packet_order(h, tile):
    """(layer, resolution, component, precinct) of each packet, in the
    tile's progression (its POC entries, each packet once)."""
    seen = set()
    runs = h.poc or [(0, 0, h.layers, 33, h.csiz, h.prog)]
    comps = tile.comps
    for rs, cs, le, re, ce, prog in runs:
        if prog > 4:  # opj_pi_next: an unknown progression yields no packet
            continue
        ce, re, le = min(ce, h.csiz), min(re, 33), min(le, h.layers)
        maxres = max(len(tc.res) for tc in comps)
        if prog in (0, 1):
            outer = ((l, r) for l in range(le) for r in range(rs, min(re, maxres))) if prog == 0 \
                else ((l, r) for r in range(rs, min(re, maxres)) for l in range(le))
            for l, r in outer:
                for c in range(cs, ce):
                    if r >= len(comps[c].res):
                        continue
                    R = comps[c].res[r]
                    for p in range(R.pw * R.ph):
                        if (l, r, c, p) not in seen:
                            seen.add((l, r, c, p))
                            yield l, r, c, p
            continue
        # position-driven orders: the tile's reference grid in steps of the
        # smallest precinct
        dxs, dys = [], []
        for c in range(cs, ce):
            tc = comps[c]
            n = len(tc.res)
            for r, R in enumerate(tc.res):
                dxs.append(h.dx[c] << (R.pdx + n - 1 - r))
                dys.append(h.dy[c] << (R.pdy + n - 1 - r))
        if not dxs:
            continue
        stepx, stepy = min(dxs), min(dys)
        tx0, ty0, tx1, ty1 = tile.box

        def ys():
            y = ty0
            while y < ty1:
                yield y
                y += stepy - y % stepy

        def xs():
            x = tx0
            while x < tx1:
                yield x
                x += stepx - x % stepx

        def at(c, r, x, y):
            tc = comps[c]
            if r >= len(tc.res):
                return None
            R = tc.res[r]
            lv = len(tc.res) - 1 - r
            dx, dy = h.dx[c], h.dy[c]
            trx0, try0 = _ceil_div(tx0, dx << lv), _ceil_div(ty0, dy << lv)
            trx1, try1 = _ceil_div(tx1, dx << lv), _ceil_div(ty1, dy << lv)
            rpx, rpy = R.pdx + lv, R.pdy + lv
            if not (y % (dy << rpy) == 0 or (y == ty0 and (try0 << lv) % (1 << rpy))):
                return None
            if not (x % (dx << rpx) == 0 or (x == tx0 and (trx0 << lv) % (1 << rpx))):
                return None
            if not R.pw or not R.ph or trx0 == trx1 or try0 == try1:
                return None
            prci = (_ceil_div(x, dx << lv) >> R.pdx) - (trx0 >> R.pdx)
            prcj = (_ceil_div(y, dy << lv) >> R.pdy) - (try0 >> R.pdy)
            return prci + prcj * R.pw

        if prog == 2:
            order = ((r, y, x, c) for r in range(rs, min(re, maxres)) for y in ys() for x in xs()
                     for c in range(cs, ce))
        elif prog == 3:
            order = ((r, y, x, c) for y in ys() for x in xs() for c in range(cs, ce)
                     for r in range(rs, min(re, maxres)))
        else:
            order = ((r, y, x, c) for c in range(cs, ce) for y in ys() for x in xs()
                     for r in range(rs, min(re, maxres)))
        for r, y, x, c in order:
            p = at(c, r, x, y)
            if p is None:
                continue
            for l in range(le):
                if (l, r, c, p) not in seen:
                    seen.add((l, r, c, p))
                    yield l, r, c, p


# ---------------------------------------------------------------------------
# the codestream
# ---------------------------------------------------------------------------

class _Tile:
    pass


# the markers OpenJPEG has a handler for (j2k_memory_marker_handler_tab), and
# those of them it takes in a main header and in a tile-part header
_KNOWN = {0xFF90, 0xFF52, 0xFF53, 0xFF5E, 0xFF5C, 0xFF5D, 0xFF5F, 0xFF51, 0xFF55, 0xFF57,
          0xFF58, 0xFF60, 0xFF61, 0xFF91, 0xFF63, 0xFF64, 0xFF74, 0xFF78, 0xFF50, 0xFF59,
          0xFF75, 0xFF77}
_IN_MAIN = _KNOWN - {0xFF51, 0xFF58, 0xFF61, 0xFF91}
_IN_TILE = {0xFF52, 0xFF53, 0xFF5E, 0xFF5C, 0xFF5D, 0xFF5F, 0xFF58, 0xFF61, 0xFF64, 0xFF74,
            0xFF75, 0xFF77}


def _skip_unknown(data: bytes, pos: int, allowed: set) -> int:
    """opj_j2k_read_unk from an unknown marker at pos: two bytes at a time
    up to a marker OpenJPEG knows -> its position; one it does not take
    where it stands, or the end of the data, fails."""
    pos += 2
    while True:
        if pos + 2 > len(data):
            raise _corrupt("an unknown marker and no known one after it (stream too short)")
        m = struct.unpack(">H", data[pos:pos + 2])[0]
        if m in _KNOWN:
            if m not in allowed:
                raise _corrupt(f"marker 0x{m:04X} where OpenJPEG takes none")
            return pos
        pos += 2


def _segments(data: bytes, pos: int):
    """(marker, body, position after) of the marker segment at pos."""
    if pos + 4 > len(data):
        raise _corrupt("the codestream ends inside a marker segment")
    marker, n = struct.unpack(">HH", data[pos:pos + 4])
    if marker < 0xFF00:
        raise _corrupt(f"a marker expected at {pos}")
    if n < 2 or pos + 2 + n > len(data):
        raise _corrupt(f"marker 0x{marker:04X}'s segment runs past the end")
    return marker, data[pos + 4:pos + 2 + n], pos + 2 + n


def _merge_ppm(ppm: list) -> list:
    """opj_j2k_merge_ppm: the PPM segments in Zppm order -> [their packed
    headers with the Nppm lengths taken out, read position]; an Nppm cut by
    a segment's end, or a last Nppm past the data, fails."""
    out, left = bytearray(), 0
    for _, body in sorted(ppm, key=lambda t: t[0]):
        at = min(left, len(body))
        out += body[:at]
        left -= at
        while at < len(body):
            if len(body) - at < 4:
                raise _corrupt("not enough bytes to read an Nppm")
            n = struct.unpack(">I", body[at:at + 4])[0]
            chunk = body[at + 4:at + 4 + n]
            out += chunk
            left = n - len(chunk)
            at += 4 + len(chunk)
    if left:
        raise _corrupt("corrupted PPM markers")
    return [bytes(out), 0]


def _codestream(data: bytes):
    """Reads the main header and every tile-part -> (header, {tile: _Tile})
    with each tile's header copy, data and packed headers."""
    if data[:4] != _J2K_MAGIC:
        raise _corrupt("no SOC and SIZ at the codestream's start")
    marker, body, pos = _segments(data, 2)
    h = _siz(body)
    ppm = []
    while True:
        if pos + 2 > len(data):
            raise _corrupt("the codestream ends in its main header")
        marker = struct.unpack(">H", data[pos:pos + 2])[0]
        if marker == 0xFF90:
            break
        if marker == 0xFFD9:
            raise _corrupt("no tile in the codestream")
        if marker >= 0xFF00 and marker not in _KNOWN:
            pos = _skip_unknown(data, pos, _IN_MAIN)
            continue
        marker, body, pos = _segments(data, pos)
        if marker == 0xFF60:
            if not body:
                raise _corrupt("a PPM segment cut short")
            ppm.append((body[0], body[1:]))
        elif marker in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F):
            _header_segment(h, marker, body)
        elif marker == 0xFF51:
            raise _corrupt("a second SIZ")
    if h.scod is None or any(q is None for q in h.quant):
        raise _corrupt("no COD or QCD in the main header")
    h.ppm = _merge_ppm(ppm) if ppm else None
    tiles = {}
    while pos + 2 <= len(data):
        marker = struct.unpack(">H", data[pos:pos + 2])[0]
        if marker == 0xFFD9:
            break
        if marker != 0xFF90:
            raise _corrupt(f"marker 0x{marker:04X} after a tile-part (OpenJPEG fails it)")
        if pos + 2 == len(data):
            break  # an SOT and nothing after it: OpenJPEG finds no more tiles
        sot = pos
        marker, body, pos = _segments(data, pos)
        if len(body) != 8:
            raise _corrupt("a bad SOT segment")
        isot, psot, tpsot, tnsot = struct.unpack(">HIBB", body)
        if isot >= h.ntx * h.nty:
            raise _corrupt("a tile index past the image's tiles")
        end = len(data) if psot == 0 else sot + psot
        if end > len(data):
            raise _corrupt("a tile-part runs past the end of the codestream")
        t = tiles.get(isot)
        if t is None:
            t = tiles[isot] = _Tile()
            t.h, t.data, t.ppt, t.parts, t.nparts = h.copy(), bytearray(), [], 0, 0
        if tnsot:  # opj_j2k_read_sot: TPsot within the tile-part counts given so far
            if (t.nparts and tpsot >= t.nparts) or tpsot >= tnsot:
                raise _corrupt(f"a tile-part index {tpsot} past the tile's {tnsot} parts")
            t.nparts = tnsot
        t.parts += 1
        while True:
            if pos + 2 > end:
                raise _corrupt("a tile-part header without SOD")
            marker = struct.unpack(">H", data[pos:pos + 2])[0]
            if marker == 0xFF93:
                pos += 2
                break
            if marker >= 0xFF00 and marker not in _KNOWN:
                pos = _skip_unknown(data, pos, _IN_TILE)
                continue
            marker, body, pos = _segments(data, pos)
            if marker == 0xFF61:
                if not body:
                    raise _corrupt("a PPT segment cut short")
                t.ppt.append((body[0], body[1:]))
            elif marker in (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F):
                if t.parts > 1 and marker != 0xFF5F:
                    raise _corrupt("a COD, COC, QCD, QCC or RGN after a tile's first part")
                _header_segment(t.h, marker, body)
        if pos > end:
            raise _corrupt("a tile-part shorter than its header")
        t.data += data[pos:end]
        pos = end
        if psot == 0:
            break
        if len(data) - pos < 2:  # OpenJPEG reads the next marker after a tile-part
            raise _corrupt("the codestream ends right after a tile-part (no EOC: OpenJPEG's "
                           "stream too short)")
    return h, tiles


# ---------------------------------------------------------------------------
# reconstruction: dequantization, the inverse DWT, MCT, DC shift
# ---------------------------------------------------------------------------

_ALPHA, _BETA = np.float32(1.586134342), np.float32(0.052980118)
_GAMMA, _DELTA = np.float32(-0.882911075), np.float32(-0.443506852)
_K, _TWO_INVK = np.float32(1.230174105), np.float32(1.625732422)


def _mirror(j: np.ndarray, n: int) -> np.ndarray:
    j = np.where(j < 0, -j, j)
    return np.where(j >= n, 2 * (n - 1) - j, j)


def _idwt53(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """One 5/3 inverse lifting along the last axis of [..., sn + dn] (low
    then high coefficients), the first sample at parity ``cas``."""
    n = x.shape[-1]
    y = np.empty_like(x)
    y[..., cas::2] = x[..., :sn]
    y[..., 1 - cas::2] = x[..., sn:]
    if n == 1:
        return y if cas == 0 else np.trunc(y / 2).astype(y.dtype)  # C division
    idx = np.arange(n)
    lo, hi = idx[cas::2], idx[1 - cas::2]
    y[..., lo] = y[..., lo] - ((y[..., _mirror(lo - 1, n)] + y[..., _mirror(lo + 1, n)] + 2) >> 2)
    y[..., hi] = y[..., hi] + ((y[..., _mirror(hi - 1, n)] + y[..., _mirror(hi + 1, n)]) >> 1)
    return y


def _lift97(y: np.ndarray, targets: np.ndarray, m: int, c: np.float32):
    """opj_v8dwt_decode_step2: each target t += (y[t-1] + y[t+1]) * c, the
    first's left neighbour mirrored, the last (past m) taking its left one
    twice."""
    n = y.shape[-1]
    if not len(targets):
        return
    full, tail = targets[:m], targets[m:]
    if len(full):
        left = y[..., _mirror(full - 1, n)]
        right = y[..., full + 1]
        y[..., full] = y[..., full] + (left + right) * c
    if len(tail):
        t = tail[:1]
        y[..., t] = y[..., t] + y[..., t - 1] * (c + c)


def _idwt97(x: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """opj_v8dwt_decode along the last axis (float32)."""
    n = x.shape[-1]
    dn = n - sn
    y = np.empty_like(x)
    y[..., cas::2] = x[..., :sn]
    y[..., 1 - cas::2] = x[..., sn:]
    if cas == 0 and not (dn > 0 or sn > 1):
        return y
    if cas == 1 and not (sn > 0 or dn > 1):
        return y
    a, b = (0, 1) if cas == 0 else (1, 0)
    idx = np.arange(n)
    lo, hi = idx[a::2][:sn], idx[b::2][:dn]
    y[..., lo] = y[..., lo] * _K
    y[..., hi] = y[..., hi] * _TWO_INVK
    _lift97(y, lo, min(sn, dn - a), _DELTA)
    _lift97(y, hi, min(dn, sn - b), _GAMMA)
    _lift97(y, lo, min(sn, dn - a), _BETA)
    _lift97(y, hi, min(dn, sn - b), _ALPHA)
    return y


def _idwt(tc: _TileComp, bands: dict) -> np.ndarray:
    """The tile-component's coefficients -> samples (int64 or float32)."""
    irrev = tc.cod.qmfbid == 0
    img = bands[(0, 0)]
    for r in range(1, len(tc.res)):
        R, P = tc.res[r], tc.res[r - 1]
        rw, rh = R.x1 - R.x0, R.y1 - R.y0
        sw, sh = P.x1 - P.x0, P.y1 - P.y0
        full = np.zeros((rh, rw), img.dtype)
        full[:sh, :sw] = img
        full[:sh, sw:] = bands[(r, 1)]
        full[sh:, :sw] = bands[(r, 2)]
        full[sh:, sw:] = bands[(r, 3)]
        fn = _idwt97 if irrev else _idwt53
        if rw:
            full = fn(full, sw, R.x0 % 2)
        if rh:
            full = fn(full.T, sh, R.y0 % 2).T
        img = np.ascontiguousarray(full)
    return img


def _t1_python(jobs) -> list:
    return [_t1_block(bytes(b.data), [(s[2], s[1]) for s in b.segs], b.numbps, orient, sty,
                      b.x1 - b.x0, b.y1 - b.y0, roi) for b, orient, sty, roi in jobs]


def _t1_cpp(jobs) -> list:
    """Every code-block in one call of the host C++ ``l2i_j2k_t1``
    (ops/csrc/jpeg2000_t1.cpp, built with the kernels at first use)."""
    from ..ops import _build

    n = len(jobs)
    if not n:
        return []
    data = b"".join(bytes(b.data) for b, *_ in jobs)
    segs = [s for b, *_ in jobs for s in b.segs]
    meta = np.array([[len(b.data), len(b.segs), b.numbps, orient, sty, b.x1 - b.x0, b.y1 - b.y0,
                      roi] for b, orient, sty, roi in jobs], np.int32)
    seg = np.array([[s[2], s[1]] for s in segs] or [[0, 0]], np.int32)
    sizes = meta[:, 5].astype(np.int64) * meta[:, 6]
    out = np.zeros(int(sizes.sum()) or 1, np.int32)
    buf = np.frombuffer(data + b"\0", np.uint8)
    rc = _build.library().l2i_j2k_t1(
        buf.ctypes.data, meta.ctypes.data, seg.ctypes.data, n, out.ctypes.data)
    if rc != 0:
        raise _corrupt("a code-block of 31 or more bit planes" if rc == -2
                       else "l2i_j2k_t1: out of memory")
    res, at = [], 0
    for k in range(n):
        w, hh = int(meta[k, 5]), int(meta[k, 6])
        res.append(out[at:at + w * hh].reshape(hh, w))
        at += w * hh
    return res


def _decode_tile(h: _Header, t, index: int, host_cpp: bool) -> list:
    """One tile -> [samples per component] (int64, after the DC shift and
    the clamp)."""
    th = t.h
    p, q = index % h.ntx, index // h.ntx
    tx0, ty0 = max(h.xto + p * h.xt, h.xo), max(h.yto + q * h.yt, h.yo)
    tx1, ty1 = min(h.xto + (p + 1) * h.xt, h.xsiz), min(h.yto + (q + 1) * h.yt, h.ysiz)
    t.box = (tx0, ty0, tx1, ty1)
    t.comps = [_TileComp(th, c, tx0, ty0, tx1, ty1) for c in range(h.csiz)]
    data = bytes(t.data)
    pos, end = 0, len(data)
    hdr = None
    if h.ppm is not None:
        hdr = h.ppm  # one stream of packed headers, read on from tile to tile
    if t.ppt:
        if hdr is not None:
            raise _corrupt("both PPM and PPT")
        hdr = [b"".join(b for _, b in sorted(t.ppt, key=lambda x: x[0])), 0]
    sop, eph = bool(th.scod & 2), bool(th.scod & 4)
    t.spans = []  # (packet start, header end, packet end) in the tile's data
    for l, r, c, pr in _packet_order(th, t):
        if hdr is None and pos >= end:
            break  # no more data: the rest of the packets are absent
        pos = _packet(t, data, pos, end, hdr, c, r, pr, l, sop, eph)
    out = []
    jobs, where = [], []
    for c, tc in enumerate(t.comps):
        for r, R in enumerate(tc.res):
            for band in R.bands:  # its kind is its orientation: 0 LL, 1 HL, 2 LH, 3 HH
                for prc in band.precincts:
                    for blk in prc[2]:
                        if blk.segs and blk.x1 > blk.x0 and blk.y1 > blk.y0:
                            jobs.append((blk, band.kind, tc.cod.sty, th.roi.get(c, 0)))
                            where.append((c, r, band))
    coefs = (_t1_cpp if host_cpp else _t1_python)(jobs)
    planes = {}
    for c, tc in enumerate(t.comps):
        irrev = tc.cod.qmfbid == 0
        bands = {}
        for r, R in enumerate(tc.res):
            for band in R.bands:
                shape = (band.y1 - band.y0, band.x1 - band.x0)
                bands[(r, band.kind)] = np.zeros(shape, np.float32 if irrev else np.int64)
        planes[c] = bands
    for (blk, *_), (c, r, band), v in zip(jobs, where, coefs):
        tc = t.comps[c]
        dst = planes[c][(r, band.kind)]
        ys, xs = blk.y0 - band.y0, blk.x0 - band.x0
        if tc.cod.qmfbid == 0:
            step = np.float32(np.float32(0.5) * np.float32(band.step))
            dst[ys:ys + v.shape[0], xs:xs + v.shape[1]] = v.astype(np.float32) * step
        else:
            vv = v.astype(np.int64)
            dst[ys:ys + v.shape[0], xs:xs + v.shape[1]] = np.where(vv < 0, -((-vv) // 2), vv // 2)
    for c, tc in enumerate(t.comps):
        out.append(_idwt(tc, planes[c]))
    if th.mct and h.csiz >= 3:
        if any(out[k].shape != out[0].shape for k in (1, 2)):
            raise _corrupt("an MCT over components of different sizes")
        if t.comps[0].cod.qmfbid == 0:
            y, u, v = out[0], out[1], out[2]
            out[0] = y + v * np.float32(1.402)
            out[1] = y - u * np.float32(0.34413) - v * np.float32(0.71414)
            out[2] = y + u * np.float32(1.772)
        else:
            y, u, v = out[0], out[1], out[2]
            g = y - ((u + v) >> 2)
            out[0], out[1], out[2] = v + g, g, u + g
    res = []
    for c, v in enumerate(out):
        prec, sg = h.prec[c], h.sgnd[c]
        lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sg else (0, (1 << prec) - 1)
        shift = 0 if sg else 1 << (prec - 1)
        if t.comps[c].cod.qmfbid == 0:
            f = v.astype(np.float32)
            with np.errstate(invalid="ignore"):
                iv = np.rint(np.nan_to_num(f, nan=0.0)).astype(np.float64)
            iv = np.where(f > np.float32(2 ** 31 - 1), hi - shift,
                          np.where(f < -2.0 ** 31, lo - shift, iv))
            v = np.clip(iv.astype(np.int64) + shift, lo, hi)
        else:
            v = np.clip(v + shift, lo, hi)
        res.append(v.astype(np.int64))
    return res


# ---------------------------------------------------------------------------
# JP2 boxes, Pillow's mode and unpackers
# ---------------------------------------------------------------------------

def _boxes(data: bytes, pos: int, end: int):
    """(type, body start, body end) of each box in [pos, end)."""
    while pos + 8 <= end:
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if n == 1:
            if pos + 16 > end:
                raise _corrupt("a box's extended length cut short")
            n = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            head = 16
        elif n == 0:
            n = end - pos
        if n < head or pos + n > end:
            raise _corrupt(f"box {kind!r} runs past its container")
        yield kind, pos + head, pos + n
        pos += n


def _jp2(data: bytes):
    """A JP2 file -> (codestream, Pillow's mode, colour space, palette)."""
    top = list(_boxes(data, 0, len(data)))
    kinds = [k for k, _, _ in top]
    if b"jp2h" not in kinds or b"jp2c" not in kinds:
        raise _corrupt("a JP2 file without a header or a codestream box")
    if kinds.index(b"jp2h") > kinds.index(b"jp2c"):
        raise _corrupt("the codestream box before the header box")
    _, s, e = top[kinds.index(b"jp2h")]
    mode = size = None
    nc, enumcs, palette = 0, None, None
    color = {}  # OpenJPEG's reading of pclr, cmap and cdef
    for kind, bs, be in _boxes(data, s, e):
        body = data[bs:be]
        if kind in (b"pclr", b"cmap", b"cdef"):
            _color_box(color, kind, body)
        if kind == b"ihdr":
            if len(body) < 14:
                raise _corrupt("an ihdr box cut short")
            hgt, wid, nc, bpc = struct.unpack(">IIHB", body[:11])
            size = (wid, hgt)
            mode = ("I;16" if (bpc & 0x7F) > 8 else "L") if nc == 1 else \
                {2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode)
        elif kind == b"colr":
            if len(body) >= 7 and enumcs is None:
                meth = body[0]
                enumcs = struct.unpack(">I", body[3:7])[0] if meth == 1 else 0
                if nc == 4 and meth == 1 and enumcs == 12:
                    mode = "CMYK"
        elif kind == b"pclr" and mode in ("L", "LA"):
            ne, npc = struct.unpack(">HB", body[:3])
            depths = body[3:3 + npc]
            if max(depths, default=0) <= 8:
                cols, at = [], 3 + npc
                for _ in range(ne):
                    col = tuple(body[at:at + npc])
                    at += npc
                    if col not in cols:  # ImagePalette.getcolor
                        if len(cols) >= 256:
                            raise _corrupt("a palette of more than 256 colours")
                        cols.append(col)
                palette = np.zeros((256, 3), np.uint8)
                if cols:
                    palette[:len(cols)] = np.array([c[:3] for c in cols], np.uint8)[:, :3]
                mode = "P" if mode == "L" else "PA"
    if size is None or mode is None:
        raise _corrupt("a malformed JP2 header")
    # any other (no colr box, an ICC profile, an unlisted enumeration): as if
    # the codestream said nothing
    space = {16: "srgb", 17: "gray", 18: "sycc", 24: "eycc", 12: "cmyk"}.get(enumcs,
                                                                          "unspecified")
    _, s, e = top[kinds.index(b"jp2c")]
    return data[s:e], mode, space, palette


def _color_box(color: dict, kind: bytes, body: bytes):
    """opj_jp2_read_pclr, _cmap and _cdef: what they fail (OpenJPEG reading
    a header to decode tile by tile applies none of them)."""
    if kind == b"pclr":
        if len(body) < 3:
            raise _corrupt("a pclr box cut short")
        ne, npc = struct.unpack(">HB", body[:3])
        if not 1 <= ne <= 1024 or npc == 0 or len(body) < 3 + npc:
            raise _corrupt("an invalid pclr box")
        per = sum(min(((b & 0x7F) + 8) >> 3, 4) for b in body[3:3 + npc])
        if len(body) < 3 + npc + ne * per:
            raise _corrupt("a pclr box's entries cut short")
        color["pclr"] = npc
    elif kind == b"cmap":
        if "pclr" not in color:
            raise _corrupt("a cmap box before a pclr box")
        if "cmap" in color:
            raise _corrupt("a second cmap box")
        n = color["pclr"]
        if len(body) < 4 * n:
            raise _corrupt("a cmap box cut short")
        color["cmap"] = [struct.unpack(">HBB", body[4 * i:4 * i + 4]) for i in range(n)]
    else:
        if len(body) < 2:
            raise _corrupt("a cdef box cut short")
        n = struct.unpack(">H", body[:2])[0]
        if n == 0 or len(body) < 2 + 6 * n:
            raise _corrupt("an invalid cdef box")
        color["cdef"] = [struct.unpack(">HHH", body[2 + 6 * i:8 + 6 * i]) for i in range(n)]


# Jpeg2KDecode.c's unpackers: (mode, colour space, components) -> kind
_UNPACK = {("L", "gray", 1): "l", ("P", "srgb", 1): "l", ("PA", "srgb", 2): "la",
           ("I;16", "gray", 1): "i", ("LA", "gray", 2): "la", ("RGB", "gray", 1): "rgb",
           ("RGB", "gray", 2): "rgb", ("RGB", "srgb", 3): "rgb", ("RGB", "sycc", 3): "ycc",
           ("RGB", "srgb", 4): "rgb", ("RGB", "sycc", 4): "ycc", ("RGBA", "gray", 1): "rgb",
           ("RGBA", "gray", 2): "la", ("RGBA", "srgb", 3): "rgb", ("RGBA", "sycc", 3): "ycc",
           ("RGBA", "gray", 4): "rgba",
           ("RGBA", "srgb", 4): "rgba", ("RGBA", "sycc", 4): "ycca", ("CMYK", "cmyk", 4): "rgba"}
_SUBSAMPLED_OK = {"rgb", "ycc", "rgba", "ycca"}


def _to8(v: np.ndarray, prec: int, sgnd: int, bits: int = 8) -> np.ndarray:
    """A sample as Pillow's unpackers take it: stored in (prec + 7) / 8
    bytes (3 as 4), read unsigned, offset for a signed component, shifted
    to ``bits`` with rounding, and cut to the target's width."""
    csiz = (prec + 7) >> 3
    csiz = 4 if csiz == 3 else csiz
    word = v.astype(np.int64) & ((1 << (8 * csiz)) - 1)
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
        val = (offset + word) >> -shift
    else:
        val = (offset + word) << shift
    return val & ((1 << bits) - 1)


def jpeg2000_decode_rgb(data: bytes, host_cpp: bool = False) -> np.ndarray:
    """J2K or JP2 file bytes -> uint8 [H, W, 3] (see the module); host_cpp:
    tier-1 in the host C++ (the same bit for bit, the same errors)."""
    from .modes import ycbcr_rgb

    data = bytes(data)
    palette = None
    if data[:12] == _JP2_MAGIC:
        cs, mode, space, palette = _jp2(data)
    elif data[:4] == _J2K_MAGIC:
        cs, space = data, "unspecified"
        if len(data) < 43:
            raise _corrupt("a SIZ segment cut short")
        csiz = struct.unpack(">H", data[40:42])[0]
        if csiz == 1:
            mode = "I;16" if (data[42] & 0x7F) + 1 > 8 else "L"
        else:
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}.get(csiz)
            if mode is None:
                raise _corrupt(f"{csiz} components (Pillow cannot tell the image's mode)")
    else:
        raise _corrupt("not a JPEG 2000 file")
    h, tiles = _codestream(cs)
    w, hgt = h.xsiz - h.xo, h.ysiz - h.yo
    if w * hgt > PILLOW_MAX_PIXELS:
        raise _corrupt(f"a {w}x{hgt} image: more pixels than Pillow opens")
    if h.csiz > 4 or space == "eycc":
        raise _corrupt("a component count or colour space Pillow has no unpacker for")
    sub = next((c for c in range(h.csiz) if h.dx[c] != 1 or h.dy[c] != 1), h.csiz)
    if space == "unspecified":
        space = "gray" if h.csiz <= 2 else ("sycc" if 1 <= sub <= 2 else "srgb")
    kind = _UNPACK.get((mode, space, h.csiz))
    if kind is None or (sub < h.csiz and kind not in _SUBSAMPLED_OK):
        raise _corrupt(f"no unpacker for mode {mode}, colour space {space}, {h.csiz} "
                       "components (Pillow fails it)")
    nb = 4 if mode in ("RGB", "RGBA", "CMYK") else (2 if mode in ("LA", "PA") else 1)
    img = np.zeros((hgt, w, nb), np.int64)
    if kind == "rgb" or kind == "ycc":
        img[..., 3:] = 255
    for index in sorted(tiles):
        t = tiles[index]
        samples = _decode_tile(h, t, index, host_cpp)
        tx0, ty0, tx1, ty1 = t.box
        tw, th = tx1 - tx0, ty1 - ty0
        x0, y0 = tx0 - h.xo, ty0 - h.yo
        ncomp = {"l": 1, "i": 1, "la": 2, "rgb": min(h.csiz, 3), "ycc": 3, "rgba": 4,
                 "ycca": 4}[kind]
        # Pillow's tile buffer: OpenJPEG writes each component's samples in
        # (prec + 7) / 8 bytes (3 as 4) one component after another; the
        # unpackers find component n at the sum of csiz x (w / dx) x (h / dy)
        # of those before it, its rows w / dx apart (what a subsampled size
        # that does not divide leaves past the data reads as zeros)
        csz = [4 if (h.prec[n] + 7) >> 3 == 3 else (h.prec[n] + 7) >> 3 for n in range(h.csiz)]
        raw = b"".join((samples[n].reshape(-1) & ((1 << (8 * csz[n])) - 1)).astype(
            f"<u{csz[n]}").tobytes() for n in range(h.csiz))
        yy, xx = np.mgrid[0:th, 0:tw]
        start = 0
        for n in range(ncomp):
            dxn, dyn = h.dx[n], h.dy[n]
            sw, sh = tw // dxn, th // dyn
            at = start + csz[n] * ((yy // dyn) * sw + xx // dxn)
            need = int(at.max()) + csz[n] if at.size else 0
            buf = np.frombuffer(raw[:need] + bytes(max(0, need - len(raw))), np.uint8)
            v = np.zeros(at.shape, np.int64)
            for k in range(csz[n]):
                v |= buf[at + k].astype(np.int64) << (8 * k)
            start += csz[n] * sw * sh
            bits = 16 if kind == "i" else 8
            v = _to8(v, h.prec[n], h.sgnd[n], bits)
            if kind == "rgb" and h.csiz < 3:  # gray (and alpha) as RGB
                if n == 0:
                    img[y0:y0 + th, x0:x0 + tw, :3] = v[..., None]
                continue
            if kind == "la" and mode in ("RGBA",):
                if n == 0:
                    img[y0:y0 + th, x0:x0 + tw, :3] = v[..., None]
                else:
                    img[y0:y0 + th, x0:x0 + tw, 3] = v
                continue
            img[y0:y0 + th, x0:x0 + tw, n] = v
    if kind in ("ycc", "ycca"):  # ImagingConvertYCbCr2RGB on each unpacked row
        img[..., :3] = ycbcr_rgb(img[..., 0], img[..., 1], img[..., 2])
    if mode == "I;16":
        g = np.minimum(img[..., 0], 255).astype(np.uint8)
        return np.repeat(g[..., None], 3, -1)
    if mode in ("P", "PA"):
        return palette[img[..., 0] & 0xFF] if palette is not None else np.zeros(
            (hgt, w, 3), np.uint8)
    if mode == "CMYK":
        from .jpeg import cmyk_to_rgb
        return cmyk_to_rgb(*(img[..., k] for k in range(4)))
    if mode in ("L", "LA"):
        return np.repeat(img[..., :1].astype(np.uint8), 3, -1)
    return np.ascontiguousarray(img[..., :3].astype(np.uint8))
