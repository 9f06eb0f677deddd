"""Old-style JPEG in TIFF (compression 6) in Python and numpy, as libtiff
4.7's tif_ojpeg.c has libjpeg decode it for Pillow 12.1: the GPU machine has
no Pillow.

    ojpeg_decode_rgb(data, tags, width, height) -> uint8 [H, W, 3]

libtiff reads the JPEG header's markers from the JPEGInterchangeFormat
stream (tags 513, 514), or where there is none from the first strip's
data: SOI, COM and APPn skipped, DRI, DQT (8-bit tables), DHT (each segment
kept whole), SOF0 or SOF1 (8-bit samples, as many components as the image
has samples, the first component's sampling the image's subsampling and the
others 1 x 1, a height and a width the strips allow), up to SOS (its
component count and selectors); where the data starts with no marker, the
tables come from the tags instead (JPEGQTables 519, JPEGDCTables 520,
JPEGACTables 521) and the frame from the image's own size. It writes a
stream of its own for libjpeg: SOI, the tables, DRI (the header's, else
for more than one strip the MCUs a strip holds, else JPEGRestartInterval),
SOF, SOS, then the data after the header's SOS: the rest of its source,
then each strip's bytes with a restart marker between strips, then EOI.
libjpeg decodes that stream (``utils/jpeg.py``'s libjpeg mode, corrupt data
recovered as libjpeg recovers it) into its components' raw planes
(``jpeg_read_raw_data``), which libtiff's RGBA interface converts: one
component as gray, three as YCbCr through TIFFYCbCrtoRGB (its
ReferenceBlackWhite and YCbCrCoefficients), each chroma sample over its
block of luma samples. Where the codec fails a strip's data (a restart
marker out of order: its resync_to_restart raises; no data at all after
the header), the RGBA interface reads that strip from a zeroed buffer if
it is the last; Pillow fails the file where it is not, or where the image
is gray. The header's errors fail the file.

What fails (ValueError) is what libtiff fails in the header (another
marker, a bad DQT, DHT, DRI, SOF or SOS segment, a header that ends
early, missing tables, what libjpeg's jpeg_read_header fails) and a strip
it fails before the last (above), and two forms libtiff always fails: a
lossless (SOF3) frame (it writes libjpeg a sequential scan header, Ss 0
and Se 63, which libjpeg refuses for lossless) and a frame whose other
components are subsampled (libtiff then expects libjpeg's largest sampling
factors to be 1 x 1, which they cannot be). Planar and tiled OJPEG, which
Pillow reads, raise naming ROADMAP item 28.
"""

from __future__ import annotations

import struct

import numpy as np

ITEM = "ROADMAP item 28"


class _In:
    """libtiff's OJPEG input buffer: the JPEGInterchangeFormat bytes, then
    each strip's (OJPEGReadBufferFill), read a byte at a time."""

    def __init__(self, data: bytes, sources):
        self.data = data
        self.sources = sources  # [(offset, length, is a strip)]
        self.k, self.pos = 0, 0

    def _skip_empty(self):
        while self.k < len(self.sources) and self.pos >= self.sources[self.k][1]:
            self.k += 1
            self.pos = 0

    def peek(self) -> int:
        self._skip_empty()
        if self.k >= len(self.sources):
            raise ValueError("ojpeg: the JPEG header ends early (libtiff fails it)")
        off = self.sources[self.k][0]
        return self.data[off + self.pos]

    def byte(self) -> int:
        b = self.peek()
        self.pos += 1
        return b

    def word(self) -> int:
        return (self.byte() << 8) | self.byte()

    def take(self, n: int) -> bytes:
        return bytes(self.byte() for _ in range(n))

    def skip(self, n: int):
        """OJPEGReadSkip: up to n bytes, no further than the data goes."""
        while n > 0:
            self._skip_empty()
            if self.k >= len(self.sources):
                return
            step = min(n, self.sources[self.k][1] - self.pos)
            self.pos += step
            n -= step

    def rest(self) -> bytes:
        """The data from here on: the rest of this source, then the strips
        with a restart marker between them (OJPEGWriteStreamCompressed)."""
        out, rst = bytearray(), 0
        strips = [i for i, s in enumerate(self.sources) if s[2] and s[1] > 0]
        for i in range(self.k, len(self.sources)):
            off, length, strip = self.sources[i]
            start = self.pos if i == self.k else 0
            if start >= length:
                continue
            out += self.data[off + start:off + length]
            if strip and i != strips[-1]:
                out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
        return bytes(out)


def _sources(data: bytes, t: dict, offsets, counts):
    size = len(data)
    out = []
    jif, jlen = t.get(513, (0,))[0], t.get(514, (0,))[0]
    if jif:
        if jif >= size:
            jif = 0
        elif jlen == 0 or jif + jlen > size:
            jlen = size - jif
    if jif:
        out.append((jif, jlen, False))
    for k, off in enumerate(offsets):
        cnt = counts[k] if k < len(counts) else 0
        if off == 0 or off >= size:
            continue
        if cnt == 0 or off + cnt > size:
            cnt = size - off
        out.append((off, cnt, True))
    return out


def _tag_tables(data: bytes, t: dict, spp: int):
    """The table-tag form: DQT and DHT segments from tags 519-521, as
    libtiff's OJPEGReadHeaderInfoSecTables* write them (a table at the
    offset of the sample before is that sample's) -> (segments, the
    samples' quantisation tables, their DC << 4 | AC tables)."""
    offs = {tag: list(t.get(tag, ()))[:3] + [0] * (3 - len(t.get(tag, ())[:3]))
            for tag in (519, 520, 521)}
    if offs[519][0] == 0:
        raise ValueError("ojpeg: missing JPEG tables (libtiff fails it)")
    segs, tq, tda = [], [0] * spp, [0] * spp
    for tag in (519, 520, 521):
        o = offs[tag]
        for m in range(spp):
            if o[m] != 0 and (m == 0 or o[m] != o[m - 1]):
                if any(o[m] == o[n] for n in range(m - 1)):
                    raise ValueError(f"ojpeg: corrupt tag {tag} values (libtiff fails it)")
                if tag == 519:
                    body = data[o[m]:o[m] + 64]
                    if len(body) < 64:
                        raise ValueError("ojpeg: a table past the end (libtiff fails it)")
                    segs.append(b"\xff\xdb\x00\x43" + bytes([m]) + body)
                    tq[m] = m
                    continue
                counts = data[o[m]:o[m] + 16]
                n = sum(counts)
                vals = data[o[m] + 16:o[m] + 16 + n]
                if len(counts) < 16 or len(vals) < n:
                    raise ValueError("ojpeg: a table past the end (libtiff fails it)")
                cls = 0 if tag == 520 else 0x10
                segs.append(b"\xff\xc4" + struct.pack(">H", 19 + n) + bytes([cls | m]) + counts
                            + vals)
                tda[m] = (m << 4) if tag == 520 else (tda[m] | m)
            elif m:
                if tag == 519:
                    tq[m] = tq[m - 1]
                elif tag == 520:
                    tda[m] = tda[m - 1]
                else:
                    tda[m] = (tda[m] & 0xF0) | (tda[m - 1] & 15)
    # libtiff emits the tables by index: quantisation, then DC, then AC
    return segs, tq, tda


def ojpeg_stream(data: bytes, t: dict, width: int, height: int, spp: int, rps: int,
                 offsets, counts) -> bytes:
    """The JPEG stream libtiff's OJPEG codec hands libjpeg (see the module)
    -> (the stream, its restart interval in MCUs, whether the header left
    no data: the codec then fails the first strip's decode)."""
    sh, sv = (1, 1)
    dri = None
    src = _In(data, _sources(data, t, offsets, counts))
    q, dht, sof, sos = {}, {}, None, None
    while True:
        if src.peek() != 0xFF:
            break
        src.byte()
        m = src.byte()
        while m == 0xFF:
            m = src.byte()
        if m == 0xD8:
            continue
        if m == 0xFE or 0xE0 <= m <= 0xEF:
            n = src.word()
            if n < 2:
                raise ValueError("ojpeg: corrupt JPEG data (libtiff fails it)")
            src.skip(n - 2)
        elif m == 0xDD:
            if src.word() != 4:
                raise ValueError("ojpeg: a corrupt DRI marker (libtiff fails it)")
            dri = src.word()
        elif m == 0xDB:
            n = src.word()
            if n <= 2:
                raise ValueError("ojpeg: a corrupt DQT marker (libtiff fails it)")
            n -= 2
            while n > 0:
                if n < 65:
                    raise ValueError("ojpeg: a corrupt DQT marker (libtiff fails it)")
                body = src.take(65)
                if body[0] & 15 > 3:
                    raise ValueError("ojpeg: a corrupt DQT marker (libtiff fails it)")
                q[body[0] & 15] = b"\xff\xdb\x00\x43" + body
                n -= 65
        elif m == 0xC4:
            n = src.word()
            if n <= 2:
                raise ValueError("ojpeg: a corrupt DHT marker (libtiff fails it)")
            body = src.take(n - 2)
            o = body[0]
            if o & 0xF0 not in (0, 0x10) or o & 15 > 3:
                raise ValueError("ojpeg: a corrupt DHT marker (libtiff fails it)")
            dht[o] = b"\xff\xc4" + struct.pack(">H", n) + body
        elif m in (0xC0, 0xC1, 0xC3):
            if sof is not None:
                raise ValueError("ojpeg: corrupt JPEG data, a second SOF (libtiff fails it)")
            if m == 0xC3:
                raise ValueError("ojpeg: a lossless (SOF3) frame (libtiff fails it: libjpeg "
                                 "refuses the sequential scan header it writes)")
            n = src.word()
            if n < 11 or (n - 8) % 3:
                raise ValueError("ojpeg: a corrupt SOF marker (libtiff fails it)")
            nc = (n - 8) // 3
            if nc != spp:
                raise ValueError("ojpeg: a frame of another sample count (libtiff fails it)")
            if src.byte() != 8:
                raise ValueError("ojpeg: a frame of other than 8 bits (libtiff fails it)")
            y, x = src.word(), src.word()
            if y < height:
                raise ValueError("ojpeg: a frame lower than the image (libtiff fails it)")
            if x != width:
                raise ValueError("ojpeg: a frame of another width (libtiff fails it)")
            if src.byte() != nc:
                raise ValueError("ojpeg: a corrupt SOF marker (libtiff fails it)")
            comps = [src.take(3) for _ in range(nc)]
            if spp == 3:
                h0, v0 = comps[0][1] >> 4, comps[0][1] & 15
                if h0 not in (1, 2, 4) or v0 not in (1, 2, 4) or any(
                        c[1] != 0x11 for c in comps[1:]):
                    raise ValueError("ojpeg: chroma sampled other than 1 x 1, or luma "
                                     "other than 1, 2 or 4 (libtiff fails it)")
                sh, sv = h0, v0
            sof = (m, y, x, comps)
        elif m == 0xDA:
            if sof is None:
                raise ValueError("ojpeg: a corrupt SOS marker (libtiff fails it)")
            if src.word() != 6 + 2 * spp or src.byte() != spp:
                raise ValueError("ojpeg: a corrupt SOS marker (libtiff fails it)")
            sos = [src.take(2) for _ in range(spp)]
            src.skip(3)
            break
        else:
            raise ValueError(f"ojpeg: an unknown marker {m:#04x} in the JPEG data (libtiff "
                             "fails it)")
    if sof is None and spp == 3:  # the table-tag form
        sh, sv = t.get(530, (2, 2))
    if rps < height:  # OJPEGReadHeaderInfo: one restart interval a strip
        if sh not in (1, 2, 4) or sv not in (1, 2, 4):
            raise ValueError("ojpeg: invalid subsampling values (libtiff fails it)")
        if rps % (sv * 8):
            raise ValueError("ojpeg: strips of rows no multiple of the MCU's (libtiff "
                             "fails them)")
        restart = -(-width // (sh * 8)) * (rps // (sv * 8))
    else:
        restart = t.get(515, (0,))[0]
    if dri is not None:
        restart = dri
    if sof is None:
        segs, tq, tda = _tag_tables(data, t, spp)
        hv = [(sh << 4) | sv] + [0x11] * (spp - 1)
        sof = (0xC0, height, width, [bytes([c, hv[c], tq[c]]) for c in range(spp)])
        sos = [bytes([c, tda[c]]) for c in range(spp)]
    else:
        segs = [q[k] for k in sorted(q)] + [dht[k] for k in sorted(dht, key=lambda o: (
            o >> 4, o & 15))]
        if sos is None:  # a header that ends before its SOS: the codec's zeroed selectors
            sos = [b"\x00\x00"] * spp
    m, y, x, comps = sof
    out = bytearray(b"\xff\xd8")
    for s in segs:
        out += s
    if restart:
        out += b"\xff\xdd\x00\x04" + struct.pack(">H", restart & 0xFFFF)
    out += bytes([0xFF, m]) + struct.pack(">HBHHB", 8 + 3 * spp, 8, y, x, spp)
    for c in comps:
        out += c
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * spp, spp)
    for c in sos:
        out += c
    out += b"\x00\x3f\x00"
    data = src.rest()
    out += data + b"\xff\xd9"
    return bytes(out), restart, not data


def ojpeg_decode_rgb(data: bytes, t: dict, width: int, height: int, offsets, counts,
                     ycbcr_rgb) -> np.ndarray:
    """An OJPEG TIFF's image (see the module); ycbcr_rgb: libtiff's
    TIFFYCbCrtoRGB over 8-bit samples (``tiff._ycbcr_rgb``)."""
    from .jpeg import _decode_libjpeg

    spp = t.get(277, (1,))[0]
    if spp not in (1, 3):
        raise ValueError(f"ojpeg: {spp} samples a pixel (libtiff fails it)")
    if t.get(284, (1,))[0] == 2 and spp > 1:
        raise ValueError(f"ojpeg: planar OJPEG is not supported yet (Pillow reads it; {ITEM})")
    if 322 in t or 324 in t:
        raise ValueError(f"ojpeg: tiled OJPEG is not supported yet (Pillow reads it; {ITEM})")
    rps = min(t.get(278, (height,))[0], height)
    stream, restart, empty = ojpeg_stream(data, t, width, height, spp, rps, offsets, counts)
    if empty and spp == 3:  # the decode of the first strip fails
        if height > rps:
            raise ValueError("ojpeg: no data after the JPEG header (libtiff's OJPEG codec "
                             "fails the first strip, and Pillow the file)")
        z = np.zeros((height, width), np.int64)
        return ycbcr_rgb(z, z, z, t)
    planes, failed = _decode_libjpeg(stream, "ojpeg")
    if spp == 1:
        if failed is not None:
            raise ValueError("ojpeg: a restart marker out of order (libtiff's OJPEG codec "
                             "fails the strip, and Pillow the file)")
        g = planes[0][:height, :width]
        return np.repeat(g[..., None], 3, axis=-1)
    y = planes[0]
    sh, sv = y.shape[1] // planes[1].shape[1], y.shape[0] // planes[1].shape[0]
    if failed is not None:
        # the strip libtiff fails: where it is the last, the RGBA interface
        # reads its rows from a zeroed buffer; before the last, Pillow fails
        row = failed * restart // -(-width // (8 * sh)) * 8 * sv
        strip = row // rps
        if strip != -(-height // rps) - 1:
            raise ValueError("ojpeg: a restart marker out of order in a strip before the "
                             "last (libtiff's OJPEG codec fails it, and Pillow the file)")
        y[strip * rps:] = 0
        for p in planes[1:]:
            p[strip * rps // sv:] = 0
    y = y[:height, :width].astype(np.int64)
    cb, cr = (np.repeat(np.repeat(p, sv, 0), sh, 1)[:height, :width].astype(np.int64)
              for p in planes[1:])
    return ycbcr_rgb(y, cb, cr, t)
