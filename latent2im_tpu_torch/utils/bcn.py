"""Block-compressed textures (BC1-BC7) in numpy, as Pillow 12.1's
``BcnDecode.c`` decodes them, bit for bit: the GPU machine has no Pillow.

    bcn_decode(data: bytes, w: int, h: int, n: int, signed: bool = False)
        -> uint8 [h, w, 4] (RGBA; BC4 fills R only)

Each 4x4 block of ``data`` (8 bytes for BC1 and BC4, 16 for the rest, in
raster order, ceil(w/4) a row) decodes to 16 pixels, cut at the image's
right and bottom edges; data that ends before the last block fails, as
Pillow's "image file is truncated". As the C decoder computes them:

- BC1: two RGB565 colours widened by bit replication, the two between
  them by integer thirds where c0 > c1, else their integer mean and
  transparent black; BC2 and BC3 take the colour block always as c0 > c1.
- BC2: 4-bit alpha replicated to 8; BC3, BC4 and BC5: eight-value
  ramps by integer sevenths or, where a0 <= a1, fifths plus 0 and 255;
  BC5 signed (``BC5S``) shifts each signed endpoint by 128 and leaves
  blue at 128.
- BC6H: the 14 modes (2 or 5 mode bits; the 4 reserved 5-bit codes give
  black), endpoints gathered through each mode's bit layout, sign extended
  and delta-decoded (the sums masked and not sign extended again), unquantized, interpolated with the BPTC weights,
  scaled by 31/64 (unsigned) or 31/32 (signed) to half floats, widened to
  float32 (``half_to_float``) and clamped to 8 bits.
- BC7: the 8 modes (the first set bit of byte 0; a byte 0 of zero gives
  opaque black), partitions of 1-3 subsets with their anchor indices, p-bits
  per endpoint or per subset, endpoints widened by bit replication, one or
  two index sets (``index_sel`` swapping them), the 6-bit interpolation and
  the channel rotation.

Blocks are decoded together wherever their layout agrees: by mode for BC6H
and BC7, every block at once for BC1-BC5.
"""

from __future__ import annotations

import numpy as np

BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}

# BPTC's two-subset partitions (bit i: pixel i's subset) and three-subset
# partitions (2 bits a pixel)
_P2 = (
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80,
    0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310,
    0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA,
    0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC,
    0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6,
    0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22)
_P3 = (
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0,
    0x5A5A5050, 0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4,
    0xA9A59450, 0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0, 0xA8A85454,
    0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400,
    0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
    0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50, 0x500AA550, 0xAAAA4444,
    0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444,
    0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414, 0x96960000,
    0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44,
    0x2A4A5254)
# the anchor index of the second subset of two, and of the second and third of three
_A2 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8, 8, 15,
       2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15, 15, 6, 6, 2, 6, 8,
       15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
_A31 = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10, 5, 8, 8, 6,
        8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15, 15, 3, 15, 5, 5, 5,
        8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
_A32 = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8, 15, 8, 3,
        15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15, 3, 6, 6, 8, 15, 3,
        15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)
_WEIGHTS = {2: (0, 21, 43, 64), 3: (0, 9, 18, 27, 37, 46, 55, 64),
            4: (0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64)}

_PIX = np.arange(16)
# [64, 16] subset of each pixel, per partition
_SUB2 = (np.array(_P2)[:, None] >> _PIX) & 1
_SUB3 = (np.array(_P3, np.int64)[:, None] >> (2 * _PIX)) & 3


def _anchors(ns: int, part: np.ndarray) -> np.ndarray:
    """[N, 16] bool: the pixels whose index has one bit fewer."""
    a = np.zeros((len(part), 16), bool)
    a[:, 0] = True
    if ns == 2:
        a[np.arange(len(part)), np.array(_A2)[part]] = True
    elif ns == 3:
        a[np.arange(len(part)), np.array(_A31)[part]] = True
        a[np.arange(len(part)), np.array(_A32)[part]] = True
    return a


def _subsets(ns: int, part: np.ndarray) -> np.ndarray:
    if ns == 2:
        return _SUB2[part]
    if ns == 3:
        return _SUB3[part]
    return np.zeros((len(part), 16), np.int64)


def _field(bits: np.ndarray, pos, n) -> np.ndarray:
    """Little-endian bit fields of each block: ``bits`` [N, L] (one byte a
    bit), ``pos`` and ``n`` ints or [N, K] -> [N] or [N, K] int64."""
    pos = np.asarray(pos)
    n = np.asarray(n)
    rows = np.arange(bits.shape[0]).reshape((-1,) + (1,) * max(pos.ndim - 1, 0))
    out = np.zeros(np.broadcast_shapes((bits.shape[0],) + pos.shape[1:], pos.shape,
                                       n.shape if n.ndim else ()), np.int64)
    for k in range(int(n.max(initial=0))):
        if pos.ndim == 0:
            v = bits[:, int(pos) + k].astype(np.int64)
        else:
            v = bits[rows, pos + k].astype(np.int64)
        out |= np.where(k < n, v, 0) << k
    return out


def _bits(blocks: np.ndarray) -> np.ndarray:
    return np.pad(np.unpackbits(blocks, axis=1, bitorder="little"), ((0, 0), (0, 16)))


# ---------------------------------------------------------------------------
# BC1-BC5
# ---------------------------------------------------------------------------

def bc1_color(b: np.ndarray, separate_alpha: bool, replicate: bool = True) -> np.ndarray:
    """[N, 8] colour blocks -> [N, 16, 4] RGBA; ``replicate``: RGB565
    widened by bit replication (else by shifts alone, as Pillow's BLP
    reader's own decode_dxt1 does)."""
    c = b[:, :4].astype(np.int64)
    c0, c1 = c[:, 0] | (c[:, 1] << 8), c[:, 2] | (c[:, 3] << 8)
    lut = b[:, 4:8].astype(np.int64)
    lut = lut[:, 0] | (lut[:, 1] << 8) | (lut[:, 2] << 16) | (lut[:, 3] << 24)

    def rgb565(x):
        r = (x & 0xF800) >> 8
        g = (x & 0x7E0) >> 3
        bl = (x & 0x1F) << 3
        if not replicate:
            return np.stack([r, g, bl], -1)
        return np.stack([r | (r >> 5), g | (g >> 6), bl | (bl >> 5)], -1)

    p0, p1 = rgb565(c0), rgb565(c1)
    four = (c0 > c1)[:, None] | separate_alpha
    p2 = np.where(four, (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four, (p0 + 2 * p1) // 3, 0)
    a3 = np.where(four[:, 0], 255, 0)
    pal = np.stack([np.concatenate([p, np.full((len(b), 1), 255)], -1) for p in (p0, p1, p2)]
                   + [np.concatenate([p3, a3[:, None]], -1)], 1)  # [N, 4, 4]
    idx = (lut[:, None] >> (2 * _PIX)) & 3
    return np.take_along_axis(pal, idx[..., None], 1)


def bc3_alpha(b: np.ndarray, signed: bool) -> np.ndarray:
    """[N, 8] alpha blocks -> [N, 16] values."""
    a0, a1 = b[:, 0].astype(np.int64), b[:, 1].astype(np.int64)
    if signed:
        a0 = b[:, 0].view(np.int8).astype(np.int64) + 128
        a1 = b[:, 1].view(np.int8).astype(np.int64) + 128
    seven = (a0 > a1)[:, None]
    k = np.arange(1, 7)
    ramp7 = ((7 - k) * a0[:, None] + k * a1[:, None]) // 7
    k5 = np.arange(1, 5)
    ramp5 = np.concatenate([((5 - k5) * a0[:, None] + k5 * a1[:, None]) // 5,
                            np.tile([0, 255], (len(b), 1))], 1)
    pal = np.concatenate([a0[:, None], a1[:, None], np.where(seven, ramp7, ramp5)], 1) & 0xFF
    lut = b[:, 2:8].astype(np.int64)
    lo = lut[:, 0] | (lut[:, 1] << 8) | (lut[:, 2] << 16)
    hi = lut[:, 3] | (lut[:, 4] << 8) | (lut[:, 5] << 16)
    idx = np.concatenate([(lo[:, None] >> (3 * np.arange(8))) & 7,
                          (hi[:, None] >> (3 * np.arange(8))) & 7], 1)
    return np.take_along_axis(pal, idx, 1)


# ---------------------------------------------------------------------------
# BC6H
# ---------------------------------------------------------------------------

# (subsets, delta-coded, partition bits, endpoint bits, delta bits r, g, b)
_BC6_MODES = ((2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6), (2, 1, 5, 11, 5, 4, 4),
              (2, 1, 5, 11, 4, 5, 4), (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
              (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5), (2, 1, 5, 8, 5, 5, 6),
              (2, 0, 5, 6, 6, 6, 6), (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
              (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))
# each mode's endpoint bits in stream order: <channel><endpoint><bits>, the
# endpoints w, x, y, z (w, x the first subset's), bits low to high or, as
# "15:10", high to low
_BC6_LAYOUT = (
    "gy4 by4 bz4 rw0:9 gw0:9 bw0:9 rx0:4 gz4 gy0:3 gx0:4 bz0 gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 "
    "rz0:4 bz3",
    "gy5 gz4 gz5 rw0:6 bz0 bz1 by4 gw0:6 by5 bz2 gy4 bw0:6 bz3 bz5 bz4 rx0:5 gy0:3 gx0:5 gz0:3 "
    "bx0:5 by0:3 ry0:5 rz0:5",
    "rw0:9 gw0:9 bw0:9 rx0:4 rw10 gy0:3 gx0:3 gw10 bz0 gz0:3 bx0:3 bw10 bz1 by0:3 ry0:4 bz2 "
    "rz0:4 bz3",
    "rw0:9 gw0:9 bw0:9 rx0:3 rw10 gz4 gy0:3 gx0:4 gw10 gz0:3 bx0:3 bw10 bz1 by0:3 ry0:3 bz0 bz2 "
    "rz0:3 gy4 bz3",
    "rw0:9 gw0:9 bw0:9 rx0:3 rw10 by4 gy0:3 gx0:3 gw10 bz0 gz0:3 bx0:4 bw10 by0:3 ry0:3 bz1 bz2 "
    "rz0:3 bz4 bz3",
    "rw0:8 by4 gw0:8 gy4 bw0:8 bz4 rx0:4 gz4 gy0:3 gx0:4 bz0 gz0:3 bx0:4 bz1 by0:3 ry0:4 bz2 "
    "rz0:4 bz3",
    "rw0:7 gz4 by4 gw0:7 bz2 gy4 bw0:7 bz3 bz4 rx0:5 gy0:3 gx0:4 bz0 gz0:3 bx0:4 bz1 by0:3 "
    "ry0:5 rz0:5",
    "rw0:7 bz0 by4 gw0:7 gy5 gy4 bw0:7 gz5 bz4 rx0:4 gz4 gy0:3 gx0:5 gz0:3 bx0:4 bz1 by0:3 "
    "ry0:4 bz2 rz0:4 bz3",
    "rw0:7 bz1 by4 gw0:7 by5 gy4 bw0:7 bz5 bz4 rx0:4 gz4 gy0:3 gx0:4 bz0 gz0:3 bx0:5 by0:3 "
    "ry0:4 bz2 rz0:4 bz3",
    "rw0:5 gz4 bz0 bz1 by4 gw0:5 gy5 by5 bz2 gy4 bw0:5 gz5 bz3 bz5 bz4 rx0:5 gy0:3 gx0:5 gz0:3 "
    "bx0:5 by0:3 ry0:5 rz0:5",
    "rw0:9 gw0:9 bw0:9 rx0:9 gx0:9 bx0:9",
    "rw0:9 gw0:9 bw0:9 rx0:8 rw10 gx0:8 gw10 bx0:8 bw10",
    "rw0:9 gw0:9 bw0:9 rx0:7 rw11 rw10 gx0:7 gw11 gw10 bx0:7 bw11 bw10",
    "rw0:9 gw0:9 bw0:9 rx0:3 rw15:10 gx0:3 gw15:10 bx0:3 bw15:10",
)


def _bc6_packing(layout: str) -> list:
    """-> [(endpoint field 0-11, bit)] in stream order."""
    out = []
    for tok in layout.split():
        field = "wxyz".index(tok[1]) * 3 + "rgb".index(tok[0])
        lo, _, hi = tok[2:].partition(":")
        lo, hi = int(lo), int(hi or lo)
        step = 1 if hi >= lo else -1
        out += [(field, b) for b in range(lo, hi + step, step)]
    return out


_BC6_PACKINGS = [_bc6_packing(s) for s in _BC6_LAYOUT]


def _sext(v: np.ndarray, prec: int) -> np.ndarray:
    """bc6_sign_extend on UINT16 storage."""
    neg = (v & (1 << (prec - 1))) != 0
    return np.where(neg, v | ((-1 << prec) & 0xFFFF), v) & 0xFFFF


def _bc6_unquantize(v: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    if not signed:
        if bits >= 15:
            return v
        return np.where(v == 0, 0, np.where(v == (1 << bits) - 1, 0xFFFF,
                                             ((v << 16) + 0x8000) >> bits))
    x = np.where(v >= 0x8000, v - 0x10000, v)
    if bits >= 16:
        return x
    s = x < 0
    x = np.abs(x)
    x = np.where(x == 0, 0, np.where(x >= (1 << (bits - 1)) - 1, 0x7FFF,
                                     ((x << 15) + 0x4000) >> (bits - 1)))
    return np.where(s, -x, x)


def half_to_u8(h: np.ndarray) -> np.ndarray:
    """A half float's bits -> Pillow's 8-bit value: BcnDecode.c's
    half_to_float (the bits shifted into a float32 and scaled by 2^112,
    exponent 31 made Inf or NaN), then clamped: below 0 gives 0, above 1
    gives 255, else the float32 product with 255 truncated."""
    h = np.asarray(h, np.int64)
    f = (((h & 0x7FFF) << 13).astype(np.uint32).view(np.float32)
         * np.float32(2.0 ** 112))
    u = f.view(np.uint32).copy()
    u[f >= np.float32(65536.0)] |= np.uint32(255 << 23)
    u |= ((h & 0x8000) << 16).astype(np.uint32)
    f = u.view(np.float32)
    with np.errstate(invalid="ignore"):
        scaled = (f * np.float32(255.0)).astype(np.float32)
        out = np.where(f < 0, 0, np.where(f > 1, 255, np.nan_to_num(scaled, nan=0.0)))
    return out.astype(np.int64)


def _bc6(bits: np.ndarray, byte0: np.ndarray, signed: bool) -> np.ndarray:
    """[N, L] bits of BC6H blocks -> [N, 16, 3] 8-bit values."""
    m = byte0.astype(np.int64) & 0x1F
    low = m & 3
    mode = np.where(low < 2, low, np.where(low == 2, 2 + (m >> 2), 10 + (m >> 2)))
    out = np.zeros((len(bits), 16, 3), np.int64)
    for k in np.unique(mode):
        if k >= 14:
            continue  # reserved: black
        sel = np.nonzero(mode == k)[0]
        b = bits[sel]
        ns, tr, pb, epb, rb, gb, bb = _BC6_MODES[k]
        start = 2 if k < 2 else 5
        pack = _BC6_PACKINGS[k]
        ep = np.zeros((len(sel), 12), np.int64)
        for i, (field, bit) in enumerate(pack):
            ep[:, field] |= b[:, start + i].astype(np.int64) << bit
        at = start + len(pack)
        part = _field(b, at, pb) if pb else np.zeros(len(sel), np.int64)
        at += pb
        numep = 12 if ns == 2 else 6
        mask = (1 << epb) - 1
        if signed:
            ep[:, :3] = _sext(ep[:, :3], epb)
        deltas = [rb, gb, bb]
        if signed or tr:
            for i in range(3, numep):
                ep[:, i] = _sext(ep[:, i], deltas[i % 3])
        if tr:
            for i in range(3, numep):
                ep[:, i] = (ep[:, i] + ep[:, i % 3]) & mask
        ue = _bc6_unquantize(ep[:, :numep], epb, signed)
        ib = 3 if ns == 2 else 4
        anchor = _anchors(ns, part)
        wid = ib - anchor
        pos = at + np.cumsum(wid, 1) - wid
        idx = _field(b, pos, wid)
        wts = np.array(_WEIGHTS[ib])[idx]  # [n, 16]
        sub = _subsets(ns, part) * 6
        e0 = np.take_along_axis(ue, (sub[..., None] + np.arange(3)).reshape(len(sel), -1),
                                1).reshape(len(sel), 16, 3)
        e1 = np.take_along_axis(ue, (sub[..., None] + 3 + np.arange(3)).reshape(len(sel), -1),
                                1).reshape(len(sel), 16, 3)
        v = (e0 * (64 - wts[..., None]) + e1 * wts[..., None]) >> 6
        if signed:
            hv = np.where(v < 0, 0x8000 | ((-v) * 31 // 32), v * 31 // 32)
        else:
            hv = v * 31 // 64
        out[sel] = half_to_u8(hv & 0xFFFF)
    return out


# ---------------------------------------------------------------------------
# BC7
# ---------------------------------------------------------------------------

# (subsets, partition bits, rotation bits, index selection bits, colour
# bits, alpha bits, p-bit per endpoint, p-bit per subset, index bits,
# second index bits)
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))


def _bc7(bits: np.ndarray, byte0: np.ndarray) -> np.ndarray:
    """[N, L] bits of BC7 blocks -> [N, 16, 4] RGBA."""
    n = len(bits)
    out = np.zeros((n, 16, 4), np.int64)
    out[..., 3] = 255  # a byte 0 of zero: opaque black
    low = np.where(byte0 == 0, 8, np.argmax(
        (byte0[:, None].astype(np.int64) >> np.arange(8)) & 1, 1))
    for k in np.unique(low):
        if k == 8:
            continue
        sel = np.nonzero(low == k)[0]
        b = bits[sel]
        ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[k]
        at = k + 1
        part = _field(b, at, pb)
        at += pb
        rot = _field(b, at, rb)
        at += rb
        isel = _field(b, at, isb)
        at += isb
        numep = 2 * ns
        ep = np.zeros((len(sel), numep, 4), np.int64)
        for c in range(3):
            for i in range(numep):
                ep[:, i, c] = _field(b, at, cb)
                at += cb
        for i in range(numep):
            if ab:
                ep[:, i, 3] = _field(b, at, ab)
                at += ab
            else:
                ep[:, i, 3] = 255
        ch = 4 if ab else 3
        if epb or spb:
            cb += 1
            ab += 1 if ab else 0
            for i in range(numep if epb else ns):
                p = b[:, at].astype(np.int64)
                at += 1
                for j in ((i,) if epb else (2 * i, 2 * i + 1)):
                    ep[:, j, :ch] = ((ep[:, j, :ch] << 1) | p[:, None]) & 0xFF
        widths = [cb] * 3 + [ab]
        for c in range(ch):
            v = (ep[..., c] << (8 - widths[c])) & 0xFF
            ep[..., c] = v | (v >> widths[c])
        anchor = _anchors(ns, part)
        wid = ib - anchor
        pos = at + np.cumsum(wid, 1) - wid
        i0 = _field(b, pos, wid)
        cw = np.array(_WEIGHTS[ib])
        sub = _subsets(ns, part) * 2
        e0 = np.take_along_axis(ep, sub[..., None], 1)  # [n, 16, 4]
        e1 = np.take_along_axis(ep, sub[..., None] + 1, 1)
        if ab and ib2:
            at2 = at + 16 * ib - ns
            wid2 = ib2 - (_PIX == 0)
            pos2 = at2 + np.cumsum(wid2) - wid2
            i1 = _field(b, np.broadcast_to(pos2, (len(sel), 16)),
                        np.broadcast_to(wid2, (len(sel), 16)))
            aw = np.array(_WEIGHTS[ib2])
            swap = isel[:, None] != 0
            sc = np.where(swap, aw[i1], cw[i0])
            sa = np.where(swap, cw[i0], aw[i1])
        else:
            sc = sa = cw[i0]
        s = np.concatenate([np.repeat(sc[..., None], 3, -1), sa[..., None]], -1)
        px = ((64 - s) * e0 + s * e1 + 32) >> 6
        for r in (1, 2, 3):
            on = rot == r
            px[on, :, r - 1], px[on, :, 3] = px[on, :, 3].copy(), px[on, :, r - 1].copy()
        out[sel] = px & 0xFF
    return out


def bcn_decode(data: bytes, w: int, h: int, n: int, signed: bool = False) -> np.ndarray:
    """BCn blocks -> uint8 [h, w, 4] (see the module); ``n`` 1-7 as Pillow's
    ``bcn`` decoder takes it, ``signed`` for BC5S and BC6HS."""
    size = BLOCK_BYTES[n]
    bw, bh = -(-w // 4), -(-h // 4)
    need = bw * bh * size
    if len(data) < need:
        raise ValueError("bcn: the block data ends before the image does (Pillow: image file "
                         "is truncated)")
    blocks = np.frombuffer(data, np.uint8, need).reshape(-1, size)
    px = np.zeros((len(blocks), 16, 4), np.int64)
    if n == 1:
        px = bc1_color(blocks, False)
    elif n in (2, 3):
        px = bc1_color(blocks[:, 8:], True)
        if n == 2:
            a = blocks[:, :8].astype(np.int64)
            nib = np.stack([a & 0xF, a >> 4], -1).reshape(-1, 16)
            px[..., 3] = nib | (nib << 4)
        else:
            px[..., 3] = bc3_alpha(blocks[:, :8], False)
    elif n == 4:
        px[..., 0] = bc3_alpha(blocks, False)
    elif n == 5:
        px[..., 0] = bc3_alpha(blocks[:, :8], signed)
        px[..., 1] = bc3_alpha(blocks[:, 8:], signed)
        px[..., 2] = 128 if signed else 0
    elif n == 6:
        px[..., :3] = _bc6(_bits(blocks), blocks[:, 0], signed)
        px[..., 3] = 255
    else:
        px = _bc7(_bits(blocks), blocks[:, 0])
    img = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 4)
    return img[:h, :w].astype(np.uint8)
