"""WEBP decoding in numpy and the standard library, as Pillow 12.1 decodes it
(``PIL.Image.open(p).convert("RGB")``: libwebp 1.6.0's WebPAnimDecoder in
MODE_RGBA, its first frame), bit for bit: the GPU machine has no Pillow.

    webp_decode_rgb(data: bytes, host_cpp: bool = False) -> uint8 [H, W, 3]

``host_cpp=True`` runs the same decode, bit for bit and with the same
errors, in the host C++ of ops/csrc/webp_decode.cpp (the card's loaders).

The pieces are libwebp's:

- the RIFF container as ``src/demux/demux.c`` parses and validates it
  (``_demux``): a simple file (``VP8 `` or ``VP8L``) or an extended one
  (``VP8X`` with ``ALPH``, ``ICCP``, ``EXIF``, ``XMP `` and unknown chunks, or
  ``ANIM`` and ``ANMF`` frames). The ICC profile is not applied (Pillow's
  ``convert`` does not), the alpha channel is decoded, so that a file
  libwebp rejects for it is rejected here too, and then dropped, not
  composited. An animation gives its first frame on a zeroed canvas of the
  ``VP8X`` size (``anim_decode.c``: the first frame is a key frame, decoded
  without a blend);
- the lossless bitstream (``VP8L``, RFC 9649, ``src/dec/vp8l_dec.c``,
  ``_vp8l_argb``): simple and normal prefix codes with their code-length
  code, the meta prefix codes of the entropy image, the color cache, LZ77
  with the 120 distance codes, and the predictor (14 modes), cross-color,
  subtract-green and color-indexing transforms (pixel bundling at 2, 4 and
  16 colours), undone in reverse order;
- the lossy bitstream (``VP8 ``, RFC 6386, ``src/dec/{vp8_dec,tree_dec,
  quant_dec,frame_dec}.c`` and ``src/dsp/dec.c``, ``_vp8_rgb``): the
  boolean decoder, the frame header with its segments, filter deltas and
  token probability updates, dequantisation, the 16x16, 4x4 and chroma
  intra predictions with libwebp's edges (127 above the frame, 129 left of
  it, the above-right pixels of the 4x4 blocks in a macroblock's right
  column taken from the macroblock above-right, or its above neighbour's
  last pixel in the image's last column), the inverse DCT and WHT, and the
  normal and simple loop filters with per-segment levels, mode deltas and
  sharpness;
- RGB as libwebp writes it in MODE_RGBA: the "fancy" chroma upsampler of
  ``src/dsp/upsampling.c`` and the 14-bit fixed-point YUV->RGB of
  ``src/dsp/yuv.h``, cropped to the frame's size.

Every error raises ``ValueError`` ("webp: ..."), wherever libwebp or
Pillow fails the file: a truncated or inconsistent container, a bitstream
that reads past its data, an invalid prefix code, an LZ77 copy out of the
image, a canvas of more pixels than Pillow opens (DecompressionBombError).
"""

from __future__ import annotations

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS

MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
MAX_IMAGE_AREA = 1 << 32
ALPHA_FLAG, ANIMATION_FLAG, ALL_VALID_FLAGS = 0x10, 0x02, 0x3E


def _bad(what: str) -> ValueError:
    return ValueError(f"webp: {what}")


def _bomb_check(w: int, h: int) -> None:
    """Pillow's Image.open refuses more pixels than PILLOW_MAX_PIXELS."""
    if w * h > PILLOW_MAX_PIXELS:
        raise _bad(f"a {w}x{h} image: more pixels than Pillow opens ({PILLOW_MAX_PIXELS})")


def _le32(b, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _le24(b, i: int) -> int:
    return int.from_bytes(b[i:i + 3], "little")


# ---------------------------------------------------------------------------
# the container (src/demux/demux.c, src/dec/webp_dec.c)
# ---------------------------------------------------------------------------

class _Frame:
    __slots__ = ("x", "y", "width", "height", "alpha", "image", "complete", "num")

    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.alpha = self.image = None  # (chunk start, chunk size with header)
        self.complete, self.num = False, 0


def _features(chunk: bytes):
    """WebPGetFeatures of a ``VP8 `` or ``VP8L`` chunk -> (width, height);
    raises where it fails."""
    if len(chunk) < 12:
        raise _bad("truncated image chunk")
    size = _le32(chunk, 4)
    data = chunk[8:]
    if chunk[:4] == b"VP8 ":
        _vp8_info(data, size)
        return _le24(data, 6) & 0x3FFF, _le24(data, 8) & 0x3FFF
    return _vp8l_info(data)


def _store_frame(buf: bytes, pos: int, end: int, frame: _Frame, num: int, min_size: int):
    """demux.c StoreFrame: the ALPH and image chunks of one frame from pos
    -> the position after them (at the first chunk that is not one)."""
    if end - pos < 8 or end - pos < min_size:
        raise _bad("truncated frame")
    alpha_chunks = image_chunks = 0
    while True:
        start = pos
        fourcc, size = buf[pos:pos + 4], _le32(buf, pos + 4)
        pos += 8
        if size > MAX_CHUNK_PAYLOAD:
            raise _bad("chunk size out of range")
        padded = size + (size & 1)
        if padded > end - pos:
            raise _bad("a chunk runs past the RIFF end")
        if fourcc == b"VP8L" and alpha_chunks:
            raise _bad("an ALPH chunk before a VP8L image")
        if fourcc == b"ALPH" and alpha_chunks == 0:
            alpha_chunks = 1
            frame.alpha, frame.num = (start, 8 + padded), num
            pos += padded
        elif fourcc in (b"VP8 ", b"VP8L") and image_chunks == 0:
            w, h = _features(buf[start:start + 8 + padded])
            image_chunks = 1
            frame.image, frame.num = (start, 8 + padded), num
            frame.width, frame.height, frame.complete = w, h, True
            pos += padded
        else:
            return start  # a chunk of the level above
        if pos == end:
            return pos
        if end - pos < 8:
            raise _bad("truncated chunk header")


def _demux(data: bytes):
    """WebPDemux's parse and validation -> (canvas width, height, the
    first frame, the file up to its RIFF end)."""
    if len(data) < 20:
        raise _bad("truncated file (shorter than its headers)")
    if data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise _bad("not a RIFF/WEBP file")
    riff_size = _le32(data, 4)
    if riff_size < 12 or riff_size > MAX_CHUNK_PAYLOAD:
        raise _bad("bad RIFF size")
    end = riff_size + 8
    if len(data) < end:
        raise _bad("truncated file (shorter than its RIFF size)")
    buf = data[:end]
    frames = []
    first = buf[12:16]
    if first in (b"VP8 ", b"VP8L"):
        fr = _Frame()
        _store_frame(buf, 12, end, fr, 1, 0)
        fr.alpha = None  # no VP8X: no alpha flag
        if fr.width <= 0 or fr.height <= 0:
            raise _bad("no image")
        _bomb_check(fr.width, fr.height)
        return fr.width, fr.height, fr, buf
    if first != b"VP8X":
        raise _bad("unknown first chunk")
    vsize = _le32(buf, 16)
    if vsize > MAX_CHUNK_PAYLOAD or vsize < 10:
        raise _bad("bad VP8X chunk")
    vsize += vsize & 1
    if vsize > end - 20:
        raise _bad("VP8X chunk runs past the RIFF end")
    flags = buf[20]
    cw, ch = 1 + _le24(buf, 24), 1 + _le24(buf, 27)
    if cw * ch >= MAX_IMAGE_AREA:
        raise _bad("canvas too large")
    pos = 20 + vsize
    if end - pos < 8:
        raise _bad("no chunk after VP8X")
    animated = bool(flags & ANIMATION_FLAG)
    anim_chunks = 0
    while True:
        start = pos
        fourcc, size = buf[pos:pos + 4], _le32(buf, pos + 4)
        pos += 8
        if size > MAX_CHUNK_PAYLOAD:
            raise _bad("chunk size out of range")
        padded = size + (size & 1)
        if padded > end - pos:
            raise _bad("a chunk runs past the RIFF end")
        if fourcc == b"VP8X":
            raise _bad("a second VP8X chunk")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim_chunks or animated:
                raise _bad("an image outside ANMF in an animation")
            if frames:
                raise _bad("a second image")
            fr = _Frame()
            pos = _store_frame(buf, start, end, fr, 1, 0)
            if not flags & ALPHA_FLAG:
                fr.alpha = None  # demux.c: alpha without the flag is dropped
            if frames and not frames[-1].complete:
                raise _bad("a frame after an incomplete one")
            frames.append(fr)
        elif fourcc == b"ANIM":
            if padded < 6:
                raise _bad("bad ANIM chunk")
            anim_chunks = 1
            pos += padded
        elif fourcc == b"ANMF":
            if not anim_chunks:
                raise _bad("ANMF before ANIM")
            if end - pos < 16 or padded < 16:
                raise _bad("bad ANMF chunk")
            fr = _Frame()
            fr.x, fr.y = 2 * _le24(buf, pos), 2 * _le24(buf, pos + 3)
            fw, fh = 1 + _le24(buf, pos + 6), 1 + _le24(buf, pos + 9)
            if fw * fh >= MAX_IMAGE_AREA:
                raise _bad("frame too large")
            pos += 16
            at = pos
            pos = _store_frame(buf, pos, end, fr, len(frames) + 1, padded - 16)
            if pos - at > padded - 16:
                raise _bad("ANMF frame runs past its chunk")
            if animated and fr.num > 0:
                if frames and not frames[-1].complete:
                    raise _bad("a frame after an incomplete one")
                frames.append(fr)
        else:  # ICCP, EXIF, XMP and unknown chunks
            pos += padded
        if pos == end:
            break
        if end - pos < 8:
            raise _bad("truncated chunk header")
    # demux.c IsValidExtendedFormat
    _bomb_check(cw, ch)
    if not frames:
        raise _bad("no frame")
    if flags & ~ALL_VALID_FLAGS & 0xFF:
        raise _bad("unknown VP8X flags")
    for f in frames:
        if not animated and f.num > 1:
            raise _bad("several frames in a still image")
        if not f.complete:
            raise _bad("an incomplete frame")
        if f.alpha is not None and f.image is not None and f.alpha[0] > f.image[0]:
            raise _bad("alpha after the image")
        if f.width <= 0 or f.height <= 0:
            raise _bad("empty frame")
        if not animated:
            if f.x or f.y or f.width != cw or f.height != ch:
                raise _bad("image size differs from the canvas")
        elif f.x + f.width > cw or f.y + f.height > ch:
            raise _bad("frame outside the canvas")
    return cw, ch, frames[0], buf


def webp_decode_rgb(data: bytes, host_cpp: bool = False) -> np.ndarray:
    """WEBP file bytes -> uint8 [H, W, 3], equal to Pillow's
    ``Image.open(f).convert("RGB")`` (see the module docstring); raises
    ValueError where Pillow fails the file.

    host_cpp: the whole decode in one call of the host C++
    ``l2i_webp_decode`` (ops/csrc/webp_decode.cpp, built with the kernels
    at first use; a failed build raises), the same function bit for bit
    with the same errors; the Python and numpy version of this module runs
    otherwise, and stays the plain version the tests hold it to."""
    data = bytes(data)
    if host_cpp:
        return _decode_c(data)
    cw, ch, fr, buf = _demux(data)
    start, size = fr.image
    image = buf[start + 8:start + size]
    alpha = None
    if fr.alpha is not None:  # the ALPH payload as ParseOptionalChunks finds it
        a0 = fr.alpha[0]
        alpha = buf[a0 + 8:a0 + 8 + _le32(buf, a0 + 4)]
    if buf[start:start + 4] == b"VP8L":
        w, h = _vp8l_info(image)
        rgb = _vp8l_rgb(image, w, h)
    else:
        declared = _le32(buf, start + 4)
        _vp8_info(image, declared)
        rgb = _vp8_rgb(image, alpha)
    h, w = rgb.shape[:2]
    if (w, h) == (cw, ch):
        return rgb
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[fr.y:fr.y + h, fr.x:fr.x + w] = rgb
    return canvas


# ---------------------------------------------------------------------------
# VP8L: the lossless bitstream (src/dec/vp8l_dec.c)
# ---------------------------------------------------------------------------

class _LBits:
    """The VP8L bit reader, least significant bit first. Past the data it
    reads zeros; ``eos()`` is libwebp's end of stream: more bits consumed
    than the data holds (than 64 for data shorter than 8 bytes)."""

    __slots__ = ("data", "pos", "limit")

    def __init__(self, data: bytes):
        self.data = bytes(data) + bytes(16)
        self.pos = 0
        self.limit = 8 * max(len(data), 8)

    def read(self, n: int) -> int:
        p = self.pos
        if p > self.limit:
            return 0  # libwebp reads 0 once at the end of stream
        i = p >> 3
        v = (int.from_bytes(self.data[i:i + 4], "little") >> (p & 7)) & ((1 << n) - 1)
        self.pos = p + n
        return v

    def eos(self) -> bool:
        return self.pos > self.limit


def _vp8l_info(data: bytes):
    """VP8LGetInfo -> (width, height)."""
    if len(data) < 5 or data[0] != 0x2F or data[4] >> 5:
        raise _bad("bad VP8L signature")
    v = int.from_bytes(data[1:5], "little")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1


CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# (dx, dy) of the 120 short distance codes (RFC 9649, 4.2.2): dist = dx + dy * width
_PLANE = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1), (-2, 1),
    (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3), (3, 1), (-3, 1), (2, 3), (-2, 3),
    (3, 2), (-3, 2), (0, 4), (4, 0), (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3),
    (2, 4), (-2, 4), (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4), (-4, 4),
    (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0), (1, 6), (-1, 6), (6, 1), (-6, 1),
    (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6),
    (6, 3), (-6, 3), (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2), (3, 7), (-3, 7),
    (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0), (4, 7), (-4, 7), (7, 4),
    (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5),
    (8, 4), (6, 7), (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))


def _huffman(lengths, alphabet: int):
    """huffman_utils.c BuildHuffmanTable's checks, then the code's lookup
    table over its longest code's bits (LSB first) -> (table of symbol <<
    4 | length, its bits); one symbol: a zero-bit code. Raises for an
    over-subscribed or incomplete code, or one with no symbol."""
    lengths = np.asarray(lengths[:alphabet], np.int64)
    used = np.nonzero(lengths)[0]
    if used.size == 0:
        raise _bad("a prefix code with no symbol")
    if used.size == 1:
        return [int(used[0]) << 4], 0
    counts = np.bincount(lengths[used], minlength=16)
    left = 1
    for n in range(1, 16):
        left = 2 * left - int(counts[n])
        if left < 0:
            raise _bad("an over-subscribed prefix code")
    if left:
        raise _bad("an incomplete prefix code")
    order = used[np.lexsort((used, lengths[used]))]
    lens = lengths[order]
    maxlen = int(lens.max())
    codes = np.zeros(order.size, np.int64)  # canonical codes, MSB first
    code = 0
    prev = int(lens[0])
    for i in range(order.size):
        code <<= int(lens[i]) - prev
        prev = int(lens[i])
        codes[i] = code
        code += 1
    rev = np.zeros_like(codes)  # bit-reversed: LSB-first keys
    for b in range(maxlen):
        rev |= ((codes >> b) & 1) << (lens - 1 - b)
    table = np.zeros(1 << maxlen, np.int64)
    for i in range(order.size):
        step = 1 << int(lens[i])
        table[int(rev[i])::step] = (int(order[i]) << 4) | int(lens[i])
    return table.tolist(), maxlen


def _read_code(br: _LBits, alphabet: int):
    """vp8l_dec.c ReadHuffmanCode -> the code's (table, bits)."""
    lengths = [0] * max(alphabet, 256)
    if br.read(1):  # simple code: one or two symbols
        n = br.read(1) + 1
        first = br.read(1 if br.read(1) == 0 else 8)
        lengths[first] = 1
        if n == 2:
            lengths[br.read(8)] = 1
    else:
        clc = [0] * 19
        for i in range(br.read(4) + 4):
            clc[CODE_LENGTH_ORDER[i]] = br.read(3)
        table, bits = _huffman(clc, 19)
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > alphabet:
                raise _bad("a code-length count past the alphabet")
        else:
            max_symbol = alphabet
        prev, sym = 8, 0
        while sym < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            e = table[_peek(br, bits)]
            br.pos += e & 15
            code_len = e >> 4
            if code_len < 16:
                lengths[sym] = code_len
                sym += 1
                if code_len:
                    prev = code_len
            else:
                extra, offset = ((2, 3), (3, 3), (7, 11))[code_len - 16]
                repeat = br.read(extra) + offset
                if sym + repeat > alphabet:
                    raise _bad("a code-length repeat past the alphabet")
                fill = prev if code_len == 16 else 0
                for _ in range(repeat):
                    lengths[sym] = fill
                    sym += 1
    if br.eos():
        raise _bad("VP8L data ends inside a prefix code")
    return _huffman(lengths, alphabet)


def _peek(br: _LBits, n: int) -> int:
    if n == 0:
        return 0
    p = br.pos
    i = p >> 3
    return (int.from_bytes(br.data[i:i + 4], "little") >> (p & 7)) & ((1 << n) - 1)


def _prefix_value(sym: int, br: _LBits) -> int:
    """A length or distance prefix symbol and its extra bits -> the value."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _decode_image(br: _LBits, xsize: int, ysize: int, level0: bool, alpha8=None):
    """vp8l_dec.c DecodeImageStream -> (ARGB pixels as a flat int list of
    the coded width, the transforms read, the coded width). level0: the
    main image (transforms and an entropy image allowed). alpha8: a list
    that gets whether libwebp would decode this alpha plane 8 bits a pixel
    (its end-of-stream rule differs)."""
    transforms = []
    if level0:
        seen = 0
        while br.read(1):
            ttype = br.read(2)
            if seen & (1 << ttype):
                raise _bad("a VP8L transform used twice")
            seen |= 1 << ttype
            if ttype in (0, 1):  # predictor, cross-color
                bits = br.read(3) + 2
                sub, _, _ = _decode_image(br, _subsample(xsize, bits), _subsample(ysize, bits),
                                          False)
                transforms.append((ttype, xsize, bits, sub))
            elif ttype == 3:  # color indexing
                n = br.read(8) + 1
                bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                pal, _, _ = _decode_image(br, n, 1, False)
                transforms.append((3, xsize, bits, _expand_palette(pal, n, bits)))
                xsize = _subsample(xsize, bits)
            else:
                transforms.append((2, xsize, 0, None))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise _bad("bad VP8L color cache size")
    meta, meta_bits, meta_w = None, 0, 0
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        meta_w = _subsample(xsize, meta_bits)
        img, _, _ = _decode_image(br, meta_w, _subsample(ysize, meta_bits), False)
        meta = [(p >> 8) & 0xFFFF for p in img]
    n_groups = max(meta) + 1 if meta else 1
    cache_size = 1 << cache_bits if cache_bits else 0
    groups = []
    for _ in range(n_groups):
        groups.append([_read_code(br, a) for a in
                       (256 + 24 + cache_size, 256, 256, 256, 40)])
    if alpha8 is not None:
        alpha8.append(len(transforms) == 1 and transforms[0][0] == 3 and not cache_bits and
                      all(g[1][1] == 0 and g[2][1] == 0 and g[3][1] == 0 for g in groups))
    if br.eos():
        raise _bad("VP8L data ends in its header")
    pixels = _decode_pixels(br, xsize, ysize, groups, meta, meta_bits, meta_w, cache_bits,
                            bool(alpha8 and alpha8[-1]))
    return pixels, transforms, xsize


def _decode_pixels(br, width, height, groups, meta, meta_bits, meta_w, cache_bits, alpha8):
    """vp8l_dec.c DecodeImageData (DecodeAlphaData where alpha8: there the
    stream may end with the last pixel) -> the ARGB pixels, a flat list.
    Each group is five (lookup table, bits) codes: green with the length
    and cache symbols, red, blue, alpha, distance."""
    total = width * height
    out = [0] * total
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cached = 0  # the pixels before this one are in the cache
    pos = x = y = 0
    data, limit = br.data, br.limit
    g = groups[0]
    while pos < total:
        if meta is not None:
            g = groups[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        (gt, gb), (rt, rb), (bt, bb), (at, ab), (dt, db) = g
        p = br.pos
        i = p >> 3
        window = int.from_bytes(data[i:i + 8], "little") >> (p & 7)
        e = gt[window & ((1 << gb) - 1)]
        window >>= e & 15
        p += e & 15
        code = e >> 4
        if code < 256:  # a literal: green, red, blue, alpha
            e = rt[window & ((1 << rb) - 1)]
            window >>= e & 15
            p += e & 15
            red = e >> 4
            e = bt[window & ((1 << bb) - 1)]
            p += e & 15
            blue = e >> 4
            i = p >> 3
            e = at[(int.from_bytes(data[i:i + 4], "little") >> (p & 7)) & ((1 << ab) - 1)]
            p += e & 15
            br.pos = p
            out[pos] = ((e >> 4) << 24) | (red << 16) | (code << 8) | blue
            pos += 1
            x += 1
            if x >= width:
                x = 0
                y += 1
        elif code < 280:  # an LZ77 copy
            br.pos = p
            length = _prefix_value(code - 256, br)
            p = br.pos
            i = p >> 3
            e = dt[(int.from_bytes(data[i:i + 4], "little") >> (p & 7)) & ((1 << db) - 1)]
            br.pos = p + (e & 15)
            dist_code = _prefix_value(e >> 4, br)
            if dist_code > 120:
                dist = dist_code - 120
            else:
                dx, dy = _PLANE[dist_code - 1]
                dist = max(dx + dy * width, 1)
            if br.pos > limit:
                break
            if dist > pos or total - pos < length:
                raise _bad("an LZ77 copy outside the image")
            for k in range(pos, pos + length):
                out[k] = out[k - dist]
            pos += length
            x += length
            while x >= width:
                x -= width
                y += 1
        else:  # a color cache entry
            br.pos = p
            while cached < pos:
                c = out[cached]
                cache[((c * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = c
                cached += 1
            out[pos] = cache[code - 280]
            pos += 1
            x += 1
            if x >= width:
                x = 0
                y += 1
        if br.pos > limit:
            break
    if br.eos() and not (alpha8 and pos >= total):
        raise _bad("VP8L data ends before the image does")
    return out


def _expand_palette(pal, n: int, bits: int):
    """vp8l_dec.c ExpandColorMap: the delta-coded palette summed per byte,
    padded with zeros to 2^(8 >> bits) entries."""
    out = [0] * (1 << (8 >> bits))
    prev = 0
    for i in range(n):
        c = pal[i]
        if i:
            c = (((c & 0xFF00FF00) + (prev & 0xFF00FF00)) & 0xFF00FF00) | \
                (((c & 0x00FF00FF) + (prev & 0x00FF00FF)) & 0x00FF00FF)
        out[i] = prev = c
    return out


def _add(a: int, b: int) -> int:
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) |
            (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _avg2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _clip255(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _predict(mode: int, L: int, T: int, TR: int, TL: int) -> int:
    """lossless.c's predictors 0-13 (14 and 15 are 0, as libwebp pads its
    table)."""
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return _avg2(_avg2(L, TR), T)
    if mode == 6:
        return _avg2(L, TL)
    if mode == 7:
        return _avg2(L, T)
    if mode == 8:
        return _avg2(TL, T)
    if mode == 9:
        return _avg2(T, TR)
    if mode == 10:
        return _avg2(_avg2(L, TL), _avg2(T, TR))
    if mode == 11:  # Select(T, L, TL)
        d = 0
        for s in (24, 16, 8, 0):
            t, lft, tl = (T >> s) & 0xFF, (L >> s) & 0xFF, (TL >> s) & 0xFF
            d += abs(lft - tl) - abs(t - tl)
        return T if d <= 0 else L
    if mode == 12:  # ClampedAddSubtractFull(L, T, TL)
        out = 0
        for s in (24, 16, 8, 0):
            out |= _clip255(((L >> s) & 0xFF) + ((T >> s) & 0xFF) - ((TL >> s) & 0xFF)) << s
        return out
    if mode == 13:  # ClampedAddSubtractHalf(Average2(L, T), TL)
        ave = _avg2(L, T)
        out = 0
        for s in (24, 16, 8, 0):
            a, b = (ave >> s) & 0xFF, (TL >> s) & 0xFF
            d = a - b
            out |= _clip255(a + (d // 2 if d >= 0 else -((-d) // 2))) << s
        return out
    return 0xFF000000


def _inverse_predictor(px: list, width: int, height: int, bits: int, modes: list):
    """The predictor transform undone in place over rows of ARGB ints."""
    tiles_w = _subsample(width, bits)
    if not width:
        return
    px[0] = _add(px[0], 0xFF000000)
    for x in range(1, width):
        px[x] = _add(px[x], px[x - 1])
    for y in range(1, height):
        row = y * width
        up = row - width
        px[row] = _add(px[row], px[up])
        trow = (y >> bits) * tiles_w
        for x in range(1, width):
            mode = (modes[trow + (x >> bits)] >> 8) & 15
            i = row + x
            px[i] = _add(px[i], _predict(mode, px[i - 1], px[up + x], px[up + x + 1],
                                         px[up + x - 1]))


def _inverse_transforms(px: list, height: int, transforms):
    """The transforms undone in reverse order -> ARGB uint32 [h, w]."""
    arr = None
    for ttype, xsize, bits, data in reversed(transforms):
        if ttype == 0:
            if arr is not None:
                px = arr.ravel().tolist()
            _inverse_predictor(px, xsize, height, bits, data)
            arr = None
            continue
        if arr is None:
            arr = np.asarray(px, np.uint32).reshape(height, -1)
        if ttype == 2:  # subtract green
            g = (arr >> 8) & 0xFF
            rb = ((arr & 0x00FF00FF) + (g << 16 | g)) & 0x00FF00FF
            arr = (arr & 0xFF00FF00) | rb
        elif ttype == 1:  # cross color
            tiles = np.asarray(data, np.uint32).reshape(_subsample(height, bits), -1)
            yy, xx = np.mgrid[0:height, 0:xsize]
            m = tiles[yy >> bits, xx >> bits].astype(np.int64)
            g2r = ((m & 0xFF) ^ 0x80) - 0x80
            g2b = (((m >> 8) & 0xFF) ^ 0x80) - 0x80
            r2b = (((m >> 16) & 0xFF) ^ 0x80) - 0x80
            a = arr.astype(np.int64)
            green = (((a >> 8) & 0xFF) ^ 0x80) - 0x80
            red = ((a >> 16) & 0xFF) + ((g2r * green) >> 5)
            red &= 0xFF
            blue = (a & 0xFF) + ((g2b * green) >> 5)
            blue += (r2b * ((red ^ 0x80) - 0x80)) >> 5
            blue &= 0xFF
            arr = ((a & 0xFF00FF00) | (red << 16) | blue).astype(np.uint32)
        else:  # color indexing
            pal = np.asarray(data, np.uint32)
            idx = (arr >> 8) & 0xFF
            if bits:
                per = 1 << bits
                bpp = 8 >> bits
                shifts = (np.arange(xsize) % per) * bpp
                idx = (idx[:, np.arange(xsize) >> bits] >> shifts) & ((1 << bpp) - 1)
            arr = pal[idx]
    if arr is None:
        arr = np.asarray(px, np.uint32).reshape(height, -1)
    return arr


def _vp8l_argb(data: bytes, width: int, height: int, level0_header: bool, alpha8=None):
    br = _LBits(data)
    if level0_header:
        br.pos = 40  # signature, size, alpha and version (checked by _vp8l_info)
    px, transforms, _ = _decode_image(br, width, height, True, alpha8)
    return _inverse_transforms(px, height, transforms)


def _vp8l_rgb(data: bytes, width: int, height: int) -> np.ndarray:
    """A VP8L bitstream -> uint8 [h, w, 3]."""
    argb = _vp8l_argb(data, width, height, True)
    return np.stack([(argb >> 16) & 0xFF, (argb >> 8) & 0xFF, argb & 0xFF], -1).astype(np.uint8)


def _alpha_check(alpha: bytes, width: int, height: int) -> None:
    """alpha_dec.c ALPHInit and ALPHDecode: the ALPH chunk's header and
    payload as libwebp checks them (the plane itself is dropped)."""
    if len(alpha) <= 1:
        raise _bad("empty ALPH chunk")
    method, pre, rsrv = alpha[0] & 3, (alpha[0] >> 4) & 3, alpha[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise _bad("bad ALPH header")
    if method == 0:
        if len(alpha) - 1 < width * height:
            raise _bad("ALPH data shorter than the image")
        return
    _vp8l_argb(alpha[1:], width, height, False, [])


# ---------------------------------------------------------------------------
# VP8: the lossy bitstream (src/dec/*.c, src/dsp/dec.c)
# ---------------------------------------------------------------------------

def _vp8_info(data: bytes, chunk_size: int) -> None:
    """VP8GetInfo's checks of a key frame header."""
    if len(data) < 10:
        raise _bad("truncated VP8 frame header")
    if data[3:6] != b"\x9d\x01\x2a":
        raise _bad("bad VP8 signature")
    bits = _le24(data, 0)
    if bits & 1:
        raise _bad("not a key frame")
    if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= chunk_size:
        raise _bad("bad VP8 frame header")
    if not _le24(data, 6) & 0x3FFF or not _le24(data, 8) & 0x3FFF:
        raise _bad("zero VP8 width or height")


class _BoolDecoder:
    """bit_reader.h's VP8GetBit (range kept as range - 1), one byte at a
    time: the same bits and the same ``eof`` as libwebp's 56-bit loads,
    which also set it only when a bit is wanted past the last byte."""

    __slots__ = ("data", "pos", "end", "value", "range", "bits", "eof")

    def __init__(self, data: bytes, start: int, size: int):
        self.data, self.pos, self.end = data, start, start + size
        self.value, self.range, self.bits, self.eof = 0, 254, -8, False
        self._load()

    def _load(self) -> None:
        if self.pos < self.end:
            self.value = (self.value << 8) | self.data[self.pos]
            self.pos += 1
            self.bits += 8
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = True
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        rng = self.range
        pos = self.bits
        split = (rng * prob) >> 8
        if (self.value >> pos) > split:
            rng -= split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            rng = split + 1
            bit = 0
        shift = 8 - rng.bit_length()
        self.range = (rng << shift) - 1
        self.bits = pos - shift
        return bit

    def value_bits(self, n: int) -> int:
        v = 0
        while n > 0:
            n -= 1
            v |= self.bit(0x80) << n
        return v

    def signed_bits(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v




def _table(hexes: str, shape) -> list:
    return np.frombuffer(bytes.fromhex(hexes), np.uint8).reshape(shape).tolist()


# RFC 6386 13.5: the default token probabilities [type][band][context][11]
_COEF_PROBS = _table(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4"
    "db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff8080"
    "80b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001b9f9fff3ff8080808080b896f7ff"
    "ece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa8bf1fcecd1ffff80"
    "80802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7"
    "ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ffc2e08080"
    "8080800101ff8080808080808080f601ff8080808080808080ff80808080808080808080c623"
    "eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf800195f1ffdde0ff"
    "ff808080b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5f2c4ffff8063"
    "79d2fac9c6ffca808080175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5"
    "ffff8080802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff808080"
    "1664aef5baa1ffc780808001b6f9ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1"
    "d3ffcd808080019df7ffece7ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe08080"
    "800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fb"
    "cfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff80"
    "8080ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933db"
    "ffc4ba8080808080452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff8080"
    "8080808d7cf8ffff8080808080800110f8ffff808080808080be24e6ffecff80808080809501"
    "ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff80808080"
    "808080800186fcffff808080808080d53efaffff808080808080375dff808080808080808080"
    "8080808080808080808080808080808080808080808080808080808080808080ca18d5ebbabf"
    "dca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6fac7bff79fffff80"
    "a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7f9dcffff807c4abff3b7"
    "c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080"
    "801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3"
    "a4adffcb80808001def8ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff80"
    "80800179ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd8080800101ff"
    "8080808080808080f401ff8080808080808080ee01ff8080808080808080", (4, 8, 3, 11))

# RFC 6386 13.4: the probabilities that each token probability is updated
_COEF_UPDATE = _table(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffff"
    "ffffffffffffdff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffff"
    "ffeafefefffffffffffffffffdfffffffffffffffffffffff6feffffffffffffffffeffdfeff"
    "fffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffbfffeffffffffffff"
    "fffffffffffffffffffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffe"
    "fffffffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffd9ff"
    "ffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfefffffffffeffffffffff"
    "ffffffffdffefeffffffffffffffffeefdfefefffffffffffffffff8fefffffffffffffffff9"
    "fefffffffffffffffffffffffffffffffffffffffffffdfffffffffffffffffff7feffffffff"
    "fffffffffffffffffffffffffffffffffffdfefffffffffffffffffcffffffffffffffffffff"
    "fffffffffffffffffffffffffefefffffffffffffffffdffffffffffffffffffffffffffffff"
    "fffffffffffffffefdfffffffffffffffffafffffffffffffffffffffeffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffbafbfaff"
    "ffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffff"
    "ffffecfdfefffffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefe"
    "fffffffffffffffffffffffffffffffffffffffffefffffffffffffffffffefeffffffffffff"
    "fffffffefffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff8ffffffffff"
    "fffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfdffffffffffffffff"
    "f6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcfffffffffffffffff8fefdffff"
    "fffffffffffffdfffefefffffffffffffffffbfefffffffffffffffff5fbfeffffffffffffff"
    "fffdfdfefffffffffffffffffffbfdfffffffffffffffffcfdfefffffffffffffffffffeffff"
    "fffffffffffffffffcfffffffffffffffffff9fffefffffffffffffffffffffeffffffffffff"
    "fffffffffdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff", (4, 8, 3, 11))

# RFC 6386 11.5: the 4x4 mode probabilities [above mode][left mode]
_BMODE_PROBS = _table(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a"
    "11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f140872"
    "72d00c09e251280b60b6541d102486b7598962656aa59448bb64829d6f204b504266a7634a3e"
    "28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380684f0c1bd9ff5711"
    "075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b"
    "61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a6240221674"
    "ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e5f55"
    "39323033c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a"
    "196d582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab"
    "29280566d3b70401dd333211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b"
    "5ab43ba65d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e1618"
    "8001361125412049731c801780cd2803097333c01206df572509733b4d40152f68372cda0936"
    "3582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a2086271335dd1a722049"
    "ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c037"
    "26467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105"
    "47663935293126210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a55"
    "8065c41a39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771c"
    "de25442d8022012f0bf5ab3e1113469255373e46252b259a64a355a0013f095c881c4020c955"
    "4b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928a432"
    "1f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d12d10155b"
    "40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab"
    "0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420654b808b76927480"
    "5538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e9224131eabff611b148a"
    "2d3d3edb0151bc4020291475978e1415a370130c3dc380300418", (10, 10, 9))

# RFC 6386 14.1: the quantiser step by index, DC and AC
_DC_Q = (4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22,
         22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39,
         40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59,
         60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79,
         80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106,
         108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143,
         145, 148, 151, 154, 157)
_AC_Q = (4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
         27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47,
         48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78,
         80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
         119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167,
         170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234,
         239, 245, 249, 254, 259, 264, 269, 274, 279, 284)
_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
         (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3  # libwebp's mode numbers


def _w16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


def _large_value(br: _BoolDecoder, p) -> int:
    """tree_dec.c GetLargeValue: a token of magnitude 2 or more."""
    bit = br.bit
    if not bit(p[3]):
        return 2 if not bit(p[4]) else 3 + bit(p[5])
    if not bit(p[6]):
        if not bit(p[7]):
            return 5 + bit(159)
        return 7 + 2 * bit(165) + bit(145)
    b1 = bit(p[8])
    cat = 2 * b1 + bit(p[9 + b1])
    v = 0
    for prob in _CATS[cat]:
        v = v + v + bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _BoolDecoder, probs, ctx: int, dq0: int, dq1: int, n: int, out, base: int) -> int:
    """tree_dec.c GetCoeffs: one block's tokens into out[base:base + 16]
    (raster order, dequantised, int16) -> the index after its last
    non-zero coefficient."""
    bit = br.bit
    p = probs[n][ctx]
    while n < 16:
        if not bit(p[0]):
            return n  # end of block
        while not bit(p[1]):  # a zero
            n += 1
            if n == 16:
                return 16
            p = probs[n][0]
        if not bit(p[2]):
            v = 1
            p = probs[n + 1][1]
        else:
            v = _large_value(br, p)
            p = probs[n + 1][2]
        if bit(0x80):
            v = -v
        out[base + _ZIGZAG[n]] = _w16(v * (dq1 if n else dq0))
        n += 1
    return 16


class _VP8Header:
    """The key frame's header (vp8_dec.c VP8GetHeaders, quant_dec.c,
    tree_dec.c VP8ParseProba)."""

    def __init__(self, data: bytes):
        if len(data) < 10:
            raise _bad("truncated VP8 frame header")
        part0 = _le24(data, 0) >> 5
        self.width = _le24(data, 6) & 0x3FFF
        self.height = _le24(data, 8) & 0x3FFF
        if part0 > len(data) - 10:
            raise _bad("bad VP8 partition length")
        br = self.br = _BoolDecoder(data, 10, part0)
        bit = br.bit
        bit(0x80), bit(0x80)  # colour space, clamping type (libwebp ignores both)
        # segments (ParseSegmentHeader)
        self.use_segment = bit(0x80)
        self.update_map, self.absolute, q, f = 0, 1, [0] * 4, [0] * 4
        self.seg_probs = [255, 255, 255]
        if self.use_segment:
            self.update_map = bit(0x80)
            if bit(0x80):
                self.absolute = bit(0x80)
                q = [br.signed_bits(7) if bit(0x80) else 0 for _ in range(4)]
                f = [br.signed_bits(6) if bit(0x80) else 0 for _ in range(4)]
            if self.update_map:
                self.seg_probs = [br.value_bits(8) if bit(0x80) else 255 for _ in range(3)]
        if br.eof:
            raise _bad("VP8 data ends in its segment header")
        # loop filter (ParseFilterHeader)
        simple, level, sharpness = bit(0x80), br.value_bits(6), br.value_bits(3)
        ref_lf, mode_lf = [0] * 4, [0] * 4
        if bit(0x80) and bit(0x80):  # lf deltas used, and updated
            ref_lf = [br.signed_bits(6) if bit(0x80) else 0 for _ in range(4)]
            mode_lf = [br.signed_bits(6) if bit(0x80) else 0 for _ in range(4)]
        self.filter_type = 0 if level == 0 else 1 if simple else 2
        if br.eof:
            raise _bad("VP8 data ends in its filter header")
        # token partitions (ParsePartitions)
        last = (1 << br.value_bits(2)) - 1
        at = 10 + part0
        size = len(data) - at
        if size < 3 * last:
            raise _bad("truncated VP8 partition sizes")
        start, left = at + 3 * last, size - 3 * last
        self.parts = []
        for p in range(last):
            psize = min(_le24(data, at + 3 * p), left)
            self.parts.append(_BoolDecoder(data, start, psize))
            start += psize
            left -= psize
        self.parts.append(_BoolDecoder(data, start, left))
        if start >= len(data):
            raise _bad("no data in the last VP8 partition")
        # quantisers (VP8ParseQuant)
        base = br.value_bits(7)
        dy1_dc, dy2_dc, dy2_ac, duv_dc, duv_ac = (
            br.signed_bits(4) if bit(0x80) else 0 for _ in range(5))
        self.quant = []
        for s in range(4):
            if self.use_segment:
                qs = q[s] + (0 if self.absolute else base)
            elif s:
                self.quant.append(self.quant[0])
                continue
            else:
                qs = base

            def clip(v, m):
                return 0 if v < 0 else m if v > m else v

            y2_ac = (_AC_Q[clip(qs + dy2_ac, 127)] * 101581) >> 16
            self.quant.append((
                (_DC_Q[clip(qs + dy1_dc, 127)], _AC_Q[clip(qs, 127)]),
                (_DC_Q[clip(qs + dy2_dc, 127)] * 2, max(y2_ac, 8)),
                (_DC_Q[clip(qs + duv_dc, 117)], _AC_Q[clip(qs + duv_ac, 127)])))
        bit(0x80)  # update_proba, ignored
        probs = []
        for t in range(4):  # VP8ParseProba
            bands = []
            for b in range(8):
                bands.append([[br.value_bits(8) if bit(_COEF_UPDATE[t][b][c][k])
                               else _COEF_PROBS[t][b][c][k] for k in range(11)]
                              for c in range(3)])
            probs.append([bands[_BANDS[n]] for n in range(17)])
        self.probs = probs
        self.use_skip = bit(0x80)
        self.skip_p = br.value_bits(8) if self.use_skip else 0
        # frame_dec.c PrecomputeFilterStrengths: (limit, ilevel, hev) by
        # segment and i4x4
        self.fstrength = []
        for s in range(4):
            lvl = f[s] + (0 if self.absolute else level) if self.use_segment else level
            row = []
            for i4 in (0, 1):
                lv = lvl + ref_lf[0] + (mode_lf[0] if i4 else 0)
                lv = 0 if lv < 0 else 63 if lv > 63 else lv
                if lv > 0:
                    il = lv
                    if sharpness > 0:
                        il >>= 2 if sharpness > 4 else 1
                        il = min(il, 9 - sharpness)
                    il = max(il, 1)
                    row.append((2 * lv + il, il, 2 if lv >= 40 else 1 if lv >= 15 else 0))
                else:
                    row.append((0, 0, 0))
            self.fstrength.append(row)


def _parse_modes(br: _BoolDecoder, hd: _VP8Header, mb_w: int, top: list):
    """One macroblock row's intra modes from partition 0 (tree_dec.c
    ParseIntraMode) -> [(segment, skip, is_i4x4, modes, uv mode)]."""
    bit = br.bit
    left = [0] * 4
    out = []
    for mb_x in range(mb_w):
        seg = 0
        if hd.update_map:
            sp = hd.seg_probs
            seg = bit(sp[1]) if not bit(sp[0]) else 2 + bit(sp[2])
        skip = bit(hd.skip_p) if hd.use_skip else 0
        is_i4 = not bit(145)
        t = 4 * mb_x
        if not is_i4:
            if bit(156):
                mode = TM_PRED if bit(128) else H_PRED
            else:
                mode = V_PRED if bit(163) else DC_PRED
            modes = mode
            top[t:t + 4] = [mode] * 4
            left = [mode] * 4
        else:
            modes = []
            for y in range(4):
                ymode = left[y]
                for x in range(4):
                    p = _BMODE_PROBS[top[t + x]][ymode]
                    if not bit(p[0]):
                        ymode = 0  # B_DC_PRED
                    elif not bit(p[1]):
                        ymode = 1  # B_TM_PRED
                    elif not bit(p[2]):
                        ymode = 2  # B_VE_PRED
                    elif not bit(p[3]):
                        ymode = (3 if not bit(p[4]) else 4 if not bit(p[5]) else 5)
                    elif not bit(p[6]):
                        ymode = 6  # B_LD_PRED
                    elif not bit(p[7]):
                        ymode = 7  # B_VL_PRED
                    else:
                        ymode = 8 if not bit(p[8]) else 9
                    top[t + x] = ymode
                modes.extend(top[t:t + 4])
                left[y] = ymode
        uv = DC_PRED if not bit(142) else V_PRED if not bit(114) else (
            TM_PRED if bit(183) else H_PRED)
        out.append((seg, skip, is_i4, modes, uv))
    return out


def _residuals(br: _BoolDecoder, hd: _VP8Header, mb, nz_top: list, nz_left: list, mb_x: int,
               coefs: list, base: int) -> bool:
    """tree_dec.c ParseResiduals: one macroblock's 25 blocks of tokens
    into coefs[base:base + 400] (16 Y, 4 U, 4 V blocks of 16, then the 16
    Y2 values) -> whether all are zero. nz_top[mb_x] / nz_left hold the
    (nz bits, nz_dc) contexts."""
    seg, _, is_i4, _, _ = mb
    (y1_dc, y1_ac), (y2_dc, y2_ac), (uv_dc, uv_ac) = hd.quant[seg]
    probs = hd.probs
    tnz, tdc = nz_top[mb_x]
    lnz, ldc = nz_left
    any_nz = False  # any block's NzCodeBits
    if not is_i4:
        nz = _coeffs(br, probs[1], tdc + ldc, y2_dc, y2_ac, 0, coefs, base + 384)
        tdc = ldc = int(nz > 0)
        coefs[base:base + 256:16] = _wht(coefs[base + 384:base + 400])
        first, ac = 1, probs[0]
    else:
        first, ac = 0, probs[3]
    t, lft = tnz & 15, lnz & 15
    for y in range(4):
        lbit = lft & 1
        for x in range(4):
            ctx = lbit + (t & 1)
            b = base + 16 * (4 * y + x)
            n = _coeffs(br, ac, ctx, y1_ac if first else y1_dc, y1_ac, first, coefs, b)
            lbit = int(n > first)
            any_nz |= n > 1 or coefs[b] != 0
            t = (t >> 1) | (lbit << 7)
        t >>= 4
        lft = (lft >> 1) | (lbit << 7)
    out_t, out_l = t, lft >> 4
    for ch in (0, 2):
        t, lft = tnz >> (4 + ch), lnz >> (4 + ch)
        for y in range(2):
            lbit = lft & 1
            for x in range(2):
                ctx = lbit + (t & 1)
                b = base + 256 + 32 * ch + 16 * (2 * y + x)
                n = _coeffs(br, probs[2], ctx, uv_dc, uv_ac, 0, coefs, b)
                lbit = int(n > 0)
                any_nz |= n > 1 or coefs[b] != 0
                t = (t >> 1) | (lbit << 3)
            t >>= 2
            lft = (lft >> 1) | (lbit << 5)
        out_t |= (t << 4) << ch
        out_l |= (lft & 0xF0) << ch
    nz_top[mb_x] = (out_t, tdc)
    nz_left[0], nz_left[1] = out_l, ldc
    return not any_nz


def _wht(c) -> list:
    """dec.c TransformWHT: the 16 Y2 values -> the 16 luma DCs (int16)."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = c[i] + c[12 + i], c[4 + i] + c[8 + i]
        a2, a3 = c[4 + i] - c[8 + i], c[i] - c[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        dc = tmp[4 * i] + 3
        a0, a1 = dc + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], dc - tmp[4 * i + 3]
        out[4 * i:4 * i + 4] = (_w16((a0 + a1) >> 3), _w16((a3 + a2) >> 3),
                                _w16((a0 - a1) >> 3), _w16((a3 - a2) >> 3))
    return out


def _idct(coef: np.ndarray) -> np.ndarray:
    """dec.c TransformOne over blocks [N, 16] (raster) -> what it adds to
    the prediction, [N, 4, 4]: the vertical pass, then the horizontal one
    with its rounder, >> 3."""
    c = coef.astype(np.int64).reshape(-1, 4, 4)

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    a, b = c[:, 0] + c[:, 2], c[:, 0] - c[:, 2]
    cc, d = mul2(c[:, 1]) - mul1(c[:, 3]), mul1(c[:, 1]) + mul2(c[:, 3])
    t = (a + d, b + cc, b - cc, a - d)  # t[k][:, i]: column i's k-th value
    rows = []
    for k in range(4):
        dc = t[k][:, 0] + 4
        a, b = dc + t[k][:, 2], dc - t[k][:, 2]
        cc = mul2(t[k][:, 1]) - mul1(t[k][:, 3])
        d = mul1(t[k][:, 1]) + mul2(t[k][:, 3])
        rows.append(np.stack([(a + d) >> 3, (b + cc) >> 3, (b - cc) >> 3, (a - d) >> 3], -1))
    return np.stack(rows, 1)


def _a3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _a2(a, b):
    return (a + b + 1) >> 1


def _pred4(w, r: int, c: int, mode: int):
    """dec.c's 4x4 predictors for the block whose top-left neighbour is
    w[r][c] (w: rows of ints; the block is w[r + 1:r + 5][c + 1:c + 5],
    the 8 pixels above it from w[r][c + 1]) -> its 4 rows."""
    top = w[r]
    X = top[c]
    A, B, C, D, E, F, G, H = top[c + 1:c + 9]
    I, J, K, L = w[r + 1][c], w[r + 2][c], w[r + 3][c], w[r + 4][c]
    if mode == 0:  # DC4
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        return [[v] * 4] * 4
    if mode == 1:  # TM4
        return [[min(max(t + lv - X, 0), 255) for t in (A, B, C, D)] for lv in (I, J, K, L)]
    if mode == 2:  # VE4
        return [[_a3(X, A, B), _a3(A, B, C), _a3(B, C, D), _a3(C, D, E)]] * 4
    if mode == 3:  # HE4
        return [[_a3(X, I, J)] * 4, [_a3(I, J, K)] * 4, [_a3(J, K, L)] * 4, [_a3(K, L, L)] * 4]
    if mode == 4:  # RD4: constant along the down-right diagonals
        e = (L, K, J, I, X, A, B, C, D)
        v = [_a3(e[i], e[i + 1], e[i + 2]) for i in range(7)]
        return [[v[x - y + 3] for x in range(4)] for y in range(4)]
    if mode == 6:  # LD4: constant along the down-left diagonals
        t = (A, B, C, D, E, F, G, H, H)
        v = [_a3(t[i], t[i + 1], t[i + 2]) for i in range(7)]
        return [[v[x + y] for x in range(4)] for y in range(4)]
    if mode == 5:  # VR4
        return [[_a2(X, A), _a2(A, B), _a2(B, C), _a2(C, D)],
                [_a3(I, X, A), _a3(X, A, B), _a3(A, B, C), _a3(B, C, D)],
                [_a3(J, I, X), _a2(X, A), _a2(A, B), _a2(B, C)],
                [_a3(K, J, I), _a3(I, X, A), _a3(X, A, B), _a3(A, B, C)]]
    if mode == 7:  # VL4
        return [[_a2(A, B), _a2(B, C), _a2(C, D), _a2(D, E)],
                [_a3(A, B, C), _a3(B, C, D), _a3(C, D, E), _a3(D, E, F)],
                [_a2(B, C), _a2(C, D), _a2(D, E), _a3(E, F, G)],
                [_a3(B, C, D), _a3(C, D, E), _a3(D, E, F), _a3(F, G, H)]]
    if mode == 8:  # HD4
        return [[_a2(I, X), _a3(I, X, A), _a3(X, A, B), _a3(A, B, C)],
                [_a2(J, I), _a3(J, I, X), _a2(I, X), _a3(I, X, A)],
                [_a2(K, J), _a3(K, J, I), _a2(J, I), _a3(J, I, X)],
                [_a2(L, K), _a3(L, K, J), _a2(K, J), _a3(K, J, I)]]
    return [[_a2(I, J), _a3(I, J, K), _a2(J, K), _a3(J, K, L)],  # HU4
            [_a2(J, K), _a3(J, K, L), _a2(K, L), _a3(K, L, L)],
            [_a2(K, L), _a3(K, L, L), L, L],
            [L, L, L, L]]


def _pred_block(mode: int, mb_x: int, mb_y: int, top, left, tl: int, size: int) -> np.ndarray:
    """dec.c's 16x16 luma and 8x8 chroma predictors, with frame_dec.c
    CheckMode's DC variants without the top row (mb_y 0), the left column
    (mb_x 0) or both."""
    if mode == DC_PRED:
        shift = 5 if size == 16 else 4
        if mb_x and mb_y:
            v = (int(top.sum() + left.sum()) + (1 << (shift - 1))) >> shift
        elif mb_x:  # no top
            v = (int(left.sum()) + (1 << (shift - 2))) >> (shift - 1)
        elif mb_y:  # no left
            v = (int(top.sum()) + (1 << (shift - 2))) >> (shift - 1)
        else:
            v = 0x80
        return np.full((size, size), v, np.int64)
    if mode == TM_PRED:
        return np.clip(top[None, :] + left[:, None] - tl, 0, 255)
    if mode == V_PRED:
        return np.broadcast_to(top[None, :], (size, size))
    return np.broadcast_to(left[:, None], (size, size))


def _context(plane: np.ndarray, y0: int, x0: int, size: int, mb_x: int, mb_y: int):
    """frame_dec.c ReconstructRow's neighbours of a macroblock: the row
    above (127 above the frame), the column left (129 left of it) and the
    corner (127 on the top row, else 129 in the left column)."""
    top = plane[y0 - 1, x0:x0 + size].astype(np.int64) if mb_y else np.full(size, 127, np.int64)
    left = plane[y0:y0 + size, x0 - 1].astype(np.int64) if mb_x else np.full(size, 129, np.int64)
    tl = 127 if not mb_y else 129 if not mb_x else int(plane[y0 - 1, x0 - 1])
    return top, left, tl


def _to_plane(res: np.ndarray, n: int) -> np.ndarray:
    """Residual blocks [n * n, 4, 4] in raster order -> [4n, 4n]."""
    return res.reshape(n, n, 4, 4).transpose(0, 2, 1, 3).reshape(4 * n, 4 * n)


def _reconstruct(hd: _VP8Header, infos, res: np.ndarray, mb_w: int, mb_h: int):
    """frame_dec.c ReconstructRow over the frame: each macroblock's
    prediction plus its residuals, in raster order, before any loop
    filtering -> the Y, U, V planes (macroblock-padded)."""
    Y = np.zeros((16 * mb_h, 16 * mb_w), np.uint8)
    U = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
    V = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            i = mb_y * mb_w + mb_x
            is_i4, modes, uv = infos[i][:3]
            r = res[i]
            y0, x0 = 16 * mb_y, 16 * mb_x
            top, left, tl = _context(Y, y0, x0, 16, mb_x, mb_y)
            if is_i4:
                if not mb_y:
                    tr = [127] * 4
                elif mb_x == mb_w - 1:
                    tr = [int(Y[y0 - 1, x0 + 15])] * 4
                else:
                    tr = Y[y0 - 1, x0 + 16:x0 + 20].astype(int).tolist()
                # the work area of rows -1..15, columns -1..19; the
                # above-right pixels repeated on rows 3, 7 and 11
                w = [[0] * 21 for _ in range(17)]
                w[0] = [tl] + top.tolist() + tr
                for j in range(16):
                    w[j + 1][0] = int(left[j])
                for j in (4, 8, 12):
                    w[j][17:21] = tr
                rl = r[:16].tolist()
                for n in range(16):
                    by, bx = 4 * (n >> 2), 4 * (n & 3)
                    pred = _pred4(w, by, bx, modes[n])
                    rb = rl[n]
                    for yy in range(4):
                        row = w[by + 1 + yy]
                        pr, rr = pred[yy], rb[yy]
                        for xx in range(4):
                            v = pr[xx] + rr[xx]
                            row[bx + 1 + xx] = 0 if v < 0 else 255 if v > 255 else v
                Y[y0:y0 + 16, x0:x0 + 16] = np.asarray([row[1:17] for row in w[1:]], np.uint8)
            else:
                pred = _pred_block(modes, mb_x, mb_y, top, left, tl, 16)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + _to_plane(r[:16], 4), 0, 255)
            for k, P in ((0, U), (1, V)):
                c0, cx = 8 * mb_y, 8 * mb_x
                top, left, tl = _context(P, c0, cx, 8, mb_x, mb_y)
                pred = _pred_block(uv, mb_x, mb_y, top, left, tl, 8)
                P[c0:c0 + 8, cx:cx + 8] = np.clip(
                    pred + _to_plane(r[16 + 4 * k:20 + 4 * k], 2), 0, 255)
    return Y, U, V


def _filter_edge(seg: np.ndarray, thresh: int, ithresh: int, hev_t: int, kind: str) -> None:
    """dec.c's loop filters across one edge, in place: seg [n, 8] holds
    p3 p2 p1 p0 | q0 q1 q2 q3 of the n positions along it (a view of the
    plane; [n, 4], p1 p0 | q0 q1, for the simple filter). kind: "simple",
    "mb" (FilterLoop26: DoFilter6 where not high edge variance) or "inner"
    (FilterLoop24: DoFilter4)."""
    s = seg.astype(np.int64)
    if kind == "simple":
        p1, p0, q0, q1 = s.T
    else:
        p3, p2, p1, p0, q0, q1, q2, q3 = s.T
    t2 = 2 * thresh + 1
    m = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= t2
    if kind != "simple":
        for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
            m &= np.abs(a - b) <= ithresh
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    else:
        hev = np.ones_like(m)
    if not m.any():
        return

    def clip1(v):
        return np.clip(v, 0, 255)

    def sclip1(v):
        return np.clip(v, -128, 127)

    def sclip2(v):
        return np.clip(v, -16, 15)

    out = s.copy()
    o = 2 if kind != "simple" else 0  # index of p1
    # DoFilter2: 4 pixels in, 2 out
    a = 3 * (q0 - p0) + sclip1(p1 - q1)
    a1, a2 = sclip2((a + 4) >> 3), sclip2((a + 3) >> 3)
    f2 = m & hev
    out[:, o + 1] = np.where(f2, clip1(p0 + a2), out[:, o + 1])
    out[:, o + 2] = np.where(f2, clip1(q0 - a1), out[:, o + 2])
    if kind == "inner":  # DoFilter4
        a = 3 * (q0 - p0)
        a1, a2 = sclip2((a + 4) >> 3), sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        f4 = m & ~hev
        for col, v in ((2, clip1(p1 + a3)), (3, clip1(p0 + a2)), (4, clip1(q0 - a1)),
                       (5, clip1(q1 - a3))):
            out[:, col] = np.where(f4, v, out[:, col])
    elif kind == "mb":  # DoFilter6
        a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1))
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        f6 = m & ~hev
        for col, v in ((1, clip1(p2 + a3)), (2, clip1(p1 + a2)), (3, clip1(p0 + a1)),
                       (4, clip1(q0 - a1)), (5, clip1(q1 - a2)), (6, clip1(q2 - a3))):
            out[:, col] = np.where(f6, v, out[:, col])
    seg[...] = out


def _loop_filter(hd: _VP8Header, infos, Y, U, V, mb_w: int, mb_h: int) -> None:
    """frame_dec.c DoFilter over the frame in macroblock raster order:
    left edge, inner vertical edges, top edge, inner horizontal edges (the
    simple filter on luma only)."""
    simple = hd.filter_type == 1
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            limit, ilevel, hev_t, inner = infos[mb_y * mb_w + mb_x][3:]
            if limit == 0:
                continue
            y0, x0 = 16 * mb_y, 16 * mb_x
            planes = [(Y, y0, x0, 16)] if simple else [
                (Y, y0, x0, 16), (U, 8 * mb_y, 8 * mb_x, 8), (V, 8 * mb_y, 8 * mb_x, 8)]
            w = 2 if simple else 4
            kinds = ("simple", "simple") if simple else ("mb", "inner")
            if mb_x > 0:
                for P, r, c, n in planes:
                    _filter_edge(P[r:r + n, c - w:c + w], limit + 4, ilevel, hev_t, kinds[0])
            if inner:
                for P, r, c, n in planes:
                    for e in range(4, n, 4) if n == 16 else (4,):
                        _filter_edge(P[r:r + n, c + e - w:c + e + w], limit, ilevel, hev_t,
                                     kinds[1])
            if mb_y > 0:
                for P, r, c, n in planes:
                    _filter_edge(P[r - w:r + w, c:c + n].T, limit + 4, ilevel, hev_t, kinds[0])
            if inner:
                for P, r, c, n in planes:
                    for e in range(4, n, 4) if n == 16 else (4,):
                        _filter_edge(P[r + e - w:r + e + w, c:c + n].T, limit, ilevel, hev_t,
                                     kinds[1])


def _upsample_pair(T: np.ndarray, C: np.ndarray, width: int):
    """upsampling.c UpsampleRgbaLinePair's chroma for one pair of output
    rows: T, C the chroma rows above and below [n, (width + 1) // 2] ->
    (the top row's, the bottom row's) [n, width]."""
    T, C = T.astype(np.int64), C.astype(np.int64)
    n = T.shape[0]
    top = np.empty((n, width), np.int64)
    bot = np.empty((n, width), np.int64)
    top[:, 0] = (3 * T[:, 0] + C[:, 0] + 2) >> 2
    bot[:, 0] = (3 * C[:, 0] + T[:, 0] + 2) >> 2
    pairs = (width - 1) >> 1
    if pairs:
        tl, t, l, uv = T[:, :pairs], T[:, 1:pairs + 1], C[:, :pairs], C[:, 1:pairs + 1]
        avg = tl + t + l + uv + 8
        d12, d03 = (avg + 2 * (t + l)) >> 3, (avg + 2 * (tl + uv)) >> 3
        top[:, 1:2 * pairs:2] = (d12 + tl) >> 1
        top[:, 2:2 * pairs + 1:2] = (d03 + t) >> 1
        bot[:, 1:2 * pairs:2] = (d03 + l) >> 1
        bot[:, 2:2 * pairs + 1:2] = (d12 + uv) >> 1
    if not width & 1:
        top[:, -1] = (3 * T[:, pairs] + C[:, pairs] + 2) >> 2
        bot[:, -1] = (3 * C[:, pairs] + T[:, pairs] + 2) >> 2
    return top, bot


def _fancy_chroma(P: np.ndarray, width: int, height: int) -> np.ndarray:
    """io_dec.c EmitFancyRGB's chroma at full size [height, width]: row 0
    from chroma row 0 alone, rows 2k - 1 and 2k between chroma rows k - 1
    and k, and an even height's last row from the last chroma row alone."""
    uw, uh = (width + 1) // 2, (height + 1) // 2
    c = P[:uh, :uw]
    out = np.empty((height, width), np.int64)
    out[0] = _upsample_pair(c[:1], c[:1], width)[0][0]
    k = (height - 1) // 2  # pairs (2k - 1, 2k) for k = 1..k
    if k:
        top, bot = _upsample_pair(c[:k], c[1:k + 1], width)
        out[1:2 * k:2] = top
        out[2:2 * k + 1:2] = bot
    if not height & 1:
        out[-1] = _upsample_pair(c[uh - 1:uh], c[uh - 1:uh], width)[0][0]
    return out


def _yuv_to_rgb(y, u, v) -> np.ndarray:
    """yuv.h VP8YuvToRgb: 14-bit fixed point (MultHi, VP8Clip8)."""
    y, u, v = (np.asarray(a, np.int64) for a in (y, u, v))

    def mh(a, k):
        return (a * k) >> 8

    def clip8(a):
        return np.where((a & ~((256 << 6) - 1)) == 0, a >> 6, np.where(a < 0, 0, 255))

    yy = mh(y, 19077)
    return np.stack([clip8(yy + mh(v, 26149) - 14234),
                     clip8(yy - mh(u, 6419) - mh(v, 13320) + 8708),
                     clip8(yy + mh(u, 33050) - 17685)], -1).astype(np.uint8)


def _vp8_rgb(data: bytes, alpha) -> np.ndarray:
    """A VP8 key frame (and its ALPH payload, or None) -> uint8 [h, w, 3]."""
    hd = _VP8Header(data)
    width, height = hd.width, hd.height
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    coefs = [0] * (400 * mb_w * mb_h)
    infos = []
    top_modes = [0] * (4 * mb_w)
    nz_top = [(0, 0)] * mb_w
    last = len(hd.parts) - 1
    for mb_y in range(mb_h):
        row = _parse_modes(hd.br, hd, mb_w, top_modes)
        if hd.br.eof:
            raise _bad("VP8 data ends in partition 0")
        tbr = hd.parts[mb_y & last]
        nz_left = [0, 0]
        for mb_x in range(mb_w):
            mb = row[mb_x]
            seg, skip, is_i4, modes, uv = mb
            if hd.use_skip and skip:
                nz_top[mb_x] = (0, nz_top[mb_x][1] if is_i4 else 0)
                nz_left[0] = 0
                if not is_i4:
                    nz_left[1] = 0
                zero = True
            else:
                zero = _residuals(tbr, hd, mb, nz_top, nz_left, mb_x, coefs,
                                  400 * (mb_y * mb_w + mb_x))
            limit, ilevel, hev_t = hd.fstrength[seg][is_i4] if hd.filter_type else (0, 0, 0)
            infos.append((is_i4, modes, uv, limit, ilevel, hev_t, is_i4 or not zero))
            if tbr.eof:
                raise _bad("VP8 data ends before the image does")
    if alpha is not None:
        _alpha_check(alpha, width, height)
    c = np.asarray(coefs, np.int64).reshape(-1, 25, 16)[:, :24]
    res = _idct(c.reshape(-1, 16)).reshape(-1, 24, 4, 4)
    Y, U, V = _reconstruct(hd, infos, res, mb_w, mb_h)
    if hd.filter_type:
        _loop_filter(hd, infos, Y, U, V, mb_w, mb_h)
    u = _fancy_chroma(U, width, height)
    v = _fancy_chroma(V, width, height)
    return _yuv_to_rgb(Y[:height, :width], u, v)


# the C entry's error codes (webp_decode.cpp) -> the Python version's errors
_C_MESSAGES = (
    "truncated file (shorter than its headers)", "not a RIFF/WEBP file", "bad RIFF size",
    "truncated file (shorter than its RIFF size)", "truncated frame", "chunk size out of range",
    "a chunk runs past the RIFF end", "an ALPH chunk before a VP8L image",
    "truncated chunk header", "no image", "unknown first chunk", "bad VP8X chunk",
    "VP8X chunk runs past the RIFF end", "canvas too large", "no chunk after VP8X",
    "a second VP8X chunk", "an image outside ANMF in an animation", "a second image",
    "a frame after an incomplete one", "bad ANIM chunk", "ANMF before ANIM", "bad ANMF chunk",
    "frame too large", "ANMF frame runs past its chunk", "no frame", "unknown VP8X flags",
    "several frames in a still image", "an incomplete frame", "alpha after the image",
    "empty frame", "image size differs from the canvas", "frame outside the canvas", None,
    "truncated image chunk", "bad VP8L signature", "a prefix code with no symbol",
    "an over-subscribed prefix code", "an incomplete prefix code",
    "a code-length count past the alphabet", "a code-length repeat past the alphabet",
    "VP8L data ends inside a prefix code", "a VP8L transform used twice",
    "bad VP8L color cache size", "VP8L data ends in its header", "an LZ77 copy outside the image",
    "a color cache code without a cache", "VP8L data ends before the image does",
    "empty ALPH chunk", "bad ALPH header", "ALPH data shorter than the image",
    "truncated VP8 frame header", "bad VP8 signature", "not a key frame", "bad VP8 frame header",
    "zero VP8 width or height", "bad VP8 partition length", "VP8 data ends in its segment header",
    "VP8 data ends in its filter header", "truncated VP8 partition sizes",
    "no data in the last VP8 partition", "VP8 data ends in partition 0",
    "VP8 data ends before the image does")
_C_FIRST, _C_BOMB, _C_OUT_SIZE, _C_NOMEM = -100, -132, -162, -163


def _c_error(rc: int, info) -> Exception:
    if rc == _C_NOMEM:
        return MemoryError("webp: out of memory")
    if rc == _C_BOMB:
        w, h = int(info[0]), int(info[1])
        return _bad(f"a {w}x{h} image: more pixels than Pillow opens ({PILLOW_MAX_PIXELS})")
    return _bad(_C_MESSAGES[_C_FIRST - rc])


def _decode_c(data: bytes) -> np.ndarray:
    """``webp_decode_rgb`` through the C entry ``l2i_webp_decode``, into an
    array sized by ``l2i_webp_dims``."""
    import ctypes

    from ..ops import _build

    lib = _build.library()
    hw = (ctypes.c_int * 2)()
    info = (ctypes.c_longlong * 2)()
    rc = lib.l2i_webp_dims(data, len(data), hw)
    shape = (hw[0], hw[1], 3) if rc == 0 else (0, 0, 3)
    out = np.empty(shape, np.uint8)
    rc = lib.l2i_webp_decode(data, len(data), out.ctypes.data if out.size else None, out.size,
                             info)
    if rc != 0:
        raise _c_error(rc, info)
    return out
