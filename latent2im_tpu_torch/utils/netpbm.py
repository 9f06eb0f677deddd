"""Netpbm decoding in Python and numpy, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its PpmImagePlugin), bit for bit: the
GPU machine has no Pillow.

    netpbm_decode_rgb(data: bytes) -> uint8 [H, W, 3]

What it reads: the magic (up to six bytes before whitespace: P1-P6, Pf, and
Pillow's own P0CMYK, PyP, PyRGBA, PyCMYK), then the header's tokens (each
at most 10 bytes; a ``#`` starts a comment to the next CR or LF, also
inside a token); the data starts one byte after the last token. Plain
files (P1 bits as ``0``/``1`` characters, whitespace optional; P2, P3
decimal tokens, comments as in the header) and raw ones (P4 packed bits,
rows padded to bytes, 1 black; P5, P6 one byte a sample up to maxval 255,
two big-endian bytes past it). A maxval other than 255 scales each value as
round(value / maxval x 255) (Python's round: halves to even), or x 65535
where a gray maxval is past 255 (Pillow's mode I, which ``convert("RGB")``
clips to 255); a raw value past maxval is capped, a plain one fails. Pf is
little-endian float32 where its scale is negative, big-endian else, rows
bottom up, converted as Pillow's mode F (``modes.f_rgb``); PyP has no
palette (black). CMYK converts as ``Convert.c:cmyk2rgb``.

What fails (ValueError, as Pillow fails): another magic (PF, P7 among
them), a header that ends early, a token past 10 bytes, a size or maxval
out of range (maxval 1-65535, a scale 0 or not finite), a bad plain token
or one past maxval, data that ends before the image does, more pixels than
Pillow opens.
"""

from __future__ import annotations

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS, cmyk_to_rgb
from .modes import NotThisKind, f_rgb, gray_rgb, i_rgb

_WS = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
          b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def accepts(prefix: bytes) -> bool:
    """PpmImagePlugin._accept: does Pillow try a file as Netpbm?"""
    return len(prefix) >= 2 and prefix[:1] == b"P" and prefix[1] in b"0123456fy"


class _Header:
    """PpmImageFile's reads of the header, byte by byte."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read1(self) -> bytes:
        c = self.data[self.pos:self.pos + 1]
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        out = b""
        for _ in range(6):
            c = self.read1()
            if not c or c in _WS:
                break
            out += c
        return out

    def token(self) -> bytes:
        tok = b""
        while len(tok) <= 10:
            c = self.read1()
            if not c:
                break
            if c in _WS:
                if not tok:
                    continue
                break
            if c == b"#":  # to the next CR or LF (or the end)
                while self.read1() not in b"\r\n":
                    pass
                continue
            tok += c
        if not tok:
            raise ValueError("netpbm: the header ends early")
        if len(tok) > 10:
            raise ValueError("netpbm: a header token past 10 bytes")
        return tok


def _int(tok: bytes) -> int:
    try:
        return int(tok)
    except ValueError as e:
        raise ValueError(f"netpbm: {tok!r} is not a number") from e


def _comment_end(block: bytes, start: int) -> int:
    """PpmPlainDecoder._find_comment_end."""
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


def _plain_text(block: bytes) -> bytes:
    """PpmPlainDecoder._ignore_comments over the whole data."""
    while True:
        start = block.find(b"#")
        if start == -1:
            return block
        end = _comment_end(block, start)
        if end == -1:
            return block[:start]
        block = block[:start] + block[end + 1:]


def _plain_bits(block: bytes, total: int) -> np.ndarray:
    """PpmPlainDecoder._decode_bitonal: '0' white, '1' black."""
    tokens = b"".join(_plain_text(block).split())
    bad = tokens.translate(None, b"01")
    if bad:
        raise ValueError(f"netpbm: a plain bit {bad[:1]!r}")
    if len(tokens) < total:
        raise ValueError("netpbm: the data ends before the image does")
    return np.where(np.frombuffer(tokens[:total], np.uint8) == ord("0"), 255, 0)


def _plain_values(block: bytes, total: int, maxval: int, out_max: int) -> list:
    """PpmPlainDecoder._decode_blocks over the whole data."""
    block = _plain_text(block)
    tokens = block.split()
    if block and not block[-1:].isspace() and tokens and len(tokens[-1]) > 10:
        raise ValueError("netpbm: a data token past 10 bytes")
    out = []
    for tok in tokens:
        if len(tok) > 10:
            raise ValueError("netpbm: a data token past 10 bytes")
        v = _int(tok)
        if v < 0 or v > maxval:
            raise ValueError(f"netpbm: a value {v} outside 0-{maxval}")
        out.append(round(v / maxval * out_max))
        if len(out) == total:
            return out
    raise ValueError("netpbm: the data ends before the image does")


def netpbm_decode_rgb(data: bytes) -> np.ndarray:
    """Netpbm file bytes -> uint8 [H, W, 3] (see the module); ValueError where
    Pillow fails."""
    data = bytes(data)
    hd = _Header(data)
    magic = hd.magic()
    if magic not in _MODES:
        raise NotThisKind(f"netpbm: magic {magic!r}: not a file Pillow reads")
    mode = _MODES[magic]
    w, h = _int(hd.token()), _int(hd.token())
    if w <= 0 or h <= 0:
        raise NotThisKind(f"netpbm: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"netpbm: a {w}x{h} image: more pixels than Pillow opens")
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        body = data[hd.pos:]
        if plain:
            v = _plain_bits(body, w * h).reshape(h, w)
        else:
            stride = (w + 7) // 8
            if len(body) < stride * h:
                raise ValueError("netpbm: the data ends before the image does")
            bits = np.unpackbits(np.frombuffer(body[:stride * h], np.uint8).reshape(h, stride),
                                 axis=1)[:, :w]
            v = np.where(bits == 1, 0, 255)
        return gray_rgb(v)
    if mode == "F":
        tok = hd.token()
        try:
            scale = float(tok)
        except ValueError as e:
            raise ValueError(f"netpbm: {tok!r} is not a number") from e
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError("netpbm: a scale of 0 or not finite")
        body = data[hd.pos:hd.pos + 4 * w * h]
        if len(body) < 4 * w * h:
            raise ValueError("netpbm: the data ends before the image does")
        v = np.frombuffer(body, "<f4" if scale < 0 else ">f4").reshape(h, w)[::-1]
        return f_rgb(v)
    maxval = _int(hd.token())
    if not 0 < maxval < 65536:
        raise ValueError(f"netpbm: maxval {maxval} outside 1-65535")
    if maxval > 255 and mode == "L":
        mode = "I"
    bands = _BANDS[mode]
    total = w * h * bands
    out_max = 65535 if mode == "I" else 255
    body = data[hd.pos:]
    if plain:
        v = np.asarray(_plain_values(body, total, maxval, out_max), np.int64)
    else:
        wide = maxval > 255
        if len(body) < total * (2 if wide else 1):
            raise ValueError("netpbm: the data ends before the image does")
        v = np.frombuffer(body[:total * (2 if wide else 1)], ">u2" if wide else np.uint8)
        v = v.astype(np.int64)
        if maxval not in (255, 65535) or (maxval == 65535 and mode != "I"):
            # PpmDecoder: round(value / maxval x out_max), capped
            v = np.minimum(out_max, np.rint(v / maxval * out_max)).astype(np.int64)
    v = np.asarray(v, np.int64).reshape(h, w, bands)
    if mode == "I":
        return i_rgb(v[..., 0])
    if mode == "L":
        return gray_rgb(v[..., 0])
    if mode == "P":  # no palette: every entry black
        return np.zeros((h, w, 3), np.uint8)
    if mode == "CMYK":
        return cmyk_to_rgb(*(v[..., i] for i in range(4)))
    return np.ascontiguousarray(v[..., :3].astype(np.uint8))
