"""GIF decoding in Python and numpy, as Pillow 12.1 decodes a file's first
frame (``PIL.Image.open(p).convert("RGB")``), bit for bit: the GPU machine
has no Pillow.

    gif_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As GifImagePlugin reads it: the logical screen (grown to hold the first
frame's rectangle where that reaches past it), the global colour table, the
extensions before the first image (a graphic control extension's
transparency index), the image descriptor (position, size, interlace, a
local colour table); a colour table that is the identity grayscale (entry i
= (i, i, i)) counts as none, and with no table the frame is gray ("L": each
index its own level). The canvas starts as the transparency index where the
frame has one, else 0; the frame's LZW codes (variable width from the
minimum code size + 1 up to 12 bits, clear and end codes, the table frozen
once full) fill its rectangle row by row, or in the four interlaced passes.
The pixels then take the colour table's colours, the transparency index its
own colour, as ``convert("RGB")`` leaves it; an index past the table is
black.

What fails (ValueError, as Pillow fails): no GIF signature, no image
before the trailer, a code past the table, data that ends before the
image's codes do.
"""

from __future__ import annotations

import struct

import numpy as np


def _palette_needed(p: bytes) -> bool:
    """GifImagePlugin._is_palette_needed: any entry other than (i, i, i)."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p), 3))


def _blocks(data: bytes, pos: int) -> tuple[bytes, int]:
    """The data sub-blocks at pos -> (their bytes, the position after the
    terminator); a block past the end gives what is there."""
    out = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(out), pos
        out.append(data[pos:pos + n])
        pos += n
    return b"".join(out), pos


def _lzw(data: bytes, min_bits: int, n_pixels: int) -> bytes:
    """GIF LZW: codes LSB first, clear = 1 << min_bits, end = clear + 1 ->
    up to n_pixels indices."""
    if not 0 < min_bits <= 12:
        raise ValueError(f"gif: LZW minimum code size {min_bits}")
    clear, end = 1 << min_bits, (1 << min_bits) + 1
    out = bytearray()
    table: list = [bytes([i]) for i in range(clear)] + [b"", b""]
    size, prev = min_bits + 1, None
    acc = nacc = 0
    it = iter(data)
    while len(out) < n_pixels:
        while nacc < size:
            b = next(it, None)
            if b is None:
                raise ValueError("gif: the image data ends before its last pixel")
            acc |= b << nacc
            nacc += 8
        code = acc & ((1 << size) - 1)
        acc >>= size
        nacc -= size
        if code == clear:
            del table[end + 1:]
            size, prev = min_bits + 1, None
            continue
        if code == end:
            break
        if prev is None:
            if code >= len(table):
                raise ValueError("gif: a code past the table (corrupt data)")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 4096:
                table.append(prev + entry[:1])
        elif code == len(table) and len(table) < 4096:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("gif: a code past the table (corrupt data)")
        out += entry
        prev = entry
        if len(table) == 1 << size and size < 12:
            size += 1
    return bytes(out[:n_pixels])


def gif_decode_rgb(data: bytes) -> np.ndarray:
    """GIF file bytes -> uint8 [H, W, 3] of its first frame (see the module);
    ValueError where Pillow fails."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError("gif: not a GIF file")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos, table = 13, None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        p = data[pos:pos + n]
        pos += n
        if _palette_needed(p):
            table = p
    trns = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("gif: no image before the trailer")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # an extension: its label, then its sub-blocks
            label = data[pos] if pos < len(data) else 0
            block, pos = _blocks(data, pos + 1)
            if label == 0xF9 and len(block) >= 4 and block[0] & 1:
                trns = block[3]
            continue
        if kind != 0x2C:
            raise ValueError(f"gif: unexpected byte 0x{kind:02X} where a block starts")
        if pos + 9 > len(data):
            raise ValueError("gif: the image descriptor runs past the end")
        x0, y0, fw, fh, lflags = struct.unpack("<HHHHB", data[pos:pos + 9])
        pos += 9
        if lflags & 0x80:
            n = 3 << ((lflags & 7) + 1)
            p = data[pos:pos + n]
            pos += n
            table = p if _palette_needed(p) else None
        if pos >= len(data):
            raise ValueError("gif: the image data runs past the end")
        min_bits = data[pos]
        codes, _ = _blocks(data, pos + 1)
        break
    W, H = max(w, x0 + fw), max(h, y0 + fh)
    canvas = np.full((H, W), trns if trns is not None else 0, np.uint8)
    idx = np.frombuffer(_lzw(codes, min_bits, fw * fh), np.uint8)
    if idx.size < fw * fh:  # the end code came early: the rest stays as it was
        idx = np.concatenate([idx, canvas[y0:y0 + fh, x0:x0 + fw].ravel()[idx.size:]])
    rows = idx.reshape(fh, fw) if fw and fh else np.zeros((fh, fw), np.uint8)
    if lflags & 0x40:  # interlaced: passes of rows 0::8, 4::8, 2::4, 1::2
        order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                np.arange(2, fh, 4), np.arange(1, fh, 2)])
        frame = np.empty_like(rows)
        frame[order] = rows
        rows = frame
    canvas[y0:y0 + fh, x0:x0 + fw] = rows
    if table is None:
        return np.repeat(canvas[..., None], 3, axis=-1)
    lut = np.zeros((256, 3), np.uint8)  # entries past the table: black
    pal = np.frombuffer(table, np.uint8)
    lut[:len(pal) // 3] = pal[:len(pal) // 3 * 3].reshape(-1, 3)
    return lut[canvas]
