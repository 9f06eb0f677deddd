"""FLI/FLC (Autodesk animation) decoding of the first frame, as Pillow
12.1 decodes a file (``PIL.Image.open(p).convert("RGB")``, its
FliImagePlugin and FliDecode.c), bit for bit: the GPU machine has no
Pillow.

    fli_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As FliImageFile reads it: a 128-byte header (magic 0xAF11 or 0xAF12 at
byte 4, flags 0 or 3, reserved bytes zero), mode P; the palette from the
first COLOR_256 (type 4) or COLOR_64 (type 11, each value shifted left
by 2) chunk among the first frame's chunks (packets of a skip and a count,
0 meaning 256), past a prefix chunk (0xF100) where one comes first; a
gray ramp where there is none. The first frame is decoded from byte 128,
its size read there (a prefix chunk there is no frame: Pillow fails it),
by FliDecode.c: a frame (0xF1FA) of chunks, each of its size and type:
COLOR chunks and PSTAMP (18) skipped, SS2 (7: word runs by line, with
skip and last-byte words), LC (12: byte runs from a first line), BLACK
(13), BRUN (15: byte runs of whole lines) and COPY (16: raw pixels) into
an image that starts at 0. A header Pillow's plugin refuses passes the
file on; a chunk of another type, a run past its line, a chunk that runs
past the frame and a frame cut by the end of the file fail.
"""

from __future__ import annotations

import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind


def accepts(prefix: bytes) -> bool:
    """FliImagePlugin._accept."""
    return len(prefix) >= 16 and prefix[4:6] in (b"\x11\xaf", b"\x12\xaf") and \
        prefix[14:16] in (b"\0\0", b"\3\0")


def _i16(d: bytes, at: int) -> int:
    if at + 2 > len(d):
        raise NotThisKind("fli: a header word cut by the end of the file")
    return d[at] | d[at + 1] << 8


def _i32(d: bytes, at: int) -> int:
    if at + 4 > len(d):
        raise NotThisKind("fli: a header word cut by the end of the file")
    return struct.unpack("<I", d[at:at + 4])[0]


def _palette(data: bytes, pos: int, shift: int) -> np.ndarray:
    """FliImageFile._palette from data[pos:] (its packet count first); a
    read past the file or an entry past 256 raises IndexError in Pillow,
    which passes the file on."""
    pal = [(a, a, a) for a in range(256)]
    i = 0
    count = _i16(data, pos)
    pos += 2
    for _ in range(count):
        s = data[pos:pos + 2]
        pos += len(s)
        if len(s) < 2:
            raise NotThisKind("fli: a palette packet cut by the end of the file")
        i += s[0]
        n = s[1] or 256
        s = data[pos:pos + 3 * n]
        pos += len(s)
        for k in range(0, len(s), 3):
            if k + 2 >= len(s) or i >= 256:
                raise NotThisKind("fli: a palette entry past the file or past 256")
            pal[i] = (s[k] << shift, s[k + 1] << shift, s[k + 2] << shift)
            i += 1
    return np.array(pal, np.int64)


def _header(data: bytes):
    """FliImageFile._open -> (width, height, palette [256, 3])."""
    head = data[:128]
    if not (accepts(head) and len(head) == 128 and head[20:22] == b"\0\0"
            and head[42:80] == bytes(38) and head[88:] == bytes(40)):
        raise NotThisKind("fli: not an FLI/FLC file")
    w, h = _i16(head, 8), _i16(head, 10)
    palette = np.array([(a, a, a) for a in range(256)], np.int64)
    pos = 128
    if _i16(data, pos + 4) == 0xF100:
        pos = 128 + _i32(data, pos)
    if _i16(data, pos + 4) == 0xF1FA:
        chunks = _i16(data, pos + 6)
        at, size = pos + 16, None
        for _ in range(chunks):
            if size is not None:
                at += size
            kind = _i16(data, at + 4)
            if kind in (4, 11):
                palette = _palette(data, at + 6, 2 if kind == 11 else 0)
                break
            size = _i32(data, at)
            if not size:
                break
    return w, h, palette & 0xFF


def _frame(img: np.ndarray, buf: bytes) -> None:
    """FliDecode.c over one frame's bytes (its size word first)."""
    h, w = img.shape
    n = len(buf)

    def overrun():
        return ValueError("fli: a chunk past the frame's data (decoder overrun)")

    if n < 8:
        raise overrun()
    if buf[4:6] != b"\xfa\xf1":
        raise ValueError("fli: the first frame is no frame chunk (unknown chunk)")
    chunks = buf[6] | buf[7] << 8
    ptr, left = 16, n - 16
    for _ in range(chunks):
        if left < 10:
            raise overrun()
        end = ptr + left
        data = ptr + 6
        kind = buf[ptr + 4] | buf[ptr + 5] << 8

        def need(k):
            if data + k > end:
                raise overrun()

        if kind in (4, 11, 18):
            pass
        elif kind == 7:  # SS2: word delta
            lines = buf[data] | buf[data + 1] << 8
            data += 2
            y = ln = 0
            while ln < lines and y < h:
                need(2)
                packets = buf[data] | buf[data + 1] << 8
                data += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= h:
                            raise overrun()
                    else:
                        img[y, w - 1] = packets & 0xFF
                    need(2)
                    packets = buf[data] | buf[data + 1] << 8
                    data += 2
                x = p = 0
                while p < packets:
                    need(2)
                    x += buf[data]
                    c = buf[data + 1]
                    if c >= 128:
                        need(4)
                        i = 256 - c
                        if x + 2 * i > w:
                            break
                        img[y, x:x + 2 * i] = np.tile([buf[data + 2], buf[data + 3]], i)
                        x += 2 * i
                        data += 4
                    else:
                        i = 2 * c
                        if x + i > w:
                            break
                        need(2 + i)
                        img[y, x:x + i] = np.frombuffer(buf[data + 2:data + 2 + i], np.uint8)
                        data += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                ln += 1
                y += 1
            if ln < lines:
                raise overrun()
        elif kind == 12:  # LC: byte delta
            y = buf[data] | buf[data + 1] << 8
            ymax = y + (buf[data + 2] | buf[data + 3] << 8)
            data += 4
            while y < ymax and y < h:
                need(1)
                packets = buf[data]
                data += 1
                x = p = 0
                while p < packets:
                    need(2)
                    x += buf[data]
                    c = buf[data + 1]
                    if c & 0x80:
                        i = 256 - c
                        if x + i > w:
                            break
                        need(3)
                        img[y, x:x + i] = buf[data + 2]
                        data += 3
                    else:
                        i = c
                        if x + i > w:
                            break
                        need(2 + i)
                        img[y, x:x + i] = np.frombuffer(buf[data + 2:data + 2 + i], np.uint8)
                        data += 2 + i
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                raise overrun()
        elif kind == 13:  # BLACK
            img[:] = 0
        elif kind == 15:  # BRUN: byte runs, whole lines
            for y in range(h):
                data += 1  # the packet count, ignored
                x = 0
                while x < w:
                    need(2)
                    c = buf[data]
                    if c & 0x80:
                        i = 256 - c
                        if x + i > w:
                            break
                        need(i + 1)
                        img[y, x:x + i] = np.frombuffer(buf[data + 1:data + 1 + i], np.uint8)
                        data += i + 1
                    else:
                        i = c
                        if x + i > w:
                            break
                        img[y, x:x + i] = buf[data + 1]
                        data += 2
                    x += i
                if x != w:
                    raise ValueError("fli: a BRUN line that does not fill the image's width")
        elif kind == 16:  # COPY
            if data + w * h > end:
                raise ValueError("fli: a COPY chunk past the frame's data (image file is "
                                 "truncated)")
            img[:] = np.frombuffer(buf[data:data + w * h], np.uint8).reshape(h, w)
        else:
            raise ValueError(f"fli: chunk type {kind} (unknown chunk)")
        advance = struct.unpack("<i", buf[ptr:ptr + 4])[0]
        if advance == 0:
            raise ValueError("fli: a chunk of size 0 (broken data)")
        if advance < 0 or advance > left:
            raise overrun()
        ptr += advance
        left -= advance


def fli_decode_rgb(data: bytes) -> np.ndarray:
    """FLI/FLC file bytes -> the first frame as uint8 [H, W, 3] (see the
    module)."""
    data = bytes(data)
    w, h, palette = _header(data)
    if len(data) < 132:  # EOFError or struct.error in Pillow's seek(0)
        raise NotThisKind("fli: no frame size")
    if w <= 0 or h <= 0:
        raise NotThisKind(f"fli: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"fli: a {w}x{h} image: more pixels than Pillow opens")
    size = struct.unpack("<I", data[128:132])[0]
    buf = data[128:128 + size]
    # FliDecode.c waits for the whole frame (one pad byte may be missing),
    # and Pillow's load fails when the file ends first
    if not size or len(buf) + len(buf) % 2 < size:
        raise ValueError("fli: the first frame cut by the end of the file (image file is "
                         "truncated)")
    img = np.zeros((h, w), np.uint8)
    _frame(img, buf)
    return palette.astype(np.uint8)[img]
