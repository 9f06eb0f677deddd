"""XPM (X11 pixmap) decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its XpmImagePlugin and its Python
XpmDecoder), bit for bit: the GPU machine has no Pillow.

    xpm_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As XpmImageFile reads it: ``/* XPM */``, then the first line that starts
with ``"<width> <height> <colours> <chars per pixel>``; one line per
colour, whose ``c`` key gives ``#rrggbb`` (the hex number's low 24 bits)
or ``None`` (the transparent key, in no palette); then the pixel lines,
each the text between its first and last ``"`` (a ``/* pixels */`` line
skipped once), cut into keys. Up to 256 colours the image is P and its
palette the colours in order (a key not in it fails, the transparent one
too), past that RGB. A line without a ``c`` key or with another colour
name fails; a header line never found passes the file on.
"""

from __future__ import annotations

import io
import re

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind
from .raw import palette_table

_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def accepts(prefix: bytes) -> bool:
    """XpmImagePlugin._accept."""
    return prefix.startswith(b"/* XPM */")


def xpm_decode_rgb(data: bytes) -> np.ndarray:
    """XPM file bytes -> uint8 [H, W, 3] (see the module)."""
    fp = io.BytesIO(bytes(data))
    if not accepts(fp.read(9)):
        raise NotThisKind("xpm: not an XPM file")
    while True:
        line = fp.readline()
        if not line:
            raise NotThisKind("xpm: no header line (a broken XPM file)")
        m = _HEAD.match(line)
        if m:
            break
    try:
        w, h, ncolors, bpp = (int(g) for g in m.groups())
    except ValueError as e:  # an empty number
        raise ValueError("xpm: a header number missing") from e
    palette = {}
    for _ in range(ncolors):
        line = fp.readline().rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1] if i + 1 < len(s) else None
                if rgb is None:
                    raise NotThisKind("xpm: a colour key without a value")
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError as e:
                        raise ValueError("xpm: a bad colour") from e
                    palette[c] = bytes([(v >> 16) & 255, (v >> 8) & 255, v & 255])
                else:
                    raise ValueError("xpm: a colour name Pillow cannot read")
                break
        else:
            raise ValueError("xpm: a colour line without a colour key")
    if w <= 0 or h <= 0:
        raise NotThisKind(f"xpm: a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"xpm: a {w}x{h} image: more pixels than Pillow opens")
    rgb_mode = ncolors > 256
    index = {k: i for i, k in enumerate(palette)}
    out = bytearray()
    need = w * h * (3 if rgb_mode else 1)
    header_seen = False
    while len(out) < need:
        line = fp.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header_seen:
            header_seen = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(line), bpp):
            key = line[i:i + bpp]
            if rgb_mode:
                if key not in palette:
                    raise ValueError("xpm: a pixel key not among the colours")
                out += palette[key]
            else:
                if key not in index:
                    raise ValueError("xpm: a pixel key not in the palette")
                out.append(index[key])
    if len(out) < need:
        raise ValueError("xpm: not enough image data")
    if rgb_mode:
        return np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, w, 3).copy()
    table = palette_table(np.frombuffer(b"".join(palette.values()), np.uint8))
    return table[np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, w)]
