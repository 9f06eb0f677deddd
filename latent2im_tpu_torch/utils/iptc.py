"""IPTC/NAA image decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its IptcImagePlugin), bit for bit:
the GPU machine has no Pillow. IPTC has no signature: the reader tries a
file where Pillow's order of plugins comes to it.

    iptc_decode_rgb(data: bytes, host_cpp: bool = False) -> uint8 [H, W, 3]

As IptcImageFile reads it: 5-byte fields (0x1C, record 1-9 or 240, a tag,
a 16-bit size; 0x80 + n: an n-byte size after, at most 4) up to the first
image data field (8, 10) or the end; (3, 60) gives the layers and whether
they are one component each (1 and not: L; 3 and so: RGB; 4 and so:
CMYK), (3, 65) the band a record holds (1-based), (3, 20) and (3, 30) the
width and height, (3, 120) the compression (1 raw, 5 JPEG). The image is
the data of the (8, 10) fields that follow one another: raw samples as a
P5 Netpbm file of the header's size (``utils/netpbm.py``), or a JPEG
(``utils/jpeg.py``, through its C entry where ``host_cpp``). A one-band
image is that image itself, converted to RGB; otherwise it is merged into
the mode's band it names, the others black (the embedded image must be
gray), then converted (CMYK as Pillow converts it). What the header does
not allow passes the file on; a field longer than 132, another
compression, no image data, an embedded image Pillow fails and a band
past the mode's fail.
"""

from __future__ import annotations

import io
import struct

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS, cmyk_to_rgb, jpeg_decode_rgb
from .modes import NotThisKind


def _i(c: bytes) -> int:
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


def _field(fp):
    """IptcImageFile.field -> (tag, size) or (None, 0) at the end."""
    s = fp.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise NotThisKind("iptc: not an IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise ValueError("iptc: an illegal field length")
    if size == 128:
        size = 0
    elif size > 128:
        size = _i(fp.read(size - 128))
    else:
        size = struct.unpack(">H", s[3:5])[0]
    return tag, size


def _open(fp):
    """IptcImageFile._open -> (mode, band, size, compression, offset of
    the image data or None); Pillow's SyntaxError, IndexError,
    TypeError, KeyError and struct.error pass the file on."""
    info = {}
    while True:
        offset = fp.tell()
        tag, size = _field(fp)
        if not tag or tag == (8, 10):
            break
        tagdata = fp.read(size) if size else None
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(tagdata)
            else:
                info[tag] = [info[tag], tagdata]
        else:
            info[tag] = tagdata
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode = ""
    if layers == 1 and not component:
        mode, band = "L", None
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _i(info[(3, 20)]), _i(info[(3, 30)])
    kinds = {1: "raw", 5: "jpeg"}
    compression = kinds.get(_i(info[(3, 120)]))
    if compression is None:
        raise ValueError("iptc: an unknown image compression")
    return mode, band, size, compression, offset if tag == (8, 10) else None


def _components(jpeg: bytes) -> int:
    """The component count of a JPEG's frame header (0 where none)."""
    pos = 2
    while pos + 4 <= len(jpeg):
        if jpeg[pos] != 0xFF:
            pos += 1
            continue
        marker = jpeg[pos + 1]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return jpeg[pos + 9] if pos + 9 < len(jpeg) else 0
        if marker in (0xD8, 0x01, 0xFF) or 0xD0 <= marker <= 0xD7:
            pos += 2 if marker != 0xFF else 1
            continue
        pos += 2 + int.from_bytes(jpeg[pos + 2:pos + 4], "big")
    return 0


def _embedded(o: bytes, host_cpp: bool):
    """Image.open of the gathered data -> (its mode, its RGB)."""
    from .netpbm import netpbm_decode_rgb

    try:
        if o[:2] == b"P5":
            return "L", netpbm_decode_rgb(o)
        if o[:3] == b"\xff\xd8\xff":
            mode = {1: "L", 3: "RGB", 4: "CMYK"}.get(_components(o), "RGB")
            return mode, jpeg_decode_rgb(o, host_cpp=host_cpp)
    except NotThisKind as e:
        raise ValueError(f"iptc: the embedded image is none Pillow identifies ({e})") from e
    raise ValueError("iptc: an embedded image of a format not read here")


def iptc_decode_rgb(data: bytes, host_cpp: bool = False) -> np.ndarray:
    """IPTC/NAA file bytes -> uint8 [H, W, 3] (see the module)."""
    fp = io.BytesIO(bytes(data))
    try:
        mode, band, (w, h), compression, offset = _open(fp)
    except (IndexError, TypeError, KeyError, EOFError, struct.error) as e:
        raise NotThisKind(f"iptc: not an IPTC/NAA image ({type(e).__name__})") from e
    if not mode or w <= 0 or h <= 0:
        raise NotThisKind(f"iptc: mode {mode!r}, a {w}x{h} image")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"iptc: a {w}x{h} image: more pixels than Pillow opens")
    if offset is None:
        raise ValueError("iptc: no image data (Pillow cannot load this image)")
    fp.seek(offset)
    o = bytearray(b"P5\n%d %d\n255\n" % (w, h) if compression == "raw" else b"")
    while True:
        try:
            tag, size = _field(fp)
        except (NotThisKind, IndexError, struct.error) as e:
            raise ValueError(f"iptc: a broken field in the image data ({e})") from e
        if tag != (8, 10):
            break
        o += fp.read(size)
    inner_mode, rgb = _embedded(bytes(o), host_cpp)
    if band is None:
        return rgb
    n = 3 if mode == "RGB" else 4
    if not -n <= band < n:
        raise ValueError(f"iptc: band {band} of a {mode} image")
    if inner_mode != "L":
        raise ValueError("iptc: a band of a mode other than L (Pillow's merge fails it)")
    v = np.zeros(rgb.shape[:2] + (n,), np.int64)
    v[..., band] = rgb[..., 0]
    if mode == "RGB":
        return v.astype(np.uint8)
    return cmyk_to_rgb(*(v[..., k] for k in range(4)))
