"""FITS decoding, as Pillow 12.1 decodes a file
(``PIL.Image.open(p).convert("RGB")``, its FitsImagePlugin and Python
FitsGzipDecoder), bit for bit: the GPU machine has no Pillow.

    fits_decode_rgb(data: bytes) -> uint8 [H, W, 3]

As FitsImageFile reads it: 80-byte cards, the first ``SIMPLE = T``; each
card's value is what precedes a ``/``, stripped, less a leading ``=``. At
each ``END`` the reading moves to the next 2880-byte boundary, and the
first header that describes an image sets it: its NAXIS1 (width; 1 where
NAXIS is 1) and NAXIS2, BITPIX 8 (L), 16 (I;16), 32 (I) or -32 and -64 (F),
the rows bottom up. The samples are read as Pillow's raw modes of those
names read them: little-endian 16 and 32-bit integers and float32s, not
FITS's big-endian ones, and a -64 image's float64s as pairs of float32s;
BSCALE and BZERO change nothing. A BINTABLE extension with ``ZIMAGE = T``
and ``ZCMPTYPE = 'GZIP_1  '`` is a tile-compressed image (ZNAXIS1,
ZNAXIS2, ZBITPIX): its data, past NAXIS1 x NAXIS2 x BITPIX // 8 bytes of
table, is gunzipped and each pixel taken from the last min(ZBITPIX // 8,
4) bytes of four (none for a float image). The image's data starts at the
card after the header's padding that is not a new header. Then
``convert("RGB")``: L as gray, I;16 and I clipped to 0-255, F truncated
to 0-255 (``utils/modes.py``). A first card other than ``SIMPLE = T``, a
missing NAXIS, NAXIS1 or NAXIS2 and a BITPIX of no mode pass the file on;
a card value that is no number, a file that ends in its header, no image
and data short of the image fail.
"""

from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

from .jpeg import PILLOW_MAX_PIXELS
from .modes import NotThisKind
from .raw import to_rgb, unpack

_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}


def accepts(prefix: bytes) -> bool:
    """FitsImagePlugin._accept."""
    return prefix.startswith(b"SIMPLE")


def _int(headers: dict, key: bytes) -> int:
    if key not in headers:
        raise NotThisKind(f"fits: no {key.decode()} card")
    try:
        return int(headers[key])
    except ValueError as e:
        raise ValueError(f"fits: a {key.decode()} that is no number") from e


def _size(headers: dict, prefix: bytes):
    naxis = _int(headers, prefix + b"NAXIS")
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, _int(headers, prefix + b"NAXIS1")
    return _int(headers, prefix + b"NAXIS1"), _int(headers, prefix + b"NAXIS2")


def _parse(headers: dict):
    """FitsImageFile._parse_headers -> (decoder, offset, size, mode,
    bits) or None where the header describes no image."""
    prefix, decoder, offset = b"", "raw", 0
    if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T" and \
            _card(headers, b"ZCMPTYPE") == b"'GZIP_1  '":
        table = _size(headers, prefix) or (0, 0)
        offset = table[0] * table[1] * (_int(headers, b"BITPIX") // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix)
    if not size:
        return None
    bits = _int(headers, prefix + b"BITPIX")
    return decoder, offset, size, _MODES.get(bits), bits


def _card(headers: dict, key: bytes) -> bytes:
    if key not in headers:
        raise NotThisKind(f"fits: no {key.decode()} card")
    return headers[key]


def fits_decode_rgb(data: bytes) -> np.ndarray:
    """FITS file bytes -> uint8 [H, W, 3] (see the module)."""
    data = bytes(data)
    headers, in_header, found, pos = {}, False, None, 0
    while True:
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            raise ValueError("fits: the file ends in its header (truncated FITS file)")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not found:  # the cards of every header so far, in one dict
                found = _parse(headers)
            in_header = False
            continue
        if found:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not accepts(keyword) or value != b"T"):
            raise NotThisKind("fits: not a FITS file")
        headers[keyword] = value
    if not found:
        raise ValueError("fits: no image data")
    decoder, offset, (w, h), mode, bits = found
    if mode is None or w <= 0 or h <= 0:
        raise NotThisKind(f"fits: a {w}x{h} image of BITPIX {bits}")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"fits: a {w}x{h} image: more pixels than Pillow opens")
    offset += pos - 80
    if decoder == "raw":
        return to_rgb(mode, unpack(data, offset, w, h, mode, 0, -1))
    if offset < 0:
        raise ValueError("fits: a negative data offset")
    try:
        value = gzip.decompress(data[offset:])
    except (OSError, EOFError, zlib.error) as e:
        raise ValueError(f"fits: the GZIP_1 data fails to decompress ({e})") from e
    nb = min(bits // 8, 4)
    if nb <= 0:
        raise ValueError("fits: a GZIP_1 float image (Pillow unpacks no samples of it)")
    groups = np.frombuffer(value[:len(value) // 4 * 4], np.uint8).reshape(-1, 4)
    rows = groups[:w * h, 4 - nb:].reshape(-1)
    if len(rows) < w * h * nb:
        raise ValueError("fits: not enough image data")
    return to_rgb(mode, unpack(rows.tobytes(), 0, w, h, mode, 0, -1))
