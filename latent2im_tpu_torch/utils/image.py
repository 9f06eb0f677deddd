"""Image grids, PNG files and uint8 conversion — own copy of
latent2im_tpu/utils/image.py (imgrid tiling with 1 px white seams, PNG save,
to_uint8), NHWC uint8. PNG is encoded and decoded with the standard library
alone (zlib + struct), and Pillow's BILINEAR, BICUBIC and LANCZOS resamples
are rewritten in numpy: the GPU machine has no Pillow. The reader
(``read_image_rgb``) takes every format Pillow 12.1 reads but AVIF, each
bit for bit as Pillow decodes it: PNG (every colour type and depth, 16-bit
and Adam7 included), JPEG, sequential, progressive or lossless, Huffman or
arithmetic-coded, grayscale, YCbCr, RGB, CMYK or YCCK (``utils/jpeg.py``),
WEBP, lossless, lossy, with alpha or animated (``utils/webp.py``), GIF (its
first frame, ``utils/gif.py``), BMP and DIB (``utils/bmp.py``), TIFF
(``utils/tiff.py``), Netpbm, ICO and CUR, PCX and DCX, SGI, QOI and TGA
(``utils/netpbm.py``, ``ico.py``, ``pcx.py``, ``dcx.py``, ``sgi.py``,
``qoi.py``, ``tga.py``), DDS with its BC1-BC7 blocks, BLP and FTEX, PSD,
JPEG 2000 and ICNS (``utils/dds.py``, ``bcn.py``, ``blp.py``, ``psd.py``,
``jpeg2000.py``, ``icns.py``), and the legacy formats IM, MSP, XBM, XPM,
SPIDER, FITS, Sun raster, FLI/FLC, PIXAR, McIdas, GBR, PhotoCD, XV
thumbnails, IMT and IPTC (``utils/im.py``, ``msp.py``, ``xbm.py``,
``xpm.py``, ``spider.py``, ``fits.py``, ``sun.py``, ``fli.py``,
``pixar.py``, ``mcidas.py``, ``gbr.py``, ``pcd.py``, ``xvthumb.py``,
``imt.py``, ``iptc.py``; raw modes in ``utils/raw.py``); hierarchical and
12-bit JPEG raise, naming ROADMAP item 26, as Pillow fails them."""

from __future__ import annotations

import functools
import math
import re
import struct
import zlib

import numpy as np

from .bmp import bmp_decode_rgb
from .gif import gif_decode_rgb
from .jpeg import PILLOW_MAX_PIXELS, jpeg_decode_rgb
from .tiff import tiff_decode_rgb
from .webp import webp_decode_rgb


def imgrid(imarray: np.ndarray, cols: int = 5, pad: int = 1) -> np.ndarray:
    """Tile [N, H, W, C] uint8 images into a grid with `pad`px white seams."""
    if imarray.dtype != np.uint8:
        raise ValueError("imgrid input imarray must be uint8")
    pad = int(pad)
    cols = int(cols)
    if pad < 0 or cols < 1:
        raise ValueError(f"imgrid: pad >= 0 and cols >= 1, got {pad}, {cols}")
    n, h, w, c = imarray.shape
    rows = int(np.ceil(n / float(cols)))
    imarray = np.pad(
        imarray,
        [[0, rows * cols - n], [0, pad], [0, pad], [0, 0]],
        "constant",
        constant_values=255,
    )
    hp, wp = h + pad, w + pad
    grid = (
        imarray.reshape(rows, cols, hp, wp, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(rows * hp, cols * wp, c)
    )
    if pad:
        grid = grid[:-pad, :-pad]
    return np.squeeze(grid)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(img_u8: np.ndarray) -> bytes:
    """uint8 [H, W, 3] (RGB) or [H, W] (gray) -> PNG file bytes. zlib level
    1: a faster encode for slightly larger payloads, as in the JAX server."""
    img = np.ascontiguousarray(img_u8, np.uint8)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"png: [H, W, 3] or [H, W] uint8, got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _png_chunk(b"IEND", b""))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, its legal bit depths)
_PNG_COLOR = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
              4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth) of one
    image (or one Adam7 pass, whose first row has no previous row) ->
    [h, stride] uint8."""
    if len(data) < h * (stride + 1):
        raise ValueError("png: truncated image data")
    out = np.zeros((h, stride), np.uint8)
    prev = bytes(stride)
    for y in range(h):
        ftype = data[y * (stride + 1)]
        cur = bytearray(data[y * (stride + 1) + 1:(y + 1) * (stride + 1)])
        if ftype == 1:  # Sub
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ftype == 2:  # Up
            cur = bytearray((np.frombuffer(cur, np.uint8) + np.frombuffer(prev, np.uint8))
                            .astype(np.uint8).tobytes())
        elif ftype == 3:  # Average
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:
            _paeth_row(cur, prev, bpp)
        elif ftype != 0:
            raise ValueError(f"png: unknown filter type {ftype} in row {y}")
        out[y] = np.frombuffer(cur, np.uint8)
        prev = bytes(cur)
    return out


def _samples(rows: np.ndarray, w: int, spp: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, w, spp] uint16: sub-byte
    samples unpacked most significant first, 16-bit ones big-endian."""
    h = rows.shape[0]
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
        vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            -1, dtype=np.uint8)
        return vals.reshape(h, w, 1).astype(np.uint16)
    if depth == 16:
        return rows.view(">u2").reshape(h, w, spp).astype(np.uint16)
    return rows.reshape(h, w, spp).astype(np.uint16)


def _png_chunks(data: bytes):
    """PngImageFile's reading of the chunks -> (IHDR's fields, the PLTE
    before the first IDAT or None, the image data): up to the first IDAT
    each chunk is read whole and its CRC checked (a bad or cut one, or a
    type of other than four word characters, and Pillow identifies no
    image); then the data of the IDAT chunks that follow one another
    (their CRCs skipped), and of the chunks after them up to IEND, each
    present in full. ValueError where Pillow fails."""
    pos, hdr, plte = 8, None, None
    while True:
        if pos + 8 > len(data):
            raise ValueError("png: the file ends before its image data (Pillow identifies "
                             "no image)")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if not re.fullmatch(rb"\w{4}", tag):
            raise ValueError(f"png: a broken chunk {tag!r} (Pillow identifies no image)")
        if tag in (b"IDAT", b"IEND"):
            break
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n:
            raise ValueError(f"png: chunk {tag!r} cut by the end of the file")
        if tag == b"IHDR":
            if n < 13:
                raise ValueError("png: a truncated IHDR chunk")
            w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", body[:13])
            if filt:
                raise ValueError("png: an unknown filter category (Pillow identifies no "
                                 "image)")
            hdr = (w, h, depth, color, comp, filt, int(interlace != 0))
        elif tag == b"PLTE" and hdr is not None and hdr[3] == 3:
            plte = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(crc) < 4 or struct.unpack(">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"png: a bad checksum in chunk {tag!r} (Pillow identifies no "
                             "image)")
        pos += 12 + n
    if hdr is None or tag == b"IEND":
        raise ValueError("png: no IHDR chunk or no image data before IEND")
    stream, gathering = bytearray(), True
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if not re.fullmatch(rb"\w{4}", tag) or tag == b"IEND":
            break
        body = data[pos + 8:pos + 8 + n]
        if tag != b"IDAT":
            gathering = False
        if gathering:
            stream += body
        elif len(body) < n:  # load_end reads each chunk after the image whole
            raise ValueError(f"png: chunk {tag!r} after the image cut by the end of the file")
        pos += 12 + n
    return hdr, plte, bytes(stream)


def png_decode_rgb(data: bytes) -> np.ndarray:
    """PNG file bytes -> uint8 [H, W, 3], as Pillow's ``Image.open(f)
    .convert("RGB")`` gives it: gray is replicated (1, 2 and 4-bit gray
    scaled to 0..255, 16-bit gray, Pillow's "I;16", clipped at 255), a
    palette is looked up, 16-bit RGB, gray+alpha and RGBA keep each
    sample's high byte, alpha and tRNS are dropped, not composited. Every
    colour type at every legal depth, filters 0-4, no interlace or Adam7
    (seven passes, each with its own filtered rows, sub-byte samples packed
    per pass row). Corrupt data as Pillow reads it: the chunks as
    ``_png_chunks`` walks them, the zlib stream inflated only as far as the
    image needs."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("png: not a PNG file (bad signature)")
    hdr, plte, stream = _png_chunks(data)
    w, h, depth, color, _, _, interlace = hdr
    if not w or not h:
        raise ValueError(f"png: a {w}x{h} image (Pillow identifies no such file)")
    if w * h > PILLOW_MAX_PIXELS:
        raise ValueError(f"png: a {w}x{h} image: more pixels than Pillow opens "
                         f"({PILLOW_MAX_PIXELS})")
    if color not in _PNG_COLOR or depth not in _PNG_COLOR[color][1]:
        raise ValueError(f"png: colour type {color} at bit depth {depth} is not supported")
    spp = _PNG_COLOR[color][0]
    bpp = max(1, spp * depth // 8)
    if not interlace:
        need = h * ((w * spp * depth + 7) // 8 + 1)
    else:
        need = sum(-(-(h - y0) // dy) * ((-(-(w - x0) // dx) * spp * depth + 7) // 8 + 1)
                   for x0, y0, dx, dy in _ADAM7 if w > x0 and h > y0)
    # ZipDecode inflates only until the image is whole: what follows (the
    # rest of the stream, its checksum) is never read
    raw = zlib.decompressobj().decompress(stream, need)
    if len(raw) < need:
        raise ValueError("png: the image data ends before the image does")
    if not interlace:
        stride = (w * spp * depth + 7) // 8
        vals = _samples(_unfilter(raw, h, stride, bpp), w, spp, depth)
    else:
        vals = np.zeros((h, w, spp), np.uint16)
        at = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no rows, no filter bytes
            stride = (pw * spp * depth + 7) // 8
            rows = _unfilter(raw[at:], ph, stride, bpp)
            at += ph * (stride + 1)
            vals[y0::dy, x0::dx] = _samples(rows, pw, spp, depth)
    if color == 3:
        if plte is None:
            raise ValueError("png: palette image without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)  # indices past the palette: black
        table[:len(plte)] = plte
        return table[vals[..., 0]]
    if color == 0:
        gray = vals[..., 0]
        if depth < 8:
            gray = gray * (255 // ((1 << depth) - 1))
        gray = np.minimum(gray, 255).astype(np.uint8)  # "I;16" -> RGB clips
        return np.repeat(gray[..., None], 3, axis=-1)
    if depth == 16:
        vals = vals >> 8
    vals = vals.astype(np.uint8)
    if color == 4:
        return np.repeat(vals[..., :1], 3, axis=-1)
    return np.ascontiguousarray(vals[..., :3])


# the one format Pillow 12.1 opens that this package does not read (ROADMAP
# item 28: an AV1 decoder waits for the specification's tables), by the
# prefixes Pillow's plugin accepts
def _avif(data: bytes) -> np.ndarray:
    raise ValueError("AVIF images are not supported (Pillow reads them; ROADMAP item 28); "
                     "convert it to PNG")


def _pillow_fails(name: str):
    """A format Pillow 12.1 opens and fails to load here: EPS (no
    Ghostscript), and its stubs, which have no loader."""
    def fail(data: bytes) -> np.ndarray:
        raise ValueError(f"{name}: Pillow opens such a file and fails to load it (no "
                         "Ghostscript, or a format it has no loader for)")
    return fail


def _decoders(host_cpp: bool = False):
    """The readers in Pillow's order of trying them (``PIL.Image.ID`` once
    ``Image.open`` has run ``preinit`` and ``init``: BMP, DIB, GIF, JPEG,
    PPM and PNG, then the other plugins by name): (name, accepts, decode).
    IM, IMT, IPTC, PCD, SPIDER and TGA have no signature: each tries the
    file and passes it on (NotThisKind) where Pillow's plugin does."""
    from . import (dcx, dds, fits, fli, gbr, icns, ico, im, imt, iptc, jpeg2000, mcidas, msp,
                   netpbm, pcd, pcx, pixar, psd, qoi, sgi, spider, sun, tga, xbm, xpm, xvthumb)
    from .blp import blp_decode_rgb, ftex_decode_rgb
    from .bmp import dib_decode_rgb

    dib_sizes = (12, 40, 52, 56, 64, 108, 124)
    every = lambda d: True  # noqa: E731
    return (
        ("BMP", lambda d: d[:2] == b"BM", bmp_decode_rgb),
        ("DIB", lambda d: len(d) >= 4 and int.from_bytes(d[:4], "little") in dib_sizes,
         lambda d: dib_decode_rgb(d, 0)),
        ("GIF", lambda d: d[:6] in (b"GIF87a", b"GIF89a"), gif_decode_rgb),
        ("JPEG", lambda d: d[:3] == b"\xff\xd8\xff",
         functools.partial(jpeg_decode_rgb, host_cpp=host_cpp)),
        ("PPM", netpbm.accepts, netpbm.netpbm_decode_rgb),
        ("PNG", lambda d: d[:8] == _PNG_SIGNATURE, png_decode_rgb),
        ("AVIF", lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1", b"msf1"),
         _avif),
        ("BLP", lambda d: d[:4] in (b"BLP1", b"BLP2"), blp_decode_rgb),
        ("BUFR", lambda d: d[:4] in (b"BUFR", b"ZCZC"), _pillow_fails("BUFR")),
        ("CUR", lambda d: d[:4] == b"\0\0\2\0", ico.ico_decode_rgb),
        ("PCX", pcx.accepts, pcx.pcx_decode_rgb),
        ("DCX", dcx.accepts, dcx.dcx_decode_rgb),
        ("DDS", dds.accepts, dds.dds_decode_rgb),
        ("EPS", lambda d: d[:4] in (b"%!PS", b"\xc5\xd0\xd3\xc6"), _pillow_fails("EPS")),
        ("FITS", fits.accepts, fits.fits_decode_rgb),
        ("FLI", fli.accepts, fli.fli_decode_rgb),
        ("FTEX", lambda d: d[:4] == b"FTEX", ftex_decode_rgb),
        ("GBR", gbr.accepts, gbr.gbr_decode_rgb),
        ("GRIB", lambda d: len(d) >= 8 and d[:4] == b"GRIB" and d[7] == 1,
         _pillow_fails("GRIB")),
        ("HDF5", lambda d: d[:8] == b"\x89HDF\r\n\x1a\n", _pillow_fails("HDF5")),
        ("JPEG 2000", jpeg2000.accepts,
         functools.partial(jpeg2000.jpeg2000_decode_rgb, host_cpp=host_cpp)),
        ("ICNS", icns.accepts, functools.partial(icns.icns_decode_rgb, host_cpp=host_cpp)),
        ("ICO", lambda d: d[:4] == b"\0\0\1\0", ico.ico_decode_rgb),
        ("IM", every, im.im_decode_rgb),
        ("IMT", every, imt.imt_decode_rgb),
        ("IPTC", every, functools.partial(iptc.iptc_decode_rgb, host_cpp=host_cpp)),
        ("MCIDAS", mcidas.accepts, mcidas.mcidas_decode_rgb),
        ("MPEG", lambda d: d[:4] == b"\0\0\x01\xb3", _pillow_fails("MPEG")),
        ("TIFF", lambda d: d[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"),
         tiff_decode_rgb),
        ("MSP", msp.accepts, msp.msp_decode_rgb),
        ("PCD", every, pcd.pcd_decode_rgb),
        ("PIXAR", pixar.accepts, pixar.pixar_decode_rgb),
        ("PSD", psd.accepts, psd.psd_decode_rgb),
        ("QOI", lambda d: d[:4] == b"qoif", qoi.qoi_decode_rgb),
        ("SGI", sgi.accepts, sgi.sgi_decode_rgb),
        ("SPIDER", every, spider.spider_decode_rgb),
        ("SUN", sun.accepts, sun.sun_decode_rgb),
        ("TGA", every, tga.tga_decode_rgb),
        ("WEBP", lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP",
         functools.partial(webp_decode_rgb, host_cpp=host_cpp)),
        ("WMF", lambda d: d[:6] == b"\xd7\xcd\xc6\x9a\0\0" or d[:4] == b"\x01\0\0\0",
         _pillow_fails("WMF")),
        ("XBM", xbm.accepts, xbm.xbm_decode_rgb),
        ("XPM", xpm.accepts, xpm.xpm_decode_rgb),
        ("XVTHUMB", xvthumb.accepts, xvthumb.xvthumb_decode_rgb),
    )


def read_image_rgb(path: str, host_cpp: bool = False) -> np.ndarray:
    """An image file -> uint8 [H, W, 3] RGB, as Pillow's ``Image.open(path)
    .convert("RGB")`` gives it, the formats told apart in Pillow's order of
    trying them (``_decoders``): BMP and DIB (``utils/bmp.py``), GIF (its
    first frame, ``utils/gif.py``), JPEG (``jpeg_decode_rgb``: sequential,
    progressive or lossless, Huffman or arithmetic-coded, 1, 3 or 4
    components, libjpeg's recovery from corrupt data; through its C entry
    where ``host_cpp``), Netpbm (``utils/netpbm.py``), PNG
    (``png_decode_rgb``), BLP and FTEX (``utils/blp.py``), CUR and ICO
    (``utils/ico.py``), PCX and DCX (``utils/pcx.py``, ``dcx.py``), DDS
    (``utils/dds.py``, its BC1-BC7 blocks in ``utils/bcn.py``), FITS, FLI,
    GBR (``utils/fits.py``, ``fli.py``, ``gbr.py``), JPEG 2000
    (``utils/jpeg2000.py``, its tier-1 through the C entry where
    ``host_cpp``), ICNS (``utils/icns.py``), IM, IMT, IPTC, McIdas
    (``utils/im.py``, ``imt.py``, ``iptc.py``, ``mcidas.py``), TIFF
    (``utils/tiff.py``), MSP, PhotoCD, PIXAR (``utils/msp.py``, ``pcd.py``,
    ``pixar.py``), PSD (``utils/psd.py``), QOI (``utils/qoi.py``), SGI
    (``utils/sgi.py``), SPIDER, Sun raster (``utils/spider.py``,
    ``sun.py``), TGA (``utils/tga.py``), WEBP (``webp_decode_rgb``, through
    its C entry where ``host_cpp``), XBM, XPM and XV thumbnails
    (``utils/xbm.py``, ``xpm.py``, ``xvthumb.py``); all but JPEG, JPEG 2000
    and WEBP in Python only. What the JPEG decoder does not read
    (hierarchical, 12-bit) raises ValueError naming the file and ROADMAP
    item 26; a TIFF or PSD form Pillow reads and the port does not (LAB)
    and AVIF name ROADMAP item 28; a corrupt file, and one of no kind
    Pillow identifies, raise ValueError naming it."""
    from .modes import NotThisKind

    with open(path, "rb") as f:
        data = f.read()
    for _, accept, decode in _decoders(host_cpp):
        if not accept(data):
            continue
        try:
            return decode(data)
        except NotThisKind:
            continue  # Pillow tries the next format
        except (ValueError, zlib.error, struct.error) as e:  # corrupt data
            raise ValueError(f"{path}: {e}") from e
    raise ValueError(f"{path}: not a file of a format read here (nor one Pillow "
                     "identifies)")


def save_im(a: np.ndarray, filename: str, format: str = "png") -> None:
    """Save a uint8 array as `{filename}.{format}` (PNG only)."""
    if format != "png":
        raise ValueError(f"save_im writes png only, not {format!r}")
    with open(f"{filename}.{format}", "wb") as f:
        f.write(png_bytes(np.squeeze(np.asarray(a, dtype=np.uint8))))


_PIL_PRECISION_BITS = 22  # libImaging/Resample.c: 32 - 8 - 2


def _pil_bicubic(x: float) -> float:
    """Pillow's bicubic filter, a = -0.5, support 2."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _pil_lanczos(x: float) -> float:
    """Pillow's lanczos filter: a sinc windowed by a sinc 3 wide, support 3."""
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _pil_bilinear(x: float) -> float:
    """Pillow's bilinear filter: a triangle, support 1."""
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


# filter -> its support, as libImaging/Resample.c defines them
_PIL_FILTERS = {"bilinear": (_pil_bilinear, 1.0), "bicubic": (_pil_bicubic, 2.0),
                "lanczos": (_pil_lanczos, 3.0)}


@functools.lru_cache(maxsize=32)
def _pil_coeffs(in_size: int, out_size: int, filt: str = "bicubic"):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for one axis ->
    (first input index [out, k], fixed-point coefficients [out, k] int64);
    unused taps have coefficient 0 and index 0. The filter is evaluated
    with the C library's sin, as Pillow's C code does."""
    fn, filter_support = _PIL_FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # C casts truncate
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:  # sequential, as the C loop sums
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        kk[xx, :xmax] = w
        idx[xx, :xmax] = np.arange(xmax) + xmin
    one = float(1 << _PIL_PRECISION_BITS)
    fixed = np.where(kk < 0, np.trunc(-0.5 + kk * one), np.trunc(0.5 + kk * one))
    fixed = fixed.astype(np.int64)
    idx.flags.writeable = fixed.flags.writeable = False  # cached: shared
    return idx, fixed


def _pil_pass(img: np.ndarray, axis: int, out_size: int, filt: str) -> np.ndarray:
    """One 8-bit pass of Pillow's resample along ``axis`` of [H, W, C]:
    integer multiply-adds from a half-unit start, >> 22, clip to uint8."""
    idx, k = _pil_coeffs(img.shape[axis], out_size, filt)
    x = np.moveaxis(img.astype(np.int64), axis, 0)  # [in, other, C]
    acc = np.full((out_size,) + x.shape[1:], 1 << (_PIL_PRECISION_BITS - 1), np.int64)
    for j in range(idx.shape[1]):
        acc += x[idx[:, j]] * k[:, j, None, None]
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _pil_resize_c(img, size, filt: str) -> np.ndarray:
    """``_pil_resize`` in one call of the host C++ ``l2i_resize``
    (ops/csrc/resample.cpp, built with the kernels; a failed build raises),
    reading a crop in place (its rows may be strided)."""
    from ..ops import _build

    w, h = size
    img = np.asarray(img, np.uint8)
    if img.shape[:2] == (h, w):
        return img  # no pass, as _pil_resize
    if img.strides[1:] != (img.shape[2], 1):
        img = np.ascontiguousarray(img)
    ih, iw, c = img.shape
    tw = _pil_coeffs(iw, w, filt) if iw != w else (None, None)
    th = _pil_coeffs(ih, h, filt) if ih != h else (None, None)
    out = np.empty((h, w, c), np.uint8)

    def ptr(a):
        return None if a is None else a.ctypes.data

    rc = _build.library().l2i_resize(
        img.ctypes.data, img.strides[0], ih, iw, c, ptr(tw[0]), ptr(tw[1]),
        0 if tw[0] is None else tw[0].shape[1], w, ptr(th[0]), ptr(th[1]),
        0 if th[0] is None else th[0].shape[1], h, _PIL_PRECISION_BITS, out.ctypes.data)
    if rc != 0:
        raise MemoryError("l2i_resize: out of memory")
    return out


def _pil_resize(img_u8, size, filt: str, host_cpp: bool = False) -> np.ndarray:
    """host_cpp: ``_pil_resize_c``, the same bit for bit."""
    if host_cpp:
        return _pil_resize_c(img_u8, size, filt)
    w, h = size
    img = np.asarray(img_u8, np.uint8)
    if img.shape[1] != w:
        img = _pil_pass(img, 1, w, filt)
    if img.shape[0] != h:
        img = _pil_pass(img, 0, h, filt)
    return img


def pil_resize_bicubic(img_u8: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W, C] -> [h, w, C] as Pillow's ``Image.resize((w, h))``
    computes it with its default BICUBIC filter, without Pillow: the
    two-pass fixed-point resample of libImaging/Resample.c, the horizontal
    pass first, each pass rounding and clipping to uint8, the filter's
    support widened by the downscale factor. ``size`` is (w, h) as Pillow's."""
    return _pil_resize(img_u8, size, "bicubic")


def pil_resize_lanczos(img_u8: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """As ``pil_resize_bicubic``, with Pillow's LANCZOS filter
    (``Image.resize(size, Image.LANCZOS)``): support 3."""
    return _pil_resize(img_u8, size, "lanczos")


def load_and_resize_image(path: str, size: int = 256, host_cpp: bool = False) -> np.ndarray:
    """An image file -> uint8 [size, size, 3], as the JAX package's
    utils/image.py:load_and_resize_image (the reference's
    load_and_resize_imagenet_image): its native extension's ``load_resize``
    first, here the port's ``native`` counterpart (libjpeg and libpng
    decodes, no antialias; IOError where that fails); where that module
    cannot be imported, ``read_image_rgb``, the centre square crop, then
    Pillow's BILINEAR resample (``_pil_resize`` with a triangle on support
    1), as it computes it without the extension. host_cpp: the fallback's
    decode and resize in the host C++, as ``read_image_rgb``'s."""
    try:
        from ..native import _l2i_native as nat
    except ImportError:
        nat = None
    if nat is not None:
        return nat.load_resize(path, size)
    return pillow_load_and_resize(path, size, host_cpp)


def pillow_load_and_resize(path: str, size: int = 256, host_cpp: bool = False) -> np.ndarray:
    """``load_and_resize_image`` without the native path: what the JAX
    package's Pillow code computes (``Image.open(path).convert("RGB")``, the
    centre square, ``resize((size, size), BILINEAR)``), as its regressor
    trainer reads the test split always."""
    im = read_image_rgb(path, host_cpp)
    h, w = im.shape[:2]
    dim = min(w, h)
    top, left = (h - dim) // 2, (w - dim) // 2
    return _pil_resize(im[top:top + dim, left:left + dim], (size, size), "bilinear", host_cpp)


def to_uint8(ims) -> np.ndarray:
    """[-1, 1] float images -> uint8 (the reference's clip_ims): clip
    ((x + 1) / 2) * 255 to [0, 255] and truncate. Already-uint8 input passes
    through."""
    ims = np.asarray(ims)
    if ims.dtype == np.uint8:
        return ims
    return np.uint8(np.clip(((ims + 1) / 2.0) * 255, 0, 255))
