"""Writes the WEBP, arithmetic-coded JPEG, 16-bit PNG and Adam7 PNG fixtures
of this directory, and their Pillow decodes (``Image.open(p).convert("RGB")``),
for the machines that have no Pillow (chip_smoke.py phase 53,
tests/test_torch_image_kinds.py, tests/test_torch_webp.py):

    PYTHONPATH=. python tests/fixtures/torch_image_kinds/make_fixtures.py

The photo-like images of tests/fixtures/torch_jpeg/make_fixtures.py:
- webp_lossless_*.webp: VP8L at 1 x 1, 17 x 23 (method 0) and 64 x 48
  (method 6), a 16-colour palette (pixel bundling) and an RGBA image kept
  exact;
- webp_lossy_*.webp: VP8 at quality 5 (37 x 53) and 90 (method 6), one with
  alpha (VP8X + ALPH), and the 256 x 256 photo chip_smoke inverts with bp;
- webp_anim_*.webp: the first frame of a two-frame animation (Pillow's),
  and one whose first frame sits at an offset on a larger canvas (written
  here: VP8X + ANIM + ANMF around a Pillow VP8L frame);
- arith_*.jpg: a Pillow JPEG re-coded with arithmetic coding
  (tests/jpeg_arith_encoder.py): grayscale sequential, 4:2:0 sequential
  with a restart interval and a non-default DAC, 4:4:4 and 4:2:0
  progressive, the last with restarts;
- lossless_*.jpg: lossless JPEG (SOF3, tests/jpeg_lossless_encoder.py):
  grayscale with predictor 6, a point transform and restarts, and RGB with
  4:2:0 sampling and predictor 7 (libjpeg-turbo replicates its chroma);
- smooth_*.jpg: Pillow's progressive JPEGs with scans left out, so that
  libjpeg-turbo smooths their blocks: without the refinement scans (4:2:0)
  and with the DC scans alone (4:4:4, DC interpolation too);
- png16_*.png, adam7_*.png: 16-bit PNGs of every colour type (one with
  tRNS) and Adam7 PNGs at depths 1, 4, 8 and 16, written here (Pillow
  writes no interlaced PNG), and the 256 x 256 16-bit photo bp inverts;
- gif_*.gif, bmp_*.bmp, tiff_*.tif (utils/gif.py, bmp.py, tiff.py): a
  quantized GIF with transparency (Pillow's) and an interlaced one with a
  local colour table off the canvas's origin; BMP at 8 bits (Pillow's),
  RLE4 and RLE8, 16-bit 5-6-5 bitfields, top-down 24-bit and OS/2 v1; TIFF
  RGB with LZW and the horizontal predictor (Pillow's), big-endian deflate
  tiles of a palette image, PackBits 1-bit WhiteIsZero
  (tests/image_format_encoders.py writes what Pillow does not).
decodes.npz holds each decode as <name>.npy (the 256 x 256 photos by their
digest only); decodes.json each decode's shape and SHA-256.
"""

import hashlib
import importlib.util
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
import PIL.Image

HERE = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.dirname(os.path.dirname(HERE))
_spec = importlib.util.spec_from_file_location(
    "torch_jpeg_fixtures", os.path.join(HERE, "..", "torch_jpeg", "make_fixtures.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
photo = _base.photo

# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
         (1, 0, 2, 2), (0, 1, 1, 2))
SPP = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _filtered(rows: np.ndarray, bpp: int, first: int) -> bytes:
    """Rows of bytes, row i written with PNG filter (first + i) % 5."""
    out, prev = b"", np.zeros(rows.shape[1], np.int64)
    for i, row in enumerate(rows.astype(np.int64)):
        f = (first + i) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = 0 * row
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out += bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row
    return out


def _rows(vals: np.ndarray, depth: int) -> np.ndarray:
    """Samples [h, w, spp] -> packed rows of bytes (MSB first, 16-bit
    big-endian)."""
    h, w, spp = vals.shape
    if depth < 8:
        bits = ((vals[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
        return np.packbits(bits.reshape(h, w * depth), axis=1)
    if depth == 16:
        return np.frombuffer(vals.astype(">u2").tobytes(), np.uint8).reshape(h, -1)
    return vals.astype(np.uint8).reshape(h, -1)


def png(vals: np.ndarray, depth: int, color: int, interlace: int = 0, plte=None,
        trns=None) -> bytes:
    """A PNG of samples [h, w, spp] at ``depth``, every filter type in
    turn, Adam7 where ``interlace``."""
    h, w, spp = vals.shape
    bpp = max(1, spp * depth // 8)
    if interlace:
        raw, k = b"", 0
        for x0, y0, dx, dy in ADAM7:
            sub = vals[y0::dy, x0::dx]
            if sub.size:
                raw += _filtered(_rows(sub, depth), bpp, k)
                k += sub.shape[0]
    else:
        raw = _filtered(_rows(vals, depth), bpp, 0)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def samples(h, w, color, depth, seed, noise=True) -> np.ndarray:
    """A photo's samples at ``depth`` bits in a colour type's layout
    (16-bit: the photo in the high byte, noise or the same byte in the low
    one)."""
    rgb = photo(h, w, seed).astype(np.int64)
    rng = np.random.RandomState(seed)
    if depth == 16:
        rgb = rgb * 256 + (rng.randint(0, 256, rgb.shape) if noise else rgb)
    elif depth < 8:
        rgb = rgb >> (8 - depth)
    gray = rgb[..., :1]
    alpha = rng.randint(0, 1 << depth, gray.shape)
    return {0: gray, 2: rgb, 3: gray, 4: np.concatenate([gray, alpha], -1),
            6: np.concatenate([rgb, alpha], -1)}[color]


def riff(chunks: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


def webp_chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\x00" * (len(body) & 1)


def webp_image_chunk(data: bytes) -> bytes:
    """The VP8/VP8L chunk of a simple WEBP file Pillow wrote."""
    assert data[12:16] in (b"VP8 ", b"VP8L")
    return data[12:]


def offset_animation(frame_webp: bytes, canvas, offset) -> bytes:
    """A one-frame animation: the image chunk of ``frame_webp`` in an ANMF
    at ``offset`` (even x, y) on a canvas (w, h)."""
    chunk = webp_image_chunk(frame_webp)
    assert chunk[:4] == b"VP8L"
    v = int.from_bytes(chunk[9:13], "little")
    fw, fh = (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1
    vp8x = bytes([0x02, 0, 0, 0]) + (canvas[0] - 1).to_bytes(3, "little") + \
        (canvas[1] - 1).to_bytes(3, "little")
    anim = struct.pack("<IH", 0xFF000000, 0)
    anmf = ((offset[0] // 2).to_bytes(3, "little") + (offset[1] // 2).to_bytes(3, "little")
            + (fw - 1).to_bytes(3, "little") + (fh - 1).to_bytes(3, "little")
            + (100).to_bytes(3, "little") + bytes([0x02]) + chunk)
    return riff(webp_chunk(b"VP8X", vp8x) + webp_chunk(b"ANIM", anim)
                + webp_chunk(b"ANMF", anmf))


def _webp(img, **opts) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "WEBP", **opts)
    return buf.getvalue()


def _rgba(h, w, seed):
    img = PIL.Image.fromarray(photo(h, w, seed)).convert("RGBA")
    a = np.asarray(img.convert("L")).copy()
    a[a < 110] = 0  # transparent pixels, whose RGB "exact" keeps
    img.putalpha(PIL.Image.fromarray(a))
    return img


def _jpeg(h, w, seed, mode, **opts) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(photo(h, w, seed)).convert(mode).save(buf, "JPEG", **opts)
    return buf.getvalue()


def jpeg_scans(data: bytes, keep) -> bytes:
    """A JPEG with only the scans ``keep(components, Ss, Se, Ah, Al)``
    takes (components as their ids)."""
    out, pos = bytearray(b"\xff\xd8"), 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            return bytes(out + data[pos:pos + 2])
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDA:
            while data[end] != 0xFF or data[end + 1] == 0 or 0xD0 <= data[end + 1] <= 0xD7:
                end += 1
            ns = data[pos + 4]
            ss, se, a = data[pos + 5 + 2 * ns:pos + 8 + 2 * ns]
            if not keep(list(data[pos + 5:pos + 5 + 2 * ns:2]), ss, se, a >> 4, a & 15):
                pos = end
                continue
        out += data[pos:end]
        pos = end
    return bytes(out)


def files() -> dict:
    """name (with extension) -> file bytes."""
    sys.path.insert(0, TESTS)
    from jpeg_arith_encoder import arith_jpeg
    from jpeg_lossless_encoder import lossless_jpeg

    img = PIL.Image.fromarray
    out = {
        "webp_lossless_1x1.webp": _webp(img(photo(1, 1, 30)), lossless=True),
        "webp_lossless_17x23_m0.webp": _webp(img(photo(17, 23, 31)), lossless=True,
                                             method=0),
        "webp_lossless_64x48_m6.webp": _webp(img(photo(64, 48, 32)), lossless=True,
                                             method=6),
        "webp_lossless_pal16_45x31.webp": _webp(
            img(photo(45, 31, 33)).convert("P", palette=PIL.Image.ADAPTIVE, colors=16)
            .convert("RGB"), lossless=True),
        "webp_lossless_exact_rgba_40x36.webp": _webp(_rgba(40, 36, 34), lossless=True,
                                                     exact=True),
        "webp_lossy_q5_37x53.webp": _webp(img(photo(37, 53, 35)), quality=5),
        "webp_lossy_q90_m6_48x40.webp": _webp(img(photo(48, 40, 36)), quality=90, method=6),
        "webp_lossy_alpha_33x47.webp": _webp(_rgba(33, 47, 37), quality=75),
        "webp_lossy_256.webp": _webp(img(photo(256, 256, 38)), quality=80),
        "webp_anim_40x56.webp": None,
        "webp_anim_offset_50x44.webp": offset_animation(
            _webp(img(photo(24, 30, 40)), lossless=True), (50, 44), (8, 12)),
        "arith_gray_45x61.jpg": arith_jpeg(_jpeg(45, 61, 41, "L", quality=85)),
        "arith_420_restart_dac_64x48.jpg": arith_jpeg(
            _jpeg(64, 48, 42, "RGB", quality=80, subsampling=2), restart=3,
            dac={0: 0x52, 1: 0x63, 16: 2, 17: 9}),
        "arith_prog_444_40x56.jpg": arith_jpeg(
            _jpeg(40, 56, 43, "RGB", quality=90, subsampling=0), progressive=True),
        "arith_prog_420_restart_53x37.jpg": arith_jpeg(
            _jpeg(53, 37, 44, "RGB", quality=75, subsampling=2), progressive=True, restart=2),
    }
    out["smooth_unrefined_420_37x53.jpg"] = jpeg_scans(
        _jpeg(37, 53, 48, "RGB", quality=75, subsampling=2, progressive=True),
        lambda comps, ss, se, ah, al: ah == 0)
    out["smooth_dc_only_444_40x32.jpg"] = jpeg_scans(
        _jpeg(40, 32, 49, "RGB", quality=80, subsampling=0, progressive=True),
        lambda comps, ss, se, ah, al: ss == 0)
    gray, rgb = photo(45, 37, 46)[..., 0], photo(30, 40, 47)
    out["lossless_gray_p6_45x37.jpg"] = lossless_jpeg([gray], [(1, 1)], predictor=6, pt=1,
                                                      restart_rows=4)
    out["lossless_rgb_420_p7_40x30.jpg"] = lossless_jpeg(
        [rgb[..., 0], rgb[::2, ::2, 1], rgb[::2, ::2, 2]], [(2, 2), (1, 1), (1, 1)],
        predictor=7, marker=None)
    buf = io.BytesIO()
    img(photo(40, 56, 39)).save(buf, "WEBP", save_all=True, quality=80, duration=100,
                                append_images=[img(photo(40, 56, 45))])
    out["webp_anim_40x56.webp"] = buf.getvalue()
    for color in (0, 2, 4, 6):
        out[f"png16_c{color}_23x19.png"] = png(samples(19, 23, color, 16, 50 + color), 16, color)
    out["png16_c2_trns_21x17.png"] = png(samples(17, 21, 2, 16, 55), 16, 2,
                                         trns=struct.pack(">HHH", 1000, 2000, 3000))
    out["png16_256.png"] = png(samples(256, 256, 2, 16, 56, noise=False), 16, 2)
    pal = photo(16, 16, 57).reshape(-1, 3)
    for color, depth in ((0, 1), (3, 4), (2, 8), (6, 16)):
        out[f"adam7_c{color}_d{depth}_19x13.png"] = png(
            samples(13, 19, color, depth, 60 + depth), depth, color, interlace=1,
            plte=pal if color == 3 else None)
    out.update(formats())
    return out


def formats() -> dict:
    """The GIF, BMP and TIFF fixtures (name -> bytes)."""
    from image_format_encoders import bmp, bmp_rle, bmp_rows, gif, tiff

    def saved(image, fmt, **opts):
        buf = io.BytesIO()
        image.save(buf, fmt, **opts)
        return buf.getvalue()

    img = PIL.Image.fromarray
    ph = photo(48, 64, 70)
    rng = np.random.RandomState(71)
    pal = photo(16, 16, 72).reshape(-1, 3)
    idx = rng.randint(0, 16, (29, 37))
    rle = (photo(23, 31, 73)[..., 0] // 64).astype(np.int64)
    out = {
        "gif_quantized_trns_64x48.gif": saved(img(ph).quantize(64), "GIF", transparency=7),
        "gif_local_interlaced_50x40.gif": gif((50, 40), idx, gpal=pal[:8], lpal=pal[16:32],
                                              pos=(6, 4), interlace=True),
        "bmp_p8_64x48.bmp": saved(img(ph).quantize(100), "BMP"),
        "bmp_rle4_31x23.bmp": bmp(31, 23, 4, bmp_rle(rle[::-1] * 5, True, seed=74),
                                  pal=pal, comp=2),
        "bmp_rle8_31x23.bmp": bmp(31, 23, 8, bmp_rle(rle[::-1] * 60, False, seed=75,
                                                     delta_after_row=3),
                                  pal=photo(16, 16, 76).reshape(-1, 3), comp=1),
        "bmp_565_31x23.bmp": bmp(31, 23, 16, bmp_rows(
            rng.randint(0, 256, (23, 62)), 8, 62), comp=3,
            after_header=struct.pack("<III", 0xF800, 0x7E0, 0x1F)),
        "bmp_24_top_down_31x23.bmp": bmp(31, 23, 24, bmp_rows(
            photo(23, 31, 77)[..., ::-1].reshape(23, -1), 8, 93), topdown=True),
        "bmp_os2_p4_31x23.bmp": bmp(31, 23, 4, bmp_rows(rle, 4, 31), pal=pal, os2=True),
        "tiff_rgb_lzw_predictor_64x48.tif": saved(img(ph), "TIFF", compression="tiff_lzw",
                                                  tiffinfo={317: 2}),
        "tiff_p4_tiles_deflate_be_37x29.tif": tiff(
            idx[..., None], 4, 3, ">", 8, tile=(16, 16),
            cmap=rng.randint(0, 65536, 48)),
        "tiff_1_packbits_white_is_zero_37x29.tif": tiff(
            (idx[..., None] > 7).astype(np.int64), 1, 0, "<", 32773, rps=8),
    }
    return out


def main() -> None:
    decodes, meta = {}, {}
    for name, data in files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        key = os.path.splitext(name)[0]
        dec = np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))
        meta[key] = {"shape": list(dec.shape),
                     "sha256": hashlib.sha256(dec.tobytes()).hexdigest()}
        if "256" not in key:
            decodes[key] = dec
    np.savez_compressed(os.path.join(HERE, "decodes.npz"), **decodes)
    meta["pillow"] = PIL.__version__
    with open(os.path.join(HERE, "decodes.json"), "w") as f:
        json.dump(meta, f, indent=1)


if __name__ == "__main__":
    main()
