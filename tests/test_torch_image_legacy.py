"""The legacy formats of the port's image reader (ROADMAP item 28.6:
latent2im_tpu_torch/utils/dcx.py, xbm.py, xpm.py, msp.py, sun.py, fli.py,
fits.py, spider.py, im.py, mcidas.py, gbr.py, pcd.py, pixar.py,
xvthumb.py, imt.py, iptc.py and raw.py) held to Pillow 12.1's
``Image.open(f).convert("RGB")`` on the spot: every mode of each format,
the five formats without a signature reached through ``read_image_rgb``'s
dispatch in Pillow's order, and a seeded fuzz. Files Pillow cannot write
come from tests/image_format_encoders.py; the readers are held to Pillow,
not to the writers."""

from __future__ import annotations

import io
import os
import struct
import tempfile
import warnings

import numpy as np
import PIL.Image
import pytest

from image_format_encoders import (dcx_file, fits_file, fits_gzip, fli_brun, fli_chunk,
                                   fli_color, fli_file, fli_lc, fli_ss2, gbr_file, iptc_file,
                                   mcidas_file, msp_file, pcd_file, pixar_file, sun_file,
                                   sun_rle, sun_rows, xpm_file, xvthumb_file, imt_file)
from latent2im_tpu_torch.utils import image as im
from latent2im_tpu_torch.utils import pcd as pcdmod
from latent2im_tpu_torch.utils import raw as rawmod

_Y, _X = np.mgrid[0:11, 0:13]
IMG = np.clip(np.stack([_X * 19, _Y * 23, (_X * _Y) % 256], -1)
              + np.random.RandomState(5).randint(-20, 20, (11, 13, 3)), 0, 255).astype(np.uint8)
PIC = PIL.Image.fromarray(IMG)
RNG = np.random.RandomState(28)


def _pillow(data):
    """Pillow's decode of the bytes, or None where it fails, the file read
    from its path, as the JAX package opens every image: PcxImagePlugin
    seeks back from the end of such a file, which fails on a short one
    (ROADMAP C.14), and ImageFile.load maps a raw image whose raw mode is
    its mode (C.17)."""
    with tempfile.TemporaryDirectory() as d:
        name = os.path.join(d, "image")
        with open(name, "wb") as f:
            f.write(data)
        return _pillow_open(name)


def _pillow_open(src):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            with PIL.Image.open(src) as img:
                return np.asarray(img.convert("RGB"))
        except Exception:
            return None


def _read(tmp_path, data, name="f"):
    """read_image_rgb on the bytes, or None where it raises ValueError."""
    path = tmp_path / name
    path.write_bytes(data)
    try:
        return im.read_image_rgb(str(path))
    except ValueError:
        return None


def _saved(img, fmt, **opts):
    buf = io.BytesIO()
    img.save(buf, fmt, **opts)
    return buf.getvalue()


def _fli_forms() -> dict:
    w, h = 14, 9
    pal = RNG.randint(0, 256, (256, 3))
    a = RNG.randint(0, 256, (h, w)).astype(np.uint8)
    a[2:5] = 7  # runs for BRUN
    b = a.copy()
    b[3, 2:9] = 200
    b[6, 0:4] = 9
    c = b.copy()
    c[1] = np.arange(w) * 3
    c[7, 4:] = 11
    pal64 = RNG.randint(0, 64, (256, 3))
    return {
        "brun": fli_file(w, h, [[fli_color(pal), fli_brun(a)]]),
        "brun_lc": fli_file(w, h, [[fli_color(pal), fli_brun(a), fli_lc(a, b)]]),
        "color64_copy": fli_file(w, h, [[fli_color(pal64, 11), fli_chunk(16, a.tobytes())]],
                                 magic=0xAF11),
        "black_ss2": fli_file(w, h, [[fli_color(pal), fli_chunk(13, b""), fli_ss2(
            np.zeros_like(c), c)]]),
        "pstamp_two_frames": fli_file(w, h, [[fli_chunk(18, bytes(20)), fli_color(pal),
                                              fli_brun(a)], [fli_lc(a, b)]]),
        "no_palette": fli_file(w, h, [[fli_brun(b)]]),
        "prefix": fli_file(w, h, [[fli_color(pal), fli_brun(a)]],
                           prefix=struct.pack("<IH", 16, 0xF100) + bytes(10)),
    }


def _im_forms() -> dict:
    out = {}
    rgb = PIC
    for mode in ("1", "L", "LA", "P", "PA", "I", "I;16", "I;16L", "I;16B", "F", "RGB", "RGBA",
                 "RGBX", "CMYK", "YCbCr"):
        if mode in ("I", "I;16", "I;16L", "I;16B", "F"):
            arr = (IMG[..., 0].astype(np.int64) * 3 - 100)
            img = PIL.Image.fromarray(arr.astype(np.int32), "I").convert(mode) \
                if mode != "F" else PIL.Image.fromarray(arr.astype(np.float32) * 1.37, "F")
        elif mode in ("P", "PA"):
            img = rgb.quantize(30)
            img = img if mode == "P" else img.convert("PA")
        else:
            img = rgb.convert(mode)
        out[mode] = _saved(img, "IM")
    w, h = 13, 11

    def head(kind, extra=b""):
        return (b"Image type: %s\r\nImage size (x*y): %d*%d\r\nName: x\r\n" % (kind, w, h)
                + extra + b"\x1a")

    planes = RNG.randint(0, 256, (3, h, w)).astype(np.uint8)
    out["rgb3"] = head(b"RGB3 image") + planes.tobytes()
    out["b2_no_lut"] = head(b"B2 image") + RNG.randint(0, 256, h * 4).astype(np.uint8).tobytes()
    out["b4"] = head(b"B4 image") + RNG.randint(0, 256, h * 7).astype(np.uint8).tobytes()
    for bits in (5, 12):
        out[f"bits{bits}"] = head(b"L*%d image" % bits) + RNG.randint(
            0, 256, h * ((w * bits + 7) // 8)).astype(np.uint8).tobytes()
    for kind, n in ((b"L 8S image", 1), (b"L 16S image", 2), (b"L 32S image", 4),
                    (b"L 32F image", 4), (b"L 32 F image", 4)):
        out[kind.decode()] = head(kind) + RNG.randint(0, 256, w * h * n).astype(
            np.uint8).tobytes()
    lut = np.concatenate([np.arange(256)[::-1]] * 3).astype(np.uint8).tobytes()  # gray, not linear
    out["l_gray_lut"] = head(b"Greyscale image", b"Lut: 1\r\n") + lut + IMG[..., 1].tobytes()
    lut = RNG.randint(0, 256, 768).astype(np.uint8).tobytes()
    out["la_color_lut"] = head(b"LA image", b"Lut: 1\r\n") + lut + RNG.randint(
        0, 256, 2 * w * h).astype(np.uint8).tobytes()
    out["rgb_lut"] = head(b"RGB image", b"Lut: 1\r\n") + lut + planes.tobytes()
    out["rlb"] = head(b"RLB image") + planes.tobytes()
    out["unknown_type"] = head(b"RGB") + planes.tobytes()
    return out


def _forms() -> dict:
    """{name: file bytes}: every form of each format."""
    f = {}
    pcx_pages = [_saved(PIC, "PCX"), _saved(PIC.convert("L"), "PCX"),
                 _saved(PIC.quantize(16), "PCX")]
    f["dcx_rgb"] = dcx_file(pcx_pages)
    f["dcx_l"] = dcx_file(pcx_pages[1:])
    f["dcx_p"] = dcx_file(pcx_pages[2:])
    bilevel = PIC.convert("1")
    f["xbm"] = _saved(bilevel, "XBM")
    f["xbm_hotspot"] = _saved(bilevel, "XBM", hotspot=(2, 3))
    f["xbm_odd_digits"] = (b"#define a_width 9\n#define a_height 2\nstatic char a_bits[] = {\n"
                           b"0x1,0xfg,0XZZ,0xz, 0x7f };\n")
    idx = RNG.randint(0, 5, (11, 13))
    pal = RNG.randint(0, 256, (5, 3))
    f["xpm_p"] = xpm_file(idx, pal)
    f["xpm_no_pixel_comment"] = xpm_file(idx, pal, pixels_comment=False)
    f["xpm_rgb"] = xpm_file(RNG.randint(0, 300, (11, 13)), RNG.randint(0, 256, (300, 3)), 2)
    f["xpm_none"] = xpm_file(idx, pal, none_key="z")
    f["xpm_none_used"] = xpm_file(idx, pal, none_key="z").replace(b'/* pixels */\n"',
                                                                  b'/* pixels */\n"z', 1)
    bits = np.asarray(bilevel, np.uint8)
    f["msp_v1"] = _saved(bilevel, "MSP")
    f["msp_v2"] = msp_file(bits)
    f["msp_v2_blank_rows"] = msp_file(bits, rowmap=[0] * 11, rows=[])
    f["msp_v2_long_row"] = msp_file(bits[:2], rows=[b"\x03\xaa\xbb\xcc", b"\x00\x05\x0f"])
    f["msp_v2_literal_past_row"] = msp_file(bits[:1], rows=[b"\x09\x01\x02"])
    v8 = RNG.randint(0, 256, (11, 13)).astype(np.uint8)
    v8[3:6] = 0x80
    cmap = RNG.randint(0, 256, 3 * 40).astype(np.uint8).tobytes()
    for depth, v in ((1, RNG.randint(0, 2, (11, 13))), (4, RNG.randint(0, 16, (11, 13))),
                     (8, v8), (24, IMG), (32, np.concatenate([IMG, IMG[..., :1]], -1))):
        for ftype in ((1, 3, 2) if depth >= 24 else (1, 2)):
            rows = sun_rows(v, depth, pad=ftype != 2)
            body = sun_rle(rows) if ftype == 2 else rows
            f[f"sun_{depth}_type{ftype}"] = sun_file(13, 11, depth, body, ftype)
        if depth == 8:
            f["sun_8_cmap"] = sun_file(13, 11, 8, sun_rows(v, 8), 1, cmap)
            f["sun_8_cmap_rle"] = sun_file(13, 11, 8, sun_rle(sun_rows(v, 8, False)), 2, cmap)
            f["sun_8_rle_padded"] = sun_file(13, 11, 8, sun_rle(sun_rows(v, 8)), 2)
            f["sun_8_rle_long_run"] = sun_file(13, 11, 8, b"\x80\xff\x09" * 2, 2)
    for name, data in _fli_forms().items():
        f["fli_" + name] = data
    gray = (IMG[..., 0].astype(np.int64) * 129 - 3000)
    for bitpix, dt in ((8, "u1"), (16, ">i2"), (32, ">i4"), (-32, ">f4"), (-64, ">f8")):
        vals = (gray % 256 if bitpix == 8 else gray).astype(dt)
        f[f"fits_{bitpix}"] = fits_file([("SIMPLE", "T"), ("BITPIX", bitpix), ("NAXIS", 2),
                                         ("NAXIS1", 13), ("NAXIS2", 11), ("BSCALE", 2),
                                         ("BZERO", 100)], vals.tobytes())
    f["fits_naxis1"] = fits_file([("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 1),
                                  ("NAXIS1", 17)], bytes(range(17)))
    for bits in (8, 16, 32, -32):
        f[f"fits_gzip_{bits}"] = fits_gzip(gray % 256 if bits == 8 else gray, bits)
    fimg = PIL.Image.fromarray((IMG[..., 2].astype(np.float32) * 1.7 - 40), "F")
    f["spider"] = _saved(fimg, "SPIDER")
    f["spider_be"] = _spider_be(f["spider"])
    f["spider_stack"] = _spider_stack(f["spider"])
    for name, data in _im_forms().items():
        f["im_" + name] = data
    for size in (1, 2, 4):
        f[f"mcidas_{size}"] = mcidas_file(gray % (256 ** size) if size < 4 else gray, size)
    f["mcidas_prefix"] = mcidas_file(gray % 256, 1, prefix=3)
    f["mcidas_bands"] = mcidas_file(gray % 65536, 2, bands=2)
    f["gbr_v1"] = gbr_file(IMG[..., 0], 1)
    f["gbr_v2"] = gbr_file(IMG[..., 1])
    f["gbr_v2_rgba"] = gbr_file(np.concatenate([IMG, IMG[..., :1]], -1))
    y = RNG.randint(0, 256, (512, 768))
    c1, c2 = RNG.randint(0, 256, (256, 384)), RNG.randint(0, 256, (256, 384))
    for o in (0, 1, 2, 3):
        f[f"pcd_orient{o}"] = pcd_file(y, c1, c2, o)
    f["pixar"] = pixar_file(IMG)
    f["xvthumb"] = xvthumb_file(RNG.randint(0, 256, (11, 13)))
    f["imt"] = imt_file(IMG[..., 0])
    f["imt_comment"] = imt_file(IMG[..., 0]).replace(b"pixel n8", b"* a comment\npixel n8")
    f["iptc_l"] = iptc_file(13, 11, [IMG[..., 0].tobytes()], 1, 0)
    f["iptc_l_split"] = iptc_file(13, 11, [IMG[..., 0].tobytes()], 1, 0, split=50)
    f["iptc_rgb_band2"] = iptc_file(13, 11, [IMG[..., 1].tobytes()], 3, 1, band=2)
    f["iptc_cmyk_band4"] = iptc_file(13, 11, [IMG[..., 2].tobytes()], 4, 1, band=4)
    f["iptc_rgb_no_band"] = iptc_file(13, 11, [IMG[..., 2].tobytes()], 3, 1)
    f["iptc_jpeg_l"] = iptc_file(13, 11, [_saved(PIC.convert("L"), "JPEG")], 1, 0, 5)
    f["iptc_jpeg_rgb"] = iptc_file(13, 11, [_saved(PIC, "JPEG")], 1, 0, 5)
    f["iptc_jpeg_band"] = iptc_file(13, 11, [_saved(PIC.convert("L"), "JPEG")], 3, 1, 5,
                                    band=1)
    return f


def _spider_be(le: bytes) -> bytes:
    """Pillow's SPIDER file (native order: little-endian here) as big-endian."""
    return np.frombuffer(le, "<f4").astype(">f4").tobytes()


def _spider_stack(le: bytes) -> bytes:
    """A stack of two images from Pillow's one: the stack header (ISTACK
    > 0, MAXIM 2), then each image's header and data."""
    h = np.frombuffer(le, "<f4").copy()
    labbyt = int(h[21])
    hdr, body = h[:labbyt // 4].copy(), h[labbyt // 4:]
    stack = hdr.copy()
    stack[23], stack[25], stack[26] = 2, 2, 0
    one = hdr.copy()
    one[26] = 1
    return (stack.astype("<f4").tobytes() + one.astype("<f4").tobytes() + body.tobytes()
            + one.astype("<f4").tobytes() + (body * 0 + 3).astype("<f4").tobytes())


FORMS = _forms()


@pytest.mark.parametrize("name", sorted(FORMS))
def test_each_legacy_form_decodes_as_pillow(tmp_path, name):
    """Each form through read_image_rgb, bit for bit as Pillow, or failing
    where Pillow fails."""
    data = FORMS[name]
    want, got = _pillow(data), _read(tmp_path, data)
    assert (got is None) == (want is None), name
    if want is not None:
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_the_forms_reach_what_they_should():
    """The forms are what they claim: Pillow reads all but the few it fails
    (a GZIP_1 float FITS image, an FLI whose prefix chunk stands where the
    first frame is read, an unknown IM raw mode or type, a transparent XPM
    key in use)."""
    fails = sorted(k for k, v in FORMS.items() if _pillow(v) is None)
    assert fails == ["fits_gzip_-32", "fli_prefix", "im_rlb", "im_unknown_type",
                     "xpm_none_used"], fails
    formats = {PIL.Image.open(io.BytesIO(v)).format for v in FORMS.values()}
    assert formats == {"DCX", "XBM", "XPM", "MSP", "SUN", "FLI", "FITS", "SPIDER", "IM",
                       "MCIDAS", "GBR", "PCD", "PIXAR", "XVThumb", "IMT", "IPTC"}, formats


def test_signature_less_formats_come_in_pillows_order(tmp_path):
    """IM, IMT, IPTC, PCD and SPIDER have no signature: a file each is
    reached through the dispatch (Pillow names the same format), and a file
    no reader takes fails without naming item 28."""
    for name in ("im_L", "imt", "iptc_l", "pcd_orient0", "spider"):
        data = FORMS[name]
        np.testing.assert_array_equal(_read(tmp_path, data), _pillow(data), err_msg=name)
    path = tmp_path / "none.bin"
    path.write_bytes(b"\x07" * 300)
    assert _pillow(path.read_bytes()) is None
    with pytest.raises(ValueError, match=r"none\.bin") as e:
        im.read_image_rgb(str(path))
    assert "item 28" not in str(e.value)
    order = [n for n, _, _ in im._decoders()]
    assert [order.index(n) for n in ("IM", "IMT", "IPTC", "PCD", "SPIDER", "TGA")] == sorted(
        order.index(n) for n in ("IM", "IMT", "IPTC", "PCD", "SPIDER", "TGA"))


def test_raw_modes_and_photoycc_are_pillows():
    """utils/raw.py's unpackers against Image.frombytes, and PhotoCD's YCC
    tables on every (Y, C1, C2) column of a random draw."""
    rng = np.random.RandomState(3)
    for rawmode, mode in (("1", "1"), ("1;I", "1"), ("1;R", "1"), ("L;4", "L"), ("P;2", "P"),
                          ("RGB;L", "RGB"), ("BGRX", "RGB"), ("CMYK;L", "CMYK"),
                          ("YCbCr;L", "YCbCr"), ("I;16B", "I;16B"), ("I;32B", "I"),
                          ("F;8S", "F"), ("F;16S", "F"), ("F;32", "F"), ("F;32BF", "F")):
        w, h = 7, 3
        data = rng.randint(0, 256, rawmod.line_bytes(w, rawmode) * h).astype(np.uint8).tobytes()
        want = PIL.Image.frombytes(mode, (w, h), data, "raw", rawmode)
        got = rawmod.unpack(data, 0, w, h, rawmode)
        if mode in ("P",):
            np.testing.assert_array_equal(got[..., 0], np.asarray(want), err_msg=rawmode)
        elif mode in ("I", "I;16B", "F"):
            np.testing.assert_array_equal(got[..., 0], np.asarray(want, np.float64),
                                          err_msg=rawmode)
        else:
            np.testing.assert_array_equal(rawmod.to_rgb(mode, got),
                                          np.asarray(want.convert("RGB")), err_msg=rawmode)
    y = rng.randint(0, 256, (512, 768))
    c1, c2 = (rng.randint(0, 256, (256, 384)) for _ in range(2))
    want = _pillow(pcd_file(y, c1, c2))
    up = lambda c: np.repeat(np.repeat(c, 2, 0), 2, 1)  # noqa: E731
    np.testing.assert_array_equal(pcdmod.photoycc_rgb(y, up(c1), up(c2)), want)


def _fuzzed(data: bytes, rng) -> bytes:
    d = bytearray(data)
    op, n = rng.randint(4), len(d)
    at = rng.randint(0, n)
    if op == 0:
        for _ in range(rng.randint(1, 4)):
            # half the overwrites land in the first 160 bytes, where the headers are
            d[rng.randint(0, min(n, 160)) if rng.randint(2) else rng.randint(0, n)] = \
                rng.randint(256)
    elif op == 1:
        d[at:at] = bytes(rng.randint(0, 256, rng.randint(1, 8)).astype(np.uint8))
    elif op == 2:
        del d[at:at + rng.randint(1, 8)]
    else:
        d = d[:at]
    return bytes(d)


def test_fuzzed_legacy_files_fail_where_pillow_fails(tmp_path):
    """400 fuzzed files across the sixteen formats (bytes overwritten,
    inserted, deleted or cut): each decodes through read_image_rgb to
    Pillow's image, or fails where Pillow fails (Pillow may take a file for
    another format, and so must the dispatch)."""
    rng = np.random.RandomState(286)
    names = sorted(k for k in FORMS if not k.startswith("pcd"))
    read = 0
    for k in range(400):
        data = _fuzzed(FORMS[names[rng.randint(len(names))]], rng)
        want, got = _pillow(data), _read(tmp_path, data)
        assert (got is None) == (want is None), k
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=str(k))
            read += 1
    assert 80 < read < 360, read
