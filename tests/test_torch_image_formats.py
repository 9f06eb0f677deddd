"""GIF, BMP, DIB, TIFF, Netpbm, QOI, TGA, PCX, SGI, ICO and CUR in the
port's image reader (latent2im_tpu_torch/utils/gif.py, bmp.py, tiff.py,
ccitt.py, netpbm.py, qoi.py, tga.py, pcx.py, sgi.py, ico.py through
utils/image.py:read_image_rgb), bit for bit against Pillow 12.1's
``Image.open(p).convert("RGB")`` on files written here, by Pillow where it
writes the form and by tests/image_format_encoders.py where it does not;
where Pillow fails a file, the port fails it, naming it; a form Pillow
reads and the port does not (TIFF's LAB, AVIF and the rest of the list)
names ROADMAP item 28."""

import io
import os
import struct
import tempfile
import warnings

import numpy as np
import PIL.Image
import pytest

from image_format_encoders import (BAND, bmp, bmp_rle, bmp_rows, ccitt, dib_frame, gif,
                                   icon_file, photo_forms, sgi_file, tga_file, tga_rle, tiff,
                                   tiff_lzw, tiff_lzw_old)
from latent2im_tpu_torch.utils import image as im
from latent2im_tpu_torch.utils import tiff as tiffmod

RNG = np.random.RandomState(17)
PHOTO = RNG.randint(0, 256, (37, 53, 3)).astype(np.uint8)


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


def _check(tmp_path, name, data):
    """The port reads the file as Pillow does, or fails it naming it."""
    path = tmp_path / name
    path.write_bytes(data)
    want = _pillow(data)
    if want is None:
        with pytest.raises(ValueError, match=name.replace(".", r"\.")):
            im.read_image_rgb(str(path))
        return False
    got = im.read_image_rgb(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return True


def _pillow_saved(img, fmt, **opts):
    buf = io.BytesIO()
    img.save(buf, fmt, **opts)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# GIF: the first frame
# ---------------------------------------------------------------------------

def _gif_cases():
    img = PIL.Image.fromarray(PHOTO)
    pal = RNG.randint(0, 256, (256, 3))
    idx = RNG.randint(0, 16, (13, 17))
    anim = io.BytesIO()
    img.quantize(64).save(anim, "GIF", save_all=True,
                          append_images=[PIL.Image.fromarray(PHOTO[::-1]).quantize(64)])
    return {
        "quantized": _pillow_saved(img.quantize(200), "GIF"),
        "interlaced": _pillow_saved(img.quantize(16), "GIF", interlace=True),
        "transparency": _pillow_saved(img.quantize(32), "GIF", transparency=5),
        "gray": _pillow_saved(img.convert("L"), "GIF"),
        "two_colours": _pillow_saved(img.convert("1"), "GIF"),
        "animated": anim.getvalue(),
        "local_table_offset": gif((30, 20), idx, gpal=pal[:8], lpal=pal[8:24], pos=(5, 3)),
        "local_interlaced": gif((30, 20), idx, lpal=pal[:16], pos=(5, 3), interlace=True),
        "frame_past_screen": gif((10, 10), idx, gpal=pal[:16], pos=(5, 3)),
        "transparent_fill": gif((30, 20), idx, gpal=pal[:16], pos=(5, 3), trns=3),
        "no_table": gif((30, 20), idx * 10),
        "short_table": gif((30, 20), idx, gpal=pal[:4]),
        "identity_gray_table": gif((17, 13), idx, gpal=np.stack([np.arange(16)] * 3, -1)),
        "min_code_size_2": gif((17, 13), idx % 4, gpal=pal[:4], min_bits=2),
        "large": gif((300, 200), RNG.randint(0, 256, (200, 300)), gpal=pal),
        "truncated_data": gif((30, 20), idx, gpal=pal[:16], cut=20),
    }


GIF_CASES = _gif_cases()


@pytest.mark.parametrize("case", sorted(GIF_CASES))
def test_gif_first_frame_decodes_as_pillow(tmp_path, case):
    _check(tmp_path, f"{case}.gif", GIF_CASES[case])


def test_gif_refusals_name_the_file(tmp_path):
    assert not _check(tmp_path, "cut.gif", GIF_CASES["quantized"][:60])
    assert not _check(tmp_path, "noimage.gif", GIF_CASES["quantized"][:13 + 3 * 256] + b";")


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

def _bmp_cases():
    w, h = 13, 7
    out = {}
    for bits in (1, 4, 8):
        n = 1 << bits
        pal = RNG.randint(0, 256, (n, 3))
        v = RNG.randint(0, n, (h, w))
        rows = bmp_rows(v, bits, w)
        out[f"p{bits}"] = bmp(w, h, bits, rows, pal=pal)
        out[f"p{bits}_top_down"] = bmp(w, h, bits, rows, pal=pal, topdown=True)
        out[f"p{bits}_os2"] = bmp(w, h, bits, rows, pal=pal, os2=True)
        out[f"p{bits}_v5_header"] = bmp(w, h, bits, rows, pal=pal, hsize=124)
        out[f"p{bits}_short_table"] = bmp(w, h, bits, rows, pal=pal[:max(1, n // 2)],
                                          colors=max(1, n // 2))
        gray = [[0, 0, 0], [255, 255, 255]] if bits == 1 else np.stack([np.arange(n)] * 3, -1)
        out[f"p{bits}_gray_table"] = bmp(w, h, bits, rows, pal=gray)
    words = np.arange(65536, dtype="<u2").view(np.uint8).reshape(256, 512)
    out["b16_555"] = bmp(256, 256, 16, bmp_rows(words, 8, 512))
    out["b16_565_bitfields"] = bmp(256, 256, 16, bmp_rows(words, 8, 512), comp=3,
                                   after_header=struct.pack("<III", 0xF800, 0x7E0, 0x1F))
    out["b16_555_bitfields_v3"] = bmp(256, 256, 16, bmp_rows(words, 8, 512), comp=3,
                                      hsize=56, masks=(0x7C00, 0x3E0, 0x1F, 0))
    out["b16_unknown_bitfields"] = bmp(256, 256, 16, bmp_rows(words, 8, 512), comp=3,
                                       hsize=56, masks=(0xF00, 0xF0, 0xF, 0))
    px3 = RNG.randint(0, 256, (h, 3 * w))
    px4 = RNG.randint(0, 256, (h, 4 * w))
    out["b24"] = bmp(w, h, 24, bmp_rows(px3, 8, 3 * w))
    out["b24_top_down"] = bmp(w, h, 24, bmp_rows(px3, 8, 3 * w), topdown=True)
    out["b24_os2"] = bmp(w, h, 24, bmp_rows(px3, 8, 3 * w), os2=True)
    out["b24_truncated"] = bmp(w, h, 24, bmp_rows(px3, 8, 3 * w))[:-5]
    out["b32"] = bmp(w, h, 32, bmp_rows(px4, 8, 4 * w))
    for k, m in enumerate([(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
                           (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                           (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                           (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                           (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0),
                           (0xFF, 0xFF00, 0xFF0000, 0)]):
        out[f"b32_bitfields_{k}"] = bmp(w, h, 32, bmp_rows(px4, 8, 4 * w), comp=3, hsize=124,
                                        masks=m)
    out["b32_bitfields_40"] = bmp(w, h, 32, bmp_rows(px4, 8, 4 * w), comp=3,
                                  after_header=struct.pack("<III", 0xFF0000, 0xFF00, 0xFF))
    for rle4 in (False, True):
        n = 16 if rle4 else 256
        v = RNG.randint(0, 3, (11, 19)) * (n // 4)
        pal = RNG.randint(0, 256, (n, 3))
        name = "rle4" if rle4 else "rle8"
        data = bmp_rle(v, rle4, seed=n)
        out[name] = bmp(19, 11, 4 if rle4 else 8, data, pal=pal, comp=2 if rle4 else 1)
        out[f"{name}_top_down"] = bmp(19, 11, 4 if rle4 else 8, data, pal=pal,
                                      comp=2 if rle4 else 1, topdown=True)
        out[f"{name}_odd_offset"] = bmp(19, 11, 4 if rle4 else 8, data, pal=pal,
                                        comp=2 if rle4 else 1, after_header=b"\x00")
        out[f"{name}_delta"] = bmp(19, 11, 4 if rle4 else 8,
                                   bmp_rle(v, rle4, seed=n + 1, delta_after_row=2), pal=pal,
                                   comp=2 if rle4 else 1)
        out[f"{name}_gray_table"] = bmp(19, 11, 4 if rle4 else 8, data,
                                        pal=np.stack([np.arange(n)] * 3, -1),
                                        comp=2 if rle4 else 1)
        out[f"{name}_cut"] = out[name][:-9]
    out["pillow_rgb"] = _pillow_saved(PIL.Image.fromarray(PHOTO), "BMP")
    out["pillow_p"] = _pillow_saved(PIL.Image.fromarray(PHOTO).quantize(100), "BMP")
    out["pillow_1"] = _pillow_saved(PIL.Image.fromarray(PHOTO).convert("1"), "BMP")
    return out


BMP_CASES = _bmp_cases()


@pytest.mark.parametrize("case", sorted(BMP_CASES))
def test_bmp_decodes_as_pillow(tmp_path, case):
    _check(tmp_path, f"{case}.bmp", BMP_CASES[case])


def test_bmp_refusals_name_the_file(tmp_path):
    v = RNG.randint(0, 4, (5, 6))
    assert not _check(tmp_path, "b2.bmp", bmp(6, 5, 2, bmp_rows(v, 2, 6), pal=np.zeros((4, 3))))
    assert not _check(tmp_path, "hdr.bmp", b"BM" + bytes(12) + struct.pack("<I", 20) + bytes(16))
    assert not _check(tmp_path, "b24_truncated.bmp", BMP_CASES["b24_truncated"])


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

def _tiff_cases():
    out = {}
    img = PIL.Image.fromarray(PHOTO)
    for mode in ("RGB", "L", "P", "1", "RGBA"):
        x = img.quantize(50) if mode == "P" else img.convert(mode)
        for comp in ("raw", "packbits", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate"):
            out[f"pillow_{mode}_{comp}"] = _pillow_saved(x, "TIFF", compression=comp)
    out["pillow_lzw_predictor"] = _pillow_saved(img, "TIFF", compression="tiff_lzw",
                                                tiffinfo={317: 2})
    gray = RNG.randint(0, 256, (37, 53, 1))
    for bo in ("<", ">"):
        e = "le" if bo == "<" else "be"
        for comp in (1, 5, 8, 32773):
            out[f"rgb_strips_{e}_{comp}"] = tiff(PHOTO, 8, 2, bo, comp, rps=5)
            out[f"rgb_tiles_{e}_{comp}"] = tiff(PHOTO, 8, 2, bo, comp, tile=(16, 16))
            out[f"rgb_predictor_{e}_{comp}"] = tiff(PHOTO, 8, 2, bo, comp, rps=7, predictor=2)
            out[f"gray_tiles_predictor_{e}_{comp}"] = tiff(gray, 8, 1, bo, comp,
                                                           tile=(32, 16), predictor=2)
            for bits in (1, 2, 4, 8):
                v = RNG.randint(0, 1 << bits, (37, 53, 1))
                out[f"g{bits}_white_is_zero_{e}_{comp}"] = tiff(v, bits, 0, bo, comp, rps=6)
                out[f"g{bits}_fill_order_2_{e}_{comp}"] = tiff(v, bits, 1, bo, comp, rps=6,
                                                               fill=2)
                out[f"p{bits}_tiles_{e}_{comp}"] = tiff(
                    v, bits, 3, bo, comp, tile=(16, 32),
                    cmap=RNG.randint(0, 65536, 3 * (1 << bits)))
            out[f"rgba_{e}_{comp}"] = tiff(RNG.randint(0, 256, (9, 11, 4)), 8, 2, bo, comp,
                                           extra=(2,))
    out["rgb_truncated"] = tiff(PHOTO, 8, 2, "<", 1, rps=5)[:200]
    return out


TIFF_CASES = _tiff_cases()


@pytest.mark.parametrize("case", sorted(TIFF_CASES))
def test_tiff_decodes_as_pillow(tmp_path, case):
    _check(tmp_path, f"{case}.tif", TIFF_CASES[case])


def test_tiff_forms_pillow_reads_and_the_port_does_not_name_item_28(tmp_path):
    lab = _pillow_saved(PIL.Image.fromarray(PHOTO).convert("LAB"), "TIFF")
    lab_lzw = _pillow_saved(PIL.Image.fromarray(PHOTO).convert("LAB"), "TIFF",
                            compression="tiff_lzw")
    for name, data in (("lab.tif", lab), ("lab_lzw.tif", lab_lzw)):
        assert _pillow(data) is not None
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(ValueError, match=name.replace(".", r"\.") + ".*LAB.*item 28"):
            im.read_image_rgb(str(path))


def _c16_cases() -> dict:
    """ROADMAP C.16: TIFFs that Pillow fails and whose refusal named item
    28: compressions Pillow does not know, WEBP (its libtiff has no such
    codec), SGILog as LogL, LogLuv or another photometric, and a
    JPEG-in-TIFF with photometric RGB over a 4:2:0 JPEG (improper JPEG
    sampling factors); old-style JPEG lossless or upsampled by libjpeg."""
    out, rng = {}, np.random.RandomState(16)
    gray = rng.randint(0, 256, (5, 7, 1))
    junk = bytes(rng.randint(0, 256, 64).astype(np.uint8))
    for comp in (34712, 34887, 50002, 99, 50001, 34676, 34677):
        out[f"c16_comp_{comp}.tif"] = tiff(gray, 8, 1, "<", comp, encode_chunk=lambda b: junk)
    for comp in (34676, 34677):
        for photo, spp in ((32844, 1), (32845, 3)):
            out[f"c16_sgilog_{comp}_{photo}.tif"] = tiff(
                rng.randint(0, 256, (5, 7, spp)), 8, photo, "<", comp,
                encode_chunk=lambda b: junk)
    img = rng.randint(0, 256, (11, 13, 3)).astype(np.uint8)
    j = _pillow_saved(PIL.Image.fromarray(img), "JPEG", subsampling="4:2:0")
    out["c16_jpeg_rgb_420.tif"] = tiff(img, 8, 2, "<", 7, encode_chunk=lambda b: j)
    # old-style JPEG (a strip that is a whole JFIF stream) in the two forms
    # libtiff always fails: a lossless frame (SOF3), and sampling factors
    # it leaves libjpeg to upsample (chroma other than 1 x 1, luma 3)
    j = _pillow_saved(PIL.Image.fromarray(img), "JPEG", subsampling="4:4:4")
    k = j.index(b"\xff\xc0")
    out["c16_ojpeg_sof3.tif"] = tiff(img, 8, 6, "<", 6, tags={530: (3, [1, 1])},
                                     encode_chunk=lambda b: j[:k + 1] + b"\xc3" + j[k + 2:])
    for factors in ((0x22, 0x21, 0x11), (0x11, 0x11, 0x12), (0x31, 0x11, 0x11)):
        sof = bytearray(j)
        for c, f in enumerate(factors):
            sof[k + 11 + 3 * c] = f
        out[f"c16_ojpeg_sampling_{'_'.join(f'{f:x}' for f in factors)}.tif"] = tiff(
            img, 8, 6, "<", 6, tags={530: (3, [factors[0] >> 4, factors[0] & 15])},
            encode_chunk=lambda b, sof=bytes(sof): sof)
    return out


def test_other_kinds_still_name_item_28(tmp_path):
    """What Pillow reads and the port does not yet (AVIF alone) names item
    28; the MSP, FITS and DCX stubs that named it before, and the DDS, JPEG
    2000, PSD and ICNS ones, now fail as Pillow fails them, naming the
    file, and so do the TIFFs of ROADMAP C.16, naming no item."""
    avif = b"\0\0\0\x1cftypavif" + bytes(200)
    path = tmp_path / "a.avif"
    path.write_bytes(avif)
    with pytest.raises(ValueError, match="item 28"):
        im.read_image_rgb(str(path))
    for name, data in (("a.dds", b"DDS " + bytes(124)),
                       ("a.jp2", b"\0\0\0\x0cjP  \r\n\x87\n" + bytes(40)),
                       ("a.psd", b"8BPS" + bytes(200)), ("a.icns", b"icns" + bytes(200)),
                       ("a.msp", b"DanM" + bytes(200)), ("a.fits", b"SIMPLE" + bytes(200)),
                       ("a.dcx", b"\xb1\x68\xde\x3a" + bytes(200))):
        assert _pillow(data) is None, name
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(ValueError, match=name.replace(".", r"\.")) as e:
            im.read_image_rgb(str(path))
        assert "Pillow reads them" not in str(e.value), name
    for name, data in _c16_cases().items():
        assert _pillow(data) is None, name
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(ValueError, match=name.replace(".", r"\.")) as e:
            im.read_image_rgb(str(path))
        assert "item 28" not in str(e.value) and "Pillow reads" not in str(e.value), name


def test_the_fixtures_equal_their_recorded_pillow_decodes():
    """tests/fixtures/torch_image_kinds' GIF, BMP and TIFF files (what the
    card reads, chip_smoke.py phase 54) against decodes.npz."""
    here = os.path.join(os.path.dirname(__file__), "fixtures", "torch_image_kinds")
    npz = np.load(os.path.join(here, "decodes.npz"))
    names = [f for f in os.listdir(here) if f.endswith((".gif", ".bmp", ".tif"))]
    assert len(names) >= 9
    for name in names:
        got = im.read_image_rgb(os.path.join(here, name))
        np.testing.assert_array_equal(got, npz[os.path.splitext(name)[0]])


# ---------------------------------------------------------------------------
# Netpbm, QOI, TGA, PCX, SGI, ICO and CUR, DIB
# ---------------------------------------------------------------------------

SMALL = RNG.randint(0, 256, (29, 41, 3)).astype(np.uint8)


def _netpbm_cases():
    out = {}
    img = PIL.Image.fromarray(SMALL)
    for mode in ("1", "L", "RGB", "I", "F"):
        x = img.convert(mode) if mode not in ("I", "F") else PIL.Image.fromarray(
            SMALL[..., 0].astype(np.int32) * 257 - 1000 if mode == "I"
            else SMALL[..., 1].astype(np.float32) * 1.37 - 20)
        out[f"pillow_{mode}"] = _pillow_saved(x, "PPM")
    g, rgb = RNG.randint(0, 256, (7, 9)), RNG.randint(0, 256, (7, 9, 3))
    for maxval in (1, 3, 15, 100, 254, 256, 1000, 4095, 65534, 65535):
        vg, vc = RNG.randint(0, maxval + 1, (7, 9)), RNG.randint(0, maxval + 1, (7, 9, 3))
        fmt = ">u2" if maxval > 255 else np.uint8
        out[f"p5_max{maxval}"] = b"P5\n9 7\n%d\n" % maxval + vg.astype(fmt).tobytes()
        out[f"p6_max{maxval}"] = b"P6 9 7 %d\n" % maxval + vc.astype(fmt).tobytes()
        out[f"p2_max{maxval}"] = b"P2\n# c\n9 7\n%d\n" % maxval + b" ".join(
            b"%d" % v for v in vg.ravel()) + b"\n"
        out[f"p3_max{maxval}"] = b"P3\n9 7\n%d\n" % maxval + b"\n".join(
            b"%d" % v for v in vc.ravel())
    out["p5_max100_values_past"] = b"P5\n9 7\n100\n" + g.astype(np.uint8).tobytes()
    out["p2_value_past_max"] = b"P2\n2 1\n10\n5 11\n"
    bits = RNG.randint(0, 2, (5, 11))
    out["p1"] = b"P1\n# bits\n11 5\n" + b"".join(
        b"".join(b"%d" % v for v in row) + b"\n" for row in bits)
    out["p1_spaced"] = b"P1 11 5 " + b" ".join(b"%d" % v for v in bits.ravel())
    out["p1_bad_char"] = b"P1 2 1 0 2"
    out["p4"] = b"P4\n11 5\n" + np.packbits(bits, axis=1).tobytes()
    out["p4_short"] = b"P4\n11 5\n" + np.packbits(bits, axis=1).tobytes()[:-1]
    out["p6_short"] = b"P6 9 7 255\n" + bytes(10)
    out["comment_in_token"] = b"P5\n9#c\n 7\n255\n" + g.astype(np.uint8).tobytes()
    out["comment_cr"] = b"P6 #x\r9 7 255\n" + rgb.astype(np.uint8).tobytes()
    out["pf_le"] = b"Pf\n9 7\n-1.0\n" + (RNG.rand(7, 9).astype("<f4") * 300 - 20).tobytes()
    out["pf_be"] = b"Pf\n9 7\n2.5\n" + (RNG.rand(7, 9).astype(">f4") * 300 - 20).tobytes()
    out["pf_nan_inf"] = b"Pf 3 1 -1 " + np.array([np.nan, np.inf, -np.inf], "<f4").tobytes()
    out["PF_color"] = b"PF\n3 1\n-1\n" + bytes(36)
    out["pam"] = b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nENDHDR\n" + bytes(6)
    out["maxval_0"] = b"P5 2 1 0\n" + bytes(2)
    out["token_too_long"] = b"P5 2 00000000001 255\n" + bytes(2)
    out["p0cmyk"] = b"P0CMYK\n3 2\n255\n" + RNG.randint(0, 256, 24).astype(np.uint8).tobytes()
    out["pyrgba"] = b"PyRGBA\n3 2\n255\n" + RNG.randint(0, 256, 24).astype(np.uint8).tobytes()
    out["pyp"] = b"PyP\n3 2\n255\n" + bytes(6)
    out["p3_trailing_long_token"] = b"P3 1 1 255 1 2 3 123456789012345"
    out["p2_short"] = b"P2 3 1 255 1 2"
    return out


def _qoi_cases():
    out = {}
    for mode in ("RGB", "RGBA"):
        a = SMALL.copy()
        a[3:9, 5:30] = a[3, 5]
        img = PIL.Image.fromarray(a).convert(mode)
        if mode == "RGBA":
            arr = np.asarray(img).copy()
            arr[..., 3] = RNG.randint(0, 4, arr.shape[:2]) * 85
            img = PIL.Image.fromarray(arr)
        data = _pillow_saved(img, "QOI")
        out[f"pillow_{mode}"] = data
        out[f"pillow_{mode}_cut"] = data[:len(data) // 2]
    head = b"qoif" + struct.pack(">II", 4, 2) + bytes([4, 0])
    out["ops"] = head + bytes([0xFE, 10, 20, 30, 0x7F, 0xA8, 0x9C, 0xC1, 0x05, 0xFF, 1, 2, 3, 4,
                               0x30]) + bytes(7) + b"\x01"
    out["run_overshoot"] = b"qoif" + struct.pack(">II", 2, 2) + bytes([3, 0, 0xFE, 9, 8, 7,
                                                                       0xD4])
    out["channels_5"] = b"qoif" + struct.pack(">II", 1, 1) + bytes([5, 1, 0xFE, 9, 8, 7])
    out["short_rgb_op"] = b"qoif" + struct.pack(">II", 1, 1) + bytes([3, 0, 0xFE, 9])
    return out


def _tga_cases():
    out = {}
    img = PIL.Image.fromarray(SMALL)
    for mode in ("RGB", "RGBA", "L", "LA", "P", "1"):
        x = img.quantize(60) if mode == "P" else img.convert(mode)
        for rle in (False, True):
            for orient in (None, 1, -1):
                opts = {"rle": rle} if orient is None else {"rle": rle, "orientation": orient}
                out[f"pillow_{mode}_{'rle' if rle else 'raw'}_{orient}"] = _pillow_saved(
                    x, "TGA", **opts)
    w, h = 13, 7
    rgb = RNG.randint(0, 256, (h, w, 3)).astype(np.uint8)
    rgb[2:5, 3:11] = rgb[2, 3]
    for flags in (0x00, 0x10, 0x20, 0x30, 0x28):
        out[f"bgr24_flags{flags:02x}"] = tga_file(w, h, 2, 24, rgb[..., ::-1].tobytes(),
                                                  flags=flags)
    px16 = RNG.randint(0, 65536, (h, w)).astype("<u2")
    out["bgr16"] = tga_file(w, h, 2, 16, px16.tobytes())
    out["bgr16_rle"] = tga_file(w, h, 10, 16, tga_rle([r.tobytes() for r in px16], 2, 1))
    out["bgra32_rle"] = tga_file(w, h, 10, 32, tga_rle(
        [np.concatenate([rgb[r][:, ::-1], rgb[r][:, :1]], -1).tobytes() for r in range(h)], 4, 2))
    out["bgr24_rle_bottom_up"] = tga_file(w, h, 10, 24, tga_rle(
        [rgb[r][:, ::-1].tobytes() for r in range(h)], 3, 3), flags=0x00)
    idx = RNG.randint(0, 40, (h, w)).astype(np.uint8)
    out["cmap24_start5"] = tga_file(w, h, 1, 8, idx.tobytes(), cmap=RNG.randint(
        0, 256, 90).astype(np.uint8).tobytes(), cstart=5, image_id=b"hello")
    out["cmap16"] = tga_file(w, h, 1, 8, idx.tobytes(), cmap=RNG.randint(
        0, 65536, 40).astype("<u2").tobytes(), cdepth=16)
    out["cmap32_rle"] = tga_file(w, h, 9, 8, tga_rle([r.tobytes() for r in idx], 1, 4),
                                 cmap=RNG.randint(0, 256, 160).astype(np.uint8).tobytes(),
                                 cdepth=32)
    out["cmap_past_256"] = tga_file(w, h, 1, 8, idx.tobytes(), cmap=bytes(600), cstart=100)
    out["gray_with_map"] = tga_file(w, h, 3, 8, idx.tobytes(), cmap=RNG.randint(
        0, 256, 150).astype(np.uint8).tobytes())
    out["la_with_16bit_map"] = tga_file(w, h, 3, 16, RNG.randint(0, 50, (h, w, 2)).astype(
        np.uint8).tobytes(), cmap=RNG.randint(0, 65536, 50).astype("<u2").tobytes(), cdepth=16)
    out["rgb_with_map"] = tga_file(w, h, 2, 24, rgb.tobytes(), cmap=bytes(12))
    out["gray8_rle"] = tga_file(w, h, 11, 8, tga_rle([r.tobytes() for r in idx], 1, 5))
    out["gray1"] = tga_file(w, h, 3, 1, np.packbits(RNG.randint(0, 2, (h, w)), axis=1).tobytes())
    out["gray16_la"] = tga_file(w, h, 3, 16, RNG.randint(0, 256, (h, w, 2)).astype(
        np.uint8).tobytes())
    out["rle_across_rows"] = tga_file(4, 2, 10, 24, bytes([0x85, 1, 2, 3]))
    out["rle_short"] = tga_file(4, 2, 10, 24, bytes([0x81, 1, 2, 3]))
    out["raw_short"] = tga_file(4, 2, 2, 24, bytes(20))
    out["gray24_no_raw_mode"] = tga_file(2, 1, 3, 24, bytes(6))
    out["cmapped_without_map"] = tga_file(2, 1, 1, 8, bytes(2))
    out["map_depth_15"] = tga_file(2, 1, 1, 8, bytes(2), cmap=bytes(4), cdepth=15)
    return out


def _pcx_file(w, h, planes, provided, lines, bits=1, version=5):
    hdr = bytearray(128)
    hdr[0], hdr[1], hdr[2], hdr[3] = 10, version, 1, bits
    hdr[4:12] = struct.pack("<HHHH", 0, 0, w - 1, h - 1)
    hdr[16:64] = RNG.randint(0, 256, 48).astype(np.uint8).tobytes()
    hdr[65] = planes
    hdr[66:68] = struct.pack("<H", provided)
    body = bytearray()
    for line in lines:
        for b in line:
            body += bytes([0xC1, b]) if b >= 0xC0 else bytes([b])
    return bytes(hdr) + bytes(body)


def _pcx_cases():
    out = {}
    img = PIL.Image.fromarray(SMALL)
    for mode in ("1", "L", "P", "RGB"):
        x = img.quantize(70) if mode == "P" else img.convert(mode)
        out[f"pillow_{mode}"] = _pillow_saved(x, "PCX")
        out[f"pillow_{mode}_w40"] = _pillow_saved(x.crop((0, 0, 40, 9)), "PCX")
    out["pillow_identity_gray_palette"] = _pillow_saved(PIL.Image.fromarray(
        np.tile(np.arange(40, dtype=np.uint8), (5, 1))), "PCX")
    for w in (3, 5, 13, 21):
        for planes, bits in ((2, 1), (4, 1), (1, 1), (3, 8), (1, 8)):
            stride = (w * bits + 7) // 8
            for provided in (stride, stride + 1):
                st = stride + stride % 2 if provided != stride else stride
                lines = [RNG.randint(0, 0xC0, planes * st).astype(np.uint8).tobytes()
                         for _ in range(3)]
                out[f"w{w}_{planes}x{bits}_stride{provided}"] = _pcx_file(
                    w, 3, planes, provided, lines, bits)
    data = bytearray(out["pillow_L"])
    data[128:130] = bytes([0xFF, 1])
    out["run_past_line"] = bytes(data)
    out["cut"] = out["pillow_RGB"][:400]
    return out


def _sgi_cases():
    out = {}
    img = PIL.Image.fromarray(SMALL)
    for mode in ("L", "RGB", "RGBA"):
        for bpc in (1, 2):
            out[f"pillow_{mode}_{bpc}"] = _pillow_saved(img.convert(mode), "SGI", bpc=bpc)
    planes = RNG.randint(0, 256, (4, 9, 13))
    planes[:, 2:6, 1:10] = planes[:, 2:3, 1:2]
    for z in (1, 3, 4):
        for bpc in (1, 2):
            p = planes[:z] * 257 + RNG.randint(0, 256, planes[:z].shape) if bpc == 2 else \
                planes[:z]
            out[f"rle_z{z}_bpc{bpc}"] = sgi_file(p, bpc, rle=True)
    out["rle_dim1"] = sgi_file(planes[:1, :1], 1, rle=True, dim=1)
    out["rle_unterminated"] = sgi_file(planes[:3], 1, rle=True, terminate=False)
    out["rle_short_rows"] = sgi_file(planes[:1], 1, rle=True, lengths=[2] * 9)
    out["verbatim_cut"] = out["pillow_RGB_1"][:600]
    return out


def _ico_cases():
    out = {}
    img = PIL.Image.fromarray(RNG.randint(0, 256, (64, 64, 3)).astype(np.uint8))
    out["pillow_png_sizes"] = _pillow_saved(img, "ICO", sizes=[(16, 16), (32, 32), (48, 48)])
    out["pillow_bmp"] = _pillow_saved(img.convert("RGBA"), "ICO", sizes=[(32, 32)],
                                      bitmap_format="bmp")
    out["pillow_bmp_p"] = _pillow_saved(img.quantize(16), "ICO", sizes=[(24, 24)],
                                        bitmap_format="bmp")
    pal = [tuple(RNG.randint(0, 256, 3)) for _ in range(16)]
    idx = RNG.randint(0, 16, (16, 16))
    rgb, rgba = RNG.randint(0, 256, (16, 16, 3)), RNG.randint(0, 256, (32, 32, 4))
    f4, f24 = dib_frame(idx, 4, pal), dib_frame(rgb, 24)
    f32 = dib_frame(rgba, 32, and_mask=False)
    out["largest_of_three"] = icon_file([(16, 16, 4, 16, f4), (32, 32, 32, 0, f32),
                                         (16, 16, 24, 0, f24)])
    out["same_size_two_depths"] = icon_file([(16, 16, 24, 0, f24), (16, 16, 4, 16, f4)])
    out["mask_cut"] = icon_file([(16, 16, 24, 0, dib_frame(rgb, 24, and_mask=False))])
    # an entry's size past the file's end by the padding of the mask's last
    # row: still read, as Pillow reads it; by one byte more: not
    for name, more in (("mask_last_row_unpadded", 2), ("mask_last_row_short", 3)):
        data = bytearray(icon_file([(16, 16, 24, 0, dib_frame(rgb, 24))]))
        data[14:18] = struct.pack("<I", struct.unpack("<I", data[14:18])[0] + more)
        out[name] = bytes(data)
    out["no_entries"] = icon_file([])
    out["cur_24"] = icon_file([(16, 16, 24, 0, f24)], kind=2)
    out["cur_two"] = icon_file([(16, 16, 4, 16, f4), (32, 32, 32, 0, f32)], kind=2)
    out["cur_32_at_22"] = icon_file([(16, 16, 32, 0, dib_frame(rgba[:16, :16], 32,
                                                               and_mask=False))], kind=2)
    out["cur_png"] = icon_file([(16, 16, 32, 0, _pillow_saved(img.resize((16, 16)), "PNG"))],
                               kind=2)
    return out


def _dib_cases():
    return {"from_bmp": _pillow_saved(PIL.Image.fromarray(SMALL), "BMP")[14:],
            "palette": _pillow_saved(PIL.Image.fromarray(SMALL).quantize(20), "BMP")[14:]}


FORMAT_CASES = [(ext, name, data) for ext, make in (
    ("ppm", _netpbm_cases), ("qoi", _qoi_cases), ("tga", _tga_cases), ("pcx", _pcx_cases),
    ("sgi", _sgi_cases), ("ico", _ico_cases), ("dib", _dib_cases))
    for name, data in make().items()]


@pytest.mark.parametrize("ext,name,data", FORMAT_CASES,
                         ids=[f"{e}-{n}" for e, n, _ in FORMAT_CASES])
def test_each_new_format_decodes_as_pillow(tmp_path, ext, name, data):
    _check(tmp_path, f"{name}.{ext}", data)


def test_the_new_formats_decode_and_fail_as_pillow_does():
    by_kind = {}
    for ext, name, data in FORMAT_CASES:
        ok = _pillow(data) is not None
        by_kind.setdefault(ext, [0, 0])[ok] += 1
    for ext, (fail, ok) in by_kind.items():
        assert ok >= 2, (ext, by_kind)
        assert fail >= (0 if ext == "dib" else 1), (ext, by_kind)


# ---------------------------------------------------------------------------
# the rest of TIFF
# ---------------------------------------------------------------------------

T_H, T_W = 11, 13
TPHOTO = RNG.randint(0, 256, (T_H, T_W, 3)).astype(np.uint8)


def _tiff_families() -> dict:
    """family -> {case: file}: each layout over both byte orders and the
    raw, LZW, deflate and PackBits paths."""
    fam = {}
    g16 = RNG.randint(0, 65536, (T_H, T_W, 1))
    rgb16 = RNG.randint(0, 65536, (T_H, T_W, 4))
    six = RNG.randint(0, 256, (T_H, T_W, 6))
    fl = (RNG.rand(T_H, T_W, 1) * 400 - 50).astype(np.float32)
    fl[0, :3, 0] = [np.nan, np.inf, -np.inf]
    big32 = RNG.randint(0, 1 << 32, (T_H, T_W, 1), dtype=np.uint64)
    cmap = RNG.randint(0, 65536, 768)
    layouts = {
        "gray16": lambda bo, c: tiff(g16, 16, 1, bo, c, rps=4),
        "gray16_white_is_zero": lambda bo, c: tiff(g16, 16, 0, bo, c, rps=4),
        "gray12": lambda bo, c: tiff(g16 >> 4, 12, 1, bo, c, rps=4),
        "signed8": lambda bo, c: tiff(six[..., :1], 8, 1, bo, c, sample_format=2),
        "signed16": lambda bo, c: tiff(g16, 16, 1, bo, c, sample_format=2),
        "signed32": lambda bo, c: tiff(big32, 32, 1, bo, c, sample_format=2),
        "unsigned32": lambda bo, c: tiff(big32, 32, 1, bo, c),
        "float32": lambda bo, c: tiff(fl, 32, 1, bo, c, sample_format=3),
        "float32_white_is_zero": lambda bo, c: tiff(fl, 32, 0, bo, c, sample_format=3),
        "rgb16_tiles": lambda bo, c: tiff(rgb16[..., :3], 16, 2, bo, c, tile=(16, 16)),
        "rgba16": lambda bo, c: tiff(rgb16, 16, 2, bo, c),
        "rgbx16": lambda bo, c: tiff(rgb16, 16, 2, bo, c, extra=(0,)),
        "rgba16_associated": lambda bo, c: tiff(rgb16, 16, 2, bo, c, extra=(1,)),
        "rgba16_unassociated": lambda bo, c: tiff(rgb16, 16, 2, bo, c, extra=(2,)),
        "rgba8_associated": lambda bo, c: tiff(rgb16 >> 8, 8, 2, bo, c, extra=(1,), rps=3),
        "rgba8_extra_999": lambda bo, c: tiff(rgb16 >> 8, 8, 2, bo, c, extra=(999,)),
        "rgb5_associated": lambda bo, c: tiff(six[..., :5], 8, 2, bo, c, extra=(1, 0)),
        "rgb6_unassociated": lambda bo, c: tiff(six, 8, 2, bo, c, extra=(2, 0, 0)),
        "cmyk8": lambda bo, c: tiff(six[..., :4], 8, 5, bo, c),
        "cmyk16": lambda bo, c: tiff(rgb16, 16, 5, bo, c),
        "cmyk_extra": lambda bo, c: tiff(six[..., :5], 8, 5, bo, c, extra=(0,)),
        "gray_alpha": lambda bo, c: tiff(six[..., :2], 8, 1, bo, c, extra=(2,)),
        "palette_extra": lambda bo, c: tiff(six[..., :2] % 16, 8, 3, bo, c, extra=(0,),
                                            cmap=cmap),
        "palette_alpha": lambda bo, c: tiff(six[..., :2] % 16, 8, 3, bo, c, extra=(2,),
                                            cmap=cmap),
        "ycbcr_one_sample": lambda bo, c: tiff(six[..., :1], 8, 6, bo, c),
        "ycbcr_1x1": lambda bo, c: tiff(six[..., :3], 8, 6, bo, c, tags={530: (3, [1, 1])}),
        "planar_rgb": lambda bo, c: tiff(six[..., :3], 8, 2, bo, c, planar=2, rps=5),
        "planar_rgba": lambda bo, c: tiff(six[..., :4], 8, 2, bo, c, planar=2, extra=(2,)),
        "planar_rgbx": lambda bo, c: tiff(six[..., :4], 8, 2, bo, c, planar=2, extra=(0,)),
        "planar_rgba_associated": lambda bo, c: tiff(six[..., :4], 8, 2, bo, c, planar=2,
                                                     extra=(1,)),
        "planar_rgb16_tiles": lambda bo, c: tiff(rgb16[..., :3], 16, 2, bo, c, planar=2,
                                                 tile=(16, 16)),
        "planar_cmyk": lambda bo, c: tiff(six[..., :4], 8, 5, bo, c, planar=2),
        "planar_gray_alpha": lambda bo, c: tiff(six[..., :2], 8, 1, bo, c, planar=2,
                                                extra=(2,)),
        "planar_one_float": lambda bo, c: tiff(fl, 32, 1, bo, c, planar=2, sample_format=3),
        "planar_one_gray16": lambda bo, c: tiff(g16, 16, 1, bo, c, planar=2),
        "planar_one_gray2": lambda bo, c: tiff(six[..., :1] % 4, 2, 1, bo, c, planar=2),
        "bigtiff_strips": lambda bo, c: tiff(TPHOTO, 8, 2, bo, c, big=True, rps=4),
        "bigtiff_tiles": lambda bo, c: tiff(TPHOTO, 8, 2, bo, c, big=True, tile=(16, 16)),
    }
    for o in range(1, 9):
        layouts[f"orientation_{o}"] = lambda bo, c, o=o: tiff(TPHOTO, 8, 2, bo, c, rps=3,
                                                              tags={274: (3, [o])})
    for name, make in layouts.items():
        fam[name] = {f"{'le' if bo == '<' else 'be'}_{c}": make(bo, c)
                     for bo in ("<", ">") for c in (1, 5, 8, 32773)}
    fam["predictors"] = {
        f"{name}_{'le' if bo == '<' else 'be'}_{c}": make(bo, c)
        for bo in ("<", ">") for c in (5, 8) for name, make in (
            ("gray16", lambda bo, c: tiff(g16, 16, 1, bo, c, predictor=2)),
            ("rgb16", lambda bo, c: tiff(rgb16[..., :3], 16, 2, bo, c, predictor=2)),
            ("signed32", lambda bo, c: tiff(big32, 32, 1, bo, c, sample_format=2, predictor=2)),
            ("float32_fp", lambda bo, c: tiff(fl, 32, 1, bo, c, sample_format=3, predictor=3)),
            ("gray4", lambda bo, c: tiff(six[..., :1] % 16, 4, 1, bo, c, predictor=2)))}
    fam["fill_order_2"] = {f"{name}_{'le' if bo == '<' else 'be'}": make(bo)
                           for bo in ("<", ">") for name, make in (
                               ("gray16_raw", lambda bo: tiff(g16, 16, 1, bo, 1, fill=2)),
                               ("gray16_lzw", lambda bo: tiff(g16, 16, 1, bo, 5, fill=2)),
                               ("rgb_lzw", lambda bo: tiff(TPHOTO, 8, 2, bo, 5, fill=2)))}
    img = PIL.Image.fromarray(TPHOTO)
    pillow = {}
    for mode in ("CMYK", "YCbCr", "I;16", "I", "F", "LA", "PA", "RGBX", "RGBA", "L", "RGB", "1",
                 "P"):
        x = {"I;16": lambda: PIL.Image.fromarray(TPHOTO[..., 0].astype(np.uint16) * 251),
             "I": lambda: PIL.Image.fromarray(TPHOTO[..., 0].astype(np.int32) * 300 - 9000),
             "F": lambda: PIL.Image.fromarray(TPHOTO[..., 1].astype(np.float32) * 1.7 - 30),
             "PA": lambda: img.quantize(40).convert("PA"),
             "P": lambda: img.quantize(40)}.get(mode, lambda: img.convert(mode))()
        for comp in ("raw", "tiff_lzw", "tiff_deflate", "packbits"):
            pillow[f"{mode}_{comp}"] = _pillow_saved(x, "TIFF", compression=comp)
        if mode in ("CMYK", "YCbCr", "LA", "RGBX", "RGBA", "L", "RGB"):
            pillow[f"{mode}_jpeg"] = _pillow_saved(x, "TIFF", compression="jpeg")
    fam["pillow_writes"] = pillow
    big = PIL.Image.fromarray(RNG.randint(0, 256, (70, 90, 3)).astype(np.uint8))
    fam["jpeg"] = {f"ycbcr_subsampling_{sub}": _pillow_saved(big, "TIFF", compression="jpeg",
                                                             quality=80, subsampling=sub)
                   for sub in (0, 1, 2)}
    fam["jpeg"]["gray"] = _pillow_saved(big.convert("L"), "TIFF", compression="jpeg")
    return fam


TIFF_FAMILIES = _tiff_families()


@pytest.mark.parametrize("family", sorted(TIFF_FAMILIES))
def test_tiff_forms_decode_as_pillow(tmp_path, family):
    read = 0
    for case, data in TIFF_FAMILIES[family].items():
        read += _check(tmp_path, f"{family}_{case}.tif", data)
    # Pillow fails a planar RGB with an extra plane on both of its paths
    assert read or family == "planar_rgbx", family


def _ycbcr_tiff(h, w, sh, sv, rps=None, tile=None, seed=0, bo="<", tags=None):
    import zlib

    rng = np.random.RandomState(seed)
    if tile:
        bx, by = tile[0] // sh, tile[1] // sv
        n = -(-w // tile[0]) * -(-h // tile[1])
    else:
        r = rps or h
        bx, by, n = -(-w // sh), -(-r // sv), -(-h // r)
    raws = iter([rng.randint(0, 256, by * bx * (sh * sv + 2)).astype(np.uint8).tobytes()
                 for _ in range(n)])
    more = {530: (3, [sh, sv])}
    more.update(tags or {})
    return tiff(np.zeros((h, w, 3), np.uint8), 8, 6, bo, 8, rps=rps, tile=tile, tags=more,
                encode_chunk=lambda b: zlib.compress(next(raws)))


def test_ycbcr_tiff_through_libtiffs_rgba_interface_is_pillows(tmp_path):
    """Every subsampling libtiff takes (and two it fails), strips (whose
    scanline size it truncates) and tiles (whose right edge it skips by 10
    bytes a 4 x 4 block), ReferenceBlackWhite and YCbCrCoefficients."""
    n = 0
    refbw = {532: (5, [10, 1, 250, 1, 128, 1, 255, 1, 100, 1, 200, 1]),
             529: (5, [2990, 10000, 5870, 10000, 1140, 10000])}
    for sh, sv in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1), (2, 4), (1, 4)):
        for h, w in ((5, 9), (9, 13), (8, 33), (17, 12)):
            for rps, tile in ((None, None), (3, None), (None, (16, 16)), (None, (32, 16))):
                data = _ycbcr_tiff(h, w, sh, sv, rps, tile, seed=n, bo="<>"[n % 2],
                                   tags=refbw if n % 3 == 0 else None)
                _check(tmp_path, f"ycc_{sh}x{sv}_{h}x{w}_{rps}_{tile and tile[0]}.tif", data)
                n += 1


def test_ccitt_tiff_is_libtiffs():
    """Group 3 (1D and 2D), group 4 and modified Huffman, bit orders 1 and 2,
    as Pillow's libtiff writes them, against its decode."""
    rng = np.random.RandomState(3)
    n = 0
    for trial in range(24):
        h, w = rng.randint(1, 30), rng.randint(1, 260)
        a = rng.rand(h, w) > rng.choice([0.02, 0.3, 0.5, 0.95])
        if trial % 3 == 0:
            a = np.repeat(a[:, ::7], 7, 1)[:, :w]
        img = PIL.Image.fromarray(a.astype(np.uint8) * 255).convert("1")
        for comp, opts in (("group3", {}), ("group3", {"tiffinfo": {292: 1}}), ("group4", {}),
                           ("tiff_ccitt", {}), ("group4", {"tiffinfo": {266: 2}})):
            data = _pillow_saved(img, "TIFF", compression=comp, **opts)
            want = _pillow(data)
            np.testing.assert_array_equal(tiffmod.tiff_decode_rgb(data), want)
            n += 1
    assert n == 120


@pytest.mark.parametrize("comp,every", [(2, 0), (3, 0), (3, 4), (4, 0)])
def test_the_ccitt_writer_is_libtiffs(comp, every):
    """tests/image_format_encoders.py:ccitt (the CCITT strips phase 55 times,
    written without Pillow) against libtiff's decode, runs past 2560 (the
    extended make-up codes) included, and the port's decode of them."""
    rng = np.random.RandomState(comp + every)
    for h, w in ((9, 3000), (31, 77), (1, 1)):
        black = (rng.rand(h, w) > rng.choice([0.1, 0.5, 0.9])).astype(np.uint8)
        black[0] = 0
        if h > 2:
            black[1, 5:2900] = 1
        tags = {} if comp != 3 else {292: (4, [1 if every else 0])}

        def enc(b, w=w):
            rows = np.unpackbits(np.frombuffer(b, np.uint8)).reshape(-1, -(-w // 8) * 8)
            return ccitt(rows[:, :w], comp, every)

        data = tiff(black[..., None], 1, 0, "<", comp, encode_chunk=enc, tags=tags)
        want = _pillow(data)
        np.testing.assert_array_equal(want[..., 0], (1 - black) * 255)
        np.testing.assert_array_equal(tiffmod.tiff_decode_rgb(data), want)


PHOTO_FORMS = photo_forms(2 * BAND, 3)


@pytest.mark.parametrize("name", sorted(PHOTO_FORMS))
def test_the_photo_forms_decode_as_pillow(tmp_path, name):
    """photo_forms (phase 55's photo-sized files, here at two bands) against
    Pillow, and against the image each was written from where the form
    keeps it."""
    data, source = PHOTO_FORMS[name]
    want = _check(tmp_path, name, data)
    assert want
    if source is not None:
        np.testing.assert_array_equal(_pillow(data), source)


def test_lzw_old_and_new_style_are_libtiffs():
    rng = np.random.RandomState(7)
    for trial in range(16):
        n = rng.randint(50, 20000)
        data = rng.randint(0, rng.randint(2, 256), n).astype(np.uint8)
        for enc in (tiff_lzw, tiff_lzw_old):
            f = tiff(data.reshape(1, n, 1), 8, 1, "<", 5, encode_chunk=enc)
            want = _pillow(f)
            assert want is not None and np.array_equal(want[0, :, 0], data)
            np.testing.assert_array_equal(tiffmod.tiff_decode_rgb(f), want)


def test_the_tiff_layouts_are_pillows():
    from PIL import TiffImagePlugin

    for (prefix, *key), want in TiffImagePlugin.OPEN_INFO.items():
        assert tiffmod._layout("<" if prefix == b"II" else ">", tuple(key)) == want, key


def test_cut_raw_files_read_no_padding_after_the_last_row(tmp_path):
    """Pillow's raw decoder needs no row padding after the last row: a BMP
    or uncompressed TIFF cut inside it still decodes, one cut further
    fails, on both sides."""
    img = PIL.Image.fromarray(SMALL)
    files = {}
    for mode in ("P", "RGB", "1", "L"):
        x = img.quantize(20) if mode == "P" else img.convert(mode)
        files[f"bmp_{mode}"] = _pillow_saved(x, "BMP")
        files[f"tiff_{mode}"] = _pillow_saved(x, "TIFF")
    files["tiff_tiles"] = tiff(SMALL, 8, 2, "<", 1, tile=(16, 16))
    outcomes = set()
    for name, data in files.items():
        for cut in range(0, 48, 3):
            outcomes.add(_check(tmp_path, f"{name}_{cut}.bin", data[:len(data) - cut]))
    assert outcomes == {True, False}


def test_eps_and_the_stub_formats_fail_as_pillow_fails(tmp_path):
    eps = _pillow_saved(PIL.Image.fromarray(SMALL), "EPS")
    for name, data in (("a.eps", eps), ("a.bufr", b"BUFR" + bytes(40)),
                       ("a.grib", b"GRIB\0\0\0\x01" + bytes(40)),
                       ("a.h5", b"\x89HDF\r\n\x1a\n" + bytes(40)),
                       ("a.mpg", b"\0\0\x01\xb3\x01\0\x10\x11" + bytes(40)),
                       ("a.wmf", b"\xd7\xcd\xc6\x9a\0\0" + bytes(40))):
        assert _pillow(data) is None, name
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(ValueError, match=name.replace(".", r"\.") + ".*fails to load"):
            im.read_image_rgb(str(path))


def test_the_format_fixtures_equal_their_recorded_pillow_decodes():
    """tests/fixtures/torch_image_formats (what the card's phase 55 reads)
    against decodes.npz, and Pillow's decodes still those."""
    here = os.path.join(os.path.dirname(__file__), "fixtures", "torch_image_formats")
    npz = np.load(os.path.join(here, "decodes.npz"))
    names = sorted(f for f in os.listdir(here) if not f.startswith(("decodes", "make_")))
    assert len(names) >= 20
    for name in names:
        got = im.read_image_rgb(os.path.join(here, name))
        key = os.path.splitext(name)[0]
        np.testing.assert_array_equal(got, npz[key], err_msg=name)
        with open(os.path.join(here, name), "rb") as f:
            np.testing.assert_array_equal(_pillow(f.read()), npz[key], err_msg=name)


# ---------------------------------------------------------------------------
# corrupt TIFF and SGI data (ROADMAP C.12 and C.13)
# ---------------------------------------------------------------------------

CORRUPT = os.path.join(os.path.dirname(__file__), "fixtures", "torch_image_corrupt")


def _corrupt_outcomes():
    import json

    with open(os.path.join(CORRUPT, "outcomes.json")) as f:
        rec = json.load(f)
    return {k: v for k, v in rec.items() if k not in ("pillow_version", "jpeg2000")}


@pytest.mark.parametrize("name", sorted(k for k, v in _corrupt_outcomes().items() if not v["c13"]))
def test_corrupt_tiff_and_sgi_decode_or_fail_as_libtiff_and_pillow(name):
    """The fuzzed files the readers once disagreed on (libtiff's LZW that
    must begin with a clear code, its deflate and LZW errors that its RGBA
    interface goes past for YCbCr, its own reading of the IFD and Pillow's
    raw mode held to it, the strips fewer than the image needs, strip
    offsets before tile offsets, planar RGBA's alpha divided out by
    libtiff's ExtraSamples, SGI rows of 2^31 or more packets, JPEGTables
    read as a stream of their own, what a single-scan JPEG strip fails after
    its rows ignored as libtiff ignores it): each decodes
    to Pillow's recorded image or fails where Pillow failed, and Pillow
    still does so."""
    import hashlib

    want = _corrupt_outcomes()[name]["pillow"]
    path = os.path.join(CORRUPT, name)
    with open(path, "rb") as f:
        data = f.read()
    pil = _pillow(data)
    assert (pil is None) == (want == "fails")
    if want == "fails":
        with pytest.raises(ValueError, match=name.replace(".", r"\.")):
            im.read_image_rgb(path)
        return
    got = im.read_image_rgb(path)
    assert hashlib.sha256(got.tobytes()).hexdigest() == want
    np.testing.assert_array_equal(got, pil)


def test_what_stays_apart_is_c13():
    """ROADMAP C.13, closed: of what stayed apart, the JPEG 2000 codestream
    whose third component's YRsiz is 230 (a 3-component image whose first
    subsampled component is the third, which Pillow unpacks as sYCC)
    decodes to Pillow's recorded image, and Pillow still decodes it so. The
    three JPEG-in-TIFF files are cases of the test above."""
    import hashlib
    import json

    with open(os.path.join(CORRUPT, "outcomes.json")) as f:
        rec = json.load(f)["jpeg2000"]
    assert len(rec) == 1
    for name, want in rec.items():
        path = os.path.join(CORRUPT, name)
        with open(path, "rb") as f:
            pil = _pillow(f.read())
        got = im.read_image_rgb(path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == want, name
        np.testing.assert_array_equal(got, pil)


def test_fuzzed_pngs_fail_where_pillow_fails():
    """PNG's corrupt data (found apart beside C.12): 600 fuzzed files of
    palette, RGBA, gray+alpha, bilevel, 16-bit, text-chunk and multi-IDAT
    PNGs decode as Pillow decodes them or fail where it fails (a bad CRC
    before the first IDAT, a cut chunk after the image, a stream that ends
    before the image does; one whose rest or checksum is bad, past what the
    image needs, decodes)."""
    import zlib

    from PIL import PngImagePlugin

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    img = PIL.Image.fromarray(SMALL)
    info = PngImagePlugin.PngInfo()
    info.add_text("k", "text")
    stream = zlib.compress(b"".join(b"\0" + r.tobytes() for r in SMALL))
    forms = [_pillow_saved(x, "PNG", **o) for x, o in (
        (img.quantize(20), {}), (img.convert("RGBA"), {}), (img.convert("LA"), {}),
        (img.convert("1"), {}), (PIL.Image.fromarray(SMALL[..., 0].astype(np.uint16) * 250), {}),
        (img, {"pnginfo": info}))]
    forms.append(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 41, 29, 8, 2, 0,
                                                                    0, 0))
                 + b"".join(chunk(b"IDAT", stream[i:i + 300]) for i in range(0, len(stream), 300))
                 + chunk(b"tEXt", b"k\0v") + chunk(b"IEND", b""))
    rng = np.random.RandomState(25)
    counts = [0, 0]
    for k in range(600):
        d = bytearray(forms[rng.randint(len(forms))])
        op, at = rng.randint(4), rng.randint(0, len(d))
        if op == 0:
            for _ in range(rng.randint(1, 4)):
                d[rng.randint(0, len(d))] = rng.randint(256)
        elif op == 1:
            d[at:at] = bytes(rng.randint(0, 256, rng.randint(1, 8)).astype(np.uint8))
        elif op == 2:
            del d[at:at + rng.randint(1, 8)]
        else:
            d = d[:at]
        want = _pillow(bytes(d))
        try:
            got = im.png_decode_rgb(bytes(d))
        except (ValueError, zlib.error, struct.error):
            got = None
        assert (got is None) == (want is None), k
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=str(k))
        counts[want is not None] += 1
    assert min(counts) >= 20, counts


# ---------------------------------------------------------------------------
# C.17: Pillow maps a raw image it opens by its path
# ---------------------------------------------------------------------------

def _set_long(data: bytes, tag: int, value: int) -> bytes:
    """A classic little-endian TIFF with one SHORT or LONG tag's value set."""
    d = bytearray(data)
    ifd = struct.unpack("<I", d[4:8])[0]
    for e in range(struct.unpack("<H", d[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * e
        if struct.unpack("<H", d[at:at + 2])[0] == tag:
            typ = struct.unpack("<H", d[at + 2:at + 4])[0]
            d[at + 8:at + 12] = struct.pack("<HH" if typ == 3 else "<I",
                                            *((value, 0) if typ == 3 else (value,)))
    return bytes(d)


def _mcidas(h: int, w: int, size: int, prefix: int, bands: int, body: bytes) -> bytes:
    words = [0] * 64
    words[1] = 4
    words[8], words[9], words[10], words[13], words[14], words[33] = h, w, size, bands, prefix, 256
    return struct.pack(">64i", *words) + body


def _map_cases() -> dict:
    """{name: (file, whether Pillow reads it otherwise from memory)}: raw
    images whose raw mode is their mode, whose map by path reads otherwise
    than the raw decoder: rows of a stride shorter than the mode's (a 4-bit
    BMP whose grayscale table makes it L, a McIdas area of a short or
    negative stride), one TIFF strip that covers fewer rows than the image
    (the map reads the whole image from the file, or fails where the file
    is too short for it) in each mode Pillow maps; and a tile wider than
    the image, which both read alike."""
    rng = np.random.RandomState(17)
    out = {}
    v = rng.randint(0, 16, (9, 40))
    gray = np.stack([np.arange(16)] * 3, -1)  # the identity table: Pillow takes it as L
    out["bmp_4bit_gray_table"] = bmp(40, 9, 4, bmp_rows(v, 4, 40), pal=gray)
    out["bmp_4bit_gray_table_top_down"] = bmp(40, 9, 4, bmp_rows(v, 4, 40), pal=gray,
                                              topdown=True)
    body = bytes(rng.randint(0, 256, 9 * 40).astype(np.uint8))
    out["mcidas_short_stride"] = _mcidas(9, 40, 1, 3, 0, body)
    out["mcidas_negative_stride"] = _mcidas(9, 20, 2, -2, 0, body)
    cmap = rng.randint(0, 65536, 768)
    six = rng.randint(0, 256, (3, 11, 6))
    for name, (img, bits, photo, kw) in {
            "l": (six[..., :1], 8, 1, {}), "p": (six[..., :1], 8, 3, {"cmap": cmap}),
            "cmyk": (six[..., :4], 8, 5, {}), "rgba": (six[..., :4], 8, 2, {"extra": (2,)}),
            "i16": (six[..., :1] * 251, 16, 1, {})}.items():
        one = tiff(img, bits, photo, "<", 1, **kw)  # one strip of 3 rows
        out[f"tiff_{name}_one_strip_of_fewer_rows"] = _set_long(one, 257, 5)
        out[f"tiff_{name}_one_strip_file_too_short"] = _set_long(one, 257, 300)
    wide = tiff(six[..., :1], 8, 1, "<", 1, tile=(16, 16))
    out["tiff_l_tile_wider_than_the_image"] = wide
    return out


MAP_CASES = _map_cases()


def _pillow_from_memory(data):
    return _pillow_open(io.BytesIO(data))


@pytest.mark.parametrize("name", sorted(MAP_CASES))
def test_a_raw_image_opened_by_its_path_reads_as_pillow_maps_it(tmp_path, name):
    """ROADMAP C.17: where Pillow maps the file (one raw tile whose raw
    mode is the image's mode), the port reads it as Pillow does from its
    path, which here differs from Pillow's decode from memory (but for the
    wide tile, which both read alike)."""
    data = MAP_CASES[name]
    by_path, from_memory = _pillow(data), _pillow_from_memory(data)
    alike = (by_path is None) == (from_memory is None) and (
        by_path is None or np.array_equal(by_path, from_memory))
    assert alike == name.endswith("wider_than_the_image"), name
    _check(tmp_path, name.replace("_", "-") + {"b": ".bmp", "m": ".area", "t": ".tif"}[name[0]],
           data)
