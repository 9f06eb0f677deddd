"""GIF, BMP and TIFF in the port's image reader (latent2im_tpu_torch/utils/
gif.py, bmp.py, tiff.py through utils/image.py:read_image_rgb), bit for bit
against Pillow 12.1's ``Image.open(p).convert("RGB")`` on files written
here, by Pillow where it writes the form and by tests/image_format_encoders.py
where it does not; where Pillow fails a file, the port fails it, naming it;
a TIFF form Pillow reads and the port does not names ROADMAP item 28."""

import io
import os
import struct
import warnings

import numpy as np
import PIL.Image
import pytest

from image_format_encoders import bmp, bmp_rle, bmp_rows, gif, tiff
from latent2im_tpu_torch.utils import image as im

RNG = np.random.RandomState(17)
PHOTO = RNG.randint(0, 256, (37, 53, 3)).astype(np.uint8)


def _pillow(data):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))
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
    cmyk = _pillow_saved(PIL.Image.fromarray(PHOTO).convert("CMYK"), "TIFF")
    i16 = _pillow_saved(PIL.Image.fromarray((PHOTO[..., 0].astype(np.uint16) * 257)), "TIFF")
    for name, data in (("cmyk.tif", cmyk), ("i16.tif", i16)):
        assert _pillow(data) is not None
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(ValueError, match=name.replace(".", r"\.") + ".*item 28"):
            im.read_image_rgb(str(path))


def test_other_kinds_still_name_item_28(tmp_path):
    path = tmp_path / "a.ppm"
    PIL.Image.fromarray(PHOTO).save(path, "PPM")
    with pytest.raises(ValueError, match=r"a\.ppm.*PPM.*item 28"):
        im.read_image_rgb(str(path))


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
