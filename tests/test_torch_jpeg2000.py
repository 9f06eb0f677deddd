"""JPEG 2000 (J2K codestreams and JP2 files) and ICNS in the port's image
reader (latent2im_tpu_torch/utils/jpeg2000.py, icns.py through
utils/image.py:read_image_rgb), bit for bit against Pillow 12.1 over
OpenJPEG 2.5.4 (``Image.open(p).convert("RGB")``): files Pillow writes
(reversible and irreversible, tiles, layers, progression orders, precincts),
and the same codestreams rewritten where Pillow cannot write the form
(every code-block style, RGN, POC, COC/QCC, PPT/PPM, SOP/EPH, other
precisions, subsampled components, JP2 boxes); the tier-1 C++ twin
(ops/csrc/jpeg2000_t1.cpp, built here with the host's C++ compiler) equal
to the Python tier-1 with equal error texts; fuzzed files failing where
Pillow fails."""

import ctypes
import hashlib
import io
import json
import os
import shutil
import struct
import subprocess
import warnings

import numpy as np
import PIL.Image
import pytest

from image_format_encoders import (icns_file, icns_rle, j2k_main_header, j2k_merge, j2k_repack,
                                   j2k_with, jp2_box, jp2_file)
from latent2im_tpu_torch.ops import _build
from latent2im_tpu_torch.utils import image as im
from latent2im_tpu_torch.utils import jpeg2000 as j2k
from latent2im_tpu_torch.utils.icns import icns_decode_rgb
from latent2im_tpu_torch.utils.modes import ycbcr_rgb

HERE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_image_textures")
_Y, _X = np.mgrid[0:37, 0:53]
PHOTO = np.clip(np.stack([_X * 4, _Y * 6, (_X + _Y) * 3], -1)
                + np.random.RandomState(20).randint(-30, 30, (37, 53, 3)), 0, 255).astype(np.uint8)
IMG = PIL.Image.fromarray(PHOTO)


def _pillow(data):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception:
            return None


def _port(data, host_cpp=False):
    """The decode, or the error's text."""
    try:
        return j2k.jpeg2000_decode_rgb(data, host_cpp=host_cpp)
    except ValueError as e:
        return str(e)


def _agrees(data) -> tuple:
    """-> (the port agrees with Pillow, Pillow read it)."""
    want, got = _pillow(data), _port(data)
    if want is None:
        return isinstance(got, str), False
    return (not isinstance(got, str) and got.shape == want.shape
            and bool((got == want).all())), True


def _saved(img, **opts):
    buf = io.BytesIO()
    img.save(buf, "JPEG2000", **opts)
    return buf.getvalue()


@pytest.fixture(scope="module")
def t1_library(tmp_path_factory):
    """ops/csrc/jpeg2000_t1.cpp built by the host's C++ compiler, standing
    in for the kernel library."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build ops/csrc/jpeg2000_t1.cpp with")
    out = str(tmp_path_factory.mktemp("j2k") / "libj2k.so")
    subprocess.run([cxx, "-std=c++17", "-O2", "-fPIC", "-shared", "-o", out,
                    os.path.join(_build.CSRC, "jpeg2000_t1.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    lib.l2i_j2k_t1.argtypes = list(_build.SIGNATURES["l2i_j2k_t1"])
    lib.l2i_j2k_t1.restype = ctypes.c_int
    return lib


@pytest.fixture
def cpp(monkeypatch, t1_library):
    monkeypatch.setattr(_build, "library", lambda: t1_library)


# ---------------------------------------------------------------------------
# the forms
# ---------------------------------------------------------------------------

def _pillow_written() -> dict:
    gray = IMG.convert("L")
    out = {
        "rev": _saved(IMG, no_jp2=True), "rev_jp2": _saved(IMG),
        "irr": _saved(IMG, no_jp2=True, irreversible=True), "irr_jp2": _saved(IMG, irreversible=True),
        "gray": _saved(gray, no_jp2=True), "gray_irr": _saved(gray, irreversible=True),
        "rgba": _saved(IMG.convert("RGBA"), no_jp2=True), "la": _saved(IMG.convert("LA")),
        "i16": _saved(PIL.Image.fromarray(PHOTO[..., 0].astype(np.uint16) * 200), no_jp2=True),
        "signed": _saved(gray, no_jp2=True, signed=True),
        "tiles": _saved(IMG, no_jp2=True, tile_size=(16, 16)),
        "tiles_offset": _saved(IMG, no_jp2=True, tile_size=(24, 24), tile_offset=(3, 5),
                               offset=(3, 5), progression="CPRL", precinct_size=(64, 32)),
        "layers_rates": _saved(IMG, no_jp2=True, quality_mode="rates", quality_layers=[40, 10, 1]),
        "layers_db_tiles_irr": _saved(IMG, irreversible=True, tile_size=(16, 24),
                                      quality_mode="dB", quality_layers=[30, 40, 50]),
        "rlcp_layers": _saved(IMG, no_jp2=True, progression="RLCP", quality_mode="rates",
                              quality_layers=[30, 5]),
        "plt": _saved(IMG, no_jp2=True, plt=True), "no_mct_irr": _saved(IMG, no_jp2=True, mct=0,
                                                                       irreversible=True),
        "one_resolution": _saved(IMG, no_jp2=True, num_resolutions=1),
        "six_resolutions_irr": _saved(IMG, no_jp2=True, num_resolutions=6, irreversible=True),
        "codeblocks_8x8": _saved(IMG, no_jp2=True, codeblock_size=(8, 8), num_resolutions=3),
    }
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        out[f"{prog}_precincts_layers"] = _saved(IMG, no_jp2=True, progression=prog,
                                                 precinct_size=(64, 64), num_resolutions=3,
                                                 quality_mode="rates", quality_layers=[20, 4])
        out[f"{prog}_tiles_irr"] = _saved(IMG, no_jp2=True, progression=prog, tile_size=(20, 24),
                                          quality_mode="rates", quality_layers=[20, 4],
                                          irreversible=True)
    out["precincts_16_pillow_fails"] = _saved(IMG, no_jp2=True, progression="RPCL",
                                              precinct_size=(16, 16))
    return out


PILLOW_WRITTEN = _pillow_written()


def _rewritten() -> dict:
    """Codestreams Pillow cannot write, rewritten from those it writes."""
    base = {k: PILLOW_WRITTEN[k] for k in ("rev", "irr", "gray")}
    out = {}
    for k, cs in base.items():
        segs, siz, _ = j2k_main_header(cs)
        cod, qcd = dict(segs)[0xFF52], dict(segs)[0xFF5C]
        for shift in (1, 3, 7):
            out[f"{k}_rgn{shift}"] = j2k_with(cs, [(0xFF5E, bytes([0, 0, shift]))])
        out[f"{k}_com_tlm_plm"] = j2k_with(cs, [(0xFF64, b"\0\x01port"), (0xFF55, b"\0\0"),
                                               (0xFF57, b"\0")])
        out[f"{k}_coc_qcc"] = j2k_with(cs, [(0xFF53, bytes([0, cod[0] & 1]) + cod[5:]),
                                           (0xFF5D, bytes([0]) + qcd)])
        ncomp = struct.unpack(">H", siz[34:36])[0]
        for prec in (1, 5, 10, 12, 16):
            for signed in (0, 0x80):
                ns = bytearray(siz)
                for c in range(ncomp):
                    ns[36 + 3 * c] = (prec - 1) | (signed if c == 0 else 0)
                out[f"{k}_prec{prec}_{'s' if signed else 'u'}"] = j2k_with(cs, siz=bytes(ns))
    for k in ("rev", "layers_rates", "tiles", "irr"):
        for sop in (False, True):
            for eph in (False, True):
                for hd in ("", "ppt", "ppm"):
                    out[f"{k}_sop{int(sop)}_eph{int(eph)}_{hd or 'inline'}"] = j2k_repack(
                        PILLOW_WRITTEN[k], sop, eph, hd)
    eph = out["layers_rates_sop1_eph1_ppt"]
    at = eph.index(b"\xff\x92")
    out["layers_rates_eph_missing"] = eph[:at] + b"\xff\x00" + eph[at + 2:]
    cs = PILLOW_WRITTEN["rev"]
    out["rev_no_eoc"] = cs[:-2]
    out["rev_junk_after_tile"] = cs[:-2] + b"\xff\x64\0\x04ab\xff\xd9"
    out["rev_bare_sot_after_tile"] = cs[:-2] + b"\xff\x90"
    rpcl = _saved(IMG, no_jp2=True, progression="RPCL", num_resolutions=4)
    poc = lambda *e: (0xFF5F, b"".join(bytes([r0, c0]) + struct.pack(">H", ly) + bytes([r1, c1, p])  # noqa: E731
                                       for r0, c0, ly, r1, c1, p in e))
    out["rpcl_poc_split"] = j2k_with(rpcl, [poc((0, 0, 1, 2, 3, 2), (2, 0, 1, 4, 3, 2))])
    out["rpcl_poc_lrcp"] = j2k_with(rpcl, [poc((0, 0, 1, 4, 3, 0))])
    gray = IMG.convert("L")
    s0 = _saved(gray, no_jp2=True, num_resolutions=3)
    s1 = _saved(gray.resize((27, 19)), no_jp2=True, num_resolutions=3)
    out["merge_420"] = j2k_merge([s0, s1, s1], [1, 2, 2], [1, 2, 2])
    s2 = _saved(gray.resize((27, 37)), no_jp2=True, num_resolutions=3)
    out["merge_422"] = j2k_merge([s0, s2, s2], [1, 2, 2], [1, 1, 1])
    out["merge_444"] = j2k_merge([s0, s0, s0], [1, 1, 1], [1, 1, 1])
    out["merge_la"] = j2k_merge([s0, s0], [1, 1], [1, 1])
    out["merge_la_subsampled"] = j2k_merge([s0, s1], [1, 2], [1, 2])
    even = IMG.crop((0, 0, 52, 36)).convert("L")
    e0 = _saved(even, no_jp2=True, num_resolutions=3)
    e1 = _saved(even.resize((26, 18)), no_jp2=True, num_resolutions=3)
    out["merge_420_even"] = j2k_merge([e0, e1, e1], [1, 2, 2], [1, 2, 2])
    return out


def _jp2_boxes() -> dict:
    out = {}
    rw = _rewritten()
    colrs = {"none": b"", "srgb": 16, "gray": 17, "sycc": 18, "cmyk": 12, "eycc": 24,
             "other": 99, "icc": b"\x02\0\0" + bytes(20)}
    for name, cs, nc in (("rgb", PILLOW_WRITTEN["rev"], 3), ("444", rw["merge_444"], 3),
                         ("420", rw["merge_420_even"], 3), ("gray", PILLOW_WRITTEN["gray"], 1),
                         ("la", rw["merge_la"], 2), ("rgba", PILLOW_WRITTEN["rgba"], 4)):
        w, h = (52, 36) if name == "420" else (53, 37)
        for cname, colr in colrs.items():
            if isinstance(colr, int):
                colr = b"\x01\0\0" + struct.pack(">I", colr)
            out[f"{name}_{cname}"] = jp2_file(cs, w, h, nc, colr=colr)
    pal = bytes(np.random.RandomState(21).randint(0, 256, 120).astype(np.uint8))
    pal = pal[:30] + pal[:30] + pal[60:]  # repeated colours: Pillow's palette drops them
    pclr = jp2_box(b"pclr", struct.pack(">HB", 40, 3) + b"\x07\x07\x07" + pal)
    cmap = jp2_box(b"cmap", b"\0\0\x01\0\0\0\x01\x01\0\0\x01\x02")
    srgb, gray = b"\x01\0\0" + struct.pack(">I", 16), b"\x01\0\0" + struct.pack(">I", 17)
    out["pclr_srgb"] = jp2_file(PILLOW_WRITTEN["gray"], 53, 37, 1, colr=srgb, extra=pclr + cmap)
    out["pclr_gray"] = jp2_file(PILLOW_WRITTEN["gray"], 53, 37, 1, colr=gray, extra=pclr + cmap)
    cdef = struct.pack(">13H", 4, 0, 0, 1, 1, 0, 2, 2, 0, 3, 3, 1, 0)
    out["cdef"] = jp2_file(PILLOW_WRITTEN["rgba"], 53, 37, 4, colr=srgb,
                           extra=jp2_box(b"cdef", cdef))
    out["cdef_cut"] = jp2_file(PILLOW_WRITTEN["rgba"], 53, 37, 4, colr=srgb,
                               extra=jp2_box(b"cdef", cdef[:-2]))
    out["cdef_incomplete"] = jp2_file(PILLOW_WRITTEN["rgba"], 53, 37, 4, colr=srgb, extra=jp2_box(
        b"cdef", struct.pack(">7H", 2, 0, 0, 1, 1, 0, 2)))
    out["cmap_before_pclr"] = jp2_file(PILLOW_WRITTEN["gray"], 53, 37, 1, colr=srgb,
                                       extra=cmap + pclr)
    out["two_colr"] = jp2_file(PILLOW_WRITTEN["rev"], 53, 37, 3, colr=gray,
                               extra=jp2_box(b"colr", srgb))
    return out


REWRITTEN = _rewritten()
JP2_BOXES = _jp2_boxes()
FORMS = {**{f"pillow_{k}": v for k, v in PILLOW_WRITTEN.items()},
         **{f"rewritten_{k}": v for k, v in REWRITTEN.items()},
         **{f"jp2_{k}": v for k, v in JP2_BOXES.items()}}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_each_form_decodes_or_fails_as_pillow(tmp_path, name):
    path = tmp_path / f"{name}.j2k"
    path.write_bytes(FORMS[name])
    want = _pillow(FORMS[name])
    if want is None:
        with pytest.raises(ValueError, match=f"{name}.j2k"):
            im.read_image_rgb(str(path))
        return
    np.testing.assert_array_equal(im.read_image_rgb(str(path)), want)


def test_the_forms_reach_what_they_should():
    """Pillow reads the forms the port must read, and some it must fail."""
    read = {k for k, v in FORMS.items() if _pillow(v) is not None}
    assert len(read) >= 150 and len(FORMS) - len(read) >= 10
    for k in ("rewritten_merge_420_even", "rewritten_rev_sop1_eph1_ppm", "jp2_420_sycc",
              "jp2_pclr_srgb", "rewritten_rpcl_poc_split", "rewritten_irr_rgn3",
              "pillow_PCRL_precincts_layers", "rewritten_gray_prec12_s"):
        assert k in read, k


def test_every_code_block_style_decodes_or_fails_as_pillow():
    """COD's style byte set to each of its 64 values over a one-layer and a
    three-layer codestream: bypass (raw passes), reset, termall, vertically
    causal contexts, predictable termination and segmentation symbols."""
    read = 0
    for base in (PILLOW_WRITTEN["rev"], PILLOW_WRITTEN["layers_rates"]):
        cod = bytearray(dict(j2k_main_header(base)[0])[0xFF52])
        for sty in range(64):
            cod[8] = sty
            agrees, ok = _agrees(j2k_with(base, cod=bytes(cod)))
            assert agrees, sty
            read += ok
    assert 64 < read < 128


def test_cpp_tier1_equals_python(cpp):
    """The C++ twin on every fourth form and every third style: equal
    images, equal errors."""
    datas = [FORMS[k] for k in sorted(FORMS)[::4]]
    cod = bytearray(dict(j2k_main_header(PILLOW_WRITTEN["rev"])[0])[0xFF52])
    for sty in range(0, 64, 3):
        cod[8] = sty
        datas.append(j2k_with(PILLOW_WRITTEN["rev"], cod=bytes(cod)))
    for data in datas:
        a, b = _port(data), _port(data, host_cpp=True)
        if isinstance(a, str) or isinstance(b, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


def test_ycbcr_to_rgb_is_pillows():
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(256), indexing="ij"), -1)
    for y in (0, 1, 77, 128, 200, 255):
        arr = np.concatenate([np.full((256, 256, 1), y), grid], -1).astype(np.uint8)
        want = np.asarray(PIL.Image.fromarray(arr, "YCbCr").convert("RGB"))
        np.testing.assert_array_equal(ycbcr_rgb(arr[..., 0], arr[..., 1], arr[..., 2]), want)


# ---------------------------------------------------------------------------
# ICNS
# ---------------------------------------------------------------------------

def _icns_forms() -> dict:
    rng = np.random.RandomState(22)

    def ph(n):
        y, x = np.mgrid[0:n, 0:n]
        return np.clip(np.stack([x * 255 // n, y * 255 // n, (x + y) * 127 // n], -1)
                       + rng.randint(-20, 21, (n, n, 3)), 0, 255).astype(np.uint8)

    p16, p32, p48, p128 = ph(16), ph(32), ph(48), ph(128)
    p128[40:90, 30:100] = 200
    png = lambda a: (lambda b: (PIL.Image.fromarray(a).save(b, "PNG"), b.getvalue())[1])(io.BytesIO())  # noqa: E731
    out = {
        "is32_rle_mask": icns_file([(b"is32", icns_rle(p16.transpose(2, 0, 1))),
                                    (b"s8mk", bytes(256))]),
        "il32_raw": icns_file([(b"il32", p32.transpose(2, 0, 1).tobytes()),
                               (b"l8mk", bytes(1024))]),
        "ih32_rle": icns_file([(b"ih32", icns_rle(p48.transpose(2, 0, 1)))]),
        "it32_rle_mask": icns_file([(b"it32", b"\0\0\0\0" + icns_rle(p128.transpose(2, 0, 1))),
                                    (b"t8mk", bytes(128 * 128)),
                                    (b"is32", icns_rle(p16.transpose(2, 0, 1)))]),
        "it32_bad_signature": icns_file([(b"it32", b"\0\0\0\x01" + icns_rle(
            p128.transpose(2, 0, 1)))]),
        "png_ic07": icns_file([(b"ic07", png(p128)), (b"is32", icns_rle(p16.transpose(2, 0, 1)))]),
        "png_palette_icp4": icns_file([(b"icp4", (lambda b: (PIL.Image.fromarray(p16).quantize(
            20).save(b, "PNG"), b.getvalue())[1])(io.BytesIO()))]),
        "jp2_ic08": icns_file([(b"ic08", _saved(PIL.Image.fromarray(ph(256)),
                                                quality_mode="rates", quality_layers=[8]))]),
        "j2k_irr_ic07": icns_file([(b"ic07", _saved(PIL.Image.fromarray(p128), no_jp2=True,
                                                    irreversible=True))]),
        "j2k_of_another_size": icns_file([(b"ic07", _saved(PIL.Image.fromarray(p32),
                                                           no_jp2=True))]),
        "rle_cut": icns_file([(b"is32", icns_rle(p16.transpose(2, 0, 1))[:-5])]),
        "mask_alone": icns_file([(b"s8mk", bytes(256))]),
        "unknown_member": icns_file([(b"ic09", b"GIF89a" + bytes(40))]),
    }
    return out


ICNS = _icns_forms()


@pytest.mark.parametrize("name", sorted(ICNS))
def test_icns_decodes_or_fails_as_pillow(tmp_path, name):
    path = tmp_path / f"{name}.icns"
    path.write_bytes(ICNS[name])
    want = _pillow(ICNS[name])
    if want is None:
        with pytest.raises(ValueError, match=f"{name}.icns"):
            im.read_image_rgb(str(path))
        return
    np.testing.assert_array_equal(im.read_image_rgb(str(path)), want)


def test_icns_cpp_equals_python(cpp, tmp_path):
    for name, data in ICNS.items():
        path = tmp_path / f"{name}.icns"
        path.write_bytes(data)
        out = []
        for host_cpp in (False, True):
            try:
                out.append(im.read_image_rgb(str(path), host_cpp=host_cpp))
            except ValueError as e:
                out.append(str(e))
        if isinstance(out[0], str) or isinstance(out[1], str):
            assert out[0] == out[1], name
        else:
            np.testing.assert_array_equal(out[0], out[1], err_msg=name)


# ---------------------------------------------------------------------------
# corrupt data
# ---------------------------------------------------------------------------

def _fuzzed(data: bytes, rng) -> bytes:
    d = bytearray(data)
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
    return bytes(d)


FUZZ_BASES = ("pillow_rev", "pillow_irr_jp2", "pillow_layers_rates", "pillow_tiles",
              "pillow_gray", "rewritten_layers_rates_sop1_eph1_ppt",
              "rewritten_tiles_sop0_eph0_ppm", "rewritten_merge_420", "rewritten_rev_rgn3",
              "rewritten_rpcl_poc_split")


def test_fuzzed_codestreams_fail_where_pillow_fails():
    """200 fuzzed J2K and JP2 files (packed headers, SOP and EPH, POC, ROI
    and subsampled components among them): the port fails exactly where
    Pillow fails and decodes the rest as Pillow does."""
    rng = np.random.RandomState(23)
    read = 0
    for k in range(200):
        data = _fuzzed(FORMS[FUZZ_BASES[rng.randint(len(FUZZ_BASES))]], rng)
        agrees, ok = _agrees(data)
        assert agrees, k
        read += ok
    assert 20 < read < 180


def test_fuzzed_icns_fail_where_pillow_fails():
    """150 fuzzed ICNS files of the RLE, raw and JPEG 2000 members (a PNG
    member's corrupt data is the PNG reader's, fuzzed in
    tests/test_torch_image_formats.py)."""
    rng = np.random.RandomState(24)
    names = [k for k in sorted(ICNS) if "png" not in k and k != "jp2_ic08"]
    read = 0
    for k in range(150):
        data = _fuzzed(ICNS[names[rng.randint(len(names))]], rng)
        want = _pillow(data)
        try:
            got = icns_decode_rgb(data)
        except ValueError:  # NotThisKind too: Pillow tries other formats, and fails
            got = None
        assert (want is None) == (got is None), k
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=str(k))
            read += 1
    assert 10 < read < 140


# ---------------------------------------------------------------------------
# the recorded fixtures (what the card checks)
# ---------------------------------------------------------------------------

def test_the_jpeg2000_photo_fixtures_equal_their_recorded_decodes(cpp):
    """tests/fixtures/torch_image_textures' JPEG 2000 photos against their
    recorded digests: the 256 px reversible one through both tiers-1, the
    others through the C++ (the Python tier-1 takes seconds a photo; the
    forms above hold it to the C++ on the irreversible path)."""
    meta = json.load(open(os.path.join(HERE, "decodes.json")))
    for name, routes in (("photo_256_rev.jp2", (False, True)),
                         ("photo_256_irr.j2k", (True,)),
                         ("photo_1024_irr.jp2", (True,))):
        for host_cpp in routes:
            got = im.read_image_rgb(os.path.join(HERE, name), host_cpp=host_cpp)
            digest = hashlib.sha256(np.ascontiguousarray(got).tobytes()).hexdigest()
            assert digest == meta[os.path.splitext(name)[0]]["sha256"], (name, host_cpp)
