"""The image kinds the port's reader added for parity with Pillow
(latent2im_tpu_torch/utils/image.py, utils/jpeg.py and its host C++ twin
ops/csrc/jpeg_huffman.cpp), on the CPU, bit for bit against Pillow 12.1's
``Image.open(p).convert("RGB")``:

- PNG: 16-bit at every colour type, with and without tRNS (Pillow clips
  16-bit gray at 255 and keeps the high byte of the rest), and Adam7 at
  every legal colour type and depth, each pass with its own filtered rows;
- arithmetic-coded JPEG (SOF9, SOF10), re-coded here from Pillow's Huffman
  files by tests/jpeg_arith_encoder.py: grayscale, 4:2:0 and 4:4:4,
  sequential and progressive, with restart intervals and a non-default
  DAC, through the Python decoder and the C++ one; one larger than
  Pillow's 64 KiB read fails in both, as libjpeg cannot suspend inside an
  arithmetic-coded scan; truncated and corrupted files fail wherever
  Pillow fails;
- lossless JPEG (SOF3), written here by tests/jpeg_lossless_encoder.py:
  every predictor, point transforms, restart intervals, grayscale, RGB
  (4:4:4, 4:2:2 and 4:2:0, one scan or one a component) and CMYK, on both
  routes; a YCbCr or YCCK lossless file fails as Pillow fails it
  (libjpeg-turbo converts no colour in lossless mode), and so do truncated
  and corrupted files;
- the committed fixtures of chip_smoke.py phase 53 against their recorded
  Pillow decodes;
- the inversion CLI's ``load_images`` on a folder mixing PNG (8- and
  16-bit, interlaced), JPEG (Huffman and arithmetic) and WEBP, and the
  regressor trainer's batches of them, against the JAX package's.
"""

import glob
import hashlib
import importlib.util
import io
import json
import os
import tempfile

import numpy as np
import PIL.Image
import pytest

from jpeg_arith_encoder import arith_jpeg
from jpeg_lossless_encoder import lossless_jpeg
from test_torch_loader import host_library, native  # noqa: F401 (the C++ twin)

from latent2im_tpu.cli import train_regressor as jtr
from latent2im_tpu.cli.bp import load_images as jax_load_images
from latent2im_tpu_torch.cli import train_regressor as tr
from latent2im_tpu_torch.cli.bp import load_images
from latent2im_tpu_torch.utils import image as im
from latent2im_tpu_torch.utils import jpeg

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "torch_image_kinds")
_spec = importlib.util.spec_from_file_location(
    "torch_image_kinds_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
kinds = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kinds)
photo = kinds.photo
IMAGES = sorted(p for p in glob.glob(os.path.join(FIXTURES, "*.*"))
                if p.endswith((".png", ".jpg", ".webp", ".gif", ".bmp", ".tif")))


def _pillow(data: bytes):
    """Pillow's decode of the file opened by its path, as the JAX package
    opens every image (ImageFile.load maps some raw images: ROADMAP C.17)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "image")
        with open(path, "wb") as f:
            f.write(data)
        try:
            with PIL.Image.open(path) as img:
                return np.asarray(img.convert("RGB"))
        except Exception:  # Pillow's errors are OSError, SyntaxError, ValueError...
            return None


# ---------------------------------------------------------------------------
# PNG (ROADMAP C.10)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("color", [0, 2, 4, 6])
def test_16_bit_png_decodes_as_pillow(color):
    for h, w, seed in ((19, 23, 1), (1, 1, 2), (7, 40, 3)):
        vals = kinds.samples(h, w, color, 16, seed + color)
        vals[0, 0] = 1000  # gray 1000: Pillow's I;16 clips it to 255, not >> 8
        for trns in (None, b"\x03\xe8" * (3 if color == 2 else 1)):
            if trns is not None and color in (4, 6):
                continue  # tRNS is not legal with an alpha channel
            data = kinds.png(vals, 16, color, trns=trns)
            want = _pillow(data)
            np.testing.assert_array_equal(im.png_decode_rgb(data), want)


@pytest.mark.parametrize("color,depth", [(c, d) for c, ds in im._PNG_COLOR.items()
                                         for d in ds[1]])
def test_adam7_png_decodes_as_pillow(color, depth):
    pal = photo(16, 16, 3).reshape(-1, 3)
    for h, w in ((1, 1), (3, 2), (9, 13), (17, 11)):
        vals = kinds.samples(h, w, color, depth, depth * 10 + color + h)
        if color == 3:
            vals = vals % min(256, len(pal))
        trns = b"\x00\x80" if color == 3 else None
        data = kinds.png(vals, depth, color, interlace=1,
                         plte=pal if color == 3 else None, trns=trns)
        np.testing.assert_array_equal(im.png_decode_rgb(data), _pillow(data))


# ---------------------------------------------------------------------------
# arithmetic-coded JPEG
# ---------------------------------------------------------------------------

ARITH = {  # name: (mode, save options)
    "gray": ("L", {"quality": 85}),
    "420": ("RGB", {"quality": 80, "subsampling": 2}),
    "444": ("RGB", {"quality": 90, "subsampling": 0}),
}
ARITH_CODINGS = [(p, r, d) for p in (False, True) for r, d in ((0, None), (2, {0: 0x52, 1: 0x63,
                                                                               16: 2, 17: 9}))]


def _huffman(mode, opts, h=45, w=61, seed=5) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(photo(h, w, seed)).convert(mode).save(buf, "JPEG", **opts)
    return buf.getvalue()


@pytest.mark.parametrize("layout", sorted(ARITH))
def test_arithmetic_jpeg_decodes_as_pillow_on_both_routes(layout, native):  # noqa: F811
    mode, opts = ARITH[layout]
    for h, w in ((45, 61), (8, 8), (17, 33)):
        src = _huffman(mode, opts, h, w, h + w)
        for progressive, restart, dac in ARITH_CODINGS:
            data = arith_jpeg(src, progressive=progressive, restart=restart, dac=dac)
            assert bytes([0xFF, 0xCA if progressive else 0xC9]) in data
            want = _pillow(data)
            assert want is not None
            for route in (False, True):
                np.testing.assert_array_equal(jpeg.jpeg_decode_rgb(data, host_cpp=route), want)


def test_arithmetic_jpeg_past_pillows_read_fails_in_both(native):  # noqa: F811
    """Pillow hands libjpeg 64 KiB at a time, and libjpeg cannot suspend
    inside arithmetic-coded data: a larger file fails in Pillow, and here."""
    noise = np.random.RandomState(6).randint(0, 256, (300, 300, 3)).astype(np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(noise).save(buf, "JPEG", quality=95)
    data = arith_jpeg(buf.getvalue())
    assert len(data) > jpeg.PILLOW_BLOCK and _pillow(data) is None
    for route in (False, True):
        with pytest.raises(ValueError, match="65536-byte read"):
            jpeg.jpeg_decode_rgb(data, host_cpp=route)


def test_arithmetic_bad_data_fails_wherever_pillow_fails(native):  # noqa: F811
    """Truncations, flipped and deleted bytes: where Pillow fails both
    routes raise the same ValueError; where it decodes, both routes agree
    (with each other, and with Pillow where the coefficients stay in
    range)."""
    rng = np.random.RandomState(7)
    counts = {"both fail": 0, "decode": 0}
    for progressive in (False, True):
        data = arith_jpeg(_huffman("RGB", {"quality": 80}, 24, 40, 8), progressive=progressive,
                          restart=2)
        bad = [data[:k] for k in range(0, len(data), 9)]
        for _ in range(150):
            d = bytearray(data)
            d[rng.randint(len(d))] = rng.randint(256)
            bad.append(bytes(d))
        for _ in range(40):
            d = bytearray(data)
            i = rng.randint(len(d))
            del d[i:i + rng.randint(1, 4)]
            bad.append(bytes(d))
        for d in bad:
            out = []
            for route in (False, True):
                try:
                    out.append(jpeg.jpeg_decode_rgb(d, host_cpp=route))
                except ValueError as e:
                    out.append(str(e))
            if isinstance(out[0], str) or isinstance(out[1], str):
                assert out[0] == out[1]
            else:
                np.testing.assert_array_equal(out[0], out[1])
            if _pillow(d) is None:
                assert isinstance(out[0], str), "Pillow fails a file the port decodes"
                counts["both fail"] += 1
            elif not isinstance(out[0], str):
                counts["decode"] += 1
    assert counts["both fail"] > 50 and counts["decode"] > 50, counts


# ---------------------------------------------------------------------------
# lossless JPEG (ROADMAP item 26.3)
# ---------------------------------------------------------------------------

def _lossless_cases(h, w, seed):
    img = photo(h, w, seed)
    gray = [img[..., 0]]
    rgb = [img[..., c] for c in range(3)]
    s420 = [img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2]]
    s422 = [img[..., 0], img[:, ::2, 1], img[:, ::2, 2]]
    cases = [(gray, [(1, 1)], {"predictor": p, "pt": pt, "restart_rows": r})
             for p in range(1, 8) for pt, r in ((0, 0), (2, 2))]
    for marker in (None, "adobe-rgb", "jfif"):
        cases.append((rgb, [(1, 1)] * 3, {"marker": marker, "predictor": 5, "restart_rows": 1}))
        for inter in (True, False):
            cases.append((s420, [(2, 2), (1, 1), (1, 1)],
                          {"marker": marker, "interleave": inter, "predictor": 7, "pt": 1}))
            cases.append((s422, [(2, 1), (1, 1), (1, 1)],
                          {"marker": marker, "interleave": inter, "predictor": 4,
                           "restart_rows": 3 if inter else 0}))
    cases.append((rgb + gray, [(1, 1)] * 4, {"marker": None, "interleave": False}))
    return [lossless_jpeg(p, s, width=w, height=h, **kw) for p, s, kw in cases]


@pytest.mark.parametrize("hw", [(13, 17), (1, 1), (20, 9)])
def test_lossless_jpeg_decodes_as_pillow_on_both_routes(hw, native):  # noqa: F811
    counts = {"decode": 0, "fail": 0}
    for data in _lossless_cases(*hw, hw[0] * hw[1]):
        want = _pillow(data)
        for route in (False, True):
            if want is None:  # a lossless YCbCr file: Pillow fails it, and the port
                with pytest.raises(ValueError, match="lossless YCbCr"):
                    jpeg.jpeg_decode_rgb(data, host_cpp=route)
            else:
                np.testing.assert_array_equal(jpeg.jpeg_decode_rgb(data, host_cpp=route), want)
        counts["fail" if want is None else "decode"] += 1
    assert counts == {"decode": 25, "fail": 5}, counts


def test_lossless_bad_data_fails_wherever_pillow_fails(native):  # noqa: F811
    rng = np.random.RandomState(9)
    img = photo(13, 17, 10)
    counts = {"both fail": 0, "decode": 0}
    for data in (lossless_jpeg([img[..., 0]], [(1, 1)], predictor=6, pt=1, restart_rows=2),
                 lossless_jpeg([img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2]],
                               [(2, 2), (1, 1), (1, 1)], marker=None, predictor=7)):
        bad = [data[:k] for k in range(0, len(data), 7)]
        for _ in range(120):
            d = bytearray(data)
            d[rng.randint(len(d))] = rng.randint(256)
            bad.append(bytes(d))
        for d in bad:
            out = []
            for route in (False, True):
                try:
                    out.append(jpeg.jpeg_decode_rgb(d, host_cpp=route))
                except ValueError as e:
                    out.append(str(e))
            if isinstance(out[0], str) or isinstance(out[1], str):
                assert out[0] == out[1]
            else:
                np.testing.assert_array_equal(out[0], out[1])
            want = _pillow(d)
            if want is None:
                assert isinstance(out[0], str), "Pillow fails a file the port decodes"
                counts["both fail"] += 1
            elif not isinstance(out[0], str):
                np.testing.assert_array_equal(out[0], want)
                counts["decode"] += 1
    assert counts["both fail"] > 40 and counts["decode"] > 10, counts


# ---------------------------------------------------------------------------
# block smoothing of a progressive file left unrefined (ROADMAP item 26.4)
# ---------------------------------------------------------------------------

SCANS_KEPT = {  # what is left of Pillow's progressive script (its jpeg_simple_progression)
    "no refinement": lambda comps, ss, se, ah, al: ah == 0,
    "the DC scans": lambda comps, ss, se, ah, al: ss == 0,
    "the first DC scan": lambda comps, ss, se, ah, al: ss == 0 and ah == 0,
    "no last luma refinement": lambda comps, ss, se, ah, al: not (ah == 1 and ss and comps == [1]),
    "no chroma AC": lambda comps, ss, se, ah, al: not (ss and comps != [1]),
}


@pytest.mark.parametrize("mode,sub,hw", [("RGB", 2, (64, 48)), ("RGB", 2, (24, 40)),
                                         ("RGB", 2, (17, 9)), ("L", 0, (45, 61)),
                                         ("RGB", 0, (30, 70)), ("RGB", 1, (33, 20))])
def test_unrefined_progressive_files_are_smoothed_as_pillow_on_both_routes(mode, sub, hw,
                                                                           native,  # noqa: F811
                                                                           monkeypatch):
    """libjpeg-turbo's jdcoefct.c decompress_smooth_data: the 5 x 5 DC
    neighbourhoods, its clamping at the image's edges (4:2:0 heights whose
    last iMCU row is short included) and DC interpolation where no AC
    coefficient was scanned."""
    base = _huffman(mode, {"quality": 75, "subsampling": sub, "progressive": True}, *hw,
                    hw[0] * hw[1])
    for name, keep in SCANS_KEPT.items():
        data = kinds.jpeg_scans(base, keep)
        want = _pillow(data)
        for route in (False, True):
            np.testing.assert_array_equal(jpeg.jpeg_decode_rgb(data, host_cpp=route), want,
                                          err_msg=name)
        if data == base:  # no scan left out (a gray file has no chroma AC)
            continue
        with monkeypatch.context() as m:  # the smoothing changes the image
            m.setattr(jpeg, "_smooth", lambda fr: fr.coef)
            assert not np.array_equal(jpeg.jpeg_decode_rgb(data), want), name


# ---------------------------------------------------------------------------
# the fixtures, and the CLIs
# ---------------------------------------------------------------------------

def test_the_chip_fixtures_decode_to_their_recorded_pillow_decodes():
    """chip_smoke.py phase 53's inputs against their Pillow decodes
    (decodes.npz, decodes.json; the 256 px photos by digest) and against
    Pillow here."""
    with open(os.path.join(FIXTURES, "decodes.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(FIXTURES, "decodes.npz"))
    names = sorted(k for k in meta if k != "pillow")
    assert names == sorted(os.path.splitext(os.path.basename(p))[0] for p in IMAGES)
    assert sorted(npz.files) == [n for n in names if "256" not in n]
    for path in IMAGES:
        name = os.path.splitext(os.path.basename(path))[0]
        got = im.read_image_rgb(path)
        assert list(got.shape) == meta[name]["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == meta[name]["sha256"], name
        if name in npz.files:
            np.testing.assert_array_equal(got, npz[name])
        np.testing.assert_array_equal(got, np.asarray(PIL.Image.open(path).convert("RGB")))


def test_the_fixtures_are_what_make_fixtures_writes():
    for name, data in kinds.files().items():
        if name.endswith((".jpg", ".png")) or "lossless" in name:
            with open(os.path.join(FIXTURES, name), "rb") as f:
                assert f.read() == data, name


def _mixed_folder(tmp_path):
    """PNG (8- and 16-bit, Adam7), JPEG (baseline, arithmetic) and WEBP
    (lossless, lossy with alpha, animated) photos of several shapes."""
    files = {}
    rgb = PIL.Image.fromarray(photo(40, 48, 20))
    buf = io.BytesIO()
    rgb.save(buf, "PNG")
    files["a.png"] = buf.getvalue()
    files["b.png"] = kinds.png(kinds.samples(48, 40, 2, 16, 21), 16, 2)
    files["c.png"] = kinds.png(kinds.samples(33, 37, 6, 8, 22), 8, 6, interlace=1)
    base = _huffman("RGB", {"quality": 85}, 50, 36, 23)
    files["d.jpg"] = base
    files["e.jpg"] = arith_jpeg(base, progressive=True, restart=3)
    for name, (img, opts) in {"f.webp": (PIL.Image.fromarray(photo(30, 44, 24)),
                                         {"lossless": True}),
                              "g.webp": (PIL.Image.fromarray(photo(45, 35, 25)).convert("RGBA"),
                                         {"quality": 70})}.items():
        buf = io.BytesIO()
        img.save(buf, "WEBP", **opts)
        files[name] = buf.getvalue()
    buf = io.BytesIO()
    PIL.Image.fromarray(photo(36, 36, 26)).save(
        buf, "WEBP", save_all=True, quality=75, duration=50,
        append_images=[PIL.Image.fromarray(photo(36, 36, 27))])
    files["h.webp"] = buf.getvalue()
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    return sorted(str(tmp_path / n) for n in files)


def test_bp_load_images_of_a_mixed_folder_matches_the_jax_cli(tmp_path):
    paths = _mixed_folder(tmp_path)
    for size in (32, 48):
        got = load_images(str(tmp_path), size)
        assert got.shape == (len(paths), size, size, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_load_images(str(tmp_path), size))


def test_regressor_batches_of_a_mixed_folder_match_the_jax_trainer(tmp_path, monkeypatch,
                                                                    native):  # noqa: F811
    monkeypatch.setitem(__import__("sys").modules, "latent2im_tpu.native", None)
    monkeypatch.setitem(__import__("sys").modules, "latent2im_tpu_torch.native", None)
    paths = _mixed_folder(tmp_path)
    order = np.random.RandomState(0).permutation(len(paths))
    want = list(jtr._pil_batches(paths, 32, 3, order))
    for route in (False, True):
        with tr.make_loader(paths, 32, host_cpp=route) as loader:
            got = list(loader.batches(tr.index_batches(order, 3)))
        assert len(got) == len(want) == 3
        for (g, gi), (w, wi) in zip(got, want):
            assert gi == wi and np.array_equal(g, w)
