"""The port's JPEG decoder (latent2im_tpu_torch/utils/jpeg.py), on
the CPU, bit for bit against Pillow's ``Image.open(p).convert("RGB")``
(libjpeg-turbo: ISLOW IDCT, fancy upsampling), on JPEGs Pillow writes here
from seeded numpy images:

- grayscale, 4:4:4, 4:2:2, 4:2:0 and 4:1:1 (Pillow), 4:4:0 (cv2, where it
  is installed), RGB with an Adobe transform 0 (``keep_rgb``); sizes that
  are and are not a multiple of the MCU (17 x 23, 218 x 178), widths and
  heights of 1-3 pixels (box upsampling where a chroma plane is 2 or fewer
  samples wide); quality 50 and 95; optimised Huffman tables; restart
  markers every MCU row and every 3 MCUs;
- every layout is held exactly: none is gated at one level;
- what it does not read raises naming ROADMAP item 26 (arithmetic-coded
  lossless, hierarchical and 12-bit frames, which Pillow fails too), and so
  does nothing else; progressive, CMYK, arithmetic-coded and lossless files
  and WEBP through ``read_image_rgb``, once refused, decode as Pillow
  decodes them (tests/test_torch_jpeg_progressive.py,
  tests/test_torch_image_kinds.py and tests/test_torch_webp.py hold them in
  full); truncated data raises;
- the committed fixtures of chip_smoke.py's phase 38 decode to their
  recorded Pillow decodes;
- the inversion CLI's ``load_images`` on a directory of JPEGs equals the JAX
  CLI's, and ``--updateGAN``'s real batches of JPEGs equal the JAX
  package's pure-Python batch path (its native extension hidden, as in
  tests/test_torch_gan_io.py).
"""

import hashlib
import io
import json
import os
import sys

import numpy as np
import PIL.Image
import pytest

from latent2im_tpu.cli import train as jcli
from latent2im_tpu.cli.bp import load_images as jax_load_images
from latent2im_tpu_torch.cli import train as tcli
from latent2im_tpu_torch.cli.bp import load_images
from latent2im_tpu_torch.utils import image as im
from latent2im_tpu_torch.utils.jpeg import jpeg_decode_rgb

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_jpeg")


def _image(h, w, seed, smooth):
    rng = np.random.RandomState(seed)
    if not smooth:
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([127.5 + 120 * np.sin(xx / 7.0 + yy / 11.0 + c) for c in range(3)], -1)
    return np.clip(a + rng.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)


def _jpeg(arr, mode="RGB", **opts) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(arr).convert(mode).save(buf, "JPEG", **opts)
    return buf.getvalue()


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))


def _assert_decodes_as_pillow(data):
    got, want = jpeg_decode_rgb(data), _pillow(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


LAYOUTS = [("L", 0), ("RGB", 0), ("RGB", 1), ("RGB", 2)]  # gray, 4:4:4, 4:2:2, 4:2:0


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("hw", [(17, 23), (218, 178)])
@pytest.mark.parametrize("mode,subsampling", LAYOUTS)
def test_baseline_layouts_decode_as_pillow(mode, subsampling, hw, quality):
    """Noise and a smooth image at each layout, size and quality."""
    for smooth in (False, True):
        arr = _image(*hw, hw[0] * 31 + quality, smooth)
        _assert_decodes_as_pillow(_jpeg(arr, mode, quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("opts", [
    {"restart_marker_rows": 1}, {"restart_marker_blocks": 3}, {"optimize": True},
    {"optimize": True, "restart_marker_blocks": 1},
])
@pytest.mark.parametrize("mode,subsampling", LAYOUTS)
def test_restart_markers_and_optimised_tables_decode_as_pillow(mode, subsampling, opts):
    arr = _image(45, 70, 7, True)
    _assert_decodes_as_pillow(_jpeg(arr, mode, quality=85, subsampling=subsampling, **opts))


@pytest.mark.parametrize("hw", [(1, 1), (2, 2), (3, 50), (33, 2), (16, 1), (9, 3), (1, 40)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_tiny_widths_and_heights_decode_as_pillow(hw, subsampling):
    """Chroma planes of 1-2 samples take box upsampling, 3 and more the
    fancy filters; one-row and one-column images."""
    _assert_decodes_as_pillow(_jpeg(_image(*hw, 5, False), quality=90, subsampling=subsampling))


def test_other_sampling_factors_and_adobe_rgb_decode_as_pillow():
    """4:1:1 (int_upsample), 4:4:0 (h1v2_fancy_upsample, written by cv2
    where it is installed) and a 3-component RGB file marked by an Adobe
    APP14 transform 0."""
    arr = _image(37, 45, 9, False)
    _assert_decodes_as_pillow(_jpeg(arr, quality=90, subsampling="4:1:1"))
    _assert_decodes_as_pillow(_jpeg(arr, quality=90, keep_rgb=True))
    cv2 = pytest.importorskip("cv2")
    for name in ("IMWRITE_JPEG_SAMPLING_FACTOR_440", "IMWRITE_JPEG_SAMPLING_FACTOR_411"):
        ok, enc = cv2.imencode(".jpg", arr, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                             getattr(cv2, name)])
        assert ok
        _assert_decodes_as_pillow(enc.tobytes())


def test_what_the_decoder_does_not_read_raises_naming_item_26(tmp_path):
    """Progressive, CMYK and WEBP files, which this test once held refused,
    now decode as Pillow decodes them, through ``read_image_rgb`` too; so
    does a baseline file's SOF0 rewritten to SOF9, now a corrupt
    arithmetic-coded file that Pillow decodes to noise without an error;
    rewritten to SOF3 it is a lossless file whose scan asks for predictor
    0, which the decoder refuses as libjpeg-turbo does (and Pillow fails).
    What still raises naming item 26: a frame marker of the arithmetic-coded
    lossless or hierarchical kinds and 12-bit precision (each written over
    a baseline file's SOF0)."""
    arr = _image(24, 24, 11, True)
    for what, data in {"progressive": _jpeg(arr, progressive=True),
                       "CMYK": _jpeg(arr, "CMYK")}.items():
        _assert_decodes_as_pillow(data)
        path = tmp_path / f"{what}.jpg"
        path.write_bytes(data)
        np.testing.assert_array_equal(im.read_image_rgb(str(path)),
                                      np.asarray(PIL.Image.open(path).convert("RGB")))
    base = _jpeg(arr)
    sof = base.index(b"\xff\xc0")
    _assert_decodes_as_pillow(base[:sof + 1] + b"\xc9" + base[sof + 2:])
    lossless = base[:sof + 1] + b"\xc3" + base[sof + 2:]
    with pytest.raises(ValueError, match="bad lossless scan parameters"):
        jpeg_decode_rgb(lossless)
    with pytest.raises(OSError):
        PIL.Image.open(io.BytesIO(lossless)).convert("RGB")
    for what, data in {
            "arithmetic-coded lossless": base[:sof + 1] + b"\xcb" + base[sof + 2:],
            "hierarchical": base[:sof + 1] + b"\xc5" + base[sof + 2:],
            "arithmetic-coded hierarchical": base[:sof + 1] + b"\xcd" + base[sof + 2:],
            "12-bit": base[:sof + 4] + b"\x0c" + base[sof + 5:]}.items():
        with pytest.raises(ValueError, match=f"{what}.*item 26"):
            jpeg_decode_rgb(data)
        path = tmp_path / "r.jpg"
        path.write_bytes(data)
        with pytest.raises(ValueError, match=f"r.jpg.*{what}.*item 26"):
            im.read_image_rgb(str(path))
    path = tmp_path / "x.webp"
    PIL.Image.fromarray(arr).save(path, "WEBP")
    np.testing.assert_array_equal(im.read_image_rgb(str(path)),
                                  np.asarray(PIL.Image.open(path).convert("RGB")))


def test_truncated_and_corrupt_data_raise():
    data = _jpeg(_image(64, 64, 12, False), quality=95)
    for cut in (len(data) // 2, len(data) - 200, 400):
        with pytest.raises(ValueError, match="truncated|Huffman|corrupt"):
            jpeg_decode_rgb(data[:cut])
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg_decode_rgb(b"\x89PNG\r\n\x1a\n")
    sos = data.index(b"\xff\xda")
    with pytest.raises(ValueError, match="truncated"):
        jpeg_decode_rgb(data[:sos] + b"\xff\xd9")


def test_the_chip_fixtures_decode_to_their_recorded_pillow_decodes():
    """chip_smoke.py phase 38's inputs: each committed JPEG against its
    Pillow decode (decodes.npz) and the decode's SHA-256 (decodes.json,
    the only record of the 1024 px one), and against Pillow here."""
    with open(os.path.join(FIXTURES, "decodes.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(FIXTURES, "decodes.npz"))
    names = sorted(k for k in meta if k != "pillow")
    assert len(names) == 5 and set(npz.files) < set(names)
    for name in names:
        path = os.path.join(FIXTURES, f"{name}.jpg")
        got = im.read_image_rgb(path)
        assert list(got.shape) == meta[name]["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == meta[name]["sha256"], name
        if name in npz.files:
            np.testing.assert_array_equal(got, npz[name])
        np.testing.assert_array_equal(got, np.asarray(PIL.Image.open(path).convert("RGB")))


def test_bp_load_images_of_jpegs_matches_the_jax_cli(tmp_path):
    shapes = [(40, 48, 2), (48, 40, 1), (33, 90, 0), (64, 64, 2)]
    for i, (h, w, sub) in enumerate(shapes):
        mode = "L" if i == 2 else "RGB"
        (tmp_path / f"im{i}.jpg").write_bytes(
            _jpeg(_image(h, w, 20 + i, i % 2 == 0), mode, quality=90, subsampling=sub))
    for size in (32, 64):
        got = load_images(str(tmp_path), size)
        assert got.shape == (len(shapes), size, size, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_load_images(str(tmp_path), size))


def test_gan_real_batches_of_jpegs_match_the_jax_fallback(tmp_path, monkeypatch):
    """--updateGAN's provider on a directory of JPEGs (and a PNG): the port's
    batches equal the JAX package's pure-Python loader's (Pillow decode,
    centre crop, BILINEAR)."""
    monkeypatch.setitem(sys.modules, "latent2im_tpu.native", None)
    monkeypatch.setitem(sys.modules, "latent2im_tpu_torch.native", None)
    (tmp_path / "sub").mkdir()
    for i, (h, w) in enumerate([(30, 24), (24, 36), (18, 18), (40, 22)]):
        (tmp_path / ("sub" if i % 2 else ".") / f"im{i}.jpeg").write_bytes(
            _jpeg(_image(h, w, 30 + i, True), quality=88, subsampling=i % 3))
    (tmp_path / "p.png").write_bytes(im.png_bytes(_image(20, 20, 40, False)))
    paths = tcli._real_paths(str(tmp_path))
    assert len(paths) == 5
    want, got = jcli._make_real_batcher(paths, 16, 3), tcli._make_real_batcher(paths, 16, 3)
    for _ in range(3):
        np.testing.assert_array_equal(got(), want())
