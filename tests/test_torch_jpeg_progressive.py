"""The port's progressive and four-component JPEG decoding
(latent2im_tpu_torch/utils/jpeg.py and its host C++ twin,
ops/csrc/jpeg_huffman.cpp) on the CPU, bit for bit against Pillow's
``Image.open(p).convert("RGB")`` on files Pillow writes here from seeded
images:

- progressive grayscale and YCbCr at 4:4:4, 4:2:2 and 4:2:0, odd and tiny
  sizes, restart markers every 3 MCUs and every MCU row, optimised tables,
  quality 50 and 95;
- CMYK, sequential and progressive, and YCCK (a Pillow CMYK file with its
  Adobe transform set to 2, which Pillow then decodes as YCCK); the CMYK to
  RGB step over every (C, K) pair against Pillow's own conversion;
- a progressive file whose AC coefficients stay unrefined decodes as
  Pillow decodes it (libjpeg-turbo smooths its blocks), a progressive file
  cut short or with a bad scan header raises;
- the host C++ equals the Python decoder on all of these, on the committed
  fixtures and on corrupted and truncated progressive and CMYK files (the
  same image or the same error); skipped where no C++ compiler builds it;
- the committed fixtures of chip_smoke.py's phase 52 decode to their
  recorded Pillow decodes;
- the inversion CLI's ``load_images`` and the regressor trainer's batches
  on a folder of progressive JPEGs equal the JAX package's.
"""

import glob
import hashlib
import io
import json
import os

import numpy as np
import PIL.Image
import pytest

from test_torch_loader import host_library, native  # noqa: F401 (the C++ twin)

from latent2im_tpu.cli import train_regressor as jtr
from latent2im_tpu.cli.bp import load_images as jax_load_images
from latent2im_tpu_torch.cli import train_regressor as tr
from latent2im_tpu_torch.cli.bp import load_images
from latent2im_tpu_torch.utils import image as im
from latent2im_tpu_torch.utils import jpeg

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "torch_jpeg_progressive")
PROG_JPEGS = sorted(glob.glob(os.path.join(FIXTURES, "*.jpg")))


def _photo(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([127.5 + 120 * np.sin(xx / 7.0 + yy / 11.0 + c) for c in range(3)], -1)
    return np.clip(a + rng.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)


def _jpeg(arr, mode="RGB", **opts) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(arr).convert(mode).save(buf, "JPEG", **opts)
    return buf.getvalue()


def _ycck(data: bytes) -> bytes:
    i = data.index(b"\xff\xee")
    assert data[i + 4:i + 9] == b"Adobe"
    return data[:i + 15] + b"\x02" + data[i + 16:]


def _pillow(data: bytes) -> np.ndarray:
    return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))


def _assert_decodes_as_pillow(data):
    got, want = jpeg.jpeg_decode_rgb(data), _pillow(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _segments(data):
    """(marker, start, end) of each segment after SOI, a scan's entropy-coded
    data included in its segment."""
    out, pos = [], 2
    while pos < len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            out.append((marker, pos, pos + 2))
            break
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDA:
            while data[end] != 0xFF or data[end + 1] == 0 or 0xD0 <= data[end + 1] <= 0xD7:
                end += 1
        out.append((marker, pos, end))
        pos = end
    return out


LAYOUTS = [("L", 0), ("RGB", 0), ("RGB", 1), ("RGB", 2)]  # gray, 4:4:4, 4:2:2, 4:2:0


@pytest.mark.parametrize("mode,subsampling", LAYOUTS)
def test_progressive_layouts_decode_as_pillow(mode, subsampling):
    for i, (hw, quality, opts) in enumerate([
            ((37, 53), 50, {}), ((64, 48), 95, {}), ((45, 70), 85, {"optimize": True}),
            ((45, 70), 85, {"restart_marker_blocks": 3}),
            ((40, 33), 85, {"restart_marker_rows": 1})]):
        arr = _photo(*hw, 40 + i)
        _assert_decodes_as_pillow(_jpeg(arr, mode, progressive=True, quality=quality,
                                        subsampling=subsampling, **opts))


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (9, 3), (1, 40), (17, 23)])
def test_progressive_tiny_sizes_decode_as_pillow(hw):
    for subsampling in (0, 1, 2):
        _assert_decodes_as_pillow(_jpeg(_photo(*hw, 5), progressive=True, quality=90,
                                        subsampling=subsampling))


@pytest.mark.parametrize("hw", [(1, 1), (17, 23), (64, 48)])
def test_cmyk_and_ycck_decode_as_pillow(hw):
    arr = _photo(*hw, 9)
    for progressive in (False, True):
        data = _jpeg(arr, "CMYK", progressive=progressive, quality=85)
        assert PIL.Image.open(io.BytesIO(data)).mode == "CMYK"
        _assert_decodes_as_pillow(data)
        _assert_decodes_as_pillow(_ycck(data))


def test_cmyk_to_rgb_is_pillows_conversion_for_every_value():
    """libjpeg's CMYK samples taken as Pillow takes them ("CMYK;I") and
    converted to RGB by Pillow, for every (C, K) pair, M and Y running
    through other values."""
    c, k = (v.ravel().astype(np.uint8) for v in np.mgrid[0:256, 0:256])
    m, y = (c + 77).astype(np.uint8), (k * 3 + 11).astype(np.uint8)
    raw = np.stack([c, m, y, k], -1)
    want = np.asarray(PIL.Image.frombytes("CMYK", (256, 256), raw.tobytes(), "raw",
                                          "CMYK;I").convert("RGB")).reshape(-1, 3)
    np.testing.assert_array_equal(jpeg._cmyk_to_rgb(c, m, y, k), want)


def test_unrefined_smoothed_truncated_and_bad_progressive_files_raise():
    data = _jpeg(_photo(64, 64, 3), progressive=True, quality=85)
    segs = _segments(data)
    scans = [(p, e) for m, p, e in segs if m == 0xDA]
    assert len(scans) >= 6
    # the DC scans alone: libjpeg-turbo smooths the blocks (refused until the
    # decoder smoothed them too, hence the name): as Pillow
    ns = lambda p: data[p + 4]  # noqa: E731
    dc_only = b"\xff\xd8" + b"".join(data[p:e] for m, p, e in segs
                                     if m != 0xDA or data[p + 5 + 2 * ns(p)] == 0)
    assert _pillow(dc_only).shape == (64, 64, 3)
    _assert_decodes_as_pillow(dc_only)
    with pytest.raises(ValueError, match="no EOI"):  # cut before the last scan
        jpeg.jpeg_decode_rgb(data[:scans[-1][0]])
    with pytest.raises(OSError):
        _pillow(data[:scans[-1][0]])
    p, e = scans[2]  # cut inside a scan
    with pytest.raises(ValueError, match="truncated"):
        jpeg.jpeg_decode_rgb(data[:(p + e) // 2])
    i = p + 5 + 2 * ns(p)  # Ss, Se of an AC scan: Se before Ss
    with pytest.raises(ValueError, match="bad progressive scan parameters"):
        jpeg.jpeg_decode_rgb(data[:i] + bytes([9, 3]) + data[i + 2:])


def _both(data):
    out = []
    for native_ in (False, True):
        try:
            out.append(jpeg.jpeg_decode_rgb(data, host_cpp=native_))
        except (ValueError, MemoryError) as e:
            out.append(str(e))
    return out


def _same(data) -> bool:
    want, got = _both(data)
    if isinstance(want, str) or isinstance(got, str):
        assert want == got
        return False
    assert want.shape == got.shape and np.array_equal(want, got)
    return True


def test_the_c_decode_is_the_python_decode(native):  # noqa: F811
    assert len(PROG_JPEGS) == 11
    for path in PROG_JPEGS:
        with open(path, "rb") as f:
            assert _same(f.read()), path
        assert np.array_equal(im.read_image_rgb(path, host_cpp=True), im.read_image_rgb(path))
    arr = _photo(33, 41, 12)
    for mode, opts in [("L", {}), ("RGB", {"subsampling": 1, "optimize": True}),
                       ("RGB", {"subsampling": 2, "restart_marker_rows": 1})]:
        assert _same(_jpeg(arr, mode, progressive=True, **opts))
    cmyk = _jpeg(arr, "CMYK", progressive=True)
    assert _same(cmyk) and _same(_ycck(cmyk))


def test_the_c_decode_fails_as_the_python_decode_on_bad_data(native):  # noqa: F811
    rng = np.random.RandomState(4)
    kinds = {True: 0, False: 0}
    arith = sorted(glob.glob(os.path.join(HERE, "fixtures", "torch_image_kinds", "*.jpg")))
    assert len(arith) == 8  # arithmetic-coded, lossless, smoothed progressive
    for path in [os.path.join(FIXTURES, f"{name}.jpg") for name in (
            "prog_restart_120x100_420", "cmyk_prog_64x48", "prog_odd_37x53_420")] + arith:
        with open(path, "rb") as f:
            src = f.read()
        for cut in range(len(src) // 3, len(src), len(src) // 9):
            kinds[_same(src[:cut])] += 1
        for _ in range(30):
            bad = bytearray(src)
            for i in rng.randint(200, len(src) - 2, rng.randint(1, 4)):
                bad[i] = rng.randint(0, 256)
            kinds[_same(bytes(bad))] += 1
    assert kinds[False] > 0  # some of them fail, in both alike
    # a scan naming more components than the frame has, as many as 255 (the
    # DC-first predictors are one per scan component): both decoders and
    # Pillow refuse it
    for progressive in (True, False):
        data = _jpeg(_photo(24, 24, 6), progressive=progressive, quality=85)
        p = next(p for m, p, e in _segments(data) if m == 0xDA)
        n = data[p + 4]
        comps, tail = data[p + 5:p + 5 + 2 * n], data[p + 5 + 2 * n:p + 8 + 2 * n]
        assert tail[:2] == bytes([0, 0 if progressive else 63])  # a DC or a sequential scan
        for ns in (n + 1, 5, 255):
            specs = (comps * ns)[:2 * ns]
            body = bytes([ns]) + specs + tail
            bad = data[:p + 2] + (len(body) + 2).to_bytes(2, "big") + body + \
                data[p + 8 + 2 * n:]
            assert _both(bad) == ["jpeg: bad SOS segment"] * 2, ns
            with pytest.raises(OSError):
                _pillow(bad)


def test_the_chip_fixtures_decode_to_their_recorded_pillow_decodes():
    """chip_smoke.py phase 52's inputs against their Pillow decodes
    (decodes.npz, decodes.json) and against Pillow here."""
    with open(os.path.join(FIXTURES, "decodes.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(FIXTURES, "decodes.npz"))
    names = sorted(k for k in meta if k != "pillow")
    assert names == sorted(os.path.basename(p)[:-4] for p in PROG_JPEGS) == sorted(npz.files)
    for name in names:
        path = os.path.join(FIXTURES, f"{name}.jpg")
        got = im.read_image_rgb(path)
        assert list(got.shape) == meta[name]["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == meta[name]["sha256"], name
        np.testing.assert_array_equal(got, npz[name])
        np.testing.assert_array_equal(got, np.asarray(PIL.Image.open(path).convert("RGB")))


def test_bp_load_images_of_progressive_jpegs_matches_the_jax_cli(tmp_path):
    for i, path in enumerate(PROG_JPEGS[:5]):
        with open(path, "rb") as f:
            (tmp_path / f"im{i}.jpg").write_bytes(f.read())
    got = load_images(str(tmp_path), 32)
    assert got.shape == (5, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_load_images(str(tmp_path), 32))


def test_regressor_batches_of_progressive_jpegs_match_the_jax_trainer(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "latent2im_tpu.native", None)
    monkeypatch.setitem(__import__("sys").modules, "latent2im_tpu_torch.native", None)
    order = np.random.RandomState(0).permutation(len(PROG_JPEGS))
    with tr.make_loader(PROG_JPEGS, 32, host_cpp=False) as loader:
        got = list(loader.batches(tr.index_batches(order, 4)))
    want = list(jtr._pil_batches(PROG_JPEGS, 32, 4, order))
    assert len(got) == len(want) == 3
    for (g, gi), (w, wi) in zip(got, want):
        assert gi == wi and np.array_equal(g, w)
