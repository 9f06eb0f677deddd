"""libjpeg's recovery from corrupt data in the port's JPEG decoder
(latent2im_tpu_torch/utils/jpeg.py, ROADMAP fault C.11), in both of its modes:

- the Pillow mode (``read_image_rgb``) against Pillow 12.1 (its
  libjpeg-turbo 3.1.3 fed 64 KiB at a time) on a seeded corpus of corrupt
  files (tests/jpeg_corrupt_corpus.py: overwritten bytes, inserted markers,
  garbage before markers, truncations), lossless ones among them, and on
  files past Pillow's first 64 KiB read: each file decodes to the same
  bytes or fails on both sides;
- the libjpeg mode (the native path, ``native.load_resize``) against the
  JAX package's extension (libjpeg-turbo 2.1.5 over a whole buffer) on the
  same corpus;
- the forms one warning of libjpeg names each (a bad Huffman code, a marker
  in a scan, extraneous bytes, a restart marker out of turn, scan
  parameters for another mode, a progression out of order, an Adobe
  transform it does not know, a scan with no DHT), the tail of a one-scan
  file, and a file with no EOI, against both;
- the host C++ twin (ops/csrc/jpeg_huffman.cpp, built here by the host's
  compiler) equal to the Python decoder on every file, in both modes;
- tests/fixtures/torch_jpeg_corrupt/, what the card's phase 55 reads,
  still what Pillow and the extension make of it.
"""

import glob
import io
import json
import os
import warnings

import numpy as np
import PIL.Image
import pytest

import jpeg_corrupt_corpus as cc
from jpeg_arith_encoder import arith_jpeg
from latent2im_tpu_torch.native import _l2i_native as tn
from latent2im_tpu_torch.native.resize import crop_resize
from latent2im_tpu_torch.utils import jpeg
from test_torch_loader import host_library, native  # noqa: F401 (the C++ twin)

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "torch_jpeg_corrupt")
SMALL = cc.sources()
LARGE = cc.sources(large=True)
LOSSLESS = cc.sources(lossless=True)
CORPUS = sorted(SMALL) + sorted(LARGE) + sorted(LOSSLESS)
N_LARGE = 6  # corruptions of each file past 64 KiB (a Python decode there takes ~0.2 s)


def _pillow(data):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))
        except Exception:
            return None


_DECODES = {}  # the Python decodes, shared by the tests of this module


def _port(data, libjpeg=False, host_cpp=False):
    key = (data, libjpeg)
    if not host_cpp and key in _DECODES:
        return _DECODES[key]
    try:
        got = jpeg.jpeg_decode_rgb(data, host_cpp=host_cpp, libjpeg=libjpeg)
    except ValueError:
        got = None
    if not host_cpp:
        _DECODES[key] = got
    return got


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and np.array_equal(a, b)


def _corpus(name):
    src, seed = (LOSSLESS, 300) if name in LOSSLESS else (LARGE, 200) if name in LARGE else \
        (SMALL, 100)
    n = N_LARGE if "large" in name else 60
    return cc.corrupt(src[name], seed + sorted(src).index(name), n)


@pytest.mark.parametrize("name", CORPUS)
def test_the_pillow_mode_decodes_the_corpus_as_pillow(name):
    counts = {"decode": 0, "fail": 0}
    for label, data in _corpus(name):
        want, got = _pillow(data), _port(data)
        assert _same(want, got), f"{name} {label}: Pillow {'fails' if want is None else 'decodes'}"
        counts["fail" if want is None else "decode"] += 1
    assert counts["decode"] and counts["fail"], counts


def _extension():
    return pytest.importorskip("latent2im_tpu.native")._l2i_native


def _load(fn, path, size):
    try:
        return fn(path, size)
    except OSError:
        return None


@pytest.mark.parametrize("name", CORPUS)
def test_the_libjpeg_mode_loads_the_corpus_as_the_extension(name, tmp_path):
    ext = _extension()
    path = str(tmp_path / "x.jpg")
    for label, data in _corpus(name):
        with open(path, "wb") as f:
            f.write(data)
        h = 250 if "large" in name else 48
        img = _port(data, libjpeg=True)  # native.load_resize's decode of a JPEG
        for size in (h, h + 13):
            want = _load(ext.load_resize, path, size)
            got = None if img is None else crop_resize(img, size)
            assert _same(want, got), f"{name} {label} at {size} px"


@pytest.mark.parametrize("name", CORPUS)
def test_the_c_twin_is_the_python_decoder_on_the_corpus(name, native):  # noqa: F811
    for label, data in _corpus(name):
        for lj in (False, True):
            py = _port(data, lj)
            c = _port(data, lj, host_cpp=True)
            assert _same(py, c), f"{name} {label} (libjpeg={lj})"
            if not lj and py is None:  # the same error
                with pytest.raises(ValueError) as e_py:
                    jpeg.jpeg_decode_rgb(data)
                with pytest.raises(ValueError) as e_c:
                    jpeg.jpeg_decode_rgb(data, host_cpp=True)
                assert str(e_py.value) == str(e_c.value), label


PHOTOS = {256: "photo_256_422.jpg", 1024: "photo_1024_420.jpg"}  # chip_smoke.PHOTO_JPEGS


def _photo(size):
    with open(os.path.join(HERE, "fixtures", "torch_jpeg", PHOTOS[size]), "rb") as f:
        return cc.overwritten(f.read(), size)


@pytest.mark.parametrize("size", sorted(PHOTOS))
def test_photo_sized_overwritten_files_decode_as_pillow_and_the_extension(size, tmp_path):
    """The photos whose decodes phase 55 times, three scan bytes overwritten:
    the Pillow mode is Pillow's decode, the libjpeg mode's load_resize the
    extension's."""
    data = _photo(size)
    want = _pillow(data)
    assert want is not None and want.shape == (size, size, 3)
    assert _same(want, _port(data)), size
    ext = _extension()
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    img = _port(data, libjpeg=True)
    assert _same(_load(ext.load_resize, path, 256), crop_resize(img, 256)), size


@pytest.mark.parametrize("size", sorted(PHOTOS))
def test_the_c_twin_is_the_python_decoder_on_photo_sized_files(size, native):  # noqa: F811
    data = _photo(size)
    for lj in (False, True):
        assert _same(_port(data, lj), _port(data, lj, host_cpp=True)), (size, lj)


# ---------------------------------------------------------------------------
# one form a warning
# ---------------------------------------------------------------------------

def _segments(data, code):
    return [(p, c) for p, c in cc.markers(data) if c == code]


def _strip(data, code):
    for p, _ in reversed(_segments(data, code)):
        n = int.from_bytes(data[p + 2:p + 4], "big")
        data = data[:p] + data[p + 2 + n:]
    return data


def _scan_params(data, params):
    p, _ = _segments(data, 0xDA)[0]
    n = int.from_bytes(data[p + 2:p + 4], "big")
    return data[:p + 2 + n - 3] + bytes(params) + data[p + 2 + n:]


def _progressive_scans(data):
    """The head before the first DHT or SOS, and each scan with the tables
    before it, as byte ranges."""
    scans = cc.scan_ranges(data)
    first = min(p for p, c in cc.markers(data) if c in (0xC4, 0xDA))
    out, lo = [], first
    for _, end in scans:
        out.append((lo, end))
        lo = end
    return data[:first], out


def _forms():
    b, p, r, g = SMALL["baseline"], SMALL["progressive"], SMALL["restart"], SMALL["gray"]
    big = LARGE["large_baseline"]
    s0 = cc.scan_ranges(b)[0][0]
    head, units = _progressive_scans(p)
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x05"
    forms = {
        "not_sequential_000": _scan_params(b, (0, 0, 0)),
        "not_sequential_0_63_1": _scan_params(b, (0, 63, 1)),
        "not_sequential_1_63_0": _scan_params(b, (1, 63, 0)),
        "no_dht_baseline": _strip(b, 0xC4),
        "no_dht_gray": _strip(g, 0xC4),
        "no_dht_restart": _strip(r, 0xC4),
        "no_dht_progressive": _strip(p, 0xC4),
        "adobe_transform_5": b[:2] + adobe + b[2:],
        "adobe_transform_5_no_jfif": b[:2] + adobe + _strip(b, 0xE0)[2:],
        "ff_ff_00_in_scan": b[:s0 + 20] + b"\xff\xff\x00" + b[s0 + 20:],
        "second_scan": b[:-2] + b[_segments(b, 0xDA)[0][0]:s0] + bytes(20) + b"\xff\xd9",
        "tail_segment_past_the_end": b[:-2] + b"\xff\xe1\x40\x00abc",
        "tail_bad_dht": b[:-2] + b"\xff\xc4\x00\x05\x55\x00\x00\xff\xd9",
        "tail_dri_cut": b[:-2] + b"\xff\xdd\x00\x04\x00",
        "progression_swapped": head + p[units[1][0]:units[1][1]] + p[units[0][0]:units[0][1]]
        + b"".join(p[a:z] for a, z in units[2:]) + b"\xff\xd9",
        "progression_repeated": head + b"".join(p[a:z] for a, z in units)
        + p[units[-1][0]:units[-1][1]] + b"\xff\xd9",
        "progression_no_dc": head + b"".join(p[a:z] for a, z in units[1:]) + b"\xff\xd9",
        "restart_missing": r[:_segments(r, 0xD3)[0][0]] + r[_segments(r, 0xD3)[0][0] + 2:],
        "restart_out_of_turn": r[:_segments(r, 0xD3)[0][0] + 1] + b"\xd6"
        + r[_segments(r, 0xD3)[0][0] + 2:],
        "arith_overwritten": _overwrite(arith_jpeg(b, restart=2), 3),
        "arith_inserted_rst": _insert(arith_jpeg(b, restart=2), b"\xff\xd5"),
        "arith_progressive_overwritten": _overwrite(arith_jpeg(p, progressive=True), 5),
    }
    for cut in (1, 2, 3, 6):
        for src, name in ((b, "baseline"), (r, "restart"), (p, "progressive")):
            forms[f"no_eoi_{name}_less_{cut}"] = src[:-cut]
            forms[f"no_eoi_{name}_less_{cut}_then_zeros"] = src[:-cut] + bytes(9)
    for off in (65536 - 3, 65536 - 1, 65536, 65536 + 2):
        for code in (0xD3, 0xC4, 0xDD, 0xE1):
            forms[f"large_insert_{code:02X}_at_{off}"] = big[:off] + bytes([0xFF, code]) + \
                big[off:]
    return forms


def _overwrite(data, n):
    rng = np.random.RandomState(n)
    a, z = cc.scan_ranges(data)[0]
    buf = bytearray(data)
    for q in rng.randint(a, z, n):
        buf[q] = rng.randint(256)
    return bytes(buf)


def _insert(data, what):
    a, z = cc.scan_ranges(data)[0]
    q = (a + z) // 2
    q += data[q - 1] == 0xFF
    return data[:q] + what + data[q:]


FORMS = _forms()


@pytest.mark.parametrize("name", sorted(FORMS))
def test_each_form_decodes_as_pillow_and_loads_as_the_extension(name, tmp_path):
    data = FORMS[name]
    assert _same(_pillow(data), _port(data)), name
    ext = pytest.importorskip("latent2im_tpu.native")._l2i_native
    path = str(tmp_path / "x.jpg")
    with open(path, "wb") as f:
        f.write(data)
    for size in (40, 53):
        want = _load(ext.load_resize, path, size)
        got = _load(lambda p, s: tn.load_resize(p, s, host_cpp=False), path, size)
        assert _same(want, got), (name, size)


def test_the_forms_cover_recovery_and_failure():
    outcomes = {name: _pillow(data) is not None for name, data in FORMS.items()}
    assert sum(outcomes.values()) > 20 and sum(not v for v in outcomes.values()) > 10
    for name in ("not_sequential_000", "no_dht_baseline", "ff_ff_00_in_scan",
                 "tail_segment_past_the_end", "progression_swapped", "restart_missing"):
        assert outcomes[name], name
    for name in ("no_dht_progressive", "second_scan", "tail_bad_dht",
                 "no_eoi_baseline_less_2"):
        assert not outcomes[name], name


def test_the_c_twin_is_the_python_decoder_on_each_form(native):  # noqa: F811
    for name, data in FORMS.items():
        for lj in (False, True):
            assert _same(_port(data, lj), _port(data, lj, host_cpp=True)), (name, lj)


# ---------------------------------------------------------------------------
# the recorded fixtures (chip_smoke.py phase 55)
# ---------------------------------------------------------------------------

def test_the_fixtures_equal_their_recordings():
    with open(os.path.join(FIXTURES, "record.json")) as f:
        rec = json.load(f)
    npz = np.load(os.path.join(FIXTURES, "decodes.npz"))
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(FIXTURES, "*.jpg")))
    assert names == sorted(rec["pillow"]) and len(names) >= 8
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()
        want = _pillow(data)
        assert (want is None) == (rec["pillow"][name] == "fail"), name
        if want is not None:
            np.testing.assert_array_equal(npz[os.path.splitext(name)[0]], want)
        assert _same(_port(data), want), name


def _sha(a) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def test_the_recordings_are_the_ports_native_path_and_regressor_batches(tmp_path):
    """record.json's extension decodes, its Loader epoch and its regressor
    batches (the JAX trainer's: corrupt JPEGs through the native Loader, the
    new formats through Pillow) against the port's Python path, and, where
    it builds, against the extension itself."""
    import shutil

    from latent2im_tpu_torch.cli import train_regressor as tr

    with open(os.path.join(FIXTURES, "record.json")) as f:
        rec = json.load(f)
    try:
        ext = __import__("latent2im_tpu.native", fromlist=["_l2i_native"])._l2i_native
    except ImportError:
        ext = None
    for name, sizes in rec["extension"].items():
        path = os.path.join(FIXTURES, name)
        for size, want in sizes.items():
            got = _load(lambda p, s: tn.load_resize(p, s, host_cpp=False), path, int(size))
            assert (want == "fail") == (got is None) and (got is None or _sha(got) == want), \
                (name, size)
            if ext is not None:
                assert _same(_load(ext.load_resize, path, int(size)), got), (name, size)
    lr = rec["loader"]
    loader = tn.Loader([os.path.join(FIXTURES, n) for n in lr["files"]], lr["size"],
                       lr["batch"], threads=2, host_cpp=False)
    with loader:
        loader.start_epoch(seed=0, shuffle=True)
        got = [{"idx": idx, "sha256": _sha(u8)} for u8, idx in tr.native_batches(loader)]
    assert got == lr["batches"]
    reg = rec["regressor"]
    fix = os.path.dirname(FIXTURES)
    for key, rel in reg["files"].items():
        os.makedirs(tmp_path / "reg" / os.path.dirname(key), exist_ok=True)
        shutil.copy(os.path.join(fix, rel), tmp_path / "reg" / key)
    split = {}
    for part, keys in reg["split"].items():
        (tmp_path / f"{part}.txt").write_text("\n".join(keys) + "\n")
        split[part] = tr.list_split(str(tmp_path / "reg"), str(tmp_path / f"{part}.txt"))
    loader = tn.Loader([p for p, _ in split["training"]], reg["size"], reg["batch"],
                       threads=2, host_cpp=False)
    training = []
    with loader:
        for e in range(2):
            loader.start_epoch(seed=e, shuffle=True)
            training += [{"epoch": e, "idx": idx, "sha256": _sha(u8)}
                         for u8, idx in tr.native_batches(loader)]
    assert training == reg["training"]
    test = tr.make_loader([p for p, _ in split["test"]], reg["size"], False)
    try:
        got = [{"idx": [int(i) for i in idx], "sha256": _sha(u8)}
               for u8, idx in test.batches(tr.index_batches(
                   np.arange(len(split["test"])), reg["batch"]))]
    finally:
        test.close()
    assert got == reg["test"]
