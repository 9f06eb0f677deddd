"""The port's WEBP decoder (latent2im_tpu_torch/utils/webp.py) on the CPU, bit
for bit against Pillow 12.1's ``Image.open(p).convert("RGB")`` (libwebp
1.6.0's WebPAnimDecoder) on files Pillow writes here from seeded images:

- lossless (VP8L): 1 x 1, 17 x 23 and 256 x 256 at every ``method`` 0-6,
  2, 4, 16 and 200-colour palettes (pixel bundling, and none) at odd sizes,
  RGBA kept ``exact``;
- lossy (VP8): quality 5-100 at every ``method``, sizes that are not a
  multiple of 16, with alpha (VP8X + ALPH, lossless and raw alpha);
- lossy files whose partition 0 is re-coded here with the simple loop
  filter or a sharpness level (Pillow's encoder writes neither), so
  libwebp's decode of them is the oracle;
- the first frame of a two-frame animation, and a first frame placed at
  an offset on a larger canvas;
- truncated and corrupted files (every chunk): the port fails wherever
  Pillow fails, and where both decode, they agree;
- the host C++ twin (ops/csrc/webp_decode.cpp) equals the Python decoder on
  all of these, and fails alike on bad data (skipped where no C++ compiler
  builds it).
"""

import glob
import importlib.util
import io
import os

import numpy as np
import PIL.Image
import pytest

from test_torch_loader import host_library, native  # noqa: F401 (the C++ twin)

from latent2im_tpu_torch.utils import webp
from latent2im_tpu_torch.utils.webp import webp_decode_rgb

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "torch_image_kinds_fixtures",
    os.path.join(HERE, "fixtures", "torch_image_kinds", "make_fixtures.py"))
kinds = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(kinds)
photo = kinds.photo


def _webp(img, **opts) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "WEBP", **opts)
    return buf.getvalue()


def _pillow(data: bytes):
    try:
        return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:  # Pillow's errors are OSError, SyntaxError, ValueError...
        return None


def _assert_as_pillow(data: bytes):
    want = _pillow(data)
    assert want is not None
    got = webp_decode_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _rgba(h, w, seed):
    img = PIL.Image.fromarray(photo(h, w, seed)).convert("RGBA")
    a = np.asarray(img.convert("L")).copy()
    a[a < 110] = 0
    img.putalpha(PIL.Image.fromarray(a))
    return img


@pytest.mark.parametrize("method", range(7))
def test_lossless_decodes_as_pillow_at_every_method(method):
    for h, w in ((1, 1), (17, 23), (256, 256)):
        data = _webp(PIL.Image.fromarray(photo(h, w, h + method)), lossless=True,
                     method=method)
        assert data[12:16] == b"VP8L"
        _assert_as_pillow(data)


@pytest.mark.parametrize("colors", [2, 4, 16, 200])
def test_lossless_palettes_decode_as_pillow(colors):
    """2, 4 and 16 colours bundle 8, 4 and 2 pixels a byte; 200 none."""
    img = PIL.Image.fromarray(photo(45, 37, colors)).convert(
        "P", palette=PIL.Image.ADAPTIVE, colors=colors).convert("RGB")
    for opts in ({}, {"method": 6}, {"method": 0}):
        _assert_as_pillow(_webp(img, lossless=True, **opts))
        _assert_as_pillow(_webp(img.crop((1, 2, 30, 23)), lossless=True, **opts))


def test_lossless_rgba_exact_and_not_decodes_as_pillow():
    img = _rgba(40, 36, 7)
    for exact in (True, False):
        _assert_as_pillow(_webp(img, lossless=True, exact=exact))


@pytest.mark.parametrize("quality", [5, 25, 50, 75, 90, 100])
def test_lossy_decodes_as_pillow_across_quality_and_method(quality):
    for method in range(7):
        for h, w in ((37, 53), (17, 23)):
            data = _webp(PIL.Image.fromarray(photo(h, w, quality + method)), quality=quality,
                         method=method)
            assert data[12:16] == b"VP8 "
            _assert_as_pillow(data)
    _assert_as_pillow(_webp(PIL.Image.fromarray(photo(1, 1, quality)), quality=quality))


def test_lossy_256_decodes_as_pillow():
    _assert_as_pillow(_webp(PIL.Image.fromarray(photo(256, 256, 8)), quality=80))


def test_lossy_with_alpha_decodes_as_pillow():
    """VP8X + ALPH (lossless-coded alpha at several alpha qualities, its
    filters, and raw alpha); the alpha is decoded, checked and dropped."""
    img = _rgba(33, 47, 9)
    for opts in ({"quality": 75}, {"quality": 60, "alpha_quality": 20},
                 {"quality": 90, "method": 6}, {"quality": 50, "alpha_quality": 100}):
        data = _webp(img, **opts)
        assert data[12:16] == b"VP8X" and b"ALPH" in data
        _assert_as_pillow(data)


def test_first_frame_of_an_animation_decodes_as_pillow():
    a, b = (PIL.Image.fromarray(photo(40, 56, s)) for s in (10, 11))
    for opts in ({"quality": 80}, {"lossless": True}):
        buf = io.BytesIO()
        a.save(buf, "WEBP", save_all=True, append_images=[b], duration=100, **opts)
        data = buf.getvalue()
        assert PIL.Image.open(io.BytesIO(data)).n_frames == 2
        _assert_as_pillow(data)
    frame = _webp(PIL.Image.fromarray(photo(24, 30, 12)), lossless=True)
    data = kinds.offset_animation(frame, (50, 44), (8, 12))
    got = webp_decode_rgb(data)
    _assert_as_pillow(data)
    assert got.shape == (44, 50, 3) and not got[:12].any() and not got[:, :8].any()


# ---------------------------------------------------------------------------
# partition 0 re-coded: the frame header fields Pillow's encoder never sets
# ---------------------------------------------------------------------------

class _BoolEncoder:
    """RFC 6386 7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self) -> bytes:
        for _ in range(32):
            self.put(128, 0)
        return bytes(self.out)


def _recode_partition0(data: bytes, edit) -> bytes:
    """A simple lossy WEBP with partition 0's decisions replayed through
    ``edit(decisions) -> decisions`` ((probability, bit) in read order)
    and re-encoded; the token partitions are kept as they are."""
    assert data[12:16] == b"VP8 "
    vp8 = data[20:20 + int.from_bytes(data[16:20], "little")]
    part0 = int.from_bytes(vp8[0:3], "little") >> 5
    seen = []
    orig = webp._BoolDecoder.bit

    def spy(self, prob):
        bit = orig(self, prob)
        if self.end == 10 + part0 and self.data is vp8:
            seen.append((prob, bit))
        return bit

    webp._BoolDecoder.bit = spy
    try:
        webp._vp8_rgb(vp8, None)
    finally:
        webp._BoolDecoder.bit = orig
    enc = _BoolEncoder()
    for prob, bit in edit(seen):
        enc.put(prob, bit)
    new0 = enc.flush()
    tag = int.from_bytes(vp8[0:3], "little") & 0x1F | (len(new0) << 5)
    body = tag.to_bytes(3, "little") + vp8[3:10] + new0 + vp8[10 + part0:]
    chunk = b"VP8 " + len(body).to_bytes(4, "little") + body + b"\x00" * (len(body) & 1)
    return b"RIFF" + (4 + len(chunk)).to_bytes(4, "little") + b"WEBP" + chunk


def _header_layout(seen):
    """The indices in partition 0's decisions of the segment flag and the
    filter header's fields (simple, level's 6 bits, sharpness's 3 bits),
    for a file without segments... or with them (Pillow writes segments)."""
    i = 2  # colour space, clamping type
    use_segment = seen[i][1]
    i += 1
    if use_segment:
        update_map = seen[i][1]
        i += 1
        update_data = seen[i][1]
        i += 1
        if update_data:
            i += 1  # absolute delta
            for bits in (7, 6):
                for _ in range(4):
                    present = seen[i][1]
                    i += 1 + (bits + 1 if present else 0)
        if update_map:
            for _ in range(3):
                present = seen[i][1]
                i += 1 + (8 if present else 0)
    return {"simple": i, "level": i + 1, "sharpness": i + 7}


@pytest.mark.parametrize("change", ["simple filter", "sharpness 3", "sharpness 7",
                                    "simple filter, sharpness 5"])
def test_recoded_filter_headers_decode_as_pillow(change):
    """The simple loop filter and the sharpness levels, which libwebp's
    encoder (Pillow's) never writes at its defaults: partition 0 re-coded
    with those fields changed, decoded by libwebp as the oracle."""
    for quality, seed in ((30, 20), (75, 21)):
        data = _webp(PIL.Image.fromarray(photo(48, 40, seed)), quality=quality)

        def edit(seen):
            at = _header_layout(seen)
            out = list(seen)
            if "simple" in change:
                out[at["simple"]] = (out[at["simple"]][0], 1)
            if "sharpness" in change:
                value = int(change.split()[-1])
                for k in range(3):
                    p = out[at["sharpness"] + k][0]
                    out[at["sharpness"] + k] = (p, (value >> (2 - k)) & 1)
            return out

        recoded = _recode_partition0(data, edit)
        hd = webp._VP8Header(recoded[20:])
        assert hd.filter_type == (1 if "simple" in change else 2)
        _assert_as_pillow(recoded)


# ---------------------------------------------------------------------------
# bad data
# ---------------------------------------------------------------------------

def _mutants(data: bytes, seed: int, n: int):
    rng = np.random.RandomState(seed)
    out = [data[:k] for k in range(0, len(data), max(1, len(data) // 60))]
    for _ in range(n):
        d = bytearray(data)
        d[rng.randint(len(d))] = rng.randint(256)
        out.append(bytes(d))
    for _ in range(n // 4):
        d = bytearray(data)
        i = rng.randint(len(d))
        del d[i:i + rng.randint(1, 4)]
        out.append(bytes(d))
    return out


def _files():
    img = PIL.Image.fromarray(photo(20, 28, 13))
    buf = io.BytesIO()
    img.save(buf, "WEBP", save_all=True, append_images=[PIL.Image.fromarray(photo(20, 28, 14))],
             duration=100, quality=80)
    return {"lossless": _webp(img, lossless=True), "lossy": _webp(img, quality=70),
            "lossy alpha": _webp(_rgba(20, 28, 15), quality=70),
            "lossless alpha": _webp(_rgba(20, 28, 16), lossless=True),
            "animation": buf.getvalue()}


@pytest.mark.parametrize("kind", ["lossless", "lossy", "lossy alpha", "lossless alpha",
                                  "animation"])
def test_bad_data_fails_wherever_pillow_fails(kind):
    """Truncations, flipped and deleted bytes over every chunk: where
    Pillow fails the port raises ValueError, and where Pillow decodes the
    port decodes the same."""
    data = _files()[kind]
    counts = {"both fail": 0, "both decode": 0, "port fails": 0}
    for bad in _mutants(data, len(data), 120):
        want = _pillow(bad)
        try:
            got = webp_decode_rgb(bad)
        except ValueError:
            got = None
        if want is None:
            assert got is None, "Pillow fails a file the port decodes"
            counts["both fail"] += 1
        elif got is None:
            counts["port fails"] += 1
        else:
            np.testing.assert_array_equal(got, want)
            counts["both decode"] += 1
    assert counts["both fail"] > 20 and counts["both decode"] > 10, counts


def test_a_canvas_pillow_refuses_as_a_bomb_raises():
    """Pillow's Image.open refuses more than 2 x MAX_IMAGE_PIXELS pixels."""
    data = bytearray(_files()["animation"])
    at = data.index(b"VP8X") + 8
    data[at + 4:at + 10] = (30000).to_bytes(3, "little") + (9999).to_bytes(3, "little")
    assert _pillow(bytes(data)) is None
    with pytest.raises(ValueError, match="more pixels than Pillow opens"):
        webp_decode_rgb(bytes(data))


# ---------------------------------------------------------------------------
# the host C++ twin (ops/csrc/webp_decode.cpp)
# ---------------------------------------------------------------------------

def _both(data):
    out = []
    for route in (False, True):
        try:
            out.append(webp_decode_rgb(data, host_cpp=route))
        except (ValueError, MemoryError) as e:
            out.append(str(e))
    return out


def test_the_c_decode_is_the_python_decode(native):  # noqa: F811
    """Every fixture, lossless and lossy files at every method, palettes,
    alpha and the re-coded simple-filter file: the C++ equals the Python
    decoder bit for bit."""
    files = [open(p, "rb").read() for p in sorted(glob.glob(os.path.join(
        HERE, "fixtures", "torch_image_kinds", "*.webp")))]
    img = PIL.Image.fromarray(photo(40, 56, 17))
    for method in range(7):
        files.append(_webp(img, lossless=True, method=method))
        files.append(_webp(img, quality=15 * method + 5, method=method))
    for colors in (2, 4, 16):
        files.append(_webp(img.convert("P", palette=PIL.Image.ADAPTIVE, colors=colors)
                           .convert("RGB").crop((1, 1, 38, 30)), lossless=True))
    files += list(_files().values())
    files.append(_recode_partition0(_webp(img, quality=40), lambda seen: [
        (p, 1) if i == _header_layout(seen)["simple"] else (p, b)
        for i, (p, b) in enumerate(seen)]))
    assert len(files) > 30
    for data in files:
        a, b = _both(data)
        assert not isinstance(a, str)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["lossless", "lossy", "lossy alpha", "animation"])
def test_the_c_decode_fails_as_the_python_decode_on_bad_data(kind, native):  # noqa: F811
    data = _files()[kind]
    kinds_ = {True: 0, False: 0}
    for bad in _mutants(data, len(data) + 1, 150):
        a, b = _both(bad)
        if isinstance(a, str) or isinstance(b, str):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
        kinds_[not isinstance(a, str)] += 1
    assert kinds_[True] > 10 and kinds_[False] > 20, kinds_
