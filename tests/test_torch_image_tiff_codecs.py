"""TIFF's other codecs in the port's image reader (ROADMAP item 28.7):
CCITT with the uncompressed-mode bit and CCITT RLEW (utils/ccitt.py),
ThunderScan, LZMA and ZSTD (utils/tiff.py, utils/zstd.py) and old-style JPEG
(utils/ojpeg.py), with faults C.15 (a modified-Huffman strip's last row) and
C.14's short 8-bit PCX read from its path, each held bit for bit to Pillow
12.1's ``Image.open(f).convert("RGB")`` (libtiff 4.7.1, libzstd 1.5.7,
liblzma) on files written here, and fuzzed to its failures. Pillow writes
the LZMA and ZSTD files; tests/image_format_encoders.py the CCITT,
ThunderScan and layouts Pillow does not; the ZSTD frames Pillow's writer
never makes (RLE literals and code tables, single-segment frames, XXH64
checksums) are put together here by hand and held to Pillow all the same.

Where libtiff leaves part of Pillow's strip buffer unwritten (a group 4
strip that ends early), Pillow's image holds uninitialised memory there;
the port fails such a file, and the tests check only that Pillow read it."""

from __future__ import annotations

import hashlib
import io
import json
import lzma
import os
import struct
import tempfile
import warnings

import numpy as np
import PIL.Image
import pytest

from image_format_encoders import ccitt, thunderscan, tiff
from latent2im_tpu_torch.utils import image as im
from latent2im_tpu_torch.utils import tiff as tiffmod
from latent2im_tpu_torch.utils import zstd as zstdmod

HERE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_image_tiff_codecs")


def _pillow(data: bytes):
    """Pillow's decode of the file opened by its path, as the JAX package
    opens every image."""
    with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        path = os.path.join(d, "image")
        with open(path, "wb") as f:
            f.write(data)
        try:
            with PIL.Image.open(path) as img:
                return np.asarray(img.convert("RGB"))
        except Exception:
            return None


def _agree(data: bytes) -> str:
    """The port decodes the file as Pillow does, or fails where Pillow
    fails -> "read", "fail", or "undefined" (Pillow reads uninitialised
    memory, the port fails)."""
    want = _pillow(data)
    try:
        got = tiffmod.tiff_decode_rgb(data)
    except ValueError as e:
        if "uninitialised" in str(e):
            assert want is not None, str(e)
            return "undefined"
        assert want is None, str(e)
        return "fail"
    assert want is not None, "the port reads a file Pillow fails"
    np.testing.assert_array_equal(got, want)
    return "read"


def _mutated(rng, c: bytes) -> bytes:
    """c with bits flipped, a byte set, bytes inserted or deleted, or cut."""
    c = bytearray(c)
    k = rng.randint(5)
    if not c:
        return bytes(c)
    i = rng.randint(len(c))
    if k == 0:
        for _ in range(rng.randint(1, 4)):
            j = rng.randint(len(c))
            c[j] ^= 1 << rng.randint(8)
    elif k == 1:
        c = c[:i]
    elif k == 2:
        c[i:i] = bytes(rng.randint(0, 256, rng.randint(1, 4)).astype(np.uint8))
    elif k == 3:
        c[i] = rng.randint(256)
    else:
        del c[i:i + rng.randint(1, 4)]
    return bytes(c)


# ---------------------------------------------------------------------------
# CCITT: C.15, the uncompressed-mode bit, extension codes, RLEW
# ---------------------------------------------------------------------------

# (compression, 1D rows every that many in 2D coding, tags): the four modes
# of ROADMAP C.15's sweep and the uncompressed-mode bit (T4Options or
# T6Options value 2) in group 3 1D, group 3 2D and group 4
CCITT_MODES = {"mh": (2, 0, {}), "g3_1d": (3, 0, {}), "g3_2d": (3, 3, {292: (4, [1])}),
               "g4": (4, 0, {}), "rlew": (32771, 0, {})}
UNCOMPRESSED_BIT = {"g3_1d": (3, 0, {292: (4, [2])}), "g3_2d": (3, 3, {292: (4, [3])}),
                    "g4": (4, 0, {293: (4, [2])})}


def _ccitt_file(black, comp, every, tags, bo="<", fill=1, **kw) -> bytes:
    """A bilevel TIFF (photometric 0, black 1) of rows ``black`` coded by
    tests/image_format_encoders.py:ccitt, strip by strip or tile by tile."""
    def enc(b, w=kw.get("tile", (black.shape[1],))[0]):
        rows = np.unpackbits(np.frombuffer(b, np.uint8)).reshape(-1, -(-w // 8) * 8)[:, :w]
        code = ccitt(rows, comp, every)
        return bytes(int(f"{x:08b}"[::-1], 2) for x in code) if fill == 2 else code

    return tiff(np.asarray(black)[..., None], 1, 0, bo, comp, encode_chunk=enc, tags=tags,
                fill=fill, **kw)


def test_c15_modified_huffman_strip_ends_with_libtiffs_white_row():
    """ROADMAP C.15: where the data ends at the last row's code, libtiff's
    bit reader makes up the bits asked for with zeros and counts them as
    held, so the row's byte alignment then drops a bit of the next row's
    code: from two rows on, the last decodes white (the fixture is the 8 x 3
    reproducer, every row's code the byte b6)."""
    with open(os.path.join(HERE, "ccitt_c15_mh_8x3.tif"), "rb") as f:
        data = f.read()
    got = tiffmod.tiff_decode_rgb(data)
    np.testing.assert_array_equal(got, _pillow(data))
    assert (got[-1] == 255).all() and (got[0, :4] == 255).all() and (got[0, 4:] == 0).all()
    for h in range(1, 6):
        black = np.tile(np.array([0, 0, 0, 0, 1, 1, 1, 1], np.uint8), (h, 1))
        assert _agree(_ccitt_file(black, 2, 0, {})) == "read"


@pytest.mark.parametrize("mode", ["mh", "g3_1d", "g3_2d", "g4"])
def test_the_ccitt_sweep_of_432_small_images_is_libtiffs(mode):
    """ROADMAP C.15's sweep: 432 random images a mode (widths 1-24, heights
    2, 3 and 7, six each), written by tests/image_format_encoders.py:ccitt,
    all as Pillow decodes them."""
    comp, every, tags = CCITT_MODES[mode]
    rng = np.random.RandomState(432)
    n = 0
    for w in range(1, 25):
        for h in (2, 3, 7):
            for k in range(6):
                black = (rng.rand(h, w) < (0.1, 0.3, 0.5, 0.7, 0.9, 0.5)[k]).astype(np.uint8)
                assert _agree(_ccitt_file(black, comp, every, tags)) == "read", (w, h, k)
                n += 1
    assert n == 432


@pytest.mark.parametrize("mode", sorted(UNCOMPRESSED_BIT))
def test_the_uncompressed_mode_bit_decodes_as_pillow(mode):
    """T4Options or T6Options with uncompressed mode allowed: libtiff
    decodes such a strip as any other (it reads no uncompressed data)."""
    comp, every, tags = UNCOMPRESSED_BIT[mode]
    rng = np.random.RandomState(2)
    for h, w, kw in ((9, 77, {}), (13, 40, {"rps": 5}), (11, 30, {"tile": (32, 16)})):
        black = (rng.rand(h, w) > 0.5).astype(np.uint8)
        black[:, w // 2:] = black[:, w // 2:w // 2 + 1]
        data = _ccitt_file(black, comp, every, tags, **kw)
        assert _agree(data) == "read"
        np.testing.assert_array_equal(tiffmod.tiff_decode_rgb(data)[..., 0], (1 - black) * 255)


@pytest.mark.parametrize("mode", sorted(UNCOMPRESSED_BIT))
def test_an_extension_code_ends_its_row_as_libtiff_does(mode):
    """An extension code (uncompressed mode, 0000001 in a 2D row): libtiff
    reports the error, writes the row white from there and decodes on; the
    strip does not fail."""
    comp, every, tags = UNCOMPRESSED_BIT[mode]
    rng = np.random.RandomState(3)
    black = (rng.rand(6, 20) > 0.5).astype(np.uint8)
    code = ccitt(black, comp, every)
    read = 0
    for at in range(1, min(len(code), 12)):
        for ext in (b"\x02", b"\x02\x0f", b"\x00\x02"):
            data = tiff(black[..., None], 1, 0, "<", comp, tags=tags,
                        encode_chunk=lambda b, c=code[:at] + ext + code[at:]: c)
            read += _agree(data) == "read"
    assert read > 5


@pytest.mark.parametrize("form", ["strips", "one_strip", "tiles", "fill_order_2", "big_endian",
                                  "wide"])
def test_rlew_decodes_as_pillow(form):
    """CCITT RLEW (32771): modified Huffman, each row written from a 16-bit
    word boundary (tests/image_format_encoders.py:ccitt). libtiff's decoder
    cuts the bits it holds after a row to a whole 16 bits, then skips a
    byte where it holds none and the next lies at an odd file offset: bits
    of the next row it has read ahead are lost with them, so such files do
    not decode to the rows written, in Pillow or in the port."""
    rng = np.random.RandomState(32771)
    h, w = (9, 300) if form == "wide" else (13, 37)
    black = (rng.rand(h, w) > 0.6).astype(np.uint8)
    kw = {"strips": {"rps": 4}, "one_strip": {}, "tiles": {"tile": (48, 16)},
          "fill_order_2": {"rps": 5, "fill": 2, "tags": {266: (3, [2])}},
          "big_endian": {"rps": 3, "bo": ">"}, "wide": {"rps": 2}}[form]
    tags = kw.pop("tags", {})
    data = _ccitt_file(black, 32771, 0, tags, **kw)
    assert _agree(data) == "read"


def test_ccitt_fuzz_decodes_or_fails_as_pillow():
    """600 seeded files, RLEW, the uncompressed-mode bit's three forms and
    modified Huffman, one to three strips, their codes with bits flipped,
    bytes set, inserted or deleted, or cut: each decodes as Pillow does or
    fails where Pillow fails (or leaves Pillow's buffer uninitialised)."""
    rng = np.random.RandomState(600)
    modes = [CCITT_MODES["rlew"], CCITT_MODES["mh"], *UNCOMPRESSED_BIT.values()]
    seen = {"read": 0, "fail": 0, "undefined": 0}
    for i in range(600):
        comp, every, tags = modes[i % len(modes)]
        h, w = rng.randint(1, 12), rng.randint(1, 40)
        black = (rng.rand(h, w) > rng.choice([0.1, 0.5, 0.9])).astype(np.uint8)

        def enc(b, w=w):
            rows = np.unpackbits(np.frombuffer(b, np.uint8)).reshape(-1, -(-w // 8) * 8)[:, :w]
            return _mutated(rng, ccitt(rows, comp, every))

        data = tiff(black[..., None], 1, 0, "<", comp, encode_chunk=enc, tags=tags,
                    rps=int(rng.choice([h, max(1, h // 3)])))
        seen[_agree(data)] += 1
    assert seen["read"] > 300 and seen["fail"] > 20, seen


# ---------------------------------------------------------------------------
# ThunderScan
# ---------------------------------------------------------------------------

def _thunder_file(v, bo="<", photo=1, runs_to_the_end=False, raw_only=False, **kw) -> bytes:
    w = v.shape[1]

    def enc(b):
        rows = np.unpackbits(np.frombuffer(b, np.uint8)).reshape(-1, -(-w * 4 // 8) * 8)
        vals = (rows[:, :w * 4].reshape(-1, w, 4) * np.array([8, 4, 2, 1])).sum(-1)
        return thunderscan(vals, runs_to_the_end, raw_only)

    return tiff(v[..., None], 4, photo, bo, 32809, encode_chunk=enc, **kw)


def _thunder_image(rng, h, w):
    v = np.clip(np.cumsum(rng.randint(-1, 2, (h, w)), 1) + 8, 0, 15)
    v[:, w // 3:w // 2] = v[:, w // 3:w // 3 + 1]
    v[::3, -5:] = rng.randint(0, 16, (len(v[::3]), min(w, 5)))
    return v


@pytest.mark.parametrize("form", ["gray", "white_is_zero", "palette", "big_endian", "strips",
                                  "runs_to_the_end", "raw_only"])
def test_thunderscan_decodes_as_pillow(form):
    """ThunderScan (32809): 4-bit rows of runs of the last pixel, three
    2-bit deltas, two 3-bit deltas and raw pixels (the writer's codes cover
    all four), as libtiff's tif_thunder.c reads them."""
    rng = np.random.RandomState(32809)
    v = _thunder_image(rng, 13, 45)
    kw = {"gray": {}, "white_is_zero": {"photo": 0}, "big_endian": {"bo": ">"},
          "palette": {"photo": 3, "cmap": rng.randint(0, 65536, 48)},
          "strips": {"rps": 4}, "runs_to_the_end": {"runs_to_the_end": True, "rps": 6},
          "raw_only": {"raw_only": True}}[form]
    data = _thunder_file(v, **kw)
    codes = thunderscan(v, kw.get("runs_to_the_end", False), kw.get("raw_only", False))
    kinds = {c & 0xC0 for c in codes}
    assert kinds == ({0xC0} if form == "raw_only" else {0, 0x40, 0x80, 0xC0}), kinds
    assert _agree(data) == "read"
    if form in ("gray", "strips", "raw_only", "runs_to_the_end"):
        np.testing.assert_array_equal(tiffmod.tiff_decode_rgb(data)[..., 0], v * 17)


def test_thunderscan_tiles_and_other_depths_fail_as_pillow_fails():
    """libtiff decodes no ThunderScan tiles, nor a depth other than 4."""
    rng = np.random.RandomState(4)
    v = _thunder_image(rng, 13, 11)
    assert _agree(tiff(v[..., None], 4, 1, "<", 32809, tile=(16, 16),
                       encode_chunk=lambda b: thunderscan(np.zeros((16, 16), int)))) == "fail"
    assert _agree(tiff(rng.randint(0, 256, (5, 6, 1)), 8, 1, "<", 32809,
                       encode_chunk=lambda b: bytes(len(b)))) == "fail"


def test_thunderscan_fuzz_decodes_or_fails_as_pillow():
    """400 seeded ThunderScan files with their codes fuzzed."""
    rng = np.random.RandomState(401)
    seen = {"read": 0, "fail": 0, "undefined": 0}
    for i in range(400):
        h, w = rng.randint(1, 10), rng.randint(1, 30)
        v = _thunder_image(rng, h, w) if rng.rand() < 0.5 else rng.randint(0, 16, (h, w))

        def enc(b, w=w):
            rows = np.unpackbits(np.frombuffer(b, np.uint8)).reshape(-1, -(-w * 4 // 8) * 8)
            vals = (rows[:, :w * 4].reshape(-1, w, 4) * np.array([8, 4, 2, 1])).sum(-1)
            return _mutated(rng, thunderscan(vals, rng.rand() < 0.2))

        data = tiff(v[..., None], 4, int(rng.choice([0, 1])), "<", 32809, encode_chunk=enc,
                    rps=int(rng.choice([h, max(1, h // 2)])))
        seen[_agree(data)] += 1
    assert seen["read"] > 100 and seen["fail"] > 100, seen


# ---------------------------------------------------------------------------
# LZMA
# ---------------------------------------------------------------------------

def _xz(b: bytes, check=lzma.CHECK_CRC64) -> bytes:
    return lzma.compress(b, format=lzma.FORMAT_XZ, check=check)


def _xz_broken_at(b: bytes, k: int) -> bytes:
    """An xz stream with a bit of its byte k flipped (k < 0: in its block's
    check, its index or its footer, which liblzma reads in the call that
    writes the data's last bytes; stdlib lzma fails such a stream)."""
    x = bytearray(_xz(b))
    x[k] ^= 0x40
    return bytes(x)


@pytest.mark.parametrize("form", ["pillow_rgb", "pillow_l", "pillow_predictor", "rgb_le_strips",
                                  "rgb_be_tiles", "g16_be_predictor", "g32_le_predictor",
                                  "float_predictor_3_be", "checks", "broken_after_the_strip"])
def test_lzma_decodes_as_pillow(form):
    """LZMA (34925) through stdlib lzma's liblzma: its xz stream decoder
    until the strip's bytes are out (an error it reports once they are is
    ignored), then libtiff's predictors and byte order."""
    rng = np.random.RandomState(34925)
    photo = np.clip(np.cumsum(rng.randint(-4, 5, (21, 37, 3)), 1) + 128, 0, 255).astype(np.uint8)
    if form.startswith("pillow"):
        img = PIL.Image.fromarray(photo).convert("L" if form == "pillow_l" else "RGB")
        buf = io.BytesIO()
        img.save(buf, "TIFF", compression="lzma",
                 **({"tiffinfo": {317: 2}} if form == "pillow_predictor" else {}))
        data = buf.getvalue()
    elif form == "rgb_le_strips":
        data = tiff(photo, 8, 2, "<", 34925, rps=5, encode_chunk=_xz)
    elif form == "rgb_be_tiles":
        data = tiff(photo, 8, 2, ">", 34925, tile=(16, 16), encode_chunk=_xz)
    elif form == "g16_be_predictor":
        data = tiff(rng.randint(0, 65536, (21, 37, 1)), 16, 1, ">", 34925, rps=4, predictor=2,
                    encode_chunk=_xz)
    elif form == "g32_le_predictor":
        data = tiff(rng.randint(0, 1 << 31, (21, 37, 1)), 32, 1, "<", 34925, rps=4,
                    predictor=2, encode_chunk=_xz)
    elif form == "float_predictor_3_be":
        data = tiff((rng.rand(21, 37, 1) * 300 - 20).astype(np.float32), 32, 1, ">", 34925,
                    sample_format=3, predictor=3, rps=7, encode_chunk=_xz)
    elif form == "checks":  # every integrity check liblzma has
        chunks = iter([lzma.CHECK_NONE, lzma.CHECK_CRC32, lzma.CHECK_CRC64, lzma.CHECK_SHA256,
                       lzma.CHECK_CRC32])
        data = tiff(photo, 8, 2, "<", 34925, rps=5, encode_chunk=lambda b: _xz(b, next(chunks)))
    else:  # each strip's stream broken in its check, its index or its footer
        at = iter([-1, -3, -8, -13, -20, -30])
        data = tiff(photo, 8, 2, "<", 34925, rps=4,
                    encode_chunk=lambda b: _xz_broken_at(b, next(at)))
        with pytest.raises(lzma.LZMAError):
            lzma.decompress(_xz_broken_at(photo.tobytes(), -1))
    assert _agree(data) == "read"


def test_lzma_fuzz_decodes_or_fails_as_pillow():
    """400 seeded LZMA files, strips and tiles, their xz streams fuzzed: each
    decodes as Pillow does or fails where Pillow fails (the data after a
    strip's bytes is not read, as libtiff does not, and an error liblzma
    reports in the call that writes the strip's last bytes is ignored)."""
    rng = np.random.RandomState(402)
    seen = {"read": 0, "fail": 0, "undefined": 0}
    for i in range(400):
        h, w = rng.randint(1, 20), rng.randint(1, 20)
        img = np.clip(np.cumsum(rng.randint(-3, 4, (h, w, 3)), 1) + 100, 0, 255)
        kw = {"tile": (16, 16)} if i % 4 == 0 else {"rps": int(rng.choice([h, max(1, h // 2)]))}
        data = tiff(img, 8, 2, "<>"[i % 2], 34925, predictor=1 + (i % 3 == 0),
                    encode_chunk=lambda b: _mutated(rng, _xz(b)), **kw)
        seen[_agree(data)] += 1
    assert seen["read"] > 40 and seen["fail"] > 200, seen


def test_lzma_fails_loudly_where_liblzma_cannot_be_loaded(monkeypatch):
    """Without liblzma an LZMA TIFF raises RuntimeError, not the ValueError
    of a file Pillow fails."""
    def no_library(name, *args, **kw):
        raise OSError(f"{name}: cannot open shared object file")

    data = tiff(np.zeros((3, 5, 1), np.uint8), 8, 1, "<", 34925, encode_chunk=_xz)
    tiffmod._liblzma.cache_clear()
    monkeypatch.setattr(tiffmod.ctypes, "CDLL", no_library)
    try:
        with pytest.raises(RuntimeError, match="liblzma"):
            tiffmod.tiff_decode_rgb(data)
    finally:
        tiffmod._liblzma.cache_clear()


# ---------------------------------------------------------------------------
# ZSTD
# ---------------------------------------------------------------------------

def _zstd_frame(content: bytes) -> bytes:
    """Pillow's ZSTD strip of ``content`` (a one-row 8-bit image)."""
    buf = io.BytesIO()
    PIL.Image.fromarray(np.frombuffer(content, np.uint8)[None], "L").save(
        buf, "TIFF", compression="zstd", strip_size=1 << 24)
    data = buf.getvalue()
    _, t = tiffmod._tags(data)
    return data[t[273][0]:t[273][0] + t[279][0]]


def _hand_frame(blocks, content: bytes, single: bool = False, checksum: bool = False,
                window: int = 0x00, fhd_extra: int = 0, dict_id: bytes = b"") -> bytes:
    """A frame of the given blocks ((type, body, size) each, the last one
    marked): a window descriptor byte, or single-segment with a one-byte
    content size; an XXH64 checksum where asked."""
    fhd = (0x20 if single else 0) | (0x04 if checksum else 0) | fhd_extra
    out = struct.pack("<I", 0xFD2FB528) + bytes([fhd])
    out += bytes([len(content)]) if single else bytes([window])
    out += dict_id
    for i, (kind, body, size) in enumerate(blocks):
        head = (size << 3) | (kind << 1) | (i == len(blocks) - 1)
        out += head.to_bytes(3, "little") + body
    if checksum:
        out += struct.pack("<I", zstdmod.xxh64(content) & 0xFFFFFFFF)
    return out


def _abc_block() -> bytes:
    """A compressed block of raw literals "abc" and one sequence (3
    literals, a match of 9 at offset 3) over RLE code tables: "abc" x 4."""
    seq = bytes([1, 0x54, 3, 2, 6, 0b110])  # LL 3, OF code 2 (+2), ML code 6; bits "10"
    return bytes([3 << 3]) + b"abc" + seq


HAND_FRAMES = {
    # RLE literals ("x" x 20, no sequences), RLE code tables, single segment,
    # XXH64 checksums, an RLE block, a raw block, a window of 2 KiB
    "literals: RLE": (_hand_frame([(2, bytes([(20 << 3) | 1]) + b"x" + b"\0", 3)],
                                  b"x" * 20, window=0x08), b"x" * 20),
    "RLE code tables": (_hand_frame([(2, _abc_block(), len(_abc_block()))], b"abc" * 4),
                        b"abc" * 4),
    "single segment, checksum": (_hand_frame([(2, _abc_block(), len(_abc_block()))],
                                             b"abc" * 4, single=True, checksum=True),
                                 b"abc" * 4),
    "streamed checksum": (_hand_frame([(1, b"q", 30), (0, b"rawbytes", 8)],
                                      b"q" * 30 + b"rawbytes", checksum=True),
                          b"q" * 30 + b"rawbytes"),
}


def _pool() -> dict:
    """Pillow-written frames of varied content -> (frame, content): random,
    constant, random walks, text, repeats, sparse data, small and large
    literal sections, blocks past 128 KiB, whose paths through the decoder
    between them cover every block, literal and sequence mode Pillow's
    writer (libzstd's level 3) makes."""
    rng = np.random.RandomState(50000)
    out = {
        "random": rng.randint(0, 256, 5000).astype(np.uint8).tobytes(),
        "constant": bytes(3000),
        "constant_past_a_block": bytes([7]) * 300000,
        "walk": (np.cumsum(rng.randint(-2, 3, 600)) % 256).astype(np.uint8).tobytes(),
        "walk_past_a_block": (np.cumsum(rng.randint(-2, 3, 200000)) % 256).astype(
            np.uint8).tobytes(),
        "two_symbols": bytes(rng.choice([0, 255], 4000).astype(np.uint8)),
        "sparse": bytes((rng.rand(400000) < 0.02).astype(np.uint8)
                        * rng.randint(1, 4, 400000).astype(np.uint8)),
    }
    words = [bytes(rng.randint(65, 70, 8).astype(np.uint8)) for _ in range(4)]
    out["words"] = b"".join(b"Q" + words[rng.randint(4)] for _ in range(20000))
    chunks = [bytes(rng.randint(0, 256, 16).astype(np.uint8)) for _ in range(64)]
    head = b"".join(chunks) + bytes(rng.choice(list(b"ABCD"), 131072 - 1024).astype(np.uint8))
    out["few_literals_past_a_block"] = head + b"".join(
        bytes(rng.choice(list(b"ABCD"), 3).astype(np.uint8)) + chunks[rng.randint(64)]
        for _ in range(60))
    yy, xx = np.mgrid[:300, :300]
    out["photo"] = np.clip(128 + 60 * np.sin(xx / 17.0) * np.cos(yy / 23.0)
                           + rng.randn(300, 300) * 4, 0, 255).astype(np.uint8).tobytes()
    return {k: (_zstd_frame(v), v) for k, v in out.items()}


POOL = _pool()
# the paths of utils/zstd.py each case must reach (RFC 8878's block,
# literal and sequence modes; libzstd's two Huffman decoders and its fast
# 4-stream loop)
ZSTD_PATHS = [
    "raw block", "RLE block", "compressed block", "literals: raw", "literals: RLE",
    "literals: Huffman, 1 stream", "literals: Huffman, 4 streams",
    "literals: Huffman, 4 streams, double-symbol table", "literals: treeless, 4 streams",
    "literals: treeless, 1 stream, double-symbol table",
    "literals: libzstd's fast 4-stream loop",
    "literal length codes: predefined", "literal length codes: RLE", "literal length codes: FSE",
    "literal length codes: repeat", "offset codes: predefined", "offset codes: RLE",
    "offset codes: FSE", "offset codes: repeat", "match length codes: predefined",
    "match length codes: RLE", "match length codes: FSE", "match length codes: repeat",
    "repeat offsets", "sequences: none", "streamed frame, window descriptor",
    "streamed frame, single segment", "single-pass frame (content size stated)",
    "XXH64 checksum"]


def _paths(frame: bytes, need: int, content: bytes) -> set:
    zstdmod.PATHS = paths = set()
    try:
        out, err = zstdmod.zstd_stream(frame, need)
    finally:
        zstdmod.PATHS = None
    assert err is None and out == content[:need], err
    return paths


def test_the_zstd_pool_reaches_each_path():
    """Which paths each Pillow-written frame reaches (recorded here): the
    pool and the hand-made frames between them reach every path named."""
    reached = {k: _paths(f, len(c), c) for k, (f, c) in POOL.items()}
    assert "sequences: none" in reached["photo"] and "raw block" in reached["random"]
    assert "RLE block" in reached["constant_past_a_block"]
    assert "literals: Huffman, 1 stream" in reached["two_symbols"]
    assert "literals: treeless, 4 streams" in reached["sparse"]
    assert "literal length codes: RLE" in reached["words"]
    assert "literals: treeless, 1 stream, double-symbol table" in reached[
        "few_literals_past_a_block"]
    for name, (frame, content) in HAND_FRAMES.items():
        reached[name] = _paths(frame, len(content), content)
    # a single-segment frame the output can hold goes through the single-pass decoder
    frame, content = HAND_FRAMES["single segment, checksum"]
    reached["single segment, streamed"] = _paths(frame, len(content) - 1, content)
    missing = set(ZSTD_PATHS) - set().union(*reached.values())
    assert not missing, missing


@pytest.mark.parametrize("path", ZSTD_PATHS)
def test_the_zstd_decoder_takes_each_path_as_pillow(path):
    """Every frame that reaches the path, in a TIFF strip (a one-row image
    of its content), decodes as Pillow decodes it."""
    frames = dict(POOL)
    frames.update(HAND_FRAMES)
    n = 0
    for name, (frame, content) in frames.items():
        need = len(content)
        if path == "streamed frame, single segment":
            need -= 1
        if path not in _paths(frame, need, content):
            continue
        img = np.frombuffer(content[:need], np.uint8)[None, :, None]
        data = tiff(img, 8, 1, "<", 50000, encode_chunk=lambda b: frame)
        assert _agree(data) == "read", name
        n += 1
    assert n, path


@pytest.mark.parametrize("form", ["pillow_rgb", "pillow_predictor", "pillow_big_strip",
                                  "be_tiles", "g16_be_predictor", "float_predictor_3",
                                  "planar"])
def test_zstd_tiffs_decode_as_pillow(form):
    """ZSTD (50000) TIFFs: Pillow's own, and layouts written here with
    Pillow's frames of their strips or tiles: both byte orders, tiles,
    planar, predictors 2 and 3."""
    rng = np.random.RandomState(50001)
    photo = np.clip(np.cumsum(rng.randint(-4, 5, (40, 53, 3)), 1) + 128, 0, 255).astype(np.uint8)
    if form.startswith("pillow"):
        buf = io.BytesIO()
        kw = {"tiffinfo": {317: 2}} if form == "pillow_predictor" else {}
        if form == "pillow_big_strip":  # one strip of several blocks
            photo = np.repeat(np.repeat(photo, 3, 0), 3, 1)
            kw = {"strip_size": 1 << 20}
        PIL.Image.fromarray(photo).save(buf, "TIFF", compression="zstd", **kw)
        data = buf.getvalue()
    elif form == "be_tiles":
        data = tiff(photo, 8, 2, ">", 50000, tile=(16, 32), encode_chunk=_zstd_frame)
    elif form == "g16_be_predictor":
        data = tiff(rng.randint(0, 65536, (21, 37, 1)), 16, 1, ">", 50000, rps=4, predictor=2,
                    encode_chunk=_zstd_frame)
    elif form == "float_predictor_3":
        data = tiff((rng.rand(21, 37, 1) * 300 - 20).astype(np.float32), 32, 1, "<", 50000,
                    sample_format=3, predictor=3, rps=7, encode_chunk=_zstd_frame)
    else:
        data = tiff(photo, 8, 2, "<", 50000, planar=2, rps=16, encode_chunk=_zstd_frame)
    assert _agree(data) == "read"


def test_zstd_frame_headers_and_checksums_as_libzstd():
    """What libzstd fails in a frame: a wrong checksum, the reserved bit, a
    dictionary ID, a window past 2^27 + 1 bytes; what it reads: a window
    descriptor of any size the frame fits, a checksum it cannot reach."""
    content = b"abc" * 4
    block = [(2, _abc_block(), len(_abc_block()))]
    good = _hand_frame(block, content, checksum=True)
    bad = good[:-1] + bytes([good[-1] ^ 1])
    cases = {"good": (good, "read"), "bad_checksum": (bad, "fail"),
             "reserved": (_hand_frame(block, content, fhd_extra=0x08), "fail"),
             "dictionary": (_hand_frame(block, content, fhd_extra=0x01, dict_id=b"\x07"),
                            "fail"),
             "window_too_large": (_hand_frame(block, content, window=(18 << 3)), "fail"),
             "window_2_kib": (_hand_frame(block, content, window=0x08), "read"),
             "window_1_5_gib": (_hand_frame(block, content, window=(20 << 3) | 4), "fail"),
             "single_segment_bad_checksum": (
                 _hand_frame(block, content, single=True, checksum=True)[:-1] + b"\0", "fail")}
    for name, (frame, outcome) in cases.items():
        img = np.frombuffer(content, np.uint8)[None, :, None]
        data = tiff(img, 8, 1, "<", 50000, encode_chunk=lambda b, f=frame: f)
        assert _agree(data) == outcome, name
    # the strip ends before the frame does: the checksum is not reached
    img = np.frombuffer(content[:10], np.uint8)[None, :, None]
    data = tiff(img, 8, 1, "<", 50000, encode_chunk=lambda b: bad)
    assert _agree(data) == "read"


def test_zstd_fuzz_of_2000_files_decodes_or_fails_as_pillow():
    """2000 seeded ZSTD TIFFs (one strip of a pool frame, the strip's size
    sometimes other than the frame's content) with the frame fuzzed: each
    decodes as Pillow does or fails where Pillow fails."""
    rng = np.random.RandomState(2000)
    frames = [(f, c) for f, c in list(POOL.values()) + list(HAND_FRAMES.values())
              if len(c) <= 6000]
    seen = {"read": 0, "fail": 0, "undefined": 0}
    for i in range(2000):
        frame, content = frames[i % len(frames)]
        n = len(content) if rng.rand() < 0.7 else max(1, len(content) + rng.randint(-20, 20))
        img = np.zeros((1, n, 1), np.uint8)
        data = tiff(img, 8, 1, "<", 50000, encode_chunk=lambda b: _mutated(rng, frame))
        seen[_agree(data)] += 1
    assert seen["read"] > 300 and seen["fail"] > 1000, seen


# ---------------------------------------------------------------------------
# old-style JPEG
# ---------------------------------------------------------------------------

def _jpeg(a, **kw) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(a).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _sos_end(j: bytes) -> int:
    p = 2
    while True:
        n = struct.unpack(">H", j[p + 2:p + 4])[0]
        if j[p + 1] == 0xDA:
            return p + 2 + n
        p += 2 + n


def _with_tag(data: bytes, tag: int, value: int) -> bytes:
    """A classic little-endian TIFF with one LONG tag's value set."""
    d = bytearray(data)
    ifd = struct.unpack("<I", d[4:8])[0]
    for e in range(struct.unpack("<H", d[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * e
        if struct.unpack("<H", d[at:at + 2])[0] == tag:
            d[at + 8:at + 12] = struct.pack("<I", value)
    return bytes(d)


SUBSAMPLING = {"4:4:4": ([1, 1], 8), "4:2:2": ([2, 1], 8), "4:2:0": ([2, 2], 16)}


def _ojpeg_restart_strips(img, sub: str, quality: int = 85, header_only: bool = True,
                          mutate=None) -> bytes:
    """OJPEG of strips that are the restart intervals of one JPEG stream
    (an MCU row each), JPEGInterchangeFormat at the stream's header (or
    all of it), the strips holding the scan data without the markers."""
    ss, mcu = SUBSAMPLING[sub]
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, "JPEG", quality=quality, subsampling=sub,
                                  restart_marker_rows=1)
    j = buf.getvalue()
    s0 = _sos_end(j)
    marks = [k for k in range(s0, len(j) - 1) if j[k] == 0xFF and 0xD0 <= j[k + 1] <= 0xD7]
    bounds = [s0] + marks + [len(j) - 2]
    chunks = [j[(a if a == s0 else a + 2):b] for a, b in zip(bounds, bounds[1:])]
    if mutate is not None:
        k = mutate.randint(len(chunks))
        chunks[k] = _mutated(mutate, chunks[k])
    it = iter(chunks)
    stream = j[:s0] if header_only else j
    data = tiff(img, 8, 6, "<", 6, rps=mcu, encode_chunk=lambda b: next(it),
                tags={530: (3, ss), 513: (4, [0]), 514: (4, [len(stream)])})
    return _with_tag(data + stream, 513, len(data))


def _ojpeg_table_tags(img, sub: str) -> bytes:
    """OJPEG with its tables in JPEGQTables, JPEGDCTables and JPEGACTables
    and each strip bare scan data."""
    ss, _ = SUBSAMPLING[sub]
    j = _jpeg(img, quality=85, subsampling=sub)
    s0 = _sos_end(j)
    q, h, p = [], {}, 2
    while p < s0:
        n = struct.unpack(">H", j[p + 2:p + 4])[0]
        body = j[p + 4:p + 2 + n]
        if j[p + 1] == 0xDB:
            q += [body[i + 1:i + 65] for i in range(0, len(body), 65)]
        elif j[p + 1] == 0xC4:
            i = 0
            while i < len(body):
                k = sum(body[i + 1:i + 17])
                h[body[i]] = body[i + 1:i + 17 + k]
                i += 17 + k
        p += 2 + n
    blob = [q[0], q[1], h[0], h[1], h[16], h[17]]
    base = tiff(img, 8, 6, "<", 6, encode_chunk=lambda b: j[s0:-2],
                tags={530: (3, ss), 512: (3, [1]), 519: (4, [0, 0, 0]), 520: (4, [0, 0, 0]),
                      521: (4, [0, 0, 0])})
    offs = np.cumsum([len(base)] + [len(b) for b in blob]).tolist()
    d = bytearray(base + b"".join(blob))
    ifd = struct.unpack("<I", d[4:8])[0]
    for e in range(struct.unpack("<H", d[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * e
        tag = struct.unpack("<H", d[at:at + 2])[0]
        if tag in (519, 520, 521):
            k = 2 * (tag - 519)
            vo = struct.unpack("<I", d[at + 8:at + 12])[0]
            d[vo:vo + 12] = struct.pack("<III", offs[k], offs[k + 1], offs[k + 1])
    return bytes(d)


def _ojpeg_forms() -> dict:
    rng = np.random.RandomState(6)
    out = {}
    for h, w in ((48, 40), (37, 53)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for sub, (ss, _) in SUBSAMPLING.items():
            j = _jpeg(img, quality=85, subsampling=sub)
            for photo in (6, 2):
                out[f"{h}x{w}_{sub}_p{photo}_strip_is_the_jfif"] = tiff(
                    img, 8, photo, "<", 6, encode_chunk=lambda b, j=j: j, tags={530: (3, ss)})
            base = tiff(img, 8, 6, "<", 6, encode_chunk=lambda b, j=j: j,
                        tags={530: (3, ss), 513: (4, [0]), 514: (4, [len(j)])})
            out[f"{h}x{w}_{sub}_interchange_format_is_the_strip"] = _with_tag(
                base, 513, base.index(j))
            out[f"{h}x{w}_{sub}_restart_strips"] = _ojpeg_restart_strips(img, sub)
            out[f"{h}x{w}_{sub}_restart_strips_whole_stream"] = _ojpeg_restart_strips(
                img, sub, header_only=False)
        for sub in ("4:4:4", "4:2:0"):
            out[f"{h}x{w}_{sub}_table_tags"] = _ojpeg_table_tags(img, sub)
        g = rng.randint(0, 256, (h, w)).astype(np.uint8)
        j = _jpeg(g, quality=85)
        out[f"{h}x{w}_gray"] = tiff(g[..., None], 8, 1, "<", 6, encode_chunk=lambda b, j=j: j)
    return out


OJPEG_FORMS = _ojpeg_forms()


@pytest.mark.parametrize("name", sorted(OJPEG_FORMS))
def test_ojpeg_decodes_as_pillow(name):
    """Old-style JPEG (6) in the forms Pillow 12.1 reads: a strip that is a
    whole JFIF stream, JPEGInterchangeFormat at it, strips that are one
    stream's restart intervals under a header of their own, the tables in
    tags with bare scan data; YCbCr 4:4:4, 4:2:2, 4:2:0 (under photometric
    RGB too) and gray."""
    assert _agree(OJPEG_FORMS[name]) == "read"


def test_ojpeg_fuzz_decodes_or_fails_as_pillow():
    """500 seeded OJPEG files, their bytes fuzzed: 300 of one strip (a whole
    JFIF stream), 100 of one strip whose stream has a restart marker each
    MCU row, 100 of restart-interval strips with one strip fuzzed. Each
    decodes as Pillow does or fails where Pillow fails: where libtiff's
    codec fails a strip's data (a restart marker out of order, no data
    after the header), Pillow reads that strip as zeros if it is the last
    and fails the file if it is not."""
    rng = np.random.RandomState(450)
    seen = {"read": 0, "fail": 0, "undefined": 0}
    for i in range(500):
        sub = ("4:4:4", "4:2:0", "4:2:2")[i % 3]
        ss, mcu = SUBSAMPLING[sub]
        if i < 400:
            h, w = rng.randint(8, 40), rng.randint(8, 40)
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            kw = {"restart_marker_rows": 1} if i >= 300 else {}
            j = _mutated(rng, _jpeg(img, quality=int(rng.randint(30, 95)), subsampling=sub,
                                    **kw))
            data = tiff(img, 8, 6, "<", 6, encode_chunk=lambda b: j, tags={530: (3, ss)})
        else:
            h, w = mcu * rng.randint(2, 5) - rng.randint(0, 3), rng.randint(8, 40)
            img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            data = _ojpeg_restart_strips(img, sub, 80, mutate=rng)
        seen[_agree(data)] += 1
    assert seen["read"] > 300 and seen["fail"] > 40, seen


def test_ojpeg_strips_libtiff_fails_read_as_pillow_reads_them():
    """Strips that keep their own restart marker under a header-only
    JPEGInterchangeFormat (libtiff writes one more between strips): the
    strip after such a strip meets a marker out of order, which libtiff's
    codec fails. Where that is the last strip Pillow reads it as zeros
    (green, through libtiff's YCbCr conversion); before the last, Pillow
    fails the file, and so does a gray image."""
    rng = np.random.RandomState(18)
    outcomes = []
    for n_strips, keep in ((3, 1), (4, 2), (4, 1), (5, 3), (5, 1), (2, 1)):
        img = rng.randint(0, 256, (16 * n_strips, 40, 3)).astype(np.uint8)
        buf = io.BytesIO()
        PIL.Image.fromarray(img).save(buf, "JPEG", quality=85, subsampling="4:2:0",
                                      restart_marker_rows=1)
        j = buf.getvalue()
        s0 = _sos_end(j)
        marks = [k for k in range(s0, len(j) - 1) if j[k] == 0xFF and 0xD0 <= j[k + 1] <= 0xD7]
        bounds = [s0] + marks + [len(j) - 2]
        chunks = iter(j[(a if a == s0 or k == keep else a + 2):b]
                      for k, (a, b) in enumerate(zip(bounds, bounds[1:])))
        data = tiff(img, 8, 6, "<", 6, rps=16, encode_chunk=lambda b: next(chunks),
                    tags={530: (3, [2, 2]), 513: (4, [0]), 514: (4, [s0])})
        data = _with_tag(data + j[:s0], 513, len(data))
        outcomes.append(_agree(data))
        if outcomes[-1] == "read" and keep + 1 == n_strips - 1:
            assert (tiffmod.tiff_decode_rgb(data)[-16:] == [0, 135, 0]).all()
    assert outcomes == ["read", "read", "fail", "read", "fail", "read"], outcomes


# ---------------------------------------------------------------------------
# C.14 (3): a short 8-bit PCX from its path
# ---------------------------------------------------------------------------

def test_a_short_8bit_pcx_fails_from_its_path_as_pillow_fails(tmp_path):
    """PcxImagePlugin seeks 769 bytes back from the end of an 8-bit file for
    its palette: on a file opened by its path, as the JAX package opens
    every image, that fails where the file is shorter; from memory Pillow
    reads it. read_image_rgb takes a path and fails it; a longer file reads
    as Pillow reads it from its path."""
    rng = np.random.RandomState(769)
    for w, h, palette in ((5, 3, False), (40, 20, False), (40, 20, True), (60, 30, False)):
        head = bytearray(128)
        head[:4] = bytes([10, 5, 1, 8])
        head[4:12] = struct.pack("<HHHH", 0, 0, w - 1, h - 1)
        head[65:68] = bytes([1]) + struct.pack("<H", w + w % 2)
        lines = b"".join(bytes([0xC1, b]) if b >= 0xC0 else bytes([b])
                         for b in rng.randint(0, 256, h * (w + w % 2)).astype(np.uint8))
        tail = b"\x0c" + rng.randint(0, 256, 768).astype(np.uint8).tobytes() if palette else b""
        data = bytes(head) + lines + tail
        path = tmp_path / f"g{w}x{h}.pcx"
        path.write_bytes(data)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            PIL.Image.open(io.BytesIO(data)).convert("RGB")  # from memory it reads
            try:
                with PIL.Image.open(path) as img:
                    want = np.asarray(img.convert("RGB"))
            except OSError:
                want = None
        assert (want is None) == (len(data) < 769), (w, h, len(data))
        if want is None:
            with pytest.raises(ValueError, match=r"g\d+x\d+\.pcx.*769"):
                im.read_image_rgb(str(path))
        else:
            np.testing.assert_array_equal(im.read_image_rgb(str(path)), want)


def _ojpeg_tiled(img, sub: str, tw: int, th: int) -> bytes:
    """Tiled OJPEG: the tiles, stacked in tile order, one JPEG stream of the
    tile width, a restart interval a tile, JPEGInterchangeFormat at its
    header."""
    ss, mcu = SUBSAMPLING[sub]
    h, w = img.shape[:2]
    stack = np.concatenate([img[y:y + th, x:x + tw] for y in range(0, h, th)
                            for x in range(0, w, tw)], 0)
    buf = io.BytesIO()
    PIL.Image.fromarray(stack).save(buf, "JPEG", quality=90, subsampling=sub,
                                    restart_marker_rows=th // mcu)
    j = buf.getvalue()
    s0 = _sos_end(j)
    marks = [k for k in range(s0, len(j) - 1) if j[k] == 0xFF and 0xD0 <= j[k + 1] <= 0xD7]
    bounds = [s0] + marks + [len(j) - 2]
    it = iter(j[(a if a == s0 else a + 2):b] for a, b in zip(bounds, bounds[1:]))
    data = tiff(img, 8, 6, "<", 6, tile=(tw, th), encode_chunk=lambda b: next(it),
                tags={530: (3, ss), 513: (4, [0]), 514: (4, [s0])})
    return _with_tag(data + j[:s0], 513, len(data))


def _ojpeg_planar(img) -> bytes:
    """Planar OJPEG: a frame of three 1 x 1 components, one scan each (its
    SOS at the start of its plane's strip but the first's, which is in the
    header)."""
    grays = [_jpeg(np.ascontiguousarray(img[..., c]), quality=90) for c in range(3)]
    g = grays[0]
    k, k2 = g.index(b"\xff\xc0"), g.index(b"\xff\xda")
    n = struct.unpack(">H", g[k + 2:k + 4])[0]
    sof = b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, img.shape[0], img.shape[1], 3) + bytes(
        [1, 0x11, 0, 2, 0x11, 0, 3, 0x11, 0])

    def sos(c):
        return b"\xff\xda" + struct.pack(">HB", 8, 1) + bytes([c + 1, 0, 0, 0x3F, 0])

    header = g[:k] + sof + g[k + 2 + n:k2] + sos(0)
    it = iter([(sos(c) if c else b"") + x[_sos_end(x):-2] for c, x in enumerate(grays)])
    data = tiff(img, 8, 6, "<", 6, planar=2, encode_chunk=lambda b: next(it),
                tags={530: (3, [1, 1]), 513: (4, [0]), 514: (4, [len(header)])})
    return _with_tag(data + header, 513, len(data))


def test_tiled_and_planar_ojpeg_pillow_reads_name_item_28():
    """Tiled and planar OJPEG, which Pillow reads (libtiff's OJPEG codec
    takes tiles as restart intervals of a stream of the tile width, and a
    plane as the scan of its component), are refused naming item 28."""
    rng = np.random.RandomState(28)
    img = np.clip(np.cumsum(rng.randint(-4, 5, (32, 32, 3)), 1) + 128, 0, 255).astype(np.uint8)
    files = {f"tiled_{sub}_{tw}x{th}": _ojpeg_tiled(img, sub, tw, th)
             for sub in SUBSAMPLING for tw, th in ((16, 16), (16, 32), (32, 16))}
    files["planar"] = _ojpeg_planar(img)
    for name, data in files.items():
        assert _pillow(data) is not None, name
        with pytest.raises(ValueError, match="Pillow reads it; ROADMAP item 28"):
            tiffmod.tiff_decode_rgb(data)


# ---------------------------------------------------------------------------
# the fixtures the card reads (chip_smoke.py phase 58)
# ---------------------------------------------------------------------------

def fixture_forms() -> dict:
    """{name: TIFF bytes}: the small files of chip_smoke.py phase 58, one
    or two a codec and form (written by
    tests/fixtures/torch_image_tiff_codecs/make_fixtures.py)."""
    rng = np.random.RandomState(58)
    out = {}
    black = np.tile(np.array([0, 0, 0, 0, 1, 1, 1, 1], np.uint8), (3, 1))
    out["ccitt_c15_mh_8x3"] = _ccitt_file(black, 2, 0, {})
    b = (rng.rand(24, 61) > 0.5).astype(np.uint8)
    for mode, (comp, every, tags) in UNCOMPRESSED_BIT.items():
        out[f"ccitt_{mode}_uncompressed_bit"] = _ccitt_file(b, comp, every, tags, rps=8)
    code = ccitt(b[:6], 4, 0)
    out["ccitt_g4_extension_code"] = tiff(
        b[:6, :, None], 1, 0, "<", 4, tags={293: (4, [2])},
        encode_chunk=lambda _: code[:5] + b"\x02\x0f" + code[5:])
    out["ccitt_rlew"] = _ccitt_file(b, 32771, 0, {}, rps=5)
    out["ccitt_rlew_tiles_be"] = _ccitt_file(b, 32771, 0, {}, bo=">", tile=(32, 16))
    v = _thunder_image(rng, 21, 45)
    out["thunderscan_gray"] = _thunder_file(v, rps=8)
    out["thunderscan_palette_be"] = _thunder_file(v, bo=">", photo=3,
                                                  cmap=rng.randint(0, 65536, 48))
    photo = np.clip(np.cumsum(rng.randint(-4, 5, (30, 41, 3)), 1) + 128, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(photo).save(buf, "TIFF", compression="lzma", tiffinfo={317: 2})
    out["lzma_rgb_predictor"] = buf.getvalue()
    out["lzma_gray16_be_tiles"] = tiff(rng.randint(0, 65536, (30, 41, 1)), 16, 1, ">", 34925,
                                       tile=(16, 16), predictor=2, encode_chunk=_xz)
    buf = io.BytesIO()
    PIL.Image.fromarray(photo).save(buf, "TIFF", compression="zstd")
    out["zstd_rgb"] = buf.getvalue()
    smooth = np.clip(np.cumsum(rng.randint(-1, 2, (180, 256, 3)), 1) + 128, 0, 255)
    buf = io.BytesIO()
    PIL.Image.fromarray(smooth.astype(np.uint8)).save(buf, "TIFF", compression="zstd",
                                                      strip_size=1 << 20)
    out["zstd_one_strip_of_two_blocks"] = buf.getvalue()
    frame, content = HAND_FRAMES["single segment, checksum"]
    out["zstd_single_segment_checksum"] = tiff(np.frombuffer(content, np.uint8)[None, :, None],
                                               8, 1, "<", 50000, encode_chunk=lambda _: frame)
    img = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    j = _jpeg(img, quality=85, subsampling="4:2:0")
    out["ojpeg_jfif_420"] = tiff(img, 8, 6, "<", 6, encode_chunk=lambda _: j,
                                 tags={530: (3, [2, 2])})
    out["ojpeg_restart_strips_422"] = _ojpeg_restart_strips(img, "4:2:2")
    out["ojpeg_table_tags_444"] = _ojpeg_table_tags(img, "4:4:4")
    # liblzma reports the broken footer in the call that writes the strip's
    # last bytes: libtiff ignores it
    out["lzma_footer_broken_after_the_strip"] = tiff(
        photo, 8, 2, "<", 34925, rps=30, encode_chunk=lambda b: _xz_broken_at(b, -1))
    return out


def zstd_photo(size: int = 256) -> bytes:
    """The 256 px ZSTD photo phase 58 times (by its digest in the fixtures):
    a smooth photo-like image with noise, in Pillow's 64 KiB strips."""
    rng = np.random.RandomState(256)
    yy, xx = np.mgrid[:size, :size]
    base = np.stack([128 + 90 * np.sin(xx / 31.0 + c) * np.cos(yy / 19.0 - c) for c in range(3)],
                    -1)
    img = np.clip(base + rng.randn(size, size, 3) * 6, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, "TIFF", compression="zstd")
    return buf.getvalue()


def test_the_tiff_codec_fixtures_equal_their_recorded_pillow_decodes():
    """tests/fixtures/torch_image_tiff_codecs (what the card reads,
    chip_smoke.py phase 58): a file for each of fixture_forms' forms, which
    Pillow and the port decode to decodes.npz (the ZSTD photo to its SHA-256
    in decodes.json)."""
    with open(os.path.join(HERE, "decodes.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(HERE, "decodes.npz"))
    forms = {**fixture_forms(), "zstd_photo_256": zstd_photo()}
    assert set(forms) == set(meta) - {"pillow", "libtiff"}
    for name in forms:
        path = os.path.join(HERE, f"{name}.tif")
        with open(path, "rb") as f:
            want = _pillow(f.read())
        got = im.read_image_rgb(path)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert list(got.shape) == meta[name]["shape"], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == meta[name]["sha256"], name
        if name in npz:
            np.testing.assert_array_equal(got, npz[name], err_msg=name)
