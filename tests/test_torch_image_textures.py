"""BCn blocks, DDS, BLP, FTEX and PSD in the port's image reader
(latent2im_tpu_torch/utils/bcn.py, dds.py, blp.py, psd.py through
utils/image.py:read_image_rgb), bit for bit against Pillow 12.1's
``Image.open(p).convert("RGB")`` on files Pillow writes where it can and
tests/image_format_encoders.py writes where it cannot; a fuzzed file fails
wherever Pillow fails it; tests/fixtures/torch_image_textures holds what the
card's machine, which has no Pillow, checks (chip_smoke.py phase 56)."""

import io
import json
import os
import tempfile
import warnings

import numpy as np
import PIL.Image
import pytest

from image_format_encoders import blp_file, dds_file, ftex_file, psd_file
from latent2im_tpu_torch.utils import bcn
from latent2im_tpu_torch.utils import image as im

RNG = np.random.RandomState(19)
PHOTO = RNG.randint(0, 256, (29, 37, 3)).astype(np.uint8)
HERE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_image_textures")


def _pillow(data):
    """Pillow's decode of the file opened by its path, as the JAX package
    opens every image (ImageFile.load maps some raw images: ROADMAP C.17)."""
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


def _same(tmp_path, name, data):
    """Does the port read the file as Pillow does, or fail it where Pillow
    fails (naming it)? -> (agrees, Pillow read it)."""
    path = tmp_path / name
    path.write_bytes(data)
    want = _pillow(data)
    try:
        got = im.read_image_rgb(str(path))
    except ValueError as e:
        return want is None and name in str(e), want is not None
    return (want is not None and got.dtype == np.uint8 and got.shape == want.shape
            and bool((got == want).all())), want is not None


def _saved(img, fmt, **opts):
    buf = io.BytesIO()
    img.save(buf, fmt, **opts)
    return buf.getvalue()


def _blocks(n, size, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, size)).astype(np.uint8)


# ---------------------------------------------------------------------------
# BC1-BC7 against BcnDecode.c, through DDS
# ---------------------------------------------------------------------------

# name -> (DXGI format, bcn decoder, block bytes)
BCN = {"bc1": (71, 1, 8), "bc2": (74, 2, 16), "bc3": (77, 3, 16), "bc4": (80, 4, 8),
       "bc5u": (83, 5, 16), "bc5s": (84, 5, 16), "bc6h_uf16": (95, 6, 16),
       "bc6h_sf16": (96, 6, 16), "bc7": (98, 7, 16)}


def _bcn_blocks(name, seed):
    """Random blocks, and for BC6H and BC7 each mode code forced on a share."""
    b = _blocks(10 * 14 * 4, BCN[name][2], seed)
    if name.startswith("bc6h"):
        codes = [0, 1] + [2 | k << 2 for k in range(8)] + [3 | k << 2 for k in range(8)]
        for i, c in enumerate(codes):
            b[i::len(codes), 0] = (b[i::len(codes), 0] & (0xFC if c < 2 else 0xE0)) | c
    if name == "bc7":
        for m in range(9):  # mode m: the first set bit of byte 0; 8: byte 0 of zero
            b[m::9, 0] = (b[m::9, 0] & ((0xFF << (m + 1)) & 0xFF)) | ((1 << m) & 0xFF)
    return b


@pytest.mark.parametrize("name", sorted(BCN))
def test_bcn_blocks_decode_as_pillow(name):
    """Every mode, partition, anchor, rotation and endpoint pattern that
    random blocks reach (BC6H: its 18 mode codes, the 4 reserved; BC7: its 8
    modes and byte 0 of zero), with alpha where Pillow keeps it."""
    dxgi, n, size = BCN[name]
    for seed, (w, h) in ((1, (37, 53)), (2, (64, 40))):
        blocks = _bcn_blocks(name, seed)[:-(-w // 4) * -(-h // 4)]
        want = np.asarray(PIL.Image.open(io.BytesIO(dds_file(w, h, blocks.tobytes(), b"DX10",
                                                              dxgi))))
        got = bcn.bcn_decode(blocks.tobytes(), w, h, n, name in ("bc5s", "bc6h_sf16"))
        got = got[..., 0] if want.ndim == 2 else got[..., :want.shape[-1]]
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {w}x{h}")


def test_half_floats_reach_8_bits_as_pillow():
    """BC6H's half floats to 8 bits (the blocks above hold them to Pillow):
    negative halves give 0, those from 1.0 to +Inf 255."""
    halves = np.arange(0, 1 << 16, 97)
    got = bcn.half_to_u8(halves)
    assert got.min() == 0 and got.max() == 255
    assert (got[halves >= 0x8000] == 0).all()
    assert (got[(halves >= 0x3C00) & (halves <= 0x7C00)] == 255).all()  # to +Inf


# ---------------------------------------------------------------------------
# DDS, BLP, FTEX, PSD
# ---------------------------------------------------------------------------

def _dds_cases():
    img = PIL.Image.fromarray(PHOTO)
    out = {f"pillow_{pf}": _saved(img.convert("RGBA"), "DDS", pixel_format=pf)
           for pf in ("DXT1", "DXT3", "DXT5", "BC2", "BC3")}
    out["pillow_bc5"] = _saved(img, "DDS", pixel_format="BC5")
    out["pillow_rgb"] = _saved(img, "DDS")
    out["pillow_rgba"] = _saved(img.convert("RGBA"), "DDS")
    out["pillow_l"] = _saved(img.convert("L"), "DDS")
    out["pillow_la"] = _saved(img.convert("LA"), "DDS")
    for fc, size in ((b"ATI1", 8), (b"BC4U", 8), (b"ATI2", 16), (b"BC5U", 16), (b"BC5S", 16)):
        out[f"fourcc_{fc.decode()}"] = dds_file(37, 29, _blocks(80, size, 3).tobytes(), fc)
    for dxgi in (70, 73, 76, 79, 82, 94, 97, 99, 27, 28, 29, 2, 81):
        n = 8 if dxgi in (70, 79, 81) else 16
        body = _blocks(80, n, dxgi).tobytes() if dxgi > 29 else PHOTO.tobytes() + b"\x80" * 2000
        out[f"dx10_{dxgi}"] = dds_file(37, 29, body, b"DX10", dxgi)
    out["masks_565"] = dds_file(37, 29, _blocks(37 * 29, 2, 4).tobytes(), pfflags=0x40,
                                bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0))
    out["masks_odd_alpha"] = dds_file(37, 29, _blocks(37 * 29, 3, 5).tobytes(), pfflags=0x41,
                                      bitcount=24, masks=(0x0F0F, 0x30F000, 0x3, 0xC00000))
    out["masks_short_data"] = dds_file(37, 29, _blocks(100, 4, 6).tobytes(), pfflags=0x40,
                                       bitcount=32, masks=(0xFF, 0xFF00, 0xFF0000, 0))
    pal = _blocks(256, 4, 7).tobytes()
    out["palette"] = dds_file(37, 29, pal + _blocks(37 * 29, 1, 8).tobytes(), pfflags=0x20,
                              bitcount=8)
    out["luminance_16_no_alpha"] = dds_file(37, 29, bytes(5000), pfflags=0x20000, bitcount=16)
    out["unknown_fourcc"] = dds_file(37, 29, bytes(5000), b"ABCD")
    out["cut_blocks"] = out["pillow_DXT1"][:-9]
    return out


def _blp_cases():
    img = PIL.Image.fromarray(PHOTO)
    pal = _blocks(256, 4, 9).tobytes()
    idx = _blocks(37 * 29, 1, 10).tobytes()
    jpg = _saved(img, "JPEG", quality=80)
    cmyk = _saved(img.convert("CMYK"), "JPEG")
    out = {f"pillow_{v}": _saved(img.quantize(50), "BLP", blp_version=v)
           for v in ("blp1", "blp2")}
    out["blp1_palette_a8"] = blp_file(1, 37, 29, idx, enc=4, alpha=8, palette=pal)
    out["blp1_palette_gap"] = blp_file(1, 37, 29, idx, enc=5, palette=pal, gap=b"gap")
    out["blp1_jpeg"] = blp_file(1, 37, 29, jpg[300:], comp=0, jpeg_header=jpg[:300])
    out["blp1_jpeg_cmyk"] = blp_file(1, 37, 29, cmyk[300:], comp=0, jpeg_header=cmyk[:300])
    out["blp1_jpeg_gap"] = blp_file(1, 37, 29, jpg[300:], comp=0, jpeg_header=jpg[:300],
                                    gap=b"\0" * 5)
    for alpha in (0, 1, 4, 8):
        out[f"blp2_palette_a{alpha}"] = blp_file(2, 37, 29, idx, alpha=alpha, palette=pal)
        for aenc, size in ((0, 8), (1, 16), (7, 16)):
            out[f"blp2_dxt{aenc}_a{alpha}"] = blp_file(
                2, 37, 29, _blocks(80, size, aenc + alpha).tobytes(), enc=2, alpha=alpha,
                aenc=aenc, palette=pal)
    out["blp2_raw_bgra"] = blp_file(2, 37, 29, PHOTO.tobytes() * 2, enc=3, palette=pal)
    out["blp2_short_palette"] = blp_file(2, 37, 29, idx, palette=pal[:600])
    return out


def _ftex_cases():
    return {"dxt1": ftex_file(37, 29, 0, _blocks(80, 8, 11).tobytes()),
            "rgb": ftex_file(37, 29, 1, PHOTO.tobytes()),
            "rgb_cut": ftex_file(37, 29, 1, PHOTO.tobytes()[:-5]),
            "format_2": ftex_file(37, 29, 2, PHOTO.tobytes())}


def _psd_cases():
    planes = RNG.randint(0, 256, (5, 29, 37)).astype(np.uint8)
    planes[:, 5:20, 3:30] = 77
    pal = _blocks(768, 1, 12).tobytes()
    out = {}
    for mode, c in ((0, 1), (1, 1), (2, 1), (3, 3), (3, 4), (3, 5), (4, 4), (7, 1), (8, 1)):
        for comp in (0, 1):
            out[f"mode{mode}_c{c}_{'packbits' if comp else 'raw'}"] = psd_file(
                planes[:c], mode, 8, comp, palette=pal if mode == 2 else b"")
    out["bitmap_raw"] = psd_file(planes[:1] > 128, 0, 1, 0)
    out["bitmap_packbits"] = psd_file(planes[:1] > 128, 0, 1, 1)
    out["indexed_no_palette"] = psd_file(planes[:1], 2, 8, 0)
    out["resources_and_layers"] = psd_file(
        planes[:3], 3, 8, 1, resources=b"8BIM\x03\xed\x03abc\0\0\0\x05hello\0"
        + b"8BIM\x04\x04\0\0\0\0\0\x02hi", layers=b"\0\0\0\x04\0\0\0\0")
    out["sixteen_bits"] = psd_file(planes[:3], 3, 16, 0)
    out["zip_compression"] = psd_file(planes[:3], 3, 8, 0)[:-3 * 29 * 37 - 2] + b"\0\x02"
    out["too_few_channels"] = psd_file(planes[:2], 3, 8, 0)
    out["cut"] = out["mode3_c3_packbits"][:-40]
    return out


FORMATS = {"dds": _dds_cases, "blp": _blp_cases, "ftex": _ftex_cases, "psd": _psd_cases}
CASES = [(ext, name, data) for ext, make in FORMATS.items() for name, data in make().items()]


@pytest.mark.parametrize("ext,name,data", CASES, ids=[f"{e}-{n}" for e, n, _ in CASES])
def test_each_texture_form_decodes_or_fails_as_pillow(tmp_path, ext, name, data):
    agrees, _ = _same(tmp_path, f"{name}.{ext}", data)
    assert agrees


def test_each_format_has_forms_pillow_reads_and_fails():
    by_kind = {}
    for ext, _, data in CASES:
        by_kind.setdefault(ext, [0, 0])[_pillow(data) is not None] += 1
    for ext, (fail, ok) in by_kind.items():
        assert ok >= 2 and fail >= 1, (ext, by_kind)


def test_psd_lab_names_item_28(tmp_path):
    """LAB: Pillow converts it with LittleCMS, which the port does not."""
    data = psd_file(RNG.randint(0, 256, (3, 9, 13)), 9, 8, 0)
    assert _pillow(data) is not None
    path = tmp_path / "lab.psd"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=r"lab\.psd.*LAB.*item 28"):
        im.read_image_rgb(str(path))


def _fuzzed(data: bytes, rng) -> bytes:
    """Bytes overwritten, inserted, deleted or cut, as the corrupt-data
    probes of tests/test_torch_image_formats.py fuzz them."""
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


@pytest.mark.parametrize("ext", sorted(FORMATS))
def test_fuzzed_files_fail_where_pillow_fails(tmp_path, ext):
    """300 fuzzed files of each format's forms (PSD's LAB left out: it names
    item 28): the port fails exactly where Pillow fails, and reads the rest
    as Pillow does."""
    forms = {k: v for k, v in FORMATS[ext]().items()}
    names = sorted(forms)
    rng = np.random.RandomState(len(ext))
    counts = [0, 0]
    for k in range(300):
        data = _fuzzed(forms[names[rng.randint(len(names))]], rng)
        agrees, read = _same(tmp_path, f"f{k}.{ext}", data)
        assert agrees, (ext, k)
        counts[read] += 1
    assert min(counts) >= 20, counts


def test_the_texture_fixtures_equal_their_recorded_pillow_decodes():
    """tests/fixtures/torch_image_textures (what the card's phase 56 reads)
    but the JPEG 2000 photos: each file's decode against decodes.npz or its recorded digest, and
    Pillow's decode still that."""
    import hashlib

    meta = json.load(open(os.path.join(HERE, "decodes.json")))
    npz = np.load(os.path.join(HERE, "decodes.npz"))
    names = sorted(f for f in os.listdir(HERE) if os.path.splitext(f)[0] in meta
                   and not f.startswith("photo_"))  # the photos: tests/test_torch_jpeg2000.py
    assert len(names) >= 28
    for name in names:
        key = os.path.splitext(name)[0]
        got = im.read_image_rgb(os.path.join(HERE, name))
        assert hashlib.sha256(got.tobytes()).hexdigest() == meta[key]["sha256"], name
        if key in npz:
            np.testing.assert_array_equal(got, npz[key], err_msg=name)
        with open(os.path.join(HERE, name), "rb") as f:
            want = _pillow(f.read())
        assert hashlib.sha256(want.tobytes()).hexdigest() == meta[key]["sha256"], name
