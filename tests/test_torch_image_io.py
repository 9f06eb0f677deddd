"""The port's image reader (latent2im_tpu_torch/utils/image.py), on the CPU:
PNG decoding and Pillow's LANCZOS resample without Pillow, bit for bit
against Pillow, and the inversion CLI's ``load_images`` against the JAX
CLI's (which opens the files with Pillow) on a directory of mixed PNGs.
"""

import io
import struct
import zlib

import numpy as np
import PIL.Image
import pytest

from latent2im_tpu.cli.bp import load_images as jax_load_images
from latent2im_tpu_torch.cli.bp import load_images
from latent2im_tpu_torch.utils import image as im


def _pillow_png(img: PIL.Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pillow_rgb(data: bytes) -> np.ndarray:
    return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))


def _chunk(tag, body):
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _filter_row(ftype, cur, prev, bpp):
    """PNG filter ``ftype`` applied to one row of bytes (the encoder's side)."""
    cur, prev = cur.astype(np.int32), prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(cur)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
    return ((cur - pred) % 256).astype(np.uint8)


def _png(rows, w, h, depth, color, plte=None, trns=None, interlace=0):
    """A PNG whose row i is written with filter i % 5 (every type in turn)."""
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    bpp = max(1, spp * depth // 8)
    raw, prev = b"", np.zeros(rows.shape[1], np.uint8)
    for i, row in enumerate(rows):
        raw += bytes([i % 5]) + _filter_row(i % 5, row, prev, bpp).tobytes()
        prev = row
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        out += _chunk(b"PLTE", plte.tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _pack(vals, depth):
    """[h, w] samples of ``depth`` bits -> packed rows of bytes."""
    h, w = vals.shape
    bits = ((vals[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, w * depth), axis=1)


def _images():
    rng = np.random.RandomState(0)
    noise = rng.randint(0, 256, (13, 17, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:13, 0:17]
    smooth = np.stack([(xx * 7 + yy * 3 + c * 40) % 256 for c in range(3)], -1)
    return {"noise": noise, "smooth": smooth.astype(np.uint8)}


PILLOW_CASES = ["RGB", "RGBA", "L", "LA", "P", "P tRNS", "P 1-bit", "P 2-bit", "P 4-bit",
                "1"]


@pytest.mark.parametrize("case", PILLOW_CASES)
@pytest.mark.parametrize("content", ["noise", "smooth"])
def test_png_written_by_pillow_decodes_as_pillow_converts_it(case, content):
    arr = _images()[content]
    if case == "RGBA":
        img = PIL.Image.fromarray(np.concatenate([arr, arr[..., :1]], -1), "RGBA")
    elif case in ("L", "1"):
        img = PIL.Image.fromarray(arr[..., 0]).convert(case)
    elif case == "LA":
        img = PIL.Image.fromarray(arr[..., :2], "LA")
    elif case.startswith("P"):
        bits = int(case.split()[1][0]) if "bit" in case else 8
        img = PIL.Image.fromarray(arr).convert("P", palette=PIL.Image.ADAPTIVE,
                                               colors=2 ** bits if bits < 8 else 200)
    else:
        img = PIL.Image.fromarray(arr)
    kw = {"transparency": 3} if case == "P tRNS" else {}
    if "bit" in case:
        kw["bits"] = int(case.split()[1][0])
    data = _pillow_png(img, **kw)
    np.testing.assert_array_equal(im.png_decode_rgb(data), _pillow_rgb(data))


@pytest.mark.parametrize("color,depth", [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1),
                                         (3, 2), (3, 4), (3, 8), (4, 8), (6, 8)])
def test_every_filter_type_at_every_colour_type_and_depth(color, depth):
    """Rows written with filters 0-4 in turn, decoded as Pillow does."""
    rng = np.random.RandomState(color * 16 + depth)
    h, w = 11, 19
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    plte = trns = None
    if depth < 8:
        rows = _pack(rng.randint(0, 2 ** depth, (h, w)), depth)
    else:
        rows = rng.randint(0, 256, (h, w * spp)).astype(np.uint8)
    if color == 3:
        n = 2 ** depth if depth < 8 else 256
        plte = rng.randint(0, 256, (n, 3)).astype(np.uint8)
        trns = bytes(range(0, 256, 32))
    data = _png(rows, w, h, depth, color, plte, trns)
    got = im.png_decode_rgb(data)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pillow_rgb(data))


def test_what_the_reader_does_not_take_raises_naming_it(tmp_path):
    """16-bit and Adam7 PNGs, WEBP, GIF and Netpbm, which this test once
    held refused, and DDS, decode as Pillow decodes them; a file of a kind
    still to port (AVIF) raises naming it and ROADMAP item 28."""
    rows = (np.arange(96) * 7 % 256).astype(np.uint8).reshape(4, 24)
    data = _png(rows, 4, 4, 16, 2)  # 16-bit RGB, 4 x 4
    np.testing.assert_array_equal(im.png_decode_rgb(data), _pillow_rgb(data))
    one = _chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 0, 0, 0, 1))
    data = (b"\x89PNG\r\n\x1a\n" + one + _chunk(b"IDAT", zlib.compress(b"\x00\x7f"))
            + _chunk(b"IEND", b""))  # Adam7 at 1 x 1: only the first pass has a row
    np.testing.assert_array_equal(im.png_decode_rgb(data), _pillow_rgb(data))
    arr = np.zeros((8, 8, 3), np.uint8)
    path = tmp_path / "x.jpg"  # baseline JPEG: decoded as Pillow decodes it
    PIL.Image.fromarray(arr).save(path, format="JPEG")
    np.testing.assert_array_equal(im.read_image_rgb(str(path)),
                                  np.asarray(PIL.Image.open(path).convert("RGB")))
    path = tmp_path / "p.jpg"  # progressive JPEG (once refused): as Pillow
    PIL.Image.fromarray(arr).save(path, format="JPEG", progressive=True)
    np.testing.assert_array_equal(im.read_image_rgb(str(path)),
                                  np.asarray(PIL.Image.open(path).convert("RGB")))
    path = tmp_path / "y.webp"
    PIL.Image.fromarray(arr).save(path, format="WEBP")
    np.testing.assert_array_equal(im.read_image_rgb(str(path)),
                                  np.asarray(PIL.Image.open(path).convert("RGB")))
    path = tmp_path / "z.gif"  # GIF (once refused): as Pillow
    PIL.Image.fromarray(arr).save(path, format="GIF")
    np.testing.assert_array_equal(im.read_image_rgb(str(path)),
                                  np.asarray(PIL.Image.open(path).convert("RGB")))
    path = tmp_path / "z.ppm"  # Netpbm (once refused): as Pillow
    PIL.Image.fromarray(arr).save(path, format="PPM")
    np.testing.assert_array_equal(im.read_image_rgb(str(path)),
                                  np.asarray(PIL.Image.open(path).convert("RGB")))
    path = tmp_path / "z.dds"  # DDS (once refused): as Pillow
    PIL.Image.fromarray(arr).save(path, format="DDS")
    np.testing.assert_array_equal(im.read_image_rgb(str(path)),
                                  np.asarray(PIL.Image.open(path).convert("RGB")))
    path = tmp_path / "z.avif"  # AVIF: still refused, naming the file and item 28
    path.write_bytes(b"\0\0\0\x1cftypavif" + bytes(124))
    with pytest.raises(ValueError, match=r"z\.avif.*AVIF.*item 28"):
        im.read_image_rgb(str(path))
    path = tmp_path / "x.png"
    path.write_bytes(im.png_bytes(arr))
    np.testing.assert_array_equal(im.read_image_rgb(str(path)), arr)


# (in h, in w) -> (out w, out h): up, down and mixed
LANCZOS = [((64, 64), (32, 32)), ((256, 256), (32, 32)), ((47, 53), (32, 32)),
           ((160, 160), (256, 256)), ((31, 29), (64, 64)), ((100, 300), (33, 120)),
           ((512, 384), (256, 256)), ((1024, 1024), (256, 256)), ((40, 48), (7, 5)),
           ((32, 32), (1024, 1024)), ((300, 100), (160, 160)), ((64, 64), (64, 64))]


@pytest.mark.parametrize("hw,size", LANCZOS)
def test_pil_lanczos_is_bit_exact(hw, size):
    h, w = hw
    rng = np.random.RandomState(h * 7 + w)
    noise = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([127.5 + 127.5 * np.sin(xx / 9.0 + yy / 13.0 + c)
                       for c in range(3)], -1).astype(np.uint8)
    for arr in (noise, smooth):
        want = np.asarray(PIL.Image.fromarray(arr).resize(size, PIL.Image.LANCZOS))
        got = im.pil_resize_lanczos(arr, size)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_load_images_matches_the_jax_cli(tmp_path):
    """A directory of mixed PNGs (RGB, RGBA, gray, palette; square, wide,
    tall), centre-cropped and LANCZOS-resized, bit for bit."""
    rng = np.random.RandomState(1)
    shapes = [(40, 48), (48, 40), (32, 32), (70, 50), (33, 90)]
    for i, (h, w) in enumerate(shapes):
        arr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        img = PIL.Image.fromarray(arr)
        img = [img, img.convert("RGBA"), img.convert("L"),
               img.convert("P", palette=PIL.Image.ADAPTIVE), img][i]
        img.save(tmp_path / f"im{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    for size in (32, 64):
        got = load_images(str(tmp_path), size)
        want = jax_load_images(str(tmp_path), size)
        assert got.shape == (len(shapes), size, size, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
