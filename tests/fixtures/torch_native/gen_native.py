"""Writes the fixtures of the native path (latent2im_tpu_torch/native/) and
records what the JAX package's native extension (native/l2i_native.cpp,
libjpeg-turbo 2.1 and libpng 1.6) makes of them, for the machines that have
neither (chip_smoke.py phase 54) and for tests/test_torch_native.py:

    PYTHONPATH=. python tests/fixtures/torch_native/gen_native.py

Needs the JAX package with its extension built (``from latent2im_tpu.native
import _l2i_native`` imports), Pillow and numpy. Writes, beside this file:

- the PNG kinds libpng treats apart from Pillow (RGBA, gray + alpha, a
  palette with tRNS, 16-bit RGBA, gAMA 1/1.8, sRGB beside a gAMA, 16-bit
  gray with sBIT 10) and the JPEGs it decodes apart (cut baseline and
  progressive files, which it fills; CMYK, which it fails);
- native.json:
  - ``load_resize``: for each photo of ``PHOTOS`` (these files and the
    other fixture directories') and each size below, at and above its crop,
    the SHA-256 of ``load_resize``'s bytes, or "fail";
  - ``orders``: the Loader's index lists over epochs 0-3 for several
    numbers of files and batch sizes (``ORDERS``);
  - ``gan_stream``: ``cli/train.py:_make_real_batcher``'s first
    ``GAN_BATCHES`` batches at ``GAN_SIZE`` px, batch ``GAN_BATCH``, on a
    directory holding ``GAN_DIR``'s files under their names there (two
    epoch boundaries, ragged tails): each batch's SHA-256;
  - ``regressor``: the JAX regressor trainer's batches on ``REG_SPLIT``
    (the training split through the native Loader, epochs 0 and 1; the test
    split through Pillow, ``_pil_batches``): each batch's SHA-256 and its
    indices.
"""

import hashlib
import io
import json
import os
import shutil
import struct
import sys
import tempfile
import zlib

import numpy as np
import PIL.Image

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.dirname(HERE)
REPO = os.path.dirname(os.path.dirname(FIX))

# photos held to the extension: (path under tests/fixtures, the sizes)
PHOTOS = {
    "torch_native/rgba_40x32.png": (16, 32, 45),
    "torch_native/ga_33x29.png": (16, 29, 42),
    "torch_native/palette_trns_37x31.png": (16, 31, 44),
    "torch_native/png16_rgba_31x27.png": (16, 27, 40),
    "torch_native/gama_1_8_35x30.png": (16, 30, 43),
    "torch_native/srgb_and_gama_30x30.png": (16, 30, 43),
    "torch_native/gray16_sbit10_29x23.png": (16, 23, 36),
    "torch_native/cut_baseline_64x48.jpg": (16, 48, 61),
    "torch_native/cut_progressive_64x48.jpg": (16, 48, 61),
    "torch_native/cmyk_40x30.jpg": (16, 30, 43),
    "torch_jpeg/photo_256_422.jpg": (64, 256, 300),
    "torch_jpeg/photo_218x178_420.jpg": (64, 178, 256),
    "torch_jpeg/photo_1024_420.jpg": (256, 1024, 1100),
    "torch_jpeg/gray_75x90.jpg": (16, 75, 99),
    "torch_jpeg_progressive/prog_256_420.jpg": (64, 256, 300),
    "torch_image_kinds/arith_420_restart_dac_64x48.jpg": (16, 48, 61),
    "torch_image_kinds/png16_256.png": (64, 256, 300),
    "torch_image_kinds/adam7_c3_d4_19x13.png": (8, 13, 26),
    "torch_image_kinds/webp_lossy_q5_37x53.webp": (16,),
    "torch_image_kinds/gif_quantized_trns_64x48.gif": (16,),
    "torch_image_kinds/bmp_p8_64x48.bmp": (16,),
}
ORDERS = [(1, 1), (2, 3), (5, 2), (5, 4), (37, 4), (37, 32), (1000, 32)]
# --updateGAN's directory: name there <- fixture
GAN_DIR = {
    "a_photo_256.jpg": "torch_jpeg/photo_256_422.jpg",
    "b_photo_218x178.jpg": "torch_jpeg/photo_218x178_420.jpg",
    "c_rgba.png": "torch_native/rgba_40x32.png",
    "d_cmyk.jpg": "torch_native/cmyk_40x30.jpg",
    "e_cut_progressive.jpg": "torch_native/cut_progressive_64x48.jpg",
    "f_palette_trns.png": "torch_native/palette_trns_37x31.png",
}
GAN_SIZE, GAN_BATCH, GAN_BATCHES = 256, 4, 4
# the regressor's split: scene/name <- fixture; training and test lists
REG_FILES = {
    "beach/a.gif": "torch_image_kinds/gif_quantized_trns_64x48.gif",
    "beach/b.jpg": "torch_native/cmyk_40x30.jpg",
    "beach/c.png": "torch_native/palette_trns_37x31.png",
    "city/d.jpg": "torch_jpeg/photo_218x178_420.jpg",
    "city/e.png": "torch_native/png16_rgba_31x27.png",
    "city/f.bmp": "torch_image_kinds/bmp_rle8_31x23.bmp",
    "city/g.tif": "torch_image_kinds/tiff_rgb_lzw_predictor_64x48.tif",
}
REG_SPLIT = {"training": ["beach/a.gif", "beach/b.jpg", "beach/c.png", "city/d.jpg",
                          "city/e.png"],
             "test": ["beach/a.gif", "city/f.bmp", "city/g.tif"]}
REG_SIZE, REG_BATCH, REG_EPOCHS, REG_OUT = 64, 2, 2, 40


def photo(h, w, seed):
    y, x = np.mgrid[0:h, 0:w]
    rng = np.random.RandomState(seed)
    base = np.stack([(x * 255) // max(w - 1, 1), (y * 255) // max(h - 1, 1),
                     ((x + y) * 127) // max(w + h - 2, 1)], -1)
    return np.clip(base + rng.randint(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


def _chunk(tag, body):
    return struct.pack(">I", len(body)) + tag + body + struct.pack(
        ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def png(samples, color, depth, pre=b"", plte=None, trns=None):
    """samples [h, w, spp] -> PNG bytes (filter 0), ``pre``: chunks before PLTE."""
    s = np.asarray(samples)
    h, w, _ = s.shape
    rows = s.astype(">u2").reshape(h, -1).view(np.uint8) if depth == 16 else \
        s.astype(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                                           0, 0, 0)) + pre
    if plte is not None:
        out += _chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def files() -> dict:
    rng = np.random.RandomState(5)
    alpha = rng.randint(0, 256, (32, 40, 1))
    alpha[:4] = 0
    alpha[4:8] = 255
    pal = photo(16, 16, 6).reshape(-1, 3)
    jpg = io.BytesIO()
    PIL.Image.fromarray(photo(48, 64, 7)).save(jpg, "JPEG", quality=85)
    prog = io.BytesIO()
    PIL.Image.fromarray(photo(48, 64, 8)).save(prog, "JPEG", quality=85, progressive=True,
                                               subsampling=2)
    cmyk = io.BytesIO()
    PIL.Image.fromarray(photo(30, 40, 9)).convert("CMYK").save(cmyk, "JPEG")
    g16 = (photo(23, 29, 10)[..., :1].astype(np.int64) * 257) ^ rng.randint(0, 256, (23, 29, 1))
    return {
        "rgba_40x32.png": png(np.concatenate([photo(32, 40, 11), alpha], -1), 6, 8),
        "ga_33x29.png": png(np.concatenate([photo(29, 33, 12)[..., :1],
                                            rng.randint(0, 256, (29, 33, 1))], -1), 4, 8),
        "palette_trns_37x31.png": png(rng.randint(0, 256, (31, 37, 1)), 3, 8, plte=pal,
                                      trns=bytes(rng.randint(0, 256, 200).tolist())),
        "png16_rgba_31x27.png": png(rng.randint(0, 65536, (27, 31, 4)), 6, 16),
        "gama_1_8_35x30.png": png(photo(30, 35, 13), 2, 8,
                                  pre=_chunk(b"gAMA", struct.pack(">I", 55556))),
        "srgb_and_gama_30x30.png": png(np.concatenate([photo(30, 30, 14), alpha[:30, :30]], -1),
                                       6, 8, pre=_chunk(b"sRGB", b"\x00")
                                       + _chunk(b"gAMA", struct.pack(">I", 100000))),
        "gray16_sbit10_29x23.png": png(g16, 0, 16, pre=_chunk(b"sBIT", b"\x0a")),
        "cut_baseline_64x48.jpg": jpg.getvalue()[:len(jpg.getvalue()) * 3 // 5],
        "cut_progressive_64x48.jpg": prog.getvalue()[:len(prog.getvalue()) * 3 // 5],
        "cmyk_40x30.jpg": cmyk.getvalue(),
    }


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def main():
    sys.path.insert(0, REPO)
    from latent2im_tpu.cli import train as jcli
    from latent2im_tpu.cli import train_regressor as jtr
    from latent2im_tpu.native import _l2i_native as nat

    for name, data in files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
    out = {"load_resize": {}, "orders": {}}
    for rel, sizes in PHOTOS.items():
        out["load_resize"][rel] = {}
        for size in sizes:
            try:
                got = sha(nat.load_resize(os.path.join(FIX, rel), size))
            except OSError:
                got = "fail"
            out["load_resize"][rel][str(size)] = got
    for n, b in ORDERS:
        loader = nat.Loader([os.path.join(HERE, "missing")] * n, 1, b, threads=1)
        epochs = []
        for e in range(4):
            loader.start_epoch(seed=e, shuffle=True)
            lists = []
            while True:
                try:
                    lists.append(loader.next_batch()[1])
                except StopIteration:
                    break
            epochs.append(lists)
        out["orders"][f"{n}_{b}"] = epochs
    with tempfile.TemporaryDirectory() as d:
        for name, rel in GAN_DIR.items():
            shutil.copy(os.path.join(FIX, rel), os.path.join(d, name))
        paths = sorted(os.path.join(d, n) for n in GAN_DIR)
        nxt = jcli._make_real_batcher(paths, GAN_SIZE, GAN_BATCH)
        out["gan_stream"] = {"size": GAN_SIZE, "batch": GAN_BATCH, "files": GAN_DIR,
                             "sha256": [sha(nxt()) for _ in range(GAN_BATCHES)]}
        os.makedirs(os.path.join(d, "reg"))
        for key, rel in REG_FILES.items():
            os.makedirs(os.path.join(d, "reg", os.path.dirname(key)), exist_ok=True)
            shutil.copy(os.path.join(FIX, rel), os.path.join(d, "reg", key))
        split = {}
        for part, keys in REG_SPLIT.items():
            with open(os.path.join(d, f"{part}.txt"), "w") as f:
                f.write("\n".join(keys) + "\n")
            split[part] = jtr.list_split(os.path.join(d, "reg"), os.path.join(d, f"{part}.txt"))
        train = [p for p, _ in split["training"]]
        loader = nat.Loader(train, REG_SIZE, REG_BATCH, threads=2)
        training = []
        for e in range(REG_EPOCHS):
            loader.start_epoch(seed=e, shuffle=True)
            while True:
                try:
                    raw, idx = loader.next_batch()
                except StopIteration:
                    break
                training.append({"epoch": e, "idx": idx, "sha256": sha(np.frombuffer(
                    raw, np.uint8).reshape(len(idx), REG_SIZE, REG_SIZE, 3))})
        test = [p for p, _ in split["test"]]
        tests = [{"idx": [int(i) for i in idx], "sha256": sha(u8)} for u8, idx in
                 jtr._pil_batches(test, REG_SIZE, REG_BATCH, np.arange(len(test)))]
        out["regressor"] = {"files": REG_FILES, "split": REG_SPLIT, "size": REG_SIZE,
                            "batch": REG_BATCH, "training": training, "test": tests,
                            "keys": {k: [key for _, key in v] for k, v in split.items()}}
    out["pillow"] = PIL.__version__
    with open(os.path.join(HERE, "native.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
