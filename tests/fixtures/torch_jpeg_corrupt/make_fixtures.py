"""Writes corrupt JPEGs, one or two of each recovery libjpeg makes (ROADMAP
fault C.11), and records what Pillow 12.1 and the JAX package's native
extension (libjpeg-turbo 2.1.5 over a whole buffer) make of them, for the
card's machine, which has neither (chip_smoke.py phase 55), and for
tests/test_torch_jpeg_corrupt.py:

    PYTHONPATH=.:tests python tests/fixtures/torch_jpeg_corrupt/make_fixtures.py

Needs the JAX package with its extension built, Pillow and numpy. Writes
beside this file the files of ``files()``, decodes.npz (Pillow's decode of
each file it decodes, under its name less the extension) and record.json:

- ``pillow``: each file's decode's shape and SHA-256, or "fail";
- ``extension``: ``load_resize`` of each file at ``SIZES``: SHA-256 or
  "fail";
- ``loader``: the extension's Loader over every file here (sorted),
  ``LOADER_SIZE`` px, batches of ``LOADER_BATCH``, epoch 0 shuffled by seed
  0: each batch's indices and SHA-256;
- ``regressor``: the JAX regressor trainer's batches on ``REG_SPLIT`` (the
  training split, corrupt JPEGs, through the native Loader over two epochs;
  the test split, tests/fixtures/torch_image_formats' files, through
  Pillow), as tests/fixtures/torch_native/gen_native.py records them.
"""

import hashlib
import io
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import PIL.Image

import jpeg_corrupt_corpus as cc
from jpeg_arith_encoder import arith_jpeg

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.dirname(HERE)
REPO = os.path.dirname(os.path.dirname(FIX))
SIZES = (16, 48, 61)
LOADER_SIZE, LOADER_BATCH = 48, 3
REG_SPLIT = {
    "training": ["a/bad_code.jpg", "a/restart_resync.jpg", "a/no_dht.jpg", "b/no_eoi.jpg",
                 "b/progressive_marker.jpg"],
    "test": ["b/tga.tga", "b/pcx.pcx", "c/tiff_jpeg.tif", "c/tiff_g4.tif", "c/qoi.qoi",
             "c/sgi.sgi"],
}
REG_FILES = {
    "a/bad_code.jpg": "torch_jpeg_corrupt/bad_code_baseline_64x48.jpg",
    "a/restart_resync.jpg": "torch_jpeg_corrupt/inserted_rst_restart_64x48.jpg",
    "a/no_dht.jpg": "torch_jpeg_corrupt/no_dht_baseline_64x48.jpg",
    "b/no_eoi.jpg": "torch_jpeg_corrupt/no_eoi_baseline_64x48.jpg",
    "b/progressive_marker.jpg": "torch_jpeg_corrupt/inserted_marker_progressive_64x48.jpg",
    "b/tga.tga": "torch_image_formats/tga_rle_bottom_up_37x29.tga",
    "b/pcx.pcx": "torch_image_formats/pcx_rgb_37x29.pcx",
    "c/tiff_jpeg.tif": "torch_image_formats/tiff_jpeg_ycbcr_420_37x29.tif",
    "c/tiff_g4.tif": "torch_image_formats/tiff_g4_61x40.tif",
    "c/qoi.qoi": "torch_image_formats/qoi_rgba_37x29.qoi",
    "c/sgi.sgi": "torch_image_formats/sgi_rle_rgba16_37x29.sgi",
}
REG_SIZE, REG_BATCH, REG_EPOCHS = 64, 2, 2


def _pillow(data):
    try:
        return np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def _first(cases, kind, want_decode=True, clean=None):
    """The first corpus case of ``kind`` that Pillow decodes (to other
    pixels than the clean file), or fails where want_decode is False."""
    for label, data in cases:
        if not label.startswith(kind):
            continue
        got = _pillow(data)
        if want_decode and got is not None and (clean is None or not np.array_equal(got, clean)):
            return data
        if not want_decode and got is None:
            return data
    raise AssertionError(f"no {kind} case")


def _strip(data, code):
    for p, c in reversed(cc.markers(data)):
        if c == code:
            data = data[:p] + data[p + 2 + int.from_bytes(data[p + 2:p + 4], "big"):]
    return data


def files() -> dict:
    src, big = cc.sources(), cc.sources(large=True)
    b, p, r, g = src["baseline"], src["progressive"], src["restart"], src["gray"]
    sos = [q for q, c in cc.markers(b) if c == 0xDA][0]
    n = int.from_bytes(b[sos + 2:sos + 4], "big")
    s0 = cc.scan_ranges(b)[0][0]
    rst3 = [q for q, c in cc.markers(r) if c == 0xD3][0]
    off = 65536 - 3  # the DHT's length across Pillow's first 64 KiB read
    return {
        # 0xFF bytes mid-scan: 16 one bits, no code of the table (JWRN_HUFF_BAD_CODE)
        "bad_code_baseline_64x48.jpg": b[:s0 + 100] + b"\xff\x00\xff\x00\xff\x00"
        + b[s0 + 106:],
        "overwritten_baseline_64x48.jpg": _first(cc.corrupt(b, 11, 40), "overwrite",
                                                 clean=_pillow(b)),
        "inserted_rst_restart_64x48.jpg": r[:rst3] + r[rst3 + 2:rst3 + 40] + b"\xff\xd6"
        + r[rst3 + 40:],
        "inserted_marker_progressive_64x48.jpg": _first(cc.corrupt(p, 12, 40), "insert",
                                                        clean=_pillow(p)),
        "garbage_before_marker_gray_64x48.jpg": _first(cc.corrupt(g, 13, 40), "garbage",
                                                       clean=None),
        "no_dht_baseline_64x48.jpg": _strip(b, 0xC4),
        "not_sequential_64x48.jpg": b[:sos + 2 + n - 3] + b"\x00\x00\x00" + b[sos + 2 + n:],
        "tail_segment_cut_64x48.jpg": b[:-2] + b"\xff\xe1\x40\x00abc",
        "no_eoi_baseline_64x48.jpg": b[:-2],
        "cut_progressive_64x48.jpg": p[:len(p) * 2 // 3],
        "arith_overwritten_64x48.jpg": _first(cc.corrupt(arith_jpeg(b, restart=2), 14, 40),
                                              "overwrite"),
        "large_inserted_dht_at_64k_340x250.jpg": big["large_baseline"][:off] + b"\xff\xc4"
        + big["large_baseline"][off:],
    }


def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def main():
    sys.path.insert(0, REPO)
    from latent2im_tpu.cli import train_regressor as jtr
    from latent2im_tpu.native import _l2i_native as nat

    rec = {"pillow": {}, "extension": {}, "pillow_version": PIL.__version__}
    decodes = {}
    for name, data in files().items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        a = _pillow(data)
        if a is None:
            rec["pillow"][name] = "fail"
        else:
            rec["pillow"][name] = {"shape": list(a.shape), "sha256": sha(a)}
            decodes[os.path.splitext(name)[0]] = a
        rec["extension"][name] = {}
        for size in SIZES:
            try:
                got = sha(nat.load_resize(path, size))
            except OSError:
                got = "fail"
            rec["extension"][name][str(size)] = got
    np.savez_compressed(os.path.join(HERE, "decodes.npz"), **decodes)
    names = sorted(n for n in os.listdir(HERE) if n.endswith(".jpg"))
    loader = nat.Loader([os.path.join(HERE, n) for n in names], LOADER_SIZE, LOADER_BATCH,
                        threads=2)
    loader.start_epoch(seed=0, shuffle=True)
    batches = []
    while True:
        try:
            raw, idx = loader.next_batch()
        except StopIteration:
            break
        batches.append({"idx": idx, "sha256": sha(np.frombuffer(raw, np.uint8).reshape(
            len(idx), LOADER_SIZE, LOADER_SIZE, 3))})
    rec["loader"] = {"files": names, "size": LOADER_SIZE, "batch": LOADER_BATCH,
                     "batches": batches}
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "reg"))
        for key, rel in REG_FILES.items():
            os.makedirs(os.path.join(d, "reg", os.path.dirname(key)), exist_ok=True)
            shutil.copy(os.path.join(FIX, rel), os.path.join(d, "reg", key))
        split = {}
        for part, keys in REG_SPLIT.items():
            with open(os.path.join(d, f"{part}.txt"), "w") as f:
                f.write("\n".join(keys) + "\n")
            split[part] = jtr.list_split(os.path.join(d, "reg"), os.path.join(d, f"{part}.txt"))
        train = [q for q, _ in split["training"]]
        reg_loader = nat.Loader(train, REG_SIZE, REG_BATCH, threads=2)
        training = []
        for e in range(REG_EPOCHS):
            reg_loader.start_epoch(seed=e, shuffle=True)
            while True:
                try:
                    raw, idx = reg_loader.next_batch()
                except StopIteration:
                    break
                training.append({"epoch": e, "idx": idx, "sha256": sha(np.frombuffer(
                    raw, np.uint8).reshape(len(idx), REG_SIZE, REG_SIZE, 3))})
        test = [q for q, _ in split["test"]]
        tests = [{"idx": [int(i) for i in idx], "sha256": sha(u8)} for u8, idx in
                 jtr._pil_batches(test, REG_SIZE, REG_BATCH, np.arange(len(test)))]
        rec["regressor"] = {"files": REG_FILES, "split": REG_SPLIT, "size": REG_SIZE,
                            "batch": REG_BATCH, "training": training, "test": tests}
    with open(os.path.join(HERE, "record.json"), "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
