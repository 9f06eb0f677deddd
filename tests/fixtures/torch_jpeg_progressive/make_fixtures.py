"""Writes the progressive, CMYK and YCCK JPEG fixtures of this directory with
Pillow, and their Pillow decodes (``Image.open(p).convert("RGB")``), for the
machines that have no Pillow (chip_smoke.py phase 52,
tests/test_torch_jpeg_progressive.py):

    python tests/fixtures/torch_jpeg_progressive/make_fixtures.py

The photo-like images of tests/fixtures/torch_jpeg/make_fixtures.py:
- prog_gray_75x90.jpg: grayscale, progressive;
- prog_444_96x80.jpg, prog_422_128.jpg, prog_420_218x178.jpg: progressive
  YCbCr at 4:4:4, 4:2:2 and 4:2:0 (the last with optimised tables);
- prog_odd_37x53_420.jpg: an odd size, 4:2:0;
- prog_restart_120x100_420.jpg: a restart marker every 3 MCUs;
- prog_256_420.jpg: 256 x 256, 4:2:0, the photo phase 52 inverts with bp;
- cmyk_64x48.jpg, cmyk_prog_64x48.jpg: CMYK, sequential and progressive;
- ycck_64x48.jpg, ycck_prog_40x56.jpg: a CMYK file of Pillow's with its
  Adobe transform byte set to 2, which Pillow then decodes as YCCK (Pillow
  writes no YCCK).
decodes.npz holds each decode as <name>.npy; decodes.json each decode's
shape and SHA-256."""

import hashlib
import importlib.util
import io
import json
import os

import numpy as np
import PIL.Image

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "torch_jpeg_fixtures", os.path.join(HERE, "..", "torch_jpeg", "make_fixtures.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
photo = _base.photo

FIXTURES = {  # name: (h, w, seed, mode, save options, Adobe transform to write)
    "prog_gray_75x90": (75, 90, 11, "L", {"quality": 80}, None),
    "prog_444_96x80": (96, 80, 12, "RGB", {"quality": 90, "subsampling": 0}, None),
    "prog_422_128": (128, 128, 13, "RGB", {"quality": 85, "subsampling": 1}, None),
    "prog_420_218x178": (218, 178, 14, "RGB",
                         {"quality": 90, "subsampling": 2, "optimize": True}, None),
    "prog_odd_37x53_420": (37, 53, 15, "RGB", {"quality": 75, "subsampling": 2}, None),
    "prog_restart_120x100_420": (120, 100, 16, "RGB",
                                 {"quality": 75, "subsampling": 2,
                                  "restart_marker_blocks": 3}, None),
    "prog_256_420": (256, 256, 17, "RGB", {"quality": 85, "subsampling": 2}, None),
    "cmyk_64x48": (64, 48, 18, "CMYK", {"quality": 85, "progressive": False}, None),
    "cmyk_prog_64x48": (64, 48, 19, "CMYK", {"quality": 85}, None),
    "ycck_64x48": (64, 48, 20, "CMYK", {"quality": 85, "progressive": False}, 2),
    "ycck_prog_40x56": (40, 56, 21, "CMYK", {"quality": 85}, 2),
}


def adobe_transform(data: bytes, transform: int) -> bytes:
    """The file with its Adobe APP14 marker's transform byte set."""
    i = data.index(b"\xff\xee")
    assert data[i + 4:i + 9] == b"Adobe"
    return data[:i + 4 + 11] + bytes([transform]) + data[i + 4 + 12:]


def main() -> None:
    decodes, meta = {}, {}
    for name, (h, w, seed, mode, opts, transform) in FIXTURES.items():
        buf = io.BytesIO()
        opts = {"progressive": True, **opts}
        PIL.Image.fromarray(photo(h, w, seed)).convert(mode).save(buf, "JPEG", **opts)
        data = buf.getvalue()
        if transform is not None:
            data = adobe_transform(data, transform)
        path = os.path.join(HERE, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(data)
        dec = np.asarray(PIL.Image.open(path).convert("RGB"))
        meta[name] = {"shape": list(dec.shape),
                      "sha256": hashlib.sha256(dec.tobytes()).hexdigest()}
        decodes[name] = dec
    np.savez_compressed(os.path.join(HERE, "decodes.npz"), **decodes)
    meta["pillow"] = PIL.__version__
    with open(os.path.join(HERE, "decodes.json"), "w") as f:
        json.dump(meta, f, indent=1)


if __name__ == "__main__":
    main()
