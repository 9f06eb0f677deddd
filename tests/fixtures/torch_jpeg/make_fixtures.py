"""Writes the JPEG fixtures of this directory with Pillow, and their Pillow
decodes (``Image.open(p).convert("RGB")``), for the machines that have no
Pillow to write a JPEG (chip_smoke.py phase 38, tests/test_torch_jpeg.py):

    python tests/fixtures/torch_jpeg/make_fixtures.py

Photo-like images (coloured blobs, a texture, mild noise) made from a seed:
- photo_218x178_420.jpg: a CelebA-sized photo, 4:2:0, quality 90;
- photo_256_422.jpg: 256 x 256, 4:2:2, quality 85;
- gray_75x90.jpg: grayscale, quality 80;
- restart_120x100_420.jpg: 4:2:0 with a restart marker every MCU row;
- photo_1024_420.jpg: 1024 x 1024, 4:2:0, quality 85.
decodes.npz holds each decode as <name>.npy but the 1024 px one's (3 MB);
decodes.json holds every decode's shape and SHA-256."""

import hashlib
import json
import os

import numpy as np
import PIL.Image

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = {  # name: (h, w, seed, mode, save options)
    "photo_218x178_420": (218, 178, 1, "RGB", {"quality": 90, "subsampling": 2}),
    "photo_256_422": (256, 256, 2, "RGB", {"quality": 85, "subsampling": 1}),
    "gray_75x90": (75, 90, 3, "L", {"quality": 80}),
    "restart_120x100_420": (120, 100, 4, "RGB",
                            {"quality": 75, "subsampling": 2, "restart_marker_rows": 1}),
    "photo_1024_420": (1024, 1024, 5, "RGB", {"quality": 85, "subsampling": 2}),
}
NO_NPY = ("photo_1024_420",)


def photo(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.zeros((h, w, 3))
    for _ in range(12):
        cy, cx, s = rng.rand(), rng.rand(), 0.05 + 0.3 * rng.rand()
        img += (rng.rand(3) * 255) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                            / (2 * s * s))[..., None]
    img = img / img.max() * 200 + 30 * np.sin(40 * xx + 25 * yy)[..., None] * rng.rand(3)
    img += rng.randn(h, w, 3) * 3
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> None:
    decodes, meta = {}, {}
    for name, (h, w, seed, mode, opts) in FIXTURES.items():
        path = os.path.join(HERE, f"{name}.jpg")
        PIL.Image.fromarray(photo(h, w, seed)).convert(mode).save(path, "JPEG", **opts)
        dec = np.asarray(PIL.Image.open(path).convert("RGB"))
        meta[name] = {"shape": list(dec.shape),
                      "sha256": hashlib.sha256(dec.tobytes()).hexdigest()}
        if name not in NO_NPY:
            decodes[name] = dec
    np.savez_compressed(os.path.join(HERE, "decodes.npz"), **decodes)
    meta["pillow"] = PIL.__version__
    with open(os.path.join(HERE, "decodes.json"), "w") as f:
        json.dump(meta, f, indent=1)


if __name__ == "__main__":
    main()
