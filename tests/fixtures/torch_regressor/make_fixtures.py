"""Writes the regressor trainer's fixture set of this directory, in the
reference's scene-data layout (folder/*/* images, a tab-separated label
file, train/test split lists), for the CLI flow of
``latent2im_tpu_torch.cli.train_regressor`` on machines without Pillow
(chip_smoke.py, tests/test_torch_regressor.py):

    python tests/fixtures/torch_regressor/make_fixtures.py

- imgs/<scene>/<n>.jpg and .png: ten photo-like images (the photo of
  tests/fixtures/torch_jpeg/make_fixtures.py) of 48-90 px a side, baseline
  JPEGs (4:2:0, 4:2:2, 4:4:4, grayscale) and PNGs, in three scene folders;
- annotations.tsv: 'scene/file' then NUM_OUTPUTS 'value,confidence' pairs,
  tab-separated, values seeded in [0, 1];
- split/training.txt (seven keys) and split/test.txt (three)."""

import os
import sys

import numpy as np
import PIL.Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "torch_jpeg"))
from make_fixtures import photo  # noqa: E402

NUM_OUTPUTS = 40
IMAGES = [  # (scene, file, h, w, save options; None: PNG)
    ("beach", "00000001.jpg", 64, 80, {"quality": 90, "subsampling": 2}),
    ("beach", "00000002.png", 72, 60, None),
    ("beach", "00000003.jpg", 90, 70, {"quality": 85, "subsampling": 1}),
    ("city", "00000004.jpg", 48, 64, {"quality": 80, "subsampling": 0}),
    ("city", "00000005.png", 66, 66, None),
    ("city", "00000006.jpg", 70, 56, {"quality": 88, "subsampling": 2}),
    ("forest", "00000007.jpg", 60, 84, {"quality": 75, "subsampling": 2}),
    ("forest", "00000008.png", 58, 72, None),
    ("forest", "00000009.jpg", 80, 64, "L"),
    ("forest", "00000010.png", 64, 64, None),
]
TEST = ("beach/00000002.png", "city/00000004.jpg", "forest/00000009.jpg")


def main() -> None:
    rng = np.random.RandomState(12)
    lines, keys = [], []
    for i, (scene, name, h, w, opts) in enumerate(IMAGES):
        os.makedirs(os.path.join(HERE, "imgs", scene), exist_ok=True)
        path = os.path.join(HERE, "imgs", scene, name)
        im = PIL.Image.fromarray(photo(h, w, 100 + i))
        if opts is None:
            im.save(path, "PNG")
        elif opts == "L":
            im.convert("L").save(path, "JPEG", quality=85)
        else:
            im.save(path, "JPEG", **opts)
        key = f"{scene}/{name}"
        keys.append(key)
        vals = rng.uniform(0, 1, NUM_OUTPUTS)
        conf = rng.uniform(0, 1, NUM_OUTPUTS)
        lines.append("\t".join([key] + [f"{v:.4f},{c:.4f}" for v, c in zip(vals, conf)]))
    with open(os.path.join(HERE, "annotations.tsv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    os.makedirs(os.path.join(HERE, "split"), exist_ok=True)
    with open(os.path.join(HERE, "split", "training.txt"), "w") as f:
        f.write("".join(k + "\n" for k in keys if k not in TEST))
    with open(os.path.join(HERE, "split", "test.txt"), "w") as f:
        f.write("".join(k + "\n" for k in TEST))


if __name__ == "__main__":
    main()
