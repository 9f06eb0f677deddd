"""Writes the fixtures of TIFF's other codecs (ROADMAP item 28.7: CCITT with
the uncompressed-mode bit and RLEW, ThunderScan, LZMA, ZSTD, old-style JPEG;
fault C.15's reproducer) and records Pillow 12.1's decode of each, for the
card's machine, which has no Pillow (chip_smoke.py phase 58):

    PYTHONPATH=.:tests python tests/fixtures/torch_image_tiff_codecs/make_fixtures.py

The files are tests/test_torch_image_tiff_codecs.py:fixture_forms and the
256 px ZSTD photo phase 58 times (``zstd_photo``). Writes beside this file
``<form>.tif``, decodes.npz (each small file's ``Image.open(f).convert("RGB")``
under its form's name) and decodes.json (each decode's shape and SHA-256, and
Pillow's and libtiff's versions); the photo is held by its digest alone.
"""

import hashlib
import io
import json
import os

import numpy as np
import PIL.features
import PIL.Image

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    import test_torch_image_tiff_codecs as t

    meta = {"pillow": PIL.__version__, "libtiff": PIL.features.version("libtiff")}
    small = {}
    for old in os.listdir(HERE):
        if old.endswith(".tif"):
            os.remove(os.path.join(HERE, old))
    forms = {**t.fixture_forms(), "zstd_photo_256": t.zstd_photo()}
    for name, data in forms.items():
        with open(os.path.join(HERE, f"{name}.tif"), "wb") as f:
            f.write(data)
        a = np.ascontiguousarray(np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB")))
        meta[name] = {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
        if name != "zstd_photo_256":
            small[name] = a
    np.savez_compressed(os.path.join(HERE, "decodes.npz"), **small)
    with open(os.path.join(HERE, "decodes.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
