"""Writes the fixtures of the legacy formats (ROADMAP item 28.6: DCX, XBM,
XPM, MSP, Sun raster, FLI/FLC, FITS, SPIDER, IM, McIdas, GBR, PhotoCD,
PIXAR, XV thumbnails, IMT and IPTC; utils/dcx.py ... iptc.py) and records
Pillow 12.1's decode of each, for the card's machine, which has no Pillow
(chip_smoke.py phase 57):

    PYTHONPATH=.:tests python tests/fixtures/torch_image_legacy/make_fixtures.py

The files are tests/test_torch_image_legacy.py's forms that Pillow reads
(one PhotoCD image of the four, the one turned by 90 degrees). Writes
beside this file ``<form>.<ext>``, decodes.npz (each small file's
``Image.open(f).convert("RGB")`` under its form's name) and decodes.json
(each decode's shape and SHA-256, and Pillow's version); the PhotoCD
image is held by its digest alone.
"""

import hashlib
import io
import json
import os

import numpy as np
import PIL.Image

HERE = os.path.dirname(os.path.abspath(__file__))
EXT = {"dcx": "dcx", "xbm": "xbm", "xpm": "xpm", "msp": "msp", "sun": "ras", "fli": "flc",
       "fits": "fits", "spider": "spi", "im": "im", "mcidas": "area", "gbr": "gbr",
       "pcd": "pcd", "pixar": "pxr", "xvthumb": "xvt", "imt": "imt", "iptc": "iim"}


def files() -> dict:
    """{form: bytes}: the test's forms that Pillow decodes, PhotoCD's
    turned one only."""
    import test_torch_image_legacy as t

    out = {}
    for name, data in sorted(t.FORMS.items()):
        if name.startswith("pcd") and name != "pcd_orient1":
            continue
        if t._pillow(data) is not None:
            out[name.replace(" ", "_").replace(";", "")] = data
    return out


def main():
    meta = {"pillow": PIL.__version__}
    small = {}
    for old in os.listdir(HERE):
        if old.split(".")[-1] in EXT.values():
            os.remove(os.path.join(HERE, old))
    for name, data in files().items():
        with open(os.path.join(HERE, f"{name}.{EXT[name.split('_')[0]]}"), "wb") as f:
            f.write(data)
        a = np.ascontiguousarray(np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB")))
        meta[name] = {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
        if not name.startswith("pcd"):
            small[name] = a
    np.savez_compressed(os.path.join(HERE, "decodes.npz"), **small)
    with open(os.path.join(HERE, "decodes.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
