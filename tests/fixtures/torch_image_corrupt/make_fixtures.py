"""Writes the fuzzed TIFF and SGI files on which the port and Pillow 12.1
once disagreed (ROADMAP C.12: libtiff's directory reading and codec errors,
Pillow's SGI run-length rows; C.13: JPEG-in-TIFF tables and marker 0x8D)
and the JPEG 2000 codestream of C.13 (its third component's YRsiz 230),
and records Pillow's outcome on each, for
tests/test_torch_image_formats.py:

    PYTHONPATH=.:tests python tests/fixtures/torch_image_corrupt/make_fixtures.py

The probe: tests/test_torch_image_formats.py's TIFF families and SGI forms,
one picked by each seed of 0-9999 and fuzzed (bytes overwritten, inserted,
deleted or cut), each file held to ``Image.open(path).convert("RGB")``. Writes
``<seed>_<form>.<ext>`` for the seeds of ``FIXED`` (the probe's
disagreements on the way to the fix) and ``APART`` (those still apart:
none since C.13 closed), ``J2K`` (tests/test_torch_jpeg2000.py's
``pillow_rev`` with the third component's YRsiz overwritten to 230: Pillow
takes a 3-component image whose first subsampled component is the second
or the third for sYCC) and outcomes.json (the SHA-256 of Pillow's decode, or
"fails", for each; the codestream's under "jpeg2000").
"""

import hashlib
import json
import os
import tempfile
import warnings

import numpy as np
import PIL.Image

HERE = os.path.dirname(os.path.abspath(__file__))
FIXED = (27, 186, 443, 685, 686, 785, 891, 904, 925, 1095, 1281, 1504, 1616, 1876, 1933, 2013,
         2033, 2071, 2301, 2401, 2592, 2603, 2700, 2770, 3463, 3592, 3654, 3810, 3846, 3851,
         3873, 3995, 4060, 4248, 4333, 4342, 4390, 4631, 4731, 5161, 5317, 5445, 5603, 5870,
         5999, 6048, 6129, 6145, 6184, 6298, 6337, 6824, 6885, 7098, 7148, 7234, 7237, 7460,
         7509, 7658, 7709, 7781, 8128, 8198, 8334, 8482, 8493, 8515, 8985, 9286, 9412, 9564,
         9578, 9581, 9631, 9750, 9878, 9966, 4789, 7667, 8373)
APART = ()
J2K = "c13_third_yrsiz_230.j2k"


def corpus():
    """[(ext, form, bytes)]: the probe's TIFF and SGI forms, in its order."""
    import test_torch_image_formats as t

    out = [("tif", f"{fam}_{c}", d) for fam, cases in t.TIFF_FAMILIES.items()
           for c, d in cases.items()]
    return out + [("sgi", name, d) for ext, name, d in t.FORMAT_CASES if ext == "sgi"]


def fuzzed(seed: int, files):
    rng = np.random.RandomState(seed)
    ext, name, data = files[rng.randint(len(files))]
    d = bytearray(data)
    op, n = rng.randint(4), len(d)
    at = rng.randint(8, n) if n > 8 else 0
    if op == 0:
        for _ in range(rng.randint(1, 4)):
            d[rng.randint(8, n)] = rng.randint(256)
    elif op == 1:
        d[at:at] = bytes(rng.randint(0, 256, rng.randint(1, 8)).astype(np.uint8))
    elif op == 2:
        del d[at:at + rng.randint(1, 8)]
    else:
        d = d[:at]
    return f"{seed}_{name.replace(';', '')}.{ext}", bytes(d)


def _digest(data: bytes) -> str:
    """Pillow's decode of the file opened by its path, as the JAX package
    opens every image (ImageFile.load maps some raw images: ROADMAP C.17)."""
    with tempfile.TemporaryDirectory() as d, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        path = os.path.join(d, "image")
        with open(path, "wb") as f:
            f.write(data)
        try:
            with PIL.Image.open(path) as img:
                a = np.asarray(img.convert("RGB"))
        except Exception:
            return "fails"
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def j2k_yrsiz_230() -> bytes:
    """pillow_rev with its third component's YRsiz (SIZ byte 48) 230."""
    import test_torch_jpeg2000 as t

    d = bytearray(t.FORMS["pillow_rev"])
    d[d.find(b"\xff\x51") + 48] = 230
    return bytes(d)


def main():
    files = corpus()
    outcomes = {}
    for seed in FIXED + APART:
        name, data = fuzzed(seed, files)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        outcomes[name] = {"c13": seed in APART, "pillow": _digest(data)}
    data = j2k_yrsiz_230()
    with open(os.path.join(HERE, J2K), "wb") as f:
        f.write(data)
    outcomes["jpeg2000"] = {J2K: _digest(data)}
    outcomes["pillow_version"] = PIL.__version__
    with open(os.path.join(HERE, "outcomes.json"), "w") as f:
        json.dump(outcomes, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
