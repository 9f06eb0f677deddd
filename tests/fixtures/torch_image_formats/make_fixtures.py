"""Writes the fixtures of the image formats read since the JPEG recovery
slice (utils/netpbm.py, qoi.py, tga.py, pcx.py, sgi.py, ico.py, bmp.py's DIB
and the rest of tiff.py with ccitt.py) and records Pillow 12.1's decode of
each, for the card's machine, which has no Pillow (chip_smoke.py phase 55),
and for tests/test_torch_image_formats.py:

    PYTHONPATH=.:tests python tests/fixtures/torch_image_formats/make_fixtures.py

Writes beside this file the files of ``files()``, decodes.npz (each file's
``Image.open(f).convert("RGB")`` under its name less the extension) and
decodes.json (each decode's shape and SHA-256, and Pillow's version).
"""

import hashlib
import io
import json
import os
import zlib

import numpy as np
import PIL.Image

from image_format_encoders import (dib_frame, icon_file, sgi_file, tga_file, tga_rle, tiff,
                                   tiff_lzw_old)

HERE = os.path.dirname(os.path.abspath(__file__))


def photo(h, w, seed):
    y, x = np.mgrid[0:h, 0:w]
    rng = np.random.RandomState(seed)
    base = np.stack([(x * 255) // max(w - 1, 1), (y * 255) // max(h - 1, 1),
                     ((x + y) * 127) // max(w + h - 2, 1)], -1)
    return np.clip(base + rng.randint(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


def saved(img, fmt, **opts):
    buf = io.BytesIO()
    img.save(buf, fmt, **opts)
    return buf.getvalue()


def files() -> dict:
    rng = np.random.RandomState(55)
    p = photo(29, 37, 1)
    img = PIL.Image.fromarray(p)
    g16 = (p[..., :1].astype(np.int64) * 257) ^ rng.randint(0, 256, (29, 37, 1))
    rgb16 = np.concatenate([p.astype(np.int64) * 257, rng.randint(0, 65536, (29, 37, 1))], -1)
    fl = (p[..., 1:2].astype(np.float32) * 1.3 - 20)
    bits = (photo(40, 61, 2)[..., 0] > 128).astype(np.uint8) * 255
    pal = [tuple(rng.randint(0, 256, 3)) for _ in range(16)]
    sub = {}
    for (sh, sv), (h, w, tile) in (((2, 2), (29, 37, None)), ((4, 4), (21, 19, (16, 16)))):
        bx = (tile[0] if tile else w + sh - 1) // sh
        by = (tile[1] if tile else h + sv - 1) // sv
        n = (-(-w // tile[0]) * -(-h // tile[1])) if tile else 1
        raws = iter([rng.randint(0, 256, by * bx * (sh * sv + 2)).astype(np.uint8).tobytes()
                     for _ in range(n)])
        sub[(sh, sv)] = tiff(np.zeros((h, w, 3), np.uint8), 8, 6, "<", 8, tile=tile,
                             tags={530: (3, [sh, sv])},
                             encode_chunk=lambda b, r=raws: zlib.compress(next(r)))
    sgi_planes = np.concatenate([p.transpose(2, 0, 1), rng.randint(0, 256, (1, 29, 37))]) * 257
    return {
        "ppm_p6_max1000_37x29.ppm": b"P6\n37 29\n1000\n" + (p.astype(np.int64) * 1000 // 255)
        .astype(">u2").tobytes(),
        "ppm_p2_plain_max15_37x29.pgm": b"P2\n# plain\n37 29\n15\n" + b"\n".join(
            b" ".join(b"%d" % v for v in row) for row in p[..., 0] // 17) + b"\n",
        "ppm_p4_61x40.pbm": saved(PIL.Image.fromarray(bits).convert("1"), "PPM"),
        "ppm_pf_le_37x29.pfm": b"Pf\n37 29\n-1.0\n" + fl[::-1].astype("<f4").tobytes(),
        "qoi_rgba_37x29.qoi": saved(img.convert("RGBA"), "QOI"),
        "tga_rle_bottom_up_37x29.tga": tga_file(37, 29, 10, 24, tga_rle(
            [row[:, ::-1].tobytes() for row in p[::-1]], 3, 1), flags=0x00),
        "tga_cmap16_37x29.tga": tga_file(37, 29, 1, 8, (p[..., 0] // 8).tobytes(),
                                         cmap=rng.randint(0, 65536, 32).astype("<u2").tobytes(),
                                         cdepth=16),
        "ico_bmp_frames_32x32.ico": icon_file([
            (16, 16, 4, 16, dib_frame(rng.randint(0, 16, (16, 16)), 4, pal)),
            (32, 32, 24, 0, dib_frame(photo(32, 32, 3), 24))]),
        "ico_png_48x48.ico": saved(PIL.Image.fromarray(photo(48, 48, 4)), "ICO",
                                   sizes=[(16, 16), (48, 48)]),
        "cur_24_16x16.cur": icon_file([(16, 16, 24, 0, dib_frame(photo(16, 16, 5), 24))], kind=2),
        "pcx_rgb_37x29.pcx": saved(img, "PCX"),
        "pcx_p_37x29.pcx": saved(img.quantize(30), "PCX"),
        "sgi_rle_rgba16_37x29.sgi": sgi_file(sgi_planes, 2, rle=True),
        "sgi_verbatim_37x29.rgb": saved(img, "SGI"),
        "dib_p_37x29.dib": saved(img.quantize(20), "BMP")[14:],
        "tiff_jpeg_ycbcr_420_37x29.tif": saved(img, "TIFF", compression="jpeg", quality=85),
        "tiff_jpeg_cmyk_37x29.tif": saved(img.convert("CMYK"), "TIFF", compression="jpeg"),
        "tiff_g4_61x40.tif": saved(PIL.Image.fromarray(bits).convert("1"), "TIFF",
                                   compression="group4"),
        "tiff_g3_2d_61x40.tif": saved(PIL.Image.fromarray(bits).convert("1"), "TIFF",
                                      compression="group3", tiffinfo={292: 1}),
        "tiff_gray16_be_deflate_pred_37x29.tif": tiff(g16, 16, 1, ">", 8, predictor=2),
        "tiff_cmyk16_lzw_37x29.tif": tiff(rgb16, 16, 5, "<", 5),
        "tiff_planar_rgba_deflate_37x29.tif": tiff(np.concatenate([p, p[..., :1]], -1), 8, 2,
                                                   "<", 8, planar=2, extra=(2,)),
        "tiff_bigtiff_tiles_37x29.tif": tiff(p, 8, 2, "<", 32773, big=True, tile=(16, 16)),
        "tiff_float_fp_pred_37x29.tif": tiff(fl, 32, 1, "<", 8, sample_format=3, predictor=3),
        "tiff_rgba16_associated_37x29.tif": tiff(rgb16, 16, 2, ">", 1, extra=(1,)),
        "tiff_ycbcr_22_37x29.tif": sub[(2, 2)],
        "tiff_ycbcr_44_tiles_19x21.tif": sub[(4, 4)],
        "tiff_orientation_6_37x29.tif": tiff(p, 8, 2, "<", 1, tags={274: (3, [6])}),
        "tiff_old_lzw_37x29.tif": tiff(p, 8, 2, "<", 5, encode_chunk=tiff_lzw_old),
    }


def main():
    decodes, meta = {}, {}
    for name, data in files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        a = np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))
        key = os.path.splitext(name)[0]
        decodes[key] = a
        meta[key] = {"shape": list(a.shape),
                     "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}
    np.savez_compressed(os.path.join(HERE, "decodes.npz"), **decodes)
    meta["pillow"] = PIL.__version__
    with open(os.path.join(HERE, "decodes.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
