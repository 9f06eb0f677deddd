"""Writes the fixtures of the formats read since the textures and JPEG 2000
slice (utils/bcn.py with dds.py, blp.py, psd.py, jpeg2000.py and icns.py)
and records Pillow 12.1's decode of each, for the card's machine, which has
no Pillow (chip_smoke.py phase 56), and for tests/test_torch_image_textures.py
and tests/test_torch_jpeg2000.py:

    PYTHONPATH=.:tests python tests/fixtures/torch_image_textures/make_fixtures.py

Writes beside this file the files of ``files()``, decodes.npz (each small
file's ``Image.open(f).convert("RGB")`` under its name less the extension)
and decodes.json (each decode's shape and SHA-256, and Pillow's and
OpenJPEG's versions); the photos (``photo_*``) are held by their digest
alone.
"""

import hashlib
import io
import json
import os
import struct

import numpy as np
import PIL.features
import PIL.Image

from image_format_encoders import (blp_file, dds_file, ftex_file, icns_file, icns_rle, j2k_merge,
                                   j2k_repack, j2k_with, jp2_file, psd_file)

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
    rng = np.random.RandomState(56)
    p = photo(48, 64, 1)
    img = PIL.Image.fromarray(p)
    blocks = lambda n, size: rng.randint(0, 256, (n, size)).astype(np.uint8).tobytes()  # noqa: E731
    bc7 = rng.randint(0, 256, (192, 16)).astype(np.uint8)
    bc7[::9, 0] = 0
    pal = rng.randint(0, 256, 1024).astype(np.uint8).tobytes()
    idx = rng.randint(0, 256, 64 * 48).astype(np.uint8).tobytes()
    jpg = saved(img, "JPEG", quality=85)
    planes = np.concatenate([p.transpose(2, 0, 1), rng.randint(0, 256, (1, 48, 64))]).astype(
        np.uint8)
    planes[:, 10:30, 5:50] = planes[:, 10:11, 5:6]
    lum = img.convert("L")
    j2k = saved(img, "JPEG2000", no_jp2=True, quality_mode="rates", quality_layers=[20, 5],
                tile_size=(32, 32))
    small = lum.resize((32, 24))
    s0 = saved(lum, "JPEG2000", no_jp2=True, num_resolutions=3)
    s1 = saved(small, "JPEG2000", no_jp2=True, num_resolutions=3)
    segs = {m: b for m, b in __import__("image_format_encoders").j2k_main_header(j2k)[0]}
    siz12 = bytearray(__import__("image_format_encoders").j2k_main_header(j2k)[1])
    for c in range(3):
        siz12[36 + 3 * c] = 11
    one = saved(img, "JPEG2000", no_jp2=True)  # one layer: every style's segments decode
    cod_all = bytearray(dict(__import__("image_format_encoders").j2k_main_header(one)[0])[0xFF52])
    cod_all[8] = 63  # bypass, reset, termall, causal, predictable, segmentation symbols
    big = photo(256, 256, 2)
    return {
        "dds_dxt1_64x48.dds": saved(img.convert("RGBA"), "DDS", pixel_format="DXT1"),
        "dds_dxt5_64x48.dds": saved(img.convert("RGBA"), "DDS", pixel_format="DXT5"),
        "dds_ati1_64x48.dds": dds_file(64, 48, blocks(192, 8), b"ATI1"),
        "dds_bc5s_64x48.dds": dds_file(64, 48, blocks(192, 16), b"BC5S"),
        "dds_bc6h_uf16_64x48.dds": dds_file(64, 48, blocks(192, 16), b"DX10", 95),
        "dds_bc6h_sf16_64x48.dds": dds_file(64, 48, blocks(192, 16), b"DX10", 96),
        "dds_bc7_64x48.dds": dds_file(64, 48, bc7.tobytes(), b"DX10", 98),
        "dds_rgb565_37x29.dds": dds_file(37, 29, blocks(37 * 29, 2), pfflags=0x40,
                                         bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0)),
        "dds_palette_64x48.dds": dds_file(64, 48, pal + idx, pfflags=0x20, bitcount=8),
        "blp1_jpeg_64x48.blp": blp_file(1, 64, 48, jpg[200:], comp=0, jpeg_header=jpg[:200]),
        "blp1_palette_64x48.blp": blp_file(1, 64, 48, idx, enc=4, alpha=8, palette=pal),
        "blp2_dxt3_37x29.blp": blp_file(2, 37, 29, blocks(80, 16), enc=2, alpha=8, aenc=1,
                                        palette=pal),
        "blp2_dxt1_37x29.blp": blp_file(2, 37, 29, blocks(80, 8), enc=2, aenc=0, palette=pal),
        "ftex_dxt1_64x48.ftc": ftex_file(64, 48, 0, blocks(192, 8)),
        "ftex_rgb_64x48.ftu": ftex_file(64, 48, 1, p.tobytes()),
        "psd_rgba_packbits_64x48.psd": psd_file(planes, 3, 8, 1),
        "psd_cmyk_raw_64x48.psd": psd_file(planes, 4, 8, 0),
        "psd_bitmap_64x48.psd": psd_file(planes[:1] > 128, 0, 1, 1),
        "psd_indexed_64x48.psd": psd_file(planes[:1], 2, 8, 0, palette=pal[:768]),
        "j2k_rev_layers_tiles_64x48.j2k": j2k,
        "j2k_irr_rpcl_64x48.j2k": saved(img, "JPEG2000", no_jp2=True, irreversible=True,
                                        progression="RPCL", precinct_size=(64, 64),
                                        num_resolutions=3),
        "j2k_styles_64x48.j2k": j2k_with(one, cod=bytes(cod_all)),
        "j2k_sop_eph_ppt_64x48.j2k": j2k_repack(j2k, True, True, "ppt"),
        "j2k_ppm_64x48.j2k": j2k_repack(j2k, False, False, "ppm"),
        "j2k_rgn_12bit_64x48.j2k": j2k_with(j2k, [(0xFF5E, bytes([0, 0, 3]))], siz=bytes(siz12)),
        "jp2_420_sycc_64x48.jp2": jp2_file(j2k_merge([s0, s1, s1], [1, 2, 2], [1, 2, 2]), 64,
                                           48, 3, colr=b"\x01\0\0" + struct.pack(">I", 18)),
        "jp2_irr_gray_64x48.jp2": saved(lum, "JPEG2000", irreversible=True),
        "icns_it32_128x128.icns": icns_file([(b"it32", b"\0\0\0\0" + icns_rle(
            photo(128, 128, 3).transpose(2, 0, 1))), (b"t8mk", bytes(128 * 128))]),
        "icns_jp2_256x256.icns": icns_file([(b"ic08", saved(PIL.Image.fromarray(big), "JPEG2000",
                                                            quality_mode="rates",
                                                            quality_layers=[10]))]),
        "photo_256_rev.jp2": saved(PIL.Image.fromarray(big), "JPEG2000"),
        "photo_256_irr.j2k": saved(PIL.Image.fromarray(big), "JPEG2000", no_jp2=True,
                                   irreversible=True),
        "photo_1024_irr.jp2": saved(PIL.Image.fromarray(photo(1024, 1024, 4)), "JPEG2000",
                                    irreversible=True, quality_mode="rates",
                                    quality_layers=[12]),
    }


def main():
    decodes, meta = {}, {}
    for name, data in files().items():
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        a = np.asarray(PIL.Image.open(io.BytesIO(data)).convert("RGB"))
        key = os.path.splitext(name)[0]
        if not key.startswith("photo_"):
            decodes[key] = a
        meta[key] = {"shape": list(a.shape),
                     "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}
    np.savez_compressed(os.path.join(HERE, "decodes.npz"), **decodes)
    meta["pillow"] = PIL.__version__
    meta["openjpeg"] = PIL.features.version("jpg_2000")
    with open(os.path.join(HERE, "decodes.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    main()
