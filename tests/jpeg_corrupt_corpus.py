"""A seeded corpus of corrupt JPEGs, what libjpeg's recovery rules are
held to (tests/test_torch_jpeg_corrupt.py, tests/fixtures/torch_jpeg_corrupt/):
four small sources written by Pillow (baseline at quality 85, progressive,
restart markers every two MCUs, gray), larger ones past Pillow's 64 KiB
read, and lossless ones (tests/jpeg_lossless_encoder.py: gray, RGB and
4:2:0, with and without restarts, tables whose all-zero code is a category
other than 0, one file past 64 KiB), each corrupted in four ways:

- 1-3 bytes of the entropy-coded data overwritten;
- one marker inserted into the entropy-coded data (RST0, RST3, RST7, DHT,
  DRI, APP1, COM: the two marker bytes alone);
- 1-5 garbage bytes put before one of the file's markers;
- a truncation.
"""

import io

import numpy as np

INSERTED = (0xD0, 0xD3, 0xD7, 0xC4, 0xDD, 0xE1, 0xFE)


def photo(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth seeded image with some texture: what a photo's blocks hold."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 90 * np.sin(x / (7 + 3 * c) + y / (11 - 2 * c) + c) for c in range(3)], -1)
    img += rng.normal(0, 18, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def saved(img: np.ndarray, **opts) -> bytes:
    import PIL.Image  # here: the card's machine, which reads overwritten(), has no Pillow

    buf = io.BytesIO()
    PIL.Image.fromarray(img).save(buf, "JPEG", **opts)
    return buf.getvalue()


def _lossless_sources() -> dict:
    from jpeg_lossless_encoder import lossless_jpeg

    img, big = photo(48, 64, 1), photo(250, 340, 5)
    rgb = [img[..., c] for c in range(3)]

    def first(k):  # a table whose all-zero code is category k
        return bytes([k] + [i for i in range(17) if i != k])

    return {
        "lossless_gray": lossless_jpeg([img[..., 1]], [(1, 1)], 4),
        "lossless_gray_pt2": lossless_jpeg([img[..., 2]], [(1, 1)], 1, pt=2, symbols=first(16)),
        "lossless_rgb_restart": lossless_jpeg(rgb, [(1, 1)] * 3, 7, restart_rows=2,
                                              marker="adobe-rgb", symbols=first(7)),
        "lossless_420_restart": lossless_jpeg(
            [img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2]], [(2, 2), (1, 1), (1, 1)], 5,
            restart_rows=2, marker="adobe-rgb", symbols=first(2)),
        "lossless_large_rgb": lossless_jpeg([big[..., c] for c in range(3)], [(1, 1)] * 3, 4,
                                            marker="adobe-rgb", symbols=first(5)),
    }


def sources(large: bool = False, lossless: bool = False) -> dict:
    """name -> file bytes; large: files past 64 KiB (Pillow's read);
    lossless: the lossless ones (their large one named so)."""
    if lossless:
        return _lossless_sources()
    if large:  # each past one 64 KiB read
        img = photo(250, 340, 5)
        return {
            "large_baseline": saved(img, quality=97),
            "large_progressive": saved(img, quality=97, progressive=True),
            "large_restart": saved(img, quality=97, restart_marker_blocks=3),
        }
    img = photo(48, 64, 1)
    return {
        "baseline": saved(img, quality=85),
        "progressive": saved(img, quality=85, progressive=True),
        "restart": saved(img, quality=85, restart_marker_blocks=2),
        "gray": saved(img[..., 1], quality=85),
    }


def markers(data: bytes) -> list:
    """(position, code) of each marker, entropy-coded data skipped: its
    RSTn markers are listed, stuffed bytes are not."""
    out, i = [], 2
    out.append((0, 0xD8))
    while i + 1 < len(data):
        if data[i] != 0xFF or data[i + 1] in (0x00, 0xFF):
            i += 1
            continue
        code = data[i + 1]
        out.append((i, code))
        if code == 0xD9:
            break
        if 0xD0 <= code <= 0xD7 or code == 0x01:
            i += 2
            continue
        n = int.from_bytes(data[i + 2:i + 4], "big")
        i += 2 + n
    return out


def scan_ranges(data: bytes) -> list:
    """(start, end) of each scan's entropy-coded data."""
    ms = markers(data)
    out = []
    for k, (p, code) in enumerate(ms):
        if code == 0xDA:
            start = p + 2 + int.from_bytes(data[p + 2:p + 4], "big")
            nxt = next((q for q, c in ms[k + 1:] if not 0xD0 <= c <= 0xD7), len(data))
            out.append((start, nxt))
    return out


def corrupt(data: bytes, seed: int, n: int = 60) -> list:
    """n corruptions of one file -> [(label, bytes)], a quarter of each kind."""
    rng = np.random.RandomState(seed)
    scans = scan_ranges(data)
    ms = markers(data)
    out = []
    for i in range(n):
        kind = i % 4
        a, b = scans[rng.randint(len(scans))]
        if kind == 0:
            k = rng.randint(1, 4)
            buf = bytearray(data)
            for p in rng.randint(a, b, k):
                buf[p] = rng.randint(256)
            out.append((f"overwrite{k}_{i}", bytes(buf)))
        elif kind == 1:
            code = INSERTED[rng.randint(len(INSERTED))]
            p = rng.randint(a, b)
            if data[p - 1] == 0xFF:  # not inside a stuffed byte or a marker
                p += 1
            out.append((f"insert{code:02X}_{i}", data[:p] + bytes([0xFF, code]) + data[p:]))
        elif kind == 2:
            p, code = ms[1 + rng.randint(len(ms) - 1)]
            junk = bytes(rng.randint(0, 255, rng.randint(1, 6)).astype(np.uint8))
            out.append((f"garbage{len(junk)}_before{code:02X}_{i}", data[:p] + junk + data[p:]))
        else:
            p = rng.randint(a, len(data))
            out.append((f"cut{p}_{i}", data[:p]))
    return out


def overwritten(data: bytes, seed: int, k: int = 3) -> bytes:
    """k bytes of the first scan's entropy-coded data overwritten at seeded
    places past its first quarter: the photo-sized corrupt files whose
    decodes are timed."""
    rng = np.random.RandomState(seed)
    a, b = scan_ranges(data)[0]
    buf = bytearray(data)
    for p in rng.randint(a + (b - a) // 4, b, k):
        buf[p] = rng.randint(256)
    return bytes(buf)


def corpus(large: bool = False, n: int = 60) -> list:
    """[(name, bytes)] over every source."""
    out = []
    for k, (name, data) in enumerate(sorted(sources(large).items())):
        out += [(f"{name}_{label}", d) for label, d in corrupt(data, 100 + k, n)]
    return out
