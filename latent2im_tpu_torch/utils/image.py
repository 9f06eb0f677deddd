"""Image grids, PNG files and uint8 conversion — own copy of
latent2im_tpu/utils/image.py (imgrid tiling with 1 px white seams, PNG save,
to_uint8), NHWC uint8. PNG is encoded with the standard library alone (zlib
+ struct): the GPU machine has no Pillow."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def imgrid(imarray: np.ndarray, cols: int = 5, pad: int = 1) -> np.ndarray:
    """Tile [N, H, W, C] uint8 images into a grid with `pad`px white seams."""
    if imarray.dtype != np.uint8:
        raise ValueError("imgrid input imarray must be uint8")
    pad = int(pad)
    cols = int(cols)
    if pad < 0 or cols < 1:
        raise ValueError(f"imgrid: pad >= 0 and cols >= 1, got {pad}, {cols}")
    n, h, w, c = imarray.shape
    rows = int(np.ceil(n / float(cols)))
    imarray = np.pad(
        imarray,
        [[0, rows * cols - n], [0, pad], [0, pad], [0, 0]],
        "constant",
        constant_values=255,
    )
    hp, wp = h + pad, w + pad
    grid = (
        imarray.reshape(rows, cols, hp, wp, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(rows * hp, cols * wp, c)
    )
    if pad:
        grid = grid[:-pad, :-pad]
    return np.squeeze(grid)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(img_u8: np.ndarray) -> bytes:
    """uint8 [H, W, 3] (RGB) or [H, W] (gray) -> PNG file bytes. zlib level
    1: a faster encode for slightly larger payloads, as in the JAX server."""
    img = np.ascontiguousarray(img_u8, np.uint8)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"png: [H, W, 3] or [H, W] uint8, got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _png_chunk(b"IEND", b""))


def save_im(a: np.ndarray, filename: str, format: str = "png") -> None:
    """Save a uint8 array as `{filename}.{format}` (PNG only)."""
    if format != "png":
        raise ValueError(f"save_im writes png only, not {format!r}")
    with open(f"{filename}.{format}", "wb") as f:
        f.write(png_bytes(np.squeeze(np.asarray(a, dtype=np.uint8))))


def to_uint8(ims) -> np.ndarray:
    """[-1, 1] float images -> uint8 (the reference's clip_ims): clip
    ((x + 1) / 2) * 255 to [0, 255] and truncate. Already-uint8 input passes
    through."""
    ims = np.asarray(ims)
    if ims.dtype == np.uint8:
        return ims
    return np.uint8(np.clip(((ims + 1) / 2.0) * 255, 0, 255))
