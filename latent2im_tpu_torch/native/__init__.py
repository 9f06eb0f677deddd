"""The port's counterpart of the JAX package's native extension
(latent2im_tpu/native over native/l2i_native.cpp): the same surface and the
same results, bit for bit, without importing it.

    from latent2im_tpu_torch.native import _l2i_native as nat
    nat.Loader(paths, size, batch, threads=2)  # .start_epoch(seed=0, shuffle=True),
                                               # .next_batch(), .num_batches()
    nat.load_resize(path, size)                # -> uint8 [size, size, 3]
    nat.imgrid(images, cols, pad)

As there, a photo is decoded by its first bytes (``\\x89P`` PNG, ``\\xff\\xd8``
JPEG, else JPEG then PNG): JPEG as libjpeg-turbo 2.1 decodes a whole
buffer into RGB (``utils/jpeg.py`` with ``libjpeg=True``: a truncated file
decodes, CMYK and YCCK fail), PNG as libpng 1.6's simplified API reads it
(``native/png.py``: gamma and alpha composited onto black); then the centre
square is resized bilinearly without antialias (``native/resize.py``).
WEBP, GIF, BMP, TIFF and the rest fail on this path. The Loader gives a
black image for a file it cannot read or decode, ``load_resize`` raises
``IOError("failed to load/decode <path>")``. Each epoch's order is
libstdc++'s ``std::shuffle`` by ``std::mt19937_64(seed)`` of the order the
previous epoch left (``native/order.py``); batches come in that order, the
last one ragged.

This module always imports, so the callers that try it first (as the JAX
package's do: ``cli/train.py:_make_real_batcher``, ``cli/train_regressor.py``,
``utils/image.py:load_and_resize_image``) take this path everywhere; a test
reaches their fallback by setting ``sys.modules["latent2im_tpu_torch.native"]``
to None. Where a card is present (``torch.cuda.is_available()``) the decode
and resize run in the host C++ of ops/csrc/ (``host_cpp``; a failed build
raises, never ImportError), elsewhere in Python; the two are the same bit
for bit. The Loader decodes on the threads of ``utils/loader.py``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..utils import image as _image
from ..utils.jpeg import jpeg_decode_rgb
from . import order as _order
from .png import decode_png
from .resize import crop_resize


# what a file the extension cannot read or decode raises here (a failed build
# of the host C++ raises RuntimeError, which passes)
DECODE_ERRORS = (OSError, ValueError, IndexError, KeyError, OverflowError, MemoryError,
                 struct.error, zlib.error)


def _host_cpp_default() -> bool:
    import torch

    return torch.cuda.is_available()


def decode_image(data: bytes, host_cpp: bool = False) -> np.ndarray:
    """l2i_native.cpp ``decode_image``: file bytes -> uint8 [H, W, 3];
    ValueError where the extension fails."""
    if len(data) >= 8 and data[0] == 0x89 and data[1] == ord("P"):
        return decode_png(data, host_cpp)
    if len(data) >= 2 and data[0] == 0xFF and data[1] == 0xD8:
        return jpeg_decode_rgb(data, host_cpp, libjpeg=True)
    try:  # neither signature: JPEG, then PNG
        return jpeg_decode_rgb(data, host_cpp, libjpeg=True)
    except ValueError:
        return decode_png(data, host_cpp)


def load_one(path: str, size: int, host_cpp: bool = False) -> np.ndarray:
    """Read, decode, centre crop and resize one file -> uint8 [size, size, 3];
    one of ``DECODE_ERRORS`` where the extension's ``load_one`` fails."""
    with open(path, "rb") as f:
        data = f.read()
    img = decode_image(data, host_cpp)
    if host_cpp:
        return _crop_resize_c(img, size)
    return crop_resize(img, size)


def _crop_resize_c(img: np.ndarray, size: int) -> np.ndarray:
    """``crop_resize`` in the host C++ ``l2i_crop_resize``
    (ops/csrc/png_native.cpp, no fused multiply-adds)."""
    from ..ops import _build

    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((size, size, 3), np.uint8)
    _build.library().l2i_crop_resize(img.ctypes.data, img.shape[0], img.shape[1], size,
                                     out.ctypes.data)
    return out


class Loader:
    """The native extension's threaded ``Loader``: ``paths`` decoded and
    resized to ``size`` in batches of ``batch``, ahead of the caller on the
    pool of ``utils/loader.py`` (``threads``: its size; the extension's
    default of 2). ``start_epoch`` shuffles the current order in place
    (``shuffle``) and starts the epoch; ``next_batch`` -> (uint8 [n, size,
    size, 3], the n indices of ``paths``), StopIteration after the last.
    The decode ahead starts at an epoch's first ``next_batch``; before it,
    ``skip_batch`` -> the next batch's indices, decoding nothing (a resume
    replaying the stream)."""

    def __init__(self, paths, size: int, batch: int, threads: int = 2, host_cpp=None):
        from ..utils.loader import Loader as Pool

        self.paths = [str(p) for p in paths]
        self.size, self.batch = int(size), int(batch)
        self.host_cpp = _host_cpp_default() if host_cpp is None else bool(host_cpp)
        self.order = list(range(len(self.paths)))
        self._pool = Pool(self.load, threads=max(1, int(threads)))
        self._batches, self._cursor, self._stream = None, 0, None

    def load(self, i: int) -> np.ndarray:
        """Path i as the loader gives it: black where it cannot be read or
        decoded."""
        try:
            return load_one(self.paths[i], self.size, self.host_cpp)
        except DECODE_ERRORS:  # unreadable or undecodable: black
            return np.zeros((self.size, self.size, 3), np.uint8)

    def start_epoch(self, seed: int = 0, shuffle: bool = True) -> None:
        self._end_stream()
        if shuffle:
            _order.std_shuffle(self.order, int(seed) & (2 ** 64 - 1))
        self._batches = [self.order[s:s + self.batch]
                         for s in range(0, len(self.order), self.batch)]
        self._cursor = 0

    def next_batch(self):
        if self._batches is None:
            raise RuntimeError("call start_epoch() first")
        if self._cursor >= len(self._batches):
            raise StopIteration
        if self._stream is None:
            self._stream = self._pool.batches(self._batches[self._cursor:])
        self._cursor += 1
        return next(self._stream)

    def skip_batch(self) -> list:
        if self._batches is None:
            raise RuntimeError("call start_epoch() first")
        if self._stream is not None:
            raise RuntimeError("skip_batch only before an epoch's first next_batch")
        if self._cursor >= len(self._batches):
            raise StopIteration
        self._cursor += 1
        return list(self._batches[self._cursor - 1])

    def num_batches(self) -> int:
        return -(-len(self.paths) // self.batch)

    def _end_stream(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None

    def close(self) -> None:
        self._end_stream()
        self._pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Wrapper:
    """The JAX package's ``_l2i_native`` wrapper, with the port's forms."""

    Loader = Loader

    @staticmethod
    def load_resize(path: str, size: int, host_cpp=None) -> np.ndarray:
        host_cpp = _host_cpp_default() if host_cpp is None else host_cpp
        try:
            return load_one(path, size, host_cpp)
        except DECODE_ERRORS as e:
            raise OSError(f"failed to load/decode {path}") from e

    @staticmethod
    def imgrid(imarray, cols: int, pad: int) -> np.ndarray:
        n, h, w, c = imarray.shape
        return _image.imgrid(np.asarray(imarray, np.uint8), cols, pad).reshape(
            -(-n // cols) * (h + pad) - pad, cols * (w + pad) - pad, c)


_l2i_native = _Wrapper()
