"""A msgpack encoder and decoder in pure Python (``struct`` only), for the
checkpoints the JAX package writes with ``flax.serialization.to_bytes`` and
reads with ``msgpack_restore``: the port's own copy of that format, since the
GPU machine has neither flax nor msgpack.

Types: nil, bool, int, float32/64, str, bin, array, map, and flax's two
extensions:

  ext 1 (ndarray)   payload = msgpack array [shape, dtype name, C-order bytes]
  ext 3 (npscalar)  the same payload, restored as a numpy scalar

Arrays larger than flax's chunk size (2**30 bytes) are written by flax as
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}`` and
are joined back on decode, as ``msgpack_restore`` does. Anything else raises,
naming the offset of the byte. ``packb`` makes the same choices as
msgpack-python under flax (the smallest int and length forms, floats as
float64, tuples as arrays), so the same tree gives the same bytes.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Bytes that are not msgpack of the supported types."""


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0 <= n <= 0xFF:
        out.append(b"\xcc" + struct.pack("B", n))
    elif 0 <= n <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", n))
    elif 0 <= n <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", n))
    elif 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", n))
    elif -0x80 <= n < 0:
        out.append(b"\xd0" + struct.pack("b", n))
    elif -0x8000 <= n < 0:
        out.append(b"\xd1" + struct.pack(">h", n))
    elif -0x80000000 <= n < 0:
        out.append(b"\xd2" + struct.pack(">i", n))
    elif -0x8000000000000000 <= n < 0:
        out.append(b"\xd3" + struct.pack(">q", n))
    else:
        raise MsgpackError(f"integer {n} does not fit in 64 bits")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple, out: list) -> None:
    """Header of a str/bin/array/map of length n: the fix form where there is
    one, then 8-, 16- and 32-bit lengths (codes for those, None to skip)."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, lim in zip(codes, ("B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= lim:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise MsgpackError(f"length {n} exceeds msgpack's 32-bit limit")


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise MsgpackError(f"cannot encode an array of dtype {arr.dtype}")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack_ext(code: int, data: bytes, out: list) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    elif n <= 0xFF:
        out.append(b"\xc7" + struct.pack("Bb", n, code))
    elif n <= 0xFFFF:
        out.append(b"\xc8" + struct.pack(">Hb", n, code))
    elif n <= 0xFFFFFFFF:
        out.append(b"\xc9" + struct.pack(">Ib", n, code))
    else:
        raise MsgpackError(f"extension payload of {n} bytes is too long")
    out.append(data)


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif type(obj) in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif type(obj) in (list, tuple):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    else:
        raise MsgpackError(f"cannot encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """A tree of dict / list / tuple / None / bool / int / float / str / bytes
    with numpy array and numpy scalar leaves -> msgpack bytes."""
    out: list[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError(
                f"truncated input: {n} bytes wanted at offset {self.pos}, "
                f"{len(self.data) - self.pos} left")
        out = self.data[self.pos:end].tobytes()
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _unpack(r: _Reader, depth: int = 0):
    if depth > 512:
        raise MsgpackError(f"nesting deeper than 512 at offset {r.pos}")
    at = r.pos
    b = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, depth)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r, depth + 1) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r, b & 0x1F, at)
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    if b in (0xC4, 0xC5, 0xC6):
        return r.take(r.unpack({0xC4: "B", 0xC5: ">H", 0xC6: ">I"}[b]))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: "B", 0xC8: ">H", 0xC9: ">I"}[b])
        return _ext(r, r.unpack("b"), n, at)
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    ints = {0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if 0xD4 <= b <= 0xD8:
        return _ext(r, r.unpack("b"), 1 << (b - 0xD4), at)
    if b in (0xD9, 0xDA, 0xDB):
        return _str(r, r.unpack({0xD9: "B", 0xDA: ">H", 0xDB: ">I"}[b]), at)
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_unpack(r, depth + 1) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"), depth)
    raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x} at offset {at}")


def _str(r: _Reader, n: int, at: int) -> str:
    try:
        return r.take(n).decode("utf-8")
    except UnicodeDecodeError as e:
        raise MsgpackError(f"invalid utf-8 in the str at offset {at}") from e


def _map(r: _Reader, n: int, depth: int) -> dict:
    out = {}
    for _ in range(n):
        at = r.pos
        k = _unpack(r, depth + 1)
        if isinstance(k, (dict, list)):
            raise MsgpackError(f"unhashable map key at offset {at}")
        out[k] = _unpack(r, depth + 1)
    return out


def _ext(r: _Reader, code: int, n: int, at: int):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise MsgpackError(f"unsupported msgpack extension type {code} at offset {at}")
    try:  # [shape, dtype name, C-order bytes]
        shape, dtype_name, buf = _unpack(_Reader(r.take(n)))
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode("ascii")
        if not isinstance(buf, bytes) or not isinstance(dtype_name, str):
            raise TypeError("not [shape, dtype name, bytes]")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()
    except (TypeError, ValueError) as e:
        raise MsgpackError(f"malformed array payload at offset {at}: {e}") from e
    return arr[()] if code == EXT_NPSCALAR else arr


def _dict_to_list(d: dict) -> list:
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(_dict_to_list(tree["shape"]))
            return np.concatenate(_dict_to_list(tree["chunks"])).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """msgpack bytes -> the tree; arrays come back as numpy arrays (the
    caller moves them to a device). Lists flax wrote as {'0': .., '1': ..}
    maps stay maps, as under ``msgpack_restore``."""
    r = _Reader(data)
    out = _unpack(r)
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} trailing bytes at offset {r.pos}")
    return _unchunk(out)
