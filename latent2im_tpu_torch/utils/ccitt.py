"""CCITT bilevel decoding in Python and numpy for TIFF (compressions 2, 3
and 4), as libtiff's tif_fax3.c decodes it for Pillow 12.1: the GPU machine
has no Pillow.

    ccitt_decode(data, compression, width, rows, t4_options, t6_options)
        -> uint8 [rows, (width + 7) // 8], packed, black 1

The codes are T.4's (ITU-T T.4 tables 2 and 3: white and black terminating
codes for runs 0-63, make-up codes for multiples of 64 to 1728, the
extended make-up codes 1792-2560 shared by both colours) and its 2D modes
(pass, horizontal, vertical 0 and +-1 to +-3, the reference line's changing
elements b1, b2 after a0 as T.4 4.2.1.3 defines them). Compression 2
(modified Huffman) codes each row in one dimension from a byte boundary,
with no EOL; compression 3 (T.4) starts each row at an EOL (any zero bits
before it skipped, as libtiff's SYNC_EOL skips fill bits), followed, where
T4Options sets 2D coding (bit 0), by a bit saying whether the row is 1D
(1) or 2D (0); compression 4 (T.6) codes every row in two dimensions, the
first against an imaginary white row, with no EOLs. A run is white first;
fill order 2 is undone by the caller. Uncompressed mode (T4Options bit 1,
T6Options bit 1, or an extension code) is not read: it raises naming
ROADMAP item 28. Data that ends early or a code that is no code raises.
"""

from __future__ import annotations

import numpy as np

ITEM = "ROADMAP item 28"

_WHITE_TERM = (
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100")
_WHITE_MAKEUP = (
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000", "010011011")
_BLACK_TERM = (
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111")
_BLACK_MAKEUP = (
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101")
_EXT_MAKEUP = (
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111")
_MODES = {"0001": "P", "001": "H", "1": 0, "011": 1, "000011": 2, "0000011": 3, "010": -1,
          "000010": -2, "0000010": -3, "0000001": "X"}


def _table(term, makeup) -> dict:
    """(code length, code value) -> run length."""
    out = {}
    for run, code in enumerate(term):
        out[(len(code), int(code, 2))] = run
    for i, code in enumerate(makeup):
        out[(len(code), int(code, 2))] = 64 * (i + 1)
    for i, code in enumerate(_EXT_MAKEUP):
        out[(len(code), int(code, 2))] = 1792 + 64 * i
    return out


_RUNS = (_table(_WHITE_TERM, _WHITE_MAKEUP), _table(_BLACK_TERM, _BLACK_MAKEUP))
_MODE_CODES = {(len(k), int(k, 2)): v for k, v in _MODES.items()}


class _Bits:
    __slots__ = ("bits", "pos")

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist()
        self.pos = 0

    def bit(self) -> int:
        if self.pos >= len(self.bits):
            raise ValueError("ccitt: the data ends before the image does")
        b = self.bits[self.pos]
        self.pos += 1
        return b

    def code(self, table: dict, most: int):
        """The next code of ``table`` (codes of at most ``most`` bits)."""
        v = 0
        for n in range(1, most + 1):
            v = (v << 1) | self.bit()
            got = table.get((n, v))
            if got is not None:
                return got
        raise ValueError("ccitt: a bad code word (corrupt data)")

    def run(self, color: int) -> int:
        """A run of ``color`` (0 white): make-up codes, then a terminating one."""
        total = 0
        while True:
            r = self.code(_RUNS[color], 13)
            total += r
            if r < 64:
                return total

    def eol(self):
        """SYNC_EOL: zero bits up to an EOL's 1 (at least 11 of them)."""
        zeros = 0
        while self.bit() == 0:
            zeros += 1
        if zeros < 11:
            raise ValueError("ccitt: a row does not start with an EOL")

    def align(self):
        self.pos = -(-self.pos // 8) * 8


def _row_1d(rd: _Bits, width: int) -> list:
    """A 1D row -> its changing elements (positions where the colour
    changes, white first)."""
    changes, a0, color = [], 0, 0
    while a0 < width:
        a0 += rd.run(color)
        changes.append(min(a0, width))
        color ^= 1
    return changes


def _row_2d(rd: _Bits, width: int, ref: list) -> list:
    """A 2D row against the reference row's changing elements."""
    changes, a0, color, i = [], -1, 0, 0
    refs = ref + [width, width]
    rising = all(a < b for a, b in zip(ref, ref[1:]))
    while a0 < width:
        # b1: the first changing element of the reference row right of a0
        # that changes to the colour opposite a0's; b2 the next one (the
        # search starts from the last one where the row's changes rise)
        start = 0 if a0 < 0 else a0 + 1
        if not rising:
            i = 0
        while i > 0 and ref[i - 1] >= start:
            i -= 1
        while i < len(ref) and (ref[i] < start or i % 2 != color):
            i += 1
        b1, b2 = refs[i], refs[i + 1]
        mode = rd.code(_MODE_CODES, 7)
        if mode == "P":
            a0 = b2
        elif mode == "H":
            a1 = max(a0, 0) + rd.run(color)
            a2 = a1 + rd.run(color ^ 1)
            changes += [min(a1, width), min(a2, width)]
            a0 = a2
        elif mode == "X":
            raise ValueError(f"ccitt: uncompressed mode is not supported ({ITEM})")
        else:
            a1 = b1 + mode
            changes.append(min(max(a1, 0), width))
            a0 = a1
            color ^= 1
    return changes


def _pack(changes: list, width: int) -> np.ndarray:
    """Black from each white run's end to the next change, or to the row's
    end where the row ends inside a black run."""
    row = np.zeros(width, np.uint8)
    for i in range(0, len(changes), 2):
        row[changes[i]:changes[i + 1] if i + 1 < len(changes) else width] = 1
    return np.packbits(row)


def ccitt_decode(data: bytes, compression: int, width: int, rows: int, t4_options: int = 0,
                 t6_options: int = 0) -> np.ndarray:
    """One strip's or tile's CCITT data -> packed rows (see the module)."""
    if (compression == 3 and t4_options & 2) or (compression == 4 and t6_options & 2):
        raise ValueError(f"ccitt: uncompressed mode is not supported ({ITEM})")
    rd = _Bits(data)
    ref, out = [], []
    for _ in range(rows):
        if compression == 2:
            changes = _row_1d(rd, width)
            rd.align()
        elif compression == 3:
            rd.eol()
            if t4_options & 1 and not rd.bit():
                changes = _row_2d(rd, width, ref)
            else:
                changes = _row_1d(rd, width)
        else:
            changes = _row_2d(rd, width, ref)
        out.append(_pack(changes, width))
        ref = _dedupe(changes, width)
    return np.stack(out) if out else np.zeros((0, -(-width // 8)), np.uint8)


def _dedupe(changes: list, width: int) -> list:
    """A row's changing elements as the next row's reference: the positions
    where the colour changes (runs of zero length fold away), white first,
    up to the width."""
    out = []
    for c in changes:
        if c >= width:
            break
        if out and out[-1] == c:
            out.pop()
        else:
            out.append(c)
    return out
