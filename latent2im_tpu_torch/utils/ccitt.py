"""CCITT bilevel decoding in Python and numpy for TIFF (compressions 2, 3, 4
and 32771), as libtiff 4.7's tif_fax3.c decodes it for Pillow 12.1: the GPU
machine has no Pillow.

    CcittDecoder(compression, width, t4_options, t6_options).decode(
        data, rows, at=0) -> (bits uint8 [rows, width], black 1; rows the
        strip or tile wrote)

The codes are T.4's (ITU-T T.4 tables 2 and 3: white and black terminating
codes for runs 0-63, make-up codes for multiples of 64 to 1728, the
extended make-up codes 1792-2560 shared by both colours) and its 2D modes
(pass, horizontal, vertical 0 and +-1 to +-3, the extension and the EOL),
looked up as libtiff's state tables do: 12 bits for a white run, 13 for a
black one, 7 for a 2D mode, a code that is none consuming nothing. What
libtiff does, line for line:

- its bit reader (``NeedBits8``/``NeedBits16``): where the data ends with
  bits still held, the bits asked for are made up with zeros and the count
  of bits held set to them; only a read with no bits held ends the data;
- the decoders: ``Fax3DecodeRLE`` (2: modified Huffman, the bits held
  after each row cut to a whole byte; 32771: RLEW, cut to a whole 16 bits,
  then a byte skipped where none is held and the next lies at an odd
  address, which is an odd file offset), ``Fax3Decode1D`` and
  ``Fax3Decode2D`` (3: each row after an EOL, and under T4Options bit 0 a
  tag bit saying 1D or 2D; where no EOL is found, the strip is decoded
  again from its start without EOLs into the rows still to come, and so
  are the image's later strips), ``Fax4Decode`` (4: every row 2D against
  the row before, the first against a white row);
- a row's runs cleaned up as ``CLEANUP_RUNS`` does (a row too short white
  to its end, one too long cut), a bad code word, an extension code
  (uncompressed mode, which libtiff does not read whatever T4Options or
  T6Options say) or an EOL inside a 2D row ending the row there, with no
  failure; the runs written by ``_TIFFFax3fillruns`` (each run clamped to
  the row), the reference row being the runs as written.

What fails (ValueError): where libtiff's decoder returns -1 (the data ends
with no bits held inside a row of compressions 2, 3 and 32771, or before a
group 4 strip's first row ends; a row of more runs than libtiff's arrays
hold). A group 4 strip that ends early is taken as ended there: the rows
past it are left as they were (Pillow's buffer: the strip or tile read
before, or uninitialised memory for the first, which the caller fails).
"""

from __future__ import annotations

import numpy as np

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
# the 2D modes: the key is what a writer codes (tests/image_format_encoders.py)
_MODES = {"0001": "P", "001": "H", "1": 0, "011": 1, "000011": 2, "0000011": 3, "010": -1,
          "000010": -2, "0000010": -3, "0000001": "X"}

# libtiff's table states (tif_fax3.h)
_NULL, _PASS, _HORIZ, _V0, _VR, _VL, _EXT, _TERMW, _TERMB, _MAKEUPW, _MAKEUPB, _MAKEUP, _EOL = \
    range(13)
_M32 = 0xFFFFFFFF
_PAST_REFS = "ccitt: a reference row past libtiff's arrays (libtiff fails it)"
_PAST_RUNS = "ccitt: a row of more runs than libtiff holds (libtiff fails it)"


def _state_table(bits: int, protos) -> list:
    """mkg3states.c's FillTable: every ``bits``-bit value (first bit most
    significant) -> (state, width, param) of the code it starts with, in
    the order the prototypes are laid down; (_NULL, 0, 0) where none."""
    out = [(_NULL, 0, 0)] * (1 << bits)
    for state, codes in protos:
        for code, param in codes:
            w = len(code)
            base = int(code, 2) << (bits - w)
            out[base:base + (1 << (bits - w))] = [(state, w, param)] * (1 << (bits - w))
    return out


_EOLH = [("0" * 11, 0)]
_EXT_RUNS = [(c, 1792 + 64 * i) for i, c in enumerate(_EXT_MAKEUP)]
_WHITE = _state_table(12, (
    (_MAKEUPW, [(c, 64 * (i + 1)) for i, c in enumerate(_WHITE_MAKEUP)]),
    (_MAKEUP, _EXT_RUNS), (_TERMW, [(c, i) for i, c in enumerate(_WHITE_TERM)]),
    (_EOL, _EOLH)))
_BLACK = _state_table(13, (
    (_MAKEUPB, [(c, 64 * (i + 1)) for i, c in enumerate(_BLACK_MAKEUP)]),
    (_MAKEUP, _EXT_RUNS), (_TERMB, [(c, i) for i, c in enumerate(_BLACK_TERM)]),
    (_EOL, _EOLH)))
_MAIN = _state_table(7, (
    (_PASS, [("0001", 0)]), (_HORIZ, [("001", 0)]), (_V0, [("1", 0)]),
    (_VR, [("011", 1), ("000011", 2), ("0000011", 3)]),
    (_VL, [("010", 1), ("000010", 2), ("0000010", 3)]),
    (_EXT, [("0000001", 0)]), (_EOL, [("0000000", 0)])))


def _i32(v: int) -> int:
    v &= _M32
    return v - (1 << 32) if v & 0x80000000 else v


class _Eof(Exception):
    """A read with no bits held: the decoder's end-of-data label."""


class _Fail(Exception):
    """libtiff's decoder returns -1."""


class _Retry(Exception):
    """SYNC_EOL found no EOL: decode again without EOLs."""


class CcittDecoder:
    """One image's CCITT decoder state (libtiff's Fax3CodecState): the run
    arrays and the no-EOL mode live across its strips or tiles."""

    def __init__(self, compression: int, width: int, t4_options: int = 0, t6_options: int = 0):
        del t6_options  # uncompressed mode allowed or not, libtiff decodes alike
        self.comp = compression
        self.lastx = width
        self.two_d = compression == 4 or (compression == 3 and t4_options & 1)
        self.noeol = compression in (2, 32771)
        n = -(-(width + 1) // 32) * 32
        self.nruns = n * 2 if self.two_d else n
        self.mem = [0] * (2 * self.nruns)

    # -- the bit reader ------------------------------------------------------

    def _need(self, n: int, two: bool):
        if self.avail < n:
            if self.cp >= self.ep:
                if self.avail == 0:
                    raise _Eof
                self.acc <<= n - self.avail
                self.avail = n
                return
            self.acc = (self.acc << 8) | self.data[self.cp]
            self.cp += 1
            self.avail += 8
            if two and self.avail < n:
                if self.cp >= self.ep:
                    self.acc <<= n - self.avail
                    self.avail = n
                else:
                    self.acc = (self.acc << 8) | self.data[self.cp]
                    self.cp += 1
                    self.avail += 8

    def _get(self, n: int) -> int:
        return self.acc >> (self.avail - n)

    def _clr(self, n: int):
        self.avail -= n
        self.acc &= (1 << self.avail) - 1 if self.avail > 0 else 0

    def _lookup(self, table, bits: int, two: bool):
        self._need(bits, two)
        ent = table[self._get(bits)]
        self._clr(ent[1])
        return ent

    # -- runs ------------------------------------------------------------------

    def _setvalue(self, x: int):
        if self.pa >= self.thisrun + self.nruns:
            raise _Fail(_PAST_RUNS)
        self.mem[self.pa] = (self.runlength + x) & _M32
        self.pa += 1
        self.a0 += x
        self.runlength = 0

    def _cleanup(self):
        lastx = self.lastx
        if self.runlength:
            self._setvalue(0)
        if self.a0 != lastx:
            while self.a0 > lastx and self.pa > self.thisrun:
                self.pa -= 1
                self.a0 = _i32(self.a0 - self.mem[self.pa])
            if self.a0 < lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if (self.pa - self.thisrun) & 1:
                    self._setvalue(0)
                self._setvalue(lastx - self.a0)
            elif self.a0 > lastx:
                self._setvalue(lastx)
                self._setvalue(0)

    def _fill(self, row: int):
        """_TIFFFax3fillruns into buffer row ``row`` (its runs clamped to
        the row in place)."""
        mem, lastx = self.mem, self.lastx
        erun = self.pa
        if (erun - self.thisrun) & 1:
            if erun < len(mem):
                mem[erun] = 0
            erun += 1
        x, runs = 0, []
        for i in range(self.thisrun, erun, 2):
            for j in (i, i + 1):
                run = mem[j] if j < len(mem) else 0
                if x + run > lastx or run > lastx:
                    run = lastx - x
                    if j < len(mem):
                        mem[j] = run
                runs.append(run)
                x += run
        cut = np.repeat(np.arange(len(runs)) & 1, runs).astype(np.uint8)
        self.buf[row, :len(cut)] = cut
        self.written[row] = len(cut) == lastx

    # -- the row expanders (EXPAND1D, EXPAND2D) -------------------------------

    def _expand1d(self):
        lastx = self.lastx
        try:
            while True:
                while True:
                    st, _, p = self._lookup(_WHITE, 12, True)
                    if st == _EOL:
                        self.eolcnt = 1
                        return self._cleanup()
                    if st == _TERMW:
                        self._setvalue(p)
                        break
                    if st in (_MAKEUPW, _MAKEUP):
                        self.a0 += p
                        self.runlength += p
                    else:  # a bad code word
                        return self._cleanup()
                if self.a0 >= lastx:
                    return self._cleanup()
                while True:
                    st, _, p = self._lookup(_BLACK, 13, True)
                    if st == _EOL:
                        self.eolcnt = 1
                        return self._cleanup()
                    if st == _TERMB:
                        self._setvalue(p)
                        break
                    if st in (_MAKEUPB, _MAKEUP):
                        self.a0 += p
                        self.runlength += p
                    else:
                        return self._cleanup()
                if self.a0 >= lastx:
                    return self._cleanup()
                if self.mem[self.pa - 1] == 0 and self.mem[self.pa - 2] == 0:
                    self.pa -= 2
        except _Eof:
            self._cleanup()
            raise

    def _check_b1(self):
        if self.pa != self.thisrun:
            mem, end = self.mem, self.refruns + self.nruns
            while self.b1 <= self.a0 and self.b1 < self.lastx:
                if self.pb + 1 >= end:
                    raise _Fail(_PAST_REFS)
                self.b1 = _i32(self.b1 + ((mem[self.pb] + mem[self.pb + 1]) & _M32))
                self.pb += 2

    def _horiz_run(self, table, bits, term, makeup) -> bool:
        while True:
            st, _, p = self._lookup(table, bits, True)
            if st == term:
                self._setvalue(p)
                return True
            if st in (makeup, _MAKEUP):
                self.a0 += p
                self.runlength += p
            else:
                return False

    def _expand2d(self):
        lastx, mem = self.lastx, self.mem
        try:
            while self.a0 < lastx:
                if self.pa >= self.thisrun + self.nruns:
                    raise _Fail(_PAST_RUNS)
                st, _, p = self._lookup(_MAIN, 7, False)
                if st == _PASS:
                    self._check_b1()
                    if self.pb + 1 >= self.refruns + self.nruns:
                        raise _Fail(_PAST_REFS)
                    self.b1 = _i32(self.b1 + mem[self.pb])
                    self.pb += 1
                    self.runlength += self.b1 - self.a0
                    self.a0 = self.b1
                    self.b1 = _i32(self.b1 + mem[self.pb])
                    self.pb += 1
                elif st == _HORIZ:
                    if (self.pa - self.thisrun) & 1:
                        ok = (self._horiz_run(_BLACK, 13, _TERMB, _MAKEUPB)
                              and self._horiz_run(_WHITE, 12, _TERMW, _MAKEUPW))
                    else:
                        ok = (self._horiz_run(_WHITE, 12, _TERMW, _MAKEUPW)
                              and self._horiz_run(_BLACK, 13, _TERMB, _MAKEUPB))
                    if not ok:
                        return self._cleanup()
                    self._check_b1()
                elif st in (_V0, _VR):
                    self._check_b1()
                    self._setvalue(self.b1 - self.a0 + p)
                    if self.pb >= self.refruns + self.nruns:
                        raise _Fail(_PAST_REFS)
                    self.b1 = _i32(self.b1 + mem[self.pb])
                    self.pb += 1
                elif st == _VL:
                    self._check_b1()
                    if self.b1 < self.a0 + p:
                        return self._cleanup()
                    self._setvalue(self.b1 - self.a0 - p)
                    self.pb -= 1
                    self.b1 = _i32(self.b1 - mem[self.pb])
                elif st == _EXT:  # uncompressed mode: not read, the row ends
                    mem[self.pa] = (lastx - self.a0) & _M32
                    self.pa += 1
                    return self._cleanup()
                elif st == _EOL:
                    mem[self.pa] = (lastx - self.a0) & _M32
                    self.pa += 1
                    self._need(4, False)
                    self._clr(4)
                    self.eolcnt = 1
                    return self._cleanup()
                else:  # a bad code word
                    return self._cleanup()
            if self.runlength:
                if self.runlength + self.a0 < lastx:  # a final V0 expected
                    self._need(1, False)
                    if not self._get(1):
                        return self._cleanup()
                    self._clr(1)
                self._setvalue(0)
            return self._cleanup()
        except _Eof:
            self._cleanup()
            raise

    def _sync_eol(self):
        """SYNC_EOL: past the next EOL; _Eof where the data ends, _Retry
        where no EOL follows."""
        if self.noeol:
            return
        if self.eolcnt == 0:
            while True:
                self._need(11, True)
                if self._get(11) == 0:
                    break
                self._clr(1)
        while True:
            try:
                self._need(8, False)
            except _Eof:
                raise _Retry from None
            if self._get(8):
                break
            self._clr(8)
        while self._get(1) == 0:
            self._clr(1)
        self._clr(1)
        self.eolcnt = 0

    # -- a strip or tile -------------------------------------------------------

    def decode(self, data: bytes, rows: int, at: int = 0, buf=None):
        """One strip's or tile's data (file offset ``at``) -> (bits
        [rows, width] into ``buf`` where given, written [rows] bool);
        ValueError where libtiff fails it."""
        self.buf = np.zeros((rows, self.lastx), np.uint8) if buf is None else buf
        self.written = np.zeros(rows, bool)
        self.data, self.ep, self.at = data, len(data), at
        # Fax3PreDecode
        self.curruns = 0
        self.refruns = self.nruns if self.two_d else None
        if self.two_d:
            self.mem[self.refruns] = self.lastx
            self.mem[self.refruns + 1] = 0
        try:
            if self.comp in (2, 32771):
                self._decode_rle(rows)
            elif self.comp == 4:
                self._decode_g4(rows)
            else:
                self._decode_g3(rows)
        except _Fail as e:
            raise ValueError(str(e) if str(e) else
                             "ccitt: the data ends inside a row (libtiff fails it)") from None
        return self.buf, self.written

    def _start(self):
        self.acc = self.avail = self.cp = 0
        self.eolcnt = 0

    def _decode_rle(self, rows: int):
        self._start()
        self.thisrun = self.curruns
        for row in range(rows):
            self.a0 = self.runlength = 0
            self.pa = self.thisrun
            try:
                self._expand1d()
            except _Eof:
                self._fill(row)
                raise _Fail from None
            self._fill(row)
            if self.comp == 2:
                self._clr(self.avail % 8)
            else:
                self._clr(self.avail % 16)
                if self.avail == 0 and (self.at + self.cp) % 2:
                    self.cp += 1

    def _decode_g3(self, rows: int):
        row = 0
        while True:  # RETRY_WITHOUT_EOL: the strip again, into the rows to come
            self._start()
            try:
                while row < rows:
                    self.a0 = self.runlength = 0
                    self.pa = self.thisrun = self.curruns
                    try:
                        self._sync_eol()
                        if self.two_d:
                            self._need(1, False)
                            one_d = self._get(1)
                            self._clr(1)
                    except _Eof:
                        self._cleanup()
                        self._fill(row)
                        raise _Fail from None
                    try:
                        if not self.two_d or one_d:
                            self._expand1d()
                        else:
                            self.pb = self.refruns
                            self.b1 = _i32(self.mem[self.pb])
                            self.pb += 1
                            self._expand2d()
                    except _Eof:
                        self._fill(row)
                        raise _Fail from None
                    self._fill(row)
                    if self.two_d:
                        if self.pa < self.thisrun + self.nruns:
                            self._setvalue(0)
                        self.curruns, self.refruns = self.refruns, self.curruns
                    row += 1
                return
            except _Retry:
                self.noeol = True

    def _decode_g4(self, rows: int):
        self._start()
        for row in range(rows):
            self.a0 = self.runlength = 0
            self.pa = self.thisrun = self.curruns
            self.pb = self.refruns
            self.b1 = _i32(self.mem[self.pb])
            self.pb += 1
            try:
                self._expand2d()
                ended = self.eolcnt
            except _Eof:
                ended = True
            if ended:  # EOFG4: this row written, the rest left as they were
                self._fill(row)
                if row == 0:
                    raise _Fail("ccitt: a group 4 strip that ends inside its first row "
                                "(libtiff fails it)")
                return
            self._fill(row)
            self._setvalue(0)
            self.curruns, self.refruns = self.refruns, self.curruns
