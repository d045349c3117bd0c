"""CCITT fax in numpy and Python, the plain version of ``csrc/tiff.cc``'s
decoder: modified Huffman (TIFF compression 2, "CCITT RLE"), Group 3
(3; 1-D, or 2-D where T4Options bit 0 is set) and Group 4 (4), as
libtiff's ``tif_fax3.c`` decodes them for Pillow.

Both follow ``tif_fax3.c`` step for step: its lookup tables (``mkg3states``:
the main 2-D table of 7 bits, the white run table of 12 and the black of
13, each indexed by the next bits, the first in the lowest), its bit
reader (bytes MSB first; past the data's end a lookup is padded with
zeros while a bit is left), its run arrays and their clean-up at the end
of each row (``CLEANUP_RUNS``), ``SYNC_EOL`` before each Group 3 row,
``EXPAND1D`` and ``EXPAND2D``, the byte alignment of each RLE row and
``_TIFFFax3fillruns``'s clipping at the row's end.  A chunk comes to one
of ``OK`` (decoded whole), ``WARNED`` (a bad code or a row of the wrong
length, which libtiff cleans up and decodes on from, with a warning),
``FAILED`` (the data ends before the rows do, or the runs overflow
libtiff's run arrays: ``tif_fax3.c``'s decoders return -1) or ``CUT`` (a
Group 4 chunk that ends early after a whole row, which libtiff hands over
as it stands).  ``io/tiff.py`` reads only ``OK`` chunks and raises
``UnsupportedImageError`` on the rest.  ``decode`` is many times slower than the C++ decoder; the
tests hold the two to each other and to Pillow.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

OK, WARNED, FAILED, CUT = 0, 1, 2, 3

# ITU-T T.4 tables 2 and 3: the codes of the terminating run lengths 0 to
# 63, the make-up codes of 64 to 1728 (by 64) for each colour, and the
# make-up codes of 1792 to 2560 both colours share
WHITE_TERM = (
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010", "00010011",
    "00010100", "00010101", "00010110", "00010111", "00101000", "00101001", "00101010",
    "00101011", "00101100", "00101101", "00000100", "00000101", "00001010", "00001011",
    "01010010", "01010011", "01010100", "01010101", "00100100", "00100101", "01011000",
    "01011001", "01011010", "01011011", "01001010", "01001011", "00110010", "00110011",
    "00110100",
)
WHITE_MAKEUP = (
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011",
)
BLACK_TERM = (
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011", "000011001100",
    "000011001101", "000001101000", "000001101001", "000001101010", "000001101011",
    "000011010010", "000011010011", "000011010100", "000011010101", "000011010110",
    "000011010111", "000001101100", "000001101101", "000011011010", "000011011011",
    "000001010100", "000001010101", "000001010110", "000001010111", "000001100100",
    "000001100101", "000001010010", "000001010011", "000000100100", "000000110111",
    "000000111000", "000000100111", "000000101000", "000001011000", "000001011001",
    "000000101011", "000000101100", "000001011010", "000001100110", "000001100111",
)
BLACK_MAKEUP = (
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011", "000000110100",
    "000000110101", "0000001101100", "0000001101101", "0000001001010", "0000001001011",
    "0000001001100", "0000001001101", "0000001110010", "0000001110011", "0000001110100",
    "0000001110101", "0000001110110", "0000001110111", "0000001010010", "0000001010011",
    "0000001010100", "0000001010101", "0000001011010", "0000001011011", "0000001100100",
    "0000001100101",
)
EXT_MAKEUP = (
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011", "000000010100",
    "000000010101", "000000010110", "000000010111", "000000011100", "000000011101",
    "000000011110", "000000011111",
)

(S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERM_W, S_TERM_B, S_MAKEUP_W, S_MAKEUP_B,
 S_MAKEUP, S_EOL) = range(13)
EOL = "000000000001"


def _table(wid: int, codes) -> list:
    """2**wid entries (state, width, param) indexed by the next ``wid``
    bits, the first in the lowest; (S_NULL, 0, 0) where no code fits."""
    tab = [(S_NULL, 0, 0)] * (1 << wid)
    for code, state, param in codes:
        rev = int(code[::-1], 2)
        for hi in range(1 << (wid - len(code))):
            tab[rev | (hi << len(code))] = (state, len(code), param)
    return tab


def _tables() -> Tuple[list, list, list]:
    main = _table(7, [("0001", S_PASS, 0), ("001", S_HORIZ, 0), ("1", S_V0, 0), ("011", S_VR, 1),
                      ("000011", S_VR, 2), ("0000011", S_VR, 3), ("010", S_VL, 1),
                      ("000010", S_VL, 2), ("0000010", S_VL, 3), ("0000001", S_EXT, 0),
                      ("0000000", S_EOL, 0)])
    ext = [(c, S_MAKEUP, 1792 + 64 * i) for i, c in enumerate(EXT_MAKEUP)]
    white = _table(12, [(c, S_TERM_W, i) for i, c in enumerate(WHITE_TERM)]
                   + [(c, S_MAKEUP_W, 64 * (i + 1)) for i, c in enumerate(WHITE_MAKEUP)]
                   + ext + [(EOL, S_EOL, 0)])
    black = _table(13, [(c, S_TERM_B, i) for i, c in enumerate(BLACK_TERM)]
                   + [(c, S_MAKEUP_B, 64 * (i + 1)) for i, c in enumerate(BLACK_MAKEUP)]
                   + ext + [(EOL, S_EOL, 0)])
    return main, white, black


_TABLES = None
_MASK = 0xFFFFFFFF


def _i32(v: int) -> int:
    """``v`` as C's int32 holds it (libtiff adds uint32 runs to int32 positions)."""
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


class _Overflow(Exception):
    """The runs overflowed libtiff's run arrays."""


class _Fax:
    """One chunk's decoder state (``tif_fax3.c``'s ``Fax3CodecState``)."""

    def __init__(self, data: bytes, two_d: bool, rowpixels: int):
        global _TABLES
        if _TABLES is None:
            _TABLES = _tables()
        self.main, self.white, self.black = _TABLES
        self.data, self.cp = data, 0
        self.acc, self.bits = 0, 0
        self.lastx = rowpixels
        self.nruns = -(-(rowpixels + 1) // 32) * 32 * (2 if two_d else 1)
        self.runs = [0] * (2 * self.nruns + 2)  # + the slots a full row's fill pads
        self.cur, self.ref = 0, self.nruns  # offsets into runs
        self.warned = False
        self.eol = 0
        self.a0 = self.run_length = self.pa = self.pb = self.b1 = 0

    # NeedBits8/NeedBits16, GetBits, ClrBits
    def need(self, n: int) -> bool:
        if self.bits < n:
            if self.cp >= len(self.data):
                if self.bits == 0:
                    return False
                self.bits = n
            else:
                self.acc |= _REV[self.data[self.cp]] << self.bits
                self.cp += 1
                self.bits += 8
                if self.bits < n:
                    if self.cp >= len(self.data):
                        self.bits = n
                    else:
                        self.acc |= _REV[self.data[self.cp]] << self.bits
                        self.cp += 1
                        self.bits += 8
        return True

    def get(self, n: int) -> int:
        return self.acc & ((1 << n) - 1)

    def clr(self, n: int) -> None:
        self.bits -= n
        self.acc >>= n

    def lookup(self, tab: list, wid: int):
        if not self.need(wid):
            return None
        e = tab[self.get(wid)]
        self.clr(e[1])
        return e

    def setvalue(self, x: int) -> None:
        if self.pa >= self.cur + self.nruns:
            raise _Overflow
        self.runs[self.pa] = (self.run_length + x) & _MASK
        self.pa += 1
        self.a0 += x
        self.run_length = 0

    def cleanup_runs(self) -> None:
        if self.run_length:
            self.setvalue(0)
        if self.a0 != self.lastx:
            self.warned = True
            while self.a0 > self.lastx and self.pa > self.cur:
                self.pa -= 1
                self.a0 = _i32(self.a0 - self.runs[self.pa])
            if self.a0 < self.lastx:
                if self.a0 < 0:
                    self.a0 = 0
                if (self.pa - self.cur) & 1:
                    self.setvalue(0)
                self.setvalue(self.lastx - self.a0)
            elif self.a0 > self.lastx:
                self.setvalue(self.lastx)
                self.setvalue(0)

    def sync_eol(self) -> bool:
        if self.eol == 0:
            while True:
                if not self.need(11):
                    return False
                if self.get(11) == 0:
                    break
                self.clr(1)
        while True:
            if not self.need(8):
                return False
            if self.get(8):
                break
            self.clr(8)
        while self.get(1) == 0:
            self.clr(1)
        self.clr(1)
        self.eol = 0
        return True

    def run(self, black: bool, one_d: bool) -> int:
        """One colour's run: 0 done, 1 an EOL or a bad code ended the row,
        -1 the data ended."""
        tab, wid = (self.black, 13) if black else (self.white, 12)
        term, makeup = (S_TERM_B, S_MAKEUP_B) if black else (S_TERM_W, S_MAKEUP_W)
        while True:
            e = self.lookup(tab, wid)
            if e is None:
                return -1
            state, _, param = e
            if state == term:
                self.setvalue(param)
                return 0
            if state in (makeup, S_MAKEUP):
                self.a0 += param
                self.run_length += param
                continue
            if one_d and state == S_EOL:
                self.eol = 1
                return 1
            self.warned = True
            return 1

    def expand_1d(self) -> bool:
        while True:
            r = self.run(False, True)
            if r == 0 and self.a0 < self.lastx:
                r = self.run(True, True)
            if r == -1:
                return False
            if r == 1 or self.a0 >= self.lastx:
                break
            if self.runs[self.pa - 1] == 0 and self.runs[self.pa - 2] == 0:
                self.pa -= 2
        self.cleanup_runs()
        return True

    def check_b1(self) -> None:
        if self.pa != self.cur:
            while self.b1 <= self.a0 and self.b1 < self.lastx:
                if self.pb + 1 >= self.ref + self.nruns:
                    raise _Overflow
                self.b1 = _i32(self.b1 + self.runs[self.pb] + self.runs[self.pb + 1])
                self.pb += 2

    def expand_2d(self) -> bool:
        """EXPAND2D; False where the data ends first."""
        while self.a0 < self.lastx:
            if self.pa >= self.cur + self.nruns:
                raise _Overflow
            e = self.lookup(self.main, 7)
            if e is None:
                return False
            state, _, param = e
            if state == S_PASS:
                self.check_b1()
                if self.pb + 1 >= self.ref + self.nruns:
                    raise _Overflow
                self.b1 = _i32(self.b1 + self.runs[self.pb])
                self.pb += 1
                self.run_length += self.b1 - self.a0
                self.a0 = self.b1
                self.b1 = _i32(self.b1 + self.runs[self.pb])
                self.pb += 1
            elif state == S_HORIZ:
                black_first = bool((self.pa - self.cur) & 1)
                r = self.run(black_first, False)
                if r == 0:
                    r = self.run(not black_first, False)
                if r == -1:
                    return False
                if r == 1:
                    return self.eol_2d()
                self.check_b1()
            elif state in (S_V0, S_VR):
                self.check_b1()
                self.setvalue(self.b1 - self.a0 + (param if state == S_VR else 0))
                if self.pb >= self.ref + self.nruns:
                    raise _Overflow
                self.b1 = _i32(self.b1 + self.runs[self.pb])
                self.pb += 1
            elif state == S_VL:
                self.check_b1()
                if self.b1 < self.a0 + param:
                    self.warned = True
                    return self.eol_2d()
                self.setvalue(self.b1 - self.a0 - param)
                self.pb -= 1
                self.b1 = _i32(self.b1 - self.runs[self.pb])
            elif state in (S_EXT, S_EOL):
                self.runs[self.pa] = (self.lastx - self.a0) & _MASK
                self.pa += 1
                if state == S_EXT:
                    self.warned = True
                    return self.eol_2d()
                if not self.need(4):
                    return False
                if self.get(4):
                    self.warned = True
                self.clr(4)
                self.eol = 1
                return self.eol_2d()
            else:
                self.warned = True
                return self.eol_2d()
        if self.run_length:
            if self.run_length + self.a0 < self.lastx:
                if not self.need(1):
                    return False
                if not self.get(1):
                    self.warned = True
                    return self.eol_2d()
                self.clr(1)
            self.setvalue(0)
        return self.eol_2d()

    def eol_2d(self) -> bool:
        self.cleanup_runs()
        return True

    def fill(self, row: np.ndarray) -> None:
        """_TIFFFax3fillruns: white runs as 0, black as 1, clipped at lastx."""
        runs, erun = self.cur, self.pa
        if (erun - runs) & 1:
            self.runs[erun] = 0
            erun += 1
        x = 0
        for i in range(runs, erun):
            r = self.runs[i]
            if x + r > self.lastx or r > self.lastx:
                r = self.runs[i] = (self.lastx - x) & _MASK
            row[x:x + r] = (i - runs) & 1
            x += r


_REV = [int(f"{i:08b}"[::-1], 2) for i in range(256)]


def decode(data: bytes, compression: int, options: int, width: int, rows: int
           ) -> Tuple[np.ndarray, int]:
    """(``rows`` x ``width`` uint8 pixels, 1 where a black run covers them,
    and the chunk's outcome: ``OK``, ``WARNED``, ``FAILED`` or ``CUT``) of
    a CCITT chunk; ``compression`` 2, 3 (``options`` its T4Options) or 4.
    Rows past a chunk that does not decode whole are left zero."""
    two_d = compression == 4 or (compression == 3 and bool(options & 1))
    f = _Fax(data, two_d, width)
    out = np.zeros((rows, width), np.uint8)
    if two_d:
        f.runs[f.ref], f.runs[f.ref + 1] = width, 0
    try:
        for line in range(rows):
            row = out[line]
            f.a0 = f.run_length = 0
            f.pa = f.cur
            if compression == 2:
                if not f.expand_1d():
                    return out, FAILED
                f.fill(row)
                f.clr(f.bits & 7)
                continue
            if compression == 3:
                if not f.sync_eol():
                    return out, FAILED
                one_d = True
                if two_d:
                    if not f.need(1):
                        return out, FAILED
                    one_d = bool(f.get(1))
                    f.clr(1)
                    f.pb = f.ref
                    f.b1 = _i32(f.runs[f.pb])
                    f.pb += 1
                if not (f.expand_1d() if one_d else f.expand_2d()):
                    return out, FAILED
                f.fill(row)
                if two_d:
                    if f.pa < f.cur + f.nruns:
                        f.setvalue(0)
                    f.cur, f.ref = f.ref, f.cur
                continue
            f.pb = f.ref
            f.b1 = _i32(f.runs[f.pb])
            f.pb += 1
            if not f.expand_2d() or f.eol:  # the data or an EOFB ends the strip
                return out, CUT if line else FAILED
            f.fill(row)
            f.setvalue(0)
            f.cur, f.ref = f.ref, f.cur
    except _Overflow:
        return out, FAILED
    return out, WARNED if f.warned else OK
