"""CCITT bilevel decoding in numpy and Python, as libtiff's `tif_fax3.c` decodes TIFF.

The JAX package reads TIFF through OpenCV, which reads a bilevel image with
libtiff's RGBA interface; the codecs are libtiff's fax decoders, one strip
or tile at a time, each starting from an all-white reference line:

  - compression 2 (`Fax3DecodeRLE`, "CCITT modified Huffman"): every row
    one-dimensional, coded from a byte boundary, no EOL codes;
  - compression 3 (`Fax3Decode1D` / `Fax3Decode2D`, T.4 Group 3): every
    row after an EOL code (found as `SYNC_EOL` finds it: eleven zero bits,
    any further zeros, which is how fill bits look, and a one); under
    `T4Options` bit 0 a tag bit after each EOL says one- (1) or
    two-dimensional (0) coding;
  - compression 4 (`Fax4Decode`, T.6 Group 4): every row two-dimensional,
    no EOL codes.

A row's changing elements are decoded as T.4 section 4.2 defines the modes:
pass, horizontal (a pair of runs), vertical (a1 - b1 in -3..3). The bits
come out as libtiff fills them: black runs as ones. Uncompressed mode (the
extension codes, `T4Options` bit 1) raises `NotImplementedError` (ROADMAP
Queue 1 item 10); data that breaks the codes raises `ValueError`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from yolo_infer_tpu_torch.data.ccitt_tables import EOL, EXTENSION, HORIZONTAL, MODES, PASS, run_codes

_UNSUPPORTED = "the port reads CCITT TIFF without uncompressed mode; {} is ROADMAP Queue 1 item 10"
_LUT_BITS = 13  # the longest code (black make-up) is 13 bits


def _lut(codes: Dict[str, object]) -> List[Tuple[int, object]]:
    """{bit string: value} -> a table over the next 13 bits of (length, value);
    (0, None) where no code starts."""
    table: List[Tuple[int, object]] = [(0, None)] * (1 << _LUT_BITS)
    for code, value in codes.items():
        pad = _LUT_BITS - len(code)
        base = int(code, 2) << pad
        for i in range(1 << pad):
            table[base + i] = (len(code), value)
    return table


_RUNS = (_lut({**run_codes(False), EOL: -1}), _lut({**run_codes(True), EOL: -1}))
_MODES = _lut({**MODES, EOL: "EOL"})


class _Bits:
    """The strip's bits, most significant first, read through 32-bit windows
    (zeros past the end)."""

    def __init__(self, data: bytes):
        b = np.frombuffer(bytes(data) + b"\0" * 8, np.uint8).astype(np.uint32)
        self.win = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
        self.total = len(data) * 8
        self.p = 0

    def peek13(self) -> int:
        p = self.p
        return (self.win[p >> 3] >> (19 - (p & 7))) & 0x1FFF

    def bit(self) -> int:
        p = self.p
        self.p = p + 1
        return (self.win[p >> 3] >> (31 - (p & 7))) & 1

    def align(self) -> None:
        self.p = (self.p + 7) & ~7

    def sync_eol(self) -> bool:
        """Past the next EOL (`SYNC_EOL`); False at the end of the data."""
        p, total, win = self.p, self.total, self.win
        while True:  # eleven zero bits
            if p + 11 > total:
                return False
            if (win[p >> 3] >> (21 - (p & 7))) & 0x7FF == 0:
                break
            p += 1
        p += 11
        while p < total and not (win[p >> 3] >> (31 - (p & 7))) & 1:
            p += 1
        if p >= total:
            return False
        self.p = p + 1
        return True


def _run(bits: _Bits, black: int) -> int:
    """One run of a colour: make-up codes, then a terminating code."""
    table, total = _RUNS[black], 0
    while True:
        length, value = table[bits.peek13()]
        if not length or value < 0 or bits.p + length > bits.total:
            raise ValueError("corrupt CCITT data: a bad run code")
        bits.p += length
        total += value
        if value < 64:
            return total


def _row_1d(bits: _Bits, width: int) -> List[int]:
    """A one-dimensional row's changing elements (where a run ends)."""
    changes, a0, black = [], 0, 0
    while a0 < width:
        a0 += _run(bits, black)
        if a0 > width:
            raise ValueError("corrupt CCITT data: a row runs past its width")
        changes.append(a0)
        black ^= 1
    return changes


def _row_2d(bits: _Bits, ref: List[int], width: int) -> List[int]:
    """A two-dimensional row against the reference line's changing elements
    `ref` (alternately to black and to white, then `width` three times)."""
    changes: List[int] = []
    a0, black, j = -1, 0, 0
    while a0 < width:
        # b1: the first changing element of the reference line right of a0
        # whose colour is opposite to a0's (to black at even indices); it
        # may lie left of the last b1, so step from the first element right
        # of a0, which only moves right
        while ref[j] <= a0:
            j += 1
        i = j + ((j & 1) != black)
        b1 = ref[i]
        length, mode = _MODES[bits.peek13()]
        if not length:
            raise ValueError("corrupt CCITT data: a bad mode code")
        bits.p += length
        if mode == PASS:
            a0 = ref[i + 1]  # b2; a0's colour stays
        elif mode == HORIZONTAL:
            a1 = max(a0, 0) + _run(bits, black)
            a2 = a1 + _run(bits, black ^ 1)
            if a2 > width:
                raise ValueError("corrupt CCITT data: a row runs past its width")
            changes += [a1, a2]
            a0 = a2
        elif mode == EXTENSION:
            raise NotImplementedError(_UNSUPPORTED.format("uncompressed mode (a T.4/T.6 extension code)"))
        elif mode == "EOL":
            raise ValueError("corrupt CCITT data: an EOL inside a row")
        else:
            a1 = b1 + mode
            if a1 > width or a1 < max(a0, 0):
                raise ValueError("corrupt CCITT data: a vertical mode leaves the row")
            changes.append(a1)
            a0, black = a1, black ^ 1
    return changes


def _fill(changes: List[int], width: int) -> np.ndarray:
    """Changing elements -> one row of 0 (white) and 1 (black)."""
    marks = np.zeros(width + 1, np.int8)
    for at in changes:
        marks[min(at, width)] ^= 1
    return np.bitwise_xor.accumulate(marks)[:width].astype(np.uint8)


def decode_ccitt(data: bytes, width: int, rows: int, compression: int, t4_options: int = 0,
                 t6_options: int = 0) -> np.ndarray:
    """One strip or tile (bytes in fill order 1) -> (rows, width) uint8 bits,
    black 1. Rows past the end of the data stay white (0), as libtiff leaves
    them after its premature-end warning."""
    if compression not in (2, 3, 4):
        raise ValueError(f"not a CCITT compression: {compression}")
    if (compression == 3 and t4_options & 2) or (compression == 4 and t6_options & 2):
        raise NotImplementedError(_UNSUPPORTED.format("uncompressed mode (T4Options or T6Options bit 1)"))
    bits = _Bits(data)
    out = np.zeros((rows, width), np.uint8)
    ref = [width] * 3  # the imaginary all-white line above the first row
    for y in range(rows):
        if compression == 2:
            if bits.p >= bits.total:
                break
            changes = _row_1d(bits, width)
            bits.align()
        elif compression == 3:
            if not bits.sync_eol():
                break
            one_d = not t4_options & 1 or bits.bit()
            changes = _row_1d(bits, width) if one_d else _row_2d(bits, ref, width)
        else:
            if bits.p >= bits.total:
                break
            changes = _row_2d(bits, ref, width)
        out[y] = _fill(changes, width)
        ref = changes + [width] * 3
    return out
