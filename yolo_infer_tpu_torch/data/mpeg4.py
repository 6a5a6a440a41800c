"""MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile video in numpy: a decoder and an intra-only encoder.

The JAX package reads and writes video through OpenCV, whose FFmpeg
backend writes `.mp4`, `.mov`, `.mkv` and, under the fourccs `XVID`,
`FMP4` and `DIVX`, `.avi` files as MPEG-4 Part 2 Simple Profile ("mp4v").
`Mpeg4Decoder` decodes those streams to the frames OpenCV returns for them,
bit for bit: libavcodec's MPEG-4 decoder followed by swscale's conversion to
BGR. The containers are `data/mp4.py`, `data/mkv.py` and `data/avi.py`.

Decoded, as far as those streams reach:

  headers      visual object sequence, visual object, video object layer
               (VOL), group of VOPs and user data; a VOL may come from the
               container (`config`) or in band, and is parsed again each
               time it recurs
  VOPs         I-VOPs and P-VOPs (`low_delay` 1: no reordering); intra,
               inter and skipped (`not_coded`) macroblocks, intra
               macroblocks in P-VOPs
  entropy      the MCBPC, CBPY, MVD and DC-size VLCs; the intra and inter
               TCOEF VLCs with escape modes 1 and 2 (the LMAX and RMAX
               tables) and 3 (fixed length, with its marker bits)
  texture      DC prediction by the gradient rule with the `dc_scaler`
               tables, AC prediction with the alternate horizontal and
               vertical scans, `intra_dc_vlc_thr` (DC coded as an AC
               coefficient past it), H.263 inverse quantisation saturated
               to [-2048, 2047], and libavcodec's "simple" integer IDCT (the
               one it picks for streams whose user data names Lavc)
  motion       median prediction with the edge rules, the MVD range wrap
               of `vop_fcode_forward` (1 to 7), half-pel interpolation under
               `vop_rounding_type`, unrestricted vectors over an edge-
               replicated reference and H.263 chroma vector rounding
  output       cropping to the VOL's width and height, and swscale's YUV
               4:2:0 to BGR (BT.601, limited range, chroma repeated 2x2,
               16-bit fixed point: `yuv420_to_bgr`)

The parser takes a whole VOP's macroblocks into the coefficient domain
first, then runs one dequantisation and one IDCT over all its blocks, then
forms every macroblock's motion-compensated prediction in one gather.

Raising `NotImplementedError` (ROADMAP Queue 1 item 11.2), a VOL that
announces the syntax before the first frame and a VOP when it is met:

  - B-VOPs (`low_delay` 0) and S-VOPs (sprites, GMC)
  - quarter-pel motion (`quarter_sample`), interlace, MPEG quantisation
    (`quant_type` 1), 4MV (`inter4v`) macroblocks, `dquant`
  - data partitioning, resync markers and video packets, reversible VLC
  - the short (H.263) video header, a not-coded VOP
  - shapes other than rectangular, `not_8_bit`, complexity estimation,
    newpred, reduced resolution and scalability
  - chroma other than 4:2:0, and odd heights (swscale converts those
    through its scaling path, whose pixels are not reproduced)
  - streams that libavcodec decodes with another IDCT or its bug
    workarounds: user data naming XviD or DivX or an old Lavc build, or no
    such user data under an Xvid fourcc in any letter case (what the
    headers before the first VOP show raises as the file is opened)

A corrupt or truncated stream raises `ValueError`.

`Mpeg4Encoder` writes I-VOPs at a fixed quantiser with DC and AC
prediction (the DC coded as an AC coefficient on request), one per frame,
every code computed in numpy at once; its `reconstruction` of each
frame is what the decoder returns for it, bit for bit. `counts` on the
decoder tallies each decoded case (the tests read it).
"""

from __future__ import annotations

import re
from collections import Counter
from fractions import Fraction
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_ROADMAP = "ROADMAP Queue 1 item 11.2"

# --------------------------------------------------------------- the tables

# (code, length) of the intra MCBPC; index = 4 * dquant + cbpc, 8 is stuffing
_INTRA_MCBPC = [(1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6), (3, 6), (1, 9)]
# the inter MCBPC; index = 16 * inter4v + 8 * dquant + 4 * intra + cbpc, 20 is stuffing
_INTER_MCBPC = {0: (1, 1), 1: (3, 4), 2: (2, 4), 3: (5, 6), 4: (3, 5), 5: (4, 8), 6: (3, 8), 7: (3, 7),
                8: (3, 3), 9: (7, 7), 10: (6, 7), 11: (5, 9), 12: (4, 6), 13: (4, 9), 14: (3, 9), 15: (2, 9),
                16: (2, 3), 17: (5, 7), 18: (4, 7), 19: (5, 8), 20: (1, 9)}
# CBPY of an intra macroblock (an inter one's is 15 minus it)
_CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4), (2, 5), (3, 6), (5, 4), (10, 4),
         (4, 4), (8, 4), (6, 4), (3, 2)]
# motion vector difference magnitudes 0..32
_MVD = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7), (11, 9), (10, 9), (9, 9), (17, 10),
        (16, 10), (15, 10), (14, 10), (13, 10), (12, 10), (11, 10), (10, 10), (9, 10), (8, 10), (7, 10), (6, 10),
        (5, 10), (4, 10), (7, 11), (6, 11), (5, 11), (4, 11), (3, 11), (2, 11), (3, 12), (2, 12)]
# dct_dc_size_luminance / _chrominance, sizes 0..12
_DC_LUM = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9), (1, 10), (1, 11)]
_DC_CHROM = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9), (1, 10), (1, 11),
             (1, 12)]

# TCOEF: (code, length) and (run, level) of each event; the first `last`
# events have last 0, the rest last 1; the escape is (3, 7)
_INTRA_VLC = [
    (2, 2), (6, 3), (15, 4), (13, 5), (12, 5), (21, 6), (19, 6), (18, 6), (23, 7), (31, 8), (30, 8), (29, 8),
    (37, 9), (36, 9), (35, 9), (33, 9), (33, 10), (32, 10), (15, 10), (14, 10), (7, 11), (6, 11), (32, 11),
    (33, 11), (80, 12), (81, 12), (82, 12), (14, 4), (20, 6), (22, 7), (28, 8), (32, 9), (31, 9), (13, 10),
    (34, 11), (83, 12), (85, 12), (11, 5), (21, 7), (30, 9), (12, 10), (86, 12), (17, 6), (27, 8), (29, 9),
    (11, 10), (16, 6), (34, 9), (10, 10), (13, 6), (28, 9), (8, 10), (18, 7), (27, 9), (84, 12), (20, 7), (26, 9),
    (87, 12), (25, 8), (9, 10), (24, 8), (35, 11), (23, 8), (25, 9), (24, 9), (7, 10), (88, 12), (7, 4), (12, 6),
    (22, 8), (23, 9), (6, 10), (5, 11), (4, 11), (89, 12), (15, 6), (22, 9), (5, 10), (14, 6), (4, 10), (17, 7),
    (36, 11), (16, 7), (37, 11), (19, 7), (90, 12), (21, 8), (91, 12), (20, 8), (19, 8), (26, 8), (21, 9), (20, 9),
    (19, 9), (18, 9), (17, 9), (38, 11), (39, 11), (92, 12), (93, 12), (94, 12), (95, 12)]
_INTRA_RUN = ([0] * 27 + [1] * 10 + [2] * 5 + [3] * 4 + [4] * 3 + [5] * 3 + [6] * 3 + [7] * 3 + [8] * 2 + [9] * 2
              + [10, 11, 12, 13, 14] + [0] * 8 + [1] * 3 + [2, 2, 3, 3, 4, 4, 5, 5, 6, 6] + list(range(7, 21)))
_INTRA_LEVEL = (list(range(1, 28)) + list(range(1, 11)) + list(range(1, 6)) + [1, 2, 3, 4] + [1, 2, 3] * 3
                + [1, 2, 3] + [1, 2] * 2 + [1] * 5 + list(range(1, 9)) + [1, 2, 3] + [1, 2] * 5 + [1] * 14)
_INTRA_LAST = 67
_INTER_VLC = [
    (2, 2), (15, 4), (21, 6), (23, 7), (31, 8), (37, 9), (36, 9), (33, 10), (32, 10), (7, 11), (6, 11), (32, 11),
    (6, 3), (20, 6), (30, 8), (15, 10), (33, 11), (80, 12), (14, 4), (29, 8), (14, 10), (81, 12), (13, 5), (35, 9),
    (13, 10), (12, 5), (34, 9), (82, 12), (11, 5), (12, 10), (83, 12), (19, 6), (11, 10), (84, 12), (18, 6),
    (10, 10), (17, 6), (9, 10), (16, 6), (8, 10), (22, 7), (85, 12), (21, 7), (20, 7), (28, 8), (27, 8), (33, 9),
    (32, 9), (31, 9), (30, 9), (29, 9), (28, 9), (27, 9), (26, 9), (34, 11), (35, 11), (86, 12), (87, 12), (7, 4),
    (25, 9), (5, 11), (15, 6), (4, 11), (14, 6), (13, 6), (12, 6), (19, 7), (18, 7), (17, 7), (16, 7), (26, 8),
    (25, 8), (24, 8), (23, 8), (22, 8), (21, 8), (20, 8), (19, 8), (24, 9), (23, 9), (22, 9), (21, 9), (20, 9),
    (19, 9), (18, 9), (17, 9), (7, 10), (6, 10), (5, 10), (4, 10), (36, 11), (37, 11), (38, 11), (39, 11),
    (88, 12), (89, 12), (90, 12), (91, 12), (92, 12), (93, 12), (94, 12), (95, 12)]
_INTER_RUN = ([0] * 12 + [1] * 6 + [2] * 4 + [3] * 3 + [4] * 3 + [5] * 3 + [6] * 3 + [7] * 2 + [8] * 2 + [9] * 2
              + [10] * 2 + list(range(11, 27)) + [0, 0, 0, 1, 1] + list(range(2, 41)))
_INTER_LEVEL = (list(range(1, 13)) + list(range(1, 7)) + [1, 2, 3, 4] + [1, 2, 3] * 4 + [1, 2] * 4 + [1] * 16
                + [1, 2, 3, 1, 2] + [1] * 39)
_INTER_LAST = 58
_ESCAPE = (3, 7)

_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7,
           14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39,
           46, 53, 60, 61, 54, 47, 55, 62, 63]
_ALT_H = [0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14, 13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22,
          23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59,
          52, 53, 54, 55, 60, 61, 62, 63]
_ALT_V = [(p % 8) * 8 + p // 8 for p in _ALT_H]  # the alternate vertical scan is the horizontal one transposed

_DC_THRESHOLD = (99, 13, 15, 17, 19, 21, 23, 0)  # intra_dc_vlc_thr: below this QP the DC has its own VLC


def _dc_scaler(q: int, luma: bool) -> int:
    if q < 5:
        return 8
    if luma:
        return 2 * q if q < 9 else q + 8 if q < 25 else 2 * q - 16
    return (q + 13) // 2 if q < 25 else q - 6


def _lut(codes: Dict[int, Tuple[int, int]], bits: int) -> List[Optional[Tuple[int, int]]]:
    """A `bits`-wide lookup: entry w is (value, length) of the code that prefixes w."""
    table: List[Optional[Tuple[int, int]]] = [None] * (1 << bits)
    for value, (code, length) in codes.items():
        if length == 0:
            continue
        lo = code << (bits - length)
        for w in range(lo, lo + (1 << (bits - length))):
            table[w] = (value, length)
    return table


def _tcoef_lut(vlc, runs, levels, last_from) -> List[Optional[Tuple[int, int, int, int]]]:
    """13-bit lookup of TCOEF: (length with the sign bit, last, run, signed
    level); level 0 is the escape (its length without a sign)."""
    codes = {i: c for i, c in enumerate(vlc)}
    codes[len(vlc)] = _ESCAPE
    table: List[Optional[Tuple[int, int, int, int]]] = [None] * 8192
    for w, hit in enumerate(_lut(codes, 13)):
        if hit is not None:
            i, length = hit
            if i == len(vlc):
                table[w] = (length, 0, 0, 0)
            else:
                sign = (w >> (12 - length)) & 1
                table[w] = (length + 1, int(i >= last_from), runs[i], -levels[i] if sign else levels[i])
    return table


def _max_tables(runs, levels, last_from):
    """LMAX[last][run] and RMAX[last][level] of a TCOEF table."""
    lmax: List[Dict[int, int]] = [{}, {}]
    rmax: List[Dict[int, int]] = [{}, {}]
    for i, (run, level) in enumerate(zip(runs, levels)):
        last = int(i >= last_from)
        lmax[last][run] = max(lmax[last].get(run, 0), level)
        rmax[last][level] = max(rmax[last].get(level, 0), run)
    return lmax, rmax


_LUT_INTRA_MCBPC = _lut(dict(enumerate(_INTRA_MCBPC)), 9)
_LUT_INTER_MCBPC = _lut(_INTER_MCBPC, 9)
_LUT_CBPY = _lut(dict(enumerate(_CBPY)), 6)
_LUT_MVD = _lut(dict(enumerate(_MVD)), 12)
_LUT_DC = (_lut(dict(enumerate(_DC_LUM)), 12), _lut(dict(enumerate(_DC_CHROM)), 12))
_LUT_INTRA = _tcoef_lut(_INTRA_VLC, _INTRA_RUN, _INTRA_LEVEL, _INTRA_LAST)
_LUT_INTER = _tcoef_lut(_INTER_VLC, _INTER_RUN, _INTER_LEVEL, _INTER_LAST)
_MAX_INTRA = _max_tables(_INTRA_RUN, _INTRA_LEVEL, _INTRA_LAST)
_MAX_INTER = _max_tables(_INTER_RUN, _INTER_LEVEL, _INTER_LAST)

# start codes (the byte after 00 00 01) that decoding reads; the visual object
# sequence, visual object and group-of-VOPs headers carry nothing it needs
VOP_START = 0xB6
VOL_FIRST, VOL_LAST = 0x20, 0x2F
USER_DATA = 0xB2


def start_codes(data: bytes) -> List[Tuple[int, int, int]]:
    """(code, payload start, payload end) of each `00 00 01 xx` unit in data."""
    found = [m.start() for m in re.finditer(b"\x00\x00\x01", data)]
    units = []
    for k, at in enumerate(found):
        if at + 3 >= len(data):
            break
        end = found[k + 1] if k + 1 < len(found) else len(data)
        if units and at < units[-1][1]:  # a 00 00 01 inside the previous code's own bytes
            continue
        units.append((data[at + 3], at + 4, end))
    return units


def _windows(data: bytes) -> List[int]:
    """The 40 bits from each byte offset of data (zero-padded past the end)."""
    a = np.frombuffer(bytes(data) + bytes(8), np.uint8).astype(np.uint64)
    return (a[:-4] << 32 | a[1:-3] << 24 | a[2:-2] << 16 | a[3:-1] << 8 | a[4:]).tolist()


class _Bits:
    """A big-endian bit reader over bytes (zeros past the end)."""

    __slots__ = ("words", "pos", "end")

    def __init__(self, data: bytes):
        self.words = _windows(data)
        self.pos = 0
        self.end = 8 * len(data)

    def peek(self, n: int) -> int:
        p = self.pos
        return (self.words[p >> 3] >> (40 - (p & 7) - n)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v

    def bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        return (self.words[p >> 3] >> (39 - (p & 7))) & 1

    def marker(self, what: str) -> None:
        if not self.bit():
            raise ValueError(f"corrupt MPEG-4 stream: marker bit missing {what}")

    def left(self) -> int:
        return self.end - self.pos


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"MPEG-4 Part 2: {what} is not decoded by the port ({_ROADMAP})")


class Vol:
    """The fields of a video object layer header that decoding uses."""

    def __init__(self, data: bytes):
        b = _Bits(data)
        b.bit()  # random_accessible_vol
        self.object_type = b.read(8)
        verid = 1
        if b.bit():  # is_object_layer_identifier
            verid = b.read(4)
            b.read(3)
        if b.read(4) == 15:  # aspect_ratio_info: extended PAR
            b.read(16)
        self.low_delay = int(self.object_type in (1, 17))  # libavcodec's default: simple and advanced simple
        if b.bit():  # vol_control_parameters
            if b.read(2) != 1:
                raise _unsupported("a chroma format other than 4:2:0")
            self.low_delay = b.bit()
            if b.bit():  # vbv_parameters
                b.read(15); b.marker("in vbv"); b.read(15); b.marker("in vbv"); b.read(15); b.marker("in vbv")
                b.read(3); b.read(11); b.marker("in vbv"); b.read(15); b.marker("in vbv")
        if b.read(2) != 0:
            raise _unsupported("a non-rectangular video object layer shape")
        b.marker("before vop_time_increment_resolution")
        self.time_resolution = b.read(16)
        if self.time_resolution == 0:
            raise ValueError("corrupt MPEG-4 VOL: vop_time_increment_resolution 0")
        self.time_bits = max((self.time_resolution - 1).bit_length(), 1)
        b.marker("after vop_time_increment_resolution")
        if b.bit():  # fixed_vop_rate
            b.read(self.time_bits)
        b.marker("before width")
        self.width = b.read(13)
        b.marker("before height")
        self.height = b.read(13)
        b.marker("after height")
        if not (self.width and self.height):
            raise ValueError(f"corrupt MPEG-4 VOL: a frame of {self.width}x{self.height}")
        if b.bit():
            raise _unsupported("interlaced video")
        b.bit()  # obmc_disable
        if b.read(1 if verid == 1 else 2):
            raise _unsupported("sprites (S-VOPs, GMC)")
        if b.bit():
            raise _unsupported("not_8_bit video")
        if b.bit():
            raise _unsupported("MPEG quantisation (quant_type 1)")
        if verid != 1 and b.bit():
            raise _unsupported("quarter-pel motion (quarter_sample)")
        if not b.bit():
            raise _unsupported("complexity estimation headers")
        if not b.bit():
            raise _unsupported("resync markers and video packets")
        if b.bit():
            raise _unsupported("data partitioning")
        if verid != 1:
            if b.bit():
                raise _unsupported("newpred")
            if b.bit():
                raise _unsupported("reduced resolution VOPs")
        if b.bit():
            raise _unsupported("scalability")
        if not self.low_delay:
            raise _unsupported("B-VOPs (low_delay 0)")
        if self.height % 2:
            raise _unsupported(f"an odd height ({self.height})")
        if b.pos > b.end:
            raise ValueError("corrupt MPEG-4 VOL: truncated")
        self.mb_w = (self.width + 15) // 16
        self.mb_h = (self.height + 15) // 16


def _user_data_build(text: bytes) -> Optional[Tuple[str, int]]:
    """The encoder a user data string names, as libavcodec reads it."""
    s = text.split(b"\0")[0].decode("latin-1")
    m = re.match(r"DivX(\d+)(?:Build|b)(\d+)", s)
    if m:
        return "divx", int(m.group(1))
    m = re.match(r"Lavc(\d+)\.(\d+)\.(\d+)", s)
    if m:
        return "lavc", (int(m.group(1)) << 16) + (int(m.group(2)) << 8) + int(m.group(3))
    m = re.match(r"FFmpe[^b]*b(\d+)", s) or re.match(r"FFmpeg v\d+\.\d+\.\d+ / libavcodec build: (\d+)", s)
    if m:
        return "lavc", int(m.group(1))
    if s == "ffmpeg":
        return "lavc", 4600
    m = re.match(r"XviD(\d+)", s)
    if m:
        return "xvid", int(m.group(1))
    return None


def _refuse_short_header(data: bytes) -> None:
    """The short (H.263) video header starts with 22 bits 0000 0000 0000 0000 1000 00."""
    if len(data) >= 3 and data[0] == 0 and data[1] == 0 and data[2] & 0xFC == 0x80:
        raise _unsupported("the short (H.263) video header")


def check_encoder(kind: Optional[Tuple[str, int]], fourcc: str) -> None:
    """Refuse a stream that libavcodec decodes with another IDCT or its bug
    workarounds, by the encoder its user data names (`kind`, None if none
    did) and the container's codec tag, which libavcodec upper-cases."""
    if kind is None and fourcc.upper() in XVID_FOURCCS:
        raise _unsupported(f"a stream under the Xvid fourcc {fourcc!r} without Lavc user data (Xvid's IDCT)")
    if kind is not None and kind[0] in ("xvid", "divx"):
        raise _unsupported(f"a stream whose user data names {kind[0]} (its IDCT and bug workarounds)")
    if kind is not None and (kind[1] <= 4712 or ((kind[1] & 0xFF) >= 100 and 3621476 < kind[1] < 3752552
                                                  and not 3752037 <= kind[1] <= 3752191)):
        raise _unsupported(f"a stream of an old libavcodec build ({kind[1]}) with its bug workarounds")


def find_vol(*sources: bytes, fourcc: str = "") -> Vol:
    """The first video object layer header in `sources` (a container's
    configuration, a first packet): raises ValueError if there is none, and
    `check_encoder`'s refusal on the user data before the first VOP."""
    vol, kind = None, None
    for data in sources:
        _refuse_short_header(data)
        for code, start, end in start_codes(data):
            if VOL_FIRST <= code <= VOL_LAST and vol is None:
                vol = Vol(data[start:end])
            elif code == USER_DATA:
                kind = _user_data_build(data[start:end]) or kind
            elif code == VOP_START:
                break
    if vol is None:
        raise ValueError("corrupt MPEG-4 stream: no video object layer header")
    check_encoder(kind, fourcc)
    return vol


XVID_FOURCCS = ("XVID", "XVIX", "RMP4", "ZMP4", "SIPP")
# AVI and VFW codec tags read as MPEG-4 Part 2 (those OpenCV's FFmpeg writer uses, and their kin)
MPEG4_FOURCCS = (b"XVID", b"FMP4", b"DIVX", b"DX50", b"mp4v", b"MP4V", b"xvid", b"divx")


# ---------------------------------------------------------------- the IDCT

_W1, _W2, _W3, _W4, _W5, _W6, _W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520


def _idct_1d(x, shift: int, rounding, col: bool):
    """One pass of libavcodec's simple IDCT over the last axis of x, in int32
    arithmetic that wraps as libavcodec's 32-bit sums do."""
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., k] for k in range(8))
    a0 = _W4 * (x0 + 32) if col else _W4 * x0 + rounding
    a1, a2, a3 = a0 + _W6 * x2, a0 - _W6 * x2, a0 - _W2 * x2
    a0 = a0 + _W2 * x2
    b0 = _W1 * x1 + _W3 * x3 + _W5 * x5 + _W7 * x7
    b1 = _W3 * x1 - _W7 * x3 - _W1 * x5 - _W5 * x7
    b2 = _W5 * x1 - _W1 * x3 + _W7 * x5 + _W3 * x7
    b3 = _W7 * x1 - _W5 * x3 + _W3 * x5 - _W1 * x7
    e4, e6 = _W4 * x4, (_W6 * x6, _W2 * x6)
    a0, a1, a2, a3 = a0 + e4 + e6[0], a1 - e4 - e6[1], a2 - e4 + e6[1], a3 + e4 - e6[0]
    return np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0], -1) >> shift


def simple_idct(blocks: np.ndarray) -> np.ndarray:
    """libavcodec's 8-bit simple IDCT of (..., 8, 8) dequantised coefficients
    (rows then columns): (..., 8, 8) int32, before the clip to pixels."""
    x = blocks.astype(np.int16).astype(np.int32)  # libavcodec's blocks are int16
    with np.errstate(over="ignore"):
        rows = _idct_1d(x, 11, 1 << 10, col=False)
        dc_only = ~np.any(x[..., 1:] != 0, axis=-1, keepdims=True)
        rows = np.where(dc_only, x[..., :1] * 8, rows)
        rows = rows.astype(np.int16).astype(np.int32)  # the row pass stores int16
        cols = _idct_1d(np.swapaxes(rows, -1, -2), 20, 0, col=True)
    return np.ascontiguousarray(np.swapaxes(cols, -1, -2))


# ---------------------------------------------------------------- colour

_R16 = lambda c: (c * 8192 + 0x8000) >> 16  # noqa: E731 -- swscale's roundToInt16(coeff << 13)
_Y_COEFF, _VR, _UB, _UG, _VG = _R16(76309), _R16(104597), _R16(132201), _R16(-25675), _R16(-53279)
_Y_OFFSET = ((16 << 16) * 8 + 0x8000) >> 16


def yuv420_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """swscale's YUV 4:2:0 to BGR24 (BT.601, limited range) as OpenCV's FFmpeg
    backend gets it: each term a 16-bit product's high half, each chroma
    sample on 2x2 pixels. (h, w) luma, (h/2, ceil(w/2)) chroma -> (h, w, 3)."""
    h, w = y.shape
    uu = np.repeat(np.repeat(u.astype(np.int32) * 8 - 1024, 2, 0), 2, 1)[:h, :w]
    vv = np.repeat(np.repeat(v.astype(np.int32) * 8 - 1024, 2, 0), 2, 1)[:h, :w]
    yy = ((y.astype(np.int32) * 8 - _Y_OFFSET) * _Y_COEFF) >> 16
    out = np.empty((h, w, 3), np.uint8)
    np.clip(yy + ((uu * _UB) >> 16), 0, 255, out=out[..., 0], casting="unsafe")
    np.clip(yy + ((uu * _UG) >> 16) + ((vv * _VG) >> 16), 0, 255, out=out[..., 1], casting="unsafe")
    np.clip(yy + ((vv * _VR) >> 16), 0, 255, out=out[..., 2], casting="unsafe")
    return out


# ---------------------------------------------------------------- the decoder


class Mpeg4Decoder:
    """Decode MPEG-4 Part 2 Simple Profile packets (one VOP each, with any
    headers before it) to BGR frames. `config` is the container's decoder
    configuration (the VOL), `fourcc` the container's codec tag."""

    def __init__(self, config: bytes = b"", fourcc: str = ""):
        self.vol: Optional[Vol] = None
        self.fourcc = fourcc
        self.encoder: Optional[Tuple[str, int]] = None
        self.counts: Counter = Counter()
        self._ref: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        if config:
            self.decode(config)
            if self.vol is None:
                raise ValueError("corrupt MPEG-4 decoder configuration: no video object layer header")

    def decode(self, packet: bytes) -> Optional[np.ndarray]:
        """Parse one packet; the decoded BGR frame if it held a VOP, else None."""
        _refuse_short_header(packet)
        frame = None
        for code, start, end in start_codes(packet):
            if VOL_FIRST <= code <= VOL_LAST:
                vol = Vol(packet[start:end])
                if self.vol is None or (vol.width, vol.height) != (self.vol.width, self.vol.height):
                    self._ref = None  # a new frame size: a P-VOP must wait for an I-VOP
                self.vol = vol
            elif code == USER_DATA:
                found = _user_data_build(packet[start:end])
                if found is not None:
                    self.encoder = found
            elif code == VOP_START:
                if frame is not None:
                    raise _unsupported("a packet with more than one VOP (packed B-frames)")
                frame = self._vop(packet[start:end])
        return frame

    def _vop(self, data: bytes):
        vol = self.vol
        if vol is None:
            raise ValueError("corrupt MPEG-4 stream: a VOP before any video object layer header")
        check_encoder(self.encoder, self.fourcc)
        b = _Bits(data)
        kind = b.read(2)
        if kind == 2:
            raise _unsupported("a B-VOP")
        if kind == 3:
            raise _unsupported("an S-VOP (sprite, GMC)")
        while b.bit():  # modulo_time_base
            if b.left() <= 0:
                raise ValueError("corrupt MPEG-4 VOP: truncated header")
        b.marker("before vop_time_increment")
        b.read(vol.time_bits)
        b.marker("after vop_time_increment")
        if not b.bit():
            raise _unsupported("a not-coded VOP")
        rounding = b.bit() if kind == 1 else 0
        dc_thr = _DC_THRESHOLD[b.read(3)]
        q = b.read(5)
        if q == 0:
            raise ValueError("corrupt MPEG-4 VOP: vop_quant 0")
        fcode = b.read(3) if kind == 1 else 1
        if fcode == 0:
            raise ValueError("corrupt MPEG-4 VOP: vop_fcode_forward 0")
        if b.left() < 0:
            raise ValueError("corrupt MPEG-4 VOP: truncated header")
        if kind == 1 and self._ref is None:
            raise ValueError("corrupt MPEG-4 stream: a P-VOP before any I-VOP")
        self.counts["p_vop" if kind else "i_vop"] += 1
        if kind:
            self.counts[f"rounding_{rounding}"] += 1
            self.counts[f"fcode_{fcode}"] += 1
        planes = self._macroblocks(b, kind, q, dc_thr, fcode, rounding)
        self._ref = planes
        y, u, v = planes
        h, w = vol.height, vol.width
        return yuv420_to_bgr(y[:h, :w], u[:h // 2, :(w + 1) // 2], v[:h // 2, :(w + 1) // 2])

    def _macroblocks(self, b: _Bits, p_vop: int, q: int, dc_thr: int, fcode: int, rounding: int):
        vol = self.vol
        mb_w, mb_h = vol.mb_w, vol.mb_h
        n_mb = mb_w * mb_h
        counts = self.counts
        levels = np.zeros((n_mb, 6, 64), np.int32)
        flat = levels.reshape(-1)
        idx: List[int] = []  # inter coefficients: flat index and level
        val: List[int] = []
        intra_at: List[int] = []  # intra blocks: block index and the 64 levels
        intra_rows: List[List[int]] = []
        mb_kind = bytearray(n_mb)  # 0 skipped, 1 inter, 2 intra
        coded = np.zeros((n_mb, 6), bool)
        mvs = np.zeros((mb_h + 1, mb_w + 2, 2), np.int64)  # a zero border: row 0, columns 0 and mb_w + 1
        mv_list = [[0, 0]] * n_mb
        # DC and AC predictors per 8x8 block in a (rows + 1, cols + 1) grid
        # whose row 0 and column 0 are outside the VOP
        lw, cw = 2 * mb_w + 1, mb_w + 1
        dc = [[1024] * (lw * (2 * mb_h + 1)), [1024] * (cw * (mb_h + 1)), [1024] * (cw * (mb_h + 1))]
        zero7 = [0] * 7
        ac_left = [[zero7] * len(dc[0]), [zero7] * len(dc[1]), [zero7] * len(dc[2])]
        ac_top = [[zero7] * len(dc[0]), [zero7] * len(dc[1]), [zero7] * len(dc[2])]
        y_scale, c_scale = _dc_scaler(q, True), _dc_scaler(q, False)
        use_dc_vlc = q < dc_thr
        qmul, qadd = 2 * q, (q - 1) | 1
        peek, read, bit = b.peek, b.read, b.bit
        lut_cbpy, lut_intra_mcbpc, lut_inter_mcbpc = _LUT_CBPY, _LUT_INTRA_MCBPC, _LUT_INTER_MCBPC
        mvd_range = 1 << (4 + fcode)
        for mb in range(n_mb):
            mby, mbx = divmod(mb, mb_w)
            if b.pos >= b.end:
                raise ValueError(f"corrupt MPEG-4 VOP: truncated at macroblock {mb} of {n_mb}")
            if p_vop:
                while True:
                    if bit():
                        hit = None
                        break
                    hit = lut_inter_mcbpc[peek(9)]
                    if hit is None:
                        raise ValueError(f"corrupt MPEG-4 VOP: bad MCBPC at macroblock {mb}")
                    b.pos += hit[1]
                    if hit[0] != 20:
                        break
                if hit is None:
                    counts["skipped_mb"] += 1
                    continue
                cbpc = hit[0]
                if cbpc & 16:
                    raise _unsupported("a 4MV (inter4v) macroblock")
                intra = cbpc & 4
            else:
                while True:
                    hit = lut_intra_mcbpc[peek(9)]
                    if hit is None:
                        raise ValueError(f"corrupt MPEG-4 VOP: bad MCBPC at macroblock {mb}")
                    b.pos += hit[1]
                    if hit[0] != 8:
                        break
                cbpc = hit[0] << 1 & 8 | hit[0] & 3  # the dquant flag where the inter table has it
                intra = 4
            if cbpc & 8:
                raise _unsupported("dquant (a macroblock quantiser change)")
            if intra:
                ac_pred = bit()
            hit = lut_cbpy[peek(6)]
            if hit is None:
                raise ValueError(f"corrupt MPEG-4 VOP: bad CBPY at macroblock {mb}")
            b.pos += hit[1]
            cbp = (hit[0] if intra else 15 - hit[0]) << 2 | cbpc & 3
            if not intra:
                mb_kind[mb] = 1
                counts["inter_mb"] += 1
                # median prediction: left, above, above right; a zero border stands outside
                if mby == 0:
                    px, py = (mvs[1, mbx] if mbx else (0, 0))  # row 1 holds mb row 0
                    px, py = int(px), int(py)
                else:
                    a, bb, c = mvs[mby + 1, mbx], mvs[mby, mbx + 1], mvs[mby, mbx + 2]
                    px = int(sorted((a[0], bb[0], c[0]))[1])
                    py = int(sorted((a[1], bb[1], c[1]))[1])
                mv = []
                for pred in (px, py):
                    hit = _LUT_MVD[peek(12)]
                    if hit is None:
                        raise ValueError(f"corrupt MPEG-4 VOP: bad MVD at macroblock {mb}")
                    b.pos += hit[1]
                    code = hit[0]
                    if code:
                        sign = bit()
                        if fcode > 1:
                            code = ((code - 1) << (fcode - 1) | read(fcode - 1)) + 1
                        pred += -code if sign else code
                        # wrap into [-16 << fcode... ) as libavcodec's sign_extend(val, 5 + fcode)
                        pred = (pred + mvd_range) % (2 * mvd_range) - mvd_range
                    mv.append(pred)
                mvs[mby + 1, mbx + 1] = mv
                mv_list[mb] = mv
                for n in range(6):
                    if cbp & (32 >> n):
                        coded[mb, n] = True
                        base = (mb * 6 + n) * 64
                        self._tcoef(b, _LUT_INTER, _MAX_INTER, -1, _ZIGZAG, base, idx, val, None)
                continue
            # intra
            mb_kind[mb] = 2
            counts["intra_mb_in_p" if p_vop else "intra_mb"] += 1
            if ac_pred:
                counts["ac_pred_mb"] += 1
            for n in range(6):
                if n < 4:
                    plane, gw = 0, lw
                    at = (2 * mby + (n >> 1) + 1) * gw + 2 * mbx + (n & 1) + 1
                    scale = y_scale
                else:
                    plane, gw = n - 3, cw
                    at = (mby + 1) * gw + mbx + 1
                    scale = c_scale
                dcp = dc[plane]
                a, bb, c = dcp[at - 1], dcp[at - 1 - gw], dcp[at - gw]
                top = abs(a - bb) < abs(bb - c)  # predict from above, else from the left
                pred = ((c if top else a) + (scale >> 1)) // scale
                block = [0] * 64
                first = 0
                if use_dc_vlc:
                    hit = _LUT_DC[n >= 4][peek(12)]
                    if hit is None:
                        raise ValueError(f"corrupt MPEG-4 VOP: bad DC size at macroblock {mb}")
                    b.pos += hit[1]
                    size = hit[0]
                    if size:
                        diff = read(size)
                        if not diff >> (size - 1):
                            diff -= (1 << size) - 1
                        if size > 8:
                            b.marker("after a DC coefficient")
                        block[0] = diff
                    first = 1
                else:
                    counts["dc_as_ac"] += 1
                if ac_pred:
                    scan = _ALT_H if top else _ALT_V
                    counts["scan_horizontal" if top else "scan_vertical"] += 1
                else:
                    scan = _ZIGZAG
                    counts["scan_zigzag"] += 1
                if cbp & (32 >> n):
                    self._tcoef(b, _LUT_INTRA, _MAX_INTRA, first - 1, scan, 0, None, None, block)
                level = block[0] + pred
                dc_val = level * scale
                dcp[at] = 0 if dc_val < 0 else 2047 if dc_val > 2047 else dc_val
                block[0] = level
                if ac_pred:
                    if top:
                        src = ac_top[plane][at - gw]
                        for k in range(7):
                            block[k + 1] += src[k]
                    else:
                        src = ac_left[plane][at - 1]
                        for k in range(7):
                            block[8 * k + 8] += src[k]
                ac_top[plane][at] = block[1:8]
                ac_left[plane][at] = block[8::8]
                intra_at.append(mb * 6 + n)
                intra_rows.append(block)
            coded[mb] = True
        if b.pos > b.end:
            raise ValueError("corrupt MPEG-4 VOP: truncated")
        if idx:
            flat[np.asarray(idx, np.int64)] = val
        if intra_at:
            levels.reshape(-1, 64)[np.asarray(intra_at, np.int64)] = intra_rows
        return self._reconstruct(levels, np.frombuffer(bytes(mb_kind), np.uint8), coded, mv_list, q, qmul, qadd,
                                 y_scale, c_scale, rounding)

    def _tcoef(self, b: _Bits, lut, maxes, i: int, scan, base: int, idx, val, block) -> None:
        """One block's TCOEF events from scan position i + 1: levels into
        block (intra, quantised) or idx/val (inter, at base)."""
        counts = self.counts
        lmax, rmax = maxes
        words = b.words
        while True:
            p = b.pos
            w = (words[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
            e = lut[w >> 19]
            if e is None:
                raise ValueError("corrupt MPEG-4 VOP: bad TCOEF code")
            length, last, run, level = e
            if level:
                p += length
            else:  # escape
                mode = (w >> 23) & 3  # the two bits after the escape code
                if mode & 2 == 0:  # escape 1: level + LMAX
                    e = lut[(w >> 11) & 0x1FFF]
                    if e is None or not e[3]:
                        raise ValueError("corrupt MPEG-4 VOP: bad TCOEF escape")
                    length, last, run, level = e
                    level += lmax[last][run] if level > 0 else -lmax[last][run]
                    p += 8 + length
                    counts["escape_1"] += 1
                elif mode == 2:  # escape 2: run + RMAX + 1
                    e = lut[(w >> 10) & 0x1FFF]
                    if e is None or not e[3]:
                        raise ValueError("corrupt MPEG-4 VOP: bad TCOEF escape")
                    length, last, run, level = e
                    run += rmax[last][abs(level)] + 1
                    p += 9 + length
                    counts["escape_2"] += 1
                else:  # escape 3: last (1), run (6), marker, level (12, signed), marker
                    last = (w >> 22) & 1
                    run = (w >> 16) & 63
                    if not (w >> 15) & 1 or not (w >> 2) & 1:
                        raise ValueError("corrupt MPEG-4 VOP: marker bit missing in an escape-3 coefficient")
                    level = (w >> 3) & 0xFFF
                    if level >= 2048:
                        level -= 4096
                    if level == 0:
                        raise ValueError("corrupt MPEG-4 VOP: an escape-3 level of 0")
                    p += 30
                    counts["escape_3"] += 1
            b.pos = p
            i += run + 1
            if i > 63:
                raise ValueError("corrupt MPEG-4 VOP: more than 64 coefficients in a block")
            if block is not None:
                block[scan[i]] = level
            else:
                idx.append(base + scan[i])
                val.append(level)
            if last:
                return

    def _reconstruct(self, levels, mb_kind, coded, mv_list, q, qmul, qadd, y_scale, c_scale, rounding):
        vol = self.vol
        mb_w, mb_h = vol.mb_w, vol.mb_h
        n_mb = mb_w * mb_h
        intra = mb_kind == 2
        # H.263 inverse quantisation, saturated
        deq = np.where(levels > 0, levels * qmul + qadd, np.where(levels < 0, levels * qmul - qadd, 0))
        deq[intra, :4, 0] = levels[intra, :4, 0] * y_scale
        deq[intra, 4:, 0] = levels[intra, 4:, 0] * c_scale
        np.clip(deq, -2048, 2047, out=deq)
        work = np.nonzero(coded.any(1))[0]
        res = np.zeros((n_mb, 6, 8, 8), np.int32)
        if work.size:
            res[work] = simple_idct(deq[work].reshape(-1, 6, 8, 8))
        # motion-compensated prediction of every macroblock that is not intra
        pred_y = np.zeros((n_mb, 16, 16), np.int32)
        pred_c = np.zeros((n_mb, 2, 8, 8), np.int32)
        inter = np.nonzero(~intra)[0]
        if inter.size:
            ref_y, ref_u, ref_v = self._ref
            mv = np.asarray(mv_list, np.int64)[inter]
            mbx, mby = inter % mb_w, inter // mb_w
            mx, my = mv[:, 0], mv[:, 1]
            sx, sy = 16 * mbx + (mx >> 1), 16 * mby + (my >> 1)
            if ((sx < 0) | (sy < 0) | (sx + 16 + (mx & 1) > 16 * mb_w) | (sy + 16 + (my & 1) > 16 * mb_h)).any():
                self.counts["mv_past_edge"] += 1
            pred_y[inter] = _halfpel(ref_y, sx, sy, mx & 1, my & 1, 16, rounding)
            cdx, cdy = (mx & 1) | ((mx & 2) >> 1), (my & 1) | ((my & 2) >> 1)
            for k, ref in enumerate((ref_u, ref_v)):
                pred_c[inter, k] = _halfpel(ref, sx >> 1, sy >> 1, cdx, cdy, 8, rounding)
        # assemble: intra blocks are their IDCT, the rest prediction plus residual
        luma = res[:, :4].reshape(n_mb, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4).reshape(n_mb, 16, 16)
        y = np.clip(pred_y + luma, 0, 255).astype(np.uint8)
        c = np.clip(pred_c + res[:, 4:], 0, 255).astype(np.uint8)
        y = y.reshape(mb_h, mb_w, 16, 16).transpose(0, 2, 1, 3).reshape(16 * mb_h, 16 * mb_w)
        u = c[:, 0].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3).reshape(8 * mb_h, 8 * mb_w)
        v = c[:, 1].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3).reshape(8 * mb_h, 8 * mb_w)
        return y, u, v


def _halfpel(ref: np.ndarray, sx, sy, dx, dy, size: int, rounding: int) -> np.ndarray:
    """(n, size, size) half-pel predictions from ref at integer (sx, sy) plus
    half steps (dx, dy), the reference edge-replicated without bound."""
    h, w = ref.shape
    ys = np.clip(sy[:, None] + np.arange(size + 1), 0, h - 1)
    xs = np.clip(sx[:, None] + np.arange(size + 1), 0, w - 1)
    g = ref[ys[:, :, None], xs[:, None, :]].astype(np.int32)
    a, r, d, rd = g[:, :size, :size], g[:, :size, 1:], g[:, 1:, :size], g[:, 1:, 1:]
    dx, dy = dx[:, None, None], dy[:, None, None]
    out = np.where(dx & dy, (a + r + d + rd + 2 - rounding) >> 2,
                   np.where(dx, (a + r + 1 - rounding) >> 1, np.where(dy, (a + d + 1 - rounding) >> 1, a)))
    return out


def decode_packets(decoder: "Mpeg4Decoder", packets, rgb: bool, path):
    """Each packet's frame through `decoder`, RGB or BGR (packets without a
    VOP give none); errors name `path`."""
    for data in packets:
        try:
            bgr = decoder.decode(data)
        except (NotImplementedError, ValueError) as exc:
            raise type(exc)(f"{path}: {exc}") from exc
        if bgr is not None:
            yield np.ascontiguousarray(bgr[..., ::-1]) if rgb else bgr


class Mpeg4Track:
    """What every container's reader shares once it has found an MPEG-4
    track: `path`, `config` (the container's decoder configuration),
    `fourcc`, `width`, `height`, `fps`, `frame_count` and `packets()` come
    from the container."""

    fourcc = ""
    counts: Counter  # the last `read()`'s decoder tallies (the tests read them)

    def _vol(self) -> Vol:
        """The video object layer header: from the configuration, else the
        first packet; a stream `check_encoder` refuses raises here, before
        any frame is read."""
        try:
            return find_vol(self.config, next(self.packets(), b""), fourcc=self.fourcc)
        except (NotImplementedError, ValueError) as exc:
            raise type(exc)(f"{self.path}: {exc}") from exc

    def info(self) -> Dict[str, float]:
        """The JAX package's `get_video_info` keys."""
        return {"width": self.width, "height": self.height, "fps": self.fps, "frame_count": self.frame_count,
                "duration_s": self.frame_count / self.fps if self.fps else 0.0}

    def read(self, rgb: bool = True) -> Iterator[np.ndarray]:
        """The decoded frames: uint8 (H, W, 3), RGB (BGR with `rgb=False`)."""
        decoder = Mpeg4Decoder(self.config, self.fourcc)
        self.counts = decoder.counts
        yield from decode_packets(decoder, self.packets(), rgb, self.path)


# ---------------------------------------------------------------- the encoder


class _BitWriter:
    """Big-endian codes of up to 32 bits, kept as (code << 6 | length) and
    packed at the end (`_pack_bits`)."""

    __slots__ = ("items",)

    def __init__(self):
        self.items: List[int] = []

    def put(self, value: int, bits: int) -> None:
        self.items.append(value << 6 | bits)

    def stuffing(self) -> bytes:
        """The codes, then next_start_code(), as bytes."""
        items = np.asarray(self.items, np.int64)
        return _pack_bits(items >> 6, items & 63)


_DCT8 = np.array([[np.sqrt((1 if u else 0.5) / 4) * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                  for u in range(8)])


def bgr_to_yuv420(frame_bgr: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BT.601 limited-range Y, U, V of a BGR frame; chroma from each 2x2
    block's mean (an odd edge repeats its last row or column)."""
    h, w = frame_bgr.shape[:2]
    f = frame_bgr.astype(np.int32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16
    f = np.pad(f, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
    s = f[0::2, 0::2] + f[1::2, 0::2] + f[0::2, 1::2] + f[1::2, 1::2]
    b, g, r = s[..., 0], s[..., 1], s[..., 2]
    u = ((-38 * r - 74 * g + 112 * b + 512) >> 10) + 128
    v = ((112 * r - 94 * g - 18 * b + 512) >> 10) + 128
    return tuple(np.clip(p, 0, 255).astype(np.uint8) for p in (y, u, v))


class Mpeg4Encoder:
    """MPEG-4 Part 2 Simple Profile I-VOPs at the fixed quantiser `quant`,
    with DC prediction, and AC prediction in each macroblock where it
    lowers the sum of the predicted levels' magnitudes (it never changes
    the picture); with `dc_vlc` False the DC differences are coded as AC
    coefficients (`intra_dc_vlc_thr` 7). `headers()` is the stream's configuration (visual object sequence,
    visual object and VOL), `encode(frame_bgr)` one frame's VOP, and
    `reconstruction` the BGR frame a decoder gets back for the last one."""

    def __init__(self, width: int, height: int, fps: float = 30.0, quant: int = 2, dc_vlc: bool = True):
        if not (0 < width < 8192 and 0 < height < 8192 and height % 2 == 0):
            raise ValueError(f"MPEG-4 frames must be 1..8191 wide and an even 2..8190 high, got {width}x{height}")
        if not 1 <= quant <= 31:
            raise ValueError(f"quant must be 1..31, got {quant}")
        self.width, self.height, self.quant, self.dc_vlc = width, height, quant, dc_vlc
        self.mb_w, self.mb_h = (width + 15) // 16, (height + 15) // 16
        # the VOP clock: `resolution` ticks a second, `step` ticks a frame
        rate = Fraction(fps).limit_denominator(1001)
        if not 0 < rate:
            raise ValueError(f"fps must be positive, got {fps}")
        if rate.numerator > 65535:
            rate = Fraction(65535, max(round(65535 / fps), 1))
        self.resolution, self.step = rate.numerator, rate.denominator
        self.time_bits = max((self.resolution - 1).bit_length(), 1)
        self.frames = 0
        self._seconds = 0
        self.reconstruction: Optional[np.ndarray] = None

    def headers(self) -> bytes:
        vol = _BitWriter()
        vol.put(0, 1)  # random_accessible_vol
        vol.put(1, 8)  # simple object type
        vol.put(1, 1); vol.put(1, 4); vol.put(1, 3)  # is_object_layer_identifier, verid 1, priority 1
        vol.put(1, 4)  # square pixels
        vol.put(1, 1); vol.put(1, 2); vol.put(1, 1); vol.put(0, 1)  # control parameters: 4:2:0, low_delay, no vbv
        vol.put(0, 2)  # rectangular
        vol.put(1, 1); vol.put(self.resolution, 16); vol.put(1, 1)
        vol.put(0, 1)  # fixed_vop_rate
        vol.put(1, 1); vol.put(self.width, 13); vol.put(1, 1); vol.put(self.height, 13); vol.put(1, 1)
        vol.put(0, 1); vol.put(1, 1); vol.put(0, 1); vol.put(0, 1)  # progressive, obmc_disable, no sprite, 8-bit
        vol.put(0, 1)  # H.263 quantisation
        vol.put(1, 1); vol.put(1, 1); vol.put(0, 1)  # no complexity estimation, no resync markers, no partitions
        vol.put(0, 1)  # no scalability
        return (b"\x00\x00\x01\xb0\x01" + b"\x00\x00\x01\xb5\x89\x13" + b"\x00\x00\x01\x00"
                + b"\x00\x00\x01\x20" + vol.stuffing())

    def encode(self, frame_bgr: np.ndarray) -> bytes:
        """One frame (uint8 (height, width, 3) BGR) as an I-VOP."""
        frame = np.asarray(frame_bgr)
        if frame.shape != (self.height, self.width, 3) or frame.dtype != np.uint8:
            raise ValueError(f"a frame of {frame.shape} {frame.dtype}; the encoder takes uint8 "
                             f"({self.height}, {self.width}, 3) BGR")
        q, mb_w, mb_h = self.quant, self.mb_w, self.mb_h
        planes = []
        for p, size in zip(bgr_to_yuv420(frame), (16, 8, 8)):
            ph, pw = size * mb_h - p.shape[0], size * mb_w - p.shape[1]
            planes.append(np.pad(p, ((0, ph), (0, pw)), mode="edge"))
        y, u, v = planes
        # (mb, 6, 8, 8) pixel blocks in macroblock order
        luma = y.reshape(mb_h, 2, 8, mb_w, 2, 8).transpose(0, 3, 1, 4, 2, 5).reshape(-1, 4, 8, 8)
        chroma = [c.reshape(mb_h, 8, mb_w, 8).transpose(0, 2, 1, 3).reshape(-1, 1, 8, 8) for c in (u, v)]
        blocks = np.concatenate([luma] + chroma, 1).astype(np.float64)
        coef = _DCT8 @ blocks @ _DCT8.T
        levels = self._quantise(coef)
        # the reconstruction is the decoder's: dequantise, IDCT, clip, convert
        deq = np.where(levels > 0, levels * 2 * q + ((q - 1) | 1), np.where(levels < 0, levels * 2 * q - ((q - 1) | 1), 0))
        deq[:, :4, 0, 0] = levels[:, :4, 0, 0] * _dc_scaler(q, True)
        deq[:, 4:, 0, 0] = levels[:, 4:, 0, 0] * _dc_scaler(q, False)
        pix = np.clip(simple_idct(np.clip(deq, -2048, 2047)), 0, 255).astype(np.uint8)
        ry = pix[:, :4].reshape(mb_h, mb_w, 2, 2, 8, 8).transpose(0, 2, 4, 1, 3, 5).reshape(16 * mb_h, 16 * mb_w)
        ru, rv = (pix[:, k].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3).reshape(8 * mb_h, 8 * mb_w)
                  for k in (4, 5))
        h, w = self.height, self.width
        self.reconstruction = yuv420_to_bgr(ry[:h, :w], ru[:h // 2, :(w + 1) // 2], rv[:h // 2, :(w + 1) // 2])
        return self._vop(levels.reshape(-1, 6, 64))

    def _quantise(self, coef: np.ndarray) -> np.ndarray:
        """Levels whose H.263 reconstruction is nearest each coefficient; the
        DC by its scaler (kept in 1..254)."""
        q = self.quant
        qadd = (q - 1) | 1
        mag = np.abs(coef)
        level = np.maximum(np.floor((mag - qadd) / (2 * q) + 0.5), 1)
        level = np.where(mag < (2 * q + qadd) / 2, 0, np.minimum(level, (2047 - qadd) // (2 * q)))
        level = (np.sign(coef) * level).astype(np.int64)
        for blocks, scale in ((slice(0, 4), _dc_scaler(q, True)), (slice(4, 6), _dc_scaler(q, False))):
            level[:, blocks, 0, 0] = np.clip(np.floor(coef[:, blocks, 0, 0] / scale + 0.5), 1, min(254, 2047 // scale))
        return level

    def _vop(self, levels: np.ndarray) -> bytes:
        """The I-VOP of (mb, 6, 64) raster levels: every predictor of an
        I-VOP is known before it is coded, so each code is computed at once."""
        q, mb_w, mb_h = self.quant, self.mb_w, self.mb_h
        n_mb = mb_w * mb_h
        scale = np.array([_dc_scaler(q, True)] * 4 + [_dc_scaler(q, False)] * 2)
        # each block on its plane's grid, with a row and a column outside the VOP (DC 1024, AC 0)
        grids = []
        for blocks, rows, cols in ((slice(0, 4), 2 * mb_h, 2 * mb_w), (slice(4, 5), mb_h, mb_w),
                                   (slice(5, 6), mb_h, mb_w)):
            blk = levels[:, blocks].reshape(mb_h, mb_w, -1, 64)
            if rows != mb_h:
                blk = blk.reshape(mb_h, mb_w, 2, 2, 64).transpose(0, 2, 1, 3, 4)
            g = np.zeros((rows + 1, cols + 1, 64), np.int64)
            g[1:, 1:] = blk.reshape(rows, cols, 64)
            grids.append(g)
        dc_val = [np.clip(g[..., 0] * s_, 0, 2047) for g, s_ in zip(grids, (scale[0], scale[4], scale[4]))]
        for d in dc_val:
            d[0, :] = d[:, 0] = 1024
        # per block (mb, n): the prediction direction, DC predictor and AC predictors
        top = np.empty((n_mb, 6), bool)
        pred_dc = np.empty((n_mb, 6), np.int64)
        pred_ac = np.empty((n_mb, 6, 7), np.int64)
        own_ac = np.empty((n_mb, 6, 7), np.int64)
        for plane, (g, d) in enumerate(zip(grids, dc_val)):
            a, b, c = d[1:, :-1], d[:-1, :-1], d[:-1, 1:]
            t = np.abs(a - b) < np.abs(b - c)
            p = np.where(t, c, a)
            from_top, from_left, own = g[:-1, 1:, 1:8], g[1:, :-1, 8::8], g[1:, 1:]
            ac = np.where(t[..., None], from_top, from_left)
            mine = np.where(t[..., None], own[..., 1:8], own[..., 8::8])
            if plane == 0:
                back = lambda x: x.reshape(mb_h, 2, mb_w, 2, *x.shape[2:]).swapaxes(1, 2).reshape(  # noqa: E731
                    n_mb, 4, *x.shape[2:])
                top[:, :4], pred_dc[:, :4], pred_ac[:, :4], own_ac[:, :4] = back(t), back(p), back(ac), back(mine)
            else:
                n = 3 + plane
                top[:, n], pred_dc[:, n] = t.reshape(-1), p.reshape(-1)
                pred_ac[:, n], own_ac[:, n] = ac.reshape(-1, 7), mine.reshape(-1, 7)
        pred_dc = (pred_dc + (scale >> 1)) // scale
        # AC prediction where it lowers the sum of the first rows' and columns' magnitudes
        coded = levels.copy()
        diff = own_ac - pred_ac
        use_ac = (np.abs(own_ac) - np.abs(diff)).sum((1, 2)) > 0
        rows, cols = np.nonzero(use_ac[:, None] & top)
        coded[rows, cols, 1:8] = diff[rows, cols]
        rows, cols = np.nonzero(use_ac[:, None] & ~top)
        coded[rows, cols, 8::8] = diff[rows, cols]
        dc_diff = levels[:, :, 0] - pred_dc
        coded[:, :, 0] = 0 if self.dc_vlc else dc_diff
        scan = np.where(use_ac[:, None], np.where(top, 1, 2), 0)
        scanned = np.take_along_axis(coded, _SCANS[scan], axis=2).reshape(-1, 64)
        # the TCOEF events: (block, scan position, level) in coding order
        blk, pos = np.nonzero(scanned)
        level = scanned[blk, pos]
        first = np.r_[True, blk[1:] != blk[:-1]]
        last = np.r_[blk[1:] != blk[:-1], True].astype(np.int64)
        run = pos - np.where(first, 0 if self.dc_vlc else -1, np.r_[0, pos[:-1]]) - 1
        ev_code, ev_len = _tcoef_codes(last, run, level)
        ev_rank = np.arange(len(blk)) - np.maximum.accumulate(np.where(first, np.arange(len(blk)), 0))
        has_events = np.zeros(n_mb * 6, bool)
        has_events[blk] = True
        cbp = (has_events.reshape(n_mb, 6) * (32 >> np.arange(6))).sum(1)
        # the macroblock header: MCBPC, ac_pred_flag, CBPY
        mc_code, mc_len = _INTRA_MCBPC_CODE[cbp & 3], _INTRA_MCBPC_LEN[cbp & 3]
        cy_code, cy_len = _CBPY_CODE[cbp >> 2], _CBPY_LEN[cbp >> 2]
        head_code = (mc_code << (1 + cy_len)) | (use_ac.astype(np.int64) << cy_len) | cy_code
        head_len = mc_len + 1 + cy_len
        parts = [(head_code, head_len, np.arange(n_mb) * 6 * 128)]
        if self.dc_vlc:  # dct_dc_size, the difference and a marker past size 8
            d = dc_diff.reshape(-1)
            size = (np.abs(d)[:, None] >= (1 << np.arange(12))).sum(1)
            chroma = np.tile(np.arange(6) >= 4, n_mb)
            sz_code = np.where(chroma, _DC_CHROM_CODE[size], _DC_LUM_CODE[size])
            sz_len = np.where(chroma, _DC_CHROM_LEN[size], _DC_LUM_LEN[size])
            value = np.where(d > 0, d, d + (1 << size) - 1)
            marker = size > 8
            dc_code = (((sz_code << size) | value) << marker) | marker
            parts.append((dc_code, sz_len + size + marker, np.arange(n_mb * 6) * 128 + 1))
        parts.append((ev_code, ev_len, blk * 128 + 2 + ev_rank))
        code, length, key = (np.concatenate(x) for x in zip(*parts))
        order = np.argsort(key, kind="stable")
        # the VOP header
        seconds, increment = divmod(self.frames * self.step, self.resolution)
        self.frames += 1
        hw = _BitWriter()
        hw.put(0, 2)  # I-VOP
        for _ in range(seconds - self._seconds):  # modulo_time_base: the seconds since the last VOP
            hw.put(1, 1)
        self._seconds = seconds
        hw.put(0, 1); hw.put(1, 1); hw.put(increment, self.time_bits); hw.put(1, 1)
        hw.put(1, 1)  # vop_coded
        hw.put(0 if self.dc_vlc else 7, 3)  # intra_dc_vlc_thr: 0, the DC has its own VLC; 7, it never has
        hw.put(q, 5)
        head = np.asarray(hw.items, np.int64)
        return b"\x00\x00\x01\xb6" + _pack_bits(np.r_[head >> 6, code[order]], np.r_[head & 63, length[order]])


def _table(pairs):
    return np.array([c for c, _ in pairs], np.int64), np.array([n for _, n in pairs], np.int64)


_SCANS = np.array([_ZIGZAG, _ALT_H, _ALT_V])
_INTRA_MCBPC_CODE, _INTRA_MCBPC_LEN = _table(_INTRA_MCBPC[:4])
_CBPY_CODE, _CBPY_LEN = _table(_CBPY)
_DC_LUM_CODE, _DC_LUM_LEN = _table(_DC_LUM)
_DC_CHROM_CODE, _DC_CHROM_LEN = _table(_DC_CHROM)
_TOP_LEVEL = max(_INTRA_LEVEL) + 1  # levels at or past it have no code of their own
# intra TCOEF codes by (last, run, level) (length 0: none), LMAX by (last, run), RMAX by (last, level)
_TC_CODE = np.zeros((2, 64, _TOP_LEVEL + 1), np.int64)
_TC_LEN = np.zeros((2, 64, _TOP_LEVEL + 1), np.int64)
_LMAX = np.zeros((2, 64), np.int64)
_RMAX = np.full((2, _TOP_LEVEL + 1), -1, np.int64)
for _i, ((_c, _n), _r, _l) in enumerate(zip(_INTRA_VLC, _INTRA_RUN, _INTRA_LEVEL)):
    _last = int(_i >= _INTRA_LAST)
    _TC_CODE[_last, _r, _l], _TC_LEN[_last, _r, _l] = _c, _n
    _LMAX[_last, _r] = max(_LMAX[_last, _r], _l)
    _RMAX[_last, _l] = max(_RMAX[_last, _l], _r)


def _tcoef_codes(last, run, level):
    """(code, length) of intra TCOEF events: the table's code, else escape 1
    (level - LMAX), escape 2 (run - RMAX - 1), else escape 3."""
    mag, sign = np.abs(level), (level < 0).astype(np.int64)
    capped = np.minimum(mag, _TOP_LEVEL)
    n0 = _TC_LEN[last, run, capped]
    mag1 = np.clip(mag - _LMAX[last, run], 0, _TOP_LEVEL)
    n1 = np.where(_LMAX[last, run] > 0, _TC_LEN[last, run, mag1], 0)
    run2 = np.clip(run - _RMAX[last, capped] - 1, 0, 63)
    n2 = np.where((_RMAX[last, capped] >= 0) & (run - _RMAX[last, capped] - 1 >= 0), _TC_LEN[last, run2, capped], 0)
    esc = _ESCAPE[0]
    code = np.where(n0 > 0, _TC_CODE[last, run, capped] << 1 | sign,
                    np.where(n1 > 0, (esc << 1) << (n1 + 1) | _TC_CODE[last, run, mag1] << 1 | sign,
                             np.where(n2 > 0, (esc << 2 | 2) << (n2 + 1) | _TC_CODE[last, run2, capped] << 1 | sign,
                                      (esc << 2 | 3) << 21 | last << 20 | run << 14 | 1 << 13
                                      | (level & 0xFFF) << 1 | 1)))
    length = np.where(n0 > 0, n0 + 1, np.where(n1 > 0, n1 + 9, np.where(n2 > 0, n2 + 10, 30)))
    return code, length


def _pack_bits(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Big-endian codes (each at most 32 bits) and next_start_code() (a 0,
    then 1s to the byte boundary) as bytes."""
    codes, lengths = np.asarray(codes, np.int64), np.asarray(lengths, np.int64)
    pad = 8 - int(lengths.sum()) % 8
    codes, lengths = np.r_[codes, (1 << (pad - 1)) - 1], np.r_[lengths, pad]
    starts = np.cumsum(lengths) - lengths
    total = int(lengths[-1] + starts[-1])
    shift = np.repeat(lengths, lengths) - 1 - (np.arange(total) - np.repeat(starts, lengths))
    return np.packbits((np.repeat(codes, lengths) >> shift) & 1).tobytes()
