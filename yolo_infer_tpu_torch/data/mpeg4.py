"""MPEG-4 Part 2 (ISO/IEC 14496-2) Simple and Advanced Simple Profile video in numpy: a decoder and an intra-only encoder.

The JAX package reads and writes video through OpenCV, whose FFmpeg
backend writes `.mp4`, `.mov`, `.mkv` and, under the fourccs `XVID`,
`FMP4` and `DIVX`, `.avi` files as MPEG-4 Part 2 Simple Profile ("mp4v"),
and reads the Advanced Simple Profile streams of libavcodec's `mpeg4`
encoder, of Xvid (most Xvid AVIs), of DivX (packed B-frames) and of old
libavcodec builds (FFmpeg and OpenCV files of 2002-2017). `Mpeg4Decoder`
decodes those streams to the frames OpenCV returns for them, bit for bit:
libavcodec's MPEG-4 decoder followed by swscale's conversion to BGR. The
containers are `data/mp4.py`, `data/mkv.py` and `data/avi.py`; H.263
(`data/h263.py`) reuses this decoder's macroblock machinery.

Decoded, as far as those streams reach:

  headers      visual object sequence, visual object, video object layer
               (VOL), group of VOPs and user data; a VOL may come from the
               container (`config`) or in band, and is parsed again each
               time it recurs; MPEG quantisation's default and loaded
               matrices (zigzag order, a 0 ending the list early)
  VOPs         I-, P- and B-VOPs; with `low_delay` 0 the output is in
               display order, one reference held back until the next
               arrives and flushed at the end of the stream, as libavcodec
               and OpenCV's drain give it; a not-coded VOP gives no frame
               (a last one makes the flush give the latest reference, again
               in a low-delay stream); a B-VOP without a past reference or
               out of order is dropped; only a packet's first VOP is
               decoded, except under DivX's packed B-frames (below)
  macroblocks  intra, inter (one vector or four: 4MV) and skipped
               macroblocks in P-VOPs, dquant in I- and P-VOPs (the DC
               scaler following the running quantiser); B macroblocks
               (`modb`, the four B types, `dbquant`): forward, backward and
               interpolated prediction with their own vector predictors
               reset at each macroblock row, and direct mode (TRB and TRD
               from `modulo_time_base` and `vop_time_increment`, the
               co-located macroblock's one or four vectors, the delta
               vector); a B macroblock whose co-located one was skipped is
               a copy of the past reference
  packets      resync markers (their length by `vop_fcode_forward`, and
               `vop_fcode_backward` in B-VOPs), `macroblock_number`,
               `quant_scale` and the header extension; across a packet
               boundary DC, AC and vector prediction treat the other
               packet's macroblocks as unavailable (libavcodec's first-row
               rules); data partitioning of I- and P-VOPs (the DC and
               motion markers)
  entropy      the MCBPC, CBPY, MVD and DC-size VLCs; the intra and inter
               TCOEF VLCs with escape modes 1 and 2 (the LMAX and RMAX
               tables) and 3 (fixed length, with its marker bits)
  texture      DC prediction by the gradient rule with the `dc_scaler`
               tables, AC prediction with the alternate horizontal and
               vertical scans rescaled between quantisers, `intra_dc_vlc_thr`
               (DC coded as an AC coefficient past it); H.263 inverse
               quantisation (an inter level an escape 3 codes saturated to
               12 bits) or MPEG's (by the matrices; mismatch control on
               inter blocks, none on intra, as libavcodec without its
               bit-exact flag); libavcodec's "simple" integer IDCT, or
               Xvid's (`xvid_idct`) for the streams libavcodec gives it
  motion       median prediction with the edge rules, the MVD range wrap
               of the vector's fcode (1 to 7), half-pel and quarter-pel
               interpolation under `vop_rounding_type` (`data/mpeg4_motion.py`:
               MPEG-4's 8-tap filter mirrored at the 16x16 or 8x8 block's
               edge, libavcodec's chroma rules), unrestricted vectors over an
               edge-replicated reference, libavcodec's clip of 8x8 blocks;
               B interpolation the rounded mean of the two predictions
  encoders     `workarounds` is libavcodec's `ff_mpeg4_workaround_bugs`:
               Xvid user data, or an Xvid fourcc in any letter case with no
               encoder user data (read as build 0), selects Xvid's IDCT and,
               by build, its workarounds (`XVID_WORKAROUNDS`); DivX user
               data (`DivX503b1393p`, `DivX609Build1896p`) or a `DIVX` tag
               over an object type 0 VOL without control parameters (DivX
               4) the quarter-pel chroma roundings 1 and 2 (DivX 5.00-5.02,
               5.03+ before build 1814) and the picture's own edge (DivX 4);
               old libavcodec builds (`LAVC_WORKAROUNDS`: `FFmpeg...b4600`,
               `ffmpeg`, `FFmpeg v... / libavcodec build: N`) the old
               quarter-pel filters (before 4653, `data/mpeg4_motion.py`),
               the picture's own edge (before 4670), the unclipped DC
               predictor (to 4712); Xvid named beside DivX wins. Taken and
               tallied without changing a frame here (`_INERT_WORKAROUNDS`):
               half-pel chroma (field prediction only), the direct block
               size (libavcodec reads it from the caller's flags, not the
               detected ones) and Lavc 55.66.100-57.66.103's intra edge;
               libavcodec's padding-bug score (Xvid to build 3, DivX 5.01
               build 20020416) changes no frame of a well-formed stream and
               is not kept. Workarounds stay once taken, as in libavcodec
  packing      DivX's packed B-frames (a 'p' after the DivX build): after a
               packet's first VOP, a following I- or B-VOP is kept and
               decoded in place of the next packet (DivX's placeholder
               N-VOP), as libavcodec does; without the 'p' the rest of a
               packet is dropped (kept only for a next packet of at most
               `MAX_NVOP_SIZE` bytes)
  output       cropping to the VOL's width and height, and swscale's YUV
               4:2:0 to BGR (BT.601, limited range, chroma repeated 2x2,
               16-bit fixed point: `yuv420_to_bgr`)

The parser takes a whole VOP's macroblocks into the coefficient domain
first, then runs one dequantisation and one IDCT over all its blocks, then
forms every macroblock's motion-compensated prediction in a few gathers.

The short (H.263) video header: libavcodec's MPEG-4 decoder finds no VOP
start code in it ("header damaged"), so OpenCV returns no frame of such a
stream, and neither does `decode` (tallied `short_header`; the containers
take the size from the stream format). H.263 itself is `data/h263.py`'s.

Raising `NotImplementedError` (ROADMAP Queue 1 item 11.2), a VOL that
announces the syntax before the first frame and a VOP when it is met:

  - interlaced video (OpenCV's FFmpeg backend returns no frame for it:
    swscale cannot convert interlaced to progressive frames)
  - S-VOPs (sprites, GMC: no encoder here writes them), reversible VLC
  - shapes other than rectangular, `not_8_bit`, complexity estimation,
    newpred, reduced resolution and scalability
  - chroma other than 4:2:0, and odd heights (swscale converts those
    through its scaling path, whose pixels are not reproduced)
  - a data-partitioned VOP whose `intra_dc_vlc_thr` is not 0, and dquant
    in an intra macroblock of a VOP whose `intra_dc_vlc_thr` depends on
    the quantiser (no encoder here writes either)

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

from yolo_infer_tpu_torch.data import mpeg4_motion as mc

_ROADMAP = "ROADMAP Queue 1 item 11.2"

# --------------------------------------------------------------- the tables

# (code, length) of the intra MCBPC; index = 4 * dquant + cbpc, 8 is stuffing
_INTRA_MCBPC = [(1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6), (3, 6), (1, 9)]
# the inter MCBPC; index = 16 * inter4v + 8 * dquant + 4 * intra + cbpc, 20 is stuffing; 24..27, four
# vectors with dquant, are H.263's (libavcodec's one table reads them in both codecs)
_INTER_MCBPC = {0: (1, 1), 1: (3, 4), 2: (2, 4), 3: (5, 6), 4: (3, 5), 5: (4, 8), 6: (3, 8), 7: (3, 7),
                8: (3, 3), 9: (7, 7), 10: (6, 7), 11: (5, 9), 12: (4, 6), 13: (4, 9), 14: (3, 9), 15: (2, 9),
                16: (2, 3), 17: (5, 7), 18: (4, 7), 19: (5, 8), 20: (1, 9), 24: (2, 11), 25: (12, 13), 26: (14, 13),
                27: (15, 13)}
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
_LUT_INTER_MCBPC = _lut(_INTER_MCBPC, 13)
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


# the default matrices of MPEG quantisation (quant_type 1), in raster order
_DEFAULT_INTRA_MATRIX = np.array([
    8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26, 28, 30,
    21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45], np.int32)
_DEFAULT_INTER_MATRIX = np.array([
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23, 24, 25,
    19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33], np.int32)


def _load_matrix(b: "_Bits", default: np.ndarray) -> Tuple[np.ndarray, bool]:
    """A VOL's load_*_quant_mat: up to 64 values in zigzag order, a 0 ending
    the list early and the last value repeated (libavcodec), else the default."""
    if not b.bit():
        return default, False
    m = default.copy()
    last, i = 0, 0
    while i < 64:
        v = b.read(8)
        if v == 0:
            break
        last = v
        m[_ZIGZAG[i]] = v
        i += 1
    for k in range(i, 64):
        m[_ZIGZAG[k]] = last
    return m, True


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
        self.low_delay: Optional[int] = None  # without control parameters, the decoder's default (`_low_delay`)
        self.control = b.bit()  # vol_control_parameters
        if self.control:
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
            raise _unsupported("interlaced video (OpenCV's FFmpeg backend returns no frame for it: swscale "
                               "cannot convert interlaced to progressive frames)")
        b.bit()  # obmc_disable
        if b.read(1 if verid == 1 else 2):
            raise _unsupported("sprites (S-VOPs, GMC)")
        if b.bit():
            raise _unsupported("not_8_bit video")
        self.quant_type = b.bit()
        self.intra_matrix, self.inter_matrix = _DEFAULT_INTRA_MATRIX, _DEFAULT_INTER_MATRIX
        self.loaded_matrices = 0
        if self.quant_type:
            self.intra_matrix, intra_loaded = _load_matrix(b, _DEFAULT_INTRA_MATRIX)
            self.inter_matrix, inter_loaded = _load_matrix(b, _DEFAULT_INTER_MATRIX)
            self.loaded_matrices = intra_loaded + inter_loaded
        self.quarter_sample = b.bit() if verid != 1 else 0
        if not b.bit():
            raise _unsupported("complexity estimation headers")
        self.resync = 1 - b.bit()  # resync_marker_disable
        self.partitioned = b.bit()
        if self.partitioned and b.bit():
            raise _unsupported("reversible VLC")
        if verid != 1:
            if b.bit():
                raise _unsupported("newpred")
            if b.bit():
                raise _unsupported("reduced resolution VOPs")
        if b.bit():
            raise _unsupported("scalability")
        if self.height % 2:
            raise _unsupported(f"an odd height ({self.height})")
        if b.pos > b.end:
            raise ValueError("corrupt MPEG-4 VOL: truncated")
        self.mb_w = (self.width + 15) // 16
        self.mb_h = (self.height + 15) // 16


def _user_data(text: bytes) -> Dict[str, int]:
    """The encoder builds a user data string names, as libavcodec reads them
    (`divx` with `divx_build` and `divx_packed`, `lavc`, `xvid`; several may
    match)."""
    s = text.split(b"\0")[0].decode("latin-1")
    found: Dict[str, int] = {}
    m = re.match(r"DivX(\d+)(?:Build|b)(\d+)(.?)", s, re.S)
    if m:  # packed B-frames: a 'p' right after the build number
        found.update(divx=int(m.group(1)), divx_build=int(m.group(2)), divx_packed=int(m.group(3) == "p"))
    m = re.match(r"FFmpe[^b]+b(\d+)", s) or re.match(r"FFmpeg v\d+\.\d+\.\d+ / libavcodec build: (\d+)", s)
    if m:
        found["lavc"] = int(m.group(1))
    else:
        m = re.match(r"Lavc(\d+)\.(\d+)\.(\d+)", s)
        if m:
            found["lavc"] = ((int(m.group(1)) & 0xFF) << 16) + ((int(m.group(2)) & 0xFF) << 8) + (int(m.group(3)) & 0xFF)
        elif s == "ffmpeg":
            found["lavc"] = 4600
    m = re.match(r"XviD(\d+)", s)
    if m:
        found["xvid"] = int(m.group(1))
    return found


def is_short_header(data: bytes) -> bool:
    """The short (H.263) video header starts with 22 bits 0000 0000 0000 0000 1000 00."""
    return len(data) >= 3 and data[0] == 0 and data[1] == 0 and data[2] & 0xFC == 0x80


def workarounds(ids: Dict[str, Optional[int]], fourcc: str, vol: Vol, bugs: Dict[str, str]) -> None:
    """libavcodec's `ff_mpeg4_workaround_bugs`, run before each VOP: the
    encoder `ids` the user data named so far (`xvid`, `divx` and
    `divx_build`, `lavc`; None where unnamed) completed from the codec tag,
    which libavcodec upper-cases (an Xvid tag with no encoder named is Xvid
    build 0; `DIVX` over an object type 0 VOL without control parameters is
    DivX 4), DivX forgotten where Xvid is named too; then each bug
    workaround they call for added to `bugs` (workaround -> "xvid", "divx"
    or "lavc", the encoder it was first taken for: they stay, as
    libavcodec's flags do). `ids` is updated in place, as libavcodec keeps
    what it infers."""
    if ids["xvid"] is None and ids["divx"] is None and ids["lavc"] is None:
        tag = fourcc.upper()
        if tag in XVID_FOURCCS:
            ids["xvid"] = 0
        elif tag == "DIVX" and vol.object_type == 0 and not vol.control:
            ids["divx"] = 400
    if ids["xvid"] is not None and ids["divx"] is not None:
        ids["divx"] = ids["divx_build"] = None
    xvid, divx, lavc = ids["xvid"], ids["divx"], ids["lavc"]
    build = -1 if ids["divx_build"] is None else ids["divx_build"]
    wanted = []
    if divx is not None:
        wanted += [("qpel_chroma", divx >= 500 and build < 1814), ("qpel_chroma2", divx > 502 and build < 1814),
                   ("edge", divx < 500), ("hpel_chroma", True)]
    if xvid is not None:
        wanted += [(name, xvid <= last) for name, last in XVID_WORKAROUNDS.items()] + [("xvid_idct", True)]
    if lavc is not None:
        wanted += [(name, lavc < first) for name, first in LAVC_WORKAROUNDS.items()]
        wanted += [("dc_clip", lavc <= 4712), ("iedge", (lavc & 0xFF) >= 100 and 3621476 < lavc < 3752552
                                                and not 3752037 <= lavc <= 3752191)]
    who = "xvid" if xvid is not None else "divx" if divx is not None else "lavc"
    for name, on in wanted:
        if on:
            bugs.setdefault(name, who)


def find_vol(*sources: bytes) -> Optional[Vol]:
    """The first video object layer header in `sources` (a container's
    configuration, a first packet), None for a stream of the short (H.263)
    video header, which has none; raises ValueError if there is neither,
    and a VOL's refusal (`Vol`) before the first VOP."""
    for data in sources:
        if is_short_header(data):
            return None
        for code, start, end in start_codes(data):
            if VOL_FIRST <= code <= VOL_LAST:
                return Vol(data[start:end])
            if code == VOP_START:
                break
    raise ValueError("corrupt MPEG-4 stream: no video object layer header")


XVID_FOURCCS = ("XVID", "XVIX", "RMP4", "ZMP4", "SIPP")
# AVI and VFW codec tags read as MPEG-4 Part 2 (those OpenCV's FFmpeg writer uses, and their kin)
MPEG4_FOURCCS = (b"XVID", b"FMP4", b"DIVX", b"DX50", b"mp4v", b"MP4V", b"xvid", b"divx")
# libavcodec's bug workarounds by Xvid build (the last build that gets each) and by
# libavcodec build (the first build that no longer gets each)
XVID_WORKAROUNDS = {"qpel_chroma": 1, "edge": 12, "dc_clip": 32}
LAVC_WORKAROUNDS = {"std_qpel": 4653, "direct_blocksize": 4655, "edge": 4670}
MAX_NVOP_SIZE = 19  # libavcodec's bound on a placeholder (N-VOP) packet, in bytes
# workarounds libavcodec takes that change no frame the port decodes, tallied per VOP: half-pel chroma
# acts on field (interlaced) prediction only, the direct block size rule reads the caller's flags
# (AVCodecContext.workaround_bugs) and not the detected ones, and no fixture or fuzzed stream shows the
# intra edge workaround change a frame
_INERT_WORKAROUNDS = ("hpel_chroma", "direct_blocksize", "iedge")


# ---------------------------------------------------------------- the IDCTs

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
    (rows then columns) as it runs on x86 (`ff_simple_idct8_sse2`: each
    pass's results packed to 16 bits with saturation): (..., 8, 8) int32,
    before the clip to pixels."""
    x = blocks.astype(np.int16).astype(np.int32)  # libavcodec's blocks are int16
    with np.errstate(over="ignore"):
        rows = _idct_1d(x, 11, 1 << 10, col=False)
        dc_only = ~np.any(x[..., 1:] != 0, axis=-1, keepdims=True)
        rows = np.clip(np.where(dc_only, x[..., :1] * 8, rows), -32768, 32767)
        cols = _idct_1d(np.swapaxes(rows, -1, -2), 20, 0, col=True)
    return np.ascontiguousarray(np.swapaxes(np.clip(cols, -32768, 32767), -1, -2))


# Xvid's IDCT as libavcodec runs it on x86 (`ff_xvid_idct_sse2`): each row's
# constants scaled by its column's factor (rows 0 and 4, 1 and 7, 2 and 6, 3
# and 5 share a table) with a rounding term of its own, 32-bit products
# saturated to 16 bits; then the columns by tangent butterflies in saturating
# 16-bit arithmetic (a product's high half, tan(3 pi / 16) as -21746 + 65536)
_XVID_TABS = np.array([[22725, 21407, 19266, 16384, 12873, 8867, 4520],
                       [31521, 29692, 26722, 22725, 17855, 12299, 6270],
                       [29692, 27969, 25172, 21407, 16819, 11585, 5906],
                       [26722, 25172, 22654, 19266, 15137, 10426, 5315]], np.int64)
_XVID_ROW_TAB = _XVID_TABS[[0, 1, 2, 3, 0, 3, 2, 1]]  # (8 rows, 7 constants)
_XVID_ROW_RND = np.array([65536, 3597, 2260, 1203, 0, 120, 512, 512], np.int64)
_TAN1, _TAN2, _TAN3_LOW, _SQRT2 = 13036, 27146, 43790 - 65536, 23170


def _sat16(x):
    return np.clip(x, -32768, 32767)


def xvid_idct(blocks: np.ndarray) -> np.ndarray:
    """Xvid's integer IDCT of (..., 8, 8) dequantised coefficients as
    libavcodec runs it for Xvid streams on x86: (..., 8, 8) int32, before
    the clip to pixels."""
    x = blocks.astype(np.int16).astype(np.int64)
    c1, c2, c3, c4, c5, c6, c7 = (_XVID_ROW_TAB[:, k] for k in range(7))
    i0, i1, i2, i3, i4, i5, i6, i7 = (x[..., k] for k in range(8))
    k = c4 * i0 + _XVID_ROW_RND
    a0 = k + c2 * i2 + c4 * i4 + c6 * i6
    a1 = k + c6 * i2 - c4 * i4 - c2 * i6
    a2 = k - c6 * i2 - c4 * i4 + c2 * i6
    a3 = k - c2 * i2 + c4 * i4 - c6 * i6
    b0 = c1 * i1 + c3 * i3 + c5 * i5 + c7 * i7
    b1 = c3 * i1 - c7 * i3 - c1 * i5 - c5 * i7
    b2 = c5 * i1 - c1 * i3 + c7 * i5 + c3 * i7
    b3 = c7 * i1 - c5 * i3 + c3 * i5 - c1 * i7
    rows = np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0], -1)
    rows = _sat16((((rows & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000) >> 11)  # 32-bit sums, packed with saturation
    col = lambda k: rows[..., k, :]  # noqa: E731
    high = lambda t, v: (t * v) >> 16  # noqa: E731 -- pmulhw
    add = lambda a, b: _sat16(a + b)  # noqa: E731 -- paddsw
    sub = lambda a, b: _sat16(a - b)  # noqa: E731 -- psubsw
    r1, r3, r5, r7 = col(1), col(3), col(5), col(7)
    t3_3 = add(high(_TAN3_LOW, r3), r3)
    t3_5 = add(high(_TAN3_LOW, r5), r5)
    m3 = sub(t3_3, r5)
    m2 = add(t3_5, r3)
    m0 = add(high(_TAN1, r7), r1)
    m1 = sub(high(_TAN1, r1), r7)
    m7, m4 = add(m2, m0), sub(m1, m3)
    m0, m1 = sub(m0, m2), add(m3, m1)
    m5, m6 = sub(m0, m1), add(m1, m0)
    m5, m6 = add(high(_SQRT2, m5), high(_SQRT2, m5)), add(high(_SQRT2, m6), high(_SQRT2, m6))
    r0, r2, r4, r6 = col(0), col(2), col(4), col(6)
    e3 = add(high(_TAN2, r6), r2)
    e2 = sub(high(_TAN2, r2), r6)
    e1, e0 = sub(r0, r4), add(r4, r0)
    e3, e0 = sub(e0, e3), add(e3, e0)
    e2, e1 = sub(e1, e2), add(e2, e1)
    o6, o1 = sub(e1, m6), add(m6, e1)
    o5, o2 = sub(e2, m5), add(m5, e2)
    o7, o0 = sub(e0, m7), add(m7, e0)
    o4, o3 = sub(e3, m4), add(m4, e3)
    return (np.stack([o0, o1, o2, o3, o4, o5, o6, o7], -2) >> 6).astype(np.int32)


# ---------------------------------------------------------------- colour

_R16 = lambda c: (c * 8192 + 0x8000) >> 16  # noqa: E731 -- swscale's roundToInt16(coeff << 13)
_Y_COEFF = _R16(76309)
_Y_OFFSET = ((16 << 16) * 8 + 0x8000) >> 16
# swscale's YUV to RGB coefficients (its `ff_yuv2rgb_coeffs`, times 65536: Cr to R, Cb to B, Cb to G, Cr to G)
# by the matrix_coefficients a stream names (ISO/IEC 23091-2: 1 BT.709, 4 FCC, 7 SMPTE 240M, 9 BT.2020
# non-constant luminance); every other code but 8 (YCgCo) and 10 (BT.2020 constant luminance), which swscale
# converts otherwise, takes BT.601's
BT601 = (104597, 132201, 25675, 53279)
YUV2RGB_COEFFS = {1: (117489, 138438, 13975, 34925), 4: (104448, 132798, 24759, 53109),
                  7: (117579, 136230, 16907, 35559), 9: (110013, 140363, 12277, 42626)}


def yuv420_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray, coeffs: Tuple[int, int, int, int] = BT601) -> np.ndarray:
    """swscale's YUV 4:2:0 to BGR24 (BT.601 unless `coeffs` says otherwise,
    limited range) as OpenCV's FFmpeg backend gets it: each term a 16-bit
    product's high half, each chroma sample on 2x2 pixels. (h, w) luma,
    (h/2, ceil(w/2)) chroma -> (h, w, 3)."""
    vr, ub, ug, vg = _R16(coeffs[0]), _R16(coeffs[1]), _R16(-coeffs[2]), _R16(-coeffs[3])
    h, w = y.shape
    uu = np.repeat(np.repeat(u.astype(np.int32) * 8 - 1024, 2, 0), 2, 1)[:h, :w]
    vv = np.repeat(np.repeat(v.astype(np.int32) * 8 - 1024, 2, 0), 2, 1)[:h, :w]
    yy = ((y.astype(np.int32) * 8 - _Y_OFFSET) * _Y_COEFF) >> 16
    out = np.empty((h, w, 3), np.uint8)
    np.clip(yy + ((uu * ub) >> 16), 0, 255, out=out[..., 0], casting="unsafe")
    np.clip(yy + ((uu * ug) >> 16) + ((vv * vg) >> 16), 0, 255, out=out[..., 1], casting="unsafe")
    np.clip(yy + ((vv * vr) >> 16), 0, 255, out=out[..., 2], casting="unsafe")
    return out


# ---------------------------------------------------------------- the decoder

_QUANT_DELTA = (-1, -2, 1, 2)  # dquant
_Y_SCALE = [_dc_scaler(q, True) for q in range(32)]
_C_SCALE = [_dc_scaler(q, False) for q in range(32)]
# the 16 bits at a resync marker's stuffing, by the bit position within its byte
_RESYNC_PREFIX = (0x7F00, 0x7E00, 0x7C00, 0x7800, 0x7000, 0x6000, 0x4000, 0x0000)
_DC_MARKER, _MOTION_MARKER = 0x6B001, 0x1F001  # 19 and 17 bits: the ends of the first partitions
# B macroblock types by their VLC (1, 01, 001, 0001): motion directions (1 forward, 2 backward, 0 direct)
_B_TYPES = ((0, "b_direct_delta"), (3, "b_interpolate"), (2, "b_backward"), (1, "b_forward"))


def _median(a: int, b: int, c: int) -> int:
    return max(min(a, b), min(max(a, b), c))


def _tdiv(a: int, b: int) -> int:
    """C's integer division (toward zero) by a positive b."""
    return a // b if a >= 0 else -((-a) // b)


def _rounded_div(a: int, b: int) -> int:
    """libavcodec's ROUNDED_DIV."""
    return (a + (b >> 1)) // b if a >= 0 else -((-a + (b >> 1)) // b)


class _Ref:
    """A decoded reference VOP: its macroblock-aligned planes and, for the
    B-VOPs that follow it, each 8x8 block's vector and which macroblocks
    were 4MV or skipped."""

    __slots__ = ("planes", "mvx", "mvy", "four", "skipped")

    def __init__(self, planes, mvx, mvy, four, skipped):
        self.planes, self.mvx, self.mvy, self.four, self.skipped = planes, mvx, mvy, four, skipped


class _Vop:
    """One VOP's parse: each macroblock's levels, quantiser, kind and motion,
    and the predictors it is parsed with."""

    h263 = False  # an H.263 picture (`data/h263.py`): its intra DC is scaled by 8
    dc_scales = None  # the luma and chroma DC scales by quantiser where they are not MPEG-4's (`data/msmpeg4.py`)

    def __init__(self, vol: Vol, kind: int, q: int, dc_thr: int, fcode: int, bcode: int):
        self.kind, self.q, self.dc_thr, self.fcode, self.bcode = kind, q, dc_thr, fcode, bcode
        mb_w, mb_h = vol.mb_w, vol.mb_h
        n_mb = mb_w * mb_h
        self.levels = np.zeros((n_mb, 6, 64), np.int32)
        self.idx: List[int] = []  # inter coefficients: flat index and level
        self.val: List[int] = []
        self.esc3: List[int] = []  # flat indices of inter levels an escape 3 coded
        self.intra_at: List[int] = []  # intra blocks: block index and the 64 levels
        self.intra_rows: List[List[int]] = []
        self.mb_kind = bytearray(n_mb)  # 0 a copy from the forward reference, 1 inter, 2 intra
        self.mbq = [q] * n_mb
        self.coded = np.zeros((n_mb, 6), bool)
        self.motion: List[Optional[tuple]] = [None] * n_mb  # (directions, 4MV, forward and backward vectors)
        # DC and AC predictors per 8x8 block in a (rows + 1, cols + 1) grid
        # whose row 0 and column 0 are outside the VOP
        self.lw, self.cw = 2 * mb_w + 1, mb_w + 1
        lw, cw = self.lw, self.cw
        self.dc = [[1024] * (lw * (2 * mb_h + 1)), [1024] * (cw * (mb_h + 1)), [1024] * (cw * (mb_h + 1))]
        zero7 = [0] * 7
        self.ac_left = [[zero7] * len(self.dc[0]), [zero7] * len(self.dc[1]), [zero7] * len(self.dc[2])]
        self.ac_top = [[zero7] * len(self.dc[0]), [zero7] * len(self.dc[1]), [zero7] * len(self.dc[2])]
        # the block vectors of a P-VOP, (2 mb_h + 1) rows of 2 mb_w + 1 (row 0 and the last column a border)
        self.stride = 2 * mb_w + 1
        self.mvx = [0] * (self.stride * (2 * mb_h + 1))
        self.mvy = [0] * (self.stride * (2 * mb_h + 1))
        self.four = bytearray(n_mb)
        self.skipped = bytearray(n_mb)
        self.start = 0  # the current video packet's first macroblock
        self.trb = self.trd = 0  # direct mode's TRB and TRD


class Mpeg4Decoder:
    """Decode MPEG-4 Part 2 packets (one VOP each, with any headers before
    it) to frames in display order, each the (Y, U, V) planes cropped to the
    picture (`yuv420_to_bgr` converts them as swscale does): `decode`
    returns the frame a packet completes, if any, and `flush` the frame
    held back at the end of the stream (B-VOP streams hold one reference
    back). `config` is the container's decoder configuration (the VOL),
    `fourcc` its codec tag."""

    def __init__(self, config: bytes = b"", fourcc: str = ""):
        self.vol: Optional[Vol] = None
        self.fourcc = fourcc
        self.ids: Dict[str, Optional[int]] = dict.fromkeys(("xvid", "divx", "divx_build", "lavc"))
        self.divx_packed = False  # DivX user data with a 'p': later VOPs of a packet are kept for the next
        self._bugs: Dict[str, str] = {}  # libavcodec's workarounds taken so far and for whom (they stay)
        self.counts: Counter = Counter()
        self._past: Optional[_Ref] = None  # the references: the one before the latest, and the latest
        self._future: Optional[_Ref] = None
        self._held = False  # the latest reference is not output yet
        self._low_delay = 0
        self._pictures = 0  # VOPs decoded (libavcodec's picture_number)
        self._stored: Optional[bytes] = None  # the rest of a packed packet, decoded in the next one's place
        self._skipped_last = False  # the last VOP was not coded: the flush outputs the latest reference again
        self._time_base = self._last_time_base = 0  # seconds (modulo_time_base) of the latest and the one before
        self._last_non_b_time = self._pp_time = 0  # in vop_time_increment ticks
        if config:
            self.decode(config)
            if self.vol is None:
                raise ValueError("corrupt MPEG-4 decoder configuration: no video object layer header")

    def decode(self, packet: bytes):
        """Parse one packet; the planes of the frame it completes, if any.

        As libavcodec: only a packet's first VOP is decoded. Under DivX's
        packed B-frames (`divx_packed`), a packet that decoded a VOP and
        holds an I- or B-VOP start code past it keeps the rest, which the
        next packet (DivX's placeholder) gives way to; without it, the rest
        is kept only for a next packet of at most `MAX_NVOP_SIZE` bytes."""
        data, stored, self._stored = packet, self._stored, None
        if stored is not None:
            codes = start_codes(packet)
            if self.divx_packed and codes and codes[0][0] == 0xB0:  # a new sequence: the kept VOP goes
                stored = b""
            if stored and (self.divx_packed or len(packet) <= MAX_NVOP_SIZE):
                data = stored
                self.counts["packed_vop"] += 1
        self._skipped_last = False
        frame, end = None, None
        for code, start, stop in start_codes(data):
            if VOL_FIRST <= code <= VOL_LAST:
                vol = Vol(data[start:stop])
                if self.vol is None or (vol.width, vol.height) != (self.vol.width, self.vol.height):
                    self._past = self._future = None  # a new frame size: a P-VOP must wait for an I-VOP
                    self._held = False
                if vol.low_delay is not None:
                    self._low_delay = vol.low_delay
                elif not self._pictures:  # libavcodec's default: simple and advanced simple
                    self._low_delay = int(vol.object_type in (1, 17))
                self.vol = vol
            elif code == USER_DATA:
                found = _user_data(data[start:stop])
                self.divx_packed = bool(found.pop("divx_packed", self.divx_packed))
                self.ids.update(found)
            elif code == VOP_START:
                frame, bits = self._vop(data[start:stop])
                if bits is not None:
                    end = start + bits // 8
                break
        else:
            if is_short_header(data):  # libavcodec's MPEG-4 decoder finds no VOP in it: no frame
                self.counts["short_header"] += 1
        if self.divx_packed and end is not None:
            at = 0 if data is not packet else end
            if len(packet) - at > 7:
                nxt = packet.find(b"\x00\x00\x01\xb6", at, len(packet) - 4)
                if nxt >= 0 and not packet[nxt + 4] & 0x40:  # an I- or B-VOP follows
                    self._stored = packet[at:]
        return frame

    def flush(self):
        """The reference held back for display order, at the end of the
        stream; after a last VOP that was not coded, the latest reference
        (again, in a low-delay stream), as libavcodec gives it."""
        if not (self._held or (self._skipped_last and self._future is not None)):
            return None
        self._held = self._skipped_last = False
        return self._output(self._future.planes)

    def _output(self, planes):
        """A decoded VOP's planes cropped to the picture."""
        y, u, v = planes
        h, w = self.vol.height, self.vol.width
        return y[:h, :w], u[:h // 2, :(w + 1) // 2], v[:h // 2, :(w + 1) // 2]

    def _vop(self, data: bytes):
        """One VOP: (the frame it completes or None, the bits its decode
        read, or None where no picture was decoded)."""
        vol = self.vol
        if vol is None:
            raise ValueError("corrupt MPEG-4 stream: a VOP before any video object layer header")
        b = _Bits(data)
        kind = b.read(2)
        if kind == 3:
            raise _unsupported("an S-VOP (sprite, GMC)")
        seconds = 0
        while b.bit():  # modulo_time_base
            seconds += 1
            if b.left() <= 0:
                raise ValueError("corrupt MPEG-4 VOP: truncated header")
        b.marker("before vop_time_increment")
        increment = b.read(vol.time_bits)
        b.marker("after vop_time_increment")
        # libavcodec's clock: a B-VOP counts from the reference before the latest
        if kind != 2:
            self._last_time_base = self._time_base
            self._time_base += seconds
            time = self._time_base * vol.time_resolution + increment
            self._pp_time = time - self._last_non_b_time
            self._last_non_b_time = time
            pb_time = 0
        else:
            time = (self._last_time_base + seconds) * vol.time_resolution + increment
            pb_time = self._pp_time - (self._last_non_b_time - time)
        if not b.bit():  # vop_coded 0: no frame, the references and the clock as they now are
            self.counts["not_coded_vop"] += 1
            self._skipped_last = True
            return None, None
        if not self._pictures and vol.object_type == 0 and not vol.control and self.ids["divx"] is None:
            self._low_delay = 1  # libavcodec forces it for such streams (DivX 4, old Xvid, OpenDivX)
        self._pictures += 1
        workarounds(self.ids, self.fourcc, vol, self._bugs)
        if kind == 2 and (self._past is None or not 0 < pb_time < self._pp_time):
            self.counts["b_vop_dropped"] += 1  # no past reference, or out of order: libavcodec drops it
            return None, None
        rounding = b.bit() if kind == 1 else 0
        dc_thr = _DC_THRESHOLD[b.read(3)]
        q = b.read(5)
        if q == 0:
            raise ValueError("corrupt MPEG-4 VOP: vop_quant 0")
        fcode = b.read(3) if kind else 1
        bcode = b.read(3) if kind == 2 else 1
        if fcode == 0 or bcode == 0:
            raise ValueError("corrupt MPEG-4 VOP: a vop_fcode of 0")
        if b.left() < 0:
            raise ValueError("corrupt MPEG-4 VOP: truncated header")
        if kind and self._future is None:
            raise ValueError("corrupt MPEG-4 stream: a P- or B-VOP before any I-VOP")
        counts = self.counts
        counts[("i_vop", "p_vop", "b_vop")[kind]] += 1
        if kind:
            counts[f"fcode_{fcode}"] += 1
        if kind == 1:
            counts[f"rounding_{rounding}"] += 1
        if vol.quarter_sample:
            counts["qpel_vop"] += 1
        if vol.quant_type:
            counts["mpeg_quant_vop"] += 1
            if vol.loaded_matrices:
                counts["loaded_matrix_vop"] += 1
        if "xvid_idct" in self._bugs:
            counts["xvid_idct_vop"] += 1
        for name in _INERT_WORKAROUNDS:
            if name in self._bugs:
                self._tally(name)
        vop = _Vop(vol, kind, q, dc_thr, fcode, bcode)
        vop.trb, vop.trd = pb_time, self._pp_time
        if vol.partitioned and kind != 2:
            if dc_thr != 99:
                raise _unsupported("a data-partitioned VOP whose intra_dc_vlc_thr is not 0")
            counts["partitioned_vop"] += 1
            self._partitioned(b, vop)
        else:
            self._plain(b, vop)
        if b.pos > b.end:
            raise ValueError("corrupt MPEG-4 VOP: truncated")
        planes = self._reconstruct(vop, rounding)
        if kind == 2:
            return self._output(planes), b.pos
        shown = self._held
        self._past, self._future = self._future, _Ref(planes, vop.mvx, vop.mvy, vop.four, vop.skipped)
        if self._low_delay:
            self._held = False
            return self._output(planes), b.pos
        self._held = True
        return (self._output(self._past.planes) if shown else None), b.pos

    # ------------------------------------------------------------ packets

    def _resync(self, b: _Bits, vop: _Vop) -> Optional[Tuple[int, int, int]]:
        """A video packet header after stuffing at the current position:
        (its first macroblock, the bit position after the header, its
        quant_scale), else None."""
        p = b.pos
        if p + 8 >= b.end or b.peek(16) != _RESYNC_PREFIX[p & 7]:  # the VOP's last byte is stuffing
            return None
        p += 8 - (p & 7)
        zeros = 0
        words = b.words
        while zeros < 32 and not (words[(p + zeros) >> 3] >> (39 - ((p + zeros) & 7))) & 1:
            zeros += 1
        need = 16 if vop.kind == 0 else vop.fcode + 15 if vop.kind == 1 else max(vop.fcode, vop.bcode, 2) + 15
        if zeros < need:
            return None
        if zeros != need:
            raise ValueError("corrupt MPEG-4 VOP: a resync marker of the wrong length")
        save = b.pos
        b.pos = p + zeros + 1
        n_mb = self.vol.mb_w * self.vol.mb_h
        mb = b.read(max((n_mb - 1).bit_length(), 1))
        if not 0 < mb < n_mb:
            raise ValueError(f"corrupt MPEG-4 VOP: a video packet at macroblock {mb} of {n_mb}")
        q = b.read(5)
        if b.bit():  # header_extension_code: the VOP header's fields again, which libavcodec skips
            self.counts["hec"] += 1
            while b.bit():
                if b.left() <= 0:
                    raise ValueError("corrupt MPEG-4 VOP: a truncated video packet header")
            b.marker("in a video packet header")
            b.read(self.vol.time_bits)
            b.marker("in a video packet header")
            b.read(2 + 3)  # vop_coding_type, intra_dc_vlc_thr
            if vop.kind:
                b.read(3)
            if vop.kind == 2:
                b.read(3)
        after = b.pos
        b.pos = save
        return mb, after, q

    def _start_packet(self, b: _Bits, vop: _Vop, mb: int, after: int, q: int) -> None:
        b.pos = after
        vop.start = mb
        if q:
            vop.q = q
        self.counts["video_packet"] += 1

    # ------------------------------------------------------------ macroblocks

    def _plain(self, b: _Bits, vop: _Vop) -> None:
        """The macroblocks of a VOP without data partitioning, video packets
        split where a resync marker follows a macroblock."""
        vol = self.vol
        mb_w, n_mb = vol.mb_w, vol.mb_w * vol.mb_h
        kind, counts = vop.kind, self.counts
        skipped = self._future.skipped if kind == 2 else None
        pending = None
        last = [0, 0, 0, 0]  # the B-VOP's forward and backward vector predictors
        for mb in range(n_mb):
            mby, mbx = divmod(mb, mb_w)
            if mb and vol.resync:
                if pending is None:
                    pending = self._resync(b, vop)
                if pending is not None and pending[0] <= mb:
                    if pending[0] < mb:
                        raise ValueError(f"corrupt MPEG-4 VOP: a video packet at macroblock {pending[0]} met at {mb}")
                    self._start_packet(b, vop, *pending)
                    pending = None
                    last[:] = (0, 0, 0, 0)
            if kind == 2:
                if mbx == 0:
                    last[:] = (0, 0, 0, 0)
                vop.mbq[mb] = vop.q
                if skipped[mb]:  # skipped in the next reference: a copy from the previous one
                    vop.motion[mb] = (1, 0, _ZERO4, None)
                    counts["b_colocated_skip"] += 1
                    continue
            if pending is not None:
                raise ValueError(f"corrupt MPEG-4 VOP: macroblock data before the video packet at {pending[0]}")
            if b.pos >= b.end:
                raise ValueError(f"corrupt MPEG-4 VOP: truncated at macroblock {mb} of {n_mb}")
            if kind == 2:
                self._b_mb(b, vop, mb, mbx, mby, last)
            else:
                self._ip_mb(b, vop, mb, mbx, mby)

    def _mcbpc(self, b: _Bits, vop: _Vop, mb: int) -> Optional[int]:
        """An I- or P-VOP macroblock's not_coded bit and MCBPC, stuffing
        skipped: None for a skipped macroblock, else 16 * inter4v + 8 *
        dquant + 4 * intra + cbpc."""
        if vop.kind:
            while True:
                if b.bit():
                    return None
                hit = _LUT_INTER_MCBPC[b.peek(13)]
                if hit is None:
                    raise ValueError(f"corrupt MPEG-4 VOP: bad MCBPC at macroblock {mb}")
                b.pos += hit[1]
                if hit[0] != 20:
                    return hit[0]
        while True:
            hit = _LUT_INTRA_MCBPC[b.peek(9)]
            if hit is None:
                raise ValueError(f"corrupt MPEG-4 VOP: bad MCBPC at macroblock {mb}")
            b.pos += hit[1]
            if hit[0] != 8:
                return hit[0] << 1 & 8 | 4 | hit[0] & 3  # the dquant flag where the inter table has it

    def _cbpy(self, b: _Bits, mb: int, intra: int) -> int:
        hit = _LUT_CBPY[b.peek(6)]
        if hit is None:
            raise ValueError(f"corrupt MPEG-4 VOP: bad CBPY at macroblock {mb}")
        b.pos += hit[1]
        return hit[0] if intra else 15 - hit[0]

    def _dquant(self, b: _Bits, vop: _Vop, intra: int) -> None:
        if intra and vop.dc_thr not in (0, 99):
            raise _unsupported("dquant in an intra macroblock of a VOP whose intra_dc_vlc_thr depends on the quantiser")
        vop.q = min(max(vop.q + _QUANT_DELTA[b.read(2)], 1), 31)
        self.counts["dquant_mb"] += 1

    def _ip_mb(self, b: _Bits, vop: _Vop, mb: int, mbx: int, mby: int) -> None:
        """One macroblock of an I- or P-VOP, not partitioned."""
        counts = self.counts
        cbpc = self._mcbpc(b, vop, mb)
        if cbpc is None:
            self._skip(vop, mb)
            return
        intra = cbpc & 4
        ac_pred = b.bit() if intra else 0
        cbp = self._cbpy(b, mb, intra) << 2 | cbpc & 3
        use_dc_vlc = vop.q < vop.dc_thr  # libavcodec tests the quantiser before this macroblock's dquant
        if cbpc & 8:
            self._dquant(b, vop, intra)
        vop.mbq[mb] = vop.q
        if intra:
            if vop.kind:
                counts["intra_mb_in_p"] += 1
            self._intra_mb(b, vop, mb, mbx, mby, cbp, ac_pred, use_dc_vlc, None, None)
            return
        self._p_vectors(b, vop, mb, mbx, mby, cbpc & 16)
        self._inter_blocks(b, vop, mb, cbp)

    def _skip(self, vop: _Vop, mb: int) -> None:
        vop.motion[mb] = (1, 0, _ZERO4, None)
        vop.skipped[mb] = 1
        vop.mbq[mb] = vop.q
        self.counts["skipped_mb"] += 1

    def _p_vectors(self, b: _Bits, vop: _Vop, mb: int, mbx: int, mby: int, four: int) -> None:
        """A P-VOP macroblock's one or four vectors, each from its median prediction."""
        self.counts["inter_mb"] += 1
        vop.mb_kind[mb] = 1
        stride, mvx, mvy = vop.stride, vop.mvx, vop.mvy
        top = (2 * mby + 1) * stride + 2 * mbx  # block 0 (row 0 of the lists is a border)
        fcode = vop.fcode
        if four:
            self.counts["inter4v_mb"] += 1
            vop.four[mb] = 1
            vectors = []
            for n in range(4):
                at = top + (n >> 1) * stride + (n & 1)
                px, py = self._pred_motion(vop, n, at, mb, mbx, mby)
                mvx[at] = x = self._mvd(b, px, fcode, mb)
                mvy[at] = y = self._mvd(b, py, fcode, mb)
                vectors.append((x, y))
            vop.motion[mb] = (1, 1, vectors, None)
            return
        px, py = self._pred_motion(vop, 0, top, mb, mbx, mby)
        x, y = self._mvd(b, px, fcode, mb), self._mvd(b, py, fcode, mb)
        mvx[top] = mvx[top + 1] = mvx[top + stride] = mvx[top + stride + 1] = x
        mvy[top] = mvy[top + 1] = mvy[top + stride] = mvy[top + stride + 1] = y
        vop.motion[mb] = (1, 0, [(x, y)] * 4, None)

    def _pred_motion(self, vop: _Vop, n: int, at: int, mb: int, mbx: int, mby: int) -> Tuple[int, int]:
        """libavcodec's `ff_h263_pred_motion` of block n: the median of the
        left, above and above-right vectors, with the rules of a video
        packet's first row (the row whose above macroblock lies in another
        packet), including its zeroing of the left vector of block 2 at the
        packet's first macroblock."""
        mvx, mvy, stride = vop.mvx, vop.mvy, vop.stride
        start = vop.start
        rx = start % self.vol.mb_w
        a = at - 1
        if (mby == 0 or mb - self.vol.mb_w < start) and n < 3:
            if n == 0:
                if mbx == rx:
                    return 0, 0
                if mbx + 1 == rx:
                    c = at + 2 - stride
                    if mbx == 0:
                        return mvx[c], mvy[c]
                    return _median(mvx[a], 0, mvx[c]), _median(mvy[a], 0, mvy[c])
                return mvx[a], mvy[a]
            if n == 1:
                if mbx + 1 == rx:
                    c = at + 1 - stride
                    return _median(mvx[a], 0, mvx[c]), _median(mvy[a], 0, mvy[c])
                return mvx[a], mvy[a]
            if mbx == rx:
                mvx[a] = mvy[a] = 0
        off = (2, 1, 1, -1)[n]
        bb, c = at - stride, at + off - stride
        return _median(mvx[a], mvx[bb], mvx[c]), _median(mvy[a], mvy[bb], mvy[c])

    def _mvd(self, b: _Bits, pred: int, fcode: int, mb: int) -> int:
        """One vector component: the MVD added to pred, wrapped as libavcodec's sign_extend(v, 5 + fcode)."""
        hit = _LUT_MVD[b.peek(12)]
        if hit is None:
            raise ValueError(f"corrupt MPEG-4 VOP: bad MVD at macroblock {mb}")
        b.pos += hit[1]
        code = hit[0]
        if not code:
            return pred
        sign = b.bit()
        if fcode > 1:
            code = ((code - 1) << (fcode - 1) | b.read(fcode - 1)) + 1
        pred += -code if sign else code
        half = 1 << (4 + fcode)
        return (pred + half) % (2 * half) - half

    def _b_mb(self, b: _Bits, vop: _Vop, mb: int, mbx: int, mby: int, last: List[int]) -> None:
        """One macroblock of a B-VOP (its co-located macroblock coded)."""
        counts = self.counts
        if b.bit():  # modb 1: direct, no vector delta, no coefficients
            counts["b_direct_skip"] += 1
            self._direct(vop, mb, mbx, mby, 0, 0)
            return
        no_cbp = b.bit()
        for dirs, name in _B_TYPES:
            if b.bit():
                break
        else:
            raise ValueError(f"corrupt MPEG-4 VOP: bad B macroblock type at macroblock {mb}")
        counts[name] += 1
        cbp = 0 if no_cbp else b.read(6)
        if dirs and cbp and b.bit():  # dbquant: 0, 10 (-2), 11 (+2)
            vop.q = min(max(vop.q + 4 * b.bit() - 2, 1), 31)
            counts["dbquant_mb"] += 1
        vop.mbq[mb] = vop.q
        if dirs:
            fwd = bwd = None
            if dirs & 1:
                last[0] = self._mvd(b, last[0], vop.fcode, mb)
                last[1] = self._mvd(b, last[1], vop.fcode, mb)
                fwd = [(last[0], last[1])] * 4
            if dirs & 2:
                last[2] = self._mvd(b, last[2], vop.bcode, mb)
                last[3] = self._mvd(b, last[3], vop.bcode, mb)
                bwd = [(last[2], last[3])] * 4
            vop.motion[mb] = (dirs, 0, fwd, bwd)
            vop.mb_kind[mb] = 1
        else:
            self._direct(vop, mb, mbx, mby, self._mvd(b, 0, 1, mb), self._mvd(b, 0, 1, mb))
        self._inter_blocks(b, vop, mb, cbp)

    def _direct(self, vop: _Vop, mb: int, mbx: int, mby: int, dx: int, dy: int) -> None:
        """Direct mode: the co-located macroblock's one or four vectors in
        the next reference, scaled by TRB / TRD, plus the delta (dx, dy)."""
        ref, trb, trd = self._future, vop.trb, vop.trd
        counts = self.counts
        counts["b_direct"] += 1
        stride = vop.stride
        top = (2 * mby + 1) * stride + 2 * mbx
        four = ref.four[mb]
        fwd, bwd = [], []
        for n in range(4 if four else 1):
            at = top + (n >> 1) * stride + (n & 1)
            pair_f, pair_b = [], []
            for p, d in ((ref.mvx[at], dx), (ref.mvy[at], dy)):
                f = _tdiv(p * trb, trd) + d
                pair_f.append(f)
                pair_b.append(f - p if d else _tdiv(p * (trb - trd), trd))
            fwd.append(tuple(pair_f))
            bwd.append(tuple(pair_b))
        if four:
            counts["b_direct_4mv"] += 1
        else:
            fwd, bwd = fwd * 4, bwd * 4
        # libavcodec predicts a quarter-pel direct macroblock as four 8x8 blocks (its direct block size
        # workaround reads the caller's flags, not the detected ones: it never acts here)
        vop.motion[mb] = (3, int(bool(four or self.vol.quarter_sample)), fwd, bwd)
        vop.mb_kind[mb] = 1

    def _inter_blocks(self, b: _Bits, vop: _Vop, mb: int, cbp: int) -> None:
        for n in range(6):
            if cbp & (32 >> n):
                vop.coded[mb, n] = True
                self._tcoef(b, _LUT_INTER, _MAX_INTER, -1, _ZIGZAG, (mb * 6 + n) * 64, vop.idx, vop.val, None,
                            vop.esc3)

    def _dc_pred(self, vop: _Vop, n: int, mb: int, mbx: int, mby: int):
        """(plane, grid index, from the top, scale, predicted DC level) of
        intra block n: the gradient rule over the left, above-left and above
        blocks, those of macroblocks in another video packet taken as 1024."""
        mb_w, start = self.vol.mb_w, vop.start
        left = mbx > 0 and mb - 1 >= start
        above = mby > 0 and mb - mb_w >= start
        corner = mbx > 0 and mby > 0 and mb - mb_w - 1 >= start
        if n < 4:
            plane, gw = 0, vop.lw
            at = (2 * mby + (n >> 1) + 1) * gw + 2 * mbx + (n & 1) + 1
            scale = _Y_SCALE[vop.q]
        else:
            plane, gw = n - 3, vop.cw
            at = (mby + 1) * gw + mbx + 1
            scale = _C_SCALE[vop.q]
        dcp = vop.dc[plane]
        a, bb, c = dcp[at - 1], dcp[at - 1 - gw], dcp[at - gw]
        if n == 1:
            if not above:
                bb = c = 1024
        elif n == 2:
            if not left:
                a = bb = 1024
        elif n != 3:
            if not left:
                a = 1024
            if not corner:
                bb = 1024
            if not above:
                c = 1024
        top = abs(a - bb) < abs(bb - c)  # predict from above, else from the left
        return plane, at, top, scale, ((c if top else a) + (scale >> 1)) // scale

    def _store_dc(self, vop: _Vop, plane: int, at: int, level: int, scale: int) -> None:
        dc_val = level * scale
        if dc_val > 2047 and "dc_clip" in self._bugs:
            self._tally("dc_clip")  # libavcodec keeps the unclipped DC for such Xvid and Lavc builds
        else:
            dc_val = 0 if dc_val < 0 else 2047 if dc_val > 2047 else dc_val
        vop.dc[plane][at] = dc_val

    def _dc_level(self, b: _Bits, n: int, mb: int) -> int:
        """A DC difference: dct_dc_size, the bits, a marker past size 8."""
        hit = _LUT_DC[n >= 4][b.peek(12)]
        if hit is None:
            raise ValueError(f"corrupt MPEG-4 VOP: bad DC size at macroblock {mb}")
        b.pos += hit[1]
        size = hit[0]
        if not size:
            return 0
        diff = b.read(size)
        if not diff >> (size - 1):
            diff -= (1 << size) - 1
        if size > 8:
            b.marker("after a DC coefficient")
        return diff

    def _intra_mb(self, b: _Bits, vop: _Vop, mb: int, mbx: int, mby: int, cbp: int, ac_pred: int,
                  use_dc_vlc: bool, dcs, dirs) -> None:
        """An intra macroblock's six blocks: DC (from `dcs`, levels a data
        partition gave with their directions `dirs`, or read here), TCOEF,
        then AC prediction from the block the DC predicted from, rescaled to
        this macroblock's quantiser."""
        counts = self.counts
        vop.mb_kind[mb] = 2
        counts["intra_mb"] += 1
        if ac_pred:
            counts["ac_pred_mb"] += 1
        mb_w, start, q, mbq = self.vol.mb_w, vop.start, vop.q, vop.mbq
        for n in range(6):
            block = [0] * 64
            if dcs is None:
                plane, at, top, scale, pred = self._dc_pred(vop, n, mb, mbx, mby)
                first = 0
                if use_dc_vlc:
                    block[0] = self._dc_level(b, n, mb)
                    first = 1
                else:
                    counts["dc_as_ac"] += 1
            else:
                plane, at, scale, top = dirs[n]
                first = 1
            if ac_pred:
                scan = _ALT_H if top else _ALT_V
                counts["scan_horizontal" if top else "scan_vertical"] += 1
            else:
                scan = _ZIGZAG
                counts["scan_zigzag"] += 1
            if cbp & (32 >> n):
                self._tcoef(b, _LUT_INTRA, _MAX_INTRA, first - 1, scan, 0, None, None, block, None)
            if dcs is None:
                level = block[0] + pred
                if level < 0 and use_dc_vlc:
                    raise ValueError(f"corrupt MPEG-4 VOP: a negative intra DC at macroblock {mb}")
                self._store_dc(vop, plane, at, level, scale)
            else:
                level = dcs[n]
            block[0] = level
            if ac_pred:
                gw = vop.lw if plane == 0 else vop.cw
                if top:
                    src = vop.ac_top[plane][at - gw]
                    if n < 2 or n > 3:  # the block above is the above macroblock's
                        src = self._ac_source(src, mb - mb_w, mby > 0 and mb - mb_w >= start, mbq, q)
                    for k in range(7):
                        block[k + 1] += src[k]
                else:
                    src = vop.ac_left[plane][at - 1]
                    if n != 1 and n != 3:  # the block left is the left macroblock's
                        src = self._ac_source(src, mb - 1, mbx > 0 and mb - 1 >= start, mbq, q)
                    for k in range(7):
                        block[8 * k + 8] += src[k]
                if type(src) is tuple:
                    counts["ac_pred_rescaled"] += 1
            vop.ac_top[plane][at] = block[1:8]
            vop.ac_left[plane][at] = block[8::8]
            vop.intra_at.append(mb * 6 + n)
            vop.intra_rows.append(block)
        vop.coded[mb] = True

    def _tally(self, workaround: str) -> None:
        """Count a workaround met, under the encoder it was taken for."""
        self.counts[f"{self._bugs[workaround]}_{workaround}"] += 1

    @staticmethod
    def _ac_source(src, nb: int, available: bool, mbq, q: int):
        """A neighbour macroblock's AC predictors: zero from another video
        packet, rescaled from its quantiser to q (libavcodec's ROUNDED_DIV;
        a tuple, where the stored ones are lists)."""
        if not available:
            return _ZERO7
        if mbq[nb] == q:
            return src
        return tuple(_rounded_div(v * mbq[nb], q) for v in src)

    def _partitioned(self, b: _Bits, vop: _Vop) -> None:
        """The macroblocks of a data-partitioned I- or P-VOP, packet by
        packet: modes, DCs (I) or vectors (P) up to the DC or motion
        marker, then the AC prediction flags, CBPY, dquant and (P) intra
        DCs, then the coefficients."""
        vol, counts = self.vol, self.counts
        mb_w, n_mb = vol.mb_w, vol.mb_w * vol.mb_h
        p_vop = vop.kind
        marker_bits, marker, stuffing = (17, _MOTION_MARKER, 10) if p_vop else (19, _DC_MARKER, 9)
        mb = 0
        while mb < n_mb:
            if mb:
                found = self._resync(b, vop)
                if found is None or found[0] != mb:
                    raise ValueError(f"corrupt MPEG-4 VOP: no video packet where macroblock {mb} begins")
                self._start_packet(b, vop, *found)
            counts["partition_packet"] += 1
            heads = []  # each macroblock's MCBPC (None: skipped) and, in an I-VOP, its DCs
            while True:  # the first partition
                if b.peek(marker_bits) == marker:
                    break
                if mb + len(heads) >= n_mb or b.pos >= b.end:
                    raise ValueError("corrupt MPEG-4 VOP: no DC or motion marker")
                at = mb + len(heads)
                mby, mbx = divmod(at, mb_w)
                if p_vop:
                    if b.bit():
                        self._skip(vop, at)
                        heads.append(None)
                        continue
                    hit = _LUT_INTER_MCBPC[b.peek(13)]
                    if hit is None:
                        raise ValueError(f"corrupt MPEG-4 VOP: bad MCBPC at macroblock {at}")
                    b.pos += hit[1]
                    if hit[0] == 20:  # stuffing: the marker may follow
                        continue
                    cbpc = hit[0]
                    if not cbpc & 4:
                        self._p_vectors(b, vop, at, mbx, mby, cbpc & 16)
                    heads.append([cbpc])
                    continue
                if b.peek(9) == 1:  # stuffing
                    b.pos += 9
                    continue
                cbpc = self._mcbpc(b, vop, at)
                if cbpc & 8:
                    self._dquant(b, vop, 1)
                vop.mbq[at] = vop.q
                heads.append([cbpc] + self._partition_dcs(b, vop, at, mbx, mby))
            if not heads:
                raise ValueError("corrupt MPEG-4 VOP: an empty video packet")
            while b.peek(stuffing) == 1:
                b.pos += stuffing
            if b.read(marker_bits) != marker:
                raise ValueError("corrupt MPEG-4 VOP: no DC or motion marker")
            for k, head in enumerate(heads):  # the second partition
                at = mb + k
                if head is None:
                    vop.mbq[at] = vop.q
                    continue
                cbpc = head[0]
                if not p_vop:
                    head.append(b.bit())
                    head.append(self._cbpy(b, at, 1) << 2 | cbpc & 3)
                    continue
                intra = cbpc & 4
                ac_pred = b.bit() if intra else 0
                cbp = self._cbpy(b, at, intra) << 2 | cbpc & 3
                if cbpc & 8:
                    self._dquant(b, vop, intra)
                vop.mbq[at] = vop.q
                if intra:
                    mby, mbx = divmod(at, mb_w)
                    head += self._partition_dcs(b, vop, at, mbx, mby)
                head += [ac_pred, cbp]
            for k, head in enumerate(heads):  # the coefficients
                at = mb + k
                if head is None:
                    continue
                vop.q = vop.mbq[at]
                cbpc, ac_pred, cbp = head[0], head[-2], head[-1]
                if cbpc & 4:
                    mby, mbx = divmod(at, mb_w)
                    if p_vop:
                        counts["intra_mb_in_p"] += 1
                    self._intra_mb(b, vop, at, mbx, mby, cbp, ac_pred, True, head[1], head[2])
                else:
                    self._inter_blocks(b, vop, at, cbp)
            mb += len(heads)

    def _partition_dcs(self, b: _Bits, vop: _Vop, mb: int, mbx: int, mby: int) -> list:
        """An intra macroblock's six DCs in a data partition: [levels as its
        coefficients get them back from the stored DC, (plane, grid index,
        scale, from the top) of each block]."""
        levels, where = [], []
        for n in range(6):
            plane, at, top, scale, pred = self._dc_pred(vop, n, mb, mbx, mby)
            level = self._dc_level(b, n, mb) + pred
            if level < 0:
                raise ValueError(f"corrupt MPEG-4 VOP: a negative intra DC at macroblock {mb}")
            self._store_dc(vop, plane, at, level, scale)
            levels.append((vop.dc[plane][at] + (scale >> 1)) // scale)
            where.append((plane, at, scale, top))
        return [levels, where]

    # ------------------------------------------------------------ pictures

    def _reconstruct(self, vop: _Vop, rounding: int):
        """The VOP's planes: every block dequantised and through the IDCT at
        once, every macroblock's prediction in a few gathers."""
        vol = self.vol
        mb_w, mb_h = vol.mb_w, vol.mb_h
        n_mb = mb_w * mb_h
        levels = vop.levels
        if vop.idx:
            levels.reshape(-1)[np.asarray(vop.idx, np.int64)] = vop.val
        if vop.intra_at:
            levels.reshape(-1, 64)[np.asarray(vop.intra_at, np.int64)] = vop.intra_rows
        intra = np.frombuffer(bytes(vop.mb_kind), np.uint8) == 2
        res = np.zeros((n_mb, 6, 8, 8), np.int32)
        work = np.nonzero(vop.coded.any(1))[0]
        if work.size:
            lv = levels[work].astype(np.int64)
            q = np.asarray(vop.mbq, np.int64)[work][:, None, None]
            iw = intra[work][:, None, None]
            if vol.quant_type:  # MPEG: by the matrices; coded inter blocks get the mismatch control
                mag = np.abs(lv)
                w = np.where(iw, vol.intra_matrix, vol.inter_matrix)
                deq = np.where(iw, (mag * 2 * q * w) >> 4, ((2 * mag + 1) * 2 * q * w) >> 5)
                deq = np.where(lv < 0, -deq, np.where(lv > 0, deq, 0))
                toggle = vop.coded[work] & ~iw[..., 0] & ((deq.sum(-1) & 1) == 0)
                deq[..., 63] ^= toggle
            else:  # H.263; an inter level an escape 3 coded is saturated to 12 bits
                qmul, qadd = 2 * q, (q - 1) | 1
                deq = np.where(lv > 0, lv * qmul + qadd, np.where(lv < 0, lv * qmul - qadd, 0))
                if vop.esc3:
                    at = np.asarray(vop.esc3, np.int64)
                    rows = np.searchsorted(work, at // 384)
                    sub = deq.reshape(len(work), -1)
                    sub[rows, at % 384] = np.clip(sub[rows, at % 384], -2048, 2047)
            mq = q[:, 0, 0]
            if vop.dc_scales is not None:
                ys, cs = np.asarray(vop.dc_scales[0])[mq], np.asarray(vop.dc_scales[1])[mq]
            else:
                ys, cs = (np.full_like(mq, 8),) * 2 if vop.h263 else (np.asarray(_Y_SCALE)[mq], np.asarray(_C_SCALE)[mq])
            deq[:, :4, 0] = np.where(iw[:, :, 0], lv[:, :4, 0] * ys[:, None], deq[:, :4, 0])
            deq[:, 4:, 0] = np.where(iw[:, :, 0], lv[:, 4:, 0] * cs[:, None], deq[:, 4:, 0])
            res[work] = self._transform(vop, work, deq.reshape(-1, 6, 8, 8))
        pred_y = np.zeros((n_mb, 16, 16), np.int32)
        pred_c = np.zeros((n_mb, 2, 8, 8), np.int32)
        moving = [m for m in range(n_mb) if vop.motion[m] is not None]
        if moving:
            refs = (self._past, self._future) if vop.kind == 2 else (self._future, None)
            count = np.zeros(n_mb, np.int32)
            for d, ref in enumerate(refs):
                sel = [m for m in moving if vop.motion[m][0] >> d & 1]
                if not sel:
                    continue
                py, pc = self._predict(ref.planes, np.asarray(sel, np.int64),
                                       np.asarray([vop.motion[m][1] for m in sel], bool),
                                       np.asarray([vop.motion[m][2 + d] for m in sel], np.int64),
                                       rounding if vop.kind == 1 else 0)
                pred_y[sel] += py
                pred_c[sel] += pc
                count[sel] += 1
            both = count == 2  # B-VOP interpolation: the rounded mean of the two
            pred_y[both] = (pred_y[both] + 1) >> 1
            pred_c[both] = (pred_c[both] + 1) >> 1
        # assemble: intra blocks are their IDCT, the rest prediction plus residual
        luma = res[:, :4].reshape(n_mb, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4).reshape(n_mb, 16, 16)
        y = np.clip(pred_y + luma, 0, 255).astype(np.uint8)
        c = np.clip(pred_c + res[:, 4:], 0, 255).astype(np.uint8)
        y = y.reshape(mb_h, mb_w, 16, 16).transpose(0, 2, 1, 3).reshape(16 * mb_h, 16 * mb_w)
        u = c[:, 0].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3).reshape(8 * mb_h, 8 * mb_w)
        v = c[:, 1].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3).reshape(8 * mb_h, 8 * mb_w)
        return y, u, v

    def _transform(self, vop: _Vop, work: np.ndarray, deq: np.ndarray) -> np.ndarray:
        """The residual (n, 6, 8, 8) of the dequantised blocks of the macroblocks `work`."""
        return (xvid_idct if "xvid_idct" in self._bugs else simple_idct)(deq)

    def _predict(self, planes, sel: np.ndarray, four: np.ndarray, vec: np.ndarray, rounding: int):
        """(n, 16, 16) luma and (n, 2, 8, 8) chroma predictions of the
        macroblocks `sel` from a reference's planes: 16x16 or (`four`) four
        8x8 vectors each, half- or quarter-pel as the VOL says."""
        vol, counts = self.vol, self.counts
        mb_w = vol.mb_w
        if "edge" in self._bugs:
            ew, eh = vol.width, vol.height  # libavcodec's edge workaround: the picture's own edge
            self._tally("edge")
        else:
            ew, eh = 16 * mb_w, 16 * vol.mb_h
        ry, ru, rv = planes[0][:eh, :ew], planes[1][:eh >> 1, :ew >> 1], planes[2][:eh >> 1, :ew >> 1]
        chroma_bug = 2 if "qpel_chroma2" in self._bugs else int("qpel_chroma" in self._bugs)
        old = "std_qpel" in self._bugs
        qp = vol.quarter_sample
        n = len(sel)
        mbx, mby = sel % mb_w, sel // mb_w
        py = np.empty((n, 16, 16), np.int32)
        pc = np.empty((n, 2, 8, 8), np.int32)
        shift, frac = (2, 3) if qp else (1, 1)
        one = np.nonzero(~four)[0]
        if one.size:
            mx, my = vec[one, 0, 0], vec[one, 0, 1]
            sx, sy = 16 * mbx[one] + (mx >> shift), 16 * mby[one] + (my >> shift)
            if ((sx < 0) | (sy < 0) | (sx + 16 + (mx & frac > 0) > ew) | (sy + 16 + (my & frac > 0) > eh)).any():
                counts["mv_past_edge"] += 1
            if qp:
                py[one] = mc.qpel(ry, sx, sy, mx & 3, my & 3, 16, rounding, old)
                if old and (mx & my & 1 | mx & 1 & my >> 1).any():
                    self._tally("std_qpel")
                if chroma_bug:
                    self._tally(("qpel_chroma", "qpel_chroma2")[chroma_bug - 1])
                (cx, cfx), (cy, cfy) = mc.chroma_qpel(mx, chroma_bug), mc.chroma_qpel(my, chroma_bug)
            else:
                py[one] = mc.halfpel(ry, sx, sy, mx & 1, my & 1, 16, rounding)
                (cx, cfx), (cy, cfy) = mc.chroma_halfpel(mx), mc.chroma_halfpel(my)
            for k, ref in enumerate((ru, rv)):
                pc[one, k] = mc.halfpel(ref, 8 * mbx[one] + cx, 8 * mby[one] + cy, cfx, cfy, 8, rounding)
        many = np.nonzero(four)[0]
        if many.size:
            v = vec[many]
            mx, my = v[..., 0], v[..., 1]
            blk = np.arange(4)
            sx, fx = mc.clip_8x8(16 * mbx[many, None] + 8 * (blk & 1) + (mx >> shift), mx & frac, -16, vol.width, frac)
            sy, fy = mc.clip_8x8(16 * mby[many, None] + 8 * (blk >> 1) + (my >> shift), my & frac, -16, vol.height,
                                 frac)
            if ((sx < 0) | (sy < 0) | (sx + 8 + (fx > 0) > ew) | (sy + 8 + (fy > 0) > eh)).any():
                counts["mv_past_edge"] += 1
            if qp:
                blocks = mc.qpel(ry, sx.ravel(), sy.ravel(), fx.ravel(), fy.ravel(), 8, rounding, old)
                if old and (fx & fy & 1 | fx & 1 & fy >> 1).any():
                    self._tally("std_qpel")
            else:
                blocks = mc.halfpel(ry, sx.ravel(), sy.ravel(), fx.ravel(), fy.ravel(), 8, rounding)
            py[many] = blocks.reshape(-1, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4).reshape(-1, 16, 16)
            if qp:  # libavcodec sums the quarter-pel vectors halved toward zero
                mx, my = np.where(mx < 0, -((-mx) >> 1), mx >> 1), np.where(my < 0, -((-my) >> 1), my >> 1)
            (cx, cfx), (cy, cfy) = mc.chroma_4mv(mx.sum(1)), mc.chroma_4mv(my.sum(1))
            csx, cfx = mc.clip_8x8(8 * mbx[many] + cx, cfx, -8, vol.width >> 1, 1)
            csy, cfy = mc.clip_8x8(8 * mby[many] + cy, cfy, -8, vol.height >> 1, 1)
            for k, ref in enumerate((ru, rv)):
                pc[many, k] = mc.halfpel(ref, csx, csy, cfx, cfy, 8, rounding)
        return py, pc

    def _tcoef(self, b: _Bits, lut, maxes, i: int, scan, base: int, idx, val, block, esc3) -> None:
        """One block's TCOEF events from scan position i + 1: levels into
        block (intra, quantised) or idx/val (inter, at base; `esc3` gets the
        flat index of each level an escape 3 coded)."""
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
            third = False
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
                    third = True
            b.pos = p
            i += run + 1
            if i > 63:
                raise ValueError("corrupt MPEG-4 VOP: more than 64 coefficients in a block")
            if block is not None:
                block[scan[i]] = level
            else:
                idx.append(base + scan[i])
                val.append(level)
                if third:
                    esc3.append(base + scan[i])
            if last:
                return


_ZERO4 = [(0, 0)] * 4
_ZERO7 = [0] * 7


def decode_packets(decoder: "Mpeg4Decoder", packets, rgb: bool, path):
    """The frames of `packets` through `decoder` in display order, RGB or
    BGR (by the decoder's `yuv_coeffs` where it has them), the one held
    back flushed at the end; errors name `path`."""
    def frames():
        for data in packets:
            yield decoder.decode(data)
        yield decoder.flush()

    try:
        for planes in frames():
            if planes is not None:
                bgr = yuv420_to_bgr(*planes, getattr(decoder, "yuv_coeffs", BT601))
                yield np.ascontiguousarray(bgr[..., ::-1]) if rgb else bgr
    except (NotImplementedError, ValueError) as exc:
        raise type(exc)(f"{path}: {exc}") from exc


class Mpeg4Track:
    """What every container's reader shares once it has found an MPEG-4
    track: `path`, `config` (the container's decoder configuration),
    `fourcc`, `width`, `height`, `fps`, `frame_count` and `packets()` come
    from the container."""

    fourcc = ""
    counts: Counter  # the last `read()`'s decoder tallies (the tests read them)

    def _vol(self) -> Optional[Vol]:
        """The video object layer header: from the configuration, else the
        first packet (None for the short video header, which has none); a
        VOL the port refuses raises here, before any frame is read."""
        try:
            return find_vol(self.config, next(self.packets(), b""))
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
