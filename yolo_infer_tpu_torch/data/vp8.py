"""VP8 (RFC 6386) decoding in numpy: the frames inside lossy WebP files and WebM video.

`Vp8Decoder.decode(frame)` takes one compressed frame and returns its Y, U
and V planes, cropped to the picture's size, or None for a frame that is
not shown. The decoder keeps the state that VP8 carries from frame to
frame: the last, golden and altref references, the probabilities, the
segmentation and the loop filter deltas.

Decoded, as far as the committed fixtures reach (`counts` tallies each
case; the tests list what the fixtures meet):

  header      the frame tag (key and inter frames, versions 0-3, shown and
              hidden frames), the key frame's start code and size,
              segmentation (a map in every frame, its tree probabilities,
              quantiser and filter levels in absolute or delta form), the
              loop filter (simple or normal, level, sharpness, reference
              and mode deltas), 1 or 8 token partitions (2 and 4 take the
              same path), the quantiser indices and their five deltas, the
              reference refresh flags, the altref copied from golden and
              its sign bias, `refresh_entropy_probs` (the probabilities
              saved and restored), the coefficient and motion vector
              probability updates, the skip probability or its absence,
              and the intra and reference probabilities of inter frames
  modes       key frame y modes and B_PRED submodes in context
              (`kf_bmode_probs`); inter frames' intra modes without
              context; inter modes by the near-vector search (sign bias
              inversion, the merge of equal vectors, the mode contexts),
              clamped NEAREST/NEAR/best vectors, new vectors (short tree,
              long form with bit 3's rule) and SPLITMV with its four
              partitionings and the left/above sub-vector contexts
  residual    tokens with band and neighbour contexts (the Y2 context
              kept apart), the categories' extra bits, dequantisation with
              the Y2 and UV rules (int16 storage), the inverse WHT and
              IDCT (20091 and 35468)
  prediction  16x16, 8x8 chroma and 4x4 intra prediction with the edge
              values 127 and 129 and the above-right rule; the 6-tap
              filters (version 0), bilinear (1 and 2) and whole-pixel
              chroma (3), each block's source clamped into the frame at
              any distance (edge replication), split chroma vectors summed
              and rounded as libavcodec rounds them
  loop filter the simple and the normal filter in raster order, with
              per-macroblock levels from segment and deltas, inner edges
              skipped where a macroblock has no coefficients and is not
              B_PRED or SPLITMV

What no fixture reaches raises `NotImplementedError` citing ROADMAP Queue 1
item 11.2 (`UNREACHED`): colour space 1, clamping_type 1, the scale bits,
a segment map kept from an earlier frame, the golden copied from last or
altref and the altref from last, golden's sign bias, and updates of the
intra mode probabilities. `check_stream` finds them in the headers of a
whole stream before any frame is decoded; `decode` raises on such a
frame's header. A corrupt frame raises `ValueError`. Data read past the
end of a partition is zeros, as libavcodec reads it.

The bool decoder keeps its window in a Python int (`_Bool`); the token
loop inlines it. Modes and tokens are parsed for the whole frame first,
then every block's inverse transform runs at once, inter macroblocks are
predicted in one gather per plane, intra macroblocks follow in raster
order, and the loop filter runs a wavefront of macroblocks at a time.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from yolo_infer_tpu_torch.data import vp8_tables as _T
from yolo_infer_tpu_torch.data.mpeg4 import yuv420_to_bgr

_ROADMAP = "ROADMAP Queue 1 item 11.2"

# syntax the decoder parses but no committed fixture reaches (by its `counts`
# name): a frame that needs one raises before its pixels are made
UNREACHED: Dict[str, str] = {
    "color_space_1": "colour space 1 (reserved)",
    "clamping_off": "clamping_type 1 (pixel values need no clamping)",
    "scale_bits": "upscaling bits in its key frame header",
    "segment_map_kept": "segmentation on a map kept from an earlier frame",
    "copy_golden_1": "the golden reference copied from the last frame",
    "copy_golden_2": "the golden reference copied from the altref",
    "copy_altref_1": "the altref copied from the last frame",
    "sign_bias_golden": "a sign bias on the golden reference",
    "ymode_prob_update": "an update of the intra y mode probabilities",
    "uv_mode_prob_update": "an update of the intra chroma mode probabilities",
}

# ------------------------------------------------------------------ tables

_NORM = [max(0, 8 - n.bit_length()) for n in range(256)]  # the shift that brings a range back to >= 128

DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED = range(5)
ZEROMV, NEARESTMV, NEARMV, NEWMV, SPLITMV = range(5, 10)
MODE_NAMES = ("DC", "V", "H", "TM", "B_PRED", "ZERO", "NEAREST", "NEAR", "NEW", "SPLIT")
B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU = range(10)

_KF_YMODE_TREE = (-B_PRED, 2, 4, 6, -DC_PRED, -V_PRED, -H_PRED, -TM_PRED)
_KF_YMODE_PROBS = (145, 156, 163, 128)
_YMODE_TREE = (-DC_PRED, 2, 4, 6, -V_PRED, -H_PRED, -TM_PRED, -B_PRED)
_YMODE_PROBS = (112, 86, 140, 37)
_UV_MODE_TREE = (-DC_PRED, 2, -V_PRED, 4, -H_PRED, -TM_PRED)
_KF_UV_MODE_PROBS = (142, 114, 183)
_UV_MODE_PROBS = (162, 101, 204)
_BMODE_TREE = (-B_DC, 2, -B_TM, 4, -B_VE, 6, 8, 12, -B_HE, 10, -B_RD, -B_VR, -B_LD, 14, -B_VL, 16, -B_HD, -B_HU)
_BMODE_PROBS = (120, 90, 79, 133, 87, 85, 80, 111, 151)
_SEGMENT_TREE = (2, 4, -0, -1, -2, -3)
_IMPLIED_BMODE = (B_DC, B_VE, B_HE, B_TM)  # the submode a 16x16 mode stands for in key frame contexts
_KF_BMODE = [[list(_T.KF_BMODE_PROBS[(a * 10 + b) * 9:(a * 10 + b) * 9 + 9]) for b in range(10)] for a in range(10)]

_MODE_CONTEXTS = ((7, 1, 1, 143), (14, 18, 14, 107), (135, 64, 57, 68), (60, 56, 128, 65), (159, 134, 128, 34),
                  (234, 188, 128, 28))
_MV_DEFAULT = ((162, 128, 225, 146, 172, 147, 214, 39, 156, 128, 129, 132, 75, 145, 178, 206, 239, 254, 254),
               (164, 128, 204, 170, 119, 235, 140, 230, 228, 128, 130, 130, 74, 148, 180, 203, 236, 254, 254))
_MV_UPDATE = ((237, 246, 253, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 250, 250, 252, 254, 254),
              (231, 243, 245, 253, 254, 254, 254, 254, 254, 254, 254, 254, 254, 254, 251, 251, 254, 254, 254))
_SPLIT_PROBS = (110, 111, 150)
_SUBMV_PROBS = ((147, 136, 18), (106, 145, 1), (179, 121, 1), (223, 1, 34), (208, 1, 1))
# partition of each 4x4 block, and each partition's first block, by partitioning (16x8, 8x16, 8x8, 4x4)
_SPLITS = ((0,) * 8 + (1,) * 8, (0, 0, 1, 1) * 4, (0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3), tuple(range(16)))
_FIRST = ((0, 8), (0, 2), (0, 2, 8, 10), tuple(range(16)))
_SPLIT_NAMES = ("16x8", "8x16", "8x8", "4x4")

_ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 7)  # position 16 is read past the last coefficient
# the coefficient token tree (RFC 6386 13.2): a leaf is -token, DCT_0 = 0, EOB = 11
_EOB = 11
_COEF_TREE = (-_EOB, 2, -0, 4, -1, 6, 8, 12, -2, 10, -3, -4, 14, 16, -5, -6, 18, 20, -7, -8, -9, -10)
_CAT_PROBS = ((159,), (165, 145), (173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
              (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
_CAT_BASE = (5, 7, 11, 19, 35, 67)
_DC_Q = _T.DC_QLOOKUP
_AC_Q = _T.AC_QLOOKUP

# 6-tap subpixel filters by eighth-pel offset (version 0), and the bilinear ones as 6 taps
_SIXTAP = np.array([[0, 0, 128, 0, 0, 0], [0, -6, 123, 12, -1, 0], [2, -11, 108, 36, -8, 1], [0, -9, 93, 50, -6, 0],
                    [3, -16, 77, 77, -16, 3], [0, -6, 50, 93, -9, 0], [1, -8, 36, 108, -11, 2],
                    [0, -1, 12, 123, -6, 0]], np.int32)
_BILINEAR = np.array([[0, 0, 128 - 16 * k, 16 * k, 0, 0] for k in range(8)], np.int32)

_HEV_KEY = [0 if lv < 15 else 1 if lv < 40 else 2 for lv in range(64)]
_HEV_INTER = [0 if lv < 15 else 1 if lv < 20 else 2 if lv < 40 else 3 for lv in range(64)]


# ------------------------------------------------------------ bool decoder


class _Bool:
    """RFC 6386's boolean entropy decoder. The window `val` holds the
    current byte above `nb` further bits; bytes arrive 4 at a time
    (`words`, big-endian), zeros past the end."""

    __slots__ = ("words", "k", "val", "rng", "nb")

    def __init__(self, data: bytes):
        rest = data[2:]
        self.words = np.frombuffer(rest + bytes(-len(rest) % 4), ">u4").tolist()
        self.k = 0
        self.val = int.from_bytes(data[:2].ljust(2, b"\0"), "big")
        self.rng = 255
        self.nb = 8

    def bool(self, prob: int) -> int:
        split = 1 + (((self.rng - 1) * prob) >> 8)
        big = split << self.nb
        if self.val >= big:
            self.rng -= split
            self.val -= big
            bit = 1
        else:
            self.rng = split
            bit = 0
        s = _NORM[self.rng]
        if s:
            self.rng <<= s
            self.nb -= s
            if self.nb < 0:
                k = self.k
                self.val = (self.val << 32) | (self.words[k] if k < len(self.words) else 0)
                self.k = k + 1
                self.nb += 32
        return bit

    def lit(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bool(128)
        return v

    def sint(self, n: int) -> int:
        v = self.lit(n)
        return -v if self.bool(128) else v

    def flag_sint(self, n: int) -> int:
        """An optional signed field: a flag, then magnitude and sign (0 if absent)."""
        return self.sint(n) if self.bool(128) else 0

    def tree(self, tree, probs) -> int:
        node = 0
        while True:
            node = tree[node + self.bool(probs[node >> 1])]
            if node <= 0:
                return -node


# ------------------------------------------------------------------ tokens


def _block_order(has_y2: bool):
    """(block, type, first coefficient, top context, left context, quantiser) in token order."""
    first, ytype = (1, 0) if has_y2 else (0, 3)
    order = ((24, 1, 0, 8, 8, 1),) if has_y2 else ()
    order += tuple((b, ytype, first, b & 3, b >> 2, 0) for b in range(16))
    order += tuple((16 + b, 2, 0, 4 + (b & 1), 4 + (b >> 1), 2) for b in range(4))
    return order + tuple((20 + b, 2, 0, 6 + (b & 1), 6 + (b >> 1), 2) for b in range(4))


_ORDER_Y2, _ORDER_NO_Y2 = _block_order(True), _block_order(False)


def _mb_tokens(br: _Bool, probs, has_y2: bool, top: List[int], left: List[int], q, out_pos: List[int],
               out_val: List[int], base: int) -> bool:
    """One macroblock's coefficient tokens (Y2 first if it has one, then 16
    Y, 4 U and 4 V blocks): dequantised values go to out_pos/out_val at
    base + block * 16 + raster index. top/left are the 9 non-zero
    contexts (4 Y, 2 U, 2 V, Y2) of the macroblock above and to the left,
    updated in place. True if any block coded a token."""
    val, rng, nb, words, k = br.val, br.rng, br.nb, br.words, br.k
    nw = len(words)
    norm, tree, zz = _NORM, _COEF_TREE, _ZIGZAG
    any_coded = False
    for block, btype, i, tx, ly, qsel in _ORDER_Y2 if has_y2 else _ORDER_NO_Y2:
        qdc, qac = q[qsel]
        pb = probs[btype]
        p = pb[i][top[tx] + left[ly]]
        node = 0
        coded = False
        at = base + block * 16
        while i < 16:
            while True:  # walk the token tree from `node`
                split = 1 + (((rng - 1) * p[node >> 1]) >> 8)
                big = split << nb
                if val >= big:
                    rng -= split
                    val -= big
                    node = tree[node + 1]
                else:
                    rng = split
                    node = tree[node]
                s = norm[rng]
                if s:
                    rng <<= s
                    nb -= s
                    if nb < 0:
                        val = (val << 32) | (words[k] if k < nw else 0)
                        k += 1
                        nb += 32
                if node <= 0:
                    break
            tok = -node
            if tok == _EOB:
                break
            coded = True
            if tok == 0:
                i += 1
                if i < 16:
                    p = pb[i][0]
                node = 2  # no EOB straight after a zero
                continue
            if tok <= 4:
                v = tok
            else:
                v = 0
                for prob in _CAT_PROBS[tok - 5]:
                    split = 1 + (((rng - 1) * prob) >> 8)
                    big = split << nb
                    if val >= big:
                        rng -= split
                        val -= big
                        v = (v << 1) | 1
                    else:
                        rng = split
                        v <<= 1
                    s = norm[rng]
                    if s:
                        rng <<= s
                        nb -= s
                        if nb < 0:
                            val = (val << 32) | (words[k] if k < nw else 0)
                            k += 1
                            nb += 32
                v += _CAT_BASE[tok - 5]
            split = 1 + ((rng - 1) >> 1)  # the sign, at probability 128
            big = split << nb
            if val >= big:
                rng -= split
                val -= big
                v = -v
            else:
                rng = split
            s = norm[rng]
            if s:
                rng <<= s
                nb -= s
                if nb < 0:
                    val = (val << 32) | (words[k] if k < nw else 0)
                    k += 1
                    nb += 32
            out_pos.append(at + zz[i])
            out_val.append(v * (qac if i else qdc))
            i += 1
            if i < 16:
                p = pb[i][1 if v == 1 or v == -1 else 2]
            node = 0
        top[tx] = left[ly] = int(coded)
        any_coded |= coded
    br.val, br.rng, br.nb, br.k = val, rng, nb, k
    return any_coded


# --------------------------------------------------------------- transforms


def _wrap16(a: np.ndarray) -> np.ndarray:
    return a.astype(np.int16).astype(np.int32)


def _mul20091(a):
    return ((a * 20091) >> 16) + a


def _mul35468(a):
    return (a * 35468) >> 16


def inverse_dct(blocks: np.ndarray) -> np.ndarray:
    """The VP8 inverse DCT of (..., 4, 4) dequantised coefficients (raster
    order): (..., 4, 4) residuals, (x + 4) >> 3 of the second pass."""
    x = blocks.astype(np.int32)
    r0, r1, r2, r3 = x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]
    a, b = r0 + r2, r0 - r2
    c = _mul35468(r1) - _mul20091(r3)
    d = _mul20091(r1) + _mul35468(r3)
    v = _wrap16(np.stack([a + d, b + c, b - c, a - d], -2))  # rows of the vertical pass (int16 in libavcodec)
    c0, c1, c2, c3 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    a, b = c0 + c2, c0 - c2
    c = _mul35468(c1) - _mul20091(c3)
    d = _mul20091(c1) + _mul35468(c3)
    return np.stack([a + d + 4, b + c + 4, b - c + 4, a - d + 4], -1) >> 3


def inverse_wht(dc: np.ndarray) -> np.ndarray:
    """The inverse Walsh-Hadamard transform of (..., 4, 4) Y2 coefficients:
    (..., 4, 4) DC values of the 16 Y blocks, by block row and column."""
    x = dc.astype(np.int32)
    r0, r1, r2, r3 = x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]
    t0, t1, t2, t3 = r0 + r3, r1 + r2, r1 - r2, r0 - r3
    v = _wrap16(np.stack([t0 + t1, t3 + t2, t0 - t1, t3 - t2], -2))
    c0, c1, c2, c3 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    t0, t1, t2, t3 = c0 + c3 + 3, c1 + c2, c1 - c2, c0 - c3 + 3
    return np.stack([t0 + t1, t3 + t2, t0 - t1, t3 - t2], -1) >> 3


# ---------------------------------------------------------- intra prediction


def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _predict_4x4(mode: int, A: List[int], L: List[int], P: int) -> List[List[int]]:
    """A 4x4 intra prediction [row][col] from the 8 pixels above (4 above,
    4 above-right), the 4 to the left and the one above-left."""
    if mode == B_DC:
        v = (sum(A[:4]) + sum(L) + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if mode == B_TM:
        return [[min(255, max(0, L[r] + A[c] - P)) for c in range(4)] for r in range(4)]
    if mode == B_VE:
        row = [_avg3(P if c == 0 else A[c - 1], A[c], A[c + 1]) for c in range(4)]
        return [list(row) for _ in range(4)]
    if mode == B_HE:
        e = [P] + L + [L[3]]
        return [[_avg3(e[r], e[r + 1], e[r + 2])] * 4 for r in range(4)]
    B = [[0] * 4 for _ in range(4)]
    if mode == B_LD:
        for r in range(4):
            for c in range(4):
                i = r + c
                B[r][c] = _avg3(A[i], A[i + 1], A[i + 2]) if i < 6 else _avg3(A[6], A[7], A[7])
        return B
    E = [L[3], L[2], L[1], L[0], P, A[0], A[1], A[2], A[3]]
    if mode == B_RD:
        for r in range(4):
            for c in range(4):
                i = 4 - r + c  # avg3p(E + i) = avg3(E[i-1], E[i], E[i+1])
                B[r][c] = _avg3(E[i - 1], E[i], E[i + 1])
        return B
    if mode == B_VR:
        B[3][0] = _avg3(E[1], E[2], E[3])
        B[2][0] = _avg3(E[2], E[3], E[4])
        B[3][1] = B[1][0] = _avg3(E[3], E[4], E[5])
        B[2][1] = B[0][0] = _avg2(E[4], E[5])
        B[3][2] = B[1][1] = _avg3(E[4], E[5], E[6])
        B[2][2] = B[0][1] = _avg2(E[5], E[6])
        B[3][3] = B[1][2] = _avg3(E[5], E[6], E[7])
        B[2][3] = B[0][2] = _avg2(E[6], E[7])
        B[1][3] = _avg3(E[6], E[7], E[8])
        B[0][3] = _avg2(E[7], E[8])
        return B
    if mode == B_VL:
        B[0][0] = _avg2(A[0], A[1])
        B[1][0] = _avg3(A[0], A[1], A[2])
        B[2][0] = B[0][1] = _avg2(A[1], A[2])
        B[1][1] = B[3][0] = _avg3(A[1], A[2], A[3])
        B[2][1] = B[0][2] = _avg2(A[2], A[3])
        B[3][1] = B[1][2] = _avg3(A[2], A[3], A[4])
        B[2][2] = B[0][3] = _avg2(A[3], A[4])
        B[3][2] = B[1][3] = _avg3(A[3], A[4], A[5])
        B[2][3] = _avg3(A[4], A[5], A[6])
        B[3][3] = _avg3(A[5], A[6], A[7])
        return B
    if mode == B_HD:
        B[3][0] = _avg2(E[0], E[1])
        B[3][1] = _avg3(E[0], E[1], E[2])
        B[2][0] = B[3][2] = _avg2(E[1], E[2])
        B[2][1] = B[3][3] = _avg3(E[1], E[2], E[3])
        B[2][2] = B[1][0] = _avg2(E[2], E[3])
        B[2][3] = B[1][1] = _avg3(E[2], E[3], E[4])
        B[1][2] = B[0][0] = _avg2(E[3], E[4])
        B[1][3] = B[0][1] = _avg3(E[3], E[4], E[5])
        B[0][2] = _avg3(E[4], E[5], E[6])
        B[0][3] = _avg3(E[5], E[6], E[7])
        return B
    # B_HU
    B[0][0] = _avg2(L[0], L[1])
    B[0][1] = _avg3(L[0], L[1], L[2])
    B[0][2] = B[1][0] = _avg2(L[1], L[2])
    B[0][3] = B[1][1] = _avg3(L[1], L[2], L[3])
    B[1][2] = B[2][0] = _avg2(L[2], L[3])
    B[1][3] = B[2][1] = _avg3(L[2], L[3], L[3])
    B[2][2] = B[2][3] = B[3][0] = B[3][1] = B[3][2] = B[3][3] = L[3]
    return B


def _predict_block(plane: np.ndarray, mode: int, y0: int, x0: int, n: int) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma intra prediction at (y0, x0): above edge
    127 on the top row, left edge 129 on the left column."""
    if mode == DC_PRED:
        if y0 and x0:
            total = int(plane[y0 - 1, x0:x0 + n].sum()) + int(plane[y0:y0 + n, x0 - 1].sum())
            v = (total + n) >> (n.bit_length())
        elif y0:
            v = (int(plane[y0 - 1, x0:x0 + n].sum()) + n // 2) >> (n.bit_length() - 1)
        elif x0:
            v = (int(plane[y0:y0 + n, x0 - 1].sum()) + n // 2) >> (n.bit_length() - 1)
        else:
            v = 128
        return np.full((n, n), v, np.int32)
    above = plane[y0 - 1, x0:x0 + n].astype(np.int32) if y0 else np.full(n, 127, np.int32)
    left = plane[y0:y0 + n, x0 - 1].astype(np.int32) if x0 else np.full(n, 129, np.int32)
    if mode == V_PRED:
        return np.broadcast_to(above, (n, n))
    if mode == H_PRED:
        return np.broadcast_to(left[:, None], (n, n))
    corner = 127 if y0 == 0 else 129 if x0 == 0 else int(plane[y0 - 1, x0 - 1])
    return np.clip(left[:, None] + above[None, :] - corner, 0, 255)


# -------------------------------------------------------------- loop filter


def _clamp(v, lo: int, hi: int):
    return np.minimum(np.maximum(v, lo), hi)


def _filter_lines(flat: np.ndarray, idx: np.ndarray, prm: np.ndarray, mbedge: bool, simple: bool) -> None:
    """Filter lines of 8 pixels p3 p2 p1 p0 | q0 q1 q2 q3 across their edge,
    in place: `idx` (n, 8) are their flat indices into `flat`, `prm` (n, 3)
    each line's edge limit, interior limit and hev threshold."""
    v = flat[idx].astype(np.int32)
    e_lim, i_lim, hev_t = prm.T
    p3, p2, p1, p0, q0, q1, q2, q3 = v.T
    mask = (np.abs(p0 - q0) * 2 + (np.abs(p1 - q1) >> 1)) <= e_lim
    c = _clamp
    if simple:
        a = c(c(p1 - q1, -128, 127) + 3 * (q0 - p0), -128, 127)
        f1, f2 = np.minimum(a + 4, 127) >> 3, np.minimum(a + 3, 127) >> 3
        flat[idx[:, 3]] = np.where(mask, c(p0 + f2, 0, 255), p0)
        flat[idx[:, 4]] = np.where(mask, c(q0 - f1, 0, 255), q0)
        return
    d = np.abs(v[:, 1:] - v[:, :-1])  # |p3-p2| |p2-p1| |p1-p0| |p0-q0| |q0-q1| |q1-q2| |q2-q3|
    d[:, 3] = 0
    mask &= d.max(axis=1) <= i_lim
    hev = (d[:, 2] > hev_t) | (d[:, 4] > hev_t)
    # the common filter: 4-tap where hev, else (inner edges) its form without p1 - q1 that also moves p1, q1
    a = c(3 * (q0 - p0) + np.where(hev, c(p1 - q1, -128, 127), 0), -128, 127)
    f1, f2 = np.minimum(a + 4, 127) >> 3, np.minimum(a + 3, 127) >> 3
    out = v[:, 1:7].copy()
    out[:, 2], out[:, 3] = c(p0 + f2, 0, 255), c(q0 - f1, 0, 255)
    soft = mask & ~hev
    if mbedge:  # macroblock edges without hev take the 27/18/9 filter
        w = c(c(p1 - q1, -128, 127) + 3 * (q0 - p0), -128, 127)[soft]
        a0, a1, a2 = (27 * w + 63) >> 7, (18 * w + 63) >> 7, (9 * w + 63) >> 7
        out[soft] = c(np.stack([p2[soft] + a2, p1[soft] + a1, p0[soft] + a0, q0[soft] - a0, q1[soft] - a1,
                                q2[soft] - a2], 1), 0, 255)
    else:
        half = (f1[soft] + 1) >> 1
        out[soft, 1], out[soft, 4] = c(p1[soft] + half, 0, 255), c(q1[soft] - half, 0, 255)
    flat[idx[mask, 1:7]] = out[mask]


_TAP = np.arange(-4, 4, dtype=np.int32)


def _edge_lines(width: int, base: int, y0: np.ndarray, x0: np.ndarray, n: int, offset: int,
                vertical: bool) -> np.ndarray:
    """Flat indices (len(y0), n, 8), from `base`, of the lines across the
    edge `offset` pixels into each n x n block at (y0, x0) of a plane
    `width` wide: a vertical edge's lines are rows, a horizontal edge's
    are columns."""
    along = np.arange(n, dtype=np.int32)
    if vertical:
        rows = (y0[:, None] + along)[:, :, None]
        cols = (x0 + offset)[:, None, None] + _TAP
    else:
        rows = (y0 + offset)[:, None, None] + _TAP
        cols = (x0[:, None] + along)[:, :, None]
    return base + rows * width + cols


def _loop_filter(planes, levels: np.ndarray, inner: np.ndarray, simple: bool, sharpness: int, key: bool) -> None:
    """The loop filter over the whole (macroblock-aligned) frame, in place.
    Raster order's result, computed a wavefront at a time: the macroblocks
    with equal x + 2y touch disjoint pixels, and each one's neighbours
    above, above-right and to the left come from earlier steps. Y, U and
    V share one flat buffer, and each kind of edge (left or top macroblock
    edge, inner edge at 4, 8 or 12) is one call a step over the lines of
    every macroblock in it, their indices and limits laid out beforehand."""
    Y, U, V = planes
    my, mx = (a.astype(np.int32) for a in np.nonzero(levels))
    if not len(my):
        return
    lv = levels[my, mx].astype(np.int32)
    ilim = lv >> ((sharpness + 3) >> 2) if sharpness else lv.copy()
    if sharpness:
        ilim = np.minimum(ilim, 9 - sharpness)
    ilim = np.maximum(ilim, 1)
    hev_t = np.asarray(_HEV_KEY if key else _HEV_INTER, np.int32)[lv]
    inn = inner[my, mx]
    flat = np.concatenate([Y.reshape(-1), U.reshape(-1), V.reshape(-1)])
    u_at, v_at = Y.size, Y.size + U.size
    yw, cw = Y.shape[1], U.shape[1]
    kinds = []  # (vertical, edge offset, the macroblocks that have that edge, lines (mb, L, 8), limits (mb, L, 3))
    for vertical, has_edge in ((True, mx > 0), (False, my > 0)):
        for edge_at in (0, 4, 8, 12):
            lines = [_edge_lines(yw, 0, my * 16, mx * 16, 16, edge_at, vertical)]
            if not simple and edge_at in (0, 4):
                lines += [_edge_lines(cw, base, my * 8, mx * 8, 8, edge_at, vertical) for base in (u_at, v_at)]
            lines = np.concatenate(lines, 1)
            lim = 2 * (lv + 2) + ilim if edge_at == 0 else 2 * lv + ilim
            prm = np.broadcast_to(np.stack([lim, ilim, hev_t], 1)[:, None, :], lines.shape[:2] + (3,))
            kinds.append((edge_at == 0, has_edge if edge_at == 0 else inn, lines, prm))
    step = mx + 2 * my
    order = np.argsort(step, kind="stable")
    for grp in np.split(order, np.flatnonzero(np.diff(step[order])) + 1):
        for mbedge, has, lines, prm in kinds:
            g = grp[has[grp]]
            if len(g):
                _filter_lines(flat, lines[g].reshape(-1, 8), prm[g].reshape(-1, 3), mbedge, simple)
    Y.reshape(-1)[:] = flat[:u_at]
    U.reshape(-1)[:] = flat[u_at:v_at]
    V.reshape(-1)[:] = flat[v_at:]


# ---------------------------------------------------------- inter prediction


def _predict_inter(ref: np.ndarray, ys: np.ndarray, xs: np.ndarray, mvy: np.ndarray, mvx: np.ndarray,
                   shift: int, taps: np.ndarray) -> np.ndarray:
    """4x4 predictions of the blocks at (ys, xs) moved by (mvy, mvx) in
    units of 1/2**shift pixel: the two-pass filter (horizontal, rounded and
    clipped, then vertical) over the reference, every source pixel clamped
    into the plane (edge replication at any distance). -> (n, 4, 4)."""
    h, w = ref.shape
    frac_mask = (1 << shift) - 1
    fx = (mvx & frac_mask) << (3 - shift)
    fy = (mvy & frac_mask) << (3 - shift)
    sx = xs + (mvx >> shift) - 2
    sy = ys + (mvy >> shift) - 2
    off = np.arange(9)
    rows = np.clip(sy[:, None] + off, 0, h - 1)
    cols = np.clip(sx[:, None] + off, 0, w - 1)
    win = ref[rows[:, :, None], cols[:, None, :]].astype(np.int32)  # (n, 9, 9)
    tx, ty = taps[fx], taps[fy]  # (n, 6)
    hp = sum(tx[:, None, None, t] * win[:, :, t:t + 4] for t in range(6))
    hp = np.clip((hp + 64) >> 7, 0, 255)  # (n, 9, 4)
    vp = sum(ty[:, None, None, t] * hp[:, t:t + 4, :] for t in range(6))
    return np.clip((vp + 64) >> 7, 0, 255)


# ------------------------------------------------------------------ decoder


class _Header:
    """The fields of one frame's header that reconstruction reads."""


class Vp8Decoder:
    """Decode VP8 frames in order. `decode(frame)` -> (Y, U, V) uint8 planes
    cropped to the picture, or None for a hidden frame (`show_frame` 0)."""

    def __init__(self):
        self.counts: Counter = Counter()
        self.refs: Optional[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = None  # last, golden, altref
        self.width = self.height = 0
        self.started = False

    # ---------------------------------------------------------- state
    def _reset_probs(self) -> None:
        c = _T.DEFAULT_COEF_PROBS
        self.coef = [[[list(c[((t * 8 + b) * 3 + x) * 11:((t * 8 + b) * 3 + x) * 11 + 11]) for x in range(3)]
                      for b in range(8)] for t in range(4)]
        self.mv_probs = [list(_MV_DEFAULT[0]), list(_MV_DEFAULT[1])]
        self.ymode_probs = list(_YMODE_PROBS)
        self.uv_probs = list(_UV_MODE_PROBS)

    def _save_probs(self):
        return ([[[list(x) for x in b] for b in t] for t in self.coef], [list(m) for m in self.mv_probs],
                list(self.ymode_probs), list(self.uv_probs))

    # ---------------------------------------------------------- frame
    def _frame_header(self, data: bytes):
        """The frame tag, a key frame's size, and the first partition's
        header: (key, version, show, first partition's decoder, header)."""
        if len(data) < 3:
            raise ValueError("a VP8 frame shorter than its frame tag")
        tag = data[0] | data[1] << 8 | data[2] << 16
        key = not (tag & 1)
        version = (tag >> 1) & 7
        show = (tag >> 4) & 1
        first_size = tag >> 5
        pos = 3
        cnt = self.counts
        if key:
            if len(data) < 10 or data[3:6] != b"\x9d\x01\x2a":
                raise ValueError("a VP8 key frame without its start code")
            w, h = (data[6] | data[7] << 8), (data[8] | data[9] << 8)
            if (w >> 14) or (h >> 14):
                cnt["scale_bits"] += 1
            w, h = w & 0x3FFF, h & 0x3FFF
            if not w or not h:
                raise ValueError("a VP8 key frame of size 0")
            pos = 10
            self.width, self.height = w, h
            self.mbw, self.mbh = (w + 15) >> 4, (h + 15) >> 4
            self._reset_probs()
            self.segment_map = np.zeros((self.mbh, self.mbw), np.int8)
            self.seg_enabled, self.seg_abs = False, False
            self.seg_quant, self.seg_lf = [0] * 4, [0] * 4
            self.seg_probs = [255, 255, 255]
            self.lf_deltas_on = False
            self.ref_deltas, self.mode_deltas = [0] * 4, [0] * 4
            self.sign_bias = [0, 0, 0, 0]
            self.started = True
            cnt["key_frame"] += 1
        else:
            if not self.started:
                raise ValueError("a VP8 inter frame before any key frame")
            cnt["inter_frame"] += 1
        cnt[f"version_{version}"] += 1
        if version > 3:
            raise ValueError(f"VP8 version {version} (0-3 are defined)")
        if not show:
            cnt["hidden_frame"] += 1
        if pos + first_size > len(data):
            raise ValueError("a VP8 frame whose first partition runs past its end")
        br = _Bool(data[pos:pos + first_size])
        hdr = self._header(br, key, data, pos + first_size)
        self._check_reached()
        return key, version, show, br, hdr

    def check_stream(self, frames) -> None:
        """Parse the header of every frame (not its macroblocks) and raise
        where `decode` would raise on its header: for syntax `UNREACHED`
        names, before any frame is decoded."""
        for data in frames:
            self._frame_header(data)

    def decode(self, data: bytes) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        key, version, show, br, hdr = self._frame_header(data)
        cnt = self.counts
        modes = self._modes(br, hdr, key)
        coefs, coded = self._tokens(hdr, modes)
        planes = self._reconstruct(modes, coefs, key, version)
        levels, inner = self._filter_levels(hdr, modes, coded)
        if hdr.filter_level:
            cnt["loop_filter_simple" if hdr.simple else "loop_filter_normal"] += 1
            if hdr.sharpness:
                cnt["sharpness"] += 1
            _loop_filter(planes, levels, inner, hdr.simple, hdr.sharpness, key)
        else:
            cnt["loop_filter_off"] += 1
        # references: copies from the old buffers first, then the refresh
        if key:
            self.refs = [planes, planes, planes]
        else:
            last, golden, altref = self.refs
            new_golden = planes if hdr.refresh_golden else {1: last, 2: altref}.get(hdr.copy_golden, golden)
            new_altref = planes if hdr.refresh_altref else {1: last, 2: golden}.get(hdr.copy_altref, altref)
            self.refs = [planes if hdr.refresh_last else last, new_golden, new_altref]
        if not hdr.refresh_probs:
            self.coef, self.mv_probs, self.ymode_probs, self.uv_probs = hdr.saved_probs
        if not show:
            return None
        h, w = self.height, self.width
        Y, U, V = planes
        return Y[:h, :w].copy(), U[:(h + 1) >> 1, :(w + 1) >> 1].copy(), V[:(h + 1) >> 1, :(w + 1) >> 1].copy()

    def _check_reached(self) -> None:
        for name, what in UNREACHED.items():
            if self.counts.get(name):
                raise NotImplementedError(f"a VP8 frame with {what}, which the port does not decode yet "
                                          f"({_ROADMAP})")

    def _header(self, br: _Bool, key: bool, data: bytes, parts_at: int):
        cnt = self.counts
        hdr = _Header()
        if key:
            if br.bool(128):
                cnt["color_space_1"] += 1
            if br.bool(128):
                cnt["clamping_off"] += 1
        self.seg_enabled = bool(br.bool(128))
        hdr.update_map = False
        if self.seg_enabled:
            cnt["segmentation"] += 1
            hdr.update_map = bool(br.bool(128))
            update_data = br.bool(128)
            if update_data:
                self.seg_abs = bool(br.bool(128))
                cnt["segment_abs" if self.seg_abs else "segment_delta"] += 1
                self.seg_quant = [br.flag_sint(7) for _ in range(4)]
                self.seg_lf = [br.flag_sint(6) for _ in range(4)]
            if hdr.update_map:
                cnt["segment_map"] += 1
                self.seg_probs = [br.lit(8) if br.bool(128) else 255 for _ in range(3)]
            else:
                cnt["segment_map_kept"] += 1
        hdr.simple = bool(br.bool(128))
        hdr.filter_level = br.lit(6)
        hdr.sharpness = br.lit(3)
        self.lf_deltas_on = bool(br.bool(128))
        if self.lf_deltas_on:
            cnt["lf_deltas"] += 1
            if br.bool(128):
                cnt["lf_delta_update"] += 1
                for i in range(4):
                    if br.bool(128):
                        self.ref_deltas[i] = br.sint(6)
                for i in range(4):
                    if br.bool(128):
                        self.mode_deltas[i] = br.sint(6)
        nparts = 1 << br.lit(2)
        cnt[f"partitions_{nparts}"] += 1
        # the token partitions: sizes of all but the last, 3 bytes each
        table = parts_at
        at = table + 3 * (nparts - 1)
        if at > len(data):
            raise ValueError("a VP8 frame cut inside its partition sizes")
        hdr.parts = []
        for i in range(nparts):
            if i < nparts - 1:
                size = data[table + 3 * i] | data[table + 3 * i + 1] << 8 | data[table + 3 * i + 2] << 16
                if at + size > len(data):
                    raise ValueError("a VP8 token partition runs past the frame's end")
            else:
                size = len(data) - at
            hdr.parts.append(_Bool(data[at:at + size]))
            at += size
        yac = br.lit(7)
        deltas = [br.flag_sint(4) for _ in range(5)]  # y dc, y2 dc, y2 ac, uv dc, uv ac
        if any(deltas):
            cnt["quant_deltas"] += 1
        hdr.quant = []
        for s in range(4):
            q = yac
            if self.seg_enabled:
                q = self.seg_quant[s] + (0 if self.seg_abs else yac)

            def ix(d):
                return min(127, max(0, q + d))
            hdr.quant.append(((_DC_Q[ix(deltas[0])], _AC_Q[ix(0)]),
                              (_DC_Q[ix(deltas[1])] * 2, max(8, _AC_Q[ix(deltas[2])] * 101581 >> 16)),
                              (min(132, _DC_Q[ix(deltas[3])]), _AC_Q[ix(deltas[4])])))
        hdr.refresh_golden = hdr.refresh_altref = hdr.refresh_last = True
        hdr.copy_golden = hdr.copy_altref = 0
        if not key:
            hdr.refresh_golden = bool(br.bool(128))
            hdr.refresh_altref = bool(br.bool(128))
            if not hdr.refresh_golden:
                hdr.copy_golden = br.lit(2)
            if not hdr.refresh_altref:
                hdr.copy_altref = br.lit(2)
            self.sign_bias[2] = br.bool(128)
            self.sign_bias[3] = br.bool(128)
            for name, on in (("refresh_golden", hdr.refresh_golden), ("refresh_altref", hdr.refresh_altref),
                             (f"copy_golden_{hdr.copy_golden}", hdr.copy_golden),
                             (f"copy_altref_{hdr.copy_altref}", hdr.copy_altref),
                             ("sign_bias_golden", self.sign_bias[2]), ("sign_bias_altref", self.sign_bias[3])):
                if on:
                    cnt[name] += 1
        hdr.refresh_probs = bool(br.bool(128))
        if not hdr.refresh_probs:
            cnt["probs_restored"] += 1
            hdr.saved_probs = self._save_probs()
        if not key:
            hdr.refresh_last = bool(br.bool(128))
            if not hdr.refresh_last:
                cnt["last_kept"] += 1
        upd = _T.COEF_UPDATE_PROBS
        n_upd = 0
        for t in range(4):
            for b in range(8):
                for x in range(3):
                    row = self.coef[t][b][x]
                    o = ((t * 8 + b) * 3 + x) * 11
                    for j in range(11):
                        if br.bool(upd[o + j]):
                            row[j] = br.lit(8)
                            n_upd += 1
        if n_upd:
            cnt["coef_prob_updates"] += 1
        hdr.skip_prob = br.lit(8) if br.bool(128) else None
        if hdr.skip_prob is None:
            cnt["no_skip_flag"] += 1
        if not key:
            hdr.prob_intra = br.lit(8)
            hdr.prob_last = br.lit(8)
            hdr.prob_gf = br.lit(8)
            if br.bool(128):
                cnt["ymode_prob_update"] += 1
                self.ymode_probs = [br.lit(8) for _ in range(4)]
            if br.bool(128):
                cnt["uv_mode_prob_update"] += 1
                self.uv_probs = [br.lit(8) for _ in range(3)]
            n_mv = 0
            for i in range(2):
                for j in range(19):
                    if br.bool(_MV_UPDATE[i][j]):
                        x = br.lit(7)
                        self.mv_probs[i][j] = x << 1 if x else 1
                        n_mv += 1
            if n_mv:
                cnt["mv_prob_updates"] += 1
        return hdr

    # ---------------------------------------------------------- modes
    def _modes(self, br: _Bool, hdr, key: bool) -> Dict[str, np.ndarray]:
        mbh, mbw = self.mbh, self.mbw
        cnt = self.counts
        ymode = np.zeros((mbh, mbw), np.int8)
        uvmode = np.zeros((mbh, mbw), np.int8)
        bmodes = np.zeros((mbh, mbw, 16), np.int8)
        ref = np.zeros((mbh, mbw), np.int8)
        mvs = np.zeros((mbh, mbw, 16, 2), np.int32)  # (row, col) quarter pels of each 4x4 block
        skip = np.zeros((mbh, mbw), bool)
        split = np.full((mbh, mbw), -1, np.int8)
        if hdr.update_map:
            seg = np.zeros((mbh, mbw), np.int8)
        else:
            seg = self.segment_map
        # per macroblock of the row above / the macroblock to the left (None outside the frame or intra)
        mb_mv: List[List[Optional[Tuple[int, int]]]] = [[None] * mbw for _ in range(mbh)]
        bmv: List[List[List[Tuple[int, int]]]] = [[None] * mbw for _ in range(mbh)]  # per-block vectors
        top_b = [[B_DC] * 4 for _ in range(mbw)]  # key frames: submodes above, per column of subblocks
        probs_uv = _KF_UV_MODE_PROBS if key else self.uv_probs
        sign_bias = self.sign_bias
        zero16 = [(0, 0)] * 16
        for my in range(mbh):
            left_b = [B_DC] * 4
            for mx in range(mbw):
                if hdr.update_map:
                    seg[my, mx] = br.tree(_SEGMENT_TREE, self.seg_probs)
                if hdr.skip_prob is not None:
                    skip[my, mx] = br.bool(hdr.skip_prob)
                if key:
                    m = br.tree(_KF_YMODE_TREE, _KF_YMODE_PROBS)
                    ymode[my, mx] = m
                    cnt[f"kf_{MODE_NAMES[m]}"] += 1
                    if m == B_PRED:
                        above = top_b[mx]
                        for b in range(16):
                            sub = br.tree(_BMODE_TREE, _KF_BMODE[above[b & 3]][left_b[b >> 2]])
                            bmodes[my, mx, b] = sub
                            above[b & 3] = left_b[b >> 2] = sub
                            cnt[f"kf_b{sub}"] += 1
                    else:
                        top_b[mx] = [_IMPLIED_BMODE[m]] * 4
                        left_b = [_IMPLIED_BMODE[m]] * 4
                    uvmode[my, mx] = br.tree(_UV_MODE_TREE, probs_uv)
                    bmv[my][mx] = zero16
                    continue
                if not br.bool(hdr.prob_intra):
                    m = br.tree(_YMODE_TREE, self.ymode_probs)
                    ymode[my, mx] = m
                    cnt[f"intra_{MODE_NAMES[m]}"] += 1
                    if m == B_PRED:
                        for b in range(16):
                            sub = br.tree(_BMODE_TREE, _BMODE_PROBS)
                            bmodes[my, mx, b] = sub
                            cnt[f"b{sub}"] += 1
                    uvmode[my, mx] = br.tree(_UV_MODE_TREE, self.uv_probs)
                    bmv[my][mx] = zero16
                    continue
                r = 1
                if br.bool(hdr.prob_last):
                    r = 2 + br.bool(hdr.prob_gf)
                ref[my, mx] = r
                cnt[("", "last", "golden", "altref")[r]] += 1
                # the near-vector search over the macroblocks above, left and above-left
                near = [(0, 0), (0, 0), (0, 0), (0, 0)]
                counts = [0, 0, 0, 0]
                idx = 0
                edges = ((my - 1, mx, 2), (my, mx - 1, 2), (my - 1, mx - 1, 1))
                for n, (ey, ex, weight) in enumerate(edges):
                    if ey < 0 or ex < 0 or mb_mv[ey][ex] is None:
                        continue
                    mv = mb_mv[ey][ex]
                    if mv != (0, 0):
                        if sign_bias[ref[ey, ex]] != sign_bias[r]:
                            mv = (-mv[0], -mv[1])
                        if n == 0 or mv != near[idx]:
                            idx += 1
                            near[idx] = mv
                        counts[idx] += weight
                    else:
                        counts[0] += weight
                lo_y, hi_y = -64 - 64 * my, (mbh - 1 - my) * 64 + 64
                lo_x, hi_x = -64 - 64 * mx, (mbw - 1 - mx) * 64 + 64

                def clamp(v):
                    return (min(hi_y, max(lo_y, v[0])), min(hi_x, max(lo_x, v[1])))
                blocks = None
                if not br.bool(_MODE_CONTEXTS[counts[0]][0]):
                    m, mv = ZEROMV, (0, 0)
                else:
                    if counts[3] and near[1] == near[3]:
                        counts[1] += 1
                    if counts[2] > counts[1]:
                        counts[1], counts[2] = counts[2], counts[1]
                        near[1], near[2] = near[2], near[1]
                    if not br.bool(_MODE_CONTEXTS[counts[1]][1]):
                        m, mv = NEARESTMV, clamp(near[1])
                    elif not br.bool(_MODE_CONTEXTS[counts[2]][2]):
                        m, mv = NEARMV, clamp(near[2])
                    else:
                        best = clamp(near[1] if counts[1] >= counts[0] else near[0])
                        nsplit = 0
                        for ey, ex, weight in ((my, mx - 1, 2), (my - 1, mx, 2), (my - 1, mx - 1, 1)):
                            if ey >= 0 and ex >= 0 and split[ey, ex] >= 0:
                                nsplit += weight
                        if br.bool(_MODE_CONTEXTS[nsplit][3]):
                            m = SPLITMV
                            blocks = self._split_mvs(br, my, mx, best, bmv, split, cnt)
                            mv = blocks[15]
                        else:
                            m = NEWMV
                            mv = (best[0] + self._mv_component(br, 0), best[1] + self._mv_component(br, 1))
                ymode[my, mx] = m
                cnt[MODE_NAMES[m]] += 1
                mb_mv[my][mx] = mv
                bmv[my][mx] = blocks if blocks is not None else [mv] * 16
                mvs[my, mx] = bmv[my][mx]
        if hdr.update_map:
            self.segment_map = seg
        return {"ymode": ymode, "uvmode": uvmode, "bmodes": bmodes, "ref": ref, "mvs": mvs, "skip": skip,
                "split": split, "segment": seg if self.seg_enabled else np.zeros_like(seg)}

    def _mv_component(self, br: _Bool, comp: int) -> int:
        p = self.mv_probs[comp]
        if br.bool(p[0]):
            x = 0
            for i in range(3):
                x += br.bool(p[9 + i]) << i
            for i in range(9, 3, -1):
                x += br.bool(p[9 + i]) << i
            if not (x & 0xFFF0) or br.bool(p[12]):
                x += 8
            self.counts["mv_long"] += 1
        else:
            b = br.bool(p[2])
            at = 3 + 3 * b
            x = 4 * b
            b = br.bool(p[at])
            x += 2 * b
            x += br.bool(p[at + 1 + b])
            self.counts["mv_short"] += 1
        return -x if x and br.bool(p[1]) else x

    def _split_mvs(self, br: _Bool, my: int, mx: int, best, bmv, split, cnt) -> List[Tuple[int, int]]:
        if not br.bool(_SPLIT_PROBS[0]):
            part = 3
        elif not br.bool(_SPLIT_PROBS[1]):
            part = 2
        else:
            part = br.bool(_SPLIT_PROBS[2])
        split[my, mx] = part
        cnt[f"split_{_SPLIT_NAMES[part]}"] += 1
        layout = _SPLITS[part]
        left_mb = bmv[my][mx - 1] if mx else None
        top_mb = bmv[my - 1][mx] if my else None
        out: List[Optional[Tuple[int, int]]] = [None] * 16
        part_mv: List[Tuple[int, int]] = []
        for n, k in enumerate(_FIRST[part]):
            left = (left_mb[k + 3] if left_mb else (0, 0)) if not (k & 3) else out[k - 1]
            above = (top_mb[k + 12] if top_mb else (0, 0)) if k < 4 else out[k - 4]
            if left == above:
                probs = _SUBMV_PROBS[3 if left != (0, 0) else 4]
            elif above == (0, 0):
                probs = _SUBMV_PROBS[2]
            else:
                probs = _SUBMV_PROBS[0 if left != (0, 0) else 1]
            if not br.bool(probs[0]):
                mv = left
                cnt["submv_left"] += 1
            elif not br.bool(probs[1]):
                mv = above
                cnt["submv_above"] += 1
            elif not br.bool(probs[2]):
                mv = (0, 0)
                cnt["submv_zero"] += 1
            else:
                mv = (best[0] + self._mv_component(br, 0), best[1] + self._mv_component(br, 1))
                cnt["submv_new"] += 1
            part_mv.append(mv)
            for b in range(16):
                if layout[b] == n:
                    out[b] = mv
        return out  # every block's vector; block 15 lies in the last partition

    # ---------------------------------------------------------- tokens
    def _tokens(self, hdr, modes):
        mbh, mbw = self.mbh, self.mbw
        probs = [[t[_BANDS[i]] for i in range(17)] for t in self.coef]
        n = mbh * mbw
        pos: List[int] = []
        val: List[int] = []
        coded = np.zeros((mbh, mbw), bool)
        top = [[0] * 9 for _ in range(mbw)]
        ymode, skip, seg = modes["ymode"], modes["skip"], modes["segment"]
        nparts = len(hdr.parts)
        for my in range(mbh):
            br = hdr.parts[my % nparts]
            left = [0] * 9
            for mx in range(mbw):
                m = int(ymode[my, mx])
                has_y2 = m != B_PRED and m != SPLITMV
                t = top[mx]
                if skip[my, mx]:
                    for j in range(8):
                        t[j] = left[j] = 0
                    if has_y2:
                        t[8] = left[8] = 0
                    continue
                coded[my, mx] = _mb_tokens(br, probs, has_y2, t, left, hdr.quant[seg[my, mx]], pos, val,
                                           (my * mbw + mx) * 400)
        coefs = np.zeros(n * 400, np.int32)
        if pos:
            coefs[np.asarray(pos, np.int64)] = np.asarray(val, np.int64)
        return _wrap16(coefs).reshape(mbh, mbw, 25, 4, 4), coded

    # ---------------------------------------------------------- pixels
    def _reconstruct(self, modes, coefs: np.ndarray, key: bool, version: int):
        mbh, mbw = self.mbh, self.mbw
        ymode = modes["ymode"]
        has_y2 = (ymode != B_PRED) & (ymode != SPLITMV)
        if has_y2.any():
            dc = _wrap16(inverse_wht(coefs[has_y2][:, 24]))  # (n, 4, 4) by block row/col
            sub = coefs[has_y2]
            sub[:, :16, 0, 0] = dc.reshape(-1, 16)
            coefs[has_y2] = sub
        res = inverse_dct(coefs[:, :, :24])  # (mbh, mbw, 24, 4, 4)
        ry = res[:, :, :16].reshape(mbh, mbw, 4, 4, 4, 4).transpose(0, 2, 4, 1, 3, 5).reshape(mbh * 16, mbw * 16)
        ru = res[:, :, 16:20].reshape(mbh, mbw, 2, 2, 4, 4).transpose(0, 2, 4, 1, 3, 5).reshape(mbh * 8, mbw * 8)
        rv = res[:, :, 20:24].reshape(mbh, mbw, 2, 2, 4, 4).transpose(0, 2, 4, 1, 3, 5).reshape(mbh * 8, mbw * 8)
        Y = np.zeros((mbh * 16, mbw * 16), np.uint8)
        U = np.zeros((mbh * 8, mbw * 8), np.uint8)
        V = np.zeros((mbh * 8, mbw * 8), np.uint8)
        ref = modes["ref"]
        if not key and (ref > 0).any():
            self._inter(modes, (Y, U, V), (ry, ru, rv), version)
        intra = np.argwhere(ref == 0)
        for my, mx in intra.tolist():
            self._intra_mb(modes, my, mx, (Y, U, V), (ry, ru, rv))
        return Y, U, V

    def _inter(self, modes, planes, residual, version: int) -> None:
        ref, mvs = modes["ref"], modes["mvs"]
        taps = _SIXTAP if version == 0 else _BILINEAR
        cnt = self.counts
        for r in (1, 2, 3):
            sel = np.argwhere(ref == r)
            if not len(sel):
                continue
            src = self.refs[r - 1]
            my, mx = sel[:, 0], sel[:, 1]
            mv = mvs[my, mx]  # (n, 16, 2)
            # luma: 16 4x4 blocks per macroblock
            by = (my[:, None] * 16 + (np.arange(16) >> 2) * 4).reshape(-1)
            bx = (mx[:, None] * 16 + (np.arange(16) & 3) * 4).reshape(-1)
            pred = _predict_inter(src[0], by, bx, mv[..., 0].reshape(-1), mv[..., 1].reshape(-1), 2, taps)
            if (mv & 7).any():
                cnt["subpel"] += 1
            self._place(planes[0], residual[0], pred, by, bx)
            # chroma: 4 4x4 blocks per macroblock, each from its 2x2 luma blocks' vectors
            quad = mv.reshape(-1, 2, 2, 2, 2, 2).sum(axis=(2, 4))  # (n, 2, 2, 2): block row, col, (y, x)
            split = modes["split"][my, mx] >= 0
            whole = mv[:, :1, :].reshape(-1, 1, 1, 2)  # a macroblock's one vector
            cmv = np.where(split[:, None, None, None], (quad + 2 + (quad >> 31)) >> 2, whole)
            if split.any():
                cnt["split_chroma"] += 1
            if version == 3:
                cmv = cmv & ~7
            cmv = cmv.reshape(-1, 4, 2)
            cy = (my[:, None] * 8 + (np.arange(4) >> 1) * 4).reshape(-1)
            cx = (mx[:, None] * 8 + (np.arange(4) & 1) * 4).reshape(-1)
            for k in (1, 2):
                pred = _predict_inter(src[k], cy, cx, cmv[..., 0].reshape(-1), cmv[..., 1].reshape(-1), 3, taps)
                self._place(planes[k], residual[k], pred, cy, cx)

    @staticmethod
    def _place(plane, residual, pred, ys, xs) -> None:
        rows = ys[:, None, None] + np.arange(4)[None, :, None]
        cols = xs[:, None, None] + np.arange(4)[None, None, :]
        plane[rows, cols] = np.clip(pred + residual[rows, cols], 0, 255)

    def _intra_mb(self, modes, my: int, mx: int, planes, residual) -> None:
        Y, U, V = planes
        ry, ru, rv = residual
        y0, x0 = my * 16, mx * 16
        m = int(modes["ymode"][my, mx])
        if m != B_PRED:
            pred = _predict_block(Y, m, y0, x0, 16)
            Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + ry[y0:y0 + 16, x0:x0 + 16], 0, 255)
        else:
            self._bpred(Y, ry, modes["bmodes"][my, mx].tolist(), my, mx)
        c = int(modes["uvmode"][my, mx])
        for P, R in ((U, ru), (V, rv)):
            pred = _predict_block(P, c, my * 8, mx * 8, 8)
            P[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = np.clip(pred + R[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8], 0, 255)

    def _bpred(self, Y: np.ndarray, ry: np.ndarray, sub: List[int], my: int, mx: int) -> None:
        y0, x0 = my * 16, mx * 16
        # the row above the macroblock and 4 beyond (above-right of the macroblock)
        if my:
            above = Y[y0 - 1, x0:x0 + 16].tolist()
            if mx < self.mbw - 1:
                above += Y[y0 - 1, x0 + 16:x0 + 20].tolist()
            else:
                above += [above[15]] * 4
        else:
            above = [127] * 20
        block = Y[y0:y0 + 16, x0:x0 + 16].astype(np.int32)
        res = ry[y0:y0 + 16, x0:x0 + 16]
        for b in range(16):
            r, c = b >> 2, b & 3
            if r == 0:
                A = above[4 * c:4 * c + 8]
            else:
                A = block[4 * r - 1, 4 * c:4 * c + 4].tolist()
                A += block[4 * r - 1, 4 * c + 4:4 * c + 8].tolist() if c < 3 else above[16:20]
            if c == 0:
                L = Y[y0 + 4 * r:y0 + 4 * r + 4, x0 - 1].tolist() if mx else [129] * 4
            else:
                L = block[4 * r:4 * r + 4, 4 * c - 1].tolist()
            if r == 0:
                P = (Y[y0 - 1, x0 + 4 * c - 1] if (mx or c) else 129) if my else 127
            elif c == 0:
                P = Y[y0 + 4 * r - 1, x0 - 1] if mx else 129
            else:
                P = block[4 * r - 1, 4 * c - 1]
            pred = np.asarray(_predict_4x4(sub[b], A, L, int(P)), np.int32)
            block[4 * r:4 * r + 4, 4 * c:4 * c + 4] = np.clip(pred + res[4 * r:4 * r + 4, 4 * c:4 * c + 4], 0, 255)
        Y[y0:y0 + 16, x0:x0 + 16] = block

    # ---------------------------------------------------------- filter levels
    def _filter_levels(self, hdr, modes, coded: np.ndarray):
        ymode, ref, seg = modes["ymode"], modes["ref"], modes["segment"]
        if self.seg_enabled:
            base = np.asarray(self.seg_lf, np.int32)[seg.astype(np.int64)]
            if not self.seg_abs:
                base = base + hdr.filter_level
        else:
            base = np.full(ymode.shape, hdr.filter_level, np.int32)
        if self.lf_deltas_on:
            base = base + np.asarray(self.ref_deltas, np.int32)[ref.astype(np.int64)]
            mode_delta = np.zeros(ymode.shape, np.int32)
            mode_delta[ymode == B_PRED] = self.mode_deltas[0]
            mode_delta[ymode == ZEROMV] = self.mode_deltas[1]
            mode_delta[(ymode >= NEARESTMV) & (ymode <= NEWMV)] = self.mode_deltas[2]
            mode_delta[ymode == SPLITMV] = self.mode_deltas[3]
            base = base + mode_delta
        levels = np.clip(base, 0, 63)
        inner = coded | (ymode == B_PRED) | (ymode == SPLITMV)
        return levels, inner


# ------------------------------------------------------------------- video


def key_frame_size(frame: bytes) -> Tuple[int, int]:
    """(width, height) from a key frame's header."""
    if len(frame) < 10 or frame[0] & 1 or frame[3:6] != b"\x9d\x01\x2a":
        raise ValueError("a VP8 stream that does not start with a key frame")
    return (frame[6] | frame[7] << 8) & 0x3FFF, (frame[8] | frame[9] << 8) & 0x3FFF


class Vp8Track:
    """What a container's reader shares once it has found a VP8 track:
    `path` and `packets()` come from the container. The frames are
    libavcodec's planes through swscale's YUV 4:2:0 to BGR, as OpenCV's
    FFmpeg backend returns them."""

    counts: Counter  # the last `read()`'s decoder tallies (the tests read them)

    def size(self) -> Tuple[int, int]:
        """(width, height) from the first key frame; an odd height raises
        (swscale converts it through its scaled path, which the port does
        not reproduce)."""
        try:
            w, h = key_frame_size(next(self.packets(), b""))
        except ValueError as exc:
            raise ValueError(f"{self.path}: {exc}") from exc
        if h & 1:
            raise NotImplementedError(f"{self.path}: VP8 video of odd height ({w}x{h}): OpenCV converts it through "
                                      f"swscale's scaled path, which the port does not reproduce ({_ROADMAP})")
        return w, h

    def read(self, rgb: bool = True) -> Iterator[np.ndarray]:
        """The decoded frames: uint8 (H, W, 3), RGB (BGR with `rgb=False`)."""
        return read_frames(self, Vp8Decoder, rgb)


def read_frames(track, decoder_type, rgb: bool) -> Iterator[np.ndarray]:
    """A container track's frames through `decoder_type` (`Vp8Decoder` or
    `data/vp9.py Vp9Decoder`): every frame's headers checked first
    (`check_stream`), then each shown frame's planes through swscale's
    YUV 4:2:0 to BGR. The decoder's tallies go to `track.counts`."""
    try:
        decoder_type().check_stream(track.packets())
    except (NotImplementedError, ValueError) as exc:
        raise type(exc)(f"{track.path}: {exc}") from exc
    decoder = decoder_type()
    track.counts = decoder.counts
    for data in track.packets():
        try:
            planes = decoder.decode(data)
        except (NotImplementedError, ValueError) as exc:
            raise type(exc)(f"{track.path}: {exc}") from exc
        if planes is not None:
            bgr = yuv420_to_bgr(*planes)
            yield np.ascontiguousarray(bgr[..., ::-1]) if rgb else bgr
