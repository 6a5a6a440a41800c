"""VP9 (profile 0) decoding in numpy: the video in WebM as OpenCV's `VP90` writer and libvpx's encoder write it.

`Vp9Decoder.decode(block)` takes one container block (a frame, or a
superframe of several) and returns the Y, U and V planes of its last
frame, cropped to the picture's size, or None where that frame is hidden.
The decoder keeps the state that VP9 carries from frame to frame: the
eight reference slots, the four saved probability contexts, the loop
filter deltas, the segmentation and its map, and the motion vectors of
the last frame decoded.

Decoded, as far as the committed fixtures reach (`counts` tallies each
case; the tests list what the fixtures meet):

  stream      superframes (each frame of the block in turn), hidden
              frames, show_existing_frame (a slot shown again, no state
              changed); the previous frame's vectors only after a shown
              frame of the same size and not in an error-resilient frame
  header      the uncompressed header of key and inter frames (profile 0,
              8-bit 4:2:0, colour space and range, frame and render size,
              the size taken from a reference, `refresh_frame_flags`, the
              three reference indices and sign biases, high-precision
              vectors, a switchable or fixed interpolation filter,
              error-resilient frames, frame contexts 0-3 with or without
              their refresh and the reset of past state, the loop filter
              level and its reference and mode delta updates, the
              quantiser index, lossless frames, segmentation: the map's
              tree and temporal prediction probabilities and the alternative
              quantiser, loop filter level and skip features as deltas,
              tile columns) and the compressed header through the bool
              decoder: `tx_mode` and its probabilities, and the forward
              updates (`inv_remap_prob`) of the coefficient, skip,
              inter-mode, filter, is-inter, single and per-block compound
              reference, y-mode, partition and motion vector probabilities
  modes       the partition tree from 64x64 to 4x4, segment ids (coded,
              predicted from the last map in context, or the last map's),
              intra modes (key frames' above/left contexts, inter frames'
              size groups, 4x4 sub-blocks), the skip flag and transform
              size in context, single references, per-block compound
              references (fixed and variable by sign bias) in context, and
              compound references in every block (reference mode
              COMPOUND_REFERENCE: no per-block choice, the compound
              reference counts adapted after the frame),
              NEARESTMV/NEARMV/ZEROMV/NEWMV for each reference with the
              candidate search (`find_mv_refs`: neighbours by block size
              and either of their references, negated across sign biases,
              the previous frame's vectors, clamping) and its sub-8x8
              form, the switchable filter in context, and vector coding
  residual    tokens with band and neighbour contexts, dequantisation by
              segment (32x32 halved), DCT and ADST at 4, 8 and 16, the
              32x32 DCT with libvpx's integer rounding, and the 4x4
              Walsh-Hadamard of lossless frames
  prediction  the ten intra predictors at every size with VP9's edge
              rules, and 8-tap (regular, smooth, sharp) and bilinear
              inter prediction from references clamped at their edges,
              compound blocks averaging their two predictions
  loop filter the 4-, 8- and 16-wide filters over the edges that
              `vp9_loopfilter.c` masks per 64x64 superblock, levels from
              the frame's or the segment's level and the reference and
              mode deltas
  adaptation  backward adaptation (`frame_parallel_decoding_mode` 0):
              the frame's symbols tallied as it is parsed and the saved
              context merged towards them (libvpx's vp9_adapt_coef_probs,
              vp9_adapt_mode_probs, vp9_adapt_mv_probs)

What no fixture reaches raises `NotImplementedError` citing ROADMAP Queue 1
item 11.2 (`UNREACHED`): profiles 1-3 and high bit depth, intra-only
frames, a forward update of the compound reference probabilities, a segment with
a fixed reference, absolute segment data, references of another size,
tile rows, a loop filter sharpness and quantiser deltas. `check_stream`
finds them in the headers of a whole stream before any frame is decoded;
`decode` raises on such a frame's header. What the headers carry without
changing a pixel is read and passed over: the colour space and range, a
render size, an inter frame's coded size (a size that differs from its
references' raises as scaled motion). A corrupt frame raises
`ValueError`.

Modes and tokens are parsed for the whole frame first (the token loop
inlines the bool decoder; a twin of it counts tokens for frames that
adapt); then every inverse transform runs batched by size and type,
inter blocks are predicted in gathers by reference, plane, size and
filter (the second references of compound blocks after the first), intra
blocks follow in decoding order, and the loop filter runs its edges in
batches, each edge in the first batch after every earlier edge (in
libvpx's order) that touches the same 4x4 units.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from yolo_infer_tpu_torch.data import vp9_tables as _T
from yolo_infer_tpu_torch.data.vp8 import _NORM, _Bool, read_frames

_ROADMAP = "ROADMAP Queue 1 item 11.2"

# syntax the decoder does not decode (by its `counts` name): a frame that
# needs one raises before its pixels are made
UNREACHED: Dict[str, str] = {
    "profile_1": "profile 1 (4:2:2, 4:4:0 or 4:4:4)",
    "profile_2": "profile 2 (10 or 12 bits)",
    "profile_3": "profile 3",
    "intra_only": "an intra-only frame",
    "comp_ref_prob_update": "a forward update of the compound reference probabilities",
    "seg_ref": "a segment with a fixed reference frame",
    "seg_abs_data": "segment data given as absolute values",
    "scaled_reference": "a reference frame of another size (scaled motion)",
    "tile_rows": "tile rows",
    "sharpness": "a loop filter sharpness above 0",
    "delta_q": "quantiser deltas for the luma DC or the chroma",
}

# ------------------------------------------------------------------ tables

KEY_FRAME = 0
BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, \
    BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64 = range(13)
BLOCK_NAMES = ("4x4", "4x8", "8x4", "8x8", "8x16", "16x8", "16x16", "16x32", "32x16", "32x32", "32x64", "64x32",
               "64x64")
_BW8 = (1, 1, 1, 1, 1, 2, 2, 2, 4, 4, 4, 8, 8)  # width in 8x8 units
_BH8 = (1, 1, 1, 1, 2, 1, 2, 4, 2, 4, 8, 4, 8)
_BW4 = (1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16)  # in 4x4 units
_BH4 = (1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16)
_MAX_TX = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3)
_UV_MAX_TX = (0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 3)  # the largest transform of the 4:2:0 chroma block
_SIZE_GROUP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3)
# subsize by partition (NONE, HORZ, VERT, SPLIT) for 64, 32, 16 and 8 wide squares
_SUBSIZE = {BLOCK_64X64: (BLOCK_64X64, BLOCK_64X32, BLOCK_32X64, BLOCK_32X32),
            BLOCK_32X32: (BLOCK_32X32, BLOCK_32X16, BLOCK_16X32, BLOCK_16X16),
            BLOCK_16X16: (BLOCK_16X16, BLOCK_16X8, BLOCK_8X16, BLOCK_8X8),
            BLOCK_8X8: (BLOCK_8X8, BLOCK_8X4, BLOCK_4X8, BLOCK_4X4)}
_PARTITION_CTX = ((15, 15), (15, 14), (14, 15), (14, 14), (14, 12), (12, 14), (12, 12), (12, 8), (8, 12), (8, 8),
                  (8, 0), (0, 8), (0, 0))  # (above, left) bits a block leaves behind
_TX_MODE_BIGGEST = (0, 1, 2, 3, 3)
TX_MODE_SELECT = 4

DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED, D207_PRED, D63_PRED, TM_PRED = range(10)
NEARESTMV, NEARMV, ZEROMV, NEWMV = range(10, 14)
MODE_NAMES = ("DC", "V", "H", "D45", "D135", "D117", "D153", "D207", "D63", "TM", "NEAREST", "NEAR", "ZERO", "NEW")
NONE_FRAME, INTRA_FRAME, LAST_FRAME, GOLDEN_FRAME, ALTREF_FRAME = range(-1, 4)
REF_NAMES = ("intra", "last", "golden", "altref")
SINGLE_REFERENCE, COMPOUND_REFERENCE, REFERENCE_MODE_SELECT = range(3)
EIGHTTAP, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR, SWITCHABLE = range(5)
FILTER_NAMES = ("regular", "smooth", "sharp", "bilinear")
_LITERAL_TO_FILTER = (EIGHTTAP_SMOOTH, EIGHTTAP, EIGHTTAP_SHARP, BILINEAR)
DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, WHT_WHT = range(5)  # WHT_WHT: the 4x4 Walsh-Hadamard of lossless frames
TX_TYPE_NAMES = ("dct_dct", "adst_dct", "dct_adst", "adst_adst", "wht_wht")
_MODE_TX_TYPE = (DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST, DCT_ADST, ADST_DCT, ADST_ADST)

# trees: a leaf is -value (a leaf of value 0 is 0)
_INTRA_MODE_TREE = (-DC_PRED, 2, -TM_PRED, 4, -V_PRED, 6, 8, 12, -H_PRED, 10, -D135_PRED, -D117_PRED, -D45_PRED,
                    14, -D63_PRED, 16, -D153_PRED, -D207_PRED)
_PARTITION_TREE = (0, 2, -1, 4, -2, -3)
_INTER_MODE_TREE = (-2, 2, 0, 4, -1, -3)  # ZEROMV, NEARESTMV, NEARMV, NEWMV as offsets from NEARESTMV
_SWITCHABLE_TREE = (-EIGHTTAP, 2, -EIGHTTAP_SMOOTH, -EIGHTTAP_SHARP)
_MV_JOINT_TREE = (0, 2, -1, 4, -2, -3)
_MV_CLASS_TREE = (0, 2, -1, 4, 6, 8, -2, -3, 10, 12, -4, -5, -6, 14, 16, 18, -7, -8, -9, -10)
_MV_FP_TREE = (0, 2, -1, 4, -2, -3)
_MV_CLASS0_TREE = (0, -1)
_SEGMENT_TREE = (2, 4, 6, 8, 10, 12, 0, -1, -2, -3, -4, -5, -6, -7)

# segment features: the alternative quantiser and loop filter level, a fixed reference, skip
SEG_ALT_Q, SEG_ALT_LF, SEG_REF, SEG_SKIP = range(4)
SEG_FEATURE_NAMES = ("seg_alt_q", "seg_alt_lf", "seg_ref", "seg_skip")
_SEG_BITS, _SEG_MAX = (8, 6, 2, 0), (255, 63, 3, 0)

# backward adaptation (vp9_adapt_coef_probs, vp9_adapt_mode_probs): the update factor by count
_COEF_COUNT_SAT, _COEF_FACTOR, _COEF_FACTOR_AFTER_KEY = 24, 112, 128

# coefficient tokens: ZERO 0, ONE 1, TWO..FOUR 2-4, CAT1..CAT6 5-10
_COEF_CON_TREE = (2, 6, -2, 4, -3, -4, 8, 10, -5, -6, 12, 14, -7, -8, -9, -10)
_CAT_PROBS = ((159,), (165, 145), (173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
              (254, 254, 254, 252, 249, 243, 230, 196, 177, 153, 140, 133, 130, 129))
_CAT_BASE = (5, 7, 11, 19, 35, 67)
_ENERGY = (0, 1, 2, 3, 3, 4, 4, 5, 5, 5, 5, 5)
_BAND_4X4 = (0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5)
_BAND_8X8 = (0, 1, 1, 2, 2, 2, 3, 3, 3, 3) + (4,) * 11 + (5,) * 1003
_PARETO = [tuple(_T.PARETO8[i * 8:i * 8 + 8]) for i in range(255)]

_INV_MAP = tuple(7 + 13 * k for k in range(20)) + tuple(v for v in range(1, 255) if (v - 7) % 13) + (253,)

# motion vector reference search: (row, col) offsets in 8x8 units by block size
_MV_REF_BLOCKS = (((-1, 0), (0, -1), (-1, -1), (-2, 0), (0, -2), (-2, -1), (-1, -2), (-2, -2)),) * 4 + (
    ((0, -1), (-1, 0), (1, -1), (-1, -1), (0, -2), (-2, 0), (-2, -1), (-1, -2)),
    ((-1, 0), (0, -1), (-1, 1), (-1, -1), (-2, 0), (0, -2), (-1, -2), (-2, -1)),
    ((-1, 0), (0, -1), (-1, 1), (1, -1), (-1, -1), (-3, 0), (0, -3), (-3, -3)),
    ((0, -1), (-1, 0), (2, -1), (-1, -1), (-1, 1), (0, -3), (-3, 0), (-3, -3)),
    ((-1, 0), (0, -1), (-1, 2), (-1, -1), (1, -1), (-3, 0), (0, -3), (-3, -3)),
    ((-1, 1), (1, -1), (-1, 2), (2, -1), (-1, -1), (-3, 0), (0, -3), (-3, -3)),
    ((0, -1), (-1, 0), (4, -1), (-1, 2), (-1, -1), (0, -3), (-3, 0), (2, -1)),
    ((-1, 0), (0, -1), (-1, 4), (2, -1), (-1, -1), (-3, 0), (0, -3), (-1, 2)),
    ((-1, 3), (3, -1), (-1, 4), (4, -1), (-1, -1), (-1, 0), (0, -1), (-1, 6)))
_MODE_2_COUNTER = (9,) * 10 + (0, 0, 3, 1)
_COUNTER_TO_CONTEXT = (2, 3, 4, 1, 3, 9, 0, 9, 9, 5, 5, 9, 5, 9, 9, 9, 9, 9, 6)
_IDX_N_COLUMN_TO_SUBBLOCK = ((1, 2), (1, 3), (3, 2), (3, 3))
_MV_BORDER = 16 << 3

_FILTERS = [np.array(t, np.int32).reshape(16, 8) for t in
            (_T.FILTER_REGULAR, _T.FILTER_SMOOTH, _T.FILTER_SHARP, _T.FILTER_BILINEAR)]


def _neighbors(scan, n: int, kind: str) -> Tuple[int, ...]:
    """The two earlier positions (raster) whose tokens give a position's context, as libvpx's scan tables hold them."""
    out = [0, 0]
    for c in range(1, n * n):
        i, j = divmod(scan[c], n)
        if i and j:
            a, b = ((i - 1) * n + j,) * 2 if kind == "col" else (i * n + j - 1,) * 2 if kind == "row" else \
                ((i - 1) * n + j, i * n + j - 1)
        elif i:
            a = b = (i - 1) * n + j
        else:
            a = b = j - 1
        out += [a, b]
    return tuple(out)


def _scan_orders():
    """(scan, neighbours) by transform size and type: ADST_DCT takes the row scan, DCT_ADST the column scan."""
    orders = []
    for n in (4, 8, 16):
        d, c, r = (getattr(_T, f"{k}_SCAN_{n}X{n}") for k in ("DEFAULT", "COL", "ROW"))
        dn, cn, rn = _neighbors(d, n, "default"), _neighbors(c, n, "col"), _neighbors(r, n, "row")
        orders.append(((d, dn), (r, rn), (c, cn), (d, dn)))
    d = _T.DEFAULT_SCAN_32X32
    orders.append(((d, _neighbors(d, 32, "default")),) * 4)
    return orders


_SCANS = _scan_orders()

# ------------------------------------------------------------ bit readers


class _Bits:
    """The uncompressed header's plain bits, most significant first."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def bit(self) -> int:
        p = self.pos
        if p >> 3 >= len(self.data):
            raise ValueError("a VP9 frame header that runs past the frame's end")
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def lit(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def sint(self, n: int) -> int:
        v = self.lit(n)
        return -v if self.bit() else v


def _bool_decoder(data: bytes) -> _Bool:
    """VP9's boolean decoder, VP8's arithmetic (`vp8._Bool`), whose first
    bit, the marker, must be 0."""
    if not data:
        raise ValueError("an empty VP9 bool-coded partition")
    br = _Bool(data)
    if br.bool(128):
        raise ValueError("a VP9 bool-coded partition whose marker bit is set")
    return br


def _inv_recenter_nonneg(v: int, m: int) -> int:
    if v > 2 * m:
        return v
    return m - ((v + 1) >> 1) if v & 1 else m + (v >> 1)


def _inv_remap_prob(v: int, m: int) -> int:
    v = _INV_MAP[v]
    m -= 1
    if (m << 1) <= 255:
        return 1 + _inv_recenter_nonneg(v, m)
    return 255 - _inv_recenter_nonneg(v, 254 - m)


def _decode_term_subexp(br: _Bool) -> int:
    if not br.bool(128):
        return br.lit(4)
    if not br.bool(128):
        return br.lit(4) + 16
    if not br.bool(128):
        return br.lit(5) + 32
    v = br.lit(7)
    return (v if v < 65 else (v << 1) - 65 + br.bool(128)) + 64


def _diff_update(br: _Bool, probs: List[int], i: int, cnt: Counter, name: str) -> None:
    if br.bool(252):
        probs[i] = _inv_remap_prob(_decode_term_subexp(br), probs[i])
        cnt[name] += 1


def _mv_update(br: _Bool, probs: List[int], n: int, cnt: Counter) -> None:
    for i in range(n):
        if br.bool(252):
            probs[i] = (br.lit(7) << 1) | 1
            cnt["mv_prob_update"] += 1


# ------------------------------------------------------- frame contexts


def _split(seq, n: int) -> List[List[int]]:
    return [list(seq[i:i + n]) for i in range(0, len(seq), n)]


def _default_context() -> Dict[str, list]:
    """The probabilities `vp9_setup_past_independence` restores."""
    c = _T.COEF_PROBS
    coef = [[[[[list(c[((((t * 2 + p) * 2 + r) * 6 + b) * 6 + x) * 3:((((t * 2 + p) * 2 + r) * 6 + b) * 6 + x) * 3 + 3])
                for x in range(6)] for b in range(6)] for r in range(2)] for p in range(2)] for t in range(4)]
    comp = {"sign": [128], "classes": [224, 144, 192, 168, 192, 176, 192, 198, 198, 245], "class0": [216],
            "bits": [136, 140, 148, 160, 176, 192, 224, 234, 234, 240], "class0_fp": [[128, 128, 64], [96, 112, 64]],
            "fp": [64, 96, 64], "class0_hp": [160], "hp": [128]}
    comp2 = dict(comp, classes=[216, 128, 176, 160, 176, 176, 192, 198, 198, 208], class0=[208])
    return {
        "coef": coef,
        "tx8": [[100], [66]], "tx16": [[20, 152], [15, 101]], "tx32": [[3, 136, 37], [5, 52, 13]],
        "skip": [192, 128, 64],
        "inter_mode": _split(_T.INTER_MODE_PROBS, 3),
        "interp": _split(_T.SWITCHABLE_INTERP_PROBS, 2),
        "intra_inter": [9, 102, 187, 225],
        "comp_inter": [239, 183, 119, 96, 41],
        "single_ref": _split(_T.SINGLE_REF_PROBS, 2),
        "comp_ref": [50, 126, 123, 221, 226],
        "y_mode": _split(_T.Y_MODE_PROBS, 9),
        "uv_mode": _split(_T.UV_MODE_PROBS, 9),
        "partition": _split(_T.PARTITION_PROBS, 3),
        "mv_joints": [32, 64, 96],
        "mv": [_copy_context(comp), _copy_context(comp2)],
    }


def _copy_context(fc):
    if isinstance(fc, dict):
        return {k: _copy_context(v) for k, v in fc.items()}
    if isinstance(fc, list):
        return [_copy_context(v) for v in fc]
    return fc


_KF_Y_PROBS = [[list(_T.KF_Y_MODE_PROBS[(a * 10 + b) * 9:(a * 10 + b) * 9 + 9]) for b in range(10)] for a in range(10)]
_KF_UV_PROBS = _split(_T.KF_UV_MODE_PROBS, 9)
_KF_PARTITION_PROBS = _split(_T.KF_PARTITION_PROBS, 3)


class _Header:
    """The fields of one frame's headers that decoding reads."""


class _Segmentation:
    """The segmentation parameters a stream carries from frame to frame
    (the header's `segmentation_params`): each segment's features hold
    their data, or None where the feature is off."""

    def __init__(self):
        self.enabled = self.update_map = self.temporal = self.abs_delta = 0
        self.tree_probs, self.pred_probs = [255] * 7, [255] * 3
        self.features: List[List[Optional[int]]] = [[None] * 4 for _ in range(8)]

    def feature(self, segment: int, kind: int) -> Optional[int]:
        return self.features[segment][kind] if self.enabled else None


class _Tally:
    """What a frame that adapts its probabilities decoded, by context
    (libvpx's FRAME_COUNTS): coefficient tokens (zero, one, more, end of
    block at index (band * 6 + context) * 4 + kind) and more-coefficients
    branches, and every mode, reference, filter and vector symbol."""

    def __init__(self):
        z = lambda *shape: [z(*shape[1:]) for _ in range(shape[0])] if len(shape) > 1 else [0] * shape[0]  # noqa: E731
        self.coef = [[[[0] * 144 for _ in range(2)] for _ in range(2)] for _ in range(4)]
        self.eob = [[[[0] * 36 for _ in range(2)] for _ in range(2)] for _ in range(4)]
        self.skip, self.intra_inter, self.comp_inter, self.comp_ref = z(3, 2), z(4, 2), z(5, 2), z(5, 2)
        self.single_ref = z(5, 2, 2)
        self.tx8, self.tx16, self.tx32 = z(2, 2), z(2, 3), z(2, 4)
        self.inter_mode, self.interp = z(7, 4), z(4, 3)
        self.y_mode, self.uv_mode, self.partition = z(4, 10), z(10, 10), z(16, 4)
        self.mv_joints = [0] * 4
        self.mv = [{"sign": [0, 0], "classes": [0] * 11, "class0": [0, 0], "bits": z(10, 2), "class0_fp": z(2, 4),
                    "fp": [0] * 4, "class0_hp": [0, 0], "hp": [0, 0]} for _ in range(2)]


def _get_prob(n0: int, den: int) -> int:
    return min(max((n0 * 256 + (den >> 1)) // den, 1), 255)


def merge_prob(pre: int, n0: int, n1: int, count_sat: int = 20, factor: int = 128) -> int:
    """libvpx's merge_probs: the saved probability moved towards the
    frame's branch counts (n0 zeros, n1 ones) by a factor that grows with
    their total up to `count_sat`. Modes and vectors (mode_mv_merge_probs)
    take the defaults (count_to_update_factor)."""
    den = n0 + n1
    if not den:
        return pre
    f = factor * min(den, count_sat) // count_sat
    return (pre * (256 - f) + _get_prob(n0, den) * f + 128) >> 8


def merge_tree(tree, pre: List[int], counts: List[int], out: List[int], i: int = 0) -> int:
    """vpx_tree_merge_probs: each node's probability merged from the counts
    of the leaves under its two branches; returns the node's total."""
    left, right = tree[i], tree[i + 1]
    n0 = counts[-left] if left <= 0 else merge_tree(tree, pre, counts, out, left)
    n1 = counts[-right] if right <= 0 else merge_tree(tree, pre, counts, out, right)
    out[i >> 1] = merge_prob(pre[i >> 1], n0, n1)
    return n0 + n1


def _adapt(fc, pre, t: _Tally, h) -> None:
    """Backward adaptation into `fc` from the saved context `pre` (the
    probabilities before this frame's forward updates) and the frame's
    counts: the coefficients always (vp9_adapt_coef_probs), the rest on
    inter frames (vp9_adapt_mode_probs, vp9_adapt_mv_probs)."""
    factor = _COEF_FACTOR_AFTER_KEY if not h.intra and h.after_key else _COEF_FACTOR
    for tx in range(4):
        for i in range(2):
            for j in range(2):
                cc, eb = t.coef[tx][i][j], t.eob[tx][i][j]
                pc, out = pre["coef"][tx][i][j], fc["coef"][tx][i][j]
                for band in range(6):
                    for ctx in range(3 if band == 0 else 6):
                        k = band * 6 + ctx
                        n0, n1, n2, neob = cc[4 * k:4 * k + 4]
                        p = pc[band][ctx]
                        out[band][ctx] = [merge_prob(p[0], neob, eb[k] - neob, _COEF_COUNT_SAT, factor),
                                          merge_prob(p[1], n0, n1 + n2, _COEF_COUNT_SAT, factor),
                                          merge_prob(p[2], n1, n2, _COEF_COUNT_SAT, factor)]
    if h.intra:
        return
    for key, n in (("intra_inter", 4), ("comp_inter", 5), ("comp_ref", 5), ("skip", 3)):
        fc[key] = [merge_prob(pre[key][i], *getattr(t, key)[i]) for i in range(n)]
    fc["single_ref"] = [[merge_prob(pre["single_ref"][i][j], *t.single_ref[i][j]) for j in range(2)]
                        for i in range(5)]
    for key, tree, n in (("inter_mode", _INTER_MODE_TREE, 7), ("y_mode", _INTRA_MODE_TREE, 4),
                         ("uv_mode", _INTRA_MODE_TREE, 10), ("partition", _PARTITION_TREE, 16)):
        for i in range(n):
            merge_tree(tree, pre[key][i], getattr(t, key)[i], fc[key][i])
    if h.interp == SWITCHABLE:
        for i in range(4):
            merge_tree(_SWITCHABLE_TREE, pre["interp"][i], t.interp[i], fc["interp"][i])
    if h.tx_mode == TX_MODE_SELECT:
        for i in range(2):
            for key in ("tx8", "tx16", "tx32"):
                c = getattr(t, key)[i]  # counts of 4x4, 8x8, ... up to the size's largest
                fc[key][i] = [merge_prob(pre[key][i][j], c[j], sum(c[j + 1:])) for j in range(len(c) - 1)]
    merge_tree(_MV_JOINT_TREE, pre["mv_joints"], t.mv_joints, fc["mv_joints"])
    for comp, pc, c in zip(fc["mv"], pre["mv"], t.mv):
        comp["sign"] = [merge_prob(pc["sign"][0], *c["sign"])]
        merge_tree(_MV_CLASS_TREE, pc["classes"], c["classes"], comp["classes"])
        merge_tree(_MV_CLASS0_TREE, pc["class0"], c["class0"], comp["class0"])
        comp["bits"] = [merge_prob(pc["bits"][j], *c["bits"][j]) for j in range(10)]
        for j in range(2):
            merge_tree(_MV_FP_TREE, pc["class0_fp"][j], c["class0_fp"][j], comp["class0_fp"][j])
        merge_tree(_MV_FP_TREE, pc["fp"], c["fp"], comp["fp"])
        if h.allow_hp:
            comp["class0_hp"] = [merge_prob(pc["class0_hp"][0], *c["class0_hp"])]
            comp["hp"] = [merge_prob(pc["hp"][0], *c["hp"])]


def superframe_sizes(data: bytes) -> Optional[List[int]]:
    """The frame sizes of a superframe index at the end of `data`, or None."""
    if not data:
        return None
    marker = data[-1]
    if marker & 0xE0 != 0xC0:
        return None
    frames, mag = (marker & 7) + 1, ((marker >> 3) & 3) + 1
    size = 2 + mag * frames
    if len(data) < size or data[-size] != marker:
        return None
    idx = data[-size + 1:-1]
    return [int.from_bytes(idx[i * mag:(i + 1) * mag], "little") for i in range(frames)]


def split_superframe(data: bytes) -> List[bytes]:
    """The frames of one container block: those its superframe index lists,
    or the block itself."""
    sizes = superframe_sizes(data)
    if sizes is None:
        return [data]
    frames, at = [], 0
    for n in sizes:
        if at + n > len(data):
            raise ValueError("a VP9 superframe whose index lists more bytes than the block holds")
        frames.append(data[at:at + n])
        at += n
    return frames


# ------------------------------------------------------------------ decoder


class Vp9Decoder:
    """Decode VP9 frames in order. `decode(frame)` -> (Y, U, V) uint8 planes cropped to the picture."""

    def __init__(self):
        self.counts: Counter = Counter()
        self.slots: List[Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = [None] * 8
        self.slot_size: List[Optional[Tuple[int, int]]] = [None] * 8
        self.contexts = [_default_context() for _ in range(4)]
        self.ref_deltas = [1, 0, -1, -1]
        self.mode_deltas = [0, 0]
        self.seg = _Segmentation()
        self.seg_map: Optional[List[int]] = None  # the last segment map (libvpx's last_frame_seg_map); None: all 0
        self.started = False
        self.last_key = False  # the frame decoded last was a key frame
        self.prev = None  # ((width, height), block by 8x8 unit) of the last frame decoded, if shown and not intra-only

    # ---------------------------------------------------------- headers
    def _uncompressed(self, data: bytes) -> _Header:
        """The uncompressed header. Like libvpx's read_uncompressed_header
        it also sets what the stream carries on: the loop filter deltas,
        the segmentation, and for key and error-resilient frames the reset
        of past state (`_past_independence`)."""
        cnt = self.counts
        rb = _Bits(data)
        h = _Header()
        if rb.lit(2) != 2:
            raise ValueError("a VP9 frame without its frame marker")
        profile = rb.bit() | rb.bit() << 1
        if profile == 3:
            rb.bit()
        cnt[f"profile_{profile}"] += 1
        h.existing = None
        if rb.bit():  # show_existing_frame: a slot shown again, nothing decoded
            cnt["show_existing_frame"] += 1
            self._check_reached()
            h.existing, h.show = rb.lit(3), 1
            if self.slot_size[h.existing] is None:
                raise ValueError("a VP9 frame that shows an empty reference slot")
            return h
        h.key = rb.bit() == KEY_FRAME
        h.show = rb.bit()
        h.error_res = rb.bit()
        if not h.show:
            cnt["hidden_frame"] += 1
        if h.error_res:
            cnt["error_resilient"] += 1
        self._check_reached()
        h.reset_ctx = 0
        if h.key:
            if rb.lit(24) != 0x498342:
                raise ValueError("a VP9 key frame without its sync code")
            cs = rb.lit(3)
            if cs == 7:
                raise ValueError("a VP9 profile 0 key frame in sRGB colour (4:4:4), which profile 0 does not allow")
            cnt[f"colour_space_{cs}"] += 1
            cnt["full_range" if rb.bit() else "studio_range"] += 1
            h.refresh = 0xFF
            h.width, h.height = rb.lit(16) + 1, rb.lit(16) + 1
            if rb.bit():
                rb.lit(32)
                cnt["render_size"] += 1
            h.ref_idx = (0, 0, 0)
            h.sign_bias = (0, 0, 0, 0)
            h.allow_hp, h.interp = 0, EIGHTTAP
            self.started = True
            cnt["key_frame"] += 1
        else:
            if not self.started:
                raise ValueError("a VP9 inter frame before any key frame")
            if not h.show and rb.bit():
                cnt["intra_only"] += 1
                self._check_reached()
            if not h.error_res:
                h.reset_ctx = rb.lit(2)  # used by intra-only frames only
            h.refresh = rb.lit(8)
            idx, bias = [], [0]
            for _ in range(3):
                idx.append(rb.lit(3))
                bias.append(rb.bit())
            h.ref_idx, h.sign_bias = tuple(idx), tuple(bias)
            for i in idx:
                if self.slot_size[i] is None:
                    raise ValueError("a VP9 inter frame that refers to an empty reference slot")
            for i in idx:
                if rb.bit():
                    h.width, h.height = self.slot_size[i]
                    cnt["size_from_ref"] += 1
                    break
            else:
                h.width, h.height = rb.lit(16) + 1, rb.lit(16) + 1
                cnt["size_coded"] += 1
            if rb.bit():
                rb.lit(32)
                cnt["render_size"] += 1
            if any(self.slot_size[i] != (h.width, h.height) for i in idx):
                cnt["scaled_reference"] += 1
                self._check_reached()
            h.allow_hp = rb.bit()
            h.interp = SWITCHABLE if rb.bit() else _LITERAL_TO_FILTER[rb.lit(2)]
            cnt["allow_hp" if h.allow_hp else "no_hp"] += 1
            cnt["filter_switchable" if h.interp == SWITCHABLE else f"filter_{FILTER_NAMES[h.interp]}"] += 1
            cnt["inter_frame"] += 1
        h.intra = h.key
        h.after_key = self.last_key
        if h.error_res:
            h.refresh_ctx, h.adapt = 0, False  # frame-parallel implied
        else:
            h.refresh_ctx = rb.bit()
            h.adapt = not rb.bit()
        if h.adapt:
            cnt["backward_adaptation"] += 1
        h.ctx_idx = rb.lit(2)
        if h.intra or h.error_res:
            self._past_independence(h)
        cnt["refresh_frame_context" if h.refresh_ctx else "keep_frame_context"] += 1
        cnt[f"frame_context_{h.ctx_idx}"] += 1
        # loop filter
        h.lf_level, h.sharpness = rb.lit(6), rb.lit(3)
        h.lf_deltas = rb.bit()
        if h.lf_deltas:
            cnt["lf_deltas"] += 1
            if rb.bit():
                for deltas in (self.ref_deltas, self.mode_deltas):
                    for i in range(len(deltas)):
                        if rb.bit():
                            deltas[i] = rb.sint(6)
                            cnt["lf_delta_update"] += 1
        h.ref_deltas, h.mode_deltas = list(self.ref_deltas), list(self.mode_deltas)
        if h.sharpness:
            cnt["sharpness"] += 1
        # quantiser
        h.base_q = rb.lit(8)
        h.dq = [rb.sint(4) if rb.bit() else 0 for _ in range(3)]  # y dc, uv dc, uv ac
        if any(h.dq):
            cnt["delta_q"] += 1
        h.lossless = h.base_q == 0 and not any(h.dq)
        if h.lossless:
            cnt["lossless"] += 1
        self._segmentation(rb)
        self._check_reached()
        # tiles
        sb_cols = (((h.width + 7) >> 3) + 7) >> 3
        min_log2 = 0
        while (64 << min_log2) < sb_cols:
            min_log2 += 1
        max_log2 = 1
        while (sb_cols >> max_log2) >= 4:
            max_log2 += 1
        max_log2 -= 1
        h.tile_cols_log2 = min_log2
        while h.tile_cols_log2 < max_log2 and rb.bit():
            h.tile_cols_log2 += 1
        if rb.bit():
            rb.bit()
            cnt["tile_rows"] += 1
            self._check_reached()
        cnt[f"tile_cols_{1 << h.tile_cols_log2}"] += 1
        h.header_size = rb.lit(16)
        h.first = (rb.pos + 7) >> 3
        if not h.header_size or h.first + h.header_size > len(data):
            raise ValueError("a VP9 frame whose compressed header is empty or runs past its end")
        return h

    def _past_independence(self, h: _Header) -> None:
        """libvpx's vp9_setup_past_independence, for key, intra-only and
        error-resilient frames: segment features and maps cleared, the
        loop filter deltas at their defaults, the probability contexts
        reset (all four, or with `reset_frame_context` 2 the frame's own
        only), the sign biases cleared, and context 0 chosen."""
        self.seg.features = [[None] * 4 for _ in range(8)]
        self.seg.abs_delta = 0
        self.seg_map = None
        self.ref_deltas, self.mode_deltas = [1, 0, -1, -1], [0, 0]
        if h.key or h.error_res or h.reset_ctx == 3:
            self.contexts = [_default_context() for _ in range(4)]
        elif h.reset_ctx == 2:
            self.contexts[h.ctx_idx] = _default_context()
        h.sign_bias = (0, 0, 0, 0)
        h.ctx_idx = 0

    def _segmentation(self, rb: _Bits) -> None:
        """The header's segmentation parameters, into `self.seg` (features
        persist until a frame updates or resets them)."""
        seg, cnt = self.seg, self.counts
        seg.update_map = 0
        seg.enabled = rb.bit()
        if not seg.enabled:
            return
        cnt["segmentation"] += 1
        seg.update_map = rb.bit()
        if seg.update_map:
            cnt["seg_update_map"] += 1
            seg.tree_probs = [rb.lit(8) if rb.bit() else 255 for _ in range(7)]
            seg.temporal = rb.bit()
            seg.pred_probs = [rb.lit(8) if rb.bit() else 255 for _ in range(3)] if seg.temporal else [255] * 3
            if seg.temporal:
                cnt["seg_temporal_update"] += 1
        if rb.bit():
            cnt["seg_update_data"] += 1
            seg.abs_delta = rb.bit()
            seg.features = [[None] * 4 for _ in range(8)]
            for i in range(8):
                for kind in range(4):
                    if rb.bit():
                        v = min(rb.lit(_SEG_BITS[kind]), _SEG_MAX[kind])
                        if kind <= SEG_ALT_LF and rb.bit():
                            v = -v
                        seg.features[i][kind] = v
                        cnt[SEG_FEATURE_NAMES[kind]] += 1
            if seg.abs_delta:
                cnt["seg_abs_data"] += 1

    def _compressed(self, data: bytes, h: _Header, fc) -> None:
        """The compressed header's forward updates, into `fc`."""
        cnt = self.counts
        br = _bool_decoder(data[h.first:h.first + h.header_size])
        if h.lossless:
            tx_mode = 0  # ONLY_4X4, not coded
        else:
            tx_mode = br.lit(2)
            if tx_mode == 3:
                tx_mode += br.bool(128)
        h.tx_mode = tx_mode
        cnt[f"tx_mode_{tx_mode}"] += 1
        if tx_mode == TX_MODE_SELECT:
            for key, n in (("tx8", 1), ("tx16", 2), ("tx32", 3)):
                for i in range(2):
                    for j in range(n):
                        _diff_update(br, fc[key][i], j, cnt, "tx_prob_update")
        for t in range(_TX_MODE_BIGGEST[tx_mode] + 1):
            if br.bool(128):
                cnt["coef_prob_update"] += 1
                for p in fc["coef"][t]:
                    for r in p:
                        for b in range(6):
                            for x in range(3 if b == 0 else 6):
                                for m in range(3):
                                    _diff_update(br, r[b][x], m, cnt, "coef_prob_delta")
        for i in range(3):
            _diff_update(br, fc["skip"], i, cnt, "skip_prob_update")
        h.ref_mode = SINGLE_REFERENCE
        if h.intra:
            return
        for i in range(7):
            for j in range(3):
                _diff_update(br, fc["inter_mode"][i], j, cnt, "inter_mode_prob_update")
        if h.interp == SWITCHABLE:
            for i in range(4):
                for j in range(2):
                    _diff_update(br, fc["interp"][i], j, cnt, "interp_prob_update")
        for i in range(4):
            _diff_update(br, fc["intra_inter"], i, cnt, "intra_inter_prob_update")
        bias = h.sign_bias
        if len(set(bias[1:])) > 1 and br.bool(128):  # compound allowed by the sign biases, and chosen
            h.ref_mode = REFERENCE_MODE_SELECT if br.bool(128) else COMPOUND_REFERENCE
            # vp9_setup_compound_reference_mode: the reference of the odd sign bias is fixed
            h.comp_fixed, h.comp_var = (ALTREF_FRAME, (LAST_FRAME, GOLDEN_FRAME)) if bias[1] == bias[2] else \
                (GOLDEN_FRAME, (LAST_FRAME, ALTREF_FRAME)) if bias[1] == bias[3] else \
                (LAST_FRAME, (GOLDEN_FRAME, ALTREF_FRAME))
            cnt["compound"] += 1
            cnt["reference_select" if h.ref_mode == REFERENCE_MODE_SELECT else "compound_only"] += 1
        if h.ref_mode == REFERENCE_MODE_SELECT:
            for i in range(5):
                _diff_update(br, fc["comp_inter"], i, cnt, "comp_inter_prob_update")
        if h.ref_mode != COMPOUND_REFERENCE:
            for i in range(5):
                for j in range(2):
                    _diff_update(br, fc["single_ref"][i], j, cnt, "single_ref_prob_update")
        if h.ref_mode != SINGLE_REFERENCE:
            for i in range(5):
                _diff_update(br, fc["comp_ref"], i, cnt, "comp_ref_prob_update")
        for i in range(4):
            for j in range(9):
                _diff_update(br, fc["y_mode"][i], j, cnt, "y_mode_prob_update")
        for i in range(16):
            for j in range(3):
                _diff_update(br, fc["partition"][i], j, cnt, "partition_prob_update")
        _mv_update(br, fc["mv_joints"], 3, cnt)
        for c in fc["mv"]:
            _mv_update(br, c["sign"], 1, cnt)
            _mv_update(br, c["classes"], 10, cnt)
            _mv_update(br, c["class0"], 1, cnt)
            _mv_update(br, c["bits"], 10, cnt)
        for c in fc["mv"]:
            for j in range(2):
                _mv_update(br, c["class0_fp"][j], 3, cnt)
            _mv_update(br, c["fp"], 3, cnt)
        if h.allow_hp:
            for c in fc["mv"]:
                _mv_update(br, c["class0_hp"], 1, cnt)
                _mv_update(br, c["hp"], 1, cnt)

    def _check_reached(self) -> None:
        for name, what in UNREACHED.items():
            if self.counts.get(name):
                raise NotImplementedError(f"a VP9 frame with {what}, which the port does not decode yet ({_ROADMAP})")

    def _frame_header(self, data: bytes) -> Tuple[_Header, dict]:
        """Both headers of a frame, and the probabilities it decodes with
        (its frame context after the forward updates)."""
        if not data:
            raise ValueError("an empty VP9 frame")
        h = self._uncompressed(data)
        if h.existing is not None:
            return h, None
        fc = _copy_context(self.contexts[h.ctx_idx])
        self._compressed(data, h, fc)
        self._check_reached()
        return h, fc

    def _frames(self, data: bytes) -> List[bytes]:
        if superframe_sizes(data) is not None:
            self.counts["superframe"] += 1
        return split_superframe(data)

    def check_stream(self, blocks) -> None:
        """Parse both headers of every frame (not its blocks), each frame of
        a superframe in turn, and raise where `decode` would raise on them:
        for syntax `UNREACHED` names, before any frame is decoded."""
        for data in blocks:
            for frame in self._frames(data):
                h, _ = self._frame_header(frame)
                if h.existing is not None:
                    continue
                for i in range(8):
                    if h.refresh >> i & 1:
                        self.slot_size[i] = (h.width, h.height)

    # ---------------------------------------------------------- modes
    def _tiles(self, data: bytes, h: _Header):
        """(column start, column end, bool decoder) of each tile column."""
        mi_cols = self.mi_cols
        sb_cols = (mi_cols + 7) >> 3
        n = 1 << h.tile_cols_log2
        pos, end = h.first + h.header_size, len(data)
        tiles = []
        for i in range(n):
            c0 = min(((i * sb_cols) >> h.tile_cols_log2) << 3, mi_cols)
            c1 = min((((i + 1) * sb_cols) >> h.tile_cols_log2) << 3, mi_cols)
            if i < n - 1:
                if pos + 4 > end:
                    raise ValueError("a VP9 frame whose tile sizes run past its end")
                size = int.from_bytes(data[pos:pos + 4], "big")
                pos += 4
            else:
                size = end - pos
            if size <= 0 or pos + size > end:
                raise ValueError("a VP9 tile that is empty or runs past the frame's end")
            tiles.append((c0, c1, _bool_decoder(data[pos:pos + size])))
            pos += size
        return tiles

    def _parse(self, data: bytes, h: _Header, fc) -> None:
        """Modes and tokens of every block, tile by tile (tiles share no
        context but the above arrays, which they split by column)."""
        mi_cols, mi_rows = self.mi_cols, self.mi_rows
        self.grid: List[Optional[_Block]] = [None] * (mi_rows * mi_cols)
        self.blocks: List[_Block] = []
        self.above_seg = [0] * (mi_cols + 8)
        self.above_nz = [[0] * (2 * mi_cols + 16), [0] * (mi_cols + 8), [0] * (mi_cols + 8)]
        self.coef_pos: List[List[int]] = [[], [], [], []]
        self.coef_val: List[List[int]] = [[], [], [], []]
        self.n_res = [0, 0, 0, 0]
        self.res_type: List[List[int]] = [[], [], [], []]
        self.intra_ops: List[tuple] = []
        self.inter_res: List[tuple] = []
        self.h, self.fc = h, fc
        self.tally = _Tally() if h.adapt else None
        seg = self.seg
        if seg.enabled:
            self.seg_last = self.seg_map or [0] * (mi_rows * mi_cols)
            self.seg_cur = [0] * (mi_rows * mi_cols)
        self.dq = []
        for i in range(8):  # each segment's (luma, chroma) (dc, ac) steps
            q, alt = h.base_q, seg.feature(i, SEG_ALT_Q)
            if alt is not None:
                q = min(max(alt if seg.abs_delta else q + alt, 0), 255)
            dc = lambda d: _T.DC_QLOOKUP[min(max(q + d, 0), 255)]  # noqa: E731
            ac = lambda d: _T.AC_QLOOKUP[min(max(q + d, 0), 255)]  # noqa: E731
            self.dq.append(((dc(h.dq[0]), ac(0)), (dc(h.dq[1]), ac(h.dq[2]))))
        for c0, c1, br in self._tiles(data, h):
            self.br, self.tile = br, (c0, c1)
            for r in range(0, mi_rows, 8):
                self.left_seg = [0] * 8
                self.left_nz = [[0] * 16, [0] * 8, [0] * 8]
                for c in range(c0, c1, 8):
                    self._partition(r, c, BLOCK_64X64, 3)
        if seg.enabled:  # libvpx swaps its two maps after a frame that has segmentation only
            self.seg_map = self.seg_cur

    def _partition(self, r: int, c: int, bsize: int, bsl: int) -> None:
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        n8 = 1 << bsl
        hbs = n8 >> 1
        has_rows, has_cols = r + hbs < self.mi_rows, c + hbs < self.mi_cols
        ctx = bsl * 4 + ((self.left_seg[r & 7] >> bsl) & 1) * 2 + ((self.above_seg[c] >> bsl) & 1)
        probs = _KF_PARTITION_PROBS[ctx] if self.h.intra else self.fc["partition"][ctx]
        br = self.br
        if has_rows and has_cols:
            p = br.tree(_PARTITION_TREE, probs)
        elif has_cols:
            p = 3 if br.bool(probs[1]) else 1
        elif has_rows:
            p = 3 if br.bool(probs[2]) else 2
        else:
            p = 3
        self.counts[f"partition_{p}"] += 1
        if self.tally:
            self.tally.partition[ctx][p] += 1
        sub = _SUBSIZE[bsize][p]
        if not hbs or p == 0:
            self._block(r, c, sub)
        elif p == 1:
            self._block(r, c, sub)
            if has_rows:
                self._block(r + hbs, c, sub)
        elif p == 2:
            self._block(r, c, sub)
            if has_cols:
                self._block(r, c + hbs, sub)
        else:
            for dr, dc in ((0, 0), (0, hbs), (hbs, 0), (hbs, hbs)):
                self._partition(r + dr, c + dc, sub, bsl - 1)
        if bsize == BLOCK_8X8 or p != 3:
            a, lf = _PARTITION_CTX[sub]
            self.above_seg[c:c + n8] = [a] * n8
            self.left_seg[r & 7:(r & 7) + n8] = [lf] * n8

    def _block(self, r: int, c: int, sb: int) -> None:
        cols = self.mi_cols
        b = _Block()
        b.r, b.c, b.sb = r, c, sb
        above = self.grid[(r - 1) * cols + c] if r else None
        left = self.grid[r * cols + c - 1] if c > self.tile[0] else None
        b.above, b.left = above, left
        br, fc, cnt, tally, seg = self.br, self.fc, self.counts, self.tally, self.seg
        x_mis, y_mis = min(_BW8[sb], cols - c), min(_BH8[sb], self.mi_rows - r)
        b.seg_pred = 0
        b.seg = self._segment_id(b, x_mis, y_mis) if seg.enabled else 0
        if seg.feature(b.seg, SEG_SKIP) is not None:
            b.skip = 1
        else:
            ctx = (above.skip if above else 0) + (left.skip if left else 0)
            b.skip = br.bool(fc["skip"][ctx])
            if tally:
                tally.skip[ctx][b.skip] += 1
        if self.h.intra:
            b.inter = 0
            b.tx = self._tx_size(b, True)
            self._intra_modes_kf(b)
        else:
            ref = seg.feature(b.seg, SEG_REF)
            if ref is not None:
                b.inter = int(ref != INTRA_FRAME)
            else:
                if above and left:
                    ctx = 3 if not above.inter and not left.inter else int(not above.inter or not left.inter)
                elif above or left:
                    ctx = 2 * (not (above or left).inter)
                else:
                    ctx = 0
                b.inter = br.bool(fc["intra_inter"][ctx])
                if tally:
                    tally.intra_inter[ctx][b.inter] += 1
            b.tx = self._tx_size(b, not b.skip or not b.inter)
            if b.inter:
                self._inter_modes(b)
            else:
                self._intra_modes(b)
        cnt[f"block_{BLOCK_NAMES[sb]}"] += 1
        cnt[f"tx_{4 << b.tx}"] += 1
        if b.skip:
            cnt["skip"] += 1
        grid = self.grid
        for y in range(r, r + y_mis):
            grid[y * cols + c:y * cols + c + x_mis] = [b] * x_mis
        self.blocks.append(b)
        self._tokens(b)

    def _segment_id(self, b, x_mis: int, y_mis: int) -> int:
        """The block's segment (libvpx's read_intra_segment_id and
        read_inter_segment_id): coded, predicted from the last map, or
        without a map update the last map's (0 on intra frames); the
        current map takes it over the block's area."""
        seg, cols = self.seg, self.mi_cols
        at = [y * cols + x for y in range(b.r, b.r + y_mis) for x in range(b.c, b.c + x_mis)]
        last, cur = self.seg_last, self.seg_cur
        if not seg.update_map:
            for i in at:
                cur[i] = last[i]
            return 0 if self.h.intra else min(last[i] for i in at)
        br = self.br
        if seg.temporal and not self.h.intra:
            ctx = (b.above.seg_pred if b.above else 0) + (b.left.seg_pred if b.left else 0)
            b.seg_pred = br.bool(seg.pred_probs[ctx])
        if b.seg_pred:
            sid = min(last[i] for i in at)
            self.counts["seg_predicted"] += 1
        else:
            sid = br.tree(_SEGMENT_TREE, seg.tree_probs)
            self.counts["seg_coded"] += 1
        for i in at:
            cur[i] = sid
        return sid

    def _tx_size(self, b, allow_select: bool) -> int:
        max_tx = _MAX_TX[b.sb]
        tx_mode = self.h.tx_mode
        if allow_select and tx_mode == TX_MODE_SELECT and b.sb >= BLOCK_8X8:
            above, left = b.above, b.left
            a = above.tx if above and not above.skip else max_tx
            lf = left.tx if left and not left.skip else max_tx
            if not left:
                lf = a
            if not above:
                a = lf
            ctx = int(a + lf > max_tx)
            key = ("tx8", "tx16", "tx32")[max_tx - 1]
            probs = self.fc[key][ctx]
            br = self.br
            tx = br.bool(probs[0])
            if tx and max_tx >= 2:
                tx += br.bool(probs[1])
                if tx > 1 and max_tx >= 3:
                    tx += br.bool(probs[2])
            self.counts["tx_selected"] += 1
            if self.tally:
                getattr(self.tally, key)[ctx][tx] += 1
            return tx
        return min(max_tx, _TX_MODE_BIGGEST[tx_mode])

    def _intra_modes_kf(self, b) -> None:
        br, above, left = self.br, b.above, b.left

        def above_mode(k):  # the mode above sub-block k (0 or 1 of the top row)
            return above.bmodes[k + 2] if above and not above.inter else DC_PRED

        def left_mode(k):  # the mode left of sub-block k (0 or 2 of the left column)
            return left.bmodes[k + 1] if left and not left.inter else DC_PRED

        sb = b.sb
        if sb >= BLOCK_8X8:
            m = br.tree(_INTRA_MODE_TREE, _KF_Y_PROBS[above_mode(0)][left_mode(0)])
            b.bmodes = (m,) * 4
        elif sb == BLOCK_4X4:
            m0 = br.tree(_INTRA_MODE_TREE, _KF_Y_PROBS[above_mode(0)][left_mode(0)])
            m1 = br.tree(_INTRA_MODE_TREE, _KF_Y_PROBS[above_mode(1)][m0])
            m2 = br.tree(_INTRA_MODE_TREE, _KF_Y_PROBS[m0][left_mode(2)])
            m3 = br.tree(_INTRA_MODE_TREE, _KF_Y_PROBS[m1][m2])
            b.bmodes = (m0, m1, m2, m3)
        elif sb == BLOCK_4X8:
            m0 = br.tree(_INTRA_MODE_TREE, _KF_Y_PROBS[above_mode(0)][left_mode(0)])
            m1 = br.tree(_INTRA_MODE_TREE, _KF_Y_PROBS[above_mode(1)][m0])
            b.bmodes = (m0, m1, m0, m1)
        else:  # 8x4
            m0 = br.tree(_INTRA_MODE_TREE, _KF_Y_PROBS[above_mode(0)][left_mode(0)])
            m2 = br.tree(_INTRA_MODE_TREE, _KF_Y_PROBS[m0][left_mode(2)])
            b.bmodes = (m0, m0, m2, m2)
        b.mode = b.bmodes[3]
        b.uv = br.tree(_INTRA_MODE_TREE, _KF_UV_PROBS[b.mode])
        self._intra_done(b, "kf_")

    def _intra_modes(self, b) -> None:
        br, fc, tally = self.br, self.fc, self.tally
        sb = b.sb
        if sb >= BLOCK_8X8:
            m = br.tree(_INTRA_MODE_TREE, fc["y_mode"][_SIZE_GROUP[sb]])
            b.bmodes = (m,) * 4
            if tally:
                tally.y_mode[_SIZE_GROUP[sb]][m] += 1
        else:
            n = 4 if sb == BLOCK_4X4 else 2
            ms = [br.tree(_INTRA_MODE_TREE, fc["y_mode"][0]) for _ in range(n)]
            b.bmodes = tuple(ms) if n == 4 else (ms[0], ms[1], ms[0], ms[1]) if sb == BLOCK_4X8 else \
                (ms[0], ms[0], ms[1], ms[1])
            if tally:
                for m in ms:
                    tally.y_mode[0][m] += 1
        b.mode = b.bmodes[3]
        b.uv = br.tree(_INTRA_MODE_TREE, fc["uv_mode"][b.mode])
        if tally:
            tally.uv_mode[b.mode][b.uv] += 1
        self._intra_done(b, "intra_")

    def _intra_done(self, b, prefix: str) -> None:
        b.ref, b.ref1, b.mv, b.mv1, b.bmvs, b.bmvs1, b.filt = INTRA_FRAME, NONE_FRAME, (0, 0), (0, 0), None, None, 3
        cnt = self.counts
        for m in set(b.bmodes):
            cnt[prefix + MODE_NAMES[m]] += 1
        cnt["uv_" + MODE_NAMES[b.uv]] += 1
        if b.sb < BLOCK_8X8:
            cnt[prefix + "sub8x8"] += 1

    # -------------------------------------------------- inter modes
    def _refs(self, b) -> None:
        """The block's references (libvpx's read_ref_frames): the segment's,
        or single or compound as the frame's reference mode and its
        contexts choose."""
        br, fc, h, tally = self.br, self.fc, self.h, self.tally
        above, left = b.above, b.left
        fixed = self.seg.feature(b.seg, SEG_REF)
        if fixed is not None:
            b.ref, b.ref1 = fixed, NONE_FRAME
            return
        compound = h.ref_mode == COMPOUND_REFERENCE
        if h.ref_mode == REFERENCE_MODE_SELECT:
            ctx = _comp_inter_ctx(above, left, h.comp_fixed)
            compound = br.bool(fc["comp_inter"][ctx])
            if tally:
                tally.comp_inter[ctx][compound] += 1
        if compound:
            fix_idx = h.sign_bias[h.comp_fixed]
            ctx = _comp_ref_ctx(above, left, h.comp_fixed, h.comp_var, 1 - fix_idx)
            bit = br.bool(fc["comp_ref"][ctx])
            if tally:
                tally.comp_ref[ctx][bit] += 1
            refs = [0, 0]
            refs[fix_idx], refs[1 - fix_idx] = h.comp_fixed, h.comp_var[bit]
            b.ref, b.ref1 = refs
            return
        ctx = _single_ref_p1_ctx(above, left)
        bit = br.bool(fc["single_ref"][ctx][0])
        if tally:
            tally.single_ref[ctx][0][bit] += 1
        if bit:
            ctx = _single_ref_p2_ctx(above, left)
            bit = br.bool(fc["single_ref"][ctx][1])
            if tally:
                tally.single_ref[ctx][1][bit] += 1
            b.ref = ALTREF_FRAME if bit else GOLDEN_FRAME
        else:
            b.ref = LAST_FRAME
        b.ref1 = NONE_FRAME

    def _inter_modes(self, b) -> None:
        br, fc, cnt, tally = self.br, self.fc, self.counts, self.tally
        self._refs(b)
        refs = (b.ref,) if b.ref1 <= INTRA_FRAME else (b.ref, b.ref1)
        cnt["ref_" + REF_NAMES[b.ref]] += 1
        if len(refs) == 2:
            cnt["ref_compound"] += 1
        # the mode context: what the two nearest neighbours did
        counter = 0
        r, c = b.r, b.c
        tile_lo, tile_hi = self.tile
        grid, cols, rows = self.grid, self.mi_cols, self.mi_rows
        for dr, dc in _MV_REF_BLOCKS[b.sb][:2]:
            y, x = r + dr, c + dc
            if 0 <= y < rows and tile_lo <= x < tile_hi:
                counter += _MODE_2_COUNTER[grid[y * cols + x].mode]
        ctx = _COUNTER_TO_CONTEXT[counter]
        allow_hp = self.h.allow_hp
        if self.seg.feature(b.seg, SEG_SKIP) is not None:
            if b.sb < BLOCK_8X8:
                raise ValueError("a VP9 block under 8x8 in a segment that skips")
            b.mode = ZEROMV
        elif b.sb >= BLOCK_8X8:
            b.mode = NEARESTMV + br.tree(_INTER_MODE_TREE, fc["inter_mode"][ctx])
            if tally:
                tally.inter_mode[ctx][b.mode - NEARESTMV] += 1
        b.filt = self._filter(b)
        if b.sb >= BLOCK_8X8:
            mode = b.mode
            mvs = []
            for ref in refs:
                if mode == ZEROMV:
                    mvs.append((0, 0))
                    continue
                lst = [_lower_precision(mv, allow_hp) for mv in self._mv_refs(b, ref, -1)]
                mvs.append(lst[0] if mode == NEWMV else lst[mode - NEARESTMV])
            if mode == NEWMV:
                mvs = [self._read_mv(best) for best in mvs]
            b.mv, b.mv1 = mvs[0], mvs[-1] if len(refs) == 2 else (0, 0)
            b.bmvs = b.bmvs1 = None
            cnt[MODE_NAMES[mode]] += 1
        else:
            n4w = 1 if b.sb in (BLOCK_4X4, BLOCK_4X8) else 2
            n4h = 1 if b.sb in (BLOCK_4X4, BLOCK_8X4) else 2
            bmvs = [[None] * 4 for _ in refs]
            best = None
            for idy in range(0, 2, n4h):
                for idx in range(0, 2, n4w):
                    j = idy * 2 + idx
                    mode = NEARESTMV + br.tree(_INTER_MODE_TREE, fc["inter_mode"][ctx])
                    if tally:
                        tally.inter_mode[ctx][mode - NEARESTMV] += 1
                    if mode == NEWMV and best is None:
                        best = [_lower_precision(self._mv_refs(b, ref, -1)[0], allow_hp) for ref in refs]
                    for k, ref in enumerate(refs):
                        if mode == NEWMV:
                            mv = self._read_mv(best[k])
                        elif mode == ZEROMV:
                            mv = (0, 0)
                        else:
                            mv = self._sub8x8_mv(b, ref, j, bmvs[k], mode == NEARMV)
                        bmvs[k][j] = mv
                        if n4h == 2:
                            bmvs[k][j + 2] = mv
                        if n4w == 2:
                            bmvs[k][j + 1] = mv
                    cnt["sub8x8_" + MODE_NAMES[mode]] += 1
            b.mode, b.bmvs = mode, tuple(bmvs[0])
            b.bmvs1 = tuple(bmvs[1]) if len(refs) == 2 else None
            b.mv, b.mv1 = b.bmvs[3], b.bmvs1[3] if b.bmvs1 else (0, 0)
        b.bmodes = (DC_PRED,) * 4
        b.uv = DC_PRED

    def _filter(self, b) -> int:
        h = self.h
        if h.interp != SWITCHABLE:
            return h.interp
        above, left = b.above, b.left
        lt = left.filt if left and left.inter else 3
        at = above.filt if above and above.inter else 3
        ctx = lt if lt == at else at if lt == 3 else lt if at == 3 else 3
        f = self.br.tree(_SWITCHABLE_TREE, self.fc["interp"][ctx])
        self.counts["switchable_" + FILTER_NAMES[f]] += 1
        if self.tally:
            self.tally.interp[ctx][f] += 1
        return f

    def _mv_refs(self, b, ref: int, block: int) -> List[Tuple[int, int]]:
        """libvpx's find_mv_refs: two candidate vectors, clamped to 16 pixels
        past the frame. A neighbour's vector for either of its references
        counts; one for another reference is negated where the two
        references' sign biases differ."""
        r, c, sb = b.r, b.c, b.sb
        c0, c1 = self.tile
        grid, cols, rows = self.grid, self.mi_cols, self.mi_rows
        bias = self.h.sign_bias
        found: List[Tuple[int, int]] = []
        positions = [(i, grid[(r + dr) * cols + c + dc]) for i, (dr, dc) in enumerate(_MV_REF_BLOCKS[sb])
                     if 0 <= r + dr < rows and c0 <= c + dc < c1]

        def add(mv) -> bool:
            if not found:
                found.append(mv)
                return False
            if mv != found[0]:
                found.append(mv)
                return True
            return False

        def scaled(mv, cand_ref):
            return (-mv[0], -mv[1]) if bias[cand_ref] != bias[ref] else mv

        def first_pass() -> bool:
            for i, cand in positions:
                if cand.ref == ref or cand.ref1 == ref:
                    second = cand.ref != ref
                    if i < 2 and block >= 0 and cand.sb < BLOCK_8X8:
                        col = _MV_REF_BLOCKS[sb][i][1]
                        mv = (cand.bmvs1 if second else cand.bmvs)[_IDX_N_COLUMN_TO_SUBBLOCK[block][col == 0]]
                    else:
                        mv = cand.mv1 if second else cand.mv
                    if add(mv):
                        return True
            prev = self.prev_grid[r * cols + c] if self.prev_grid else None
            if prev is not None:
                if prev.ref == ref:
                    if add(prev.mv):
                        return True
                elif prev.ref1 == ref and add(prev.mv1):
                    return True
            for i, cand in positions:
                if cand.inter:
                    if cand.ref != ref and add(scaled(cand.mv, cand.ref)):
                        return True
                    if cand.ref1 > INTRA_FRAME and cand.ref1 != ref and cand.mv1 != cand.mv and \
                            add(scaled(cand.mv1, cand.ref1)):
                        return True
            if prev is not None:
                if prev.ref != ref and prev.ref > INTRA_FRAME and add(scaled(prev.mv, prev.ref)):
                    return True
                if prev.ref1 > INTRA_FRAME and prev.ref1 != ref and prev.mv1 != prev.mv and \
                        add(scaled(prev.mv1, prev.ref1)):
                    return True
            return False

        first_pass()
        while len(found) < 2:
            found.append((0, 0))
        bw, bh = _BW8[sb], _BH8[sb]
        lo_c, hi_c = -(c * 64) - _MV_BORDER, (cols - bw - c) * 64 + _MV_BORDER
        lo_r, hi_r = -(r * 64) - _MV_BORDER, (rows - bh - r) * 64 + _MV_BORDER
        return [(min(max(mr, lo_r), hi_r), min(max(mc, lo_c), hi_c)) for mr, mc in found[:2]]

    def _sub8x8_mv(self, b, ref: int, block: int, bmvs, near: bool) -> Tuple[int, int]:
        """NEARESTMV or NEARMV of sub-block `block` for reference `ref`, whose
        earlier sub-blocks' vectors are `bmvs` (libvpx's
        append_sub8x8_mvs_for_idx)."""
        lst = self._mv_refs(b, ref, block)
        if block == 0:
            return lst[1] if near else lst[0]
        if block in (1, 2):
            nearest = bmvs[0]
            cands = lst
        else:
            nearest = bmvs[2]
            cands = [bmvs[1], bmvs[0], lst[0], lst[1]]
        if not near:
            return nearest
        for mv in cands:
            if mv != nearest:
                return mv
        return (0, 0)

    def _read_mv(self, best: Tuple[int, int]) -> Tuple[int, int]:
        br, fc, tally = self.br, self.fc, self.tally
        use_hp = self.h.allow_hp and abs(best[0]) < 64 and abs(best[1]) < 64
        joint = br.tree(_MV_JOINT_TREE, fc["mv_joints"])
        dr = self._mv_component(0, use_hp) if joint in (2, 3) else 0
        dc = self._mv_component(1, use_hp) if joint in (1, 3) else 0
        self.counts["mv_joint_%d" % joint] += 1
        if tally:
            tally.mv_joints[joint] += 1
        return best[0] + dr, best[1] + dc

    def _mv_component(self, i: int, use_hp: bool) -> int:
        br, cnt, comp = self.br, self.counts, self.fc["mv"][i]
        sign = br.bool(comp["sign"][0])
        cls = br.tree(_MV_CLASS_TREE, comp["classes"])
        if cls == 0:
            d = br.bool(comp["class0"][0])
            mag = 0
            fr = br.tree(_MV_FP_TREE, comp["class0_fp"][d])
            hp = br.bool(comp["class0_hp"][0]) if use_hp else 1
        else:
            d = 0
            for k in range(cls):
                d |= br.bool(comp["bits"][k]) << k
            mag = 2 << (cls + 2)
            fr = br.tree(_MV_FP_TREE, comp["fp"])
            hp = br.bool(comp["hp"][0]) if use_hp else 1
        cnt["mv_class0" if cls == 0 else "mv_class_n"] += 1
        if use_hp:
            cnt["mv_hp_bit"] += 1
        if self.tally:  # vp9_inc_mv: an implied high-precision bit (1) is counted too
            t = self.tally.mv[i]
            t["sign"][sign] += 1
            t["classes"][cls] += 1
            if cls == 0:
                t["class0"][d] += 1
                t["class0_fp"][d][fr] += 1
                t["class0_hp"][hp] += 1
            else:
                for k in range(cls):
                    t["bits"][k][(d >> k) & 1] += 1
                t["fp"][fr] += 1
                t["hp"][hp] += 1
        mag += ((d << 3) | (fr << 1) | hp) + 1
        return -mag if sign else mag

    # ---------------------------------------------------------- frames
    def decode(self, data: bytes) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Decode one container block: every frame of a superframe in turn.
        Returns the last frame's planes if it is shown (as libvpx outputs
        a block), else None."""
        out = None
        for frame in self._frames(data):
            out = self._decode_frame(frame)
        return out

    def _decode_frame(self, data: bytes) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        h, fc = self._frame_header(data)
        if h.existing is not None:  # libvpx leaves every state of the stream as it was
            return tuple(p.copy() for p in self.slots[h.existing])
        cnt = self.counts
        w, ht = h.width, h.height
        self.mi_cols, self.mi_rows = (w + 7) >> 3, (ht + 7) >> 3
        # use_prev_frame_mvs: the last frame decoded was shown, not intra-only, of this size; this one not
        # error-resilient (after a hidden frame no vectors carry over)
        prev = self.prev
        self.prev_grid = None
        if prev is not None and prev[0] == (w, ht) and not h.error_res and not h.intra:
            self.prev_grid = prev[1]
            cnt["prev_frame_mvs"] += 1
        self._parse(data, h, fc)
        if h.adapt:
            _adapt(fc, self.contexts[h.ctx_idx], self.tally, h)
        if h.refresh_ctx:
            self.contexts[h.ctx_idx] = fc
        planes = self._reconstruct(h)
        if h.lf_level:
            cnt["loop_filter"] += 1
            _loop_filter(planes, self.grid, self._levels(h), self.mi_cols, self.mi_rows, h.sharpness)
        else:
            cnt["loop_filter_off"] += 1
        Y = planes[0][:ht, :w].astype(np.uint8)
        U = planes[1][:(ht + 1) >> 1, :(w + 1) >> 1].astype(np.uint8)
        V = planes[2][:(ht + 1) >> 1, :(w + 1) >> 1].astype(np.uint8)
        for i in range(8):
            if h.refresh >> i & 1:
                self.slots[i] = (Y, U, V)
                self.slot_size[i] = (w, ht)
                cnt[f"refresh_slot_{i}"] += 1
        self.prev = ((w, ht), self.grid) if h.show else None
        self.last_key = h.key
        self.grid = self.blocks = self.intra_ops = self.inter_res = self.prev_grid = self.tally = None
        return (Y.copy(), U.copy(), V.copy()) if h.show else None

    def _levels(self, h: _Header) -> List[int]:
        """Each 8x8 unit's loop filter level: the frame's, or its segment's,
        moved by the reference's and the inter mode's deltas (scaled by 2
        from frame level 32)."""
        lvl0 = h.lf_level
        scale = 1 << (lvl0 >> 5)
        seg = self.seg
        by_seg = []
        for i in range(8):
            alt = seg.feature(i, SEG_ALT_LF)
            by_seg.append(lvl0 if alt is None else min(max(alt if seg.abs_delta else lvl0 + alt, 0), 63))
        by_block = {}
        out = []
        for b in self.grid:
            v = by_block.get(id(b))
            if v is None:
                v = by_seg[b.seg]
                if not h.lf_deltas:
                    pass
                elif b.ref == INTRA_FRAME:
                    v += h.ref_deltas[0] * scale
                else:
                    v += h.ref_deltas[b.ref] * scale + h.mode_deltas[int(b.mode != ZEROMV)] * scale
                v = min(max(v, 0), 63)
                by_block[id(b)] = v
            out.append(v)
        return out

    def _reconstruct(self, h: _Header) -> List[np.ndarray]:
        """Residuals batched by transform size and type, inter blocks
        predicted in gathers, then intra blocks in decoding order."""
        cnt = self.counts
        sbh, sbw = ((self.mi_rows + 7) >> 3) * 64, ((self.mi_cols + 7) >> 3) * 64
        planes = [np.zeros((sbh, sbw), np.int32), np.zeros((sbh >> 1, sbw >> 1), np.int32),
                  np.zeros((sbh >> 1, sbw >> 1), np.int32)]
        res = []
        for t in range(4):
            n, size = self.n_res[t], 4 << t
            coefs = np.zeros(n * size * size, np.int64)
            if n:
                coefs[np.asarray(self.coef_pos[t], np.int64)] = self.coef_val[t]
            coefs = coefs.reshape(n, size, size)
            out = np.zeros((n, size, size), np.int64)
            types = np.asarray(self.res_type[t], np.int64)
            for tt in range(5):
                sel = np.nonzero(types == tt)[0]
                if len(sel):
                    out[sel] = inverse_transform(coefs[sel], t, tt)
            res.append(out)
        # inter prediction: every block's first reference, then the second of compound blocks, averaged in
        groups: Dict[tuple, list] = {}
        for b in self.blocks:
            if not b.inter:
                continue
            r, c, sb = b.r, b.c, b.sb
            for second, (ref, mv, bmvs) in enumerate(((b.ref, b.mv, b.bmvs), (b.ref1, b.mv1, b.bmvs1))):
                if ref <= INTRA_FRAME:
                    break
                key = (second, h.ref_idx[ref - 1])
                if sb >= BLOCK_8X8:
                    my, mx = mv
                    groups.setdefault(key + (0, _BH8[sb] * 8, _BW8[sb] * 8, b.filt), []).append(
                        (r * 8, c * 8, my * 2, mx * 2))
                    for p in (1, 2):
                        groups.setdefault(key + (p, _BH8[sb] * 4, _BW8[sb] * 4, b.filt), []).append(
                            (r * 4, c * 4, my, mx))
                else:
                    for i, (my, mx) in enumerate(bmvs):
                        groups.setdefault(key + (0, 4, 4, b.filt), []).append(
                            (r * 8 + 4 * (i >> 1), c * 8 + 4 * (i & 1), my * 2, mx * 2))
                    sy, sx = sum(m[0] for m in bmvs), sum(m[1] for m in bmvs)
                    my, mx = int((sy - 2 if sy < 0 else sy + 2) / 4), int((sx - 2 if sx < 0 else sx + 2) / 4)
                    for p in (1, 2):
                        groups.setdefault(key + (p, 4, 4, b.filt), []).append((r * 4, c * 4, my, mx))
        for (second, slot, p, bh, bw, filt) in sorted(groups):
            a = np.array(groups[(second, slot, p, bh, bw, filt)], np.int64)
            pred = predict_inter(self.slots[slot][p], a[:, 0], a[:, 1], a[:, 2], a[:, 3], bh, bw, _FILTERS[filt])
            rows = a[:, 0, None] + np.arange(bh)
            cols = a[:, 1, None] + np.arange(bw)
            ix = (rows[:, :, None], cols[:, None, :])
            planes[p][ix] = compound_average(planes[p][ix], pred) if second else pred
            cnt[f"inter_{FILTER_NAMES[filt]}"] += 1
            if second:
                cnt["inter_compound"] += 1
        byk: Dict[tuple, list] = {}
        for plane, t, slot, y0, x0 in self.inter_res:
            byk.setdefault((plane, t), []).append((slot, y0, x0))
        for (plane, t), items in byk.items():
            a = np.array(items, np.int64)
            n = 4 << t
            rows = a[:, 1, None] + np.arange(n)
            cols = a[:, 2, None] + np.arange(n)
            dst = planes[plane]
            ix = (rows[:, :, None], cols[:, None, :])
            dst[ix] = np.clip(dst[ix] + res[t][a[:, 0]], 0, 255)
        # intra prediction, in decoding order
        fws = (self.mi_cols * 8, self.mi_cols * 4, self.mi_cols * 4)
        fhs = (self.mi_rows * 8, self.mi_rows * 4, self.mi_rows * 4)
        for plane, t, slot, y0, x0, mode, top, left, right in self.intra_ops:
            dst = planes[plane]
            pred = predict_intra(dst, fws[plane], fhs[plane], y0, x0, t, mode, top, left, right)
            n = 4 << t
            if slot >= 0:
                pred = np.clip(pred + res[t][slot], 0, 255)
            dst[y0:y0 + n, x0:x0 + n] = pred
        return planes

    # ---------------------------------------------------------- tokens
    def _tokens(self, b) -> None:
        """The block's coefficient tokens, plane by plane, transform blocks in
        raster order; the non-zero contexts; and the reconstruction records."""
        sb, r, c = b.sb, b.r, b.c
        cols, rows = self.mi_cols, self.mi_rows
        above_nz, left_nz = self.above_nz, self.left_nz
        probs_all = self.fc["coef"]
        tally, lossless = self.tally, self.h.lossless
        eob_total = 0
        for plane in range(3):
            if plane == 0:
                n4w, n4h = (2, 2) if sb < BLOCK_8X8 else (_BW4[sb], _BH4[sb])
                tx = b.tx
                max_w, max_h = min(n4w, (cols - c) * 2), min(n4h, (rows - r) * 2)
                ax, ly = c * 2, (r & 7) * 2
            else:
                n4w, n4h = (1, 1) if sb < BLOCK_8X8 else (_BW4[sb] >> 1, _BH4[sb] >> 1)
                tx = min(b.tx, _UV_MAX_TX[sb])
                max_w, max_h = min(n4w, cols - c), min(n4h, rows - r)
                ax, ly = c, r & 7
            a_ctx, l_ctx = above_nz[plane], left_nz[plane]
            if b.skip:
                a_ctx[ax:ax + n4w] = [0] * n4w
                l_ctx[ly:ly + n4h] = [0] * n4h
            step = 1 << tx
            if b.skip and b.inter:
                continue
            probs = probs_all[tx][plane > 0][b.inter]
            dqdc, dqac = self.dq[b.seg][plane > 0]
            for row in range(0, max_h, step):
                for col in range(0, max_w, step):
                    if b.inter:
                        tx_type, mode = DCT_DCT, None
                    elif plane:
                        tx_type, mode = DCT_DCT, b.uv
                    else:
                        mode = b.bmodes[(row << 1) + col] if sb < BLOCK_8X8 else b.mode
                        tx_type = _MODE_TX_TYPE[mode] if tx < 3 and not lossless else DCT_DCT
                    slot = -1
                    if not b.skip:
                        ctx = int(any(a_ctx[ax + col:ax + col + step])) + int(any(l_ctx[ly + row:ly + row + step]))
                        scan, nb = _SCANS[tx][tx_type]
                        slot = self.n_res[tx]
                        args = (self.br, probs, _BAND_4X4 if tx == 0 else _BAND_8X8, scan, nb, 16 << (tx << 1), ctx,
                                dqdc, dqac, int(tx == 3), self.coef_pos[tx], self.coef_val[tx], slot << (4 + 2 * tx))
                        if tally:
                            eob = _coefs_tallied(*args, tally.coef[tx][plane > 0][b.inter],
                                                 tally.eob[tx][plane > 0][b.inter])
                        else:
                            eob = _coefs(*args)
                        has = int(eob > 0)
                        na = min(step, max_w - col)
                        a_ctx[ax + col:ax + col + step] = [has] * na + [0] * (step - na)
                        nl = min(step, max_h - row)
                        l_ctx[ly + row:ly + row + step] = [has] * nl + [0] * (step - nl)
                        if eob:
                            if lossless:
                                tx_type = WHT_WHT
                            self.n_res[tx] = slot + 1
                            self.res_type[tx].append(tx_type)
                            eob_total += 1
                            self.counts[f"tx_type_{TX_TYPE_NAMES[tx_type]}"] += 1
                        else:
                            slot = -1
                    x0, y0 = (ax + col) * 4, ((r * 2 >> (plane > 0)) + row) * 4
                    if b.inter:
                        if slot >= 0:
                            self.inter_res.append((plane, tx, slot, y0, x0))
                    else:
                        have_top = bool(row) or b.above is not None
                        have_left = bool(col) or b.left is not None
                        have_right = col + step < n4w
                        self.intra_ops.append((plane, tx, slot, y0, x0, mode, have_top, have_left, have_right))
        if b.inter and not b.skip and sb >= BLOCK_8X8 and not eob_total:
            b.skip = 1  # no coefficients: the loop filter skips its inner edges, later contexts see a skip
            self.counts["skip_no_coefficients"] += 1


class _Block:
    __slots__ = ("r", "c", "sb", "skip", "tx", "inter", "ref", "ref1", "mode", "uv", "bmodes", "mv", "mv1", "bmvs",
                 "bmvs1", "filt", "seg", "seg_pred", "above", "left")


# reference contexts (libvpx's vp9_pred_common.c); a block's second reference `ref1` is NONE_FRAME unless compound


def _comp_inter_ctx(above, left, fixed: int) -> int:
    """vp9_get_reference_mode_context: single or compound, by the neighbours."""
    if above and left:
        a2, l2 = above.ref1 > INTRA_FRAME, left.ref1 > INTRA_FRAME
        if not a2 and not l2:
            return (above.ref == fixed) ^ (left.ref == fixed)
        if not a2:
            return 2 + (above.ref == fixed or not above.inter)
        if not l2:
            return 2 + (left.ref == fixed or not left.inter)
        return 4
    if above or left:
        e = above or left
        return 3 if e.ref1 > INTRA_FRAME else int(e.ref == fixed)
    return 1


def _comp_ref_ctx(above, left, fixed: int, var, var_idx: int) -> int:
    """vp9_get_pred_context_comp_ref_p: which variable reference, by the neighbours."""
    def var_ref(e):
        return e.ref if e.ref1 <= INTRA_FRAME else (e.ref, e.ref1)[var_idx]

    if above and left:
        ai, li = not above.inter, not left.inter
        if ai and li:
            return 2
        if ai or li:
            return 1 + 2 * (var_ref(left if ai else above) != var[1])
        a_sg, l_sg = above.ref1 <= INTRA_FRAME, left.ref1 <= INTRA_FRAME
        vrfa, vrfl = var_ref(above), var_ref(left)
        if vrfa == vrfl and var[1] == vrfa:
            return 0
        if l_sg and a_sg:
            if (vrfa == fixed and vrfl == var[0]) or (vrfl == fixed and vrfa == var[0]):
                return 4
            return 3 if vrfa == vrfl else 1
        if l_sg or a_sg:
            vrfc, rfs = (vrfa, vrfl) if l_sg else (vrfl, vrfa)
            if vrfc == var[1] and rfs != var[1]:
                return 1
            if rfs == var[1] and vrfc != var[1]:
                return 2
            return 4
        return 4 if vrfa == vrfl else 2
    if above or left:
        e = above or left
        if not e.inter:
            return 2
        return 4 * (var_ref(e) != var[1]) if e.ref1 > INTRA_FRAME else 3 * (e.ref != var[1])
    return 2


def _single_ref_p1_ctx(above, left) -> int:
    """vp9_get_pred_context_single_ref_p1: LAST or not, by the neighbours."""
    if above and left:
        ai, li = not above.inter, not left.inter
        if ai and li:
            return 2
        if ai or li:
            e = left if ai else above
            if e.ref1 <= INTRA_FRAME:
                return 4 * (e.ref == LAST_FRAME)
            return 1 + (e.ref == LAST_FRAME or e.ref1 == LAST_FRAME)
        a2, l2 = above.ref1 > INTRA_FRAME, left.ref1 > INTRA_FRAME
        if a2 and l2:
            return 1 + (LAST_FRAME in (above.ref, above.ref1, left.ref, left.ref1))
        if a2 or l2:
            rfs = left.ref if a2 else above.ref
            crf = (above.ref, above.ref1) if a2 else (left.ref, left.ref1)
            return (3 if rfs == LAST_FRAME else 0) + (LAST_FRAME in crf)
        return 2 * (above.ref == LAST_FRAME) + 2 * (left.ref == LAST_FRAME)
    if above or left:
        e = above or left
        if not e.inter:
            return 2
        if e.ref1 <= INTRA_FRAME:
            return 4 * (e.ref == LAST_FRAME)
        return 1 + (e.ref == LAST_FRAME or e.ref1 == LAST_FRAME)
    return 2


def _single_ref_p2_ctx(above, left) -> int:
    """vp9_get_pred_context_single_ref_p2: GOLDEN or ALTREF, by the neighbours."""
    if above and left:
        ai, li = not above.inter, not left.inter
        if ai and li:
            return 2
        if ai or li:
            e = left if ai else above
            if e.ref1 <= INTRA_FRAME:
                return 3 if e.ref == LAST_FRAME else 4 * (e.ref == GOLDEN_FRAME)
            return 1 + 2 * (e.ref == GOLDEN_FRAME or e.ref1 == GOLDEN_FRAME)
        a2, l2 = above.ref1 > INTRA_FRAME, left.ref1 > INTRA_FRAME
        a0, a1, l0, l1 = above.ref, above.ref1, left.ref, left.ref1
        if a2 and l2:
            if a0 == l0 and a1 == l1:
                return 3 * (GOLDEN_FRAME in (a0, a1, l0, l1))
            return 2
        if a2 or l2:
            rfs = l0 if a2 else a0
            crf = (a0, a1) if a2 else (l0, l1)
            g = GOLDEN_FRAME in crf
            if rfs == GOLDEN_FRAME:
                return 3 + g
            if rfs == ALTREF_FRAME:
                return int(g)
            return 1 + 2 * g
        if a0 == LAST_FRAME and l0 == LAST_FRAME:
            return 3
        if a0 == LAST_FRAME or l0 == LAST_FRAME:
            return 4 * ((l0 if a0 == LAST_FRAME else a0) == GOLDEN_FRAME)
        return 2 * (a0 == GOLDEN_FRAME) + 2 * (l0 == GOLDEN_FRAME)
    if above or left:
        e = above or left
        if not e.inter or (e.ref == LAST_FRAME and e.ref1 <= INTRA_FRAME):
            return 2
        if e.ref1 <= INTRA_FRAME:
            return 4 * (e.ref == GOLDEN_FRAME)
        return 3 * (e.ref == GOLDEN_FRAME or e.ref1 == GOLDEN_FRAME)
    return 2


def _lower_precision(mv: Tuple[int, int], allow_hp: int) -> Tuple[int, int]:
    r, c = mv
    if allow_hp and abs(r) < 64 and abs(c) < 64:
        return mv
    if r & 1:
        r += -1 if r > 0 else 1
    if c & 1:
        c += -1 if c > 0 else 1
    return r, c


def _coefs(br: _Bool, probs, bands, scan, nb, n: int, ctx: int, dqdc: int, dqac: int, shift: int, out_pos: List[int],
           out_val: List[int], base: int) -> int:
    """One transform block's tokens (libvpx's decode_coefs): dequantised
    values go to out_pos/out_val at base + raster position. Returns the
    end of block."""
    val, rng, nbits, words, k = br.val, br.rng, br.nb, br.words, br.k
    nw = len(words)
    norm = _NORM
    cache = [0] * n
    c = 0
    dqv = dqdc
    while c < n:
        p = probs[bands[c]][ctx]
        # more coefficients? (p[0])
        split = 1 + (((rng - 1) * p[0]) >> 8)
        big = split << nbits
        if val >= big:
            rng -= split
            val -= big
            bit = 1
        else:
            rng = split
            bit = 0
        s = norm[rng]
        if s:
            rng <<= s
            nbits -= s
            if nbits < 0:
                val = (val << 32) | (words[k] if k < nw else 0)
                k += 1
                nbits += 32
        if not bit:
            break
        while True:  # zero tokens (p[1])
            split = 1 + (((rng - 1) * p[1]) >> 8)
            big = split << nbits
            if val >= big:
                rng -= split
                val -= big
                bit = 1
            else:
                rng = split
                bit = 0
            s = norm[rng]
            if s:
                rng <<= s
                nbits -= s
                if nbits < 0:
                    val = (val << 32) | (words[k] if k < nw else 0)
                    k += 1
                    nbits += 32
            if bit:
                break
            dqv = dqac
            cache[scan[c]] = 0
            c += 1
            if c >= n:
                br.val, br.rng, br.nb, br.k = val, rng, nbits, k
                return c
            ctx = (1 + cache[nb[2 * c]] + cache[nb[2 * c + 1]]) >> 1
            p = probs[bands[c]][ctx]
        # one (p[2]) or more
        split = 1 + (((rng - 1) * p[2]) >> 8)
        big = split << nbits
        if val >= big:
            rng -= split
            val -= big
            bit = 1
        else:
            rng = split
            bit = 0
        s = norm[rng]
        if s:
            rng <<= s
            nbits -= s
            if nbits < 0:
                val = (val << 32) | (words[k] if k < nw else 0)
                k += 1
                nbits += 32
        if not bit:
            tok = v = 1
        else:
            pp = _PARETO[p[2] - 1]
            node = 0
            while True:
                split = 1 + (((rng - 1) * pp[node >> 1]) >> 8)
                big = split << nbits
                if val >= big:
                    rng -= split
                    val -= big
                    node = _COEF_CON_TREE[node + 1]
                else:
                    rng = split
                    node = _COEF_CON_TREE[node]
                s = norm[rng]
                if s:
                    rng <<= s
                    nbits -= s
                    if nbits < 0:
                        val = (val << 32) | (words[k] if k < nw else 0)
                        k += 1
                        nbits += 32
                if node <= 0:
                    break
            tok = -node
            if tok <= 4:
                v = tok
            else:
                v = 0
                for prob in _CAT_PROBS[tok - 5]:
                    split = 1 + (((rng - 1) * prob) >> 8)
                    big = split << nbits
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
                        nbits -= s
                        if nbits < 0:
                            val = (val << 32) | (words[k] if k < nw else 0)
                            k += 1
                            nbits += 32
                v += _CAT_BASE[tok - 5]
        v = (v * dqv) >> shift
        split = 1 + ((rng - 1) >> 1)  # the sign
        big = split << nbits
        if val >= big:
            rng -= split
            val -= big
            v = -v
        else:
            rng = split
        s = norm[rng]
        if s:
            rng <<= s
            nbits -= s
            if nbits < 0:
                val = (val << 32) | (words[k] if k < nw else 0)
                k += 1
                nbits += 32
        rc = scan[c]
        out_pos.append(base + rc)
        out_val.append(v)
        cache[rc] = _ENERGY[tok]
        c += 1
        if c < n:
            ctx = (1 + cache[nb[2 * c]] + cache[nb[2 * c + 1]]) >> 1
        dqv = dqac
    br.val, br.rng, br.nb, br.k = val, rng, nbits, k
    return c


def _coefs_tallied(br: _Bool, probs, bands, scan, nb, n: int, ctx: int, dqdc: int, dqac: int, shift: int,
                   out_pos: List[int], out_val: List[int], base: int, tally: List[int], eob_branch: List[int]) -> int:
    """`_coefs`, counting as libvpx's decode_coefs counts for backward
    adaptation: at index (band * 6 + context) * 4 of `tally` each zero,
    one, larger token (+0, +1, +2) and end of block (+3), and in
    `eob_branch` each more-coefficients read. A twin of `_coefs`, so that
    frames that do not adapt decode without counting."""
    val, rng, nbits, words, kw = br.val, br.rng, br.nb, br.words, br.k
    nw = len(words)
    norm = _NORM
    cache = [0] * n
    c = 0
    dqv = dqdc
    while c < n:
        k = bands[c] * 6 + ctx
        eob_branch[k] += 1
        p = probs[bands[c]][ctx]
        # more coefficients? (p[0])
        split = 1 + (((rng - 1) * p[0]) >> 8)
        big = split << nbits
        if val >= big:
            rng -= split
            val -= big
            bit = 1
        else:
            rng = split
            bit = 0
        s = norm[rng]
        if s:
            rng <<= s
            nbits -= s
            if nbits < 0:
                val = (val << 32) | (words[kw] if kw < nw else 0)
                kw += 1
                nbits += 32
        if not bit:
            tally[4 * k + 3] += 1
            break
        while True:  # zero tokens (p[1])
            split = 1 + (((rng - 1) * p[1]) >> 8)
            big = split << nbits
            if val >= big:
                rng -= split
                val -= big
                bit = 1
            else:
                rng = split
                bit = 0
            s = norm[rng]
            if s:
                rng <<= s
                nbits -= s
                if nbits < 0:
                    val = (val << 32) | (words[kw] if kw < nw else 0)
                    kw += 1
                    nbits += 32
            if bit:
                break
            tally[4 * k] += 1
            dqv = dqac
            cache[scan[c]] = 0
            c += 1
            if c >= n:
                br.val, br.rng, br.nb, br.k = val, rng, nbits, kw
                return c
            ctx = (1 + cache[nb[2 * c]] + cache[nb[2 * c + 1]]) >> 1
            k = bands[c] * 6 + ctx
            p = probs[bands[c]][ctx]
        # one (p[2]) or more
        split = 1 + (((rng - 1) * p[2]) >> 8)
        big = split << nbits
        if val >= big:
            rng -= split
            val -= big
            bit = 1
        else:
            rng = split
            bit = 0
        s = norm[rng]
        if s:
            rng <<= s
            nbits -= s
            if nbits < 0:
                val = (val << 32) | (words[kw] if kw < nw else 0)
                kw += 1
                nbits += 32
        if not bit:
            tok = v = 1
            tally[4 * k + 1] += 1
        else:
            tally[4 * k + 2] += 1
            pp = _PARETO[p[2] - 1]
            node = 0
            while True:
                split = 1 + (((rng - 1) * pp[node >> 1]) >> 8)
                big = split << nbits
                if val >= big:
                    rng -= split
                    val -= big
                    node = _COEF_CON_TREE[node + 1]
                else:
                    rng = split
                    node = _COEF_CON_TREE[node]
                s = norm[rng]
                if s:
                    rng <<= s
                    nbits -= s
                    if nbits < 0:
                        val = (val << 32) | (words[kw] if kw < nw else 0)
                        kw += 1
                        nbits += 32
                if node <= 0:
                    break
            tok = -node
            if tok <= 4:
                v = tok
            else:
                v = 0
                for prob in _CAT_PROBS[tok - 5]:
                    split = 1 + (((rng - 1) * prob) >> 8)
                    big = split << nbits
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
                        nbits -= s
                        if nbits < 0:
                            val = (val << 32) | (words[kw] if kw < nw else 0)
                            kw += 1
                            nbits += 32
                v += _CAT_BASE[tok - 5]
        v = (v * dqv) >> shift
        split = 1 + ((rng - 1) >> 1)  # the sign
        big = split << nbits
        if val >= big:
            rng -= split
            val -= big
            v = -v
        else:
            rng = split
        s = norm[rng]
        if s:
            rng <<= s
            nbits -= s
            if nbits < 0:
                val = (val << 32) | (words[kw] if kw < nw else 0)
                kw += 1
                nbits += 32
        rc = scan[c]
        out_pos.append(base + rc)
        out_val.append(v)
        cache[rc] = _ENERGY[tok]
        c += 1
        if c < n:
            ctx = (1 + cache[nb[2 * c]] + cache[nb[2 * c + 1]]) >> 1
        dqv = dqac
    br.val, br.rng, br.nb, br.k = val, rng, nbits, kw
    return c


# --------------------------------------------------------------- transforms

_COS = [int(round(16384 * np.cos(k * np.pi / 64))) for k in range(33)]
_SIN9 = (0, 5283, 9929, 13377, 15212)


def _r14(x):
    return (x + 8192) >> 14


def _rot(a, b, ca: int, cb: int):
    """(round(a*ca - b*cb), round(a*cb + b*ca)): libvpx's butterfly rotation."""
    return _r14(a * ca - b * cb), _r14(a * cb + b * ca)


def idct4(x: List[np.ndarray]) -> List[np.ndarray]:
    c = _COS
    s0, s1 = _r14((x[0] + x[2]) * c[16]), _r14((x[0] - x[2]) * c[16])
    s2, s3 = _rot(x[1], x[3], c[24], c[8])
    return [s0 + s3, s1 + s2, s1 - s2, s0 - s3]


def iadst4(x: List[np.ndarray]) -> List[np.ndarray]:
    x0, x1, x2, x3 = x
    s = _SIN9
    s0 = s[1] * x0 + s[4] * x2 + s[2] * x3
    s1 = s[2] * x0 - s[1] * x2 - s[4] * x3
    s3 = s[3] * x1
    s2 = s[3] * (x0 - x2 + x3)
    return [_r14(s0 + s3), _r14(s1 + s3), _r14(s2), _r14(s0 + s1 - s3)]


def idct8(x: List[np.ndarray]) -> List[np.ndarray]:
    c = _COS
    e = idct4([x[0], x[2], x[4], x[6]])
    s4, s7 = _rot(x[1], x[7], c[28], c[4])
    s5, s6 = _rot(x[5], x[3], c[12], c[20])
    t4, t5, t6, t7 = s4 + s5, s4 - s5, s7 - s6, s6 + s7
    u5, u6 = _r14((t6 - t5) * c[16]), _r14((t5 + t6) * c[16])
    o = [t4, u5, u6, t7]
    return [e[0] + o[3], e[1] + o[2], e[2] + o[1], e[3] + o[0], e[3] - o[0], e[2] - o[1], e[1] - o[2], e[0] - o[3]]


def iadst8(x: List[np.ndarray]) -> List[np.ndarray]:
    c = _COS
    x0, x1, x2, x3, x4, x5, x6, x7 = x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]
    s0, s1 = c[2] * x0 + c[30] * x1, c[30] * x0 - c[2] * x1
    s2, s3 = c[10] * x2 + c[22] * x3, c[22] * x2 - c[10] * x3
    s4, s5 = c[18] * x4 + c[14] * x5, c[14] * x4 - c[18] * x5
    s6, s7 = c[26] * x6 + c[6] * x7, c[6] * x6 - c[26] * x7
    x0, x1, x2, x3 = _r14(s0 + s4), _r14(s1 + s5), _r14(s2 + s6), _r14(s3 + s7)
    x4, x5, x6, x7 = _r14(s0 - s4), _r14(s1 - s5), _r14(s2 - s6), _r14(s3 - s7)
    s4, s5 = c[8] * x4 + c[24] * x5, c[24] * x4 - c[8] * x5
    s6, s7 = -c[24] * x6 + c[8] * x7, c[8] * x6 + c[24] * x7
    x0, x1, x2, x3 = x0 + x2, x1 + x3, x0 - x2, x1 - x3
    x4, x5, x6, x7 = _r14(s4 + s6), _r14(s5 + s7), _r14(s4 - s6), _r14(s5 - s7)
    x2, x3 = _r14(c[16] * (x2 + x3)), _r14(c[16] * (x2 - x3))
    x6, x7 = _r14(c[16] * (x6 + x7)), _r14(c[16] * (x6 - x7))
    return [x0, -x4, x6, -x2, x3, -x7, x5, -x1]


def _idct16_odd(x):
    """The odd half of the 16-point inverse DCT, from inputs 1, 3, ..., 15."""
    c = _COS
    i1, i3, i5, i7, i9, i11, i13, i15 = x
    s8, s15 = _rot(i1, i15, c[30], c[2])
    s9, s14 = _rot(i9, i7, c[14], c[18])
    s10, s13 = _rot(i5, i11, c[22], c[10])
    s11, s12 = _rot(i13, i3, c[6], c[26])
    t8, t9, t10, t11 = s8 + s9, s8 - s9, -s10 + s11, s10 + s11
    t12, t13, t14, t15 = s12 + s13, s12 - s13, -s14 + s15, s14 + s15
    u9, u14 = _r14(-t9 * c[8] + t14 * c[24]), _r14(t9 * c[24] + t14 * c[8])
    u10, u13 = _r14(-t10 * c[24] - t13 * c[8]), _r14(-t10 * c[8] + t13 * c[24])
    v8, v9, v10, v11 = t8 + t11, u9 + u10, u9 - u10, t8 - t11
    v12, v13, v14, v15 = -t12 + t15, -u13 + u14, u13 + u14, t12 + t15
    w10, w13 = _r14((-v10 + v13) * c[16]), _r14((v10 + v13) * c[16])
    w11, w12 = _r14((-v11 + v12) * c[16]), _r14((v11 + v12) * c[16])
    return [v8, v9, w10, w11, w12, w13, v14, v15]


def idct16(x: List[np.ndarray]) -> List[np.ndarray]:
    e = idct8(x[0::2])
    o = _idct16_odd(x[1::2])
    return [e[i] + o[7 - i] for i in range(8)] + [e[7 - i] - o[i] for i in range(8)]


def iadst16(x: List[np.ndarray]) -> List[np.ndarray]:
    c = _COS
    x0, x1, x2, x3, x4, x5, x6, x7 = x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6]
    x8, x9, x10, x11, x12, x13, x14, x15 = x[7], x[8], x[5], x[10], x[3], x[12], x[1], x[14]
    s0, s1 = x0 * c[1] + x1 * c[31], x0 * c[31] - x1 * c[1]
    s2, s3 = x2 * c[5] + x3 * c[27], x2 * c[27] - x3 * c[5]
    s4, s5 = x4 * c[9] + x5 * c[23], x4 * c[23] - x5 * c[9]
    s6, s7 = x6 * c[13] + x7 * c[19], x6 * c[19] - x7 * c[13]
    s8, s9 = x8 * c[17] + x9 * c[15], x8 * c[15] - x9 * c[17]
    s10, s11 = x10 * c[21] + x11 * c[11], x10 * c[11] - x11 * c[21]
    s12, s13 = x12 * c[25] + x13 * c[7], x12 * c[7] - x13 * c[25]
    s14, s15 = x14 * c[29] + x15 * c[3], x14 * c[3] - x15 * c[29]
    x0, x1, x2, x3 = _r14(s0 + s8), _r14(s1 + s9), _r14(s2 + s10), _r14(s3 + s11)
    x4, x5, x6, x7 = _r14(s4 + s12), _r14(s5 + s13), _r14(s6 + s14), _r14(s7 + s15)
    x8, x9, x10, x11 = _r14(s0 - s8), _r14(s1 - s9), _r14(s2 - s10), _r14(s3 - s11)
    x12, x13, x14, x15 = _r14(s4 - s12), _r14(s5 - s13), _r14(s6 - s14), _r14(s7 - s15)
    s8, s9 = x8 * c[4] + x9 * c[28], x8 * c[28] - x9 * c[4]
    s10, s11 = x10 * c[20] + x11 * c[12], x10 * c[12] - x11 * c[20]
    s12, s13 = -x12 * c[28] + x13 * c[4], x12 * c[4] + x13 * c[28]
    s14, s15 = -x14 * c[12] + x15 * c[20], x14 * c[20] + x15 * c[12]
    x0, x1, x2, x3, x4, x5, x6, x7 = x0 + x4, x1 + x5, x2 + x6, x3 + x7, x0 - x4, x1 - x5, x2 - x6, x3 - x7
    x8, x9, x10, x11 = _r14(s8 + s12), _r14(s9 + s13), _r14(s10 + s14), _r14(s11 + s15)
    x12, x13, x14, x15 = _r14(s8 - s12), _r14(s9 - s13), _r14(s10 - s14), _r14(s11 - s15)
    s4, s5 = x4 * c[8] + x5 * c[24], x4 * c[24] - x5 * c[8]
    s6, s7 = -x6 * c[24] + x7 * c[8], x6 * c[8] + x7 * c[24]
    s12, s13 = x12 * c[8] + x13 * c[24], x12 * c[24] - x13 * c[8]
    s14, s15 = -x14 * c[24] + x15 * c[8], x14 * c[8] + x15 * c[24]
    x0, x1, x2, x3 = x0 + x2, x1 + x3, x0 - x2, x1 - x3
    x4, x5, x6, x7 = _r14(s4 + s6), _r14(s5 + s7), _r14(s4 - s6), _r14(s5 - s7)
    x8, x9, x10, x11 = x8 + x10, x9 + x11, x8 - x10, x9 - x11
    x12, x13, x14, x15 = _r14(s12 + s14), _r14(s13 + s15), _r14(s12 - s14), _r14(s13 - s15)
    x2, x3 = _r14(-c[16] * (x2 + x3)), _r14(c[16] * (x2 - x3))
    x6, x7 = _r14(c[16] * (x6 + x7)), _r14(c[16] * (-x6 + x7))
    x10, x11 = _r14(c[16] * (x10 + x11)), _r14(c[16] * (-x10 + x11))
    x14, x15 = _r14(-c[16] * (x14 + x15)), _r14(c[16] * (x14 - x15))
    return [x0, -x8, x12, -x4, x6, x14, x10, x2, x3, x11, x15, x7, x5, -x13, x9, -x1]


def _idct32_odd(x):
    """The odd half of the 32-point inverse DCT, from inputs 1, 3, ..., 31."""
    c = _COS
    i = {2 * k + 1: v for k, v in enumerate(x)}
    s = {}
    for lo, hi, a, b, ca in ((16, 31, 1, 31, 31), (17, 30, 17, 15, 15), (18, 29, 9, 23, 23), (19, 28, 25, 7, 7),
                             (20, 27, 5, 27, 27), (21, 26, 21, 11, 11), (22, 25, 13, 19, 19), (23, 24, 29, 3, 3)):
        s[lo], s[hi] = _rot(i[a], i[b], c[ca], c[32 - ca])
    t = {}
    for k in (16, 20, 24, 28):
        t[k], t[k + 1], t[k + 2], t[k + 3] = s[k] + s[k + 1], s[k] - s[k + 1], -s[k + 2] + s[k + 3], s[k + 2] + s[k + 3]
    u = dict(t)
    u[17], u[30] = _r14(-t[17] * c[4] + t[30] * c[28]), _r14(t[17] * c[28] + t[30] * c[4])
    u[18], u[29] = _r14(-t[18] * c[28] - t[29] * c[4]), _r14(-t[18] * c[4] + t[29] * c[28])
    u[21], u[26] = _r14(-t[21] * c[20] + t[26] * c[12]), _r14(t[21] * c[12] + t[26] * c[20])
    u[22], u[25] = _r14(-t[22] * c[12] - t[25] * c[20]), _r14(-t[22] * c[20] + t[25] * c[12])
    v = {16: u[16] + u[19], 17: u[17] + u[18], 18: u[17] - u[18], 19: u[16] - u[19],
         20: -u[20] + u[23], 21: -u[21] + u[22], 22: u[21] + u[22], 23: u[20] + u[23],
         24: u[24] + u[27], 25: u[25] + u[26], 26: u[25] - u[26], 27: u[24] - u[27],
         28: -u[28] + u[31], 29: -u[29] + u[30], 30: u[29] + u[30], 31: u[28] + u[31]}
    w = dict(v)
    w[18], w[29] = _r14(-v[18] * c[8] + v[29] * c[24]), _r14(v[18] * c[24] + v[29] * c[8])
    w[19], w[28] = _r14(-v[19] * c[8] + v[28] * c[24]), _r14(v[19] * c[24] + v[28] * c[8])
    w[20], w[27] = _r14(-v[20] * c[24] - v[27] * c[8]), _r14(-v[20] * c[8] + v[27] * c[24])
    w[21], w[26] = _r14(-v[21] * c[24] - v[26] * c[8]), _r14(-v[21] * c[8] + v[26] * c[24])
    y = {16: w[16] + w[23], 17: w[17] + w[22], 18: w[18] + w[21], 19: w[19] + w[20],
         20: w[19] - w[20], 21: w[18] - w[21], 22: w[17] - w[22], 23: w[16] - w[23],
         24: -w[24] + w[31], 25: -w[25] + w[30], 26: -w[26] + w[29], 27: -w[27] + w[28],
         28: w[27] + w[28], 29: w[26] + w[29], 30: w[25] + w[30], 31: w[24] + w[31]}
    z = dict(y)
    for lo, hi in ((20, 27), (21, 26), (22, 25), (23, 24)):
        z[lo], z[hi] = _r14((-y[lo] + y[hi]) * c[16]), _r14((y[lo] + y[hi]) * c[16])
    return [z[k] for k in range(16, 32)]


def idct32(x: List[np.ndarray]) -> List[np.ndarray]:
    e = idct16(x[0::2])
    o = _idct32_odd(x[1::2])
    return [e[i] + o[15 - i] for i in range(16)] + [e[15 - i] - o[i] for i in range(16)]


_ONE_D = {(0, 0): idct4, (0, 1): iadst4, (1, 0): idct8, (1, 1): iadst8, (2, 0): idct16, (2, 1): iadst16,
          (3, 0): idct32}


def iwht4(x: List[np.ndarray]) -> List[np.ndarray]:
    """The 4-point inverse Walsh-Hadamard lifting steps of libvpx's
    vpx_iwht4x4_16_add (lossless frames), on inputs (a, c, d, b)."""
    a, c, d, b = x
    a = a + c
    d = d - b
    e = (a - d) >> 1
    b = e - b
    c = e - c
    return [a - b, b, c, d + c]


def inverse_transform(coefs: np.ndarray, tx: int, tx_type: int) -> np.ndarray:
    """libvpx's 2-D inverse transforms of blocks (m, n, n) of dequantised
    coefficients: rows first, then columns, then rounded by 4, 5, 6, 6 bits.
    `tx_type` ADST_DCT is ADST down the columns and DCT along the rows.
    WHT_WHT (4x4 only) takes the coefficients down by 2 bits, then the
    Walsh-Hadamard along the rows and down the columns, unrounded."""
    n = 4 << tx
    x = coefs.astype(np.int64)
    if tx_type == WHT_WHT:
        x = x >> 2
        t = np.stack(iwht4([x[:, :, k] for k in range(4)]), axis=2)
        return np.stack(iwht4([t[:, k, :] for k in range(4)]), axis=1)
    row_f = _ONE_D[(tx, int(tx_type in (DCT_ADST, ADST_ADST)))]
    col_f = _ONE_D[(tx, int(tx_type in (ADST_DCT, ADST_ADST)))]
    rows = row_f([x[:, :, k] for k in range(n)])  # each (m, n): row r's output k
    t = np.stack(rows, axis=2)
    cols = col_f([t[:, k, :] for k in range(n)])  # each (m, n): column c's output k
    out = np.stack(cols, axis=1)
    shift = (4, 5, 6, 6)[tx]
    return (out + (1 << (shift - 1))) >> shift


# --------------------------------------------------------- intra prediction


def _directional(mode: int, bs: int):
    """Index arrays (i0, i1, i2, avg3) into the edge vector E = (left
    reversed, top-left, above and above-right) for a directional mode:
    pred = AVG3(E[i0], E[i1], E[i2]) where avg3 else AVG2(E[i0], E[i1])."""

    def a(i):  # above[i], i in -1 .. 2bs-1
        return bs + 1 + i

    def lf(i):  # left[i], clamped to the last
        return bs - 1 - min(i, bs - 1)

    out = np.zeros((4, bs, bs), np.int64)
    for r in range(bs):
        for c in range(bs):
            if mode == D45_PRED:
                k = r + c
                e = (a(k), a(k + 1), a(k + 2), 1) if k + 2 < 2 * bs else (a(2 * bs - 1), a(2 * bs - 1), 0, 0)
            elif mode == D63_PRED:
                k = (r >> 1) + c
                e = (a(k), a(k + 1), a(k + 2), 1) if r & 1 else (a(k), a(k + 1), 0, 0)
            elif mode == D207_PRED:
                k = r + (c >> 1)
                e = (lf(k), lf(k + 1), lf(k + 2), 1) if c & 1 else (lf(k), lf(k + 1), 0, 0)
            elif mode == D135_PRED:
                # the edge from the bottom left: l[bs-1] .. l[0], top-left, a[0] ..: E itself
                k = bs - 1 - r + c
                e = (k, k + 1, k + 2, 1)
            elif mode == D117_PRED:
                m = min(r >> 1, c)
                rr, cc = r - 2 * m, c - m
                if rr == 0:
                    e = (a(cc - 1), a(cc), 0, 0)
                elif rr == 1:
                    e = (lf(0), a(-1), a(0), 1) if cc == 0 else (a(cc - 2), a(cc - 1), a(cc), 1)
                elif rr == 2:
                    e = (a(-1), lf(0), lf(1), 1)
                else:
                    e = (lf(rr - 3), lf(rr - 2), lf(rr - 1), 1)
            else:  # D153
                m = min(r, c >> 1)
                rr, cc = r - m, c - 2 * m
                if rr == 0:
                    e = (a(-1), lf(0), 0, 0) if cc == 0 else (lf(0), a(-1), a(0), 1) if cc == 1 else \
                        (a(cc - 3), a(cc - 2), a(cc - 1), 1)
                elif cc == 0:
                    e = (lf(rr - 1), lf(rr), 0, 0)
                elif rr == 1:
                    e = (a(-1), lf(0), lf(1), 1)
                else:
                    e = (lf(rr - 2), lf(rr - 1), lf(rr), 1)
            out[:, r, c] = e
    return out


_DIRECTIONAL = {(m, t): _directional(m, 4 << t) for m in (D45_PRED, D135_PRED, D117_PRED, D153_PRED, D207_PRED,
                                                          D63_PRED) for t in range(4)}
_NEEDS_ABOVE = {DC_PRED, V_PRED, D45_PRED, D135_PRED, D117_PRED, D153_PRED, D63_PRED, TM_PRED}
_NEEDS_LEFT = {DC_PRED, H_PRED, D135_PRED, D117_PRED, D153_PRED, D207_PRED, TM_PRED}


def predict_intra(plane: np.ndarray, fw: int, fh: int, y0: int, x0: int, tx: int, mode: int, have_top: bool,
                  have_left: bool, have_right: bool) -> np.ndarray:
    """One transform block's intra prediction from the reconstructed
    `plane` (frame width and height `fw`, `fh` aligned to 8 luma pixels),
    with libvpx's edges: 127 above the frame, 129 left of it (and left of
    a tile), the above row replicated past the frame's right edge, the
    above-right taken for 4x4 transform blocks inside their block only."""
    bs = 4 << tx
    if mode in _NEEDS_ABOVE:
        if have_top:
            n = min(2 * bs if bs == 4 and have_right and mode in (D45_PRED, D63_PRED) else bs, fw - x0)
            row = plane[y0 - 1, x0:x0 + n].astype(np.int64)
            above = np.empty(2 * bs + 1, np.int64)
            above[1:n + 1] = row
            above[n + 1:] = row[n - 1]
            above[0] = plane[y0 - 1, x0 - 1] if have_left else 129
        else:
            above = np.full(2 * bs + 1, 127, np.int64)
    else:
        above = np.full(2 * bs + 1, 127, np.int64)
    if mode in _NEEDS_LEFT:
        if have_left:
            n = min(bs, fh - y0)
            col = plane[y0:y0 + n, x0 - 1].astype(np.int64)
            left = np.empty(bs, np.int64)
            left[:n] = col
            left[n:] = col[n - 1]
        else:
            left = np.full(bs, 129, np.int64)
    else:
        left = np.full(bs, 129, np.int64)
    if mode == DC_PRED:
        if have_top and have_left:
            v = (int(above[1:bs + 1].sum()) + int(left.sum()) + bs) // (2 * bs)
        elif have_top:
            v = (int(above[1:bs + 1].sum()) + bs // 2) // bs
        elif have_left:
            v = (int(left.sum()) + bs // 2) // bs
        else:
            v = 128
        return np.full((bs, bs), v, np.int64)
    if mode == V_PRED:
        return np.broadcast_to(above[1:bs + 1], (bs, bs))
    if mode == H_PRED:
        return np.broadcast_to(left[:, None], (bs, bs))
    if mode == TM_PRED:
        return np.clip(left[:, None] + above[None, 1:bs + 1] - above[0], 0, 255)
    e = np.concatenate([left[::-1], above])
    i0, i1, i2, avg3 = _DIRECTIONAL[(mode, tx)]
    return np.where(avg3 == 1, (e[i0] + 2 * e[i1] + e[i2] + 2) >> 2, (e[i0] + e[i1] + 1) >> 1)


# --------------------------------------------------------- inter prediction


def compound_average(first: np.ndarray, second: np.ndarray) -> np.ndarray:
    """A compound block's prediction: its two references' predictions
    averaged, rounding half up (libvpx's vpx_convolve_avg)."""
    return (first + second + 1) >> 1


def predict_inter(ref: np.ndarray, ys: np.ndarray, xs: np.ndarray, mvy: np.ndarray, mvx: np.ndarray, h: int, w: int,
                  kernel: np.ndarray) -> np.ndarray:
    """Blocks (n, h, w) at (ys, xs) moved by (mvy, mvx) in 1/16 pixels,
    through the 8-tap `kernel`: a horizontal pass rounded and clipped to 8
    bits, then a vertical one (libvpx's vpx_convolve8). `ref` is the
    reference plane at its picture size; reads past it take its edge."""
    H, W = ref.shape
    iy, fy = ys + (mvy >> 4) - 3, mvy & 15
    ix, fx = xs + (mvx >> 4) - 3, mvx & 15
    rows = np.clip(iy[:, None] + np.arange(h + 7), 0, H - 1)
    cols = np.clip(ix[:, None] + np.arange(w + 7), 0, W - 1)
    win = ref[rows[:, :, None], cols[:, None, :]].astype(np.int32)  # (n, h+7, w+7)
    tx, ty = kernel[fx], kernel[fy]  # (n, 8)
    hp = tx[:, None, None, 0] * win[:, :, 0:w]
    for k in range(1, 8):
        hp += tx[:, None, None, k] * win[:, :, k:k + w]
    hp = np.clip((hp + 64) >> 7, 0, 255)
    vp = ty[:, None, None, 0] * hp[:, 0:h, :]
    for k in range(1, 8):
        vp += ty[:, None, None, k] * hp[:, k:k + h, :]
    return np.clip((vp + 64) >> 7, 0, 255)


# -------------------------------------------------------------- loop filter

_ALL = (1 << 64) - 1
_LEFT_PRED = (1, 1, 1, 1, 0x101, 1, 0x101, 0x1010101, 0x101, 0x1010101, 0x0101010101010101, 0x1010101,
              0x0101010101010101)
_ABOVE_PRED = (1, 1, 1, 1, 1, 3, 3, 3, 0xF, 0xF, 0xF, 0xFF, 0xFF)
_SIZE_MASK = (1, 1, 1, 1, 0x101, 3, 0x303, 0x3030303, 0xF0F, 0xF0F0F0F, 0x0F0F0F0F0F0F0F0F, 0xFFFFFFFF, _ALL)
_LEFT_TX = (_ALL, _ALL, 0x5555555555555555, 0x1111111111111111)
_ABOVE_TX = (_ALL, _ALL, 0x00FF00FF00FF00FF, 0x000000FF000000FF)
_LEFT_PRED_UV = (1, 1, 1, 1, 1, 1, 1, 0x11, 1, 0x11, 0x1111, 0x11, 0x1111)
_ABOVE_PRED_UV = (1, 1, 1, 1, 1, 1, 1, 1, 3, 3, 3, 0xF, 0xF)
_SIZE_MASK_UV = (1, 1, 1, 1, 1, 1, 1, 0x11, 3, 0x33, 0x3333, 0xFF, 0xFFFF)
_LEFT_TX_UV = (0xFFFF, 0xFFFF, 0x5555, 0x1111)
_ABOVE_TX_UV = (0xFFFF, 0xFFFF, 0x0F0F, 0x000F)


class _Mask:
    """One superblock's edge masks, as libvpx's LOOP_FILTER_MASK: bit
    row * 8 + col (luma 8x8 units) or row * 4 + col (chroma)."""

    __slots__ = ("left_y", "above_y", "int_y", "left_uv", "above_uv", "int_uv", "lfl")

    def __init__(self):
        self.left_y, self.above_y = [0] * 4, [0] * 4
        self.left_uv, self.above_uv = [0] * 4, [0] * 4
        self.int_y = self.int_uv = 0
        self.lfl = [0] * 64


def _build(m: _Mask, b, level: int, shift_y: int, shift_uv: Optional[int]) -> None:
    """libvpx's build_masks (with `shift_uv`) and build_y_mask (without)."""
    if not level:
        return
    sb, tx = b.sb, b.tx
    w, h = _BW8[sb], _BH8[sb]
    for i in range(h):
        at = shift_y + 8 * i
        m.lfl[at:at + w] = [level] * w
    m.above_y[tx] |= _ABOVE_PRED[sb] << shift_y
    m.left_y[tx] |= _LEFT_PRED[sb] << shift_y
    tx_uv = min(tx, _UV_MAX_TX[sb])
    if shift_uv is not None:
        m.above_uv[tx_uv] |= _ABOVE_PRED_UV[sb] << shift_uv
        m.left_uv[tx_uv] |= _LEFT_PRED_UV[sb] << shift_uv
    if b.skip and b.inter:
        return
    m.above_y[tx] |= (_SIZE_MASK[sb] & _ABOVE_TX[tx]) << shift_y
    m.left_y[tx] |= (_SIZE_MASK[sb] & _LEFT_TX[tx]) << shift_y
    if tx == 0:
        m.int_y |= _SIZE_MASK[sb] << shift_y
    if shift_uv is not None:
        m.above_uv[tx_uv] |= (_SIZE_MASK_UV[sb] & _ABOVE_TX_UV[tx_uv]) << shift_uv
        m.left_uv[tx_uv] |= (_SIZE_MASK_UV[sb] & _LEFT_TX_UV[tx_uv]) << shift_uv
        if tx_uv == 0:
            m.int_uv |= _SIZE_MASK_UV[sb] << shift_uv


def _setup_mask(grid, levels, cols: int, rows: int, r0: int, c0: int) -> _Mask:
    """libvpx's vp9_setup_mask for the superblock at mi (r0, c0)."""
    m = _Mask()
    max_rows, max_cols = min(8, rows - r0), min(8, cols - c0)

    def at(dr, dc):
        i = (r0 + dr) * cols + c0 + dc
        return grid[i], levels[i]

    b, lv = at(0, 0)
    if b.sb == BLOCK_64X64:
        _build(m, b, lv, 0, 0)
    elif b.sb == BLOCK_64X32:
        _build(m, b, lv, 0, 0)
        if 4 < max_rows:
            _build(m, *at(4, 0), 32, 8)
    elif b.sb == BLOCK_32X64:
        _build(m, b, lv, 0, 0)
        if 4 < max_cols:
            _build(m, *at(0, 4), 4, 2)
    else:
        for i32 in range(4):
            r32, c32 = (i32 >> 1) << 2, (i32 & 1) << 2
            if c32 >= max_cols or r32 >= max_rows:
                continue
            sy, suv = (0, 4, 32, 36)[i32], (0, 2, 8, 10)[i32]
            b, lv = at(r32, c32)
            if b.sb == BLOCK_32X32:
                _build(m, b, lv, sy, suv)
            elif b.sb == BLOCK_32X16:
                _build(m, b, lv, sy, suv)
                if r32 + 2 < max_rows:
                    _build(m, *at(r32 + 2, c32), sy + 16, suv + 4)
            elif b.sb == BLOCK_16X32:
                _build(m, b, lv, sy, suv)
                if c32 + 2 < max_cols:
                    _build(m, *at(r32, c32 + 2), sy + 2, suv + 1)
            else:
                for i16 in range(4):
                    r16, c16 = r32 + ((i16 >> 1) << 1), c32 + ((i16 & 1) << 1)
                    if c16 >= max_cols or r16 >= max_rows:
                        continue
                    sy16, suv16 = sy + (0, 2, 16, 18)[i16], suv + (0, 1, 4, 5)[i16]
                    b, lv = at(r16, c16)
                    if b.sb == BLOCK_16X16:
                        _build(m, b, lv, sy16, suv16)
                    elif b.sb == BLOCK_16X8:
                        _build(m, b, lv, sy16, suv16)
                        if r16 + 1 < max_rows:
                            _build(m, *at(r16 + 1, c16), sy16 + 8, None)
                    elif b.sb == BLOCK_8X16:
                        _build(m, b, lv, sy16, suv16)
                        if c16 + 1 < max_cols:
                            _build(m, *at(r16, c16 + 1), sy16 + 1, None)
                    else:
                        _build(m, b, lv, sy16, suv16)
                        for i8 in range(1, 4):
                            r8, c8 = r16 + (i8 >> 1), c16 + (i8 & 1)
                            if c8 >= max_cols or r8 >= max_rows:
                                continue
                            _build(m, *at(r8, c8), sy16 + (0, 1, 8, 9)[i8], None)
    # the 16-wide filter serves 32x32 transforms too; every 32x32 border gets at least the 8-wide one
    m.left_y[2] |= m.left_y[3]
    m.above_y[2] |= m.above_y[3]
    m.left_uv[2] |= m.left_uv[3]
    m.above_uv[2] |= m.above_uv[3]
    m.left_y[1] |= m.left_y[0] & 0x1111111111111111
    m.left_y[0] &= ~0x1111111111111111 & _ALL
    m.above_y[1] |= m.above_y[0] & 0x000000FF000000FF
    m.above_y[0] &= ~0x000000FF000000FF & _ALL
    m.left_uv[1] |= m.left_uv[0] & 0x1111
    m.left_uv[0] &= ~0x1111 & 0xFFFF
    m.above_uv[1] |= m.above_uv[0] & 0x000F
    m.above_uv[0] &= ~0x000F & 0xFFFF
    if r0 + 8 > rows:
        nr = rows - r0
        my, muv = (1 << (nr << 3)) - 1, (1 << (((nr + 1) >> 1) << 2)) - 1
        for i in range(3):
            m.left_y[i] &= my
            m.above_y[i] &= my
            m.left_uv[i] &= muv
            m.above_uv[i] &= muv
        m.int_y &= my
        m.int_uv &= muv
        if nr == 1:
            m.above_uv[1] |= m.above_uv[2]
            m.above_uv[2] = 0
        if nr == 5:
            m.above_uv[1] |= m.above_uv[2] & 0xFF00
            m.above_uv[2] &= ~(m.above_uv[2] & 0xFF00) & 0xFFFF
    if c0 + 8 > cols:
        nc = cols - c0
        my, muv = ((1 << nc) - 1) * 0x0101010101010101, ((1 << ((nc + 1) >> 1)) - 1) * 0x1111
        muv_int = ((1 << (nc >> 1)) - 1) * 0x1111
        for i in range(3):
            m.left_y[i] &= my
            m.above_y[i] &= my
            m.left_uv[i] &= muv
            m.above_uv[i] &= muv
        m.int_y &= my
        m.int_uv &= muv_int
        if nc == 1:
            m.left_uv[1] |= m.left_uv[2]
            m.left_uv[2] = 0
        if nc == 5:
            m.left_uv[1] |= m.left_uv[2] & 0xCCCC
            m.left_uv[2] &= ~(m.left_uv[2] & 0xCCCC) & 0xFFFF
    if c0 == 0:
        for i in range(3):
            m.left_y[i] &= 0xFEFEFEFEFEFEFEFE
            m.left_uv[i] &= 0xEEEE
    return m


def _mask_ops(m: _Mask, r0: int, c0: int, rows: int):
    """The superblock's filter operations in libvpx's order: (pass, order
    key, plane, kind, y, x, level); kind 16, 8 or 4; pass 0 filters across
    vertical edges (left to right), pass 1 across horizontal ones (top to
    bottom); an 8-pixel edge segment each."""
    ops = []
    kinds = ((2, 16), (1, 8), (0, 4))
    for pas, masks, int_mask in ((0, m.left_y, m.int_y), (1, m.above_y, m.int_y)):
        for bit in range(64):
            rr, cc = bit >> 3, bit & 7
            if r0 + rr >= rows:
                break
            y, x = (r0 + rr) * 8, (c0 + cc) * 8
            lvl = m.lfl[bit]
            top = pas == 1 and r0 + rr == 0
            key = (cc if pas == 0 else rr) * 2
            for t, kind in kinds:
                if masks[t] >> bit & 1 and not top:
                    ops.append((pas, key, 0, kind, y, x, lvl))
                    break
            if int_mask >> bit & 1:
                ops.append((pas, key + 1, 0, 4, y + 4 * pas, x + 4 * (1 - pas), lvl))
    for pas, masks in ((0, m.left_uv), (1, m.above_uv)):
        for bit in range(16):
            ur, uc = bit >> 2, bit & 3
            if r0 + 2 * ur >= rows:
                break
            y, x = (r0 >> 1) * 8 + ur * 8, (c0 >> 1) * 8 + uc * 8
            lvl = m.lfl[(2 * ur) * 8 + 2 * uc]
            top = pas == 1 and r0 + 2 * ur == 0
            key = (uc if pas == 0 else ur) * 2
            for t, kind in kinds:
                if masks[t] >> bit & 1 and not top:
                    ops.append((pas, key, 1, kind, y, x, lvl))
                    break
            if m.int_uv >> bit & 1 and not (pas == 1 and r0 + 2 * ur == rows - 1):
                ops.append((pas, key + 1, 1, 4, y + 4 * pas, x + 4 * (1 - pas), lvl))
    return ops


def _limits(sharpness: int):
    """(limit, blimit, hev threshold) by filter level."""
    lim, mblim, hev = [], [], []
    for lvl in range(64):
        inside = lvl >> ((sharpness > 0) + (sharpness > 4))
        if sharpness > 0:
            inside = min(inside, 9 - sharpness)
        inside = max(inside, 1)
        lim.append(inside)
        mblim.append(2 * (lvl + 2) + inside)
        hev.append(lvl >> 4)
    return np.array(lim), np.array(mblim), np.array(hev)


def _window(x: np.ndarray, r: int) -> np.ndarray:
    """The flat filters' outputs for positions 1 .. n-2 of lines x (m, n):
    (the 2r+1 values around each, the line's ends repeated, plus the value
    itself, + (r+1)) / (2r+2), for r = 3 (8 taps) or 7 (16)."""
    m, n = x.shape
    pad = np.concatenate([np.repeat(x[:, :1], r, 1), x, np.repeat(x[:, -1:], r, 1)], 1)
    cs = np.concatenate([np.zeros((m, 1), x.dtype), np.cumsum(pad, 1)], 1)
    j = np.arange(1, n - 1)
    total = cs[:, j + 2 * r + 1] - cs[:, j] + x[:, 1:n - 1]
    return (total + r + 1) >> (r + 1).bit_length()


def _clamp8(x: np.ndarray) -> np.ndarray:
    """A signed 8-bit value's clamp, -128 .. 127 (libvpx's signed_char_clamp)."""
    return np.minimum(np.maximum(x, -128), 127)


def _filter_lines(buf: np.ndarray, idx: np.ndarray, kind: np.ndarray, lim, blim, hev) -> None:
    """libvpx's filter4/8/16 on lines of pixels, each line by its own `kind`
    (4, 8 or 16): idx (n, 16) p7..q7 where some line is of kind 16 (the
    other lines' p7..p4 and q4..q7 repeat their p3 and q3, which no filter
    but the 16-wide one reads or writes), (n, 8) p3..q3 otherwise; kind,
    lim, blim, hev (n,)."""
    px = buf[idx]
    o = 4 if idx.shape[1] == 16 else 0
    c = px[:, o:o + 8]  # p3 .. q3
    d = np.abs(np.diff(c, axis=1))  # |p2-p3|, |p1-p2|, |p0-p1|, |q0-p0|, |q1-q0|, |q2-q1|, |q3-q2|
    p1, p0, q0, q1 = c[:, 2], c[:, 3], c[:, 4], c[:, 5]
    mask = (np.maximum(d[:, :3].max(1), d[:, 4:].max(1)) <= lim) & (d[:, 3] * 2 + (np.abs(p1 - q1) >> 1) <= blim)
    if not mask.any():
        return
    out = px.copy()
    # filter4
    hv = np.maximum(d[:, 2], d[:, 4]) > hev
    ps1, ps0, qs0, qs1 = p1 - 128, p0 - 128, q0 - 128, q1 - 128
    f = np.where(hv, _clamp8(ps1 - qs1), 0)
    f = np.where(mask, _clamp8(f + 3 * (qs0 - ps0)), 0)
    f1 = _clamp8(f + 4) >> 3
    f2 = _clamp8(f + 3) >> 3
    fo = np.where(hv, 0, (f1 + 1) >> 1)
    out[:, o + 2] = _clamp8(ps1 + fo) + 128
    out[:, o + 3] = _clamp8(ps0 + f2) + 128
    out[:, o + 4] = _clamp8(qs0 - f1) + 128
    out[:, o + 5] = _clamp8(qs1 - fo) + 128
    flat = mask & (kind >= 8) & (np.abs(c[:, :3] - p0[:, None]).max(1) <= 1) & \
        (np.abs(c[:, 5:] - q0[:, None]).max(1) <= 1)
    if flat.any():
        # filter8: each of p2 .. q2 is (the 7 taps around it, edges repeated, + itself + 4) >> 3
        out[:, o + 1:o + 7] = np.where(flat[:, None], _window(c, 3), out[:, o + 1:o + 7])
        if o:
            flat2 = flat & (kind == 16) & (np.abs(px[:, :4] - p0[:, None]).max(1) <= 1) & \
                (np.abs(px[:, 12:] - q0[:, None]).max(1) <= 1)
            if flat2.any():
                out[:, 1:15] = np.where(flat2[:, None], _window(px, 7), out[:, 1:15])
    buf[idx] = out


def _lf_lines(ops: List[tuple], offsets, strides) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat pixel indices (n*8, 16 or 8) of the lines of edge operations at
    one position, and each line's level and filter kind."""
    a = np.array(ops, np.int64)  # plane, kind, y, x, level, pass
    plane, kind, y, x, lvl, pas = a.T
    half = 8 if (kind == 16).any() else 4
    stride = np.asarray(strides)[plane]
    base = np.asarray(offsets)[plane] + y * stride + x
    along = np.where(pas == 0, stride, 1)  # the 8 lines of a vertical edge step down, of a horizontal one right
    across = np.where(pas == 0, 1, stride)
    k = np.arange(8)
    t = np.arange(-half, half)
    t = np.where(kind[:, None] == 16, t, np.clip(t, -4, 3))  # narrower filters read and write p3..q3 only
    idx = base[:, None, None] + k[None, :, None] * along[:, None, None] + t[:, None, :] * across[:, None, None]
    return idx.reshape(-1, 2 * half), np.repeat(lvl, 8), np.repeat(kind, 8)


def _loop_filter(planes, grid, levels, cols: int, rows: int, sharpness: int) -> None:
    """Filter the reconstructed planes in place, in libvpx's order
    (superblocks in raster order; each one's vertical edges left to right,
    then its horizontal ones top to bottom), batched as early as that
    order allows: each edge operation reads and writes within the 4x4
    units its lines span (8 pixels each side of a 16-wide edge, 4 of the
    others), so it joins the batch after the last one that touched any of
    its units (U's operations stand for V's too). A batch is one call."""
    lim, blim, hev = _limits(sharpness)
    shapes = [p.shape for p in planes]
    flat = np.concatenate([p.reshape(-1) for p in planes]).astype(np.int32)
    offsets = [0, shapes[0][0] * shapes[0][1], shapes[0][0] * shapes[0][1] + shapes[1][0] * shapes[1][1]]
    strides = [s[1] for s in shapes]
    wu = (shapes[0][1] >> 2) + 4  # 4x4 units a row, two spare each side
    half = ((shapes[0][0] >> 2) + 4) * wu
    last = [0] * (2 * half)  # the batch that last touched each unit, by plane (Y, UV)
    # the units an edge's lines span, from the unit right of or below the edge: vertical (pass 0) and horizontal
    # edges, reaching 1 unit each side (4- and 8-wide) or 2 (16-wide)
    spans = {(pas, wide): [i * wu + j if pas == 0 else j * wu + i for i in (0, 1) for j in range(-wide, wide)]
             for pas in (0, 1) for wide in (1, 2)}
    batches: List[list] = []
    for r0 in range(0, rows, 8):
        for c0 in range(0, cols, 8):
            ops = _mask_ops(_setup_mask(grid, levels, cols, rows, r0, c0), r0, c0, rows)
            ops.sort(key=lambda op: op[:2])  # by pass, then edge position (stable: planes are independent)
            for pas, _, plane, kind, y, x, lvl in ops:
                base = plane * half + ((y >> 2) + 2) * wu + (x >> 2) + 2
                units = [base + d for d in spans[pas, 2 if kind == 16 else 1]]
                at = max([last[u] for u in units])
                for u in units:
                    last[u] = at + 1
                if at == len(batches):
                    batches.append([])
                batches[at].append((plane, kind, y, x, lvl, pas))
    for ops in batches:
        ops = ops + [(2, kind, y, x, lvl, p) for (pl, kind, y, x, lvl, p) in ops if pl == 1]
        idx, lv, kinds = _lf_lines(ops, offsets, strides)
        _filter_lines(flat, idx, kinds, lim[lv], blim[lv], hev[lv])
    at = 0
    for p, s in zip(planes, shapes):
        n = s[0] * s[1]
        p[...] = flat[at:at + n].reshape(s)
        at += n


# ------------------------------------------------------------------- video


def key_frame_size(frame: bytes) -> Tuple[int, int]:
    """(width, height) from a profile 0 key frame's header."""
    rb = _Bits(frame)
    if rb.lit(2) != 2:
        raise ValueError("a VP9 stream whose first frame has no frame marker")
    profile = rb.bit() | rb.bit() << 1
    if profile:
        raise NotImplementedError(f"VP9 profile {profile}, which the port does not decode yet ({_ROADMAP})")
    if rb.bit() or rb.bit() != KEY_FRAME:
        raise ValueError("a VP9 stream that does not start with a key frame")
    rb.lit(2)
    if rb.lit(24) != 0x498342:
        raise ValueError("a VP9 key frame without its sync code")
    if rb.lit(3) != 7:
        rb.bit()
    return rb.lit(16) + 1, rb.lit(16) + 1


class Vp9Track:
    """What a container's reader shares once it has found a VP9 track:
    `path` and `packets()` come from the container. The frames are the
    decoded planes through swscale's YUV 4:2:0 to BGR, as OpenCV's FFmpeg
    backend returns them."""

    counts: Counter  # the last `read()`'s decoder tallies (the tests read them)

    def size(self) -> Tuple[int, int]:
        """(width, height) from the first key frame, once every frame's
        headers have been read (`check_stream`); an odd height raises
        (swscale converts it through its scaled path, which the port does
        not reproduce)."""
        try:
            w, h = key_frame_size(next(self.packets(), b""))
            Vp9Decoder().check_stream(self.packets())
        except (NotImplementedError, ValueError) as exc:
            raise type(exc)(f"{self.path}: {exc}") from exc
        if h & 1:
            raise NotImplementedError(f"{self.path}: VP9 video of odd height ({w}x{h}): OpenCV converts it through "
                                      f"swscale's scaled path, which the port does not reproduce ({_ROADMAP})")
        return w, h

    def read(self, rgb: bool = True) -> Iterator[np.ndarray]:
        """The decoded frames: uint8 (H, W, 3), RGB (BGR with `rgb=False`)."""
        return read_frames(self, Vp9Decoder, rgb)
