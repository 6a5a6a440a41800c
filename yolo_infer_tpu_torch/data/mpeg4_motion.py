"""Motion compensation of MPEG-4 Part 2 in numpy, as libavcodec's MPEG-4 decoder forms its predictions.

Every function takes a batch of blocks at once: their reference plane, the
integer sample position of each block's top-left corner and its fraction,
and returns the (n, size, size) predictions (int32, 0..255).

  half-pel     (`halfpel`) the bilinear average of two or four samples,
               `vop_rounding_type` subtracted before the shift (two samples
               of an 8x8 block under rounding type 1: libavcodec's x86
               approximation)
  quarter-pel  (`qpel`) MPEG-4's 8-tap filter (-1, 3, -6, 20, 20, -6, 3, -1)
               / 32 over the block's own size + 1 samples, which are
               mirrored past the 16x16 or 8x8 block's edge: the horizontal
               pass over size + 1 rows gives the half sample or, averaged
               with the nearer full sample, the quarter one; the vertical
               pass runs over that result the same way; each pass rounds
               (+16, or +15 under `vop_rounding_type` 1) and clips to
               0..255, each average rounds up (down under rounding type 1);
               under libavcodec's `FF_BUG_STD_QPEL` (Lavc builds before
               4653) its old filters at the six positions of an odd x and
               a non-zero y quarter step: four- or two-way averages of the
               full, across, down and centre samples
  chroma       the H.263 rule of a 16x16 half-pel vector (`chroma_halfpel`),
               libavcodec's rule of a 16x16 quarter-pel vector
               (`chroma_qpel`: halved toward zero, then to half-pel with
               the odd quarter kept; its two quarter-pel chroma
               workarounds), and the sixteenth-pel rounding table
               of four 8x8 vectors' sum (`chroma_4mv`)

The reference is the decoded plane cut to the picture's edge position
(the macroblock-aligned size, or the coded size under libavcodec's Xvid
edge workaround) and replicated past it without bound, what libavcodec's
edge emulation gives. `clip_8x8` applies libavcodec's clip of an 8x8
block's position to [-16, coded size] (and of 4MV chroma to [-8, coded
size / 2]), where the fraction is dropped.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# libavcodec's rounding of four 8x8 vectors' sum (sixteenths of a chroma sample) to half samples
_CHROMA_ROUND = np.array([0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2], np.int64)


def gather(ref: np.ndarray, sx: np.ndarray, sy: np.ndarray, size: int) -> np.ndarray:
    """(n, size, size) samples of ref from each (sx, sy), replicated past its edges."""
    h, w = ref.shape
    ys = np.clip(sy[:, None] + np.arange(size), 0, h - 1)
    xs = np.clip(sx[:, None] + np.arange(size), 0, w - 1)
    return ref[ys[:, :, None], xs[:, None, :]].astype(np.int32)


def halfpel(ref: np.ndarray, sx, sy, dx, dy, size: int, rounding: int) -> np.ndarray:
    """(n, size, size) half-pel predictions at integer (sx, sy) plus half steps (dx, dy).

    Under `vop_rounding_type` 1 an 8x8 block's two-sample average is
    libavcodec's x86 one (no bit-exact flag, as OpenCV opens the decoder): a
    rounding-up average after a saturating -1 on one sample, the left one
    across, down the upper one on an odd row of the block and the lower one
    on an even row; exact except where that sample is 0. Its 16x16 averages
    are exact."""
    g = gather(ref, sx, sy, size + 1)
    a, r, d, rd = g[:, :size, :size], g[:, :size, 1:], g[:, 1:, :size], g[:, 1:, 1:]
    if rounding and size == 8:
        across = (np.maximum(a - 1, 0) + r + 1) >> 1
        odd = (np.arange(size) & 1)[None, :, None].astype(bool)
        down = np.where(odd, np.maximum(a - 1, 0) + d + 1, a + np.maximum(d - 1, 0) + 1) >> 1
    else:
        across, down = (a + r + 1 - rounding) >> 1, (a + d + 1 - rounding) >> 1
    dx, dy = dx[:, None, None], dy[:, None, None]
    return np.where(dx & dy, (a + r + d + rd + 2 - rounding) >> 2, np.where(dx, across, np.where(dy, down, a)))


def _lowpass(x: np.ndarray, size: int, rounding: int) -> np.ndarray:
    """The 8-tap half-sample filter along the last axis of x (size + 1 samples) -> size samples."""
    p = np.concatenate([x[..., 2::-1], x, x[..., :size - 3:-1]], -1)  # 3 mirrored samples past each end
    t = lambda k: p[..., k:k + size] + p[..., 7 - k:7 - k + size]  # noqa: E731 -- the taps k and 7 - k
    s = 20 * t(3) - 6 * t(2) + 3 * t(1) - t(0)
    return np.clip((s + 16 - rounding) >> 5, 0, 255)


def _vlowpass(x: np.ndarray, size: int, rounding: int) -> np.ndarray:
    """The 8-tap filter down the columns of x (n, size + 1, size) -> (n, size, size)."""
    return np.swapaxes(_lowpass(np.swapaxes(x, 1, 2), size, rounding), 1, 2)


def qpel(ref: np.ndarray, sx, sy, fx, fy, size: int, rounding: int, old: bool = False) -> np.ndarray:
    """(n, size, size) quarter-pel predictions at integer (sx, sy) plus
    quarter steps (fx, fy) in 0..3; `old`: libavcodec's pre-4653 filters
    (`FF_BUG_STD_QPEL`) at the six positions of an odd x step and a
    non-zero y step."""
    g = gather(ref, sx, sy, size + 1)  # (n, size + 1, size + 1)
    r = 1 - rounding
    half = _lowpass(g, size, rounding)  # (n, size + 1, size): each row's half samples
    fx = fx[:, None, None]
    rows = np.where(fx == 0, g[:, :, :size], np.where(fx == 2, half, np.where(
        fx == 1, (half + g[:, :, :size] + r) >> 1, (half + g[:, :, 1:] + r) >> 1)))
    vert = _vlowpass(rows, size, rounding)  # (n, size, size)
    fy = fy[:, None, None]
    top, bottom = rows[:, :size], rows[:, 1:]
    out = np.where(fy == 0, top, np.where(fy == 2, vert, np.where(
        fy == 1, (top + vert + r) >> 1, (bottom + vert + r) >> 1)))
    if not old:
        return out
    # the old filters: the full sample, the half sample across, the half sample down (of the full
    # samples' column at x or x + 1) and the centre half sample, averaged four ways at y 1 and 3,
    # the last two averaged at y 2
    odd = fx & 1
    at = odd.astype(bool) & (fy > 0)
    if not at.any():
        return out
    centre = _vlowpass(half, size, rounding)
    right = (fx == 3)
    down = np.where(right, _vlowpass(g[:, :, 1:], size, rounding), _vlowpass(g[:, :, :size], size, rounding))
    low = (fy == 3)
    full = np.where(low, np.where(right, g[:, 1:, 1:], g[:, 1:, :size]), np.where(right, g[:, :size, 1:],
                                                                                g[:, :size, :size]))
    across = np.where(low, half[:, 1:], half[:, :size])
    four = (full + across + down + centre + 2 - rounding) >> 2
    two = (down + centre + r) >> 1
    return np.where(at, np.where(fy == 2, two, four), out)


def clip_8x8(pos: np.ndarray, frac: np.ndarray, low: int, limit: int, mask: int) -> Tuple[np.ndarray, np.ndarray]:
    """libavcodec's clip of an 8x8 (or 4MV chroma) block's position to
    [low, limit]; at `limit` the fraction bits `mask` are dropped."""
    pos = np.clip(pos, low, limit)
    return pos, np.where(pos == limit, frac & ~mask, frac)


def chroma_halfpel(mx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(integer offset, half step) of the chroma vector of a 16x16 half-pel luma vector (H.263)."""
    return mx >> 2, (mx & 1) | ((mx & 2) >> 1)


_QPEL_CHROMA2_ROUND = np.array([0, 0, 1, 1, 0, 0, 0, 1], np.int64)


def chroma_qpel(mx: np.ndarray, bug: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(integer offset, half step) of the chroma vector of a 16x16 quarter-pel
    luma vector: halved toward zero (under libavcodec's quarter-pel chroma
    workaround, `bug` 1, halved keeping the odd bit; under its second, `bug`
    2, halved and rounded by its table of the vector's low 3 bits), then to
    half samples keeping the odd bit."""
    if bug == 2:
        m = (mx >> 1) + _QPEL_CHROMA2_ROUND[mx & 7]
    else:
        m = (mx >> 1) | (mx & 1) if bug else np.where(mx < 0, -((-mx) >> 1), mx >> 1)
    m = (m >> 1) | (m & 1)
    return m >> 1, m & 1


def chroma_4mv(total: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(integer offset, half step) of the chroma vector from the sum of four
    8x8 luma vectors in half samples, by the sixteenth-pel rounding table."""
    m = _CHROMA_ROUND[total & 15] + ((total >> 3) & ~1)
    return m >> 1, m & 1
