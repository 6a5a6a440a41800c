"""The keep-mask walk's schedule (`csrc/nms_walk.cuh`) and kernel A's pair
test, modelled in numpy on the CPU, against the JAX package.

The strip-staged walk splits the greedy NMS over warps: warp 0 decides a
strip of 32 candidates from the removed set's word under it, which is the
helper warps' word (the kept rows of strips at least D+1 behind) ORed with
the carry warp 0 took from the D strips just before; the helpers OR each
strip's kept rows into the words D+1 strips on and beyond, behind the walk
(D = `kWalkCarry`, modelled at 1, 2 and 3). An error in that schedule shows only on the card, so `walk_schedule`
replays it step by step, on a bitmask in which every word the bits passes
leave unwritten holds random garbage, and the result is held to the JAX
package's `greedy_nms_pallas` (interpret mode) and the port's
`_nms_fixpoint`, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_infer_tpu.ops.iou import box_iou_matrix as j_box_iou
from yolo_infer_tpu.ops.pallas.nms_kernel import greedy_nms_pallas
from yolo_infer_tpu_torch.ops.iou import box_iou_matrix
from yolo_infer_tpu_torch.ops.kernels.nms_walk import bits_stride
from yolo_infer_tpu_torch.ops.nms import _nms_fixpoint
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FULL = 0xFFFFFFFF


def _pack(hit: np.ndarray) -> np.ndarray:
    """(..., 32 n) bools -> (..., n) uint32 words, bit b of word w = column 32 w + b."""
    words = hit.reshape(*hit.shape[:-1], -1, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)
    return words.sum(-1).astype(np.uint32)


def _valid_end(valid: np.ndarray) -> int:
    idx = np.flatnonzero(valid)
    return int(idx[-1]) + 1 if len(idx) else 0


def written_bits(iou: np.ndarray, valid: np.ndarray, thr: float, rng) -> np.ndarray:
    """One image's (K, bits_stride(K)) bitmask as the bits passes leave it:
    for a valid row i below E, words i/32 .. ceil(E/32)-1 hold `iou > thr`
    for i < j < E; every other word (invalid rows, rows from E on, words
    below the diagonal, the row padding) is garbage."""
    k = iou.shape[0]
    stride = bits_stride(k)
    bits = rng.integers(0, 2 ** 32, (k, stride), dtype=np.uint64).astype(np.uint32)
    e = _valid_end(valid)
    we = (e + 31) // 32
    j = np.arange(32 * stride)
    for i in np.flatnonzero(valid):
        hit = np.zeros(32 * stride, bool)
        hit[:k] = iou[i] > np.float32(thr)
        bits[i, i // 32:we] = _pack(hit & (j > i) & (j < e))[i // 32:we]
    return bits


def walk_schedule(bits: np.ndarray, valid: np.ndarray, carry, rng) -> np.ndarray:
    """The keep flags the strip-staged walk writes, replayed strip by strip.

    carry = D (`kWalkCarry`): warp 0 ORs its kept rows' words w+1 .. w+D
    into a carry it holds and publishes the strip's kept bits; before warp 0
    reads word w of the shared removed set, it has waited on every strip s
    <= w-D-1, whose helper warp (s mod 6) has ORed that strip's kept rows
    into the words from s+D+1 on, lane l taking words s+D+1+l, +32, ... (a
    helper may be done with later strips too, which touch words past w
    only). carry = None (the ring variant's single-warp OR): warp 0 ORs every
    kept row's words from w+1 on itself. Rows a strip does not stage
    (invalid, past E or past K) hold stale data there: garbage here."""
    k = len(valid)
    e = _valid_end(valid)
    we = (e + 31) // 32
    keep = np.zeros(k, bool)
    split = carry is not None
    d_n = carry or 1
    removed = np.zeros(we + 1, np.uint32)  # the shared removed set (split) or warp 0's own
    kept_words = []
    helped = 0  # strips the helpers are done with
    acc = [0] * d_n  # acc[d]: word w+d from the kept rows of the last d_n strips
    for w in range(we):
        if split:
            for s in range(helped, w - d_n):  # strips up to w-D-1, each by helper warp 2 + s % 6
                for lane in range(32):
                    for c in range(s + d_n + 1 + lane, we, 32):
                        for t in range(32):
                            if kept_words[s] >> t & 1:
                                removed[c] |= bits[32 * s + t, c]
            helped = max(helped, w - d_n)
        i0 = 32 * w
        staged = [i0 + t < e and bool(valid[i0 + t]) for t in range(32)]
        rows = np.stack([bits[i0 + t] if staged[t] else rng.integers(0, 2 ** 32, bits.shape[1], dtype=np.uint64)
                         .astype(np.uint32) for t in range(32)])
        invalid = FULL & ~sum(1 << t for t in range(32) if staged[t])
        cur = int(removed[w]) | (acc[0] if split else 0) | invalid
        add = [0] * d_n
        for t in range(32):  # the chain: kept when bit t is clear
            if not cur >> t & 1:
                cur |= int(rows[t, w])
                for d in range(d_n):
                    if w + 1 + d < we:
                        add[d] |= int(rows[t, w + 1 + d])
        kept = FULL & ~cur  # no row holds a bit at or below its own rank
        n = min(32, k - i0)
        keep[i0:i0 + n] = [(kept >> t) & 1 for t in range(n)]
        kept_words.append(kept)
        if split:
            acc = [(acc[d + 1] if d + 1 < d_n else 0) | add[d] for d in range(d_n)]
        else:
            for t in range(32):
                if kept >> t & 1:
                    removed[w + 1:we] |= rows[t, w + 1:we]
    return keep


def _sorted_boxes(rng, b, k):
    cxy = rng.uniform(50, 590, (b, k, 2))
    wh = rng.uniform(10, 120, (b, k, 2))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)


def _chain_boxes(k):
    """Box i overlaps box i+1 at IoU 0.5 and box i+2 at 0.2: greedy keeps every other box."""
    x = np.arange(k, dtype=np.float32)[:, None] * 10
    return np.concatenate([x, np.zeros_like(x), x + 30, np.full_like(x, 10)], 1)[None]


@pytest.mark.parametrize("case", ["K=37", "K=100", "K=257", "chain"])
def test_walk_schedule_equals_the_jax_kernel_and_the_fixpoint(case):
    rng = np.random.default_rng(len(case))
    if case == "chain":
        boxes, thr = _chain_boxes(100), 0.3
        valid = np.ones((1, 100), bool)
    else:
        k = int(case[2:])
        boxes, thr = _sorted_boxes(rng, 3, k), 0.5
        valid = rng.uniform(0, 1, (3, k)) > 0.2
        valid[1] = np.arange(k) < 2 * k // 3  # a valid prefix: the walk stops at E
        valid[2, -1] = True  # the last candidate valid: E = K
    iou = np.stack([np.asarray(j_box_iou(jnp.asarray(b), jnp.asarray(b))) for b in boxes])
    want = np.asarray(greedy_nms_pallas(jnp.asarray(iou), jnp.asarray(valid), thr, interpret=True))
    fix = _nms_fixpoint(torch.from_numpy(iou), torch.from_numpy(valid), thr, max_sweeps=iou.shape[-1]).numpy()
    np.testing.assert_array_equal(fix, want)
    for b in range(len(boxes)):
        bits = written_bits(iou[b], valid[b], thr, rng)
        for carry in (1, 2, 3, None):
            np.testing.assert_array_equal(walk_schedule(bits, valid[b], carry, rng), want[b])
    if case == "chain":
        np.testing.assert_array_equal(want[0], np.arange(100) % 2 == 0)
    else:
        assert 0 < want.sum() < valid.sum()


def test_bits_rows_start_on_16_bytes():
    for k in (1, 31, 32, 33, 37, 128, 129, 384, 1000, 1024, 1025, 4096, 8192):
        stride = bits_stride(k)
        assert stride % 4 == 0 and (k + 31) // 32 <= stride < (k + 31) // 32 + 4


def kernel_a_hits(boxes: np.ndarray, thr: float) -> np.ndarray:
    """Kernel A's pair test (`csrc/nms_fused.cu`) in float32 numpy, row box
    i against column box j: a box with a NaN coordinate never hits; between
    the others np.fmin / np.fmax (which drop NaN, as fminf / fmaxf do) stand
    for torch.minimum / torch.maximum, the clamps keep the NaN of inf - inf
    (np.maximum), and an empty intersection skips the division (0 > thr where
    the areas are not NaN)."""
    a, c = boxes[:, None, :], boxes[None, :, :]
    area = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    iw = np.maximum(np.fmin(a[..., 2], c[..., 2]) - np.fmax(a[..., 0], c[..., 0]), 0)
    ih = np.maximum(np.fmin(a[..., 3], c[..., 3]) - np.fmax(a[..., 1], c[..., 1]), 0)
    inter = iw * ih
    areas = area[:, None] + area[None, :]
    full = inter / ((areas - inter) + np.float32(1e-7)) > np.float32(thr)
    hit = np.where(inter == 0, ~np.isnan(areas) & (np.float32(0) > np.float32(thr)), full)
    finite = ~np.isnan(boxes).any(1)
    return hit & finite[:, None] & finite[None, :]


@pytest.mark.parametrize("thr", [0.45, -0.25])
def test_kernel_a_pair_test_equals_box_iou_matrix_on_nan_inf_and_empty_boxes(thr):
    rng = np.random.default_rng(7)
    boxes = _sorted_boxes(rng, 1, 96)[0]
    edge = np.array([np.nan, np.inf, -np.inf, 0.0, 200.0], np.float32)
    pick = rng.uniform(0, 1, boxes.shape) < 0.15
    boxes = np.where(pick, edge[rng.integers(0, len(edge), boxes.shape)], boxes)
    boxes[::7, 2:] = boxes[::7, :2]  # zero-area boxes
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        got = kernel_a_hits(boxes, thr)
    t = torch.from_numpy(boxes)
    want = (box_iou_matrix(t, t) > torch.tensor(thr, dtype=torch.float32)).numpy()
    upper = np.triu(np.ones_like(want), 1)
    np.testing.assert_array_equal(got & upper, want & upper)
    assert (want & upper).any() and np.isnan(boxes).any()
