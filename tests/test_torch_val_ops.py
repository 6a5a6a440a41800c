"""The port's validation ops (kernels F and G's plain versions, the full-grid
decode, multi-label NMS, the multi-label Predictor) vs the JAX package, on the CPU.

Same numpy-seeded inputs through the JAX function and its port counterpart:
F's plain version within 1e-5 of the Pallas kernel in interpret mode (the
same formula) and within 1e-4 of `dfl_expectation` (softmax first, then the
dot: the rounding differs, as the JAX kernel's own test allows); G's plain
version bit-equal to the Pallas kernel; `batched_nms` with exact classes,
counts, valid and anchor_idx, boxes and scores within 1e-5; the multi-label
`predict_raw` (pre_topk 4096) on golden weights, OBB's included, with exact
classes and counts, boxes and keypoints within 1e-3 px and scores within
1e-5.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest
from yolo_infer_tpu.core.predictor import Predictor as JaxPredictor
from yolo_infer_tpu.models import build_spec as jax_build_spec
from yolo_infer_tpu.models import fold_model as jax_fold_model
from yolo_infer_tpu.models.convert import convert_state_dict
from yolo_infer_tpu.ops import decode as jdec
from yolo_infer_tpu.ops import nms as jnms
from yolo_infer_tpu.ops.iou import box_iou_matrix as j_box_iou
from yolo_infer_tpu.ops.pallas.dfl_kernel import dfl_decode_pallas
from yolo_infer_tpu.ops.pallas.nms_kernel import greedy_nms_pallas
from yolo_infer_tpu_torch.core.predictor import Predictor
from yolo_infer_tpu_torch.models.convert import load_state_dict
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.ops import decode as tdec
from yolo_infer_tpu_torch.ops import nms as tnms
from yolo_infer_tpu_torch.ops.kernels import dfl_decode, greedy_nms
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# --- kernel F's plain version -------------------------------------------------


def test_dfl_plain_version_matches_pallas_kernel_and_dfl_expectation():
    x = np.random.default_rng(0).normal(0, 2, (2, 700, 64)).astype(np.float32)  # A=700: the Pallas tile pads
    got = dfl_decode.dfl_decode_reference(torch.from_numpy(x)).numpy()
    kernel = np.asarray(dfl_decode_pallas(jnp.asarray(x), tile=512, interpret=True))
    np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jdec.dfl_expectation(jnp.asarray(x))), atol=1e-4, rtol=0)


def _spread_logits(rng, shape):
    """N(0, 8) logits, and in one row in four each side's 16 bins a shuffled
    ramp from -40 to 40 (as chip_smoke.py's phase 12)."""
    x = rng.normal(0, 8, shape).astype(np.float32)
    sides = x[..., :64].reshape(-1, 4, 16)
    rows = rng.choice(sides.shape[0], sides.shape[0] // 4, replace=False)
    sides[rows] = rng.permuted(np.broadcast_to(np.linspace(-40, 40, 16, dtype=np.float32), (len(rows), 4, 16)), axis=-1)
    x[..., :64] = sides.reshape(*shape[:-1], 64)
    return x


@pytest.mark.parametrize("case", ["65-channel slab (pose nc 1)", "79-channel slab (obb nc 15)", "wide spread"])
def test_dfl_plain_version_matches_pallas_kernel_on_the_paths_slab_slices(case):
    """The slab slices whose rows the kernel reads at 2- and 4-byte alignment,
    and logits spread far enough that exp(x - max) spans ~1e-35..1."""
    rng = np.random.default_rng(2)
    if case == "wide spread":
        slab = _spread_logits(rng, (2, 300, 79))
    else:
        slab = rng.normal(0, 3, (2, 300, 65 if case.startswith("65") else 79)).astype(np.float32)
    view = torch.from_numpy(slab)[..., :64]
    assert not view.is_contiguous()
    got = dfl_decode.dfl_decode_reference(view).numpy()
    kernel = np.asarray(dfl_decode_pallas(jnp.asarray(slab[..., :64]), tile=512, interpret=True))
    np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=0)


def test_dfl_wrapper_reads_the_head_slab_slice_and_counts_only_kernel_launches():
    slab = torch.from_numpy(np.random.default_rng(1).normal(0, 2, (2, 50, 64 + 7)).astype(np.float32))
    view = slab[..., :64]
    assert not view.is_contiguous()
    before = dfl_decode.dfl_decode.launches
    got = dfl_decode.dfl_decode(view)
    assert dfl_decode.dfl_decode.launches == before
    assert got.shape == (2, 50, 4) and got.dtype == torch.float32
    torch.testing.assert_close(got, dfl_decode.dfl_decode_reference(view.contiguous()), atol=0, rtol=0)
    bf16 = dfl_decode.dfl_decode(view.bfloat16())
    torch.testing.assert_close(bf16, dfl_decode.dfl_decode_reference(view.bfloat16().float()), atol=0, rtol=0)
    with pytest.raises(ValueError):
        dfl_decode.dfl_decode(torch.zeros((1, 4, 64), device="meta"))


def _feats(rng, b=2, nc=5, sizes=((12, 12), (6, 6), (3, 3))):
    return [rng.normal(0, 2, (b, h, w, 64 + nc)).astype(np.float32) for h, w in sizes]


def test_decode_detections_matches_jax():
    feats = _feats(np.random.default_rng(2))
    boxes, scores = tdec.decode_detections([torch.from_numpy(f) for f in feats], 5)
    jboxes, jscores = jdec.decode_detections([jnp.asarray(f) for f in feats], 5)
    assert boxes.shape == (2, 189, 4) and scores.shape == (2, 189, 5)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), atol=1e-3, rtol=0)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=1e-6, rtol=0)


# --- kernel G's plain version -------------------------------------------------


def _sorted_boxes(rng, k):
    cxy = rng.uniform(50, 590, (k, 2))
    wh = rng.uniform(10, 120, (k, 2))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)


def _keep_both(iou, valid, thr):
    got = greedy_nms.greedy_nms_keep(torch.from_numpy(iou), torch.from_numpy(valid), thr).numpy()
    want = np.asarray(greedy_nms_pallas(jnp.asarray(iou), jnp.asarray(valid), thr, interpret=True))
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_keep_matches_pallas_kernel(seed):
    rng = np.random.default_rng(seed)
    boxes = np.stack([_sorted_boxes(rng, 128) for _ in range(2)])
    iou = np.stack([np.asarray(j_box_iou(jnp.asarray(b), jnp.asarray(b))) for b in boxes])
    valid = rng.uniform(0, 1, (2, 128)) > 0.1
    got, want = _keep_both(iou, valid, 0.5)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


def test_greedy_keep_respects_the_valid_mask():
    iou = np.eye(128, dtype=np.float32)[None]
    valid = np.zeros((1, 128), bool)
    valid[0, :5] = True
    got, want = _keep_both(iou, valid, 0.5)
    np.testing.assert_array_equal(got, want)
    assert got[0, :5].all() and not got[0, 5:].any()


def test_greedy_keep_long_suppression_chain():
    """Box i overlaps box i+1 (IoU 0.5) but not i+2 (0.2): greedy keeps every
    other box, and the fixpoint needs K sweeps to get there."""
    x = np.arange(128, dtype=np.float32)[:, None] * 10
    boxes = np.concatenate([x, np.zeros_like(x), x + 30, np.full_like(x, 10)], 1)
    iou = np.asarray(j_box_iou(jnp.asarray(boxes), jnp.asarray(boxes)))[None]
    got, want = _keep_both(iou, np.ones((1, 128), bool), 0.3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.arange(128) % 2 == 0)


# --- multi-label NMS ----------------------------------------------------------


def _dense_scene(seed, b=2, a=300, nc=80):
    """Seeded boxes and sigmoided scores with clustered, overlapping objects
    and many scores tied at the conf floor."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(60, 580, (b, 12, 2))
    cxy = centres[:, rng.integers(0, 12, a)] + rng.normal(0, 8, (b, a, 2))
    wh = rng.uniform(20, 90, (b, a, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    logits = rng.normal(-4, 2.5, (b, a, nc))
    scores = (1 / (1 + np.exp(-logits))).astype(np.float32)
    scores[:, ::7, :3] = 0.5  # ties across anchors and classes
    return boxes, scores


@pytest.mark.parametrize("multi_label,topc,pre_topk,max_det", [
    (True, 8, 4096, 300), (True, 100, 4096, 300), (True, 8, 200, 300), (True, 8, 4096, 50),
    (False, 8, 4096, 300)])
def test_batched_nms_matches_jax(multi_label, topc, pre_topk, max_det):
    boxes, scores = _dense_scene(3)
    kw = dict(pre_topk=pre_topk, max_det=max_det, multi_label=multi_label, multi_label_topc=topc)
    got = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.001, 0.6, **kw)
    want = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.001, 0.6, **kw)
    assert int(got["num"].min()) > 0
    for key in ("num", "valid", "classes", "anchor_idx"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-5, rtol=0)


def test_topc_per_anchor_matches_jax_with_ties():
    scores = np.random.default_rng(4).integers(0, 4, (2, 50, 20)).astype(np.float32) / 4  # many ties
    vals, idx = tnms._topc_per_anchor(torch.from_numpy(scores), 8)
    jvals, jidx = jnms._topc_per_anchor(jnp.asarray(scores), 8)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


# --- the multi-label Predictor ------------------------------------------------

_CACHE = {}


def _predictors(task):
    if task not in _CACHE:
        z = np.load(Path(__file__).parent / "golden" / f"golden_{task}_n_v{GOLDEN_VERSION}.npz")
        sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
        nc = int(z["nc"])
        jspec = jax_build_spec(task, "n", nc=nc)
        params, state = convert_state_dict(sd, jspec)
        spec = build_spec(task, "n", nc=nc)
        _CACHE[task] = (JaxPredictor(jax_fold_model(params, state), jspec, compute_dtype=jnp.float32),
                        Predictor(load_state_dict(sd, spec), spec, device="cpu", compute_dtype=torch.float32))
    return _CACHE[task]


@pytest.mark.parametrize("task,topc", [("detect", "8"), ("detect", "2"), ("pose", "8"), ("obb", "8"), ("obb", "2")])
def test_multi_label_predict_raw_matches_jax(task, topc, monkeypatch):
    """conf 0.001 and iou 0.6 as the validator runs it; YOLO_MULTI_LABEL_TOPC=2
    (< nc = 5) takes the per-anchor top-C pool, 8 the whole (anchor, class)
    pool. OBB: the rotated NMS's pool of (anchor, class) pairs and its
    probIoU keep (kernel C's plain version), boxes (B, 300, 5)."""
    monkeypatch.setenv("YOLO_MULTI_LABEL_TOPC", topc)
    jax_pred, port = _predictors(task)
    frames = np.random.default_rng(5).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    got = port.predict_raw(torch.from_numpy(frames), 0.001, 0.6, 96, max_det=300, multi_label=True, pre_topk=4096)
    want = jax_pred.predict_raw(jnp.asarray(frames), 0.001, 0.6, 96, multi_label=True, max_det=300, pre_topk=4096)
    assert int(got["num"].min()) > 10
    for key in ("num", "valid", "classes", "anchor_idx"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-5, rtol=0)
    if task == "pose":
        np.testing.assert_allclose(got["kpts"].numpy(), np.asarray(want["kpts"]), atol=1e-3, rtol=0)


def test_multi_label_predict_matches_jax_results():
    jax_pred, port = _predictors("detect")
    frames = list(np.random.default_rng(6).integers(0, 256, (2, 72, 96, 3), dtype=np.uint8))
    got = port.predict(frames, conf=0.01, iou=0.6, imgsz=96, multi_label=True)
    want = jax_pred.predict(frames, conf=0.01, iou=0.6, imgsz=96, multi_label=True)
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        np.testing.assert_array_equal(g.classes, w.classes)
        np.testing.assert_allclose(g.boxes, w.boxes, atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-5, rtol=0)
