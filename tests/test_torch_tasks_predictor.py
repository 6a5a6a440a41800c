"""The port's segment, OBB, pose and classify Predictor vs the JAX Predictor, on the CPU.

Both predictors serve a task's golden weights (tests/golden) in f32 on the
same numpy-seeded 72x96 frames at imgsz 96 (segment also at 128) with
max_det 100: equal counts and classes, boxes and obb within 1e-3 px, scores
within 1e-5, keypoints within 1e-3 px, probs within 1e-5, and the lazily
read masks equal (at most 1e-4 of the pixels may differ).
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
from yolo_infer_tpu_torch.core.predictor import LazyMasks, Predictor
from yolo_infer_tpu_torch.models.convert import load_state_dict
from yolo_infer_tpu_torch.models.spec import build_spec
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_CACHE = {}


def _predictors(task, **kw):
    key = (task, tuple(sorted(kw.items())))
    if key not in _CACHE:
        z = np.load(Path(__file__).parent / "golden" / f"golden_{task}_n_v{GOLDEN_VERSION}.npz")
        sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
        nc = int(z["nc"])
        jspec = jax_build_spec(task, "n", nc=nc)
        params, state = convert_state_dict(sd, jspec)
        jax_pred = JaxPredictor(jax_fold_model(params, state), jspec, compute_dtype=jnp.float32, **kw)
        spec = build_spec(task, "n", nc=nc)
        port = Predictor(load_state_dict(sd, spec), spec, device="cpu", compute_dtype=torch.float32, **kw)
        _CACHE[key] = (jax_pred, port)
    return _CACHE[key]


def _both(task, imgsz=96, seed=0, **kw):
    jax_pred, port = _predictors(task, **kw)
    frames = np.random.default_rng(seed).integers(0, 256, (2, imgsz * 3 // 4, imgsz, 3), dtype=np.uint8)
    want = jax_pred.predict(list(frames), conf=0.25, iou=0.45, imgsz=imgsz, max_det=100)
    got = port.predict(list(frames), conf=0.25, iou=0.45, imgsz=imgsz, max_det=100)
    assert len(got) == len(want) == 2
    return got, want


def _same_detections(g, w):
    assert len(g) == len(w) > 0
    assert g.orig_shape == w.orig_shape
    np.testing.assert_array_equal(g.classes, w.classes)
    np.testing.assert_allclose(g.boxes, w.boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(g.scores, w.scores, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mask_mode,imgsz", [("device", 96), ("device", 128), ("device_half", 96)])
def test_segment_matches_jax_predictor(mask_mode, imgsz):
    got, want = _both("segment", imgsz, seed=imgsz, mask_mode=mask_mode)
    for g, w in zip(got, want):
        _same_detections(g, w)
        assert isinstance(g.masks, LazyMasks)
        assert g.masks.shape == w.masks.shape == (len(g), imgsz * 3 // 4, imgsz)
        gm, wm = g.masks.numpy(), np.asarray(w.masks)
        assert gm.dtype == np.float32 and set(np.unique(gm)) <= {0.0, 1.0}
        assert 0 < gm.mean() < 1
        assert (gm != wm).mean() <= 1e-4


def test_lazy_masks_prefetch_shape_and_ndarray_surface():
    got, _ = _both("segment", 96, seed=96, mask_mode="device")
    shapes = [r.masks.shape for r in got]
    LazyMasks.prefetch(got)  # one copy for both images
    assert all(r.masks._dev is None for r in got)
    fresh, _ = _both("segment", 96, seed=96, mask_mode="device")
    for r, f, shape in zip(got, fresh, shapes):
        np.testing.assert_array_equal(r.masks.numpy(), f.masks.numpy())
        assert r.masks.numpy().shape == shape
        assert len(r.masks) == shape[0] and r.masks.ndim == 3
        assert float(r.masks.sum()) == float(f.masks.numpy().sum())
        np.testing.assert_array_equal(np.asarray(r.masks) > 0.5, r.masks > 0.5)
        assert not hasattr(r.masks, "cpu")


@pytest.mark.parametrize("mode", ["q8", "bits", "exact", "auto"])
def test_unported_mask_modes_raise(mode):
    """The modes that raised before they were ported now serve their
    artifact (tests/test_torch_mask_modes.py holds them to JAX); an unknown
    mode raises."""
    from yolo_infer_tpu_torch.models.yolo11 import build_model

    model, spec = build_model("segment", "n", nc=3, seed=0)
    pred = Predictor(model, spec, device="cpu", mask_mode=mode)
    dets = pred.predict_raw(torch.zeros((1, 64, 64, 3), dtype=torch.uint8), 0.0, 0.45, 64, 5)
    key = {"q8": "mask_q8", "bits": "mask_bits", "exact": "mask_coefs", "auto": "mask_bits_up"}[mode]
    assert dets[key].shape[:2] == (1, 5)
    with pytest.raises(ValueError, match="mask_mode"):
        Predictor(model, spec, device="cpu", mask_mode=mode + "_x")


def test_segment_predict_raw_can_skip_the_masks():
    _, port = _predictors("segment", mask_mode="device")
    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 96, 96, 3), dtype=np.uint8))
    assert "mask_bits_up" in port.predict_raw(frames, 0.25, 0.45, 96, 100)
    assert "mask_bits_up" not in port.predict_raw(frames, 0.25, 0.45, 96, 100, mask_out="none")


def test_obb_matches_jax_predictor():
    got, want = _both("obb", 96, seed=3)
    for g, w in zip(got, want):
        _same_detections(g, w)
        assert g.obb.shape == (len(g), 5)
        np.testing.assert_allclose(g.obb, w.obb, atol=1e-3, rtol=0)


def test_pose_matches_jax_predictor():
    got, want = _both("pose", 96, seed=4)
    for g, w in zip(got, want):
        _same_detections(g, w)
        assert g.keypoints.shape == (len(g), 17, 3)
        np.testing.assert_allclose(g.keypoints, w.keypoints, atol=1e-3, rtol=0)


def test_classify_matches_jax_predictor():
    got, want = _both("classify", 96, seed=5)
    for g, w in zip(got, want):
        assert len(g) == 0 and g.probs.shape == w.probs.shape == (5,)
        np.testing.assert_allclose(g.probs.sum(), 1.0, atol=1e-5)
        np.testing.assert_allclose(g.probs, w.probs, atol=1e-5, rtol=0)
