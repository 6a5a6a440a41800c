"""The port's bulk serving vs the JAX package, on the CPU.

- The serving detect tail (select-then-decode) through both Predictors on
  the golden detect weights (f32): its pool, min(pre_topk, 384), must reach
  kernel A's wrapper, and the detections equal JAX's at that pool.
- `predict_many` against the JAX `predict_many` on ten frames at
  batch_size 4 (the last chunk padded), uniform and mixed sizes, and against
  the port's own `predict`; `YOLO11Model.predict` routes long lists and
  `batch=` to it.
Detections are held to equal counts and classes, boxes within 1e-3 px and
scores within 1e-5.
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
from yolo_infer_tpu_torch.core import predictor as tpred
from yolo_infer_tpu_torch.core.model import YOLO11Model
from yolo_infer_tpu_torch.core.predictor import Predictor
from yolo_infer_tpu_torch.models.convert import load_state_dict
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.ops import nms as tnms
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_CACHE = {}


# ------------------------------------------------------------------ predictors


def _predictors(task="detect", **kw):
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


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        assert g.orig_shape == w.orig_shape
        np.testing.assert_array_equal(g.classes, w.classes)
        np.testing.assert_allclose(g.boxes, w.boxes, atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-5, rtol=0)


def _frames(seed, n=2, hw=(120, 160)):
    return list(np.random.default_rng(seed).integers(0, 256, (n,) + hw + (3,), dtype=np.uint8))


@pytest.mark.parametrize("seed", [20, 25])
def test_detect_serving_matches_jax(seed):
    """The select-then-decode tail, the only serving detect tail of both
    packages off a mesh, at the default pool."""
    jax_pred, port = _predictors()
    frames = _frames(seed)
    _same_results(port.predict(frames, conf=0.25, iou=0.5, imgsz=160),
                  jax_pred.predict(frames, conf=0.25, iou=0.5, imgsz=160))


@pytest.mark.parametrize("pre_topk,pool", [(1024, 384), (256, 256), (384, 384), (100, 100)])
def test_serving_pool_reaches_kernel_a(monkeypatch, pre_topk, pool):
    """The pool is min(pre_topk, 384) (`SERVE_POOL`), the per-call
    `pre_topk` over the predictor's; the detections equal JAX's at the same
    `pre_topk`."""
    jax_pred, port = _predictors()
    frames = _frames(21)
    seen = []
    keep = tnms.nms_keep
    monkeypatch.setattr(tnms, "nms_keep", lambda bx, va, thr: seen.append(bx.shape[1]) or keep(bx, va, thr))
    dets = port.predict_raw(torch.from_numpy(np.stack([f[:96, :96] for f in frames])), 0.05, 0.5, 160,
                            pre_topk=pre_topk)
    assert seen == [pool]
    want = jax_pred.predict_raw(jnp.asarray(np.stack([f[:96, :96] for f in frames])), 0.05, 0.5, 160,
                                pre_topk=pre_topk)
    np.testing.assert_array_equal(dets["num"].numpy(), np.asarray(want["num"]))
    for i, n in enumerate(dets["num"].tolist()):
        np.testing.assert_array_equal(dets["classes"][i, :n].numpy(), np.asarray(want["classes"])[i, :n])
        np.testing.assert_allclose(dets["boxes"][i, :n].numpy(), np.asarray(want["boxes"])[i, :n], atol=1e-3, rtol=0)
        np.testing.assert_allclose(dets["scores"][i, :n].numpy(), np.asarray(want["scores"])[i, :n], atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("mixed", [False, True])
def test_predict_many_matches_jax_and_predict(mixed):
    jax_pred, port = _predictors()
    rng = np.random.default_rng(22)
    if mixed:
        frames = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in [(72, 96), (96, 64), (50, 96)] * 3 + [(80, 80)]]
    else:
        frames = _frames(22, n=10, hw=(72, 96))
    got = port.predict_many(frames, conf=0.25, imgsz=96, batch_size=4)
    _same_results(got, jax_pred.predict_many(frames, conf=0.25, imgsz=96, batch_size=4))
    # predict on the same chunks, the last padded as predict_many pads it (a
    # batch of another size may take other conv algorithms)
    chunks = [frames[lo:lo + 4] + [frames[min(lo + 4, 10) - 1]] * max(lo + 4 - 10, 0) for lo in range(0, 10, 4)]
    own = [r for c in chunks for r in port.predict(c, conf=0.25, imgsz=96)][:10]
    assert len(own) == len(got) == 10
    for g, w in zip(got, own):
        assert g.orig_shape == w.orig_shape
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.scores, w.scores)
        np.testing.assert_array_equal(g.classes, w.classes)
        assert g.speed["inference"] > 0


def test_predict_many_pose_and_depth_one():
    jax_pred, port = _predictors("pose")
    frames = _frames(23, n=5, hw=(72, 96))
    got = port.predict_many(frames, conf=0.25, imgsz=96, batch_size=2, pipeline_depth=1)
    want = jax_pred.predict_many(frames, conf=0.25, imgsz=96, batch_size=2, pipeline_depth=1)
    _same_results(got, want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.keypoints, w.keypoints, atol=1e-3, rtol=0)
    assert port.predict_many([], imgsz=96) == []
    with pytest.raises(ValueError, match="pipeline_depth"):
        port.predict_many(frames, imgsz=96, pipeline_depth=0)


def test_model_predict_routes_long_lists_and_batch_to_predict_many(monkeypatch):
    model = YOLO11Model("yolo11n", device="cpu", nc=3, compute_dtype=torch.float32)
    calls = []
    many = tpred.Predictor.predict_many

    def spy(self, images, **kw):
        calls.append((len(images), kw["batch_size"]))
        return many(self, images, **kw)

    monkeypatch.setattr(tpred.Predictor, "predict_many", spy)
    frames = np.random.default_rng(24).integers(0, 256, (65, 32, 32, 3), dtype=np.uint8)
    assert len(model.predict(list(frames), imgsz=32, conf=0.0, max_det=5)) == 65
    assert len(model.predict(frames[:5], imgsz=32, conf=0.0, max_det=5, batch=2)) == 5
    assert len(model.predict(frames[:5], imgsz=32, conf=0.0, max_det=5)) == 5  # whole, through predict
    assert calls == [(65, 32), (5, 2)]
