"""The port's detect Predictor vs the JAX Predictor, on the CPU.

Both predictors serve the golden detect weights (tests/golden) in f32 on the
same numpy-seeded frames: imgsz 96 has fewer candidates than max_det (the
padding path), imgsz 160 fills the 384-row pool. Also: no silent CPU
fallback and the mixed-size host letterbox path.
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
from yolo_infer_tpu_torch.core.predictor import Predictor
from yolo_infer_tpu_torch.models.convert import load_state_dict
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.models.yolo11 import build_model
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

GOLDEN = Path(__file__).parent / "golden" / f"golden_detect_n_v{GOLDEN_VERSION}.npz"


@pytest.fixture(scope="module")
def golden_sd():
    z = np.load(GOLDEN)
    names = str(z["names"]).split("\n")
    return golden_state_dict(names, unpack_manifest(z["shapes_flat"], z["shapes_ndims"])), int(z["nc"])


@pytest.fixture(scope="module")
def predictors(golden_sd):
    sd, nc = golden_sd
    jspec = jax_build_spec("detect", "n", nc=nc)
    params, state = convert_state_dict(sd, jspec)
    jax_pred = JaxPredictor(jax_fold_model(params, state), jspec, compute_dtype=jnp.float32)
    spec = build_spec("detect", "n", nc=nc)
    port = Predictor(load_state_dict(sd, spec), spec, device="cpu", compute_dtype=torch.float32)
    return jax_pred, port


SCORE_ATOL = 1e-5


def canonical(result):
    """(boxes, scores, classes) of a result with each run of rows whose
    scores are within SCORE_ATOL of the row before sorted by class, then
    box: f32 summation noise below the score tolerance may rank such rows
    either way (e.g. two class-3 detections scored 0.5055147 and 0.5055146
    by one package, 0.5055147 twice by the other)."""
    scores = np.asarray(result.scores)
    order, start = [], 0
    for i in range(1, len(scores) + 1):
        if i == len(scores) or abs(float(scores[i]) - float(scores[i - 1])) > SCORE_ATOL:
            order += sorted(range(start, i), key=lambda k: (int(result.classes[k]), *map(float, result.boxes[k])))
            start = i
    return np.asarray(result.boxes)[order], scores[order], np.asarray(result.classes)[order]


@pytest.mark.parametrize("iou", [0.45, 0.7])
@pytest.mark.parametrize("imgsz", [96, 160])
def test_predict_matches_jax_predictor(predictors, imgsz, iou):
    jax_pred, port = predictors
    frames = np.random.default_rng(imgsz).integers(0, 256, (2, imgsz * 3 // 4, imgsz, 3), dtype=np.uint8)
    want = jax_pred.predict(list(frames), conf=0.25, iou=iou, imgsz=imgsz)
    got = port.predict(list(frames), conf=0.25, iou=iou, imgsz=imgsz)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        assert g.orig_shape == w.orig_shape
        (g_boxes, g_scores, g_classes), (w_boxes, w_scores, w_classes) = canonical(g), canonical(w)
        np.testing.assert_array_equal(g_classes, w_classes)
        np.testing.assert_allclose(g_boxes, w_boxes, atol=1e-3, rtol=0)
        np.testing.assert_allclose(g_scores, w_scores, atol=SCORE_ATOL, rtol=0)


def test_mixed_frame_sizes_take_the_host_letterbox(predictors):
    _, port = predictors
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in ((60, 96), (96, 72))]
    out = port.predict(frames, conf=0.25, imgsz=96)
    assert [r.orig_shape for r in out] == [(60, 96), (96, 72)]
    for r, (h, w) in zip(out, ((60, 96), (96, 72))):
        assert len(r) > 0
        assert (r.boxes[:, [0, 2]] <= w).all() and (r.boxes[:, [1, 3]] <= h).all() and (r.boxes >= 0).all()


def test_predictor_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    model, spec = build_model("detect", "n", seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model, spec)


def _snapshot(model):
    return {k: v.clone() for k, v in model.state_dict().items()}, [type(m).__name__ for m in model.modules()]


def test_predictor_leaves_the_callers_module_unchanged():
    """A bf16 Predictor serves a folded, cast copy: the module it was given
    keeps its dtypes, its parameters bit for bit and its batch norms."""
    model, spec = build_model("detect", "n", seed=0)
    state, kinds = _snapshot(model)
    pred = Predictor(model, spec, device="cpu")
    assert pred.model is not model
    assert next(pred.model.parameters()).dtype == torch.bfloat16
    after, kinds_after = _snapshot(model)
    assert kinds_after == kinds and "BatchNorm2d" in kinds
    assert list(after) == list(state)
    for k, v in state.items():
        assert after[k].dtype == v.dtype and torch.equal(after[k], v), k


def test_fp32_predictor_after_a_bf16_one_serves_the_original_weights():
    """An fp32 Predictor built on a module that already served a bf16
    Predictor gives the head outputs of one built on a fresh copy."""
    model, spec = build_model("detect", "n", seed=0)
    Predictor(model, spec, device="cpu", compute_dtype=torch.bfloat16)
    reused = Predictor(model, spec, device="cpu", compute_dtype=torch.float32)
    fresh = Predictor(build_model("detect", "n", seed=0)[0], spec, device="cpu", compute_dtype=torch.float32)
    x = torch.from_numpy(np.random.default_rng(11).random((2, 96, 96, 3)).astype(np.float32))
    with torch.inference_mode():
        got, want = reused.model(x), fresh.model(x)
    for g, w in zip(got["feats"], want["feats"]):
        assert torch.equal(g, w)
