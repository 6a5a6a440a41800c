"""The whole slice on the CPU: the port's YOLO11Validator vs the JAX package's.

A seeded PNG dataset of six frames of six shapes (the letterbox pads each
one differently), written with the port's `save_image` and labelled with
the port's own predictions at conf 0.25 (segment: the convex hull of each
predicted mask as its polygon; OBB: the corners of each rotated box), is
validated by both packages on the golden detect, segment, pose and OBB
weights at imgsz 96, batch 4 (the last batch padded), with the val
defaults (conf 0.001, iou 0.6, multi-label, pre_topk 4096). The JAX
validator drives a JAX Predictor through a SimpleNamespace(task, spec,
predictor).

- Every batch's detections agree: classes, counts, valid and anchor_idx
  exactly, boxes (OBB: all five values) and keypoints within 1e-3 px,
  scores within 1e-5, and at most 1e-3 of the segment mask bits (packed at
  prototype resolution, "bits") differ.
- Given those same detections (the JAX predictor's, replayed), the port's
  validator gives the JAX validator's metrics, per-class AP50, segment mask
  and pose OKS metrics, confusion matrix and k-fold scores within 1e-6.
- On its own predictor the port's metrics stay within 1e-2: AP is not
  continuous in the scores. The golden heads score an anchor almost alike
  in every frame (their activations fade through the graph), so the merged
  ranking holds scores one f32 ulp apart that the two packages order
  differently; over seeds that moved an AP by 7e-4 to 2e-2.
"""

from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest
from yolo_infer_tpu.core.predictor import Predictor as JaxPredictor
from yolo_infer_tpu.core.validator import YOLO11Validator as JaxValidator
from yolo_infer_tpu.models import build_spec as jax_build_spec
from yolo_infer_tpu.models import fold_model as jax_fold_model
from yolo_infer_tpu.models.convert import convert_state_dict
from yolo_infer_tpu_torch.core.predictor import Predictor
from yolo_infer_tpu_torch.core.validator import YOLO11Validator, create_validator
from yolo_infer_tpu_torch.data.loader import save_image
from yolo_infer_tpu_torch.data.polygon import convex_hull
from yolo_infer_tpu_torch.models.convert import load_state_dict
from yolo_infer_tpu_torch.models.spec import build_spec
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

IMGSZ = 96
SHAPES = [(96, 64), (72, 96), (96, 80), (48, 96), (96, 56), (80, 96)]
VAL = dict(imgsz=IMGSZ, batch=4)
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


class _Recorder:
    """A predictor that records every `predict_raw` result (as numpy)."""

    def __init__(self, pred):
        self.pred, self.spec, self.device, self.dets = pred, pred.spec, getattr(pred, "device", None), []

    def predict_raw(self, *args, **kw):
        out = self.pred.predict_raw(*args, **kw)
        self.dets.append({k: np.array(v) for k, v in out.items() if v is not None})
        return out


class _Replay:
    """A port-shaped predictor that returns recorded detections in order."""

    def __init__(self, spec, dets):
        self.spec, self.device, self._dets = spec, torch.device("cpu"), iter(dets)

    def predict_raw(self, *args, **kw):
        return {k: torch.from_numpy(v) for k, v in next(self._dets).items()}


def _mask_polygon(mask, box):
    """The convex hull of a binary mask's pixels (each row's first and last
    set pixel, as pixel corners), or the box's corners for an empty mask."""
    rows = np.nonzero(mask.any(1))[0]
    if not len(rows):
        x1, y1, x2, y2 = box
        return np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.float32)
    left = np.array([np.nonzero(mask[r])[0][[0, -1]] for r in rows])
    pts = np.concatenate([np.stack([left[:, 0], rows], 1), np.stack([left[:, 1] + 1, rows], 1),
                          np.stack([left[:, 0], rows + 1], 1), np.stack([left[:, 1] + 1, rows + 1], 1)])
    return convex_hull(pts.astype(np.float32))


def _obb_corners(cx, cy, w, h, r):
    c, s = np.cos(r), np.sin(r)
    return np.array([[cx + dx * c - dy * s, cy + dx * s + dy * c]
                     for dx, dy in ((-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2), (-w / 2, h / 2))])


def _self_labelled_dataset(root, task, port):
    """The six frames labelled with `port`'s detections at conf 0.25: boxes
    as normalized xywh, pose keypoints with visibility 2 where the predicted
    keypoint confidence exceeds 0.5, else 1; segment polygons from the
    predicted masks and OBB corners from the rotated boxes, normalized and
    clipped to the frame."""
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, shape + (3,), dtype=np.uint8) for shape in SHAPES]
    results = port.predict(frames, conf=0.25, iou=0.6, imgsz=IMGSZ)
    assert sum(len(r) for r in results) >= 6
    (root / "labels" / "val").mkdir(parents=True)
    for i, (frame, r) in enumerate(zip(frames, results)):
        save_image(root / "images" / "val" / f"f{i}.png", frame)
        h, w = frame.shape[:2]
        lines = []
        masks = np.asarray(r.masks) if task == "segment" else None
        for j in range(len(r)):
            if task in ("segment", "obb"):
                pts = _mask_polygon(masks[j] > 0.5, r.boxes[j]) if task == "segment" else _obb_corners(*r.obb[j])
                pts = (np.asarray(pts, np.float64) / [w, h]).clip(0, 1)
                lines.append(f"{r.classes[j]} " + " ".join(f"{v:.6f}" for v in pts.ravel()))
                continue
            x1, y1, x2, y2 = (r.boxes[j] / [w, h, w, h]).clip(0, 1)
            line = f"{r.classes[j]} {(x1 + x2) / 2:.6f} {(y1 + y2) / 2:.6f} {x2 - x1:.6f} {y2 - y1:.6f}"
            if task == "pose":
                line += "".join(f" {x / w:.6f} {y / h:.6f} {2 if v > 0.5 else 1}" for x, y, v in r.keypoints[j])
            lines.append(line)
        (root / "labels" / "val" / f"f{i}.txt").write_text("\n".join(lines) + "\n")
    return {"path": str(root), "val": "images/val", "names": {c: f"c{c}" for c in range(port.spec.nc)}}


def _assert_close(got, want, atol=1e-6, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], atol, f"{path}.{k}")
    else:
        np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float), atol=atol, rtol=0, err_msg=path)


def _assert_same_detections(got, want):
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        for key in ("num", "valid", "classes", "anchor_idx"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5, rtol=0)
        if "kpts" in w:
            np.testing.assert_allclose(g["kpts"], w["kpts"], atol=1e-3, rtol=0)
        if "mask_bits" in w:
            bits = [np.unpackbits(d["mask_bits"][i, :n], axis=-1) for d in (g, w) for i, n in enumerate(d["num"])]
            differ = sum(int((a != b).sum()) for a, b in zip(bits[:len(bits) // 2], bits[len(bits) // 2:]))
            assert g["mask_bits"].shape == w["mask_bits"].shape and differ <= 1e-3 * sum(a.size for a in bits) / 2


@pytest.mark.parametrize("task", ["detect", "segment", "pose", "obb"])
def test_validate_matches_the_jax_validator(tmp_path, task):
    jax_pred, port = _predictors(task)
    data = _self_labelled_dataset(tmp_path / "data", task, port)
    kw = dict(VAL, verbose=False, confusion_matrix=True, save_json=True)
    jax_rec = _Recorder(jax_pred)
    want = JaxValidator(model=SimpleNamespace(task=task, spec=jax_pred.spec, predictor=jax_rec),
                        output_dir=tmp_path / "jax").validate(data, **kw)
    port_rec = _Recorder(port)
    got = YOLO11Validator(model=SimpleNamespace(predictor=port_rec), output_dir=tmp_path / "port").validate(data, **kw)
    _assert_same_detections(port_rec.dets, jax_rec.dets)
    replayed = YOLO11Validator(model=SimpleNamespace(predictor=_Replay(port.spec, jax_rec.dets)),
                               output_dir=tmp_path / "replay").validate(data, **kw)

    task_key = {"segment": "mask_metrics", "pose": "pose_metrics"}.get(task)
    keys = ["metrics", "per_class_ap50", "confusion_matrix"] + ([task_key] if task_key else [])
    assert set(got) == set(replayed) == set(want) and {"num_images", "speed", "config"} <= set(want)
    assert got["num_images"] == replayed["num_images"] == want["num_images"] == 6
    assert got["config"] == want["config"]
    _assert_close({k: replayed[k] for k in keys}, {k: want[k] for k in keys})
    _assert_close(got["metrics"], want["metrics"], atol=1e-2)
    if task_key:
        _assert_close(got[task_key], want[task_key], atol=1e-2)
    # a mask label is the hull of the full-size mask, drawn again on the 24 x 24
    # prototype grid the predictions are scored on: a coarse match
    assert want["metrics"]["mAP50"] > 0.5 and (task_key is None or want[task_key]["mAP50"] > 0.3)
    assert (tmp_path / "replay" / "confusion_matrix.txt").read_text() == \
        (tmp_path / "jax" / "confusion_matrix.txt").read_text()
    for name in ("validation_summary.txt", "validation_results.json"):
        assert (tmp_path / "port" / name).exists()


class _ExactMasks(_Recorder):
    """A recording predictor whose segment rows carry the prototypes and
    mask coefficients ("exact") in place of the packed bits."""

    def predict_raw(self, *args, **kw):
        return super().predict_raw(*args, **{**kw, "mask_out": "exact"})


def test_segment_mask_metrics_from_prototypes_match_the_jax_validator(tmp_path):
    """A predictor that returns no `mask_bits`: both validators threshold
    their own host assembly of the prototypes at 0.5 (`_assemble_masks`);
    on the JAX predictor's replayed rows the port's mask metrics equal the
    JAX validator's within 1e-6, and on its own rows within 1e-2."""
    jax_pred, port = _predictors("segment")
    data = _self_labelled_dataset(tmp_path / "data", "segment", port)
    kw = dict(VAL, verbose=False)
    jax_rec = _ExactMasks(jax_pred)
    want = JaxValidator(model=SimpleNamespace(task="segment", spec=jax_pred.spec, predictor=jax_rec),
                        output_dir=tmp_path / "jax").validate(data, **kw)
    assert all("mask_coefs" in d and "mask_bits" not in d for d in jax_rec.dets)
    replayed = YOLO11Validator(model=SimpleNamespace(predictor=_Replay(port.spec, jax_rec.dets)),
                               output_dir=tmp_path / "replay").validate(data, **kw)
    got = YOLO11Validator(model=SimpleNamespace(predictor=_ExactMasks(port)), output_dir=tmp_path / "port").validate(
        data, **kw)
    _assert_close(replayed["mask_metrics"], want["mask_metrics"])
    _assert_close(got["mask_metrics"], want["mask_metrics"], atol=1e-2)
    assert want["mask_metrics"]["mAP50"] > 0.3


def test_cross_validate_matches_the_jax_validator(tmp_path):
    jax_pred, port = _predictors("detect")
    data = _self_labelled_dataset(tmp_path / "data", "detect", port)
    jax_rec = _Recorder(jax_pred)
    want = JaxValidator(model=SimpleNamespace(task="detect", spec=jax_pred.spec, predictor=jax_rec),
                        output_dir=tmp_path / "jax").cross_validate(data, k=2, **VAL)
    port_rec = _Recorder(port)
    got = YOLO11Validator(model=SimpleNamespace(predictor=port_rec), output_dir=tmp_path / "port").cross_validate(
        data, k=2, **VAL)
    _assert_same_detections(port_rec.dets, jax_rec.dets)
    replayed = YOLO11Validator(model=SimpleNamespace(predictor=_Replay(port.spec, jax_rec.dets)),
                               output_dir=tmp_path / "replay").cross_validate(data, k=2, **VAL)
    _assert_close(replayed, want)
    _assert_close(got, want, atol=1e-2)


def test_validator_takes_a_predictor_and_raises_without_a_model_loader(tmp_path):
    """A Predictor serves as the model; a model name builds the port's
    YOLO11Model, and so does a checkpoint file (a native one loads; a file
    that is no checkpoint raises), which `benchmark_speed` times and
    `compare_models` validates."""
    from yolo_infer_tpu_torch.core.model import YOLO11Model

    port = _predictors("detect")[1]
    assert YOLO11Validator(model=port, output_dir=tmp_path).predictor is port
    ckpt = YOLO11Model("yolo11n", nc=3, device="cpu").save(tmp_path / "yolo11n.msgpack")
    assert YOLO11Validator(model_path=str(ckpt), device="cpu").model.nc == 3
    bad = tmp_path / "yolo11n.pt"
    bad.write_bytes(b"")
    with pytest.raises(EOFError):  # an empty .pt: the unpickler runs out of input
        YOLO11Validator(model_path=str(bad))
    v = create_validator("yolo11n", device="cpu", output_dir=tmp_path)
    assert v.model.task == "detect" and v.predictor.device.type == "cpu"
    speed = v.benchmark_speed(imgsz_list=(32,), batch_sizes=(1,), runs=1)
    assert speed["imgsz32_batch1"]["batch"] == 1 and (tmp_path / "speed_benchmark.json").exists()
    data = _self_labelled_dataset(tmp_path / "data", "detect", port)
    cmp = YOLO11Validator(model=port, output_dir=tmp_path, device="cpu").compare_models(
        ["yolo11n", "yolo11n-pose"], data, imgsz=32, batch=4)
    assert set(cmp["results"]) == {"yolo11n", "yolo11n-pose"} and cmp["best"] in cmp["results"]
