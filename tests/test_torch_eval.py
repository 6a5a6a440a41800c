"""Classify evaluation, the AP oracle and label QA: the port vs the JAX package, on the CPU.

- `data/classify.py`: `_resize_center_crop` bit for bit against the JAX
  package's (which resizes with `cv2.resize`) at up, down and unit scales;
  `ClassifyDataset` records and split rules; two `ClassifyLoader` epochs
  (shuffle, flips, the ragged tail) equal batch for batch; and
  `evaluate_classifier` gives the JAX package's top-1, top-5 and image
  count on golden classify weights (the head widened to 12 classes, so
  top-5 is not trivially 1), with a ragged last batch.
- `core/ap_oracle.py`: the port's copy gives the JAX oracle's mAP on
  randomized scenes under both protocols, and the port's `DetMetrics`
  equals it exactly under the ultralytics protocol.
- `data/dataset_validator.py`: the port's copy reports, caches and deletes
  as the JAX package's does, and its CLI exits alike.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest
from yolo_infer_tpu.core import ap_oracle as j_oracle
from yolo_infer_tpu.core.predictor import Predictor as JaxPredictor
from yolo_infer_tpu.data import classify as jcls
from yolo_infer_tpu.data import dataset_validator as jdv
from yolo_infer_tpu.models import build_spec as jax_build_spec
from yolo_infer_tpu.models import fold_model as jax_fold_model
from yolo_infer_tpu.models.convert import convert_state_dict
from yolo_infer_tpu_torch.core import ap_oracle as t_oracle
from yolo_infer_tpu_torch.core.metrics import DetMetrics
from yolo_infer_tpu_torch.core.predictor import Predictor
from yolo_infer_tpu_torch.data import classify as tcls
from yolo_infer_tpu_torch.data import dataset_validator as tdv
from yolo_infer_tpu_torch.data.loader import save_image
from yolo_infer_tpu_torch.models.convert import load_state_dict
from yolo_infer_tpu_torch.models.spec import build_spec
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

NC = 12  # the golden classify head (5 classes) widened, so top-5 can miss
IMGSZ = 32


def _classifiers():
    """A JAX and a port Predictor on the same golden classify weights, f32."""
    z = np.load(Path(__file__).parent / "golden" / f"golden_classify_n_v{GOLDEN_VERSION}.npz")
    names = str(z["names"]).split("\n")
    shapes = unpack_manifest(z["shapes_flat"], z["shapes_ndims"])
    shapes = [(NC,) + tuple(s[1:]) if n.startswith("model.10.linear.") else s for n, s in zip(names, shapes)]
    sd = golden_state_dict(names, shapes)
    jspec = jax_build_spec("classify", "n", nc=NC)
    params, state = convert_state_dict(sd, jspec)
    spec = build_spec("classify", "n", nc=NC)
    return (JaxPredictor(jax_fold_model(params, state), jspec, compute_dtype=jnp.float32),
            Predictor(load_state_dict(sd, spec), spec, device="cpu", compute_dtype=torch.float32))


def _image_tree(root, shapes, labels):
    """PNG frames in a val/<class>/ tree (class directories for all NC
    classes, some left empty)."""
    rng = np.random.default_rng(len(shapes))
    for c in range(NC):
        (root / "val" / f"c{c:02d}").mkdir(parents=True, exist_ok=True)
    (root / "train").mkdir()
    for i, (shape, label) in enumerate(zip(shapes, labels)):
        save_image(root / "val" / f"c{label:02d}" / f"im{i:02d}.png", rng.integers(0, 256, shape + (3,), dtype=np.uint8))
    return root


@pytest.mark.parametrize("hw, size", [((17, 29), 32), ((120, 90), 32), ((64, 64), 64), ((40, 100), 48),
                                      ((33, 31), 32), ((7, 200), 16)])
def test_resize_center_crop_matches_jax(hw, size):
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), dtype=np.uint8)
    got, want = tcls._resize_center_crop(img, size), jcls._resize_center_crop(img, size)
    assert got.shape == (size, size, 3)
    np.testing.assert_array_equal(got, want)


def test_classify_dataset_and_loader_epochs_match_jax(tmp_path):
    shapes = [(24, 40), (40, 24), (32, 32), (50, 30), (20, 20), (36, 44), (28, 28)]
    root = _image_tree(tmp_path, shapes, [0, 3, 3, 7, 11, 0, 5])
    got, want = tcls.ClassifyDataset(root, "val"), jcls.ClassifyDataset(root, "val")
    assert got.samples == want.samples and got.names == want.names and got.nc == want.nc == NC
    for i in range(len(want)):
        np.testing.assert_array_equal(got[i]["image"], want[i]["image"])
    with pytest.raises(FileNotFoundError):
        tcls.ClassifyDataset(root, "test")
    flat = tcls.ClassifyDataset(root / "val")
    assert flat.samples == jcls.ClassifyDataset(root / "val").samples
    for batch_size in (3, 16):  # three full batches and a dropped tail; one batch padded by repeats
        tl = tcls.ClassifyLoader(got, batch_size=batch_size, imgsz=IMGSZ, seed=4)
        jl = jcls.ClassifyLoader(want, batch_size=batch_size, imgsz=IMGSZ, seed=4)
        assert len(tl) == len(jl)
        for epoch in (0, 1):
            tb, jb = list(tl.epoch_batches(epoch)), list(jl.epoch_batches(epoch))
            assert len(tb) == len(jb) > 0
            for g, w in zip(tb, jb):
                np.testing.assert_array_equal(g["images"], w["images"])
                np.testing.assert_array_equal(g["labels"], w["labels"])


def test_evaluate_classifier_matches_jax(tmp_path):
    """Frames of eleven shapes (up- and down-scaled to 32 px), labelled with
    the port's own ranking: first, third and seventh class in turn, so
    top-1 and top-5 both fall between 0 and 1. Batch 4: the last of three
    batches is padded."""
    jax_pred, port = _classifiers()
    shapes = [(24, 40), (40, 24), (32, 32), (50, 30), (20, 20), (36, 44), (28, 28), (64, 48), (16, 30), (45, 45),
              (33, 70)]
    rng = np.random.default_rng(len(shapes))
    frames = [rng.integers(0, 256, shape + (3,), dtype=np.uint8) for shape in shapes]
    crops = np.stack([tcls._resize_center_crop(f, IMGSZ) for f in frames])
    probs = port.predict_raw(torch.from_numpy(crops), 0.0, 0.0, IMGSZ)["probs"].numpy()
    ranks = np.argsort(-probs, axis=-1)
    labels = [int(ranks[i, (0, 2, 6)[i % 3]]) for i in range(len(frames))]
    root = _image_tree(tmp_path, shapes, labels)
    ds = tcls.ClassifyDataset(root, "val")
    got = tcls.evaluate_classifier(None, ds, imgsz=IMGSZ, batch=4, predictor=port)
    want = jcls.evaluate_classifier(None, jcls.ClassifyDataset(root, "val"), imgsz=IMGSZ, batch=4,
                                    predictor=jax_pred)
    assert got == want
    assert got["num_images"] == len(shapes) and 0 < got["top1"] < got["top5"] < 1


def _scene(rng, nc, n_gt):
    """One image: ground truth, jittered and duplicate detections, false positives, sorted by score."""
    xy = rng.uniform(0, 450, (n_gt, 2))
    gt = np.concatenate([xy, xy + rng.uniform(20, 190, (n_gt, 2))], 1).astype(np.float32)
    gt_cls = rng.integers(0, nc, n_gt)
    keep = rng.random(n_gt) > 0.25
    preds = np.concatenate([gt[keep] + rng.normal(0, 6, (int(keep.sum()), 4)), rng.uniform(0, 600, (3, 4))])
    preds[:, 2:] = np.maximum(preds[:, 2:], preds[:, :2] + 5)
    cls = np.concatenate([np.where(rng.random(int(keep.sum())) < 0.9, gt_cls[keep], rng.integers(0, nc)),
                          rng.integers(0, nc, 3)])
    scores = rng.uniform(0.05, 1, len(preds))
    order = np.argsort(-scores, kind="stable")
    return {"pred_boxes": preds[order].astype(np.float32), "pred_scores": scores[order].astype(np.float32),
            "pred_cls": cls[order].astype(np.int64), "gt_boxes": gt, "gt_cls": gt_cls.astype(np.int64)}


@pytest.mark.parametrize("seed", range(4))
def test_ap_oracle_copy_matches_jax_and_bounds_detmetrics(seed):
    rng = np.random.default_rng(seed)
    nc = int(rng.integers(2, 6))
    images = [_scene(rng, nc, int(rng.integers(1, 10))) for _ in range(int(rng.integers(2, 6)))]
    for protocol in ("coco", "ultralytics"):
        assert t_oracle.oracle_map(images, protocol=protocol) == j_oracle.oracle_map(images, protocol=protocol)
    dm = DetMetrics(nc=nc)
    for img in images:
        dm.update(img["pred_boxes"], img["pred_scores"], img["pred_cls"], img["gt_boxes"], img["gt_cls"])
    got, want = dm.compute(), t_oracle.oracle_map(images, protocol="ultralytics")
    for key in ("map", "map50", "map75"):
        assert abs(got[key] - want[key]) < 1e-12, key


def test_dataset_validator_copy_matches_jax(tmp_path, capsys):
    lbl, img = tmp_path / "labels" / "train", tmp_path / "images" / "train"
    lbl.mkdir(parents=True)
    img.mkdir(parents=True)
    texts = {"ok": "0 0.5 0.5 0.2 0.2\n1 0.1 0.1 0.05 0.05\n", "cls": "9 0.5 0.5 0.2 0.2\n",
             "coords": "0 1.5 0.5 0.2 0.2\n", "short": "0 0.5 0.5\n", "text": "a b c d e\n", "empty": ""}
    for name, text in texts.items():
        (lbl / f"{name}.txt").write_text(text)
        (img / f"{name}.png").write_bytes(b"")
    results = []
    for mod, cache in ((tdv, "port"), (jdv, "jax")):
        v = mod.DatasetValidator(tmp_path, num_classes=3, cache_dir=tmp_path / cache)
        first, second = v.validate_dataset(), mod.DatasetValidator(tmp_path, 3, cache_dir=tmp_path / cache).validate_dataset()
        results.append((first, second, v.delete_invalid_files(dry_run=True)))
    assert results[0] == results[1]
    first, second, removed = results[0]
    assert first["invalid_files"] == 4 and first["cached_hits"] == 0 and second["cached_hits"] == len(texts)
    assert len(removed) == 8
    assert json.loads((tmp_path / "port" / "validation_cache.json").read_text()) == \
        json.loads((tmp_path / "jax" / "validation_cache.json").read_text())
    codes = [mod.main([str(tmp_path), "--num-classes", "3", "--no-cache"]) for mod in (tdv, jdv)]
    out = capsys.readouterr().out
    assert codes == [1, 1] and out.count("INVALID") == 8
