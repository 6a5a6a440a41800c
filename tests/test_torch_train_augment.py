"""Training augmentation and the train loader (`yolo_infer_tpu_torch/data/
cv_ops.py`, `augment.py`, `train_loader.py`) against OpenCV and the JAX
package, on the CPU.

The numpy copies of OpenCV's calls are bit-equal to `cv2` (5.0): RGB -> HSV
over the whole uint8 cube, HSV -> RGB over every hue below 180 (all the hue
table can give), getRotationMatrix2D, and warpAffine (bilinear, border
114) under seeded rotations, shears, scales and translations that put
taps outside the source image, at output widths on and off the 16-column
vector blocks. `augment_full` of every task from one `random.Random` state
gives the JAX package's images bit for bit and its labels within 1e-5; an
epoch of `TrainLoader` batches equals the JAX loader's, whatever the number
of worker threads.
"""

import random
from fractions import Fraction

import cv2
import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from yolo_infer_tpu.data import augment as JA
from yolo_infer_tpu.data.dataset import YOLODataset as JaxDataset
from yolo_infer_tpu.data.train_loader import TrainLoader as JaxLoader
from yolo_infer_tpu_torch.data import augment as PA
from yolo_infer_tpu_torch.data import cv_ops
from yolo_infer_tpu_torch.data.classify import ClassifyDataset, ClassifyLoader
from yolo_infer_tpu_torch.data.dataset import YOLODataset
from yolo_infer_tpu_torch.data.train_loader import TrainLoader, _Replay

F32 = np.float32


def test_fma_f32_rounds_once():
    """Against exact rational arithmetic, on random triples and on ones made
    to land on an f32 midpoint in float64 (where rounding twice goes wrong)."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=3000).astype(F32) for _ in range(3))
    # a * b = 2^-24 + 2^-60, so a * b + 1 rounds in float64 onto the f32
    # midpoint 1 + 2^-24, which rounds to even (1.0); the exact sum is above it
    a[:2], b[:2], c[:2] = F32(1 + 2 ** -12), F32(2 ** -24 * (1 - 2 ** -12 + 2 ** -24)), F32(1.0)
    c[1], a[1] = F32(-1.0), -a[1]  # and its mirror below -1
    assert float(a[0]) * float(b[0]) + float(c[0]) == 1 + 2 ** -24
    got = cv_ops.fma_f32(a, b, c)
    assert got[0] == F32(1 + 2 ** -23) and got[1] == F32(-1 - 2 ** -23)
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, F32(-np.inf)), near, np.nextafter(near, F32(np.inf))]
        want = min(cands, key=lambda x: (abs(Fraction(float(x)) - exact), int(np.float32(x).view(np.uint32)) & 1))
        assert got[i] == want, i


def test_rgb2hsv_matches_opencv_over_the_whole_cube():
    for r in range(0, 256, 16):  # 16 red values a block: 1M colours
        rr, g, b = np.meshgrid(np.arange(r, r + 16), np.arange(256), np.arange(256), indexing="ij")
        img = np.stack([rr, g, b], -1).reshape(1024, 1024, 3).astype(np.uint8)
        np.testing.assert_array_equal(cv_ops.rgb2hsv_u8(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))


def test_hsv2rgb_matches_opencv_for_every_hue_below_180():
    for h0 in range(0, 180, 20):
        h, s, v = np.meshgrid(np.arange(h0, h0 + 20), np.arange(256), np.arange(256), indexing="ij")
        img = np.stack([h, s, v], -1).reshape(1280, 1024, 3).astype(np.uint8)
        np.testing.assert_array_equal(cv_ops.hsv2rgb_u8(img), cv2.cvtColor(img, cv2.COLOR_HSV2RGB))


def test_rotation_matrix_matches_opencv():
    for angle, scale, center in ((0.0, 1.0, (0, 0)), (17.3, 0.61, (0, 0)), (-44.9, 1.49, (12.5, -3.0))):
        np.testing.assert_array_equal(cv_ops.rotation_matrix_2d(center, angle, scale),
                                      cv2.getRotationMatrix2D(center=center, angle=angle, scale=scale))


def affine(rng, h, w, out, degrees, shear, translate, scale):
    """The JAX package's matrix composition (`_affine_matrix`), seeded."""
    c = np.eye(3)
    c[0, 2], c[1, 2] = -w / 2, -h / 2
    r = np.eye(3)
    r[:2] = cv2.getRotationMatrix2D(angle=rng.uniform(-degrees, degrees), center=(0, 0),
                                    scale=rng.uniform(1 - scale, 1 + scale))
    s = np.eye(3)
    s[0, 1], s[1, 0] = (np.tan(np.deg2rad(rng.uniform(-shear, shear))) for _ in range(2))
    t = np.eye(3)
    t[0, 2], t[1, 2] = (rng.uniform(0.5 - translate, 0.5 + translate) * out for _ in range(2))
    return t @ s @ r @ c


@pytest.mark.parametrize("h,w,out,degrees,shear,translate,scale", [
    (64, 64, 32, 0.0, 0.0, 0.1, 0.5),  # scale and translate only (the default augmentation)
    (97, 130, 61, 30.0, 0.0, 0.3, 0.5),  # rotation; a width off the 16-column blocks
    (120, 90, 80, 10.0, 10.0, 0.5, 0.7),  # shear; taps well outside the image
    (256, 256, 128, 45.0, 5.0, 0.1, 0.5),  # the mosaic's 2x canvas to its output
    (33, 47, 100, 180.0, 20.0, 0.9, 0.9),  # an upscale, most taps outside
])
def test_warp_affine_matches_opencv(h, w, out, degrees, shear, translate, scale):
    rng = np.random.default_rng(h * w + out)
    for _ in range(3):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        m = affine(rng, h, w, out, degrees, shear, translate, scale)[:2]
        want = cv2.warpAffine(img, m, dsize=(out, out), borderValue=(114, 114, 114))
        np.testing.assert_array_equal(cv_ops.warp_affine_linear_u8(img, m, (out, out)), want)


def task_record(task, rng, h, w):
    """A seeded record of `task` with 3 instances (the dataset's layout)."""
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    n = 3
    xy = rng.uniform(0, 0.6, (n, 2)) * [w, h]
    wh = rng.uniform(0.1, 0.4, (n, 2)) * [w, h]
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    rec = {"image": img, "boxes": boxes, "classes": rng.integers(0, 4, n).astype(np.int32), "orig_shape": (h, w),
           "path": None}
    if task == "segment":
        rec["polygons"] = [(np.array([[b[0], b[1]], [b[2], b[1] + 3], [b[2], b[3]], [b[0] + 2, b[3]]], np.float32)
                            / np.array([w, h], np.float32)) for b in boxes]
    elif task == "pose":
        kp = rng.uniform(0, 1, (n, 17, 3)).astype(np.float32) * [w, h, 1]
        kp[..., 2] = (kp[..., 2] > 0.3) * 2.0
        rec["keypoints"] = kp.astype(np.float32)
    elif task == "obb":
        rec["rboxes"] = np.concatenate([(boxes[:, :2] + boxes[:, 2:]) / 2, boxes[:, 2:] - boxes[:, :2],
                                        rng.uniform(-0.7, 2.3, (n, 1))], 1).astype(np.float32)
    return rec


def assert_same_labels(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k == "polygons":
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("task", ["detect", "segment", "pose", "obb"])
@pytest.mark.parametrize("use_mosaic", [True, False])
def test_augment_full_matches_jax(task, use_mosaic):
    rng = np.random.default_rng({"detect": 1, "segment": 2, "pose": 3, "obb": 4}[task])
    hyp = {**JA.DEFAULT_AUG, "degrees": 12.0, "shear": 3.0, "flipud": 0.5, "fliplr": 0.5}
    for trial in range(3):
        records = [task_record(task, rng, int(rng.integers(40, 120)), int(rng.integers(40, 120))) for _ in range(4)]
        ja, pa = random.Random(trial), random.Random(trial)
        jimg, jlab = JA.augment_full([dict(r) for r in records], ja, imgsz=96, hyp=hyp, use_mosaic=use_mosaic,
                                     task=task)
        pimg, plab = PA.augment_full([dict(r) for r in records], pa, imgsz=96, hyp=hyp, use_mosaic=use_mosaic,
                                     task=task)
        np.testing.assert_array_equal(pimg, jimg)
        assert_same_labels(plab, jlab)
        assert ja.random() == pa.random()  # the same draws were taken


@pytest.mark.parametrize("use_mosaic", [True, False])
def test_detect_only_augment_sample_matches_jax(use_mosaic):
    """The detect-only `augment_sample` (mosaic4 + random_affine, or letterbox)."""
    rng = np.random.default_rng(5)
    hyp = {**JA.DEFAULT_AUG, "degrees": 12.0, "shear": 3.0, "flipud": 0.5}
    records = [task_record("detect", rng, int(rng.integers(40, 120)), int(rng.integers(40, 120))) for _ in range(4)]
    want = JA.augment_sample([dict(r) for r in records], random.Random(9), imgsz=96, hyp=hyp, use_mosaic=use_mosaic)
    got = PA.augment_sample([dict(r) for r in records], random.Random(9), imgsz=96, hyp=hyp, use_mosaic=use_mosaic)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2], want[2])


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Detect and segment datasets of seeded PNG frames of two sizes."""
    root = tmp_path_factory.mktemp("train_aug")
    rng = np.random.default_rng(7)
    for split in ("train", "val"):
        for task in ("detect", "segment"):
            (root / task / "images" / split).mkdir(parents=True)
            (root / task / "labels" / split).mkdir(parents=True)
        for i in range(10):
            h, w = (48, 64) if i % 2 else (80, 60)
            img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            det, seg = [], []
            for _ in range(int(rng.integers(0, 4))):
                cx, cy, bw, bh = rng.uniform(0.25, 0.75), rng.uniform(0.25, 0.75), rng.uniform(0.1, 0.4), \
                    rng.uniform(0.1, 0.4)
                c = int(rng.integers(0, 3))
                det.append(f"{c} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
                pts = [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2, cx, cy + bh / 2]
                seg.append(f"{c} " + " ".join(f"{v:.6f}" for v in pts))
            for task, rows in (("detect", det), ("segment", seg)):
                cv2.imwrite(str(root / task / "images" / split / f"{i}.png"), img[..., ::-1])
                (root / task / "labels" / split / f"{i}.txt").write_text("\n".join(rows) + "\n")
    for task in ("detect", "segment"):
        (root / task / "data.yaml").write_text(
            f"path: {root / task}\ntrain: images/train\nval: images/val\nnc: 3\nnames: [a, b, c]\n")
    return root


@pytest.mark.parametrize("task,hyp", [
    ("detect", {}),
    ("detect", {"mixup": 0.5, "degrees": 10.0, "shear": 5.0, "flipud": 0.5}),
    ("segment", {"degrees": 5.0}),
])
def test_train_loader_epoch_equals_jax(datasets, task, hyp):
    data = datasets / task / "data.yaml"
    jl = JaxLoader(JaxDataset(data, split="train", task=task), batch_size=4, imgsz=64, max_boxes=8, seed=3, hyp=hyp)
    want = list(jl.epoch_batches(1))
    for workers in (1, 3):
        pl = TrainLoader(YOLODataset(data, split="train", task=task), batch_size=4, imgsz=64, max_boxes=8, seed=3,
                         hyp=hyp, workers=workers)
        got = list(pl.epoch_batches(1))
        assert len(got) == len(want) == len(pl) == len(jl) == 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                if k in ("boxes", "kpts"):
                    np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5, err_msg=k)
                else:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_train_loader_raises_a_failed_batch_in_the_consumer(datasets, monkeypatch):
    """A failure while building a batch ends the epoch with that exception
    (the JAX loader logs it and ends the epoch early)."""
    loader = TrainLoader(YOLODataset(datasets / "detect" / "data.yaml", split="train"), batch_size=2, imgsz=64,
                         workers=2)

    def broken(*a, **kw):
        raise RuntimeError("augmentation failed")

    monkeypatch.setattr("yolo_infer_tpu_torch.data.train_loader.augment_full", broken)
    with pytest.raises(RuntimeError, match="augmentation failed"):
        list(loader.epoch_batches(0))


def test_classify_loader_raises_a_failed_batch_in_the_consumer(tmp_path):
    for c in ("a", "b"):
        (tmp_path / "train" / c).mkdir(parents=True)
        cv2.imwrite(str(tmp_path / "train" / c / "0.png"), np.zeros((8, 8, 3), np.uint8))
    (tmp_path / "train" / "a" / "1.png").write_bytes(b"not a png")
    loader = ClassifyLoader(ClassifyDataset(tmp_path, "train"), batch_size=3, imgsz=8)
    with pytest.raises(Exception):
        list(loader.epoch_batches(0))


def test_replay_holds_a_sample_to_its_recorded_draws():
    rep = _Replay([0.25, 7])
    assert rep.uniform(2.0, 6.0) == 3.0 and rep.randrange(10) == 7
    rep.check_done()
    with pytest.raises(RuntimeError):
        rep.random()
    with pytest.raises(RuntimeError):
        _Replay([0.5]).check_done()
