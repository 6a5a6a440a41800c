"""The port's segment, pose and OBB losses, `probiou_pairs` and the
distillation losses against the JAX package's, fp32 on the CPU.

The same seeded numpy head maps and labels go through both packages. Each
loss component must agree within 1e-5 relative and its gradient with
respect to every head map within 1e-4 of that gradient's norm; probIoU and
the distillation losses within 1e-6. One segment case caps the mask anchors
below the foreground count, with tied weights at the cut, so the order of
the top-k decides which anchors enter the loss. Segment, pose and OBB
training through `YOLO11Model.train` is tested at the end of the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from yolo_infer_tpu.core import losses as JL
from yolo_infer_tpu.ops.rotated import probiou_pairs as jax_probiou_pairs
from yolo_infer_tpu_torch.core import losses as PL
from yolo_infer_tpu_torch.ops.rotated import probiou_matrix, probiou_pairs

B, M, NC, NM, K = 2, 6, 3, 8, 5
STRIDES = (8, 16, 32)


def _rboxes(rng, shape, imgsz):
    xy = rng.uniform(imgsz * 0.2, imgsz * 0.8, shape + (2,))
    wh = rng.uniform(imgsz * 0.15, imgsz * 0.5, shape + (2,))
    ang = rng.uniform(-np.pi / 2, np.pi / 2, shape + (1,))
    return np.concatenate([xy, wh, ang], -1).astype(np.float32)


def _xyxy(rng, shape, imgsz):
    xy = rng.uniform(0, imgsz * 0.6, shape + (2,))
    wh = rng.uniform(imgsz * 0.2, imgsz * 0.5, shape + (2,))
    return np.concatenate([xy, np.minimum(xy + wh, imgsz)], -1).astype(np.float32)


def _maps(rng, imgsz, c):
    return [rng.normal(size=(B, imgsz // s, imgsz // s, c)).astype(np.float32) for s in STRIDES]


def _mask(n0=5, n1=3):
    mask = np.zeros((B, M), bool)
    mask[0, :n0] = True
    mask[1, :n1] = True
    return mask


def _compare(jax_fn, port_fn, out_np, batch_np, rel=1e-5, grad_rel=1e-4):
    """Loss, metrics and the gradient of the total with respect to every
    head map: JAX's value_and_grad against torch's backward."""
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jout = jax.tree_util.tree_map(jnp.asarray, out_np)
    (jt, jm), jg = jax.jit(jax.value_and_grad(lambda o: jax_fn(o, jbatch), has_aux=True))(jout)
    tout = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).requires_grad_(), out_np)
    pt, pm = port_fn(tout, {k: torch.from_numpy(v) for k, v in batch_np.items()})
    pt.backward()
    assert int(pm["num_fg"]) == int(jm["num_fg"]) > 0
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=rel, atol=1e-7, err_msg=k)
    for g_jax, t in zip(jax.tree_util.tree_leaves(jg), jax.tree_util.tree_leaves(tout)):
        g_jax = np.asarray(g_jax)
        assert np.isfinite(t.grad.numpy()).all()
        assert np.linalg.norm(t.grad.numpy() - g_jax) <= grad_rel * max(np.linalg.norm(g_jax), 1e-12)
    return pm


def test_probiou_pairs_matches_jax_and_the_matrix_form():
    rng = np.random.default_rng(0)
    a, b = _rboxes(rng, (40,), 100), _rboxes(rng, (40,), 100)
    b[::4] = a[::4]  # identical pairs
    b[1::9, 2:4] = 0.0  # zero-size boxes (padding rows)
    want = np.asarray(jax_probiou_pairs(jnp.asarray(a), jnp.asarray(b)))
    got = probiou_pairs(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the broadcast form and the pairwise matrix agree to the bit
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(probiou_pairs(ta[:, None, :], tb[None, :, :]), probiou_matrix(ta, tb))


@pytest.mark.parametrize("imgsz", [64, 160])
def test_obb_loss_and_its_gradient_match_jax(imgsz):
    rng = np.random.default_rng(imgsz)
    out = {"feats": _maps(rng, imgsz, 64 + NC), "angle": _maps(rng, imgsz, 1)}
    boxes = _rboxes(rng, (B, M), imgsz)
    boxes[1, 3:] = 0.0  # padding rows: zero-size boxes reach probIoU's clamps
    batch = {"boxes": boxes, "classes": rng.integers(0, NC, (B, M)).astype(np.int32), "mask": _mask()}
    _compare(lambda o, bt: JL.obb_loss(o, bt, nc=NC), lambda o, bt: PL.obb_loss(o, bt, nc=NC), out, batch)


def _seg_batch(rng, imgsz, boxes):
    masks = np.zeros((B, imgsz // 4, imgsz // 4), np.int32)
    for bi in range(B):
        for j in range(M):
            x0, y0, x1, y1 = (boxes[bi, j] / 4).astype(int)
            masks[bi, y0:y1, x0:x1] = j + 1
    return {"boxes": boxes, "classes": rng.integers(0, NC, (B, M)).astype(np.int32), "mask": _mask(),
            "masks": masks}


def _tied_anchors(feats, boxes):
    """Nine stride-8 anchors of image 0 around grid cell (3, 3) that predict
    gt 0's box exactly (one-hot DFL bins) with equal class logits: their
    assignment weights are equal to the bit."""
    boxes[0, 0] = [12.0, 12.0, 44.0, 44.0]  # 2 cells each side of the anchor at (28, 28)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            row = np.full((4, 16), -50.0, np.float32)
            for side, v in enumerate((2 + dx, 2 + dy, 2 - dx, 2 - dy)):  # l, t, r, b in cells
                row[side, v] = 50.0
            feats[0][0, 3 + dy, 3 + dx, :64] = row.reshape(-1)
            feats[0][0, 3 + dy, 3 + dx, 64:] = 10.0


@pytest.mark.parametrize("imgsz,cap", [(64, 160), (160, 160), (64, 6)])
def test_segmentation_loss_and_its_gradient_match_jax(imgsz, cap):
    rng = np.random.default_rng(100 + imgsz + cap)
    out = {"feats": _maps(rng, imgsz, 64 + NC), "mc": _maps(rng, imgsz, NM),
           "proto": rng.normal(size=(B, imgsz // 4, imgsz // 4, NM)).astype(np.float32)}
    boxes = _xyxy(rng, (B, M), imgsz)
    if cap < 160:  # the cap binds, with equal weights at the cut
        _tied_anchors(out["feats"], boxes)
    batch = _seg_batch(rng, imgsz, boxes)
    kw = dict(nc=NC, mask_fg_cap=cap)
    pm = _compare(lambda o, bt: JL.segmentation_loss(o, bt, **kw), lambda o, bt: PL.segmentation_loss(o, bt, **kw),
                  out, batch)
    if cap < 160:
        _, _, aux = PL.detection_loss([torch.from_numpy(f) for f in out["feats"]],
                                      {k: torch.from_numpy(v) for k, v in batch.items()}, nc=NC, return_aux=True)
        assert (aux["weight"] > 0).sum(1).min() > cap  # the cap binds in both images
        w = aux["weight"][0].sort(descending=True).values
        assert w[cap - 1] > 0 and w[cap - 1] == w[cap]  # a tie among positive weights at the cut
        # the port's top-k orders ties by index, as lax.top_k does on the CPU
        from yolo_infer_tpu_torch.ops.nms import _topk_stable
        want = jax.lax.top_k(jnp.asarray(aux["weight"].numpy()), cap)[1]
        np.testing.assert_array_equal(_topk_stable(aux["weight"], cap)[1].numpy(), np.asarray(want))


@pytest.mark.parametrize("imgsz", [64, 160])
def test_pose_loss_and_its_gradient_match_jax(imgsz):
    rng = np.random.default_rng(200 + imgsz)
    out = {"feats": _maps(rng, imgsz, 64 + NC), "kpts": _maps(rng, imgsz, K * 3)}
    boxes = _xyxy(rng, (B, M), imgsz)
    kx = rng.uniform(boxes[..., None, 0], boxes[..., None, 2], (B, M, K))
    ky = rng.uniform(boxes[..., None, 1], boxes[..., None, 3], (B, M, K))
    vis = rng.integers(0, 3, (B, M, K)).astype(np.float32)
    batch = {"boxes": boxes, "classes": rng.integers(0, NC, (B, M)).astype(np.int32), "mask": _mask(),
             "kpts": np.stack([kx, ky, vis], -1).astype(np.float32)}
    _compare(lambda o, bt: JL.pose_loss(o, bt, nc=NC), lambda o, bt: PL.pose_loss(o, bt, nc=NC), out, batch)


def test_kpt_sigmas_are_the_jax_constants():
    np.testing.assert_array_equal(np.asarray(PL.KPT_SIGMAS, np.float32), np.asarray(JL.KPT_SIGMAS))


def test_distillation_losses_match_jax():
    rng = np.random.default_rng(7)
    s, t = (rng.normal(size=(4, 10)).astype(np.float32) * 3 for _ in range(2))
    want = float(JL.distill_classify_loss(jnp.asarray(s), jnp.asarray(t), 4.0))
    got = float(PL.distill_classify_loss(torch.from_numpy(s), torch.from_numpy(t), 4.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    kl_j = np.asarray(JL._binary_kl_from_logits(jnp.asarray(t), jnp.asarray(s)))
    kl_p = PL._binary_kl_from_logits(torch.from_numpy(t), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(kl_p, kl_j, rtol=0, atol=1e-6)

    sf, tf = _maps(rng, 64, 64 + NC), _maps(rng, 64, 64 + NC)
    jt, jm = JL.distill_detect_loss([jnp.asarray(f) for f in sf], [jnp.asarray(f) for f in tf], nc=NC)
    pt, pm = PL.distill_detect_loss([torch.from_numpy(f) for f in sf], [torch.from_numpy(f) for f in tf], nc=NC)
    np.testing.assert_allclose(float(pt), float(jt), rtol=1e-6)
    for k in ("kd_cls", "kd_box"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-6, err_msg=k)


def _write_task_dataset(root, task, n=2):
    """Two 64x80 PNGs per split with one exact label each: a filled
    rectangle as a polygon (segment), a box with 17 keypoints on it (pose),
    or its four corners (OBB)."""
    from yolo_infer_tpu_torch.data.loader import create_dataset_config, save_image

    for split in ("train", "val"):
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            img = np.full((64, 80, 3), 100, np.uint8)
            x0, y0, x1, y1 = 10 + 4 * i, 8, 50 + 4 * i, 40
            img[y0:y1, x0:x1] = (220, 40, 40)
            save_image(root / "images" / split / f"{i}.png", img)
            xs, ys = np.array([x0, x1, x1, x0]) / 80, np.array([y0, y0, y1, y1]) / 64
            corners = " ".join(f"{x:.6f} {y:.6f}" for x, y in zip(xs, ys))
            if task == "pose":
                kp = " ".join(f"{(x0 + j * 2) / 80:.6f} {(y0 + 10) / 64:.6f} 2" for j in range(17))
                row = f"0 {(x0 + x1) / 160:.6f} {(y0 + y1) / 128:.6f} {(x1 - x0) / 80:.6f} {(y1 - y0) / 64:.6f} {kp}"
            else:
                row = f"0 {corners}"
            (root / "labels" / split / f"{i}.txt").write_text(row + "\n")
    return create_dataset_config(root / "data.yaml", str(root / "images" / "train"), str(root / "images" / "val"),
                                 ["box"])


@pytest.mark.parametrize("task", ["segment", "pose", "obb"])
def test_task_training_through_yolo11model_validates_each_epoch(task, tmp_path):
    """Segment, pose and OBB training through `YOLO11Model.train`: the
    task's loss, no skipped step, and the task's validation after the epoch."""
    from yolo_infer_tpu_torch.core.model import YOLO11Model

    data = _write_task_dataset(tmp_path / "ds", task)
    model = YOLO11Model(f"yolo11n-{ {'segment': 'seg'}.get(task, task)}", device="cpu", nc=1,
                        compute_dtype=torch.float32)
    out = model.train(str(data), epochs=1, batch=2, imgsz=64, project=str(tmp_path / "runs"), mosaic=0.0)
    assert out["status"] == "completed" and out["skipped_steps"] == 0
    row = out["history"][0]
    key = {"segment": "loss_mask", "pose": "loss_kpt", "obb": "loss_dfl"}[task]
    assert np.isfinite(row[key]) and "val_mAP50-95" in row
    assert model.task == task and np.isfinite(model.predict(np.full((64, 80, 3), 100, np.uint8), imgsz=64,
                                                            conf=0.0)[0].scores).all()
