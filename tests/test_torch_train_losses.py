"""The port's training losses (`yolo_infer_tpu_torch/core/losses.py`,
`ops/iou.py bbox_iou_aligned`) against the JAX package's, fp32 on the CPU.

The same seeded numpy inputs go through both. The assigner's masks and
indices must be equal; target boxes and scores within 1e-6; each loss
component within 1e-5 relative and its gradient with respect to the head
maps within 1e-5 of the largest gradient. Gradient parity is tested on
seeded continuous inputs, which hold no exact ties: at a tie
`jnp.maximum`, `jnp.minimum` and `clip` send half the gradient to each
side, torch all of it to one side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from yolo_infer_tpu.core import losses as JL
from yolo_infer_tpu.ops.decode import make_anchors as jax_make_anchors
from yolo_infer_tpu.ops.iou import bbox_iou_aligned as jax_iou
from yolo_infer_tpu_torch.core import losses as PL
from yolo_infer_tpu_torch.ops.decode import make_anchors
from yolo_infer_tpu_torch.ops.iou import bbox_iou_aligned, xywh2xyxy, xyxy2xywh

B, M, NC = 2, 8, 5


def random_boxes(rng, shape, imgsz, min_wh=4.0):
    xy = rng.uniform(0, imgsz * 0.7, shape + (2,))
    wh = rng.uniform(min_wh, imgsz * 0.5, shape + (2,))
    return np.concatenate([xy, np.minimum(xy + wh, imgsz)], -1).astype(np.float32)


def gt_batch(rng, imgsz, empty_image=True):
    """Padded ground truth: image 0 has 6 of its 8 rows, image 1 none (when
    `empty_image`), else 5."""
    mask = np.zeros((B, M), bool)
    mask[0, :6] = True
    if not empty_image:
        mask[1, :5] = True
    return {"boxes": random_boxes(rng, (B, M), imgsz), "classes": rng.integers(0, NC, (B, M)).astype(np.int32),
            "mask": mask}


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_bbox_iou_aligned_matches_jax(kind):
    rng = np.random.default_rng(1)
    a, b = random_boxes(rng, (64, 7), 100), random_boxes(rng, (64, 7), 100)
    b[::5] = a[::5]  # identical pairs
    b[1::7, :, 2:] = b[1::7, :, :2] + 1e-3  # near-degenerate boxes
    want = np.asarray(jax_iou(jnp.asarray(a), jnp.asarray(b), kind=kind))
    got = bbox_iou_aligned(torch.from_numpy(a), torch.from_numpy(b), kind=kind).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_ciou_alpha_is_detached():
    """CIoU's alpha carries no gradient, as the JAX package stops it."""
    rng = np.random.default_rng(2)
    a, b = random_boxes(rng, (16,), 64), random_boxes(rng, (16,), 64)

    def jax_grad(x):
        return jax.grad(lambda t: jnp.sum(jax_iou(t, jnp.asarray(b), kind="ciou")))(jnp.asarray(x))

    ta = torch.from_numpy(a).requires_grad_()
    bbox_iou_aligned(ta, torch.from_numpy(b), kind="ciou").sum().backward()
    want = np.asarray(jax_grad(a))
    np.testing.assert_allclose(ta.grad.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_box_format_round_trip():
    x = np.random.default_rng(3).uniform(1, 50, (10, 4)).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(xyxy2xywh(xywh2xyxy(t)).numpy(), x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("imgsz", [64, 160])
def test_assigner_matches_jax(imgsz):
    rng = np.random.default_rng(imgsz)
    shapes = [(imgsz // s, imgsz // s) for s in (8, 16, 32)]
    a = sum(h * w for h, w in shapes)
    scores = (1 / (1 + np.exp(-rng.normal(size=(B, a, NC))))).astype(np.float32)
    gt = gt_batch(rng, imgsz)
    anc, strd = jax_make_anchors(shapes, (8, 16, 32))
    anc_px = np.asarray(anc * strd, np.float32)
    half = rng.uniform(2, imgsz * 0.25, (B, a, 2))  # predictions around their anchors, as a head gives them
    pd = np.concatenate([anc_px - half, anc_px + half], -1).astype(np.float32)
    want = JL.task_aligned_assigner(jnp.asarray(scores), jnp.asarray(pd), jnp.asarray(anc_px),
                                    jnp.asarray(gt["classes"]), jnp.asarray(gt["boxes"]), jnp.asarray(gt["mask"]))
    p_anc, p_strd = make_anchors(shapes, (8, 16, 32))
    np.testing.assert_array_equal((p_anc * p_strd).numpy(), anc_px)
    got = PL.task_aligned_assigner(torch.from_numpy(scores), torch.from_numpy(pd), p_anc * p_strd,
                                   torch.from_numpy(gt["classes"]), torch.from_numpy(gt["boxes"]),
                                   torch.from_numpy(gt["mask"]))
    tb, ts, fg, idx = (np.asarray(w) for w in want)
    assert fg.sum() > 10 and not fg[1].any()  # positives in image 0, none in the empty image
    np.testing.assert_array_equal(got[2].numpy(), fg)
    np.testing.assert_array_equal(got[3].numpy(), idx)
    np.testing.assert_allclose(got[0].numpy(), tb, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), ts, rtol=0, atol=1e-6)


@pytest.mark.parametrize("imgsz,empty_image", [(64, True), (160, False)])
def test_detection_loss_and_its_gradient_match_jax(imgsz, empty_image):
    rng = np.random.default_rng(10 + imgsz)
    feats = [rng.normal(size=(B, imgsz // s, imgsz // s, 64 + NC)).astype(np.float32) for s in (8, 16, 32)]
    gt = gt_batch(rng, imgsz, empty_image)

    def jax_loss(fs):
        total, metrics, aux = JL.detection_loss(fs, {k: jnp.asarray(v) for k, v in gt.items()}, nc=NC,
                                                return_aux=True)
        return total, (metrics, aux)

    (jt, (jm, ja)), jg = jax.value_and_grad(jax_loss, has_aux=True)([jnp.asarray(f) for f in feats])
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    pt, pm, pa = PL.detection_loss(tf, {k: torch.from_numpy(v) for k, v in gt.items()}, nc=NC, return_aux=True)
    pt.backward()
    assert int(pm["num_fg"]) == int(jm["num_fg"]) > 0
    np.testing.assert_array_equal(pa["fg_mask"].numpy(), np.asarray(ja["fg_mask"]))
    for k in ("loss", "loss_box", "loss_cls", "loss_dfl"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    for g_jax, t in zip(jg, tf):
        g_jax = np.asarray(g_jax)
        np.testing.assert_allclose(t.grad.numpy(), g_jax, rtol=0, atol=1e-5 * np.abs(g_jax).max())


def test_classification_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, 6).astype(np.int32)
    labels[0] = int(np.argmax(logits[0]))  # one right answer at least
    (jl, jm), jg = jax.value_and_grad(lambda x: JL.classification_loss(x, jnp.asarray(labels)), has_aux=True)(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    pl, pm = PL.classification_loss(t, torch.from_numpy(labels))
    pl.backward()
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    assert float(pm["accuracy"]) == float(jm["accuracy"]) > 0
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-7)


@pytest.mark.parametrize("name,item", [("obb_loss", "8.2"), ("segmentation_loss", "8.2"), ("pose_loss", "8.2"),
                                       ("distill_classify_loss", "7"), ("distill_detect_loss", "7")])
def test_unported_losses_raise_with_a_roadmap_pointer(name, item):
    """These losses raised, citing ROADMAP Queue 1 item 8.2 or 7, until they
    were ported; now each gives a finite loss with a finite gradient on a
    tiny input (`test_torch_train_tasks.py` holds them to the JAX package's)."""
    rng = np.random.default_rng(0)
    maps = [torch.from_numpy(rng.normal(size=(B, 32 // s, 32 // s, 64 + NC)).astype(np.float32)).requires_grad_()
            for s in (8, 16, 32)]
    gt = {k: torch.from_numpy(v) for k, v in gt_batch(rng, 32, empty_image=False).items()}
    if name == "distill_classify_loss":
        s_logits = torch.from_numpy(rng.normal(size=(4, 7)).astype(np.float32)).requires_grad_()
        loss, leaves = PL.distill_classify_loss(s_logits, torch.zeros(4, 7)), [s_logits]
    elif name == "distill_detect_loss":
        loss, leaves = PL.distill_detect_loss(maps, [m.detach() * 0.5 for m in maps], nc=NC)[0], maps
    else:
        extra = {"obb_loss": ("angle", 1), "segmentation_loss": ("mc", 4), "pose_loss": ("kpts", 6)}[name]
        out = {"feats": maps, extra[0]: [torch.zeros(B, 32 // s, 32 // s, extra[1]) for s in (8, 16, 32)]}
        if name == "obb_loss":
            xyxy = gt["boxes"]
            gt["boxes"] = torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2, xyxy[..., 2:] - xyxy[..., :2],
                                     torch.zeros(B, M, 1)], -1)
        elif name == "segmentation_loss":
            out["proto"] = torch.zeros(B, 8, 8, 4)
            gt["masks"] = torch.ones(B, 8, 8, dtype=torch.int32)
        else:
            gt["kpts"] = torch.full((B, M, 2, 3), 10.0)
        loss, leaves = getattr(PL, name)(out, gt, nc=NC)[0], maps
    loss.backward()
    assert item in ("7", "8.2") and torch.isfinite(loss) and all(torch.isfinite(t.grad).all() for t in leaves)
