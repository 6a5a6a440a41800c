"""The PyTorch port's serving ops vs the JAX package, on the CPU.

Same numpy-seeded inputs through the JAX function and its port counterpart:
keep masks exactly (vs the Pallas kernel in interpret mode and the host
oracle), preprocess / decode / IoU in f32. Also the port's import hygiene.
The CUDA kernels' own tests are in test_torch_cuda.py.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_infer_tpu.ops import decode as jdec
from yolo_infer_tpu.ops.letterbox import letterbox_params as j_letterbox_params, scale_boxes as j_scale_boxes
from yolo_infer_tpu.ops import nms as jnms
from yolo_infer_tpu.ops.iou import box_iou_matrix as j_iou
from yolo_infer_tpu.ops.pallas.nms_fused import nms_keep_pallas
from yolo_infer_tpu.ops.preprocess import preprocess_batch as j_preprocess
from yolo_infer_tpu_torch.ops import decode as tdec
from yolo_infer_tpu_torch.ops import letterbox as tlb
from yolo_infer_tpu_torch.ops import nms as tnms
from yolo_infer_tpu_torch.ops.iou import box_iou_matrix as t_iou
from yolo_infer_tpu_torch.ops.kernels import nms_fused
from yolo_infer_tpu_torch.ops.preprocess import preprocess_batch as t_preprocess

REPO = Path(__file__).resolve().parent.parent


def _random_sorted_candidates(rng, b, k):
    cxy = rng.uniform(50, 590, (b, k, 2))
    wh = rng.uniform(10, 120, (b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0, 1, (b, k)).astype(np.float32), axis=1)
    return boxes, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keep_mask_matches_pallas_kernel_and_oracle(seed):
    rng = np.random.default_rng(seed)
    b, k = 3, 160
    boxes, scores = _random_sorted_candidates(rng, b, k)
    valid = scores > 0.15
    got = tnms.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5).numpy()
    want = np.asarray(nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(valid), 0.5, interpret=True))
    np.testing.assert_array_equal(got, want)
    for i in range(b):
        vb, vs = boxes[i][valid[i]], scores[i][valid[i]]
        want_v = np.zeros(valid[i].sum(), bool)
        want_v[tnms.nms_numpy_reference(vb, vs, 0.5)] = True
        np.testing.assert_array_equal(got[i][valid[i]], want_v)
        assert not got[i][~valid[i]].any()


def test_keep_mask_suppression_chain():
    """A suppresses B, so C (overlapped only by B) must survive."""
    boxes = np.array([[[0, 0, 100, 100], [40, 0, 140, 100], [80, 0, 180, 100], [500, 500, 510, 510]]], np.float32)
    valid = np.array([[True, True, True, False]])
    got = tnms.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid), 0.3).tolist()
    want = np.asarray(nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(valid), 0.3, interpret=True)).tolist()
    assert got == want == [[True, False, True, False]]


def test_box_iou_matrix_matches_jax():
    rng = np.random.default_rng(3)
    a, _ = _random_sorted_candidates(rng, 1, 50)
    b, _ = _random_sorted_candidates(rng, 1, 70)
    got = t_iou(torch.from_numpy(a[0]), torch.from_numpy(b[0])).numpy()
    want = np.asarray(j_iou(jnp.asarray(a[0]), jnp.asarray(b[0])))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw", [(480, 640), (300, 400), (720, 1280), (640, 640)])
def test_preprocess_batch_matches_jax(hw):
    """Pad only, upscale, downscale, and the no-resize fast path."""
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    got = t_preprocess(torch.from_numpy(frames), (640, 640)).numpy()
    want = np.asarray(j_preprocess(jnp.asarray(frames), out_hw=(640, 640)))
    assert got.shape == want.shape == (2, 640, 640, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_letterbox_geometry_matches_jax():
    for shape in [(480, 640), (1080, 1920), (640, 480), (123, 457)]:
        assert tlb.letterbox_params(shape, 640) == j_letterbox_params(shape, 640)
        r, pad, _ = j_letterbox_params(shape, 640)
        boxes = np.random.default_rng(5).uniform(-20, 660, (7, 4)).astype(np.float32)
        np.testing.assert_array_equal(tlb.scale_boxes(boxes, r, pad, shape), j_scale_boxes(boxes, r, pad, shape))


def _feats(rng, b=2, nc=5, sizes=((12, 12), (6, 6), (3, 3))):
    return [rng.normal(0, 2, (b, h, w, 64 + nc)).astype(np.float32) for h, w in sizes]


def test_decode_scores_raw_matches_jax():
    feats = _feats(np.random.default_rng(6))
    got = tdec.decode_scores_raw([torch.from_numpy(f) for f in feats], 5)
    want = jdec.decode_scores_raw([jnp.asarray(f) for f in feats], 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_anchor_rows_from_idx_matches_jax_and_anchor_table():
    shapes, strides = ((12, 12), (6, 6), (3, 3)), (8, 16, 32)
    idx = np.random.default_rng(7).integers(0, 189, (2, 40)).astype(np.int32)
    ap, st = tdec.anchor_rows_from_idx(torch.from_numpy(idx).long(), shapes, strides)
    jap, jst = jdec.anchor_rows_from_idx(jnp.asarray(idx), shapes, strides)
    np.testing.assert_allclose(ap.numpy(), np.asarray(jap), atol=1e-6, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-6, rtol=0)
    table, tstr = tdec.make_anchors(shapes, strides)
    np.testing.assert_array_equal(ap.numpy(), table.numpy()[idx])
    np.testing.assert_array_equal(st.numpy(), tstr.numpy()[idx])


def test_dfl_decode_matches_jax():
    x = np.random.default_rng(8).normal(0, 2, (2, 30, 64)).astype(np.float32)
    ap = np.random.default_rng(9).uniform(0, 20, (2, 30, 2)).astype(np.float32)
    got = tdec.dist2bbox(tdec.dfl_expectation(torch.from_numpy(x)), torch.from_numpy(ap)).numpy()
    want = np.asarray(jdec.dist2bbox(jdec.dfl_expectation(jnp.asarray(x)), jnp.asarray(ap)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("pre_topk,max_det", [(384, 300), (100, 300), (384, 50)])
def test_batched_nms_seldec_matches_jax(pre_topk, max_det):
    """The whole select-then-decode tail, incl. the k < max_det padding path."""
    rng = np.random.default_rng(10)
    feats = _feats(rng, sizes=((20, 20), (10, 10), (5, 5)))
    shapes = ((20, 20), (10, 10), (5, 5))
    best, cls, dist = tdec.decode_scores_raw([torch.from_numpy(f) for f in feats], 5)
    jbest, jcls, jdist = jdec.decode_scores_raw([jnp.asarray(f) for f in feats], 5)
    got = tnms.batched_nms_seldec(dist, best, cls, 0.3, 0.45, feat_shapes=shapes, pre_topk=pre_topk, max_det=max_det)
    want = jnms.batched_nms_seldec(jdist, jbest, jcls, 0.3, 0.45, feat_shapes=shapes, pre_topk=pre_topk, max_det=max_det, impl="xla")
    assert got["num"].tolist() == np.asarray(want["num"]).tolist()
    assert int(got["num"].min()) > 0
    for key in ("valid", "classes", "anchor_idx"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-6, rtol=0)


def test_keep_kernel_wrapper_rejects_other_devices():
    boxes = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(ValueError):
        nms_fused.nms_keep(boxes, torch.ones((1, 4), dtype=torch.bool, device="meta"), 0.5)


def test_port_imports_without_jax():
    # -I: no PYTHONPATH and no user site, so nothing pre-imports jax behind the test's back
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            "import yolo_infer_tpu_torch, yolo_infer_tpu_torch.core.predictor; assert 'jax' not in sys.modules")
    subprocess.run([sys.executable, "-I", "-c", code], check=True, timeout=120)


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "yolo_infer_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "yolo_infer_tpu"), f"{path}: imports {name}"
