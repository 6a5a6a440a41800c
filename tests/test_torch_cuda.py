"""The port's CUDA kernels (A, B, C, D, F, G) against their plain versions, on the card.

This file imports neither jax nor the JAX package, so it also runs on a host
that has only torch: `python -m pytest --noconftest tests/test_torch_cuda.py`
(the repo's conftest sets up jax). The `cuda` tests skip without a card.
"""

import numpy as np
import pytest
import torch

import yolo_infer_tpu_torch.ops.masks as masks_mod
from yolo_infer_tpu_torch.core.predictor import LazyMasks, Predictor
from yolo_infer_tpu_torch.models.yolo11 import build_model
from yolo_infer_tpu_torch.ops.iou import box_iou_matrix
from yolo_infer_tpu_torch.ops.kernels import (
    attention_fused,
    dfl_decode,
    greedy_nms,
    mask_pack,
    nms_fused,
    rotated_nms_fused,
)
from yolo_infer_tpu_torch.ops.rotated import gauss_terms


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _candidates(seed, b, k):
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(50, 590, (b, k, 2))
    wh = rng.uniform(10, 120, (b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    return torch.from_numpy(boxes), torch.from_numpy(rng.uniform(0, 1, (b, k)) > 0.15)


def test_wrappers_take_the_plain_versions_for_cpu_tensors():
    boxes, valid = _candidates(0, 2, 50)
    slab = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 128)).astype(np.float32))
    launches = (nms_fused.nms_keep.launches, attention_fused.attention_qkv.launches)
    assert torch.equal(nms_fused.nms_keep(boxes, valid, 0.45), nms_fused.nms_keep_reference(boxes, valid, 0.45))
    assert torch.equal(attention_fused.attention_qkv(slab, 1, 32, 64),
                       attention_fused.attention_qkv_reference(slab, 1, 32, 64))
    assert (nms_fused.nms_keep.launches, attention_fused.attention_qkv.launches) == launches


@pytest.mark.cuda
@pytest.mark.parametrize("k", [384, 1024])
def test_keep_kernel_is_bit_equal_to_the_plain_version(card, k):
    boxes, valid = _candidates(k, 8, k)
    before = nms_fused.nms_keep.launches
    got = nms_fused.nms_keep(boxes.to(card), valid.to(card), 0.45)
    assert nms_fused.nms_keep.launches == before + 1
    assert torch.equal(got.cpu(), nms_fused.nms_keep_reference(boxes, valid, 0.45))


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype,atol,rtol", [(400, torch.bfloat16, 2e-2, 2e-2), (400, torch.float32, 1e-5, 0.0),
                                               (1600, torch.bfloat16, 2e-2, 2e-2)])
def test_attention_kernel_matches_the_plain_version(card, n, dtype, atol, rtol):
    slab = torch.from_numpy(np.random.default_rng(n).standard_normal((4, n, 256)).astype(np.float32)).to(card, dtype)
    before = attention_fused.attention_qkv.launches
    got = attention_fused.attention_qkv(slab, 2, 32, 64)
    assert attention_fused.attention_qkv.launches == before + 1
    want = attention_fused.attention_qkv_reference(slab, 2, 32, 64)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_main_path_launches_both_kernels(card):
    model, spec = build_model("detect", "n", seed=0)
    pred = Predictor(model, spec)
    assert pred.device.type == "cuda"
    frames = np.random.default_rng(4).integers(0, 256, (2, 640, 640, 3), dtype=np.uint8)
    nms_fused.nms_keep.launches = attention_fused.attention_qkv.launches = 0
    pred.predict(frames)
    assert nms_fused.nms_keep.launches == 1 and attention_fused.attention_qkv.launches == 1


def _rotated_candidates(seed, b, k):
    rng = np.random.default_rng(seed)
    rb = np.concatenate([rng.uniform(50, 590, (b, k, 2)), rng.uniform(10, 120, (b, k, 2)),
                         rng.uniform(-np.pi / 2, np.pi / 2, (b, k, 1))], -1).astype(np.float32)
    return gauss_terms(torch.from_numpy(rb)).contiguous(), torch.from_numpy(rng.uniform(0, 1, (b, k)) > 0.15)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [160, 1024])
def test_rotated_keep_kernel_is_bit_equal_to_the_plain_version(card, k):
    gauss, valid = _rotated_candidates(k, 8, k)
    g, v = gauss.to(card), valid.to(card)
    before = rotated_nms_fused.rotated_nms_keep.launches
    got = rotated_nms_fused.rotated_nms_keep(g, v, 0.45)
    assert rotated_nms_fused.rotated_nms_keep.launches == before + 1
    assert torch.equal(got, rotated_nms_fused.rotated_nms_keep_reference(g, v, 0.45))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 160, 160), (37, 24, 40)])
def test_mask_pack_kernel_is_bit_equal_to_the_plain_version(card, shape):
    soft = torch.from_numpy(np.random.default_rng(shape[0]).random(shape).astype(np.float32)).to(card)
    before = mask_pack.upsample4x_threshold_pack.launches
    got = mask_pack.upsample4x_threshold_pack(soft)
    assert mask_pack.upsample4x_threshold_pack.launches == before + 1
    assert got.shape == (shape[0], 4 * shape[1], shape[2] // 2)
    assert torch.equal(got, mask_pack.upsample4x_threshold_pack_reference(soft))


@pytest.mark.cuda
def test_wrappers_raise_on_inputs_the_kernels_do_not_take(card):
    gauss, valid = _rotated_candidates(0, 2, 64)
    g, v = gauss.to(card), valid.to(card)
    with pytest.raises(ValueError, match="contiguous"):
        rotated_nms_fused.rotated_nms_keep(g.transpose(0, 1).contiguous().transpose(0, 1), v, 0.45)
    with pytest.raises(ValueError, match="float32"):
        rotated_nms_fused.rotated_nms_keep(g.double(), v, 0.45)
    soft = torch.rand((4, 16, 32), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        mask_pack.upsample4x_threshold_pack(soft.transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        mask_pack.upsample4x_threshold_pack(soft.half())
    boxes = torch.rand((2, 64, 4), device=card)
    with pytest.raises(ValueError, match="contiguous"):
        nms_fused.nms_keep(boxes.transpose(0, 1).contiguous().transpose(0, 1), v, 0.45)
    with pytest.raises(ValueError, match="float32"):
        nms_fused.nms_keep(boxes.half(), v, 0.45)


@pytest.mark.cuda
def test_segment_predict_masks_match_the_plain_path(card):
    model, spec = build_model("segment", "n", seed=0)
    pred = Predictor(model, spec, compute_dtype=torch.float32)
    frames = np.random.default_rng(5).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    torch.backends.cudnn.deterministic = True
    try:
        before = mask_pack.upsample4x_threshold_pack.launches
        got = pred.predict(frames, conf=0.0, max_det=50)
        assert mask_pack.upsample4x_threshold_pack.launches == before + 1
        masks_mod.upsample4x_threshold_pack = mask_pack.upsample4x_threshold_pack_reference
        want = pred.predict(frames, conf=0.0, max_det=50)
    finally:
        masks_mod.upsample4x_threshold_pack = mask_pack.upsample4x_threshold_pack
        torch.backends.cudnn.deterministic = False
    for g, w in zip(got, want):
        assert isinstance(g.masks, LazyMasks) and len(g) == len(w) > 0
        assert g.masks.shape == (len(g), 480, 640)
        np.testing.assert_array_equal(g.masks.numpy(), w.masks.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dfl_kernel_matches_the_plain_version(card, dtype):
    slab = torch.from_numpy(np.random.default_rng(6).normal(0, 3, (4, 2100, 144)).astype(np.float32)).to(card, dtype)
    for x in (slab[..., :64], slab[..., :64].contiguous()):
        before = dfl_decode.dfl_decode.launches
        got = dfl_decode.dfl_decode(x)
        assert dfl_decode.dfl_decode.launches == before + 1
        torch.testing.assert_close(got, dfl_decode.dfl_decode_reference(x), atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(2, 4096), (4, 1000), (3, 37)])
def test_greedy_keep_kernel_is_bit_equal_to_the_plain_version(card, b, k):
    boxes, valid = _candidates(k + 1, b, k)
    boxes, valid = boxes.to(card), valid.to(card)
    valid[-1] = False  # an image with no valid candidate
    iou = box_iou_matrix(boxes, boxes)
    before = greedy_nms.greedy_nms_keep.launches
    got = greedy_nms.greedy_nms_keep(iou, valid, 0.6)
    assert greedy_nms.greedy_nms_keep.launches == before + 1
    assert torch.equal(got, greedy_nms.greedy_nms_keep_reference(iou, valid, 0.6))
    assert not got[-1].any()


@pytest.mark.cuda
def test_validation_path_launches_f_and_g(card):
    model, spec = build_model("pose", "n", nc=1, seed=0)
    pred = Predictor(model, spec, compute_dtype=torch.float32)
    frames = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)).to(card)
    dfl_decode.dfl_decode.launches = greedy_nms.greedy_nms_keep.launches = 0
    dets = pred.predict_raw(frames, 0.001, 0.6, 640, 300, multi_label=True, pre_topk=4096)
    assert dfl_decode.dfl_decode.launches == 1 and greedy_nms.greedy_nms_keep.launches == 1
    assert dets["kpts"].shape == (2, 300, 17, 3) and bool(torch.isfinite(dets["boxes"]).all())


@pytest.mark.cuda
def test_f_and_g_wrappers_raise_on_inputs_the_kernels_do_not_take(card):
    x = torch.rand((2, 64, 64), device=card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dfl_decode.dfl_decode(x.half())
    with pytest.raises(ValueError, match="last dim"):
        dfl_decode.dfl_decode(x.transpose(1, 2))
    with pytest.raises(ValueError, match="reg_max"):
        dfl_decode.dfl_decode(x[..., :32], reg_max=8)
    valid = torch.ones((2, 64), dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        greedy_nms.greedy_nms_keep(x.transpose(1, 2), valid, 0.5)
    with pytest.raises(ValueError, match="float32"):
        greedy_nms.greedy_nms_keep(x.half(), valid, 0.5)
    with pytest.raises(ValueError, match="K="):
        greedy_nms.greedy_nms_keep(torch.zeros((1, 8200, 8200), device=card), torch.ones((1, 8200), dtype=torch.bool,
                                                                                          device=card), 0.5)
