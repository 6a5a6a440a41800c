"""The port's CUDA kernels (A to H) against their plain versions, on the card.

This file imports neither jax nor the JAX package, so it also runs on a host
that has only torch: `python -m pytest --noconftest tests/test_torch_cuda.py`
(the repo's conftest sets up jax). The `cuda` tests skip without a card.
"""

import numpy as np
import pytest
import torch

import yolo_infer_tpu_torch.ops.masks as masks_mod
from yolo_infer_tpu_torch.core.graphs import WARMUP_CALLS
from yolo_infer_tpu_torch.core.predictor import LazyMasks, Predictor
from yolo_infer_tpu_torch.models.yolo11 import build_model
from yolo_infer_tpu_torch.ops.iou import box_iou_matrix
from yolo_infer_tpu_torch.ops.kernels import (
    attention_fused,
    dfl_decode,
    greedy_nms,
    int8_conv,
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


@pytest.mark.parametrize("name", ["nms_fused", "attention_fused", "rotated_nms_fused", "mask_pack", "dfl_decode",
                                  "greedy_nms", "int8_conv"])
def test_kernel_source_keeps_its_header_note(name):
    """Each kernel source opens with what it replaces, what bounds it on the
    card and what its design does about that."""
    from yolo_infer_tpu_torch.ops.kernels import _build

    head = []
    for line in (_build.CSRC_DIR / f"{name}.cu").read_text().splitlines():
        if not line.startswith("//"):
            break
        head.append(line)
    note = "\n".join(head)
    assert "Replaces: " in note and "yolo_infer_tpu/ops/pallas/" in note
    assert "What bounds it on the H100" in note and "design" in note.lower()


def test_wrappers_take_the_plain_versions_for_cpu_tensors():
    boxes, valid = _candidates(0, 2, 50)
    slab = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 128)).astype(np.float32))
    launches = (nms_fused.nms_keep.launches, attention_fused.attention_qkv.launches)
    assert torch.equal(nms_fused.nms_keep(boxes, valid, 0.45), nms_fused.nms_keep_reference(boxes, valid, 0.45))
    assert torch.equal(attention_fused.attention_qkv(slab, 1, 32, 64),
                       attention_fused.attention_qkv_reference(slab, 1, 32, 64))
    assert (nms_fused.nms_keep.launches, attention_fused.attention_qkv.launches) == launches
    x8 = torch.from_numpy(np.random.default_rng(2).integers(-127, 128, (1, 5, 5, 8), dtype=np.int8))
    w8 = torch.from_numpy(np.random.default_rng(3).integers(-127, 128, (4, 3, 3, 8), dtype=np.int8))
    before = (int8_conv.int8_conv.launches, attention_fused.attention_packed.launches)
    args = (x8, w8, torch.full((4,), 1e-4), None, 20.0)
    assert torch.equal(int8_conv.int8_conv(*args), int8_conv.int8_conv_reference(*args))
    assert torch.equal(attention_fused.attention_packed(slab[..., :128], 32, 64),
                       attention_fused.attention_packed_reference(slab[..., :128], 32, 64))
    assert (int8_conv.int8_conv.launches, attention_fused.attention_packed.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("k,kind", [(37, "random"), (384, "random"), (1024, "random"), (4096, "random"),
                                    (8192, "random"), (384, "prefix"), (4096, "prefix"), (384, "nan_inf"),
                                    (4096, "nan_inf")])
def test_keep_kernel_is_bit_equal_to_the_plain_version(card, k, kind):
    """Random candidates, a valid prefix (the serving pool: the bits pass and
    the walk stop at its end) and boxes holding NaN, +-inf and zero areas
    (torch.maximum, torch.minimum and clamp pass NaN through)."""
    b = 8 if k <= 1024 else 2
    boxes, valid = _candidates(k, b, k)
    if kind == "prefix":
        valid = torch.arange(k)[None] < torch.tensor([[0], [1], [33], [k // 2], [k - 1], [k], [31], [32]])[:b]
    if kind == "nan_inf":
        rng = np.random.default_rng(k)
        edge = torch.tensor([np.nan, np.inf, -np.inf, 0.0, 640.0], dtype=torch.float32)
        pick = torch.from_numpy(rng.uniform(0, 1, tuple(boxes.shape)) < 0.1)
        boxes = torch.where(pick, edge[torch.from_numpy(rng.integers(0, 5, tuple(boxes.shape)))], boxes)
        boxes[:, ::9, 2:] = boxes[:, ::9, :2]
    before = nms_fused.nms_keep.launches
    got = nms_fused.nms_keep(boxes.to(card), valid.to(card), 0.45)
    assert nms_fused.nms_keep.launches == before + 1
    # the plain version one image at a time on the card: (K, K) temporaries of 268 MB at K = 8192
    want = torch.cat([nms_fused.nms_keep_reference(boxes[i:i + 1].to(card), valid[i:i + 1].to(card), 0.45)
                      for i in range(b)])
    assert torch.equal(got, want)
    if k <= 1024:
        assert torch.equal(got.cpu(), nms_fused.nms_keep_reference(boxes, valid, 0.45))


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype,atol,rtol", [(400, torch.bfloat16, 2e-2, 2e-2), (400, torch.float32, 1e-5, 0.0),
                                               (1600, torch.bfloat16, 2e-2, 2e-2), (1024, torch.bfloat16, 2e-2, 2e-2),
                                               (37, torch.bfloat16, 2e-2, 2e-2), (37, torch.float32, 1e-5, 0.0)])
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
    pred.predict(frames)  # the signature's capture: each kernel once in the warm-up, once into the graph
    assert nms_fused.nms_keep.launches == attention_fused.attention_qkv.launches == 1 + WARMUP_CALLS
    pred.predict(frames)  # a replay: no launch from Python
    assert nms_fused.nms_keep.launches == attention_fused.attention_qkv.launches == 1 + WARMUP_CALLS


def _rotated_candidates(seed, b, k):
    rng = np.random.default_rng(seed)
    rb = np.concatenate([rng.uniform(50, 590, (b, k, 2)), rng.uniform(10, 120, (b, k, 2)),
                         rng.uniform(-np.pi / 2, np.pi / 2, (b, k, 1))], -1).astype(np.float32)
    return gauss_terms(torch.from_numpy(rb)).contiguous(), torch.from_numpy(rng.uniform(0, 1, (b, k)) > 0.15)


def _rotated_reference(g, v, thr):
    """The plain version one image at a time: its (K, K) f32 temporaries
    take 268 MB each at K = 8192."""
    return torch.cat([rotated_nms_fused.rotated_nms_keep_reference(g[i:i + 1], v[i:i + 1], thr)
                      for i in range(g.shape[0])])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [37, 160, 1024, 2048, 4096, 8192])
def test_rotated_keep_kernel_is_bit_equal_to_the_plain_version(card, k):
    gauss, valid = _rotated_candidates(k, 8, k)
    g, v = gauss.to(card), valid.to(card)
    v[-1] = False  # an image with no valid candidate
    before = rotated_nms_fused.rotated_nms_keep.launches
    got = rotated_nms_fused.rotated_nms_keep(g, v, 0.45)
    assert rotated_nms_fused.rotated_nms_keep.launches == before + 1
    assert torch.equal(got, _rotated_reference(g, v, 0.45))
    assert not got[-1].any()


@pytest.mark.cuda
def test_rotated_keep_kernel_on_a_prefix_valid_pool(card):
    """The serving pool: score-sorted, valid = score > 0, so the valid
    candidates are a prefix (the bits pass and the walk stop at its end)."""
    gauss, _ = _rotated_candidates(3, 4, 4096)
    g = gauss.to(card)
    v = torch.arange(4096, device=card)[None] < torch.tensor([[700], [4096], [1], [33]], device=card)
    got = rotated_nms_fused.rotated_nms_keep(g, v, 0.45)
    assert torch.equal(got, _rotated_reference(g, v, 0.45))
    assert bool(got[2, 0]) and not got[2, 1:].any()


@pytest.mark.cuda
def test_rotated_keep_wrapper_names_its_limit(card):
    g = torch.zeros((1, 8193, 5), device=card)
    with pytest.raises(ValueError, match="MAX_K=8192"):
        rotated_nms_fused.rotated_nms_keep(g, torch.ones((1, 8193), dtype=torch.bool, device=card), 0.45)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 160, 160), (37, 24, 40), (9600, 160, 160), (5, 17, 8), (2, 6, 4096)])
def test_mask_pack_kernel_is_bit_equal_to_the_plain_version(card, shape):
    soft = torch.from_numpy(np.random.default_rng(shape[0]).random(shape).astype(np.float32)).to(card)
    before = mask_pack.upsample4x_threshold_pack.launches
    got = mask_pack.upsample4x_threshold_pack(soft)
    assert mask_pack.upsample4x_threshold_pack.launches == before + 1
    assert got.shape == (shape[0], 4 * shape[1], shape[2] // 2)
    assert torch.equal(got, mask_pack.upsample4x_threshold_pack_reference(soft))


@pytest.mark.cuda
def test_mask_pack_kernel_is_bit_equal_on_edge_values(card):
    """0.5, nextafter(0.5, 1), -inf, +inf, NaN and negatives scattered over
    zeros, all-zero instances, and 2 x 2 blocks just above 0.5: the zero
    skip must not drop a bit, nor a NaN or an infinity make one."""
    rng = np.random.default_rng(11)
    up = float(np.nextafter(np.float32(0.5), np.float32(1)))
    vals = np.array([0.5, up, -np.inf, np.inf, np.nan, 0.49, 0.75, -3.0], np.float32)
    soft = np.where(rng.random((64, 24, 40)) < 0.1, vals[rng.integers(0, 8, (64, 24, 40))], 0).astype(np.float32)
    soft[::4] = 0
    soft[1::4, 6:8, 8:10] = up
    x = torch.from_numpy(soft).to(card)
    got = mask_pack.upsample4x_threshold_pack(x)
    assert torch.equal(got, mask_pack.upsample4x_threshold_pack_reference(x))
    assert not got[::4].any() and got[1::4].any()


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
    with pytest.raises(ValueError, match="MAX_K=8192"):
        nms_fused.nms_keep(torch.zeros((1, 8193, 4), device=card), torch.ones((1, 8193), dtype=torch.bool,
                                                                              device=card), 0.45)


@pytest.mark.cuda
def test_segment_predict_masks_match_the_plain_path(card):
    model, spec = build_model("segment", "n", seed=0)
    pred = Predictor(model, spec, compute_dtype=torch.float32)
    frames = np.random.default_rng(5).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    torch.backends.cudnn.deterministic = True
    try:
        before = mask_pack.upsample4x_threshold_pack.launches
        got = pred.predict(frames, conf=0.0, max_det=50)
        assert mask_pack.upsample4x_threshold_pack.launches == before + 1 + WARMUP_CALLS  # the capture
        masks_mod.upsample4x_threshold_pack = mask_pack.upsample4x_threshold_pack_reference
        pred.release_programs()  # captured again, with the plain version in the graph
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
    """Every row alignment the paths produce: detect's 144-channel slab,
    slices from channel 1, 2 and 4, OBB's 79 and pose's 65 channels, a
    ragged A, logits spread to N(0, 8) with sides that span 80, and more
    images than the grid's y limit (65535)."""
    rng = np.random.default_rng(6)
    slabs = {c: torch.from_numpy(rng.normal(0, 3, (4, 2100, c)).astype(np.float32)).to(card, dtype)
             for c in (144, 79, 65)}
    wide = rng.normal(0, 8, (4, 2100, 79)).astype(np.float32)
    sides = wide[..., :64].reshape(-1, 4, 16)
    rows = rng.choice(len(sides), len(sides) // 4, replace=False)
    sides[rows] = rng.permuted(np.broadcast_to(np.linspace(-40, 40, 16, dtype=np.float32), (len(rows), 4, 16)), axis=-1)
    wide[..., :64] = sides.reshape(4, 2100, 64)
    wide = torch.from_numpy(wide).to(card, dtype)
    many = torch.from_numpy(rng.normal(0, 3, (70000, 3, 64)).astype(np.float32)).to(card, dtype)
    widths = set()
    for x in (slabs[144][..., :64], slabs[144][..., :64].contiguous(), slabs[144][..., 1:65],
              slabs[144][..., 2:66], slabs[144][..., 4:68], slabs[79][..., :64], slabs[65][..., :64],
              slabs[144][:3, :2037, :64], wide[..., :64], wide[..., :64].contiguous(), many):
        before = dfl_decode.dfl_decode.launches
        got = dfl_decode.dfl_decode(x)
        assert dfl_decode.dfl_decode.launches == before + 1
        torch.testing.assert_close(got, dfl_decode.dfl_decode_reference(x), atol=1e-5, rtol=0)
        widths.add(dfl_decode.vector_bytes(x))
    assert widths == ({16, 8, 4} if dtype == torch.float32 else {16, 8, 4, 2})


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(2, 4096), (4, 1000), (3, 37), (2, 8192)])
def test_greedy_keep_kernel_is_bit_equal_to_the_plain_version(card, b, k):
    boxes, valid = _candidates(k + 1, b, k)
    boxes, valid = boxes.to(card), valid.to(card)
    valid[-1] = False  # an image with no valid candidate
    iou = box_iou_matrix(boxes, boxes)
    before = greedy_nms.greedy_nms_keep.launches
    got = greedy_nms.greedy_nms_keep(iou, valid, 0.6)
    assert greedy_nms.greedy_nms_keep.launches == before + 1
    want = torch.cat([greedy_nms.greedy_nms_keep_reference(iou[i:i + 1], valid[i:i + 1], 0.6) for i in range(b)])
    assert torch.equal(got, want)
    assert not got[-1].any()


@pytest.mark.cuda
def test_validation_path_launches_f_and_g(card):
    model, spec = build_model("pose", "n", nc=1, seed=0)
    pred = Predictor(model, spec, compute_dtype=torch.float32)
    frames = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)).to(card)
    dfl_decode.dfl_decode.launches = greedy_nms.greedy_nms_keep.launches = 0
    dets = pred.predict_raw(frames, 0.001, 0.6, 640, 300, multi_label=True, pre_topk=4096)
    assert dfl_decode.dfl_decode.launches == greedy_nms.greedy_nms_keep.launches == 1 + WARMUP_CALLS  # the capture
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


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 20, 20, 128, 128, 3, 1), (2, 17, 15, 64, 96, 3, 2), (3, 9, 11, 256, 40, 1, 1),
                                   (2, 10, 10, 130, 66, 1, 2), (1, 20, 20, 3, 16, 3, 2), (2, 13, 11, 96, 70, 3, 1)])
def test_int8_conv_kernel_is_bit_equal_to_the_plain_version(card, shape, epilogue):
    b, h, w, ci, co, k, stride = shape
    rng = np.random.default_rng(ci + co)
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, ci), dtype=np.int8)).to(card)
    wq = torch.from_numpy(rng.integers(-127, 128, (co, k, k, ci), dtype=np.int8)).to(card)
    scale = torch.from_numpy(rng.uniform(1e-5, 3e-5, co).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.normal(0, 0.5, co).astype(np.float32)).to(card)
    for act, bb in ((True, bias), (False, None)):
        before = int8_conv.int8_conv.launches
        got = int8_conv.int8_conv(x, wq, scale, bb, 50.0, stride=stride, act=act, epilogue_dtype=epilogue)
        assert int8_conv.int8_conv.launches == before + 1
        want = int8_conv.int8_conv_reference(x, wq, scale, bb, 50.0, stride=stride, act=act, epilogue_dtype=epilogue)
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 20, 20, 3, 16, 3, 2), (2, 17, 15, 16, 32, 3, 1), (2, 9, 11, 32, 64, 1, 1),
                                   (2, 10, 10, 64, 64, 3, 2), (2, 13, 11, 130, 70, 1, 1), (1, 9, 7, 96, 33, 3, 1)])
def test_int8_conv_float_epilogue_is_bit_equal_to_the_plain_version(card, shape, epilogue):
    """E's float epilogue (the dynamic and legacy static modes) at the stem's
    Ci = 3, the 16/32/64 widths, an odd Ci and an odd Co (single stores)."""
    b, h, w, ci, co, k, stride = shape
    rng = np.random.default_rng(ci * 7 + co)
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, ci), dtype=np.int8)).to(card)
    wq = torch.from_numpy(rng.integers(-127, 128, (co, k, k, ci), dtype=np.int8)).to(card)
    scale = torch.from_numpy(rng.uniform(1e-5, 3e-5, co).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.normal(0, 0.5, co).astype(np.float32)).to(card)
    for act, bb in ((True, bias), (False, None)):
        before = int8_conv.int8_conv.launches
        got = int8_conv.int8_conv(x, wq, scale, bb, 1.0, stride=stride, act=act, epilogue_dtype=epilogue,
                                  requant=False)
        assert int8_conv.int8_conv.launches == before + 1 and got.dtype == epilogue
        want = int8_conv.int8_conv_reference(x, wq, scale, bb, 1.0, stride=stride, act=act, epilogue_dtype=epilogue,
                                             requant=False)
        assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_int8_conv_kernel_reads_a_channel_chunk_in_place(card, k, stride):
    """E on the second half of a wider NHWC tensor (pixel pitch 256), as a
    static8 conv gets a `q_split2` chunk, equals its plain version and its
    own output on a contiguous copy; Co = 70 masks the ragged channel tile."""
    rng = np.random.default_rng(10 * k + stride)
    wide = torch.from_numpy(rng.integers(-127, 128, (2, 15, 13, 256), dtype=np.int8)).to(card)
    x = wide[..., 128:]
    wq = torch.from_numpy(rng.integers(-127, 128, (70, k, k, 128), dtype=np.int8)).to(card)
    scale = torch.from_numpy(rng.uniform(1e-5, 3e-5, 70).astype(np.float32)).to(card)
    bias = torch.from_numpy(rng.normal(0, 0.5, 70).astype(np.float32)).to(card)
    before = int8_conv.int8_conv.launches
    got = int8_conv.int8_conv(x, wq, scale, bias, 50.0, stride=stride)
    assert int8_conv.int8_conv.launches == before + 1
    assert torch.equal(got, int8_conv.int8_conv_reference(x, wq, scale, bias, 50.0, stride=stride))
    assert torch.equal(got, int8_conv.int8_conv(x.contiguous(), wq, scale, bias, 50.0, stride=stride))


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", [torch.float32, torch.bfloat16])
def test_int8_conv_kernel_is_bit_equal_on_sums_beyond_2_to_the_24(card, epilogue):
    """Large positive codes: int32 sums of ~6e7, which round on their way to
    f32 (the plain version's sums are exact in float64, then rounded)."""
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.integers(100, 128, (2, 9, 9, 512), dtype=np.int8)).to(card)
    wq = torch.from_numpy(rng.integers(100, 128, (64, 3, 3, 512), dtype=np.int8)).to(card)
    scale = torch.from_numpy((rng.uniform(0.5, 1.5, 64) / (113.5 ** 2 * 9 * 512)).astype(np.float32)).to(card)
    got = int8_conv.int8_conv(x, wq, scale, None, 50.0, epilogue_dtype=epilogue)
    assert torch.equal(got, int8_conv.int8_conv_reference(x, wq, scale, None, 50.0, epilogue_dtype=epilogue))
    assert int(got.abs().min()) < 127  # not every code clipped


@pytest.mark.cuda
def test_b_and_e_wrappers_raise_on_a_pitch_or_pointer_the_16_byte_path_does_not_take(card):
    wide = torch.zeros((2, 8, 8, 272), dtype=torch.int8, device=card)
    wq = torch.zeros((16, 3, 3, 128), dtype=torch.int8, device=card)
    scale = torch.ones(16, device=card)
    pitch136 = torch.zeros((2, 8, 8, 136), dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        int8_conv.int8_conv(pitch136[..., :128], wq, scale, None, 1.0)
    with pytest.raises(ValueError, match="16-byte"):
        int8_conv.int8_conv(wide[..., 8:136], wq, scale, None, 1.0)  # first element at byte 8
    with pytest.raises(ValueError, match="pixel pitch"):
        int8_conv.int8_conv(wide[..., :128].permute(0, 2, 1, 3), wq, scale, None, 1.0)
    slab = torch.zeros(2 * 16 * 256 + 1, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention_fused.attention_qkv(slab[1:].view(2, 16, 256), 2, 32, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.bfloat16, 2e-2, 2e-2), (torch.float32, 1e-5, 0.0)])
def test_packed_attention_kernel_matches_the_plain_version_and_route_b(card, dtype, atol, rtol):
    slab = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 400, 256)).astype(np.float32)).to(card, dtype)
    qg = slab.view(4, 400, 2, 128).transpose(1, 2).reshape(8, 400, 128)
    before = attention_fused.attention_packed.launches
    got = attention_fused.attention_packed(qg, 32, 64)
    assert attention_fused.attention_packed.launches == before + 1
    torch.testing.assert_close(got.float(), attention_fused.attention_packed_reference(qg, 32, 64).float(),
                               atol=atol, rtol=rtol)
    via_b = attention_fused.attention_qkv(slab, 2, 32, 64).view(4, 400, 2, 64).transpose(1, 2).reshape(8, 400, 64)
    torch.testing.assert_close(got, via_b, atol=0, rtol=0)


@pytest.mark.cuda
def test_static8_path_launches_e_and_the_pallas_route_launches_h(card):
    from yolo_infer_tpu_torch import YOLO11Model
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

    frames = np.random.default_rng(8).integers(0, 256, (2, 640, 640, 3), dtype=np.uint8)
    q = create_quantizer("ptq", YOLO11Model("yolo11n"), {"imgsz": 640})
    q.set_calibration_data([frames])
    qmodel = q.optimize()
    int8_conv.int8_conv.launches = 0
    out = qmodel.predict(frames)
    assert int8_conv.int8_conv.launches > 0 and len(out) == 2
    model, spec = build_model("detect", "n", seed=0)
    pred = Predictor(model, spec, attn_impl="pallas")
    attention_fused.attention_packed.launches = attention_fused.attention_qkv.launches = 0
    pred.predict(frames)  # the capture
    assert attention_fused.attention_packed.launches == 1 + WARMUP_CALLS
    assert attention_fused.attention_qkv.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["detect", "segment"])
def test_predict_many_on_the_card_equals_predict_per_chunk(card, task):
    """Nine frames in chunks of 2 at pipeline_depth 1: two pinned staging
    buffers refilled by the staging thread four times over; the Results (and
    segment masks, held on the host) equal `predict` on the same padded chunks."""
    model, spec = build_model(task, "n", seed=0)
    pred = Predictor(model, spec, compute_dtype=torch.float32)
    frames = list(np.random.default_rng(6).integers(0, 256, (9, 96, 128, 3), dtype=np.uint8))
    torch.backends.cudnn.deterministic = True
    try:
        got = pred.predict_many(frames, conf=0.0, imgsz=128, max_det=20, batch_size=2, pipeline_depth=1)
        chunks = [frames[lo:lo + 2] for lo in range(0, 8, 2)] + [[frames[8], frames[8]]]
        want = [r for c in chunks for r in pred.predict(c, conf=0.0, imgsz=128, max_det=20)][:9]
    finally:
        torch.backends.cudnn.deterministic = False
    assert len(got) == 9
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.scores, w.scores)
        if task == "segment":
            assert not torch.is_tensor(g.masks._dev)
            np.testing.assert_array_equal(g.masks.numpy(), w.masks.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["detect", "segment", "pose", "obb"])
def test_predict_raw_makes_no_host_synchronisation(card, task):
    model, spec = build_model(task, "n", seed=0)
    pred = Predictor(model, spec)
    frames = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)).cuda()
    pred.predict_raw(frames, 0.25, 0.45, 128)  # builds and loads outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pred.predict_raw(frames, 0.25, 0.45, 128)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
