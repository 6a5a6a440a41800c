"""The port's task ops (rotated NMS, masks, row select, keypoints, letterbox) vs the JAX package, on the CPU.

Same numpy-seeded inputs through the JAX function and its port counterpart:
keep masks and packed mask bytes exactly (the Pallas kernels in interpret
mode, the XLA reference paths), probIoU within 1e-6, boxes within 1e-3; the
OpenCV-free letterbox bit for bit against `cv2.resize`.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_infer_tpu.ops import decode as jdec
from yolo_infer_tpu.ops.letterbox import crop_letterbox_masks as j_crop_masks
from yolo_infer_tpu.ops.letterbox import crop_letterbox_slices as j_crop_slices
from yolo_infer_tpu.ops.letterbox import letterbox as j_letterbox
from yolo_infer_tpu.ops.letterbox import letterbox_params as j_letterbox_params
from yolo_infer_tpu.ops.letterbox import scale_obb as j_scale_obb
from yolo_infer_tpu.ops import masks as jmasks
from yolo_infer_tpu.ops import rotated as jrot
from yolo_infer_tpu.ops.nms import _nms_fixpoint as j_fixpoint
from yolo_infer_tpu.ops.pallas.mask_pack import upsample4x_threshold_pack as j_pack_pallas
from yolo_infer_tpu.ops.pallas.nms_fused import rotated_nms_keep_pallas
from yolo_infer_tpu.ops.select import select_anchor_rows as j_select
from yolo_infer_tpu_torch.ops import decode as tdec
from yolo_infer_tpu_torch.ops import letterbox as tlb
from yolo_infer_tpu_torch.ops import masks as tmasks
from yolo_infer_tpu_torch.ops import rotated as trot
from yolo_infer_tpu_torch.ops.kernels import mask_pack, rotated_nms_fused
from yolo_infer_tpu_torch.ops.select import select_anchor_rows
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _rboxes(rng, b, k):
    """Random oriented boxes in a 640 px frame and descending scores, as in
    test_pallas_kernels.py's rotated kernel test."""
    cxy = rng.uniform(50, 590, (b, k, 2))
    wh = rng.uniform(10, 120, (b, k, 2))
    ang = rng.uniform(-np.pi / 2, np.pi / 2, (b, k, 1))
    scores = -np.sort(-rng.uniform(0, 1, (b, k)).astype(np.float32), axis=1)
    return np.concatenate([cxy, wh, ang], -1).astype(np.float32), scores


# --- kernel C's plain path --------------------------------------------------

def test_probiou_matrix_matches_jax():
    rb, _ = _rboxes(np.random.default_rng(0), 1, 1024)
    got = trot.probiou_matrix(torch.from_numpy(rb[0]), torch.from_numpy(rb[0])).numpy()
    want = np.asarray(jrot.probiou_matrix(jnp.asarray(rb[0]), jnp.asarray(rb[0])))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("k", [160, 1024])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotated_keep_mask_matches_pallas_kernel_and_fixpoint(seed, k):
    rb, scores = _rboxes(np.random.default_rng(seed), 2, k)
    valid = scores > 0.15
    got = trot.rotated_nms_keep_mask(torch.from_numpy(rb), torch.from_numpy(valid), 0.4).numpy()
    jrb = jnp.asarray(rb)
    ca, cb, cc = jrot._cov(jrb)
    gauss = jnp.stack([jrb[..., 0], jrb[..., 1], ca, cb, cc], axis=-1)
    want_pl = np.asarray(rotated_nms_keep_pallas(gauss, jnp.asarray(valid), 0.4, interpret=True))
    want_fx = np.asarray(jax.vmap(
        lambda bx, va: j_fixpoint(jrot.probiou_matrix(bx, bx), va, jnp.float32(0.4), max_sweeps=k))(jrb, jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want_pl)
    np.testing.assert_array_equal(got, want_fx)
    assert got.any() and not got[~valid].any()


def test_rotated_keep_mask_suppression_chain():
    """A suppresses B, so C (overlapped only by B) must survive."""
    rb = np.array([[[50, 50, 100, 40, 0.3], [90, 50, 100, 40, 0.3], [130, 50, 100, 40, 0.3],
                    [400, 400, 20, 20, 0.0]]], np.float32)
    valid = np.array([[True, True, True, False]])
    got = trot.rotated_nms_keep_mask(torch.from_numpy(rb), torch.from_numpy(valid), 0.3).tolist()
    want = np.asarray(jrot.rotated_nms_keep_mask(jnp.asarray(rb), jnp.asarray(valid), jnp.float32(0.3), 4,
                                                 impl="xla")).tolist()
    assert got == want == [[True, False, True, False]]


@pytest.mark.parametrize("pre_topk,max_det", [(1024, 300), (64, 100), (2048, 300)])
def test_batched_rotated_nms_matches_jax(pre_topk, max_det):
    rng = np.random.default_rng(3)
    b, a, nc = 2, 1500, 4
    rb, _ = _rboxes(rng, b, a)
    scores = rng.uniform(0, 1, (b, a, nc)).astype(np.float32) ** 3
    got = trot.batched_rotated_nms(torch.from_numpy(rb), torch.from_numpy(scores), 0.25, 0.45,
                                   pre_topk=pre_topk, max_det=max_det)
    want = jrot.batched_rotated_nms(jnp.asarray(rb), jnp.asarray(scores), 0.25, 0.45,
                                    pre_topk=pre_topk, max_det=max_det, impl="xla")
    assert got["num"].tolist() == np.asarray(want["num"]).tolist()
    assert int(got["num"].min()) > 0
    for key in ("valid", "classes", "anchor_idx"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=1e-6, rtol=0)


def _walk(words, valid):
    """Kernel C's walk (csrc/nms_walk.cuh) in numpy: candidates up to E, one
    past the last valid one, in rank order; a kept row ORs its words from its
    own word on into the removed set."""
    k = valid.shape[0]
    end = int(np.nonzero(valid)[0].max()) + 1 if valid.any() else 0
    removed = np.zeros(words.shape[1], np.uint32)
    keep = np.zeros(k, bool)
    for i in range(end):
        if valid[i] and not (removed[i >> 5] >> np.uint32(i & 31)) & 1:
            keep[i] = True
            removed[i >> 5:] |= words[i, i >> 5:]
    return keep


@pytest.mark.parametrize("prefix", [False, True])
def test_greedy_walk_over_the_cleared_probiou_bitmask_gives_the_fixpoint(prefix):
    """The rule kernel C's bits pass relies on: bits of pairs with an invalid
    row or column, and of columns at or past E, cleared without their
    probIoU; rows at or past E and words before a row's own never read (set
    to ones here). The walk then gives the fixpoint's keep mask."""
    rng = np.random.default_rng(13)
    b, k, thr = 3, 200, 0.4
    rb, scores = _rboxes(rng, b, k)
    valid = np.arange(k)[None] < np.array([[150], [37], [0]]) if prefix else scores > 0.3
    valid[2] = False  # an image with no valid candidate
    gauss = trot.gauss_terms(torch.from_numpy(rb)).contiguous()
    iou = trot.probiou_gauss_matrix(gauss, gauss).numpy()
    want = rotated_nms_fused.rotated_nms_keep_reference(gauss, torch.from_numpy(valid), thr).numpy()
    jwant = np.asarray(jax.vmap(lambda m, v: j_fixpoint(m, v, jnp.float32(thr), max_sweeps=k))(
        jnp.asarray(iou), jnp.asarray(valid)))
    np.testing.assert_array_equal(want, jwant)
    for img in range(b):
        v = valid[img]
        end = int(np.nonzero(v)[0].max()) + 1 if v.any() else 0
        sup = (iou[img] > thr) & np.triu(np.ones((k, k), bool), 1) & v[:, None] & v[None, :]
        sup[:, end:] = False
        words = np.packbits(np.pad(sup, ((0, 0), (0, -k % 32))), axis=1, bitorder="little").view("<u4").copy()
        for i in range(k):
            words[i, :i >> 5] = 0xFFFFFFFF
        words[end:] = 0xFFFFFFFF
        np.testing.assert_array_equal(_walk(words, v), want[img])
    assert want[0].any() and not want[2].any()


def test_multi_label_rotated_nms_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 4.2"):
        trot.batched_rotated_nms(torch.zeros(1, 8, 5), torch.zeros(1, 8, 2), multi_label=True)


def test_dist2rbox_matches_jax():
    rng = np.random.default_rng(4)
    dist = rng.uniform(0, 8, (2, 30, 4)).astype(np.float32)
    angle = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 30)).astype(np.float32)
    ap = rng.uniform(0, 20, (30, 2)).astype(np.float32)
    got = trot.dist2rbox(torch.from_numpy(dist), torch.from_numpy(angle), torch.from_numpy(ap)[None]).numpy()
    want = np.asarray(jrot.dist2rbox(jnp.asarray(dist), jnp.asarray(angle), jnp.asarray(ap)[None]))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# --- kernel D's plain path --------------------------------------------------

@pytest.mark.parametrize("r", [4, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_upsample_threshold_pack_is_bit_equal_to_jax(seed, r):
    soft = np.random.default_rng(seed).random((64, 24, 24)).astype(np.float32)
    got = tmasks._upsample_threshold_pack(torch.from_numpy(soft), r).numpy()
    want = np.asarray(jmasks._upsample_threshold_pack(jnp.asarray(soft), r))
    assert got.shape == (64, 24 * r, 24 * r // 8)
    np.testing.assert_array_equal(got, want)


def test_mask_pack_plain_version_is_bit_equal_to_the_pallas_kernel():
    soft = np.random.default_rng(5).random((8, 16, 40)).astype(np.float32)
    got = mask_pack.upsample4x_threshold_pack_reference(torch.from_numpy(soft)).numpy()
    want = np.asarray(j_pack_pallas(jnp.asarray(soft[..., 0::2]), jnp.asarray(soft[..., 1::2]), interpret=True))
    np.testing.assert_array_equal(got, want)


def _pack_both(soft):
    got = mask_pack.upsample4x_threshold_pack_reference(torch.from_numpy(soft)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmasks._upsample_threshold_pack(jnp.asarray(soft), 4)))
    return got


@pytest.mark.parametrize("fill", [0.5, -np.inf, np.nan, -2.0, 0.0])
def test_mask_pack_inputs_at_most_half_pack_to_zero(fill):
    """The rule kernel D's zero skip rests on: soft masks with no value above
    0.5 (0.5 itself, -inf, NaN, negatives, zeros, mixed) pack to all zeros."""
    rng = np.random.default_rng(12)
    soft = np.where(rng.random((6, 16, 24)) < 0.5, np.float32(fill), rng.uniform(-1, 0.5, (6, 16, 24)))
    assert not _pack_both(soft.astype(np.float32)).any()


def test_mask_pack_values_just_above_half_set_bits():
    """One value nextafter(0.5, 1) in zeros sets no bit (a bilinear tap
    weighs it at most 7/8 x 7/8), a 2 x 2 block of it sets the 4 x 4 output
    pixels at its centre: a skip test of `> 0.5` on the inputs keeps both."""
    up = np.nextafter(np.float32(0.5), np.float32(1))
    soft = np.zeros((2, 16, 24), np.float32)
    soft[0, 7, 9] = up
    soft[1, 6:8, 8:10] = up
    bits = np.unpackbits(_pack_both(soft), axis=-1)
    assert not bits[0].any()
    want = np.zeros((64, 96), np.uint8)
    want[26:30, 34:38] = 1
    np.testing.assert_array_equal(bits[1], want)


@pytest.mark.parametrize("out_size", [None, 48])
def test_assemble_mask_bits_up_is_bit_equal_to_jax(out_size):
    """Bit-equal on these seeded inputs (the prototype product's summation
    order may differ, so a logit within an ulp of 0 could flip a bit; none
    does here)."""
    rng = np.random.default_rng(7)
    b, md, nm, imgsz = 2, 50, 32, 96
    proto = rng.normal(0, 1, (b, imgsz // 4, imgsz // 4, nm)).astype(np.float32)
    coefs = rng.normal(0, 0.5, (b, md, nm)).astype(np.float32)
    xy = rng.uniform(0, 80, (b, md, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (b, md, 2))], -1).astype(np.float32)
    got = tmasks.assemble_mask_bits_up(torch.from_numpy(proto), torch.from_numpy(coefs), torch.from_numpy(boxes),
                                       imgsz, out_size=out_size).numpy()
    want = np.asarray(jmasks.assemble_mask_bits_up(jnp.asarray(proto), jnp.asarray(coefs), jnp.asarray(boxes),
                                                   imgsz, out_size=out_size))
    grid = out_size or imgsz
    assert got.shape == (b, md, grid, grid // 8)
    assert 0.02 < np.unpackbits(got).mean() < 0.5  # masks neither empty nor full
    np.testing.assert_array_equal(got, want)


def test_unpack_and_repeat_mask_bits_match_jax():
    packed = np.random.default_rng(8).integers(0, 256, (3, 5, 7), dtype=np.uint8)
    np.testing.assert_array_equal(tmasks.unpack_mask_bits(packed), jmasks.unpack_mask_bits(packed))
    for s in (1, 2, 4):
        np.testing.assert_array_equal(tmasks.repeat_mask_bits(packed, s), jmasks.repeat_mask_bits(packed, s))


# --- wrappers ---------------------------------------------------------------

def test_wrappers_take_the_plain_versions_for_cpu_tensors():
    rb, scores = _rboxes(np.random.default_rng(9), 2, 40)
    gauss = trot.gauss_terms(torch.from_numpy(rb)).contiguous()
    valid = torch.from_numpy(scores > 0.15)
    soft = torch.from_numpy(np.random.default_rng(10).random((4, 8, 16)).astype(np.float32))
    launches = (rotated_nms_fused.rotated_nms_keep.launches, mask_pack.upsample4x_threshold_pack.launches)
    assert torch.equal(rotated_nms_fused.rotated_nms_keep(gauss, valid, 0.45),
                       rotated_nms_fused.rotated_nms_keep_reference(gauss, valid, 0.45))
    assert torch.equal(mask_pack.upsample4x_threshold_pack(soft), mask_pack.upsample4x_threshold_pack_reference(soft))
    assert (rotated_nms_fused.rotated_nms_keep.launches, mask_pack.upsample4x_threshold_pack.launches) == launches


def test_wrappers_reject_other_devices():
    with pytest.raises(ValueError):
        rotated_nms_fused.rotated_nms_keep(torch.zeros((1, 4, 5), device="meta"),
                                           torch.ones((1, 4), dtype=torch.bool, device="meta"), 0.5)
    with pytest.raises(ValueError):
        mask_pack.upsample4x_threshold_pack(torch.zeros((1, 8, 8), device="meta"))


# --- row select, decode -----------------------------------------------------

@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_select_anchor_rows_matches_jax(impl):
    rng = np.random.default_rng(11)
    grid = rng.normal(0, 1, (2, 189, 51)).astype(np.float32)
    table = rng.normal(0, 1, (189, 3)).astype(np.float32)
    idx = rng.integers(0, 189, (2, 40)).astype(np.int32)
    for x in (grid, table):
        got = select_anchor_rows(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
        np.testing.assert_array_equal(got, np.asarray(j_select(jnp.asarray(x), jnp.asarray(idx), impl=impl)))


def test_decode_raw_and_keypoints_match_jax():
    rng = np.random.default_rng(12)
    shapes = ((12, 12), (6, 6), (3, 3))
    feats = [rng.normal(0, 2, (2, h, w, 64 + 5)).astype(np.float32) for h, w in shapes]
    got = tdec.decode_raw([torch.from_numpy(f) for f in feats], 5)
    want = jdec.decode_raw([jnp.asarray(f) for f in feats], 5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    kflat = rng.normal(0, 1, (2, 189, 51)).astype(np.float32)
    ap, st = tdec.make_anchors(shapes, (8, 16, 32))
    idx = rng.integers(0, 189, (2, 30))
    for anchors, strides, rows in ((ap, st, kflat), (ap.numpy()[idx], st.numpy()[idx], kflat[np.arange(2)[:, None], idx])):
        got = tdec.decode_keypoints(torch.as_tensor(rows), torch.as_tensor(anchors), torch.as_tensor(strides)).numpy()
        want = np.asarray(jdec.decode_keypoints(jnp.asarray(rows), jnp.asarray(anchors), jnp.asarray(strides)))
        assert got.shape == want.shape and got.shape[-2:] == (17, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# --- letterbox ----------------------------------------------------------------

@pytest.mark.parametrize("hw,new_wh", [
    ((60, 96), (640, 400)),  # up, non-integer
    ((480, 640), (320, 240)),  # exactly x0.5: OpenCV's area path
    ((480, 640), (96, 72)),  # down by 6.67
    ((123, 457), (160, 43)),  # down, non-integer, odd sizes
    ((64, 64), (192, 192)),  # up x3
    ((720, 1280), (640, 360)),  # down, non-integer
    ((101, 100), (50, 50)),  # nearly x0.5 on one axis only
])
def test_resize_matches_cv2_bit_for_bit(hw, new_wh):
    img = np.random.default_rng(sum(hw)).integers(0, 256, hw + (3,), dtype=np.uint8)
    want = cv2.resize(img, new_wh, interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(tlb.resize_linear_u8(img, *new_wh), want)


@pytest.mark.parametrize("hw", [(60, 96), (96, 72), (480, 640), (1080, 1920), (640, 640), (33, 47)])
def test_letterbox_matches_the_jax_packages_opencv_letterbox(hw):
    img = np.random.default_rng(hw[0]).integers(0, 256, hw + (3,), dtype=np.uint8)
    for imgsz in (96, 320):
        got, r, pad = tlb.letterbox(img, imgsz)
        want, wr, wpad = j_letterbox(img, imgsz)
        assert (r, pad) == (wr, wpad)
        np.testing.assert_array_equal(got, want)


def test_obb_and_mask_geometry_match_jax():
    obb = np.random.default_rng(13).uniform(0, 600, (9, 5)).astype(np.float32)
    for shape in [(480, 640), (640, 480), (123, 457)]:
        r, pad, _ = j_letterbox_params(shape, 640)
        np.testing.assert_array_equal(tlb.scale_obb(obb, r, pad), j_scale_obb(obb, r, pad))
        for ds in (1, 4):
            assert tlb.crop_letterbox_slices(r, pad, shape, ds) == j_crop_slices(r, pad, shape, ds)
        masks = np.random.default_rng(14).random((3, 160, 160)).astype(np.float32)
        np.testing.assert_array_equal(tlb.crop_letterbox_masks(masks, r, pad, shape),
                                      j_crop_masks(masks, r, pad, shape))


def test_kernel_build_hashes_the_included_headers(tmp_path, monkeypatch):
    """An edited header must rebuild every kernel that includes it."""
    from yolo_infer_tpu_torch.ops.kernels import _build

    for src in _build.CSRC_DIR.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    assert {p.name for p in _build._sources("rotated_nms_fused")} == {"rotated_nms_fused.cu", "nms_walk.cuh"}
    before = {name: _build.library_path(name) for name in _build.KERNELS}
    (tmp_path / "nms_walk.cuh").write_text((tmp_path / "nms_walk.cuh").read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.KERNELS}
    assert [n for n in _build.KERNELS if before[n] != after[n]] == ["nms_fused", "rotated_nms_fused", "greedy_nms"]
