"""The port's host-finished segment mask modes vs the JAX package, on the CPU.

- `assemble_mask_bits` and `assemble_masks_q8` against JAX on the same seeded
  prototypes, coefficients and boxes: packed bits equal, q8 codes within one
  code (sigmoid * 255 may round the other way at a .5 edge).
- `resize_linear_f32` against `cv2.resize(INTER_LINEAR)` on float32 at
  several scales and up to 600 channels (OpenCV takes 128 at a time here):
  within 1e-6 (OpenCV's vector loops fuse some products into FMAs: the last
  bit may differ, 6e-8 on values in [0, 1]).
- Each mode through `Predictor.predict` on the golden segment weights (f32)
  at 160 px against the JAX Predictor: equal counts, and the detections
  paired as sets (same class, boxes within 1e-3 px, scores within 1e-5:
  the golden weights give some detections scores equal to the last bit,
  which either package may order first); of each pair, "bits" and "auto"
  binary masks with at most 1e-4 of the pixels differing (a mask logit
  within rounding of 0 may threshold the other way); "q8" soft masks
  within 1/255 + 1e-6 (one code); "exact" within 1e-4.
- Segment `predict_many` (masks copied to the host at drain time) equal to
  `predict`'s masks, read through `LazyMasks` from host arrays.
"""

from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest
from yolo_infer_tpu.core.predictor import Predictor as JaxPredictor
from yolo_infer_tpu.models import build_spec as jax_build_spec
from yolo_infer_tpu.models import fold_model as jax_fold_model
from yolo_infer_tpu.models.convert import convert_state_dict
from yolo_infer_tpu.ops import masks as jmasks
from yolo_infer_tpu_torch.core.predictor import LazyMasks, Predictor
from yolo_infer_tpu_torch.models.convert import load_state_dict
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.ops import masks as tmasks
from yolo_infer_tpu_torch.ops.letterbox import resize_linear_f32
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_CACHE = {}


def _mask_inputs(seed, b=2, md=12, hm=24, wm=32, nm=32, imgsz=128):
    rng = np.random.default_rng(seed)
    proto = rng.normal(0, 1, (b, hm, wm, nm)).astype(np.float32)
    coefs = rng.normal(0, 0.5, (b, md, nm)).astype(np.float32)
    xy = rng.uniform(0, imgsz * 0.7, (b, md, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, imgsz * 0.5, (b, md, 2))], -1).astype(np.float32)
    return proto, coefs, boxes


@pytest.mark.parametrize("seed", [0, 1])
def test_assemble_mask_bits_matches_jax(seed):
    proto, coefs, boxes = _mask_inputs(seed)
    got = tmasks.assemble_mask_bits(*(torch.from_numpy(a) for a in (proto, coefs, boxes)), 128).numpy()
    want = np.asarray(jmasks.assemble_mask_bits(*(jnp.asarray(a) for a in (proto, coefs, boxes)), 128))
    assert got.shape == want.shape == (2, 12, 24, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_assemble_masks_q8_matches_jax(seed):
    proto, coefs, boxes = _mask_inputs(seed)
    got = tmasks.assemble_masks_q8(*(torch.from_numpy(a) for a in (proto, coefs, boxes)), 128).numpy()
    want = np.asarray(jmasks.assemble_masks_q8(*(jnp.asarray(a) for a in (proto, coefs, boxes)), 128))
    assert got.shape == want.shape == (2, 12, 24, 32) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != want).mean() < 1e-3 and 0 < (got > 127).mean() < 1


@pytest.mark.parametrize("src,dst", [((40, 40), (160, 160)), ((20, 30), (40, 60)), ((17, 23), (50, 61)),
                                     ((40, 40), (28, 28)), ((24, 40), (96, 160))])
@pytest.mark.parametrize("channels", [2, 600])
def test_resize_linear_f32_matches_opencv(src, dst, channels):
    x = np.random.default_rng(channels).random(src + (channels,)).astype(np.float32)
    got = resize_linear_f32(x, dst[1], dst[0])
    want = np.concatenate([cv2.resize(x[..., i:i + 128], dst[::-1], interpolation=cv2.INTER_LINEAR)
                           .reshape(dst + (-1,)) for i in range(0, channels, 128)], axis=-1)
    assert got.shape == want.shape == dst + (channels,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _predictors(mask_mode):
    if mask_mode not in _CACHE:
        z = np.load(Path(__file__).parent / "golden" / f"golden_segment_n_v{GOLDEN_VERSION}.npz")
        sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
        nc = int(z["nc"])
        jspec = jax_build_spec("segment", "n", nc=nc)
        params, state = convert_state_dict(sd, jspec)
        jax_pred = JaxPredictor(jax_fold_model(params, state), jspec, compute_dtype=jnp.float32, mask_mode=mask_mode)
        spec = build_spec("segment", "n", nc=nc)
        port = Predictor(load_state_dict(sd, spec), spec, device="cpu", compute_dtype=torch.float32,
                         mask_mode=mask_mode)
        _CACHE[mask_mode] = (jax_pred, port)
    return _CACHE[mask_mode]


def _frames():
    rng = np.random.default_rng(160)
    return [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8), rng.integers(0, 256, (160, 112, 3), dtype=np.uint8)]


def _pair(g, w):
    """For each detection of g, the index of its partner in w (same class,
    box within 1e-3 px, score within 1e-5), each partner used once."""
    used = np.zeros(len(w), bool)
    order = []
    for i in range(len(g)):
        hit = np.nonzero(~used & (w.classes == g.classes[i]) & (np.abs(w.boxes - g.boxes[i]).max(1) <= 1e-3)
                         & (np.abs(w.scores - g.scores[i]) <= 1e-5))[0]
        assert len(hit), f"detection {i} has no partner"
        used[hit[0]] = True
        order.append(int(hit[0]))
    return order


@pytest.mark.parametrize("mode", ["q8", "bits", "exact", "auto"])
def test_mask_mode_matches_jax_predictor(mode):
    jax_pred, port = _predictors(mode)
    frames = _frames()
    want = jax_pred.predict(frames, conf=0.25, iou=0.45, imgsz=160, max_det=100)
    got = port.predict(frames, conf=0.25, iou=0.45, imgsz=160, max_det=100)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0 and g.orig_shape == w.orig_shape
        order = _pair(g, w)
        gm, wm = np.asarray(g.masks), np.asarray(w.masks)[order]
        assert gm.shape == wm.shape == (len(g),) + g.orig_shape and gm.dtype == np.float32
        if mode in ("bits", "auto"):
            assert set(np.unique(gm)) <= {0.0, 1.0} and 0 < gm.mean() < 1
            assert (gm != wm).mean() <= 1e-4
        else:
            assert 0 < gm.max() <= 1 and len(np.unique(gm)) > 2  # soft
            np.testing.assert_allclose(gm, wm, atol=1 / 255 + 1e-6 if mode == "q8" else 1e-4, rtol=0)
    if mode == "auto":  # imgsz 160 < 512: auto is "device"
        device = _predictors("device")[1].predict(frames, conf=0.25, iou=0.45, imgsz=160, max_det=100)
        assert all(isinstance(g.masks, LazyMasks) for g in got)
        for g, d in zip(got, device):
            np.testing.assert_array_equal(g.masks.numpy(), d.masks.numpy())


def test_auto_takes_device_half_from_512_px():
    _, port = _predictors("auto")
    frames = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (1, 512, 512, 3), dtype=np.uint8))
    dets = port.predict_raw(frames, 0.25, 0.45, 512, 20)
    assert dets["mask_bits_up"].shape == (1, 20, 256, 32)  # the imgsz/2 grid


@pytest.mark.parametrize("mode", ["device", "bits"])
def test_segment_predict_many_masks_equal_predict(mode):
    _, port = _predictors(mode)
    rng = np.random.default_rng(7)
    frames = list(rng.integers(0, 256, (5, 120, 160, 3), dtype=np.uint8))
    got = port.predict_many(frames, conf=0.25, imgsz=160, max_det=100, batch_size=3)
    chunks = [frames[:3], frames[3:] + [frames[4]]]  # the last chunk padded as predict_many pads it
    want = [r for c in chunks for r in port.predict(c, conf=0.25, imgsz=160, max_det=100)][:5]
    LazyMasks.prefetch(got)  # host arrays: unpacked in place, no device copy
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        np.testing.assert_array_equal(g.boxes, w.boxes)
        if mode == "device":
            assert isinstance(g.masks, LazyMasks) and g.masks._dev is None
            assert isinstance(g.masks.numpy(), np.ndarray)
        np.testing.assert_array_equal(np.asarray(g.masks), np.asarray(w.masks))


def test_unknown_mask_mode_raises():
    _, port = _predictors("device")
    with pytest.raises(ValueError, match="mask_mode"):
        port.predict_raw(torch.zeros((1, 64, 64, 3), dtype=torch.uint8), 0.25, 0.45, 64, mask_out="soft")
