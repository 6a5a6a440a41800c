"""The live Predictor's program cache (`Predictor._get`, `_build`, `_cache`).

The JAX `Predictor` caches one jitted program per input signature; the port
caches one program per the same key (batch, frame H x W, imgsz,
multi_label, max_det, pre_topk, mask_out, trace env), captured into a CUDA
graph on the card and run eagerly on the CPU. Counterparts of the JAX
package's cache tests: key normalisation (tests/test_masks.py), mixed frame
sizes served by one program (tests/test_predict_tasks.py), `predict_many`
on one signature (tests/test_serving.py); a knob of the trace env builds a
new program; a `predict_raw` result outlives the next call, for the live
predictor and the exported one; cached calls at two thresholds equal the
JAX Predictor (counts and classes equal, boxes within 1e-3 px, scores within
1e-5, as tests/test_torch_serving.py holds them). The port's own rules: the
cache keeps `PROGRAM_CACHE_SIZE` programs, releasing the least recently
used; the validator releases its run's program; `predict` keeps only the
mask rows its detections use.

The `cuda` cases skip here. This module imports jax only inside the tests
that compare with the JAX package, so the card's pass runs it without jax:
`python -m pytest --noconftest tests/test_torch_program_cache.py -m cuda`.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest
from yolo_infer_tpu_torch.core.exported import ExportedPredictor, export_predictor
from yolo_infer_tpu_torch.core.graphs import WARMUP_CALLS
from yolo_infer_tpu_torch.core.model import YOLO11Model
from yolo_infer_tpu_torch.core.predictor import PROGRAM_CACHE_SIZE, TRACE_ENV, LazyMasks, Predictor
from yolo_infer_tpu_torch.core.validator import YOLO11Validator
from yolo_infer_tpu_torch.data.loader import save_image
from yolo_infer_tpu_torch.models.convert import load_state_dict
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.ops.kernels import attention_fused, nms_fused
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _golden(task="detect"):
    z = np.load(Path(__file__).parent / "golden" / f"golden_{task}_n_v{GOLDEN_VERSION}.npz")
    return golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"])), \
        int(z["nc"])


def _port(task="detect", **kw):
    """A fresh port Predictor over the task's golden weights (f32, cpu)."""
    sd, nc = _golden(task)
    spec = build_spec(task, "n", nc=nc)
    return Predictor(load_state_dict(sd, spec), spec, device="cpu", compute_dtype=torch.float32, **kw)


def _jax(task="detect", **kw):
    """The JAX Predictor over the same golden weights (f32)."""
    import jax.numpy as jnp

    from yolo_infer_tpu.core.predictor import Predictor as JaxPredictor
    from yolo_infer_tpu.models import build_spec as jax_build_spec
    from yolo_infer_tpu.models import fold_model as jax_fold_model
    from yolo_infer_tpu.models.convert import convert_state_dict

    sd, nc = _golden(task)
    jspec = jax_build_spec(task, "n", nc=nc)
    params, state = convert_state_dict(sd, jspec)
    return JaxPredictor(jax_fold_model(params, state), jspec, compute_dtype=jnp.float32, **kw)


def _frames(seed, shape=(2, 96, 96, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _eager(pred, frames, conf, iou, imgsz, **kw):
    """The uncaptured serving body on the same inputs: what a program of the cache runs."""
    with torch.inference_mode():
        return pred.serve_program(torch.as_tensor(frames).to(pred.device), pred._dev_scalar(conf, pred.device),
                                  pred._dev_scalar(iou, pred.device), imgsz, **kw)


def _assert_dets_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_cache_key_normalises_mask_out_and_pre_topk():
    """mask_out None and an explicit mask_out equal to mask_mode share one
    entry, as pre_topk None and the predictor's own do; "none" carries no
    mask artifact. The key's layout is the JAX package's (its first seven
    fields equal the JAX key's for the same calls)."""
    seg = _port("segment")
    img = torch.zeros((1, 64, 64, 3), dtype=torch.uint8)
    dets = seg.predict_raw(img, 0.25, 0.45, 64, mask_out="none")
    assert not any(k.startswith("mask") or k == "proto" for k in dets), list(dets)
    seg.predict_raw(img, 0.25, 0.45, 64)  # mask_out=None: the default "device"
    seg.predict_raw(img, 0.25, 0.45, 64, mask_out="device")
    seg.predict_raw(img, 0.25, 0.45, 64, pre_topk=seg.pre_topk)
    keys = [k for k in seg._cache if k[0] == 1 and k[1] == (64, 64) and k[6] == "device"]
    assert len(keys) == 1, keys
    assert len(seg._cache) == 2  # "none" and "device"
    assert not any(k[5] is None or k[6] is None for k in seg._cache), "un-normalised cache key"
    assert all(k[7] == tuple(os.environ.get(n, "") for n in TRACE_ENV) for k in seg._cache)

    port, jax_pred = _port(), _jax()
    for args, kw in (((1, (64, 64), 64, False, 300), {}), ((1, (64, 64), 64, False, 300), {"mask_out": "device"}),
                     ((2, (48, 64), 64, True, 100), {"pre_topk": 512})):
        port._get(*args, **kw)
        jax_pred._get(*args, **kw)  # builds the jitted function; nothing compiles until a call
    assert sorted(k[:7] for k in port._cache) == sorted(k[:7] for k in jax_pred._cache)


def test_mixed_sizes_share_one_program():
    """Frames of three sizes host-letterbox into one (imgsz, imgsz) batch: one program."""
    m = YOLO11Model("yolo11n", device="cpu", compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for h, w in [(96, 128), (64, 64), (80, 100)]]
    res = m.predict(imgs, conf=0.0001, imgsz=64)
    assert len(res) == 3
    assert len(m.predictor._cache) == 1
    for r, im in zip(res, imgs):
        assert r.orig_shape == tuple(im.shape[:2])
        if len(r):
            assert r.boxes[:, [0, 2]].max() <= im.shape[1] + 1e-3
            assert r.boxes[:, [1, 3]].max() <= im.shape[0] + 1e-3


@pytest.mark.parametrize("mixed", [False, True])
def test_predict_many_serves_one_signature(mixed):
    """Every chunk of `predict_many`, the padded last one included, and
    `predict` on a chunk of the same shape run one cached program."""
    port = _port()
    rng = np.random.default_rng(22)
    if mixed:  # host-letterboxed to (96, 96) first
        frames = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in [(72, 96), (96, 64), (50, 96)] * 3]
    else:
        frames = list(_frames(22, (9, 96, 96, 3)))
    many = port.predict_many(frames, conf=0.25, imgsz=96, batch_size=4)
    assert len(many) == 9 and len(port._cache) == 1
    ((batch, hw, *_),) = port._cache
    assert (batch, hw) == (4, (96, 96))
    ref = port.predict(frames[:4], conf=0.25, imgsz=96)
    assert len(port._cache) == 1
    for a, b in zip(many[:4], ref):
        np.testing.assert_array_equal(a.boxes, b.boxes)
        np.testing.assert_array_equal(a.classes, b.classes)


@pytest.mark.parametrize("knob,value,kw", [("YOLO_MULTI_LABEL_TOPC", "1", {"multi_label": True}),
                                           ("YOLO_ATTN_IMPL", "xla", {}), ("YOLO_ATTN_IMPL", "pallas", {})])
def test_a_trace_env_knob_builds_a_new_program(monkeypatch, knob, value, kw):
    """A knob read while the program is built is part of the key: setting it
    on a live predictor adds an entry whose result is the eager body's under
    the new value; unsetting it finds the first entry again."""
    monkeypatch.delenv(knob, raising=False)
    port = _port()
    frames = torch.from_numpy(_frames(30))
    before = port.predict_raw(frames, 0.05, 0.5, 96, **kw)
    monkeypatch.setenv(knob, value)
    after = port.predict_raw(frames, 0.05, 0.5, 96, **kw)
    assert len(port._cache) == 2
    (k0, k1) = port._cache
    assert k0[:7] == k1[:7] and k0[7] != k1[7]
    _assert_dets_equal(after, _eager(port, frames, 0.05, 0.5, 96, **kw))
    if knob == "YOLO_MULTI_LABEL_TOPC":  # one class per anchor instead of eight: other candidates
        assert not all(torch.equal(before[k], after[k]) for k in before)
    monkeypatch.delenv(knob)
    _assert_dets_equal(port.predict_raw(frames, 0.05, 0.5, 96, **kw), before)
    assert len(port._cache) == 2


def _exported(tmp_path):
    port = YOLO11Model("yolo11n", nc=3, device="cpu", compute_dtype=torch.float32)
    return ExportedPredictor.load(export_predictor(port, tmp_path / "detect.pt2", batch=2, imgsz=64))


@pytest.mark.parametrize("which", ["live", "exported"])
def test_predict_raw_result_outlives_the_next_call(tmp_path, which):
    """Two calls on different frames: the first call's dict is unchanged."""
    if which == "live":
        pred = YOLO11Model("yolo11n", nc=3, device="cpu", compute_dtype=torch.float32).predictor
        call = lambda f: pred.predict_raw(torch.from_numpy(f), 1e-4, 0.45, 64)  # noqa: E731
    else:
        ep = _exported(tmp_path)
        call = lambda f: ep.predict_raw(f, 1e-4, 0.45)  # noqa: E731
    first = call(_frames(31, (2, 64, 64, 3)))
    kept = {k: v.clone() for k, v in first.items()}
    second = call(_frames(32, (2, 64, 64, 3)))
    _assert_dets_equal(first, kept)
    assert not torch.equal(first["boxes"], second["boxes"])


def test_cached_calls_match_jax_at_two_thresholds():
    """A sequence of predict_raw calls through one cached program, two
    frame batches at two conf/iou pairs, each equal to the JAX Predictor's
    on the same inputs; each package builds one program."""
    import jax.numpy as jnp

    port, jax_pred = _port(), _jax()
    a, b = _frames(40), _frames(41)
    for frames, conf, iou in ((a, 0.25, 0.45), (b, 0.10, 0.60), (a, 0.10, 0.60), (b, 0.25, 0.45)):
        got = port.predict_raw(torch.from_numpy(frames), conf, iou, 96)
        want = jax_pred.predict_raw(jnp.asarray(frames), conf, iou, 96)
        np.testing.assert_array_equal(got["num"].numpy(), np.asarray(want["num"]))
        assert int(got["num"].sum()) > 0
        for i, n in enumerate(got["num"].tolist()):
            np.testing.assert_array_equal(got["classes"][i, :n].numpy(), np.asarray(want["classes"])[i, :n])
            np.testing.assert_allclose(got["boxes"][i, :n].numpy(), np.asarray(want["boxes"])[i, :n], atol=1e-3,
                                       rtol=0)
            np.testing.assert_allclose(got["scores"][i, :n].numpy(), np.asarray(want["scores"])[i, :n], atol=1e-5,
                                       rtol=0)
    assert len(port._cache) == len(jax_pred._cache) == 1


def test_validation_pads_its_last_batch_into_one_program(tmp_path):
    """Six frames of three sizes at batch 4: the second batch is padded with
    zero frames, so the whole validation runs one program, which the run
    releases when it ends; a serving program built before stays."""
    rng = np.random.default_rng(12)
    (tmp_path / "labels" / "val").mkdir(parents=True)
    for i, hw in enumerate([(96, 64), (72, 96), (96, 80)] * 2):
        save_image(tmp_path / "images" / "val" / f"f{i}.png", rng.integers(0, 256, hw + (3,), dtype=np.uint8))
        (tmp_path / "labels" / "val" / f"f{i}.txt").write_text("0 0.5 0.5 0.2 0.2\n")
    port = _port()
    port.predict_raw(torch.from_numpy(_frames(13, (1, 64, 64, 3))), 0.25, 0.45, 64)
    (serving,) = port._cache
    built = []
    build = port._build
    port._build = lambda *a: built.append(a) or build(*a)
    data = {"path": str(tmp_path), "val": "images/val", "names": {c: f"c{c}" for c in range(port.spec.nc)}}
    out = YOLO11Validator(model=port, output_dir=tmp_path / "out").validate(data, imgsz=64, batch=4, pre_topk=256,
                                                                            verbose=False)
    assert out["num_images"] == 6
    assert len(built) == 1
    ((src_hw, imgsz, multi_label, _, pre_topk, _, batch),) = built
    assert (batch, src_hw, imgsz, multi_label, pre_topk) == (4, (64, 64), 64, True, 256)
    assert list(port._cache) == [serving]


def test_the_cache_releases_its_least_recently_used_program():
    """One signature past `PROGRAM_CACHE_SIZE` releases the program used
    longest ago (a hit counts as a use); `release_programs` empties it."""
    port = _port()
    keys = []
    for h in range(PROGRAM_CACHE_SIZE):
        port._get(1, (64 + h, 64), 64, False, 300)
        keys.append(list(port._cache)[-1])
    first = port._get(1, (64, 64), 64, False, 300)  # a hit: now the most recent
    assert len(port._cache) == PROGRAM_CACHE_SIZE and list(port._cache)[-1] == keys[0]
    port._get(1, (64 + PROGRAM_CACHE_SIZE, 64), 64, False, 300)
    assert len(port._cache) == PROGRAM_CACHE_SIZE
    assert keys[1] not in port._cache and keys[0] in port._cache
    assert port._get(1, (64, 64), 64, False, 300) is first
    port.release_programs([keys[0]])
    assert keys[0] not in port._cache and len(port._cache) == PROGRAM_CACHE_SIZE - 1
    port.release_programs()
    assert not port._cache
    frames = torch.from_numpy(_frames(14, (1, 64, 64, 3)))
    _assert_dets_equal(port.predict_raw(frames, 0.05, 0.5, 64), _eager(port, frames, 0.05, 0.5, 64))


def test_segment_predict_keeps_only_the_mask_rows_in_use():
    """`predict` copies the rows of the device masks its detections use (the
    largest count of the batch), not every max_det row, and the masks equal
    the full `predict_raw` output's rows."""
    seg = _port("segment")
    frames = _frames(15, (2, 96, 96, 3))
    res = seg.predict(frames, conf=0.05, imgsz=96)
    rows = max(len(r) for r in res)
    assert rows > 0
    full = seg.predict_raw(torch.from_numpy(frames), 0.05, 0.45, 96)["mask_bits_up"]
    for i, r in enumerate(res):
        if not len(r):
            continue
        assert isinstance(r.masks, LazyMasks) and tuple(r.masks._dev.shape[:2]) == (2, rows)
        np.testing.assert_array_equal(r.masks._dev[i, : len(r)].numpy(), full[i, : len(r)].numpy())


# ---------------------------------------------------------------- on the card


def _card_predictor(task, dtype=torch.bfloat16, **kw):
    """A Predictor on the card over the task's golden weights (real
    detections at these thresholds; the seeded init scores every anchor
    below 1e-3)."""
    sd, nc = _golden(task)
    spec = build_spec(task, "n", nc=nc)
    return Predictor(load_state_dict(sd, spec), spec, compute_dtype=dtype, **kw)


PAIRS = ((0.05, 0.45), (0.2, 0.6))


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["detect", "segment", "obb", "pose", "classify"])
def test_captured_program_equals_eager_on_the_card(card, task):
    """One capture, two conf/iou pairs: the replay equals the eager body bit
    for bit (the same kernels on the same inputs), one entry in the cache."""
    pred = _card_predictor(task)
    frames = torch.from_numpy(_frames(50, (4, 160, 160, 3))).to(card)
    for conf, iou in PAIRS:
        got = pred.predict_raw(frames, conf, iou, 160)
        _assert_dets_equal(got, _eager(pred, frames, conf, iou, 160))
        assert task == "classify" or int(got["num"].sum()) > 0
    assert len(pred._cache) == 1


@pytest.mark.cuda
def test_capture_launches_once_per_warm_up_and_once_into_the_graph(card):
    """A signature's first call runs its kernels in the warm-up and records
    them into the graph; every later call replays, launching none from Python."""
    pred = _card_predictor("detect")
    frames = torch.from_numpy(_frames(51, (2, 160, 160, 3))).to(card)
    nms_fused.nms_keep.launches = attention_fused.attention_qkv.launches = 0
    pred.predict_raw(frames, *PAIRS[0], 160)
    assert nms_fused.nms_keep.launches == attention_fused.attention_qkv.launches == 1 + WARMUP_CALLS
    pred.predict_raw(frames, *PAIRS[1], 160)
    torch.cuda.synchronize()
    assert nms_fused.nms_keep.launches == attention_fused.attention_qkv.launches == 1 + WARMUP_CALLS


@pytest.mark.cuda
def test_predict_raw_result_outlives_the_next_call_on_the_card(card, tmp_path):
    """The live replay and the exported replay hand back fresh tensors."""
    pred = _card_predictor("segment")
    sd, nc = _golden("detect")
    m = YOLO11Model.from_params(load_state_dict(sd, build_spec("detect", "n", nc=nc)), task="detect", size="n",
                                nc=nc, fused=False)
    ep = ExportedPredictor.load(export_predictor(m, tmp_path / "detect.pt2", batch=2, imgsz=160))
    for call in (lambda f: pred.predict_raw(f, *PAIRS[0], 160), lambda f: ep.predict_raw(f, *PAIRS[0])):
        first = call(torch.from_numpy(_frames(52, (2, 160, 160, 3))).to(card))
        kept = {k: v.clone() for k, v in first.items()}
        second = call(torch.from_numpy(_frames(53, (2, 160, 160, 3))).to(card))
        torch.cuda.synchronize()
        _assert_dets_equal(first, kept)
        assert int(first["num"].sum()) > 0 and not torch.equal(first["boxes"], second["boxes"])


@pytest.mark.cuda
def test_predict_many_replays_one_graph_on_the_card(card):
    """Nine frames in chunks of 2: one capture (its launches only), five
    replays; the Results equal `predict` on the same padded chunks."""
    pred = _card_predictor("detect", dtype=torch.float32)
    frames = list(_frames(54, (9, 120, 160, 3)))
    nms_fused.nms_keep.launches = 0
    got = pred.predict_many(frames, conf=0.05, imgsz=160, max_det=20, batch_size=2)
    assert nms_fused.nms_keep.launches == 1 + WARMUP_CALLS and len(pred._cache) == 1
    chunks = [frames[lo:lo + 2] for lo in range(0, 8, 2)] + [[frames[8], frames[8]]]
    want = [r for c in chunks for r in pred.predict(c, conf=0.05, imgsz=160, max_det=20)][:9]
    assert len(pred._cache) == 1 and sum(len(r) for r in got) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.scores, w.scores)


@pytest.mark.cuda
def test_distinct_frame_sizes_keep_the_reserved_memory_bounded_on_the_card(card):
    """b1 frames of 3 * PROGRAM_CACHE_SIZE heights, one signature each: the
    cache keeps PROGRAM_CACHE_SIZE graphs, and the reserved device memory
    stays within one program's share (`(full - base) / PROGRAM_CACHE_SIZE`)
    of what the full cache reserved; `release_programs` gives it back to
    within that share of `base`."""
    import gc

    pred = _card_predictor("detect")
    frame = _frames(56, (1, 160 + 8 * 3 * PROGRAM_CACHE_SIZE, 160, 3))[0]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    reserved = []
    for i in range(3 * PROGRAM_CACHE_SIZE):
        pred.predict(frame[: 160 + 8 * i], conf=0.05, imgsz=160)
        reserved.append(torch.cuda.memory_reserved())
        assert len(pred._cache) == min(i + 1, PROGRAM_CACHE_SIZE)
    full = reserved[PROGRAM_CACHE_SIZE - 1]
    share = (full - base) / PROGRAM_CACHE_SIZE
    assert share > 0 and max(reserved[PROGRAM_CACHE_SIZE:]) <= full + share, (base, reserved)
    pred.release_programs()
    assert torch.cuda.memory_reserved() <= base + share


@pytest.mark.cuda
def test_a_trace_env_knob_captures_a_new_graph_on_the_card(card, monkeypatch):
    """YOLO_ATTN_IMPL=pallas on a live predictor: a new capture that runs H
    (not B), equal to the eager body under the knob."""
    monkeypatch.delenv("YOLO_ATTN_IMPL", raising=False)
    pred = _card_predictor("detect")
    frames = torch.from_numpy(_frames(55, (2, 160, 160, 3))).to(card)
    pred.predict_raw(frames, *PAIRS[0], 160)
    monkeypatch.setenv("YOLO_ATTN_IMPL", "pallas")
    attention_fused.attention_packed.launches = attention_fused.attention_qkv.launches = 0
    got = pred.predict_raw(frames, *PAIRS[0], 160)
    assert attention_fused.attention_packed.launches == 1 + WARMUP_CALLS
    assert attention_fused.attention_qkv.launches == 0 and len(pred._cache) == 2
    _assert_dets_equal(got, _eager(pred, frames, *PAIRS[0], 160))
