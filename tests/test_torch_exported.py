"""The port's serving artifacts (core/exported.py) on the CPU.

An artifact is the port's whole serving program on `torch.export`, loaded
without model code. It is held to the port's live predictor bit for bit
(the CPU runs the loaded program op by op, the same ops in the same order),
and to the JAX package's `jax.export` artifact within tests/test_exported.py's
tolerances (scores 1e-5, boxes 0.1 px). conf and iou are runtime inputs: one
artifact serves two threshold pairs, each equal to the live predictor at
that pair. Segment, OBB, pose, static8 and multi_label artifacts equal live;
each of the eight kernel ops passes `torch.library.opcheck`.

Detect and classify, compared across the packages, serve the golden weights
(tests/golden, nc 5): the seeded init scores every anchor alike, so two
packages' last bits reorder its detections. The other artifacts take the
seeded `build_model` init at nc 3 and are compared with the port alone.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest
from yolo_infer_tpu.core.exported import ExportedPredictor as JaxExportedPredictor
from yolo_infer_tpu.core.exported import export_predictor as jax_export_predictor
from yolo_infer_tpu.core.model import YOLO11Model as JaxYOLO11Model
from yolo_infer_tpu.models import build_spec as jax_build_spec
from yolo_infer_tpu.models.convert import convert_state_dict
from yolo_infer_tpu_torch.core.exported import ExportedPredictor, export_predictor, read_meta
from yolo_infer_tpu_torch.core.model import YOLO11Model
from yolo_infer_tpu_torch.models.convert import load_state_dict
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.ops.kernels import (
    attention_fused,
    dfl_decode,
    greedy_nms,
    int8_conv,
    mask_pack,
    nms_fused,
    rotated_nms_fused,
)
from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

IMGSZ = 64


def _golden(task):
    """The port's and the JAX package's YOLO11Model over one task's golden weights (f32, cpu)."""
    z = np.load(Path(__file__).parent / "golden" / f"golden_{task}_n_v{GOLDEN_VERSION}.npz")
    sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
    nc = int(z["nc"])
    spec = build_spec(task, "n", nc=nc)
    port = YOLO11Model.from_params(load_state_dict(sd, spec), task=task, size="n", nc=nc, fused=False,
                                   compute_dtype=torch.float32, device="cpu")
    params, state = convert_state_dict(sd, jax_build_spec(task, "n", nc=nc))
    jax_model = JaxYOLO11Model.from_params(params, task=task, size="n", nc=nc, fused=False, state=state,
                                           names=port.names, compute_dtype=jnp.float32)
    return port, jax_model


@pytest.fixture(scope="module")
def detect(tmp_path_factory):
    """(port model, JAX model, the port's loaded b2/64 artifact, its path)."""
    port, jax_model = _golden("detect")
    path = export_predictor(port, tmp_path_factory.mktemp("exp") / "detect.pt2", batch=2, imgsz=IMGSZ)
    return port, jax_model, ExportedPredictor.load(path), path


def _frames(seed, shape=(2, IMGSZ, IMGSZ, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _assert_dets_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_roundtrip_matches_live_predictor(detect):
    """Bit for bit: the loaded program's dets and Results against live
    `predict_raw` and `predict` on the same frames."""
    port, _, ep, path = detect
    frames = _frames(0)
    got = ep.predict_raw(frames, 0.25, 0.45)
    _assert_dets_equal(got, port.predictor.predict_raw(torch.from_numpy(frames), 0.25, 0.45, IMGSZ))
    assert int(got["num"].min()) > 0  # non-vacuous
    live = port.predict(list(frames), conf=0.25, imgsz=IMGSZ)
    exp = ep.predict(list(frames), conf=0.25)
    for a, b in zip(live, exp):
        np.testing.assert_array_equal(a.boxes, b.boxes)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.classes, b.classes)
        assert b.names == port.names
    meta = read_meta(path)
    assert (meta["task"], meta["batch"], meta["imgsz"], meta["device"], meta["nc"]) == ("detect", 2, IMGSZ, "cpu", 5)


def test_roundtrip_matches_the_jax_artifact(detect, tmp_path):
    """Both packages' artifacts of the same weights on frames that need the
    host letterbox, within the JAX test's tolerances."""
    _, jax_model, ep, _ = detect
    jep = JaxExportedPredictor.load(jax_export_predictor(jax_model, tmp_path / "n.jaxexp", batch=2, imgsz=IMGSZ))
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 255, (80, 60, 3), dtype=np.uint8) for _ in range(2)]
    want = jep.predict(imgs, conf=0.25)
    got = ep.predict(imgs, conf=0.25)
    assert sum(len(r) for r in want) > 0
    for a, b in zip(want, got):
        assert len(a) == len(b)
        np.testing.assert_array_equal(a.classes, b.classes)
        np.testing.assert_allclose(b.scores, a.scores, atol=1e-5)
        np.testing.assert_allclose(b.boxes, a.boxes, atol=0.1)


def test_classify_artifact(tmp_path):
    port, jax_model = _golden("classify")
    ep = ExportedPredictor.load(export_predictor(port, tmp_path / "cls.pt2", batch=1, imgsz=IMGSZ))
    jep = JaxExportedPredictor.load(jax_export_predictor(jax_model, tmp_path / "cls.jaxexp", batch=1, imgsz=IMGSZ))
    img = _frames(2, (IMGSZ, IMGSZ, 3))
    got = ep.predict(img)[0].probs
    np.testing.assert_array_equal(got, port.predict(img, imgsz=IMGSZ)[0].probs)
    np.testing.assert_allclose(got, jep.predict(img)[0].probs, atol=1e-5)


def test_signature_is_enforced(detect):
    _, _, ep, path = detect
    with pytest.raises(ValueError, match="specialized"):
        ep.predict_raw(np.zeros((1, IMGSZ, IMGSZ, 3), np.uint8))
    with pytest.raises(ValueError, match="batch"):
        ep.predict([np.zeros((IMGSZ, IMGSZ, 3), np.uint8)] * 3)
    # an artifact serves on the device it was exported for
    with pytest.raises(RuntimeError, match="serves on cpu.*cannot serve on meta"):
        ExportedPredictor.load(path, device="meta")


def test_conf_and_iou_are_runtime_inputs(detect):
    """One artifact, two threshold pairs: each equals the live predictor at
    that pair, and the two differ (no threshold is baked in)."""
    port, _, ep, _ = detect
    frames = torch.from_numpy(_frames(3))
    outs = []
    for conf, iou in ((0.25, 0.45), (0.4, 0.7)):
        got = {k: v.clone() for k, v in ep.predict_raw(frames, conf, iou).items()}
        _assert_dets_equal(got, port.predictor.predict_raw(frames, conf, iou, IMGSZ))
        # a 0-d tensor threshold is the same program input
        _assert_dets_equal(ep.predict_raw(frames, torch.tensor(conf), torch.tensor(iou)), got)
        outs.append(got)
    assert not torch.equal(outs[0]["num"], outs[1]["num"])


def _task_model(name):
    """The seeded yolo11n model of an artifact case, f32 on the cpu."""
    suffix = {"segment": "-seg", "obb": "-obb", "pose": "-pose"}.get(name, "")
    model = YOLO11Model(f"yolo11n{suffix}", nc=3, device="cpu", compute_dtype=torch.float32)
    if name != "static8":
        return model
    ptq = create_quantizer("ptq", model, {"imgsz": IMGSZ})
    ptq.set_calibration_data([_frames(4)])
    return ptq.optimize()


@pytest.mark.parametrize("name", ["segment", "obb", "pose", "static8", "multi_label"])
def test_task_artifact_matches_live(name, tmp_path):
    model = _task_model(name)
    ml = name == "multi_label"
    ep = ExportedPredictor.load(export_predictor(model, tmp_path / f"{name}.pt2", batch=2, imgsz=IMGSZ,
                                                 multi_label=ml))
    frames = _frames(5)
    got = ep.predict_raw(frames, 1e-4, 0.45)
    _assert_dets_equal(got, model.predictor.predict_raw(torch.from_numpy(frames), 1e-4, 0.45, IMGSZ,
                                                        multi_label=ml))
    assert int(got["num"].min()) > 0
    if name == "segment":  # the masks' Results too (LazyMasks over a copy of the rows in use)
        live = model.predict(list(frames), conf=1e-4, imgsz=IMGSZ)
        exp = ep.predict(list(frames), conf=1e-4)
        for a, b in zip(live, exp):
            np.testing.assert_array_equal(a.masks.numpy(np.uint8), b.masks.numpy(np.uint8))
    if name == "static8":
        assert sum("int8_conv" in str(n.target) for n in ep._module.graph.nodes) > 0  # E's scales are baked in


def _op_cases():
    """(op, args) at small shapes for each of the eight kernel ops, on the CPU."""
    g = torch.Generator().manual_seed(0)
    boxes = torch.rand((2, 40, 2), generator=g) * 50
    xyxy = torch.cat([boxes, boxes + 5 + torch.rand((2, 40, 2), generator=g) * 20], -1)
    valid = torch.rand((2, 40), generator=g) > 0.2
    thr = torch.tensor(0.45)
    gauss = torch.cat([torch.rand((2, 40, 2), generator=g) * 50, torch.rand((2, 40, 2), generator=g) * 20 + 1,
                       torch.rand((2, 40, 1), generator=g)], -1)
    iou = torch.rand((2, 40, 40), generator=g)
    x_q = torch.randint(-127, 128, (1, 6, 6, 16), dtype=torch.int8, generator=g)
    w_q = torch.randint(-127, 128, (8, 3, 3, 16), dtype=torch.int8, generator=g)
    ops = torch.ops.yolo_port
    return {
        "nms_keep": (ops.nms_keep, (xyxy, valid, thr)),
        "attention_qkv": (ops.attention_qkv, (torch.randn((2, 9, 256), generator=g), 2, 32, 64)),
        "rotated_nms_keep": (ops.rotated_nms_keep, (gauss, valid, thr)),
        "upsample4x_threshold_pack": (ops.upsample4x_threshold_pack, (torch.randn((3, 6, 16), generator=g),)),
        "int8_conv": (ops.int8_conv, (x_q, w_q, torch.rand(8, generator=g) * 1e-3, torch.randn(8, generator=g),
                                      20.0, 1, True, torch.bfloat16)),
        "dfl_decode": (ops.dfl_decode, (torch.randn((2, 30, 80), generator=g)[..., 8:72], 16)),
        "greedy_nms_keep": (ops.greedy_nms_keep, (iou, valid, thr)),
        "attention_packed": (ops.attention_packed, (torch.randn((4, 9, 128), generator=g), 32, 64)),
    }


@pytest.mark.parametrize("name", ["nms_keep", "attention_qkv", "rotated_nms_keep", "upsample4x_threshold_pack",
                                  "int8_conv", "dfl_decode", "greedy_nms_keep", "attention_packed"])
def test_kernel_op_passes_opcheck(name):
    """The op's schema, fake (shapes, dtypes, strides) and dispatch agree
    with its real CPU implementation (`torch.library.opcheck`), and the
    public wrapper returns what the op does."""
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
    wrapper = {"nms_keep": nms_fused.nms_keep, "attention_qkv": attention_fused.attention_qkv,
               "rotated_nms_keep": rotated_nms_fused.rotated_nms_keep,
               "upsample4x_threshold_pack": mask_pack.upsample4x_threshold_pack,
               "int8_conv": int8_conv.int8_conv, "dfl_decode": dfl_decode.dfl_decode,
               "greedy_nms_keep": greedy_nms.greedy_nms_keep, "attention_packed": attention_fused.attention_packed}
    if name == "int8_conv":
        got = wrapper[name](*args[:5], stride=args[5], act=args[6], epilogue_dtype=args[7])
    else:
        got = wrapper[name](*args)
    assert torch.equal(got, op(*args))
