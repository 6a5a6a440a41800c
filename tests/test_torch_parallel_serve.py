"""The port's meshed `Predictor` on the CPU: two gloo processes, each serving
its half of every batch (`tests/torch_dist.py serve_ranks`), against the JAX
package's meshed predictor over a 2-device mesh (`tests/test_serving.py`'s
cases: num equal, scores within 1e-5, boxes within 1e-2 px, masks equal) and
against the port's own one-process predictor, for every task.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest
from torch_dist import TIMEOUT_S, serve_ranks, write_rect_dataset
from torch_threads import one_torch_thread  # noqa: F401
from yolo_infer_tpu.core.predictor import Predictor as JaxPredictor
from yolo_infer_tpu.models import build_model as jax_build_model
from yolo_infer_tpu.models import build_spec as jax_build_spec
from yolo_infer_tpu.models import fold_model as jax_fold_model
from yolo_infer_tpu.models.convert import convert_state_dict
from yolo_infer_tpu.parallel.mesh import create_mesh as jax_create_mesh
from yolo_infer_tpu_torch.core.predictor import SERVE_POOL, Predictor
from yolo_infer_tpu_torch.data.loader import save_image
from yolo_infer_tpu_torch.models.convert import load_state_dict, params_from_jax
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.models.yolo11 import build_model
from yolo_infer_tpu_torch.parallel.distributed import launch

TASK_NC = {"detect": 80, "pose": 1, "obb": 15, "classify": 10}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def frames(n, seed=0, hw=(64, 64)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (n, *hw, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_models():
    """Folded JAX yolo11n detect (seeded, nc 80) and segment (the golden
    weights of tests/golden, nc 5) and their port copies. The seeded
    segment init puts its mask logits near 0, where the last bit of two
    float implementations flips a pixel at the 0.5 threshold; on the golden
    weights the port's masks equal the JAX package's bit for bit."""
    params, state, spec = jax_build_model(jax.random.PRNGKey(0), "detect", "n", TASK_NC["detect"])
    deploy = jax_fold_model(params, state)
    out = {"detect": (deploy, spec, params_from_jax(np_tree(deploy), build_spec("detect", "n", TASK_NC["detect"])))}
    z = np.load(Path(__file__).parent / "golden" / f"golden_segment_n_v{GOLDEN_VERSION}.npz")
    sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
    jspec = jax_build_spec("segment", "n", nc=int(z["nc"]))
    params, state = convert_state_dict(sd, jspec)
    out["segment"] = (jax_fold_model(params, state), jspec, load_state_dict(sd, build_spec("segment", "n", int(z["nc"]))))
    return out


def write_classify_tree(root):
    rng = np.random.default_rng(3)
    for c in range(3):
        for i in range(3):
            save_image(root / "val" / f"c{c}" / f"{i}.png", rng.integers(0, 255, (48, 56, 3), dtype=np.uint8))
    return root


def label_with(pred, data):
    """Labels of the detect val split: each image's three best detections of
    `pred` (at conf 0: the seeded model scores low), so that the metrics
    do not all read 0."""
    from yolo_infer_tpu_torch.data.loader import load_image

    root = data.parent
    for img in sorted((root / "images" / "val").glob("*.png")):
        im = load_image(img)
        r = pred.predict(im, conf=0.0, imgsz=64)[0]
        h, w = im.shape[:2]
        rows = [f"{int(c)} {(b[0] + b[2]) / 2 / w:.6f} {(b[1] + b[3]) / 2 / h:.6f} {(b[2] - b[0]) / w:.6f} "
                f"{(b[3] - b[1]) / h:.6f}" for b, c in zip(r.boxes[:3], r.classes[:3])]
        (root / "labels" / "val" / f"{img.stem}.txt").write_text("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def served(jax_models, tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_serve")
    models = {t: jax_models[t][2] for t in ("detect", "segment")}
    for task in ("pose", "obb", "classify"):
        models[task] = build_model(task, "n", TASK_NC[task], seed=0)[0]
    models["val_detect"] = build_model("detect", "n", 2, seed=0)[0]
    data = write_rect_dataset(root / "data", n_train=1, n_val=4)
    label_with(Predictor(models["val_detect"], models["val_detect"].spec, device="cpu", compute_dtype=torch.float32),
               data)
    seg_frames = [frames(1, seed=i)[0] for i in range(8)]
    args = (models, frames(8), seg_frames, frames(10, seed=5), data, write_classify_tree(root / "cls"))
    return seg_frames, launch(serve_ranks, 2, args=args, timeout_s=TIMEOUT_S)


def assert_dets_close(got, want, box_tol=1e-2, score_tol=1e-5):
    np.testing.assert_array_equal(got["num"], want["num"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=score_tol)
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=box_tol)


def assert_results_close(got, want, box_tol=1e-2, score_tol=1e-5):
    assert [len(r["scores"]) for r in got] == [len(r["scores"]) for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["classes"], b["classes"])
        np.testing.assert_allclose(a["boxes"], b["boxes"], atol=box_tol)
        np.testing.assert_allclose(a["scores"], b["scores"], atol=score_tol)


def test_meshed_results_are_the_whole_batch_on_every_rank(served):
    _, (r0, r1) = served
    for task in ("detect", "pose", "obb", "classify"):
        for k, v in r0[task]["meshed"].items():
            assert v.shape[0] == 8 and np.array_equal(v, r1[task]["meshed"][k]), (task, k)
    assert len(r0["many"]["meshed"]) == 10 and len(r0["segment"]["meshed"]) == 8
    for key in ("segment", "many", "predict"):
        for a, b in zip(r0[key]["meshed"], r1[key]["meshed"]):
            assert all(np.array_equal(a[f], b[f]) for f in ("boxes", "scores", "classes"))
            assert (a["masks"] is None) == (b["masks"] is None)
            assert a["masks"] is None or np.array_equal(a["masks"], b["masks"])


def test_meshed_detect_matches_jax_meshed_predictor(served, jax_models):
    deploy, spec, _ = jax_models["detect"]
    sharded = JaxPredictor(deploy, spec, compute_dtype=jnp.float32, mesh=jax_create_mesh(n_devices=2))
    want = np_tree(sharded.predict_raw(jnp.asarray(frames(8)), 0.0001, 0.5, 64))
    _, (r0, _) = served
    assert_dets_close(r0["detect"]["meshed"], want)
    assert int(want["num"].sum()) > 0


def test_meshed_segment_masks_equal_jax_meshed_predictor(served, jax_models):
    deploy, spec, _ = jax_models["segment"]
    seg_frames, (r0, _) = served
    sharded = JaxPredictor(deploy, spec, compute_dtype=jnp.float32, mesh=jax_create_mesh(n_devices=2))
    want = sharded.predict(seg_frames, conf=0.001, imgsz=64)
    got = r0["segment"]["meshed"]
    assert [len(r) for r in want] == [len(r["scores"]) for r in got] and any(len(r) for r in want)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g["boxes"], w.boxes, atol=1e-2)
        np.testing.assert_allclose(g["scores"], w.scores, atol=1e-5)
        if w.masks is None:
            assert g["masks"] is None
        else:
            np.testing.assert_array_equal(g["masks"], np.asarray(w.masks))


def test_meshed_predictor_matches_the_one_process_predictor(served):
    """Every task: each rank runs its half through the one-process program
    (the select-then-decode tail over min(pre_topk, 384) for detect), so
    the gathered results equal the one-process predictor's on the whole
    batch."""
    _, (r0, _) = served
    for task in ("detect", "pose", "obb"):
        assert_dets_close(r0[task]["meshed"], r0[task]["single"])
    np.testing.assert_allclose(r0["classify"]["meshed"]["probs"], r0["classify"]["single"]["probs"], atol=1e-6)
    assert_results_close(r0["segment"]["meshed"], r0["segment"]["single"])
    for a, b in zip(r0["segment"]["meshed"], r0["segment"]["single"]):
        assert (a["masks"] is None and b["masks"] is None) or np.array_equal(a["masks"], b["masks"])
    assert_results_close(r0["predict"]["meshed"], r0["predict"]["single"])
    assert_results_close(r0["many"]["meshed"], r0["many"]["single"], box_tol=1e-3)


def test_meshed_detect_serves_the_one_process_tail(served):
    """At 192 px (756 anchors, more candidates at conf 0 than the serve pool
    holds) each rank's slice reaches the keep mask (kernel A on the card) at
    K = 384, as the one-process predictor's batch does, and the gathered
    detections are the one-process ones."""
    _, (r0, r1) = served
    for r in (r0, r1):
        assert r["pool"]["meshed"]["keep_inputs"] == [(1, SERVE_POOL, 4)]
        assert r["pool"]["single"]["keep_inputs"] == [(2, SERVE_POOL, 4)]
    assert_dets_close(r0["pool"]["meshed"]["dets"], r0["pool"]["single"]["dets"])
    assert int(r0["pool"]["single"]["dets"]["num"].sum()) > 0


def test_meshed_batch_not_divisible_by_the_data_axis_raises(served):
    _, (r0, _) = served
    assert "divisible by the data axis (2)" in r0["odd_batch"]


def test_validator_and_classify_evaluation_take_a_meshed_predictor(served):
    """Their metrics are equal on both ranks and equal to the one-process
    predictor's."""
    _, (r0, r1) = served
    assert r0["val"]["meshed"] == r1["val"]["meshed"]
    for k, v in r0["val"]["single"].items():
        np.testing.assert_allclose(r0["val"]["meshed"][k], v, atol=1e-6, err_msg=k)
    assert r0["val"]["single"]["mAP50"] > 0
    assert r0["classify_eval"]["meshed"] == r1["classify_eval"]["meshed"] == r0["classify_eval"]["single"]
