"""The port's native checkpoints against the JAX package's, on the CPU.

The port writes flax's msgpack wire format itself (`utils/msgpack.py`): its
bytes equal `flax.serialization.msgpack_serialize`'s for the trees the JAX
package writes, and flax restores them. A file that the JAX package's
`YOLO11Model.save` writes (fused, unfused, with PTQ scales) predicts in the
port as the JAX model does; a file the port writes predicts in the JAX
package. An ultralytics-style `.pt` (tests/torch_ref.py, saved as
tests/test_convert.py saves it) loads as `convert_pt_checkpoint` loads it.
`CheckpointManager` keeps tests/test_wrapper.py's behaviour, across both
packages' files; the safetensors export reads back under
`safetensors.numpy.load_file`.

The detect models serve the golden weights (tests/golden, nc 5) in f32.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest
from torch_ref import TorchYOLO11
from yolo_infer_tpu.core.model import YOLO11Model as JaxYOLO11Model
from yolo_infer_tpu.models import build_spec as jax_build_spec
from yolo_infer_tpu.models import fold_model as jax_fold_model
from yolo_infer_tpu.models.convert import convert_pt_checkpoint, convert_state_dict
from yolo_infer_tpu.nn import quantize as JQ
from yolo_infer_tpu.optimization.quantization.quantizers import PostTrainingQuantizer as JaxPTQ
from yolo_infer_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from yolo_infer_tpu_torch.core.model import YOLO11Model
from yolo_infer_tpu_torch.core.predictor import Predictor
from yolo_infer_tpu_torch.models.convert import load_pt_checkpoint, params_from_jax
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.utils import msgpack as port_msgpack
from yolo_infer_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    load_training_state,
    save_training_state,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

IMGSZ = 64


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trees():
    rng = np.random.default_rng(0)
    return {
        "leaves": {"f32": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                   "bf16": np.asarray(jnp.asarray(rng.standard_normal((2, 5)), jnp.bfloat16)),
                   "s8": rng.integers(-127, 128, (1, 1, 4, 6)).astype(np.int8),
                   "s32": np.arange(300, dtype=np.int32), "empty": np.zeros((0, 3), np.float32)},
        "scalars": {"step": np.int32(7), "lr": np.float32(0.1), "d": np.float64(2.5), "b": np.bool_(True)},
        "meta": {"task": "detect", "size": "n", "nc": 80, "fused": True, "state": None, "f": 1.5, "neg": -300,
                 "big": 2 ** 40, "names": {str(i): f"class {i}" for i in range(90)}, "s": "é" * 40,
                 "nested": {"z": [1, {"b": 2, "a": [np.float32(3)]}], "a": {}}},
    }


@pytest.mark.parametrize("case", ["leaves", "scalars", "meta"])
def test_msgpack_bytes_equal_flax(case):
    """The port's bytes equal flax's; flax restores them, and the port
    restores flax's (bfloat16 as a torch tensor of the same values)."""
    tree = _trees()[case]
    want = serialization.msgpack_serialize(tree)
    got = port_msgpack.msgpack_serialize(tree)
    assert got == want
    back = serialization.msgpack_restore(got)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    mine = port_msgpack.msgpack_restore(want)
    if case == "leaves":
        assert mine["bf16"].dtype == torch.bfloat16
        np.testing.assert_array_equal(mine["bf16"].float().numpy(), tree["bf16"].astype(np.float32))
        np.testing.assert_array_equal(mine["s8"], tree["s8"])
    if case == "scalars":
        assert mine["step"] == 7 and mine["step"].dtype == np.int32
    if case == "meta":
        assert mine == serialization.msgpack_restore(want)


def test_msgpack_chunks_large_arrays_as_flax(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE in dicts are written in flax's chunked
    form (cut here to 64 bytes in both packages) and joined on read."""
    import flax.serialization as fs

    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(port_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"b": {"w": np.arange(100, dtype=np.float32), "a": 1}, "l": [np.arange(50, dtype=np.float32)],
            "a": np.arange(30, dtype=np.float64)}
    got = port_msgpack.msgpack_serialize(tree)
    assert got == fs.msgpack_serialize(tree)
    back = port_msgpack.msgpack_restore(got)
    np.testing.assert_array_equal(back["b"]["w"], tree["b"]["w"])
    np.testing.assert_array_equal(back["a"], tree["a"])


@pytest.fixture(scope="module")
def golden():
    """Golden detect weights: the JAX model (unfolded, f32), the port's
    same-weights model, and frames."""
    z = np.load(Path(__file__).parent / "golden" / f"golden_detect_n_v{GOLDEN_VERSION}.npz")
    sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
    nc = int(z["nc"])
    jspec = jax_build_spec("detect", "n", nc=nc)
    params, state = convert_state_dict(sd, jspec)
    jax_model = JaxYOLO11Model.from_params(params, task="detect", size="n", nc=nc, fused=False, state=state,
                                           names={i: f"c{i}" for i in range(nc)}, compute_dtype=jnp.float32)
    frames = list(np.random.default_rng(1).integers(0, 256, (2, 48, IMGSZ, 3), dtype=np.uint8))
    return SimpleNamespace(jax=jax_model, jspec=jspec, nc=nc, frames=frames, params=params, state=state)


def _same_detections(got, want):
    assert sum(len(r) for r in want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_array_equal(g.classes, w.classes)
        np.testing.assert_allclose(g.boxes, w.boxes, atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.scores, w.scores, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_jax_checkpoint_predicts_in_the_port(golden, fused, tmp_path):
    path = golden.jax.save(tmp_path / "j.msgpack", fused=fused)
    port = YOLO11Model(path, device="cpu", compute_dtype=torch.float32)
    assert (port.task, port.size, port.nc, port.names) == ("detect", "n", golden.nc, golden.jax.names)
    want = golden.jax.predict(golden.frames, conf=0.25, imgsz=IMGSZ)
    _same_detections(port.predict(golden.frames, conf=0.25, imgsz=IMGSZ), want)


@pytest.mark.parametrize("fused", [False, True])
def test_port_checkpoint_predicts_in_jax(golden, fused, tmp_path):
    """A file the port writes loads in the JAX package and predicts as the
    port does. Unfused, it is byte for byte the file the JAX package writes;
    fused, the two packages' batch-norm folds round apart in the last bit,
    so the trees match in structure and to 1e-6."""
    port = YOLO11Model(golden.jax.save(tmp_path / "j.msgpack"), device="cpu", compute_dtype=torch.float32)
    path = port.save(tmp_path / "p.msgpack", fused=fused)
    jax_file = golden.jax.save(tmp_path / "j2.msgpack", fused=fused)
    if not fused:
        assert path.read_bytes() == jax_file.read_bytes()
    mine, theirs = serialization.msgpack_restore(path.read_bytes()), serialization.msgpack_restore(jax_file.read_bytes())
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(theirs)
    for a, b in zip(jax.tree_util.tree_leaves(mine["params"]), jax.tree_util.tree_leaves(theirs["params"])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    back = JaxYOLO11Model(path, compute_dtype=jnp.float32)
    want = port.predict(golden.frames, conf=0.25, imgsz=IMGSZ)
    _same_detections(back.predict(golden.frames, conf=0.25, imgsz=IMGSZ), want)


def test_jax_ptq_checkpoint_serves_static8_in_the_port(golden, tmp_path):
    """A JAX PTQ model's file (the int8 tree and its activation scales)
    loads into the port's int8 deploy form with the same weights and scales,
    and serves static8 as the port's predictor over that tree and those
    scales does (which tests/test_torch_quant.py holds to the JAX package)."""
    qparams = JQ.quantize_params_tree(jax_fold_model(golden.params, golden.state))
    ptq = JaxPTQ(SimpleNamespace(spec=golden.jspec, compute_dtype=jnp.float32), {"imgsz": IMGSZ})
    ptq.set_calibration_data([np.stack(golden.frames)])
    scales = ptq._calibrate(qparams)
    jq = JaxYOLO11Model.from_params(qparams, task="detect", size="n", nc=golden.nc, fused=True,
                                    quant_act_scales=scales, compute_dtype=jnp.float32)
    port = YOLO11Model(jq.save(tmp_path / "q.msgpack"), device="cpu", compute_dtype=torch.float32)
    np.testing.assert_array_equal(port.quant_act_scales, np.asarray(scales))
    spec = build_spec("detect", "n", nc=golden.nc)
    carried = params_from_jax(_np_tree(qparams), spec)
    a, b = port.model.state_dict(), carried.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert sum(k.endswith(".w_q") for k in a) == 72
    want = Predictor(carried, spec, device="cpu", compute_dtype=torch.float32,
                     quant_act_scales=np.asarray(scales)).predict(golden.frames, conf=0.25, imgsz=IMGSZ)
    got = port.predict(golden.frames, conf=0.25, imgsz=IMGSZ)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.boxes, w.boxes)
        np.testing.assert_array_equal(g.scores, w.scores)
    # and the port writes it back as the JAX package wrote it
    assert port.save(tmp_path / "q2.msgpack").read_bytes() == (tmp_path / "q.msgpack").read_bytes()


def test_pt_checkpoint_matches_convert_pt_checkpoint(tmp_path):
    """An ultralytics-style .pt (tests/torch_ref.py's model, saved as
    tests/test_convert.py saves it) loads in the port with the weights and
    meta `convert_pt_checkpoint` reads, and predicts as the JAX package does."""
    torch.manual_seed(0)
    jspec = jax_build_spec("detect", "n", nc=80)
    tmodel = TorchYOLO11(jspec).eval()
    tmodel.names = {i: f"c{i}" for i in range(80)}
    path = tmp_path / "m.pt"
    torch.save({"model": tmodel, "epoch": 0}, path)
    params, meta = convert_pt_checkpoint(path)
    model, spec, pmeta = load_pt_checkpoint(path)
    assert (pmeta["task"], pmeta["size"], pmeta["nc"], pmeta["names"]) == ("detect", "n", 80, meta["names"])
    a = params_from_jax(_np_tree(params), spec, _np_tree(meta["state"])).state_dict()
    b = model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    port = YOLO11Model(path, device="cpu", compute_dtype=torch.float32)
    jax_model = JaxYOLO11Model(path, compute_dtype=jnp.float32)
    img = np.random.default_rng(2).integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
    got = port.predict(img, conf=1e-4, imgsz=IMGSZ)[0]
    want = jax_model.predict(img, conf=1e-4, imgsz=IMGSZ)[0]
    assert len(want) > 0 and got.names == want.names
    # the seeded init scores its anchors alike: compare the best detection and the counts' order of size
    np.testing.assert_allclose(got.scores[0], want.scores[0], atol=1e-5)
    np.testing.assert_allclose(got.boxes[0], want.boxes[0], atol=1e-3)


def test_checkpoint_manager(tmp_path):
    """tests/test_wrapper.py's CheckpointManager case, and each package's
    files read by the other."""
    mgr = CheckpointManager(tmp_path, max_checkpoints=2)
    state = {"params": {"w": np.arange(4, dtype=np.float32)}, "step": np.int32(7),
             "opt": [np.ones(2, np.float32), {"mu": torch.arange(3.0).to(torch.bfloat16)}]}
    for epoch in range(4):
        mgr.save_checkpoint(state, epoch=epoch, metrics={"loss": 1.0 / (epoch + 1)}, is_best=epoch == 2)
    ckpts = mgr.list_checkpoints()
    assert len(ckpts) == 2  # keep-last-N
    latest = mgr.get_latest_checkpoint()
    assert "0003" in latest.name
    restored = mgr.load_checkpoint()
    np.testing.assert_array_equal(restored["train_state"]["params"]["w"], state["params"]["w"])
    assert restored["epoch"] == 3 and restored["metrics"]["loss"] == 0.25
    assert mgr.get_checkpoint_info(latest)["epoch"] == 3
    assert mgr.load_checkpoint(tmp_path / "best.msgpack")["epoch"] == 2
    typed = mgr.load_checkpoint(target=state)["train_state"]
    assert isinstance(typed["opt"], list) and torch.equal(typed["opt"][1]["mu"], state["opt"][1]["mu"])
    # the JAX package reads the port's file, and the port the JAX package's
    jax_state = JaxCheckpointManager(tmp_path).load_checkpoint(latest)["train_state"]
    np.testing.assert_array_equal(jax_state["opt"]["0"], state["opt"][0])
    jmgr = JaxCheckpointManager(tmp_path / "jax", max_checkpoints=2)
    jpath = jmgr.save_checkpoint({"params": {"w": np.arange(4, dtype=np.float32)}, "step": np.int32(7)}, epoch=5)
    assert jpath.read_bytes() == CheckpointManager(tmp_path / "port").save_checkpoint(
        {"params": {"w": np.arange(4, dtype=np.float32)}, "step": np.int32(7)}, epoch=5).read_bytes()
    assert CheckpointManager(tmp_path / "jax").load_checkpoint()["train_state"]["step"] == 7
    save_training_state(tmp_path / "ts.msgpack", state, epoch=9)
    raw = load_training_state(tmp_path / "ts.msgpack")
    assert raw["meta"]["epoch"] == 9 and raw["train_state"]["step"] == 7


def test_save_load_export(golden, tmp_path):
    """save -> load gives identical state; the safetensors export reads back
    under `safetensors.numpy.load_file` as the JAX package's export of the
    same weights (names, f32, values to the folds' last bit: 1e-6)."""
    from safetensors.numpy import load_file

    port = YOLO11Model(golden.jax.save(tmp_path / "j.msgpack"), device="cpu", compute_dtype=torch.float32)
    again = YOLO11Model("yolo11n", nc=3, device="cpu").load(port.save(tmp_path / "p.msgpack"))
    a, b = port.model.state_dict(), again.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert (again.task, again.nc, again.names) == ("detect", golden.nc, port.names)
    got = load_file(str(port.export(tmp_path / "p.safetensors", format="safetensors")))
    want = load_file(str(golden.jax.export(tmp_path / "j.safetensors", format="safetensors")))
    assert got.keys() == want.keys() and len(got) > 100
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unsupported export format"):
        port.export(tmp_path / "p.onnx", format="onnx")


def test_optimized_model_saves_and_loads(tmp_path):
    """A PTQ model through `save_optimized_model` and `load_optimized_model`
    (a fused checkpoint with its scales, and the info JSON beside it) serves
    static8 as before."""
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

    model = YOLO11Model("yolo11n", nc=3, device="cpu", compute_dtype=torch.float32)
    ptq = create_quantizer("ptq", model, {"imgsz": IMGSZ})
    frames = np.random.default_rng(3).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    ptq.set_calibration_data([frames])
    qmodel = ptq.optimize()
    path = ptq.save_optimized_model(tmp_path / "q.msgpack")
    assert (tmp_path / "q.info.json").exists()
    back = ptq.load_optimized_model(path)
    back.device, back.compute_dtype = "cpu", torch.float32
    np.testing.assert_array_equal(back.quant_act_scales, qmodel.quant_act_scales)
    want = qmodel.predictor.predict_raw(torch.from_numpy(frames), 1e-4, 0.45, IMGSZ)
    got = back.predictor.predict_raw(torch.from_numpy(frames), 1e-4, 0.45, IMGSZ)
    assert int(want["num"].min()) > 0 and all(torch.equal(got[k], want[k]) for k in want)
