"""The port's command line (`yolo_infer_tpu_torch/cli.py`) against the JAX package's `main.py`.

The same argv goes through `main.YOLO11CLI().run` and the port's
`YOLO11CLI().run` with `--device cpu` appended, on one `.msgpack` checkpoint
that the JAX package wrote (the golden detect weights, nc 5), both in f32:
the JAX package's models are built in f32 here, the port's through the
config's `model.compute_dtype`. The demo's dicts agree within 1e-2 px and
1e-5 (the card's f32 tolerances), validation metrics within 1e-3; config
merging, the exit codes, `optimize --method ptq` (a file the port and the
JAX package load) and `info` are checked too.
"""

import json
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))  # main.py

import main as jax_main  # noqa: E402
import yolo_infer_tpu.core.model as jax_model_module  # noqa: E402
import yolo_infer_tpu.demos.detection_demo as jax_demo_module  # noqa: E402
from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest  # noqa: E402
from yolo_infer_tpu.models import build_spec as jax_build_spec  # noqa: E402
from yolo_infer_tpu.models.convert import convert_state_dict  # noqa: E402
from yolo_infer_tpu_torch import cli as port_cli  # noqa: E402
from yolo_infer_tpu_torch.core.model import YOLO11Model  # noqa: E402

IMGSZ = 64
JaxYOLO11Model = jax_model_module.YOLO11Model


class _JaxF32Model(JaxYOLO11Model):
    """The JAX package's model, built in f32 wherever its CLI builds one."""

    def __init__(self, *args, **kwargs):
        kwargs["compute_dtype"] = jnp.float32
        super().__init__(*args, **kwargs)


@pytest.fixture(autouse=True)
def jax_models_in_f32(monkeypatch):
    monkeypatch.setattr(jax_model_module, "YOLO11Model", _JaxF32Model)
    monkeypatch.setattr(jax_demo_module, "YOLO11Model", _JaxF32Model)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX-written golden checkpoint, a config that sets f32, JPEG
    frames (OpenCV's) and a detect dataset labelled with the golden model's
    own f32 detections."""
    root = tmp_path_factory.mktemp("cli")
    z = np.load(REPO / "tests" / "golden" / f"golden_detect_n_v{GOLDEN_VERSION}.npz")
    sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
    nc = int(z["nc"])
    params, state = convert_state_dict(sd, jax_build_spec("detect", "n", nc=nc))
    jax_model = JaxYOLO11Model.from_params(params, task="detect", size="n", nc=nc, fused=False, state=state,
                                           names={i: f"c{i}" for i in range(nc)}, compute_dtype=jnp.float32)
    ckpt = jax_model.save(root / "golden.msgpack")
    config = root / "f32.yaml"
    config.write_text("model:\n  compute_dtype: float32\n")
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for shape in ((48, 64, 3), (64, 48, 3), (48, 64, 3),
                                                                        (40, 56, 3))]
    images = root / "ds" / "images" / "val"
    labels = root / "ds" / "labels" / "val"
    images.mkdir(parents=True)
    labels.mkdir(parents=True)
    for i, frame in enumerate(frames):
        cv2.imwrite(str(images / f"{i}.jpg"), frame[..., ::-1])
    for i, r in enumerate(jax_model.predict([cv2.imread(str(images / f"{i}.jpg"))[..., ::-1] for i in range(4)],
                                            conf=0.25, imgsz=IMGSZ)):
        h, w = r.orig_shape
        rows = [f"{c} {(b[0] + b[2]) / 2 / w:.6f} {(b[1] + b[3]) / 2 / h:.6f} {(b[2] - b[0]) / w:.6f} "
                f"{(b[3] - b[1]) / h:.6f}" for b, c in zip(r.boxes.clip(0, [w, h, w, h]), r.classes)]
        (labels / f"{i}.txt").write_text("\n".join(rows[::2]) + "\n")
    data = root / "ds" / "data.yaml"
    data.write_text(f"path: {root / 'ds'}\ntrain: images/val\nval: images/val\nnames:\n"
                    + "".join(f"  {i}: c{i}\n" for i in range(nc)))
    return {"root": root, "ckpt": ckpt, "config": config, "images": images, "data": data, "nc": nc}


def run_both(argv, capsys):
    """(rc, stdout) of the JAX CLI and of the port's, on the same argv."""
    capsys.readouterr()
    jax_rc = jax_main.YOLO11CLI().run(list(argv))
    jax_out = capsys.readouterr().out
    port_rc = port_cli.YOLO11CLI().run(list(argv) + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    return (jax_rc, jax_out), (port_rc, port_out)


def assert_same_demo(got, want):
    assert got["num_detections"] == want["num_detections"] > 0
    assert got["classes"] == want["classes"]
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-2, rtol=0)
    np.testing.assert_allclose(got["confidences"], want["confidences"], atol=1e-5, rtol=0)


def test_demo_image_matches_the_jax_cli(world, tmp_path, capsys):
    image = world["images"] / "0.jpg"
    (jax_rc, jax_out), _ = run_both(["--config", str(world["config"]), "demo", "--input", str(image),
                                     "--model-path", str(world["ckpt"]), "--imgsz", str(IMGSZ), "--conf", "0.25",
                                     "--output", str(tmp_path / "jax.jpg")], capsys)
    port_rc = port_cli.YOLO11CLI().run(["--config", str(world["config"]), "demo", "--input", str(image),
                                        "--model-path", str(world["ckpt"]), "--imgsz", str(IMGSZ), "--conf", "0.25",
                                        "--output", str(tmp_path / "port.jpg"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert jax_rc == port_rc == 0
    assert_same_demo(json.loads(port_out), json.loads(jax_out))
    annotated = cv2.imread(str(tmp_path / "port.jpg"))
    assert annotated is not None and annotated.shape == cv2.imread(str(tmp_path / "jax.jpg")).shape


def test_demo_directory_runs_every_image_as_the_jax_cli_runs_each(world, tmp_path, capsys):
    rc = port_cli.YOLO11CLI().run(["--config", str(world["config"]), "demo", "--input", str(world["images"]),
                                   "--model-path", str(world["ckpt"]), "--imgsz", str(IMGSZ), "--conf", "0.25",
                                   "--output", str(tmp_path / "out"), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert rc == 0 and got["num_images"] == 4 and set(got["host_s"]) == {"decode", "predict", "draw", "encode"}
    for entry in got["images"]:
        assert jax_main.YOLO11CLI().run(["demo", "--input", entry["image"], "--model-path", str(world["ckpt"]),
                                         "--imgsz", str(IMGSZ), "--conf", "0.25"]) == 0
        assert_same_demo(entry, json.loads(capsys.readouterr().out))
        assert (tmp_path / "out" / Path(entry["image"]).name).exists()


def test_val_metrics_match_the_jax_cli(world, tmp_path, capsys):
    (jax_rc, jax_out), (port_rc, port_out) = run_both(
        ["--config", str(world["config"]), "val", "--data", str(world["data"]), "--model-path", str(world["ckpt"]),
         "--imgsz", str(IMGSZ), "--batch", "2", "--output-dir", str(tmp_path), "--save-json"], capsys)
    assert jax_rc == port_rc == 0
    want, got = json.loads(jax_out), json.loads(port_out)
    assert got["num_images"] == want["num_images"] == 4
    assert want["metrics"]["mAP50"] > 0.5
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-3, k


def test_config_merging_threads_imgsz_and_conf(world, tmp_path, capsys):
    """A config's inference.imgsz and demo.conf_threshold reach the demo
    when no flag names them (CLI flag > config > default), in both CLIs."""
    config = tmp_path / "c.yaml"
    config.write_text("model:\n  compute_dtype: float32\ninference:\n  imgsz: 64\ndemo:\n  conf_threshold: 0.25\n")
    image = str(world["images"] / "2.jpg")
    base = ["demo", "--input", image, "--model-path", str(world["ckpt"])]
    (jax_rc, jax_out), (port_rc, port_out) = run_both(["--config", str(config)] + base, capsys)
    assert jax_rc == port_rc == 0
    assert_same_demo(json.loads(port_out), json.loads(jax_out))
    explicit = port_cli.YOLO11CLI().run(["--config", str(world["config"])] + base
                                        + ["--imgsz", "64", "--conf", "0.25", "--device", "cpu"])
    assert explicit == 0 and json.loads(capsys.readouterr().out)["boxes"] == json.loads(port_out)["boxes"]


@pytest.mark.parametrize("case", ["missing_input", "unknown_model", "info"])
def test_exit_codes_match_the_jax_cli(world, tmp_path, capsys, case):
    argv = {"missing_input": ["demo", "--input", str(tmp_path / "missing.jpg"), "--model-path", str(world["ckpt"])],
            "unknown_model": ["val", "--data", str(world["data"]), "--model-path", "not-a-model"],
            "info": ["info"]}[case]
    (jax_rc, _), (port_rc, _) = run_both(argv, capsys)
    assert jax_rc == port_rc == {"missing_input": 2, "unknown_model": 1, "info": 0}[case]


@pytest.mark.parametrize("argv", [["train", "--data", "data.yaml", "--qat"], ["optimize", "--method", "dynamic"],
                                  ["optimize", "--method", "qat"], ["optimize", "--method", "prune"],
                                  ["optimize", "--method", "distill"]])
def test_unported_commands_exit_1_with_a_roadmap_pointer(argv, world, tmp_path, capsys, monkeypatch):
    """These commands exited 1 citing ROADMAP Queue 1 items 6 and 7 until
    their methods were ported; now each exits as `main.py` does on the same
    argv: a QAT run on a missing dataset and QAT without data fail (1),
    distill without data exits 2, dynamic and prune save their model (0)."""
    monkeypatch.chdir(tmp_path)
    want = {"train": 1, "dynamic": 0, "qat": 1, "prune": 0, "distill": 2}[argv[2] if argv[0] == "optimize" else "train"]
    if argv[0] == "optimize":
        argv = argv + ["--model-path", str(world["ckpt"])]
    (jax_rc, _), (port_rc, _) = run_both(argv, capsys)
    assert port_rc == jax_rc == want


def test_optimize_ptq_writes_a_file_the_port_and_jax_load(world, tmp_path, capsys):
    out = tmp_path / "q.msgpack"
    rc = port_cli.YOLO11CLI().run(["--config", str(world["config"]), "optimize", "--method", "ptq", "--model-path",
                                   str(world["ckpt"]), "--imgsz", str(IMGSZ), "--calibration-batches", "2",
                                   "--output", str(out), "--device", "cpu"])
    info = json.loads(capsys.readouterr().out)
    assert rc == 0 and info["saved"] == str(out) and out.exists()
    port = YOLO11Model(out, device="cpu", compute_dtype=torch.float32)
    assert port.quant_act_scales is not None and port.quant_act_scales.shape == (72, 2)
    frame = cv2.imread(str(world["images"] / "0.jpg"))[..., ::-1]
    assert len(port.predict(frame, conf=0.01, imgsz=IMGSZ)[0]) > 0
    assert JaxYOLO11Model(out).quant_act_scales.shape == (72, 2)


def test_info_names_the_dependencies(capsys):
    assert port_cli.YOLO11CLI().run(["info", "--device", "cpu"]) == 0
    info = json.loads(capsys.readouterr().out)
    deps = info["dependencies"]
    assert deps["torch"] and deps["numpy"] and set(deps) == {"torch", "numpy", "cuda", "nvcc", "yaml (optional)"}
    assert "devices" in info and "python_version" in info


def test_module_entry_point_runs(tmp_path):
    import subprocess

    from torch_threads import TORCH_SUBPROCESS_ENV

    proc = subprocess.run([sys.executable, "-m", "yolo_infer_tpu_torch", "info", "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=120, env=TORCH_SUBPROCESS_ENV)
    assert proc.returncode == 0 and json.loads(proc.stdout)["dependencies"]["torch"]


def test_convert_to_file_writes_the_jax_package_file(tmp_path):
    """An ultralytics-style `.pt` (tests/torch_ref.py's model) converts to the
    `.msgpack` the JAX package's `convert_to_file` writes, byte for byte."""
    from torch_ref import TorchYOLO11
    from yolo_infer_tpu.models.convert import convert_to_file as jax_convert_to_file
    from yolo_infer_tpu_torch.models.convert import convert_to_file

    torch.manual_seed(0)
    tmodel = TorchYOLO11(jax_build_spec("detect", "n", nc=80)).eval()
    tmodel.names = {i: f"c{i}" for i in range(80)}
    pt = tmp_path / "m.pt"
    torch.save({"model": tmodel, "epoch": 0}, pt)
    assert convert_to_file(pt) == tmp_path / "m.msgpack"
    want = jax_convert_to_file(pt, tmp_path / "jax.msgpack")
    assert (tmp_path / "m.msgpack").read_bytes() == want.read_bytes()


@pytest.mark.parametrize("fmt", ["msgpack", "safetensors", "torchexport"])
def test_export_entry_writes_each_format(world, tmp_path, capsys, fmt):
    """`python -m yolo_infer_tpu_torch.export` (the counterpart of
    scripts/model_export.py): each format loads back and serves as the model does."""
    from yolo_infer_tpu_torch import export
    from yolo_infer_tpu_torch.core.exported import ExportedPredictor
    from yolo_infer_tpu_torch.utils.safetensors import load_file

    out = tmp_path / f"m.{'pt2' if fmt == 'torchexport' else fmt}"
    assert export.main([str(world["ckpt"]), "--format", fmt, "--imgsz", str(IMGSZ), "--output", str(out),
                        "--device", "cpu"]) == 0
    assert str(out) in capsys.readouterr().out
    model = YOLO11Model(world["ckpt"], device="cpu")
    frames = np.stack([cv2.imread(str(world["images"] / "0.jpg"))[..., ::-1]])
    if fmt == "msgpack":
        back = YOLO11Model(out, device="cpu")
        a, b = back.predict(frames, conf=0.25, imgsz=IMGSZ)[0], model.predict(frames, conf=0.25, imgsz=IMGSZ)[0]
        assert len(a) == len(b) > 0 and np.array_equal(a.boxes, b.boxes)
    elif fmt == "safetensors":
        tensors, meta = load_file(out)
        assert meta["task"] == "detect" and meta["nc"] == str(world["nc"]) and len(tensors) > 100
    else:  # the artifact serves one signature: (1, IMGSZ, IMGSZ, 3) frames
        square = np.random.default_rng(3).integers(0, 256, (1, IMGSZ, IMGSZ, 3), dtype=np.uint8)
        got = ExportedPredictor.load(out).predict_raw(square, 0.25, 0.45)
        want = model.predictor.predict_raw(torch.from_numpy(square), 0.25, 0.45, IMGSZ)
        assert all(torch.equal(got[k], want[k]) for k in want) and int(got["num"][0]) > 0


def test_val_of_a_classify_model_evaluates_its_class_tree(tmp_path, capsys):
    """`val` on a classify checkpoint runs `evaluate_classifier` over a
    class-per-directory tree (the JAX package's validator takes detection
    tasks only)."""
    from yolo_infer_tpu_torch.data.classify import ClassifyDataset, evaluate_classifier
    from yolo_infer_tpu_torch.data.loader import save_image

    rng = np.random.default_rng(4)
    for c in range(2):
        for i in range(3):
            save_image(tmp_path / "cls" / "val" / f"c{c}" / f"{i}.jpg", rng.integers(0, 256, (40, 52, 3), np.uint8))
    ckpt = YOLO11Model("yolo11n-cls", nc=2, device="cpu").save(tmp_path / "cls.msgpack")
    config = tmp_path / "f32.yaml"
    config.write_text("model:\n  compute_dtype: float32\n")
    rc = port_cli.YOLO11CLI().run(["--config", str(config), "val", "--data", str(tmp_path / "cls"), "--model-path",
                                   str(ckpt), "--imgsz", "32", "--batch", "4", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    want = evaluate_classifier(YOLO11Model(ckpt, device="cpu", compute_dtype=torch.float32),
                               ClassifyDataset(tmp_path / "cls", "val"), imgsz=32, batch=4)
    assert rc == 0 and got == json.loads(json.dumps(want, default=float)) and got["num_images"] == 6
