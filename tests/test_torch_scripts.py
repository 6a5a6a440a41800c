"""The port's `yolo_infer_tpu_torch/scripts/` against the repo's `scripts/`.

Each JAX script runs in this process (its `main` under a patched
`sys.argv`), the port's through its `main(argv)` with `--device cpu`, on one
`.msgpack` checkpoint that the JAX package wrote (the golden yolo11n detect
weights, nc 5) at 64 px:

  - options: each port script's `--help` lists the JAX script's options
    and positionals, plus `--device`;
  - `export_dynamic`: both files' int8 leaves bit-equal, the f32 scales
    within 1e-6 relative and the unquantized layers' bf16 weights within one
    bf16 step, the printed sizes and ratio equal; each package
    loads the other's file and the port serves it as dynamic int8;
  - `val_matrix` (both models in f32): `confusion_matrix.txt` equal, the
    metrics within 1e-4;
  - `benchmark --int8 --runs 2`: the JAX script's JSON keys;
  - `train`: one QAT epoch from the float checkpoint completes in both
    packages and writes a checkpoint; on the int8 file the JAX script raises
    `TypeError` in its first step (it differentiates the int8 leaves) and
    the port raises `ValueError` before any step.
"""

import contextlib
import io
import json
import re
import runpy
import subprocess
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import TORCH_SUBPROCESS_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import yolo_infer_tpu.core.model as jax_model_module  # noqa: E402
import yolo_infer_tpu_torch.core.model as port_model_module  # noqa: E402
from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest  # noqa: E402
from yolo_infer_tpu.models import build_spec as jax_build_spec  # noqa: E402
from yolo_infer_tpu.models.convert import convert_state_dict  # noqa: E402
from yolo_infer_tpu_torch.scripts import benchmark, export_dynamic, train, val_matrix  # noqa: E402
from yolo_infer_tpu_torch.utils.msgpack import msgpack_restore  # noqa: E402

IMGSZ = 64
SCRIPTS = {"export_dynamic": export_dynamic, "val_matrix": val_matrix, "benchmark": benchmark, "train": train}
JaxYOLO11Model = jax_model_module.YOLO11Model
PortYOLO11Model = port_model_module.YOLO11Model


def run_jax_script(name, argv):
    """`scripts/<name>.py argv` in this process -> (rc, stdout)."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = [f"scripts/{name}.py", *map(str, argv)]
    try:
        with contextlib.redirect_stdout(out):
            rc = runpy.run_path(str(REPO / "scripts" / f"{name}.py"))["main"]()
    finally:
        sys.argv = old
    return rc, out.getvalue()


def run_port_script(name, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = SCRIPTS[name].main([*map(str, argv), "--device", "cpu"])
    return rc, out.getvalue()


class _JaxF32Model(JaxYOLO11Model):
    def __init__(self, *args, **kwargs):
        kwargs["compute_dtype"] = jnp.float32
        super().__init__(*args, **kwargs)


class _PortF32Model(PortYOLO11Model):
    def __init__(self, *args, **kwargs):
        kwargs["compute_dtype"] = torch.float32
        super().__init__(*args, **kwargs)


def write_dataset(root, frames, labels, nc):
    images, label_dir = root / "images" / "val", root / "labels" / "val"
    images.mkdir(parents=True)
    label_dir.mkdir(parents=True)
    for i, frame in enumerate(frames):
        cv2.imwrite(str(images / f"{i}.jpg"), frame[..., ::-1])
        (label_dir / f"{i}.txt").write_text(labels[i])
    data = root / "data.yaml"
    data.write_text(f"path: {root}\ntrain: images/val\nval: images/val\nnames:\n"
                    + "".join(f"  {i}: c{i}\n" for i in range(nc)))
    return data


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX-written golden checkpoint (unfused, with its batch norms), a
    detect set of JPEG frames labelled with the golden model's own f32
    detections, and a one-class set of rectangles for training."""
    root = tmp_path_factory.mktemp("scripts")
    z = np.load(REPO / "tests" / "golden" / f"golden_detect_n_v{GOLDEN_VERSION}.npz")
    sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
    nc = int(z["nc"])
    params, state = convert_state_dict(sd, jax_build_spec("detect", "n", nc=nc))
    jax_model = JaxYOLO11Model.from_params(params, task="detect", size="n", nc=nc, fused=False, state=state,
                                           names={i: f"c{i}" for i in range(nc)}, compute_dtype=jnp.float32)
    ckpt = jax_model.save(root / "golden.msgpack")
    fused = jax_model.save(root / "golden_fused.msgpack", fused=True)
    rng = np.random.default_rng(21)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for shape in ((48, 64, 3), (64, 48, 3), (48, 64, 3),
                                                                        (40, 56, 3))]
    frames = [cv2.imdecode(cv2.imencode(".jpg", f)[1], cv2.IMREAD_COLOR) for f in frames]  # as read back
    labels = []
    for r in jax_model.predict(frames, conf=0.25, imgsz=IMGSZ):
        h, w = r.orig_shape
        rows = [f"{c} {(b[0] + b[2]) / 2 / w:.6f} {(b[1] + b[3]) / 2 / h:.6f} {(b[2] - b[0]) / w:.6f} "
                f"{(b[3] - b[1]) / h:.6f}" for b, c in zip(r.boxes.clip(0, [w, h, w, h]), r.classes)]
        labels.append("\n".join(rows[::2]) + "\n")
    val_data = write_dataset(root / "val", frames, labels, nc)
    rects = []
    for _ in range(4):
        img = np.full((64, 64, 3), 90, np.uint8)
        img[8:48, 8:40] = (255, 40, 40)
        rects.append(img)
    train_data = write_dataset(root / "rects", rects, ["0 0.375 0.4375 0.5 0.625\n"] * 4, 1)
    return {"root": root, "ckpt": ckpt, "fused": fused, "val": val_data, "train": train_data, "nc": nc}


def option_strings(text):
    """(every option string, the positionals in order) of an argparse help
    text, past its "usage:" and the program's name (a worker process's
    `sys.argv[0]` may be "-c")."""
    usage, _, rest = text.partition("\n\n")
    usage = usage.split(None, 2)[2]
    return (set(re.findall(r"(?<![\w-])--?[a-z][\w-]*", usage + rest)),
            re.sub(r"\[[^\]]*\]|--?[a-z][\w-]*\s+\w+", "", usage).split())


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_options_are_the_jax_scripts_plus_device(name, capsys):
    jax_help = subprocess.run([sys.executable, f"scripts/{name}.py", "--help"], capture_output=True, text=True,
                              check=True, cwd=REPO, env=TORCH_SUBPROCESS_ENV, timeout=120).stdout
    with pytest.raises(SystemExit) as done:
        SCRIPTS[name].main(["--help"])
    assert done.value.code == 0
    (jax_opts, jax_pos), (port_opts, port_pos) = option_strings(jax_help), option_strings(capsys.readouterr().out)
    assert port_opts == jax_opts | {"--device"}, (name, port_opts ^ jax_opts)
    assert port_pos == jax_pos, (name, port_pos, jax_pos)


def f64(x):
    return (x.double().numpy() if isinstance(x, torch.Tensor) else x).astype(np.float64)


def leaves(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            yield from leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def exported(world):
    """Both packages' `export_dynamic` of the golden checkpoint, fused and not."""
    root, out = world["root"], {}
    for ckpt in ("fused", "ckpt"):
        for who, run in (("jax", run_jax_script), ("port", run_port_script)):
            path = root / f"{who}_{ckpt}_int8.msgpack"
            rc, text = run("export_dynamic", [world[ckpt], "--output", path])
            out[ckpt, who] = (rc, text, path)
    return out


@pytest.mark.parametrize("ckpt", ["fused", "ckpt"])
def test_export_dynamic_matches_the_jax_script(exported, ckpt):
    """From the fused file both packages quantize the same bf16 weights:
    every leaf is bit-equal. From the unfused file each folds the batch
    norms first, in f32 with its own `rsqrt` (XLA's and torch's differ in
    the last bit), so a weight at a rounding edge may take the next bf16
    value, and its code the next integer."""
    (jax_rc, jax_out, jax_file), (port_rc, port_out, port_file) = exported[ckpt, "jax"], exported[ckpt, "port"]
    assert jax_rc == port_rc == 0
    assert jax_out.replace(str(jax_file), "OUT") == port_out.replace(str(port_file), "OUT")
    assert re.search(r"compression \d+\.\d\dx \(\d+\.\d -> \d+\.\d MB\)", port_out), port_out
    assert jax_file.with_suffix(".info.json").exists() and port_file.with_suffix(".info.json").exists()
    a = dict(leaves(msgpack_restore(jax_file.read_bytes())))
    b = dict(leaves(msgpack_restore(port_file.read_bytes())))
    assert a.keys() == b.keys()
    codes = off = 0
    for key, want in a.items():
        got = b[key]
        if not isinstance(want, (np.ndarray, torch.Tensor)):  # bfloat16 leaves come back as torch tensors
            assert key == "/meta/model_path" or got == want, key
            continue
        assert type(got) is type(want) and got.dtype == want.dtype and tuple(got.shape) == tuple(want.shape), key
        if want.dtype == np.int8:
            diff = np.abs(got.astype(np.int64) - want)
            codes, off = codes + diff.size, off + int((diff > 0).sum())
            assert diff.max() <= (ckpt != "fused"), key
        elif ckpt == "fused":
            assert np.array_equal(f64(got), f64(want)), key
        else:  # the f32 scales to 1e-6, the unquantized layers' bf16 weights to one bf16 step
            rtol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(f64(got), f64(want), rtol=rtol, atol=0, err_msg=key)
    assert codes > 10 ** 6 and off <= codes * 1e-5, (codes, off)


def test_each_package_loads_the_others_dynamic_int8_file(exported):
    for _, _, path in exported.values():
        assert PortYOLO11Model(path, device="cpu").predictor.quant_mode == "dynamic"
        JaxYOLO11Model(str(path)).deploy_params  # noqa: B018 (loads and casts the int8 tree)


def test_val_matrix_matches_the_jax_script(world, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_model_module, "YOLO11Model", _JaxF32Model)
    monkeypatch.setattr(port_model_module, "YOLO11Model", _PortF32Model)
    outs = {}
    for who, run in (("jax", run_jax_script), ("port", run_port_script)):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        rc, text = run("val_matrix", [world["ckpt"], "--data", world["val"], "--imgsz", IMGSZ, "--batch", 2])
        assert rc == 0
        assert text.rstrip().endswith("confusion matrix written to validation_results/confusion_matrix.txt")
        metrics = json.loads(text[: text.rindex("confusion matrix written")])
        outs[who] = (metrics, (tmp_path / who / "validation_results" / "confusion_matrix.txt").read_text())
    (jm, jtxt), (pm, ptxt) = outs["jax"], outs["port"]
    assert ptxt == jtxt and len(jtxt.splitlines()) == world["nc"] + 2
    assert pm.keys() == jm.keys()
    for k in jm:
        assert abs(pm[k] - jm[k]) <= 1e-4, (k, pm[k], jm[k])
    assert jm["mAP50"] > 0


def test_benchmark_prints_the_jax_scripts_keys(tmp_path):
    argv = ["yolo11n", "--imgsz", IMGSZ, "--batch", 1, "--runs", 2, "--int8"]
    jax_rc, jax_out = run_jax_script("benchmark", argv)
    port_rc, port_out = run_port_script("benchmark", argv)
    assert jax_rc == port_rc == 0
    want, got = json.loads(jax_out), json.loads(port_out)
    assert list(got) == list(want) == ["bf16", "int8_dynamic", "speedup"]
    for key in ("bf16", "int8_dynamic"):
        assert {"avg_time_s", "fps", "imgsz", "batch", "runs"} <= got[key].keys() & want[key].keys()
        assert got[key]["imgsz"] == IMGSZ and got[key]["batch"] == 1
    assert got["speedup"] == pytest.approx(got["bf16"]["avg_time_s"] / got["int8_dynamic"]["avg_time_s"])


def without_validation(config_cls):
    class NoValidation(config_cls):
        def __post_init__(self):
            self.val = False
    return NoValidation


def test_train_from_the_float_checkpoint_completes_one_qat_epoch_in_both(world, tmp_path, monkeypatch):
    """The script's config with the epoch's validation off in both packages
    (compiling the JAX package's validation program alone takes ~70 s here;
    the validation paths have their own tests)."""
    import yolo_infer_tpu.core.trainer as jax_trainer
    import yolo_infer_tpu_torch.core.trainer as port_trainer

    for module in (jax_trainer, port_trainer):
        monkeypatch.setattr(module, "TrainingConfig", without_validation(module.TrainingConfig))
    for who, run in (("jax", run_jax_script), ("port", run_port_script)):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        rc, text = run("train", [world["ckpt"], "--data", world["train"], "--epochs", 1, "--batch", 2, "--imgsz",
                                 IMGSZ])
        summary = json.loads(text[text.index("{"):])
        assert rc == 0 and summary["status"] == "completed" and summary["epochs_completed"] == 1, (who, summary)
        assert "history" not in summary
        run_dir = Path(summary["run_dir"])
        assert run_dir.name == "train_from_int8" and run_dir.resolve().parent == (tmp_path / who / "runs" /
                                                                                   "train").resolve()
        assert any((run_dir / "checkpoints").iterdir()), who


def test_train_refuses_the_int8_checkpoint_in_both(world, exported, tmp_path, monkeypatch):
    """The JAX script's first step differentiates the int8 leaves and raises
    TypeError (a reference caveat: its docstring promises a dequantized
    shadow it does not build); the port refuses the fused file before any
    step, saying what it is."""
    import yolo_infer_tpu_torch.core.train_step as port_train_step

    monkeypatch.chdir(tmp_path)
    argv = [exported["fused", "jax"][2], "--data", world["train"], "--epochs", 1, "--batch", 2, "--imgsz", IMGSZ]
    with pytest.raises(TypeError, match="grad requires real- or complex-valued inputs"):
        run_jax_script("train", argv)
    steps = []
    make_step = port_train_step.make_train_step

    def counting_make_train_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def counted(*a, **k):
            steps.append(1)
            return step(*a, **k)
        return counted

    monkeypatch.setattr(port_train_step, "make_train_step", counting_make_train_step)
    for path in (exported["fused", "jax"][2], exported["fused", "port"][2]):
        with pytest.raises(ValueError, match=r"training needs the unfolded model.*fused deploy checkpoint, int8"):
            run_port_script("train", [path, *argv[1:]])
    assert not steps
