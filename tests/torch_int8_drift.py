"""How far int8 (static8) outputs drift, on the CPU: the figures PERF.md cites.

Run from the repository root: `JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
tests/torch_int8_drift.py` (about a minute). It prints one JSON line per
measurement:

  sigmoid   the share of bf16 elements where a one-rounding sigmoid differs
            from XLA's bf16 `logistic` (exp, sum and reciprocal each rounded)
  jax_drift the golden yolo11n detect weights in static8 at 96 px (f32
            compute, C=64 convs int8 too): mean |diff| / mean |map| of the
            head maps between JAX's jitted and eager forwards, and between
            the port and the jitted forward
  weights   yolo11n at 160 px (the port alone): head error of static8 and
            bf16 against f32, for the seeded init with batch-norm statistics
            calibrated to unit scale and for the seeded init as it is with
            the head rescaled (chip_smoke.py's int8 weights); and the bf16
            model's mAP50 against its own labels (conf 0.25) validated
            multi-label at iou 0.6 (the val defaults) and single-label at
            iou 0.45 (the settings that made the labels)
"""

import json
import os
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]
os.environ["YOLO_INT8_C64_MIN_ROWS"] = "25000"  # the 640 px rows rule, scaled to 160 px

import chip_smoke  # noqa: E402
from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest  # noqa: E402
from yolo_infer_tpu.models import build_spec as jax_build_spec  # noqa: E402
from yolo_infer_tpu.models import fold_model as jax_fold_model  # noqa: E402
from yolo_infer_tpu.models import forward as jax_forward  # noqa: E402
from yolo_infer_tpu.models.convert import convert_state_dict  # noqa: E402
from yolo_infer_tpu.nn import quantize as JQ  # noqa: E402
from yolo_infer_tpu.optimization.quantization.quantizers import PostTrainingQuantizer as JaxPTQ  # noqa: E402
from yolo_infer_tpu_torch import YOLO11Model  # noqa: E402
from yolo_infer_tpu_torch.core.validator import YOLO11Validator  # noqa: E402
from yolo_infer_tpu_torch.models.blocks import Conv  # noqa: E402
from yolo_infer_tpu_torch.models.convert import params_from_jax  # noqa: E402
from yolo_infer_tpu_torch.models.spec import build_spec  # noqa: E402
from yolo_infer_tpu_torch.models.yolo11 import build_model  # noqa: E402
from yolo_infer_tpu_torch.nn import quantize as Q  # noqa: E402
from yolo_infer_tpu_torch.ops.preprocess import preprocess_batch  # noqa: E402
from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer  # noqa: E402


def rel(a, b):
    return [float(np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32)).mean()
                  / np.abs(np.asarray(x, np.float32)).mean()) for x, y in zip(a, b)]


def sigmoid_share():
    y = np.random.default_rng(0).normal(0, 3, 200_000).astype(np.float32)
    xla = np.asarray(jax.nn.sigmoid(jnp.asarray(y, jnp.bfloat16)), np.float32)
    one = torch.sigmoid(torch.from_numpy(y).to(torch.bfloat16)).float().numpy()
    return {"measure": "sigmoid", "one_rounding_differs_share": float((xla != one).mean())}


def jax_drift():
    z = np.load(REPO / "tests" / "golden" / f"golden_detect_n_v{GOLDEN_VERSION}.npz")
    sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
    jspec = jax_build_spec("detect", "n", nc=int(z["nc"]))
    qparams = JQ.quantize_params_tree(jax_fold_model(*convert_state_dict(sd, jspec)))
    rng = np.random.default_rng(7)
    ptq = JaxPTQ(type("M", (), {"spec": jspec, "compute_dtype": jnp.float32}), {"imgsz": 96})
    ptq.set_calibration_data([rng.integers(0, 256, (2, 72, 96, 3), dtype=np.uint8) for _ in range(2)])
    scales = ptq._calibrate(qparams)
    x = np.random.default_rng(8).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    outs = {}
    for mode in ("jit", "eager"):
        ctx = JQ.QuantContext("static8", act_scales=jnp.asarray(scales))
        ctx.int8_c64_min_rows = 1
        fn = lambda p, xx: jax_forward(p, None, jspec, xx, compute_dtype=jnp.float32)  # noqa: E731
        with JQ.quant_context(ctx):
            outs[mode] = (jax.jit(fn) if mode == "jit" else fn)(qparams, jnp.asarray(x))[0]["feats"]
    port = params_from_jax(jax.tree_util.tree_map(np.asarray, qparams), build_spec("detect", "n", nc=int(z["nc"])))
    with torch.no_grad(), Q.quant_context(Q.QuantContext("static8", act_scales=scales, int8_c64_min_rows=1)):
        got = [f.numpy() for f in port(torch.from_numpy(x))["feats"]]
    return {"measure": "jax_drift", "jax_jit_vs_eager": rel(outs["jit"], outs["eager"]),
            "port_vs_jax_jit": rel(outs["jit"], got)}


def _weights(calibrate_bn, frames):
    if not calibrate_bn:
        return chip_smoke.smoke_weights(frames, size="n", calibrate_bn=False)[0]
    model, _ = build_model("detect", "n", 80, seed=0)
    x = preprocess_batch(torch.from_numpy(frames), (frames.shape[1], frames.shape[2]))
    hooks = []
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                def cal(conv, inp, out, bn=m.bn):
                    bn.running_mean.copy_(out.mean((0, 2, 3)))
                    bn.running_var.copy_(out.var((0, 2, 3)))
                hooks.append(m.conv.register_forward_hook(cal))
        model(x)
    for h in hooks:
        h.remove()
    return model


def weights_drift(imgsz=160):
    rng = np.random.default_rng(0)
    calib = rng.integers(0, 256, (4, imgsz, imgsz, 3), dtype=np.uint8)
    frames = rng.integers(0, 256, (8, imgsz, imgsz, 3), dtype=np.uint8)
    out = {"measure": "weights", "imgsz": imgsz}
    for name, calibrate_bn in (("unit_bn_stats", True), ("fading_rescaled_head", False)):
        model = _weights(calibrate_bn, calib)
        mk = lambda dt: YOLO11Model.from_params(model, task="detect", size="n", fused=False, compute_dtype=dt,  # noqa: E731
                                                device="cpu")
        f32, b16 = mk(torch.float32), mk(torch.bfloat16)
        ptq = create_quantizer("ptq", b16, {"imgsz": imgsz})
        ptq.set_calibration_data([calib[:2], calib[2:]])
        q8 = ptq.optimize()
        with torch.no_grad():
            x = preprocess_batch(torch.from_numpy(frames[:2]), (imgsz, imgsz))
            ref = f32.predictor.model(x)["feats"]
            res = {"static8_vs_f32": rel(ref, [f.float() for f in q8.predictor._forward(x.bfloat16())["feats"]]),
                   "bf16_vs_f32": rel(ref, [f.float() for f in b16.predictor.model(x.bfloat16())["feats"]])}
        labels = b16.predict(frames, conf=0.25, imgsz=imgsz)
        root = Path(tempfile.mkdtemp())
        data = chip_smoke.write_val_dataset(root / "d", frames, labels, "detect", 80)
        for mname, m in (("bf16", b16), ("static8", q8)):
            for proto, kw in (("multi_label_iou0.6", {}), ("single_label_iou0.45", {"multi_label": False, "iou": 0.45})):
                r = YOLO11Validator(model=m, output_dir=root / mname).validate(data, imgsz=imgsz, batch=8,
                                                                               verbose=False, **kw)
                res[f"{mname}_mAP50_{proto}"] = r["metrics"]["mAP50"]
        out[name] = res
    return out


if __name__ == "__main__":
    for measure in (sigmoid_share, jax_drift, weights_drift):
        print(json.dumps(measure()), flush=True)
