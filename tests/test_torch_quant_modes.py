"""The port's dynamic, legacy static, observe and QAT fake-quant int8 modes
against the JAX package's, on the CPU.

Kernel E's float epilogue (`int8_conv(..., requant=False)`) runs as its
plain version here: its int32 sums must equal XLA's s8 convolution (the
JAX package's `quantized_conv2d`) exactly, and a dynamic or legacy static
`Conv` must give JAX's `conv_block` output within 1e-5 in f32. The kernel
itself is held to its plain version on the card (`chip_smoke.py` phase 30,
`tests/test_torch_cuda.py`).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from torch_threads import one_torch_thread  # noqa: F401
from yolo_infer_tpu.models import build_spec as jax_build_spec
from yolo_infer_tpu.models import forward as jax_forward
from yolo_infer_tpu.models.convert import convert_state_dict
from yolo_infer_tpu.nn import quantize as JQ
from yolo_infer_tpu.nn.layers import conv_block
from yolo_infer_tpu_torch.core.model import YOLO11Model
from yolo_infer_tpu_torch.core.predictor import Predictor
from yolo_infer_tpu_torch.models.blocks import Conv
from yolo_infer_tpu_torch.models.convert import params_from_jax
from yolo_infer_tpu_torch.models.yolo11 import build_model, fold_model, quantize_model
from yolo_infer_tpu_torch.nn import quantize as Q
from yolo_infer_tpu_torch.ops.kernels.int8_conv import int8_conv, int8_conv_reference, int8_conv_sums
from yolo_infer_tpu_torch.optimization.quantization.quantizers import QuantizationUtils, create_quantizer


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_fake_quantize_ste_gradient_and_value_match_jax():
    x = np.linspace(-1, 1, 8).astype(np.float32)
    jg = jax.grad(lambda v: jnp.sum(JQ.fake_quantize(v, jnp.float32(0.01))))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    y = Q.fake_quantize(t, torch.tensor(0.01))
    y.sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg))
    np.testing.assert_allclose(t.grad.numpy(), 1.0)  # straight-through
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(JQ.fake_quantize(jnp.asarray(x), jnp.float32(0.01))))
    a = np.random.default_rng(0).normal(0, 3, (2, 5, 7)).astype(np.float32)
    assert float(Q.dynamic_act_scale(torch.from_numpy(a))) == float(JQ.dynamic_act_scale(jnp.asarray(a)))


def _node(rng, k, ci, co):
    w = rng.normal(0, 0.05, (k, k, ci, co)).astype(np.float32)
    wq, w_scale = (np.asarray(a) for a in JQ.quantize_weights_per_channel(jnp.asarray(w)))
    return wq, w_scale, rng.normal(0, 0.1, co).astype(np.float32)


def _port_conv(wq, w_scale, bias, k, stride):
    ci, co = wq.shape[2], wq.shape[3]
    conv = Conv(ci, co, k, stride)
    conv.fold()
    conv.quantize()
    conv.w_q.copy_(torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 0, 1, 2).reshape(co, -1))))
    conv.w_scale.copy_(torch.from_numpy(w_scale))
    conv.b.copy_(torch.from_numpy(bias))
    return conv


@pytest.mark.parametrize("k,stride,ci,co", [(3, 2, 3, 16), (3, 1, 16, 32), (1, 1, 32, 64), (3, 2, 64, 64),
                                            (1, 1, 130, 24)])
def test_float_epilogue_sums_equal_xla_s8_conv(k, stride, ci, co):
    """The plain version's int32 sums equal XLA's s8 convolution exactly,
    at the stem's Ci = 3 (stride 2), the 16/32/64 widths and an odd Ci; the
    float epilogue then follows its order of rounding."""
    rng = np.random.default_rng(k * 100 + ci)
    x = rng.integers(-127, 128, (2, 11, 9, ci)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)
    want = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(wq), (stride, stride), ((k // 2, k // 2),) * 2,
                                    dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    w_rows = torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 0, 1, 2)))
    sums = int8_conv_sums(torch.from_numpy(x), w_rows, stride)
    np.testing.assert_array_equal(sums.numpy().astype(np.int64), np.asarray(want).astype(np.int64))
    scale = rng.uniform(1e-5, 2e-5, co).astype(np.float32)
    bias = rng.normal(0, 0.1, co).astype(np.float32)
    for dt in (torch.float32, torch.bfloat16):
        got = int8_conv(torch.from_numpy(x), w_rows, torch.from_numpy(scale), torch.from_numpy(bias), 1.0,
                        stride=stride, epilogue_dtype=dt, requant=False)
        y = (sums.float() * torch.from_numpy(scale)).to(dt) + torch.from_numpy(bias).to(dt)
        assert got.dtype == dt and torch.equal(got, y * torch.reciprocal(1.0 + torch.exp(-y)))
        assert torch.equal(got, int8_conv_reference(torch.from_numpy(x), w_rows, torch.from_numpy(scale),
                                                    torch.from_numpy(bias), 1.0, stride=stride, epilogue_dtype=dt,
                                                    requant=False))


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("k,stride,ci", [(3, 2, 3), (1, 1, 32), (3, 1, 64)])
def test_dynamic_and_legacy_static_conv_match_jax_conv_block(mode, k, stride, ci):
    rng = np.random.default_rng(7 * k + ci)
    co = 48
    wq, w_scale, bias = _node(rng, k, ci, co)
    node = {"w_q": jnp.asarray(wq), "w_scale": jnp.asarray(w_scale), "b": jnp.asarray(bias)}
    x = rng.normal(0, 1, (2, 13, 11, ci)).astype(np.float32)
    conv = _port_conv(wq, w_scale, bias, k, stride)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    scales = np.array([3.5], np.float32)
    if mode == "dynamic":
        want, _ = conv_block(node, None, jnp.asarray(x), stride=stride)
        got = conv(xt)
    else:
        with JQ.quant_context(JQ.QuantContext("static", act_scales=jnp.asarray(scales))):
            want, _ = conv_block(node, None, jnp.asarray(x), stride=stride)
        with Q.quant_context(Q.QuantContext("static", act_scales=scales)) as ctx:
            got = conv(xt)
        assert ctx.index == 1
    assert got.dtype == torch.float32 and not isinstance(got, Q.QAct)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def small_detect():
    """yolo11n detect at nc=3: the port's seeded weights carried to JAX,
    folded and quantized by the JAX package and carried back."""
    model, spec = build_model("detect", "n", 3, seed=0)
    jspec = jax_build_spec("detect", "n", nc=3)
    params, state = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, jspec)
    from yolo_infer_tpu.models import fold_model as jax_fold_model

    float_params = jax.jit(jax_fold_model)(params, state)
    qparams = jax.jit(JQ.quantize_params_tree)(float_params)
    return SimpleNamespace(spec=spec, jspec=jspec, qparams=qparams, port=params_from_jax(_np_tree(qparams), spec),
                           float_params=float_params, model=model)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_dynamic_and_legacy_static_forward_match_jax(small_detect, mode):
    """Whole f32 forwards on the same int8 tree: the head maps within 3e-2
    of their mean magnitude (a code at a rounding edge flips where the two
    packages' float convs round differently, as in static8)."""
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    n = 72
    scales = np.random.default_rng(4).uniform(2, 6, n).astype(np.float32)
    fwd = jax.jit(lambda p, xx: jax_forward(p, None, small_detect.jspec, xx, compute_dtype=jnp.float32))
    if mode == "dynamic":
        want, _ = fwd(small_detect.qparams, jnp.asarray(x))
        with torch.no_grad():
            got = small_detect.port(torch.from_numpy(x))
    else:
        with JQ.quant_context(JQ.QuantContext("static", act_scales=jnp.asarray(scales))):
            want, _ = fwd(small_detect.qparams, jnp.asarray(x))
        with torch.no_grad(), Q.quant_context(Q.QuantContext("static", act_scales=scales)) as ctx:
            got = small_detect.port(torch.from_numpy(x))
        assert ctx.index == n
    for a, b in zip(want["feats"], got["feats"]):
        a, b = np.asarray(a, np.float32), b.float().numpy()
        assert a.shape == b.shape and np.abs(a - b).mean() / np.abs(a).mean() < 3e-2


def test_observe_mode_records_jax_float_conv_inputs(small_detect):
    """"observe" records the input absmax of every float conv in DAG order, as JAX does."""
    x = np.random.default_rng(5).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    @jax.jit
    def observe(p, xx):
        with JQ.quant_context(JQ.QuantContext("observe")) as jctx:
            jax_forward(p, None, small_detect.jspec, xx, compute_dtype=jnp.float32)
            return jnp.stack(jctx.collected)

    want = np.asarray(observe(small_detect.float_params, jnp.asarray(x)))
    deploy = fold_model(params_from_jax(_np_tree(small_detect.float_params), small_detect.spec))
    with torch.no_grad(), Q.quant_context(Q.QuantContext("observe")) as ctx:
        deploy(torch.from_numpy(x))
    got = np.array([float(v) for v in ctx.collected])
    assert len(got) == len(want) > 80
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fake_mode_conv_and_its_gradients_match_jax():
    """One QAT conv in training mode (batch statistics): fake-quantized
    weights and input, forward within 1e-5 and the gradients of the weights,
    batch-norm affine and input within 1e-5 of their norms."""
    rng = np.random.default_rng(0)
    ci, co, k = 16, 32, 3
    w = rng.normal(0, 0.1, (k, k, ci, co)).astype(np.float32)
    g, b = rng.uniform(0.5, 1.5, co).astype(np.float32), rng.normal(0, 0.1, co).astype(np.float32)
    x = rng.normal(0, 1, (2, 9, 9, ci)).astype(np.float32)
    st = {"mean": jnp.zeros(co), "var": jnp.ones(co)}

    def jfn(node, xx):
        with JQ.quant_context(JQ.QuantContext("fake")):
            y, _ = conv_block(node, st, xx, stride=1, training=True)
        return jnp.sum(y * jnp.cos(y)), y

    (_, want), (jgn, jgx) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        {"w": jnp.asarray(w), "gamma": jnp.asarray(g), "beta": jnp.asarray(b)}, jnp.asarray(x))
    conv = Conv(ci, co, k, 1)
    with torch.no_grad():
        conv.conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        conv.bn.weight.copy_(torch.from_numpy(g))
        conv.bn.bias.copy_(torch.from_numpy(b))
    conv.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    with Q.quant_context(Q.QuantContext("fake")):
        y = conv(xt)
    (y * torch.cos(y)).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for got, ref in ((conv.conv.weight.grad.permute(2, 3, 1, 0), jgn["w"]), (conv.bn.weight.grad, jgn["gamma"]),
                     (conv.bn.bias.grad, jgn["beta"]), (xt.grad.permute(0, 2, 3, 1), jgx)):
        ref = np.asarray(ref)
        assert np.linalg.norm(got.numpy() - ref) <= 1e-5 * np.linalg.norm(ref)


def test_mode_checks():
    for mode in ("observe", "static", "fake", "observe8", "static8"):
        assert Q.QuantContext(mode).mode == mode
    with pytest.raises(ValueError, match="2-D"):
        Q.QuantContext("static8", act_scales=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="1-D"):
        Q.QuantContext("static", act_scales=np.ones((3, 2), np.float32))
    with pytest.raises(ValueError, match="mode must be one of"):
        Q.QuantContext("dynamic")  # dynamic is no context at all


def test_dynamic_legacy_static_and_static8_serve_through_the_predictor(tmp_path):
    """`create_quantizer("dynamic")` serves; a model carrying 1-D scales
    serves legacy static, and the program-cache key holds the mode; both
    survive a save and load."""
    model = YOLO11Model("yolo11n", device="cpu", compute_dtype=torch.float32, nc=3)
    q = create_quantizer("dynamic", model)
    qmodel = q.optimize()
    assert q.get_optimization_info()["method"] == "dynamic" and QuantizationUtils.is_quantized(qmodel)
    frames = np.random.default_rng(1).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    out = qmodel.predict(list(frames), conf=0.0, imgsz=64, max_det=10)
    assert len(out) == 2 and all(0 < len(r) <= 10 and np.isfinite(r.boxes).all() for r in out)
    pred = qmodel.predictor
    assert pred.quant_mode == "dynamic" and all(k[-1] == "dynamic" for k in pred._cache)

    legacy = YOLO11Model(q.save_optimized_model(tmp_path / "dyn.msgpack"), device="cpu", compute_dtype=torch.float32)
    assert legacy.quant_act_scales is None and legacy.predictor.quant_mode == "dynamic"
    legacy.quant_act_scales = np.full(72, 4.0, np.float32)
    legacy.invalidate()
    back = YOLO11Model(legacy.save(tmp_path / "legacy.msgpack", fused=True), device="cpu",
                       compute_dtype=torch.float32)
    assert back.quant_act_scales.shape == (72,)
    res = back.predict(frames[0], conf=0.0, imgsz=64, max_det=10)
    assert back.predictor.quant_mode == "static" and 0 < len(res[0]) <= 10
    assert all(k[-1] == "static" for k in back.predictor._cache)
    with pytest.raises(ValueError, match="73 scale"):
        Predictor(back.deploy_model, back.spec, device="cpu", compute_dtype=torch.float32,
                  quant_act_scales=np.ones(73, np.float32)).predict(frames[0], imgsz=64)
    assert Predictor(quantize_model(fold_model(build_model("detect", "n", 3)[0])), back.spec, device="cpu").quant_mode \
        == "dynamic"
