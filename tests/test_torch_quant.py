"""The port's static8 int8 path vs the JAX package, on the CPU.

The golden detect weights (tests/golden) folded in f32 are quantized by the
JAX package (`quantize_params_tree`) and carried into the port
(`params_from_jax`), so both packages run the same int8 weights; the
activation scales are calibrated on the same numpy-seeded frames. C=64
convs are quantized too (`int8_c64_min_rows` lowered), so most convs of
yolo11n at 96 px run int8. Kernel E's plain version stands in for the CUDA
kernel here; the kernel itself is checked in test_torch_cuda.py.
"""

from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest
from yolo_infer_tpu.core.predictor import Predictor as JaxPredictor
from yolo_infer_tpu.models import build_spec as jax_build_spec
from yolo_infer_tpu.models import fold_model as jax_fold_model
from yolo_infer_tpu.models import forward as jax_forward
from yolo_infer_tpu.models.convert import convert_state_dict
from yolo_infer_tpu.nn import quantize as JQ
from yolo_infer_tpu.nn.layers import conv_block
from yolo_infer_tpu.ops.pallas.int8_conv import int8_conv3x3_fused, xla_reference
from yolo_infer_tpu.optimization.quantization.quantizers import PostTrainingQuantizer as JaxPTQ
from yolo_infer_tpu_torch.core.model import YOLO11Model, parse_model_name
from yolo_infer_tpu_torch.core.predictor import Predictor
from yolo_infer_tpu_torch.models import blocks as blocks_mod
from yolo_infer_tpu_torch.models.blocks import Conv
from yolo_infer_tpu_torch.models.convert import params_from_jax, state_dict_from_jax
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.models.yolo11 import build_model, fold_model, quantize_model
from yolo_infer_tpu_torch.nn import quantize as Q
from yolo_infer_tpu_torch.ops.kernels.int8_conv import int8_conv, int8_conv_reference, nhwc_input, pixel_pitch
from yolo_infer_tpu_torch.optimization.quantization.quantizers import (
    PostTrainingQuantizer,
    QuantizationUtils,
    create_quantizer,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

GOLDEN = Path(__file__).parent / "golden" / f"golden_detect_n_v{GOLDEN_VERSION}.npz"
IMGSZ = 96
C64_ROWS = 1  # every conv with min(Cin, Cout) >= 64 runs int8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@jax.jit
def _jax_fold_quantize(params, state):
    """The JAX package's deploy fold and `quantize_params_tree` compiled as
    one program: 10x faster than eager, for where only the tree's structure
    matters (XLA's fused division can move a weight scale by an ulp from the
    eager one that `PostTrainingQuantizer` computes)."""
    return JQ.quantize_params_tree(jax_fold_model(params, state))


@pytest.fixture(scope="module")
def golden():
    """The golden detect weights, folded f32, quantized by the JAX package,
    the port's model carrying that int8 tree, and calibration frames."""
    z = np.load(GOLDEN)
    sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
    nc = int(z["nc"])
    jspec = jax_build_spec("detect", "n", nc=nc)
    deploy = jax_fold_model(*convert_state_dict(sd, jspec))
    qparams = JQ.quantize_params_tree(deploy)
    spec = build_spec("detect", "n", nc=nc)
    rng = np.random.default_rng(7)
    calib = [rng.integers(0, 256, (2, 72, IMGSZ, 3), dtype=np.uint8) for _ in range(2)]
    scales = JaxPTQ(SimpleNamespace(spec=jspec, compute_dtype=jnp.float32), {"imgsz": IMGSZ})
    scales.set_calibration_data(calib)
    return SimpleNamespace(jspec=jspec, spec=spec, deploy=deploy, qparams=qparams, nc=nc, calib=calib,
                           port=params_from_jax(_np_tree(qparams), spec), jax_scales=scales._calibrate(qparams))


# ---------------------------------------------------------------- weights

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_per_channel_weight_quantization_is_bit_equal(dtype):
    w = np.random.default_rng(0).normal(0, 0.05, (3, 3, 64, 48)).astype(np.float32)
    w[:, :, :, 5] = 0  # an all-zero output channel takes the 1e-12 scale floor
    jw = jnp.asarray(w, dtype)
    want_q, want_s = JQ.quantize_weights_per_channel(jw)
    got_q, got_s = Q.quantize_weights_per_channel(torch.from_numpy(np.asarray(jw, np.float32).transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(got_q.numpy().transpose(2, 3, 1, 0), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    back = Q.dequantize_weights(got_q, got_s).numpy().transpose(2, 3, 1, 0)
    np.testing.assert_array_equal(back, np.asarray(JQ.dequantize_weights(want_q, want_s)))


@pytest.mark.parametrize("task", ["detect", "segment", "pose", "obb", "classify"])
def test_quantized_conv_set_matches_quantize_params_tree(task):
    """By name: the port's `quantize_model` quantizes exactly the convs
    `quantize_params_tree` gives int8 weights (72 for yolo11n detect)."""
    model, spec = build_model(task, "n", 80, seed=0)
    params, state = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                       jax_build_spec(task, "n", nc=80))
    want = {k[: -len(".w_q")] for k in state_dict_from_jax(_np_tree(_jax_fold_quantize(params, state)), spec)
            if k.endswith(".w_q")}
    got = {k[: -len(".w_q")] for k in quantize_model(fold_model(model)).state_dict() if k.endswith(".w_q")}
    assert got == want
    assert len(got) == {"detect": 72, "segment": 81, "pose": 78, "obb": 78, "classify": 36}[task]


def test_port_quantization_equals_the_carried_jax_tree(golden):
    """Quantizing the same folded weights in the port gives the JAX int8
    weights, scales and biases bit for bit."""
    own = quantize_model(params_from_jax(_np_tree(golden.deploy), golden.spec)).state_dict()
    carried = golden.port.state_dict()
    assert own.keys() == carried.keys()
    for k in own:
        assert own[k].dtype == carried[k].dtype and torch.equal(own[k], carried[k]), k


def test_observe8_scales_match_jax_calibration(golden):
    """The port's PTQ calibration (observe8, quantized convs in DAG order)
    gives JAX's (n, 2) absmax pairs within 1e-5 relative: the order is pinned."""
    ptq = PostTrainingQuantizer(SimpleNamespace(spec=golden.spec, compute_dtype=torch.float32, device="cpu"),
                                {"imgsz": IMGSZ})
    ptq.set_calibration_data(golden.calib)
    got = ptq._calibrate(golden.port)
    assert got.shape == golden.jax_scales.shape == (72, 2)
    np.testing.assert_allclose(got, golden.jax_scales, rtol=1e-5, atol=0)


# ---------------------------------------------------------------- kernel E

def _int8_case(seed, b, h, w, ci, co, k=3, wmax=20):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, h, w, ci)).astype(np.int8)
    wq = rng.integers(-wmax, wmax + 1, (k, k, ci, co)).astype(np.int8)
    scale = rng.uniform(1e-3, 2e-3, (co,)).astype(np.float32)
    bias = rng.normal(0, 0.1, (co,)).astype(np.float32)
    return x, wq, scale, bias


def _plain_e(x, wq, scale, bias, sy, act=True, epilogue=torch.float32, stride=1):
    return int8_conv_reference(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 0, 1, 2))),
                               torch.from_numpy(scale), None if bias is None else torch.from_numpy(bias),
                               (1.0 / torch.tensor(sy, dtype=torch.float32)).item(), stride=stride, act=act,
                               epilogue_dtype=epilogue).numpy()


def _assert_codes_close(got, want):
    """At most 1 code apart on under 1% of the outputs (the rounding edges of
    two arithmetics: `y / sy` vs `y * (1/sy)`, XLA's vs PyTorch's sigmoid)."""
    diff = np.abs(got.astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.01


@pytest.mark.parametrize("shape", [(2, 16, 16, 32, 32), (1, 8, 8, 64, 32)])
def test_e_plain_version_matches_the_tpu_kernel_and_xla_reference(shape):
    x, wq, scale, bias, sy = *_int8_case(0, *shape), np.float32(0.02)
    got = _plain_e(x, wq, scale, bias, sy)
    assert got.shape == shape[:3] + (shape[4],) and got.dtype == np.int8
    args = (jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale), jnp.asarray(bias), jnp.float32(sy))
    _assert_codes_close(got, xla_reference(*args))
    _assert_codes_close(got, int8_conv3x3_fused(*args, interpret=True))


def test_e_plain_version_without_bias_or_activation():
    x, wq, scale, _ = _int8_case(1, 1, 8, 8, 32, 32, wmax=5)
    got = _plain_e(x, wq, scale, None, np.float32(0.01), act=False)
    want = xla_reference(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale), None, jnp.float32(0.01), act=False)
    _assert_codes_close(got, want)


def _quantized_conv(wq, w_scale, bias, k, stride):
    """A port Conv in the int8 deploy form holding the given int8 tree node."""
    ci, co = wq.shape[2], wq.shape[3]
    conv = Conv(ci, co, k, stride)
    conv.fold()
    conv.quantize()
    conv.w_q.copy_(torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 0, 1, 2).reshape(co, -1))))
    conv.w_scale.copy_(torch.from_numpy(w_scale))
    conv.b.copy_(torch.from_numpy(bias))
    return conv


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2)])
def test_static8_conv_matches_jax_conv_block(k, stride):
    """The port's int8 Conv (E's plain version, bf16 epilogue) against the
    JAX static8 `conv_block`, for a float input and for a QAct input."""
    rng = np.random.default_rng(10 * k + stride)
    ci, co = 64, 80
    w = rng.normal(0, 0.05, (k, k, ci, co)).astype(np.float32)
    wq, w_scale = (np.asarray(a) for a in JQ.quantize_weights_per_channel(jnp.asarray(w)))
    bias = rng.normal(0, 0.1, co).astype(np.float32)
    node = {"w_q": jnp.asarray(wq), "w_scale": jnp.asarray(w_scale), "b": jnp.asarray(bias)}
    scales = np.array([[3.0, 2.5]], np.float32)
    x = rng.normal(0, 1, (2, 15, 13, ci)).astype(np.float32)
    conv = _quantized_conv(wq, w_scale, bias, k, stride)
    xq = Q.quantize_act(torch.from_numpy(x).permute(0, 3, 1, 2), torch.tensor(3.0 / 127, dtype=torch.float32))
    for inp_jax, inp_port in ((jnp.asarray(x), torch.from_numpy(x).permute(0, 3, 1, 2)),
                              (JQ.QAct(jnp.asarray(xq.q.permute(0, 2, 3, 1).numpy()), jnp.asarray(xq.s.numpy())), xq)):
        with JQ.quant_context(JQ.QuantContext("static8", act_scales=jnp.asarray(scales), int8_min_channels=1)):
            want, _ = conv_block(node, None, inp_jax, stride=stride)
        with Q.quant_context(Q.QuantContext("static8", act_scales=scales, int8_min_channels=1)) as ctx:
            got = conv(inp_port)
        assert isinstance(want, JQ.QAct) and isinstance(got, Q.QAct) and ctx.index == 1
        assert float(got.s) == float(want.s)
        _assert_codes_close(got.q.permute(0, 2, 3, 1).numpy(), want.q)


def test_int8_conv_wrapper_takes_the_plain_version_on_cpu_only():
    x, wq, scale, bias = _int8_case(2, 1, 6, 6, 8, 8)
    args = (torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 0, 1, 2))),
            torch.from_numpy(scale), torch.from_numpy(bias), 50.0)
    before = int8_conv.launches
    assert torch.equal(int8_conv(*args), int8_conv_reference(*args))
    assert int8_conv.launches == before
    with pytest.raises(ValueError):
        int8_conv(*(a.to("meta") if torch.is_tensor(a) else a for a in args))


def test_static8_conv_reads_a_channel_chunk_in_place(monkeypatch):
    """A static8 Conv fed a channel chunk of a wider channels_last QAct (the
    card's layout), as `q_split2` gives it, hands E's wrapper the strided
    NHWC view (pixel pitch = the wide C, no copy) and returns the codes of
    the same conv on a contiguous copy of the chunk."""
    rng = np.random.default_rng(11)
    ci, co = 32, 48
    wq = rng.integers(-20, 21, (3, 3, ci, co)).astype(np.int8)
    conv = _quantized_conv(wq, rng.uniform(1e-3, 2e-3, co).astype(np.float32),
                           rng.normal(0, 0.1, co).astype(np.float32), 3, 1)
    codes = torch.from_numpy(rng.integers(-127, 128, (2, 2 * ci, 9, 7)).astype(np.int8))
    wide = Q.QAct(codes.contiguous(memory_format=torch.channels_last), torch.tensor(0.02))
    inputs = []

    def recording_int8_conv(x, *args, **kw):
        inputs.append(x)
        return int8_conv(x, *args, **kw)

    monkeypatch.setattr(blocks_mod, "int8_conv", recording_int8_conv)
    outs = []
    for chunk in (Q.q_split2(wide, 1)[1], Q.QAct(Q.q_split2(wide, 1)[1].q.contiguous(), wide.s)):
        with Q.quant_context(Q.QuantContext("static8", act_scales=np.array([[2.5, 3.0]], np.float32),
                                            int8_min_channels=1)):
            outs.append(conv(chunk))
    view, copied = inputs
    assert not view.is_contiguous() and view.stride() == (9 * 7 * 2 * ci, 7 * 2 * ci, 2 * ci, 1)
    assert view.data_ptr() == wide.q.data_ptr() + ci and pixel_pitch(view) == 2 * ci
    assert copied.is_contiguous() and torch.equal(view, copied)
    assert float(outs[0].s) == float(outs[1].s)
    assert torch.equal(outs[0].q, outs[1].q)


def test_nhwc_input_views_pitched_chunks_and_copies_the_rest():
    """`nhwc_input` hands kernel E a view where it reads the codes in place
    (channels_last, or a chunk of it at a 16-byte aligned offset and pitch)
    and a contiguous copy otherwise (plain NCHW, a 16-channel-multiple chunk
    at a misaligned offset)."""
    codes = torch.zeros((2, 64, 5, 5), dtype=torch.int8)
    cl = codes.contiguous(memory_format=torch.channels_last)
    assert nhwc_input(cl).data_ptr() == cl.data_ptr() and nhwc_input(cl).is_contiguous()
    chunk = nhwc_input(cl[:, 32:])
    assert not chunk.is_contiguous() and pixel_pitch(chunk) == 64 and chunk.data_ptr() == cl.data_ptr() + 32
    odd = nhwc_input(cl[:, 8:40])  # Ci = 32 takes the 16-byte path, and byte 8 is not 16-byte aligned
    assert odd.is_contiguous() and odd.data_ptr() != cl.data_ptr() + 8
    assert nhwc_input(cl[:, 8:11]).data_ptr() == cl.data_ptr() + 8  # Ci = 3 takes the byte path anywhere
    assert nhwc_input(codes).is_contiguous() and pixel_pitch(codes.permute(0, 2, 3, 1)) is None


# ---------------------------------------------------------------- QAct routing and eligibility

def _qacts(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(-127, 128, (2, c, 5, 5)).astype(np.int8), np.float32(s))
            for c, s in ((8, 0.02), (16, 0.05), (8, 0.03))]


def test_q_concat_requantizes_to_the_largest_scale_like_jax():
    parts = _qacts(0)
    want = JQ.q_concat([JQ.QAct(jnp.asarray(q.transpose(0, 2, 3, 1)), jnp.asarray(s)) for q, s in parts], axis=-1)
    got = Q.q_concat([Q.QAct(torch.from_numpy(q), torch.tensor(s)) for q, s in parts], 1)
    assert float(got.s) == float(want.s) == float(np.float32(0.05))
    np.testing.assert_array_equal(got.q.numpy().transpose(0, 2, 3, 1), np.asarray(want.q))
    mixed = Q.q_concat([Q.QAct(torch.from_numpy(parts[0][0]), torch.tensor(parts[0][1])),
                        torch.ones((2, 4, 5, 5), dtype=torch.bfloat16)], 1)
    assert mixed.dtype == torch.bfloat16 and mixed.shape == (2, 12, 5, 5)


def test_q_add_runs_in_float_like_jax():
    (qa, sa), (qb, sb), _ = _qacts(1)
    qb = qb[:, :8]
    ja, jb = (JQ.QAct(jnp.asarray(q.transpose(0, 2, 3, 1)), jnp.asarray(s)) for q, s in ((qa, sa), (qb, sb)))
    ta, tb = Q.QAct(torch.from_numpy(qa), torch.tensor(sa)), Q.QAct(torch.from_numpy(qb), torch.tensor(sb))
    both = Q.q_add(ta, tb)
    assert both.dtype == torch.bfloat16  # QAct + QAct adds in bf16
    np.testing.assert_array_equal(both.float().numpy().transpose(0, 2, 3, 1), np.asarray(JQ.q_add(ja, jb), np.float32))
    f = np.random.default_rng(2).normal(0, 1, (2, 5, 5, 8)).astype(np.float32)
    mixed = Q.q_add(ta, torch.from_numpy(f.transpose(0, 3, 1, 2)))
    assert mixed.dtype == torch.float32
    np.testing.assert_allclose(mixed.numpy().transpose(0, 2, 3, 1), np.asarray(JQ.q_add(ja, jnp.asarray(f))),
                               rtol=1e-6, atol=1e-6)


def test_static8_c64_eligibility_is_rows_keyed():
    """C=64 convs run int8 only when rows = N*H*W reach int8_c64_min_rows
    (tests/test_quantization.py's case); an exempted conv runs float but
    still takes its scale pair, so the next conv reads the next pair."""
    rng = np.random.default_rng(3)
    wq, w_scale = Q.quantize_weights_per_channel(torch.from_numpy(rng.normal(0, 0.1, (64, 64, 3, 3)).astype(np.float32)))
    conv = _quantized_conv(wq.numpy().transpose(2, 3, 1, 0), w_scale.numpy(), np.zeros(64, np.float32), 3, 1)
    scales = np.ones((2, 2), np.float32)

    def run(n, hw, min_rows, float_convs=None):
        x = torch.from_numpy(rng.normal(0, 1, (n, 64, hw, hw)).astype(np.float32))
        with Q.quant_context(Q.QuantContext("static8", act_scales=scales, int8_c64_min_rows=min_rows,
                                            float_convs=float_convs)) as ctx:
            y = conv(x)
            conv(x)
        assert ctx.index == 2
        return y

    assert not isinstance(run(2, 8, min_rows=2 * 8 * 8 + 1), Q.QAct)
    assert isinstance(run(2, 16, min_rows=2 * 8 * 8 + 1), Q.QAct)
    assert isinstance(run(4, 8, min_rows=4 * 8 * 8), Q.QAct)
    assert not isinstance(run(4, 8, min_rows=1, float_convs={0}), Q.QAct)
    with Q.quant_context(Q.QuantContext("static8", act_scales=scales, int8_min_channels=1 << 20,
                                        int8_c64_min_rows=1)):  # weight-only: not relaxed by the rows rule
        assert not isinstance(conv(torch.zeros((1, 64, 8, 8))), Q.QAct)


def test_unported_modes_raise():
    """The modes that raised until dynamic, legacy static and QAT int8 were
    ported now construct; what stays refused is a scale array of the wrong
    rank for its mode and an unknown mode. An int8 conv outside a context
    runs dynamic int8 (float in, float out)."""
    for mode in ("static", "fake", "observe"):
        assert Q.QuantContext(mode).mode == mode
    with pytest.raises(ValueError, match="2-D activation scales"):
        Q.QuantContext("static8", act_scales=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="mode must be one of"):
        Q.QuantContext("dynamic")
    conv = _quantized_conv(np.ones((1, 1, 4, 4), np.int8), np.ones(4, np.float32), np.zeros(4, np.float32), 1, 1)
    y = conv(torch.ones((1, 4, 2, 2)))  # an int8 conv outside a context (dynamic int8)
    assert not isinstance(y, Q.QAct) and y.dtype == torch.float32 and y.shape == (1, 4, 2, 2)


# ---------------------------------------------------------------- whole forward and serving

def test_static8_forward_matches_jax(golden):
    """Head maps of the whole static8 forward (f32 compute) against JAX's
    jitted one on the same int8 tree and scales: mean |diff| within 3e-2 of
    the mean |map|. Measured 0.8-1.0%: codes at rounding edges flip (XLA
    keeps f32 between jitted bf16 ops; bf16 convs sum in another order) and
    travel on; JAX's own jitted and eager static8 forwards differ by as much
    (0.77-0.98%) on these inputs."""
    x = np.random.default_rng(8).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    jctx = JQ.QuantContext("static8", act_scales=jnp.asarray(golden.jax_scales))
    jctx.int8_c64_min_rows = C64_ROWS
    with JQ.quant_context(jctx):
        want, _ = jax.jit(lambda p, xx: jax_forward(p, None, golden.jspec, xx, compute_dtype=jnp.float32))(
            golden.qparams, jnp.asarray(x))
    with torch.no_grad(), Q.quant_context(Q.QuantContext("static8", act_scales=golden.jax_scales,
                                                         int8_c64_min_rows=C64_ROWS)) as ctx:
        got = golden.port(torch.from_numpy(x))
    assert ctx.index == len(golden.jax_scales)
    for a, b in zip(want["feats"], got["feats"]):
        a, b = np.asarray(a, np.float32), b.float().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).mean() / np.abs(a).mean() < 3e-2


def _spread_head_weights(frames):
    """The seeded yolo11n init (its activations fade, so int8 noise does not
    grow through the layers) with the head's output projections rescaled so
    box and class logits spread at unit scale: detections with distinct
    scores. The golden weights score every anchor ~0.5, a tie."""
    model, spec = build_model("detect", "n", 80, seed=0)
    head = model.model[-1]
    x = torch.from_numpy(np.concatenate(frames).astype(np.float32) / 255)
    with torch.no_grad():
        for branch in list(head.cv2) + list(head.cv3):
            branch[-1].bias.zero_()
        feats = torch.cat([f.reshape(-1, f.shape[-1]) for f in model(x)["feats"]])
        for branch in head.cv2:
            branch[-1].weight.mul_(2.0 / feats[:, :64].std())
        for branch in head.cv3:
            branch[-1].weight.mul_(2.0 / feats[:, 64:].std())
            branch[-1].bias.fill_(-6.0)
    return {k: v.numpy() for k, v in model.state_dict().items()}, spec


def _iou(a, b):
    lt, rb = np.maximum(a[:, None, :2], b[None, :, :2]), np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area = lambda z: np.prod(z[:, 2:] - z[:, :2], axis=-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None] - inter)


def test_static8_predictor_matches_the_jax_predictor(monkeypatch):
    """Predictor.predict of the same int8 weights and scales in both
    packages (f32 compute, C=64 convs int8 too): every detection scoring
    >= 0.35 in one has a partner in the other (same class, IoU >= 0.5,
    score within 0.1) for at least 90% of them, both ways. Not all: the
    ~1% head drift of the forward test moves scores by ~0.01-0.05, which
    reorders near-equal candidates in NMS."""
    monkeypatch.setenv("YOLO_INT8_C64_MIN_ROWS", str(C64_ROWS))
    rng = np.random.default_rng(12)
    calib = [rng.integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8) for _ in range(2)]
    sd, spec = _spread_head_weights(calib)
    jspec = jax_build_spec("detect", "n", nc=80)
    qparams = _jax_fold_quantize(*convert_state_dict(sd, jspec))
    ptq = JaxPTQ(SimpleNamespace(spec=jspec, compute_dtype=jnp.float32), {"imgsz": IMGSZ})
    ptq.set_calibration_data(calib)
    scales = ptq._calibrate(qparams)
    frames = list(rng.integers(0, 256, (2, 72, IMGSZ, 3), dtype=np.uint8))
    want = JaxPredictor(qparams, jspec, compute_dtype=jnp.float32, quant_act_scales=jnp.asarray(scales)).predict(
        frames, conf=0.25, imgsz=IMGSZ)
    got = Predictor(params_from_jax(_np_tree(qparams), spec), spec, device="cpu", compute_dtype=torch.float32,
                    quant_act_scales=scales).predict(frames, conf=0.25, imgsz=IMGSZ)
    for g, w in zip(got, want):
        assert len(g) > 5 and abs(len(g) - len(w)) <= 0.2 * len(w)
        for a, b in ((g, w), (w, g)):
            keep = a.scores >= 0.35
            ok = ((_iou(a.boxes[keep], b.boxes) >= 0.5) & (a.classes[keep, None] == b.classes[None])
                  & (np.abs(a.scores[keep, None] - b.scores[None]) <= 0.1)).any(1)
            assert keep.sum() > 3 and ok.mean() >= 0.9, (ok.mean(), keep.sum())


def test_ptq_through_yolo11model_serves_static8():
    """The user's entry: YOLO11Model -> create_quantizer("ptq") ->
    set_calibration_data -> optimize -> predict / quantization utilities."""
    model = YOLO11Model("yolo11n", device="cpu", compute_dtype=torch.float32)
    rng = np.random.default_rng(11)
    q = create_quantizer("ptq", model, {"imgsz": 64})
    with pytest.raises(RuntimeError, match="calibration"):
        q.optimize()
    q.set_calibration_data([rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8), rng.random((64, 64, 3))])
    qmodel = q.optimize()
    info = q.get_optimization_info()
    assert info["method"] == "ptq" and info["num_observed_convs"] == 72 and info["num_calibration_batches"] == 2
    assert qmodel.quant_act_scales.shape == (72, 2) and (qmodel.quant_act_scales > 0).all()
    assert QuantizationUtils.is_quantized(qmodel) and not QuantizationUtils.is_quantized(model)
    sizes = QuantizationUtils.compare_model_sizes(model, qmodel)
    assert sizes["compression_ratio"] > 3
    frames = rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    out = qmodel.predict(frames, conf=0.0, imgsz=64, max_det=20)
    assert len(out) == 2 and all(len(r) == 20 and np.isfinite(r.boxes).all() for r in out)
    dyn = create_quantizer("dynamic", model).optimize()  # ported since dynamic int8 (test_torch_quant_modes.py)
    assert QuantizationUtils.is_quantized(dyn) and dyn.quant_act_scales is None
    with pytest.raises(RuntimeError, match="QAT needs a dataset"):
        create_quantizer("qat", model).optimize()


def test_yolo11model_surface(tmp_path):
    assert parse_model_name("yolo11s-seg.pt") == ("s", "segment") and parse_model_name("resnet") is None
    model = YOLO11Model("yolo11n-pose", device="cpu", nc=1)
    assert model.task == "pose" and model.names == {0: "0"}
    info = model.get_model_info()
    assert info["device"] == "cpu" and info["parameters"] > 2_000_000 and info["compute_dtype"] == "bfloat16"
    # training runs since item 8.1, pose training since item 8.2
    from yolo_infer_tpu_torch.data.loader import create_dataset_config, save_image

    kpts = " ".join("0.5 0.5 2" for _ in range(17))
    for i in range(2):
        save_image(tmp_path / "pose" / "images" / f"{i}.png", np.full((32, 32, 3), 100, np.uint8))
        (tmp_path / "pose" / "labels").mkdir(parents=True, exist_ok=True)
        (tmp_path / "pose" / "labels" / f"{i}.txt").write_text(f"0 0.5 0.5 0.5 0.5 {kpts}\n")
    images = str(tmp_path / "pose" / "images")
    data = create_dataset_config(tmp_path / "pose" / "data.yaml", images, images, ["0"])
    out = model.train(str(data), epochs=1, batch=2, imgsz=32, project=str(tmp_path / "runs"), val=False)
    assert out["status"] == "completed" and out["skipped_steps"] == 0 and np.isfinite(out["history"][0]["loss"])
    # checkpoints are ported: a saved file loads back as the same task and names
    loaded = YOLO11Model(model.save(tmp_path / "m.msgpack"), device="cpu")
    assert loaded.task == "pose" and loaded.names == {0: "0"}
    (tmp_path / "m.bin").write_bytes(b"")
    with pytest.raises(ValueError, match="unsupported checkpoint format"):
        YOLO11Model(tmp_path / "m.bin")
    # predict on 65 images streams through predict_many; benchmark times the model
    assert len(model.predict(list(np.zeros((65, 32, 32, 3), np.uint8)), imgsz=32)) == 65
    assert model.benchmark(imgsz=32, batch=1, runs=1, warmup=0)["runs"] == 1
    with pytest.raises(ValueError):
        YOLO11Model("resnet50")
