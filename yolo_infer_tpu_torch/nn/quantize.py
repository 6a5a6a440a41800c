"""int8 quantization primitives and the quantization context.

Port of `yolo_infer_tpu/nn/quantize.py`: weights int8 per output channel,
activations int8 per tensor. The post-training static8 path keeps every
quantized conv int8 in, int8 out (kernel E, `ops/kernels/int8_conv.py`), its
epilogue rescaling, adding the bias, applying SiLU and requantizing.
Structural ops (concat, max-pool, upsample, split) run on the int8 codes;
adds and attention stay float and re-enter int8 at the next conv through
its calibrated input scale.

The other modes take float in and give float out at each quantized conv
(`quantized_conv2d`: the input quantized per tensor, kernel E's float
epilogue): "dynamic" (no context: the scale is the input's absmax, a device
scalar, never read back to the host, so a captured CUDA graph holds it) and
the legacy "static" (one calibrated input scale per conv, a 1-D
`act_scales`). "observe" records the input absmax of every float conv, and
"fake" fake-quantizes the weights and input of every float conv in the
training forward (QAT) with a straight-through gradient.

Calibration is matched to serving by ORDER: an "observe8" forward records
(input absmax, output absmax) at each quantized conv in execution order,
and a "static8" forward consumes the scale pairs by the same index.

Layouts follow the port: activations NCHW (channels_last on the card),
weights OIHW. Scales are f32 tensors on the host, so reading one costs no
device sync. `torch.round` rounds half to even, as `jnp.round` does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch

from yolo_infer_tpu_torch.ops.kernels.int8_conv import int8_conv, nhwc_input

INT8_MAX = 127.0
MODES = ("observe8", "static8", "observe", "static", "fake")


@dataclasses.dataclass(frozen=True)
class QAct:
    """An int8 activation (NCHW; channels_last on the card) and its f32 scalar scale: x ~= q * s."""

    q: torch.Tensor  # int8
    s: torch.Tensor  # f32, 0-d, on the host

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def dequant(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.q.float() * self.s).to(dtype)


def _codes(x: torch.Tensor) -> torch.Tensor:
    """round half to even, clip to ±127, int8."""
    return torch.clamp(torch.round(x), -INT8_MAX, INT8_MAX).to(torch.int8)


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> QAct:
    return QAct(_codes(x.float() / scale), torch.as_tensor(scale, dtype=torch.float32))


def as_float(x: Any, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return x.dequant(dtype) if isinstance(x, QAct) else x


def q_concat(xs: Sequence[Any], dim: int = 1) -> Any:
    """Concat that stays int8 when every input is a QAct: the scale is the
    largest, each input requantized to it (<= half a step of rounding);
    mixed inputs are concatenated in float."""
    if all(isinstance(x, QAct) for x in xs):
        s = xs[0].s
        for x in xs[1:]:
            s = torch.maximum(s, x.s)
        return QAct(torch.cat([_codes(x.q.float() * (x.s / s)) for x in xs], dim), s)
    dt = next((x.dtype for x in xs if not isinstance(x, QAct)), torch.float32)
    return torch.cat([as_float(x, dt) for x in xs], dim)


def q_add(a: Any, b: Any) -> torch.Tensor:
    """Residual add in float: in the float side's dtype, in bf16 when both
    sides are QAct (int8 re-entry happens at the next conv)."""
    if isinstance(a, QAct) or isinstance(b, QAct):
        if not isinstance(b, QAct):
            dt = b.dtype
        else:
            dt = a.dtype if not isinstance(a, QAct) else torch.bfloat16
        return as_float(a, dt) + as_float(b, dt)
    return a + b


def q_split2(x: Any, dim: int = 1) -> Tuple[Any, Any]:
    if isinstance(x, QAct):
        a, b = x.q.chunk(2, dim)
        return QAct(a, x.s), QAct(b, x.s)
    return tuple(x.chunk(2, dim))


def q_split_at(x: Any, c: int, dim: int = 1) -> Tuple[Any, Any]:
    if isinstance(x, QAct):
        a, b = x.q.split((c, x.q.shape[dim] - c), dim)
        return QAct(a, x.s), QAct(b, x.s)
    return tuple(x.split((c, x.shape[dim] - c), dim))


def quantize_weights_per_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW float weights -> (int8 weights, per-Cout f32 scales), computed in f32."""
    wf = w.float()
    absmax = wf.abs().amax(dim=(1, 2, 3))
    scale = torch.clamp(absmax / INT8_MAX, min=1e-12)
    return _codes(wf / scale[:, None, None, None]), scale


def dequantize_weights(w_q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 OIHW weights and per-Cout scales -> float OIHW weights."""
    return (w_q.float() * scale[:, None, None, None]).to(dtype)


def fake_quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize with the straight-through estimator (QAT): the
    value of q * scale, the gradient of the identity."""
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX) * scale
    return x + (q - x).detach()


def dynamic_act_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor scale max(|x|, 1e-6) / 127, a 0-d f32 tensor on x's device."""
    return torch.clamp(x.detach().float().abs().amax(), min=1e-6) / INT8_MAX


def quantized_conv2d(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor, bias: Optional[torch.Tensor], *,
                     stride: int = 1, act: bool = True, x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 conv of the dynamic and legacy static modes: x (B, Ci, H, W)
    float is quantized per tensor (the dynamic scale when `x_scale` is None),
    the conv sums int8 x int8 exactly, and kernel E's float epilogue gives
    cast(acc * x_scale * w_scale) to x's dtype, + bias, SiLU: (B, Co, Ho,
    Wo) in x's dtype (an NHWC tensor seen as NCHW). w_q is (Co, k, k, Ci)
    int8. The JAX package's `quantized_conv2d` and the fp-in/fp-out branch of
    `nn/layers.py conv_block`."""
    if x_scale is None:
        x_scale = dynamic_act_scale(x)
    xq = quantize_act(x, x_scale).q
    y = int8_conv(nhwc_input(xq), w_q, x_scale * w_scale, bias, 1.0, stride=stride, act=act,
                  epilogue_dtype=x.dtype, requant=False)
    return y.permute(0, 3, 1, 2)


@dataclasses.dataclass
class QuantContext:
    """Active during one forward of a quantized model.

    mode:
      "observe8" - at each quantized conv run a float conv on the dequantized
                   weights and record (input absmax, output absmax), in order
      "static8"  - int8 residency: consume (in, out) scale pairs (an (n, 2)
                   tensor of absmax values) in order; eligible convs take and
                   give QAct through kernel E
      "observe"  - record the input absmax of every float conv, in order
      "static"   - legacy: consume one input absmax per quantized conv (an
                   (n,) tensor) in order; float in, float out
      "fake"     - QAT: fake-quantize the weights (per output channel) and
                   the input (the static scale when `act_scales` is given,
                   else the dynamic one) of every float conv
    A quantized model with no context runs "dynamic".
    """

    mode: str
    collected: List[torch.Tensor] = dataclasses.field(default_factory=list)
    act_scales: Optional[torch.Tensor] = None  # (n, 2) static8 | (n,) static and fake, f32 on the host
    index: int = 0
    epilogue_dtype: Optional[torch.dtype] = None  # static8 epilogue dtype (None: bf16)
    float_convs: Optional[set] = None  # static8: conv indices forced to run dequantized-float
    int8_min_channels: int = 128  # static8: convs with min(Cin, Cout) below this run dequantized-bf16
    # C=64 convs quantize when their input rows N*H*W reach this volume
    int8_c64_min_rows: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("YOLO_INT8_C64_MIN_ROWS", 400_000)))
    # static8: 1/sy of each pair as a Python float, kernel E's epilogue argument
    # (`out_scale_inverses`); a caller that traces the forward passes them in,
    # since a traced program cannot read a tensor back to the host
    syinv: Optional[List[float]] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.act_scales is not None:
            self.act_scales = torch.as_tensor(self.act_scales, dtype=torch.float32).cpu()
            want = 2 if self.mode == "static8" else 1
            if self.act_scales.dim() != want:
                raise ValueError(f"mode {self.mode!r} takes {want}-D activation scales, "
                                 f"got shape {tuple(self.act_scales.shape)}")
            if self.mode == "static8" and self.syinv is None:
                self.syinv = out_scale_inverses(self.act_scales)

    def observe(self, x: torch.Tensor) -> None:
        self.collected.append(x.detach().float().abs().amax())

    def observe_pair(self, x: torch.Tensor, y: torch.Tensor) -> None:
        self.collected.append(torch.stack([x.float().abs().amax(), y.float().abs().amax()]))

    def next_scale(self) -> torch.Tensor:
        i = self.index
        self.index += 1
        return torch.clamp(self.act_scales[i], min=1e-6) / INT8_MAX

    def next_scale_pair(self) -> Tuple[torch.Tensor, torch.Tensor]:
        i = self.index
        self.index += 1
        pair = torch.clamp(self.act_scales[i], min=1e-6) / INT8_MAX
        return pair[0], pair[1]

    def exempt(self, idx: int, ci: int, co: int, rows: int) -> bool:
        """Whether quantized conv number `idx` runs dequantized-float: C >=
        128 convs always run int8; C = 64 convs when rows = N*H*W clears
        `int8_c64_min_rows`. Thresholds above 1024 ask for every conv
        exempted (weight-only int8) and are not relaxed by the rows rule."""
        thresh = self.int8_min_channels
        if rows >= self.int8_c64_min_rows and thresh <= 1024:
            thresh = min(thresh, 64)
        return min(ci, co) < thresh or (self.float_convs is not None and idx in self.float_convs)


def out_scale_inverses(act_scales: torch.Tensor) -> List[float]:
    """1/sy of every (in, out) absmax pair, as `next_scale_pair` makes sy
    (f32: clamp, / 127, then the reciprocal), as Python floats."""
    sy = torch.clamp(torch.as_tensor(act_scales, dtype=torch.float32), min=1e-6)[:, 1] / INT8_MAX
    return (1.0 / sy).tolist()


_ACTIVE: List[QuantContext] = []


def current_context() -> Optional[QuantContext]:
    return _ACTIVE[-1] if _ACTIVE else None


class quant_context:
    """with quant_context(QuantContext(...)) as ctx: model(x)"""

    def __init__(self, ctx: QuantContext):
        self.ctx = ctx

    def __enter__(self) -> QuantContext:
        _ACTIVE.append(self.ctx)
        return self.ctx

    def __exit__(self, *exc) -> bool:
        _ACTIVE.pop()
        return False
