"""int8 quantization primitives and the calibration / static8 context.

Port of `yolo_infer_tpu/nn/quantize.py` for the post-training static8 path:
weights int8 per output channel, activations int8 per tensor with scales
calibrated offline, and every quantized conv int8 in, int8 out (kernel E,
`ops/kernels/int8_conv.py`), its epilogue rescaling, adding the bias,
applying SiLU and requantizing. Structural ops (concat, max-pool, upsample,
split) run on the int8 codes; adds and attention stay float and re-enter
int8 at the next conv through its calibrated input scale.

Calibration is matched to serving by ORDER: an "observe8" forward records
(input absmax, output absmax) at each quantized conv in execution order,
and a "static8" forward consumes the scale pairs by the same index.

Layouts follow the port: activations NCHW (channels_last on the card),
weights OIHW. Scales are f32 tensors on the host, so reading one costs no
device sync. `torch.round` rounds half to even, as `jnp.round` does.

The JAX package's "dynamic", legacy 1-D "static" and QAT "fake" modes are
not ported (ROADMAP Queue 1 item 6) and raise.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch

INT8_MAX = 127.0
MODES = ("observe8", "static8")
_UNPORTED_MODES = ("dynamic", "static", "fake", "observe")
UNPORTED = "is not ported yet (ROADMAP Queue 1 item 6: dynamic, legacy static and QAT fake-quant int8)"


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


@dataclasses.dataclass
class QuantContext:
    """Active during one forward of a quantized model.

    mode:
      "observe8" - at each quantized conv run a float conv on the dequantized
                   weights and record (input absmax, output absmax), in order
      "static8"  - int8 residency: consume (in, out) scale pairs (an (n, 2)
                   tensor of absmax values) in order; eligible convs take and
                   give QAct through kernel E
    """

    mode: str
    collected: List[torch.Tensor] = dataclasses.field(default_factory=list)
    act_scales: Optional[torch.Tensor] = None  # (n, 2) f32 on the host (static8)
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
        if self.mode in _UNPORTED_MODES:
            raise NotImplementedError(f"quantization mode {self.mode!r} {UNPORTED}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.act_scales is not None:
            self.act_scales = torch.as_tensor(self.act_scales, dtype=torch.float32).cpu()
            if self.act_scales.dim() != 2:
                raise NotImplementedError(f"1-D (legacy static) activation scales {UNPORTED}")
            if self.syinv is None:
                self.syinv = out_scale_inverses(self.act_scales)

    def observe_pair(self, x: torch.Tensor, y: torch.Tensor) -> None:
        self.collected.append(torch.stack([x.float().abs().amax(), y.float().abs().amax()]))

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
