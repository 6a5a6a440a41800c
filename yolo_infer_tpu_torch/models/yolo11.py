"""YOLO11 module, seeded `build_model`, BN folding and dtype cast (every task).

Port of `yolo_infer_tpu/models/yolo11.py`. `YOLO11` runs the layer DAG of a
`ModelSpec` in plain form: the JAX package's halo-tiled early stage, its
space-to-depth stem and batch chunking only work around TPU layouts and give
identical outputs, so they have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn as nn

from yolo_infer_tpu_torch.models import blocks as B
from yolo_infer_tpu_torch.models.spec import ModelSpec, build_spec, save_indices
from yolo_infer_tpu_torch.nn.layers import upsample2x


class YOLO11(nn.Module):
    """The YOLO11 DAG with ultralytics naming (`model.<i>.…`)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        layers: List[nn.Module] = []
        for layer in spec.layers:
            t = layer.typ
            if t == "Conv":
                m = B.Conv(layer.c_in, layer.c_out, layer.kw["k"], layer.kw["stride"])
            elif t == "C3k2":
                m = B.C3k2(layer.c_in, layer.c_out, layer.kw["n"], layer.kw["c3k"], layer.kw["e"], layer.kw["shortcut"])
            elif t == "SPPF":
                m = B.SPPF(layer.c_in, layer.c_out, layer.kw["k"])
            elif t == "C2PSA":
                m = B.C2PSA(layer.c_in, layer.kw["n"], e=layer.kw["e"])
            elif t in ("Upsample", "Concat"):
                m = nn.Identity()  # parameter-free; keeps `model.<i>` aligned with the spec
            elif t == "Detect":
                m = B.Detect(spec.nc, layer.c_in, spec.reg_max)
            elif t == "Segment":
                m = B.Segment(spec.nc, layer.c_in, spec.reg_max, spec.nm)
            elif t == "Pose":
                m = B.Pose(spec.nc, layer.c_in, spec.reg_max, spec.kpt_shape)
            elif t == "OBB":
                m = B.OBB(spec.nc, layer.c_in, spec.reg_max, spec.ne)
            elif t == "Classify":
                m = B.Classify(layer.c_in, spec.nc, layer.kw["c_hidden"])
            else:
                raise ValueError(f"unknown layer type {t}")
            layers.append(m)
        self.model = nn.ModuleList(layers)
        self.spec = spec
        self._keep = frozenset(save_indices(spec))

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        """`x` is (B, H, W, 3) float in [0, 1], NHWC as the JAX package takes it.

        Returns the JAX package's head dict, maps as NHWC views:
          detect  : {"feats": [(B, Hi, Wi, 4*reg_max + nc)] * 3}
          segment : + {"mc": [(B, Hi, Wi, nm)] * 3, "proto": (B, H/4, W/4, nm)}
          pose    : + {"kpts": [(B, Hi, Wi, K*D)] * 3}
          obb     : + {"angle": [(B, Hi, Wi, ne)] * 3}
          classify: {"logits": (B, nc) f32}
        """
        x = x.permute(0, 3, 1, 2).to(self.model[0].conv.weight.dtype)
        ys: Dict[int, torch.Tensor] = {}
        prev = x
        for layer in self.spec.layers:
            m = self.model[layer.idx]
            if isinstance(layer.frm, tuple):
                inp = [prev if f == layer.idx - 1 else ys[f] for f in layer.frm]
            else:
                inp = prev if layer.frm == layer.idx - 1 or layer.idx == 0 else ys[layer.frm]
            t = layer.typ
            if t == "Upsample":
                y = upsample2x(inp)
            elif t == "Concat":
                y = torch.cat(inp, 1)
            elif t in ("Detect", "Segment", "Pose", "OBB"):
                return {k: [f.permute(0, 2, 3, 1) for f in v] if isinstance(v, list) else v.permute(0, 2, 3, 1)
                        for k, v in m(inp).items()}
            elif t == "Classify":
                return {"logits": m(inp).float()}
            else:
                y = m(inp)
            prev = y
            if layer.idx in self._keep:
                ys[layer.idx] = y
        raise ValueError("spec has no head")


@torch.no_grad()
def _init_weights(model: YOLO11, generator: torch.Generator) -> None:
    """Kaiming-uniform conv and transposed-conv weights (var 1/fan_in),
    identity BN, zero biases, linear weights and bias uniform in
    ±sqrt(1/fan_in); then the Detect bias priors (box 1.0, cls = prior
    frequency) on the heads that have them."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel()  # (O, I/g, kh, kw) or, transposed, (I, O, kh, kw)
            bound = math.sqrt(1.0 / fan_in) * math.sqrt(3.0)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            bound = math.sqrt(1.0 / m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
    spec = model.spec
    det = model.model[-1]
    if not isinstance(det, B.Detect):
        return
    for i, s in enumerate(spec.strides):
        det.cv2[i][-1].bias.fill_(1.0)
        det.cv3[i][-1].bias.fill_(math.log(5 / spec.nc / (640 / s) ** 2))


def build_model(task: str = "detect", size: str = "n", nc: int = 80, *, seed: int = 0) -> Tuple[YOLO11, ModelSpec]:
    """A YOLO11 model (unfolded, f32, on the CPU) with weights drawn from
    `torch.Generator().manual_seed(seed)`."""
    spec = build_spec(task=task, size=size, nc=nc)
    model = YOLO11(spec)
    _init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval(), spec


def fold_model(model: YOLO11) -> YOLO11:
    """Fold every batch norm into its conv, in place (deploy form)."""
    for m in model.modules():
        if isinstance(m, B.Conv):
            m.fold()
    return model


def cast_model(model: YOLO11, dtype: torch.dtype) -> YOLO11:
    """Cast conv, transposed-conv and linear weights and biases to `dtype` in
    place. Batch-norm statistics of an unfolded model stay f32, as the JAX
    state tree does."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            m.to(dtype)
    return model
