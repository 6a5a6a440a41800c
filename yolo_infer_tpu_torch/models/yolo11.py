"""YOLO11 module, seeded builder, BN folding and dtype cast (detect task).

Port of `yolo_infer_tpu/models/yolo11.py`. `YOLO11` runs the layer DAG of a
`ModelSpec` in plain form: the JAX package's halo-tiled early stage, its
space-to-depth stem and batch chunking only work around TPU layouts and give
identical outputs, so they have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from yolo_infer_tpu_torch.models import blocks as B
from yolo_infer_tpu_torch.models.spec import ModelSpec, build_spec, save_indices
from yolo_infer_tpu_torch.nn.layers import upsample2x


class YOLO11(nn.Module):
    """The YOLO11 DAG with ultralytics naming (`model.<i>.…`)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        if spec.task != "detect":
            raise NotImplementedError(f"task {spec.task!r} is not ported yet; only 'detect' is")
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
            else:
                raise ValueError(f"unknown layer type {t}")
            layers.append(m)
        self.model = nn.ModuleList(layers)
        self.spec = spec
        self._keep = frozenset(save_indices(spec))

    def forward(self, x: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """`x` is (B, H, W, 3) float in [0, 1], NHWC as the JAX package takes it.

        Returns {"feats": [(B, Hi, Wi, 4*reg_max + nc)] * 3}, NHWC views.
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
            elif t == "Detect":
                return {"feats": [f.permute(0, 2, 3, 1) for f in m(inp)]}
            else:
                y = m(inp)
            prev = y
            if layer.idx in self._keep:
                ys[layer.idx] = y
        raise ValueError("spec has no Detect head")


@torch.no_grad()
def _init_weights(model: YOLO11, generator: torch.Generator) -> None:
    """Kaiming-uniform conv weights (var 1/fan_in), identity BN, zero biases,
    then the Detect bias priors (box 1.0, cls = prior frequency)."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
            bound = math.sqrt(1.0 / fan_in) * math.sqrt(3.0)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    spec = model.spec
    det = model.model[-1]
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
    """Cast conv weights and biases to `dtype` in place. Batch-norm
    statistics of an unfolded model stay f32, as the JAX state tree does."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype)
    return model
