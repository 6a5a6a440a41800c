"""YOLO11 architecture specification (all sizes x all tasks).

The port's own copy of `yolo_infer_tpu/models/spec.py`: a declarative layer
table that `build_spec` resolves into concrete channel widths/depths per
size. It is copied rather than imported because importing the JAX package's
`models` pulls in `jax`, which the port never imports.

YOLO11 {n,s,m,l,x} x {detect, segment, classify, pose, obb}; anchor-free,
strides 8/16/32, DFL reg_max=16.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple, Union

SIZES = ("n", "s", "m", "l", "x")
TASKS = ("detect", "segment", "classify", "pose", "obb")

# size -> (depth_multiple, width_multiple, max_channels)
SCALES: Dict[str, Tuple[float, float, int]] = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}

REG_MAX = 16
STRIDES = (8, 16, 32)

# (from, repeats, module, args) — args follow the module's constructor order.
# Backbone + detect head graph shared by detect/segment/pose/obb.
_BACKBONE: List[Tuple[Union[int, List[int]], int, str, List[Any]]] = [
    (-1, 1, "Conv", [64, 3, 2]),        # 0  P1/2
    (-1, 1, "Conv", [128, 3, 2]),       # 1  P2/4
    (-1, 2, "C3k2", [256, False, 0.25]),# 2
    (-1, 1, "Conv", [256, 3, 2]),       # 3  P3/8
    (-1, 2, "C3k2", [512, False, 0.25]),# 4
    (-1, 1, "Conv", [512, 3, 2]),       # 5  P4/16
    (-1, 2, "C3k2", [512, True]),       # 6
    (-1, 1, "Conv", [1024, 3, 2]),      # 7  P5/32
    (-1, 2, "C3k2", [1024, True]),      # 8
    (-1, 1, "SPPF", [1024, 5]),         # 9
    (-1, 2, "C2PSA", [1024]),           # 10
]

_NECK: List[Tuple[Union[int, List[int]], int, str, List[Any]]] = [
    (-1, 1, "Upsample", []),            # 11
    ([-1, 6], 1, "Concat", []),         # 12
    (-1, 2, "C3k2", [512, False]),      # 13
    (-1, 1, "Upsample", []),            # 14
    ([-1, 4], 1, "Concat", []),         # 15
    (-1, 2, "C3k2", [256, False]),      # 16  P3/8 small
    (-1, 1, "Conv", [256, 3, 2]),       # 17
    ([-1, 13], 1, "Concat", []),        # 18
    (-1, 2, "C3k2", [512, False]),      # 19  P4/16 medium
    (-1, 1, "Conv", [512, 3, 2]),       # 20
    ([-1, 10], 1, "Concat", []),        # 21
    (-1, 2, "C3k2", [1024, True]),      # 22  P5/32 large
]

_HEADS: Dict[str, Tuple[Union[int, List[int]], int, str, List[Any]]] = {
    "detect": ([16, 19, 22], 1, "Detect", []),
    "segment": ([16, 19, 22], 1, "Segment", []),
    "pose": ([16, 19, 22], 1, "Pose", []),
    "obb": ([16, 19, 22], 1, "OBB", []),
}

# Classification model: the upstream yolo11-cls backbone OMITS SPPF —
# layers 0-8 match detect, then C2PSA sits at index 9 and Classify at 10
# (keeps converted official *-cls.pt checkpoints layer-aligned).
_CLS_BACKBONE: List[Tuple[Union[int, List[int]], int, str, List[Any]]] = (
    _BACKBONE[:9] + [(-1, 2, "C2PSA", [1024])]  # 9
)
_CLS_HEAD: Tuple[Union[int, List[int]], int, str, List[Any]] = (-1, 1, "Classify", [])  # 10


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


@dataclasses.dataclass(frozen=True)
class Layer:
    """One resolved node of the model DAG."""

    idx: int
    frm: Union[int, Tuple[int, ...]]  # absolute input layer indices (-1 already resolved)
    typ: str
    c_in: Union[int, Tuple[int, ...]]
    c_out: int
    kw: Dict[str, Any]  # resolved constructor args (n, k, stride, c3k, e, shortcut...)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    task: str
    size: str
    nc: int
    layers: Tuple[Layer, ...]
    out_indices: Tuple[int, ...]  # layers feeding the head
    strides: Tuple[int, ...] = STRIDES
    reg_max: int = REG_MAX
    # task extras
    nm: int = 32   # segment: number of mask coefficients
    npr: int = 256 # segment: proto channels (pre width-scale)
    kpt_shape: Tuple[int, int] = (17, 3)  # pose
    ne: int = 1    # obb: number of extra (angle) outputs


def _resolve_repeats(n: int, depth: float) -> int:
    return max(round(n * depth), 1) if n > 1 else n


def build_spec(task: str = "detect", size: str = "n", nc: int = 80, **extras) -> ModelSpec:
    """Resolve the declarative table into concrete per-layer channels."""
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; expected one of {TASKS}")
    if size not in SIZES:
        raise ValueError(f"unknown size {size!r}; expected one of {SIZES}")
    depth, width, max_ch = SCALES[size]

    if task == "classify":
        table = list(_CLS_BACKBONE) + [_CLS_HEAD]
    else:
        table = list(_BACKBONE) + list(_NECK) + [_HEADS[task]]

    layers: List[Layer] = []
    ch: List[int] = []  # output channels per layer; ch[-1] == previous layer
    for i, (frm, n, typ, args) in enumerate(table):
        n_rep = _resolve_repeats(n, depth)
        kw: Dict[str, Any] = {}
        if isinstance(frm, list):
            frm_abs = tuple(f if f >= 0 else i + f for f in frm)
            c_in: Union[int, Tuple[int, ...]] = tuple(ch[f] for f in frm_abs)
        else:
            frm_abs = frm if frm >= 0 else i + frm
            c_in = ch[frm_abs] if i > 0 else 3

        if typ == "Conv":
            c2 = make_divisible(min(args[0], max_ch) * width, 8)
            kw = {"k": args[1], "stride": args[2]}
        elif typ == "C3k2":
            c2 = make_divisible(min(args[0], max_ch) * width, 8)
            c3k = bool(args[1]) or size in ("m", "l", "x")
            e = args[2] if len(args) > 2 else 0.5
            kw = {"n": n_rep, "c3k": c3k, "e": e, "shortcut": True}
        elif typ == "SPPF":
            c2 = make_divisible(min(args[0], max_ch) * width, 8)
            kw = {"k": args[1]}
        elif typ == "C2PSA":
            c2 = make_divisible(min(args[0], max_ch) * width, 8)
            kw = {"n": n_rep, "e": 0.5}
        elif typ == "Upsample":
            c2 = c_in  # type: ignore[assignment]
        elif typ == "Concat":
            c2 = sum(c_in)  # type: ignore[arg-type]
        elif typ in ("Detect", "Segment", "Pose", "OBB"):
            c2 = 0  # heads emit task-specific pytrees, not a single map
            kw = {"nc": nc}
        elif typ == "Classify":
            c2 = nc
            kw = {"nc": nc, "c_hidden": 1280}
        else:
            raise ValueError(f"unknown module type {typ!r}")
        layers.append(Layer(idx=i, frm=frm_abs, typ=typ, c_in=c_in, c_out=c2, kw=kw))
        ch.append(c2)

    head = layers[-1]
    out_indices = head.frm if isinstance(head.frm, tuple) else (head.frm,)
    return ModelSpec(task=task, size=size, nc=nc, layers=tuple(layers), out_indices=out_indices, **extras)


def save_indices(spec: ModelSpec) -> Tuple[int, ...]:
    """Indices whose outputs must be retained during DAG execution."""
    needed = set()
    for layer in spec.layers:
        frm = layer.frm if isinstance(layer.frm, tuple) else (layer.frm,)
        for f in frm:
            if f != layer.idx - 1:
                needed.add(f)
    return tuple(sorted(needed))
