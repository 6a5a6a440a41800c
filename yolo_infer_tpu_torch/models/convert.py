"""Weight loading: ultralytics-named state dicts and JAX parameter trees.

`load_state_dict` takes a flat torch state dict with ultralytics key names —
the naming `yolo_infer_tpu/models/convert.py` maps (`model.{i}.cv1.conv.weight`,
`….bn.running_var`, `….m.{j}.…`, `….cv3.{i}.0.0.…`) — and returns a
`YOLO11`. The port's modules carry those names, so loading is
`nn.Module.load_state_dict` after a strict key check.

`params_from_jax` takes the JAX package's parameter tree as numpy arrays
(folded `{"w", "b"}` nodes, or unfolded `{"w", "gamma", "beta"}` nodes plus
the `{"mean", "var"}` state tree), renames it to the same keys with HWIO
kernels transposed to OIHW, and loads it. That is how the tests run one set
of weights through both packages.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from yolo_infer_tpu_torch.models.spec import ModelSpec
from yolo_infer_tpu_torch.models.yolo11 import YOLO11, fold_model

# keys a checkpoint may carry that the port has no use for: BN step counters
# and the fixed DFL expectation conv (the decode computes it arithmetically)
_IGNORED = ("num_batches_tracked", ".dfl.")


def load_state_dict(sd: Mapping[str, Any], spec: ModelSpec) -> YOLO11:
    """Ultralytics-named flat state dict -> `YOLO11` (CPU, f32, eval).

    A dict with no batch-norm keys is taken as folded (`….conv.bias` in their
    place) and yields a folded model. Missing or unexpected keys raise
    KeyError, a tensor of the wrong shape ValueError.
    """
    tensors = {
        k: torch.tensor(np.asarray(v, np.float32))
        for k, v in sd.items()
        if not any(s in k for s in _IGNORED)
    }
    model = YOLO11(spec)
    if not any(".bn." in k for k in tensors):
        fold_model(model)
    own = {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    missing = sorted(own.keys() - tensors.keys())
    unexpected = sorted(tensors.keys() - own.keys())
    if missing or unexpected:
        raise KeyError(f"state dict does not fit the {spec.size}/{spec.task} spec: "
                       f"missing {missing[:5]}, unexpected {unexpected[:5]}")
    wrong = [k for k, v in own.items() if v.shape != tensors[k].shape]
    if wrong:
        raise ValueError(f"state dict does not fit the {spec.size}/{spec.task} spec: "
                         f"{wrong[0]} is {tuple(tensors[wrong[0]].shape)}, expected {tuple(own[wrong[0]].shape)}")
    model.load_state_dict(tensors, strict=False)
    return model.eval()


def _oihw(w) -> np.ndarray:
    """HWIO (JAX) -> OIHW (torch)."""
    return np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1))


def _conv(out: Dict[str, np.ndarray], prefix: str, p, s) -> None:
    """One Conv(+BN) node: folded {"w","b"} or unfolded {"w","gamma","beta"} + state."""
    out[f"{prefix}.conv.weight"] = _oihw(p["w"])
    if "gamma" in p:
        out[f"{prefix}.bn.weight"] = p["gamma"]
        out[f"{prefix}.bn.bias"] = p["beta"]
        out[f"{prefix}.bn.running_mean"] = s["mean"]
        out[f"{prefix}.bn.running_var"] = s["var"]
    else:
        out[f"{prefix}.conv.bias"] = p["b"]


def _conv2d(out: Dict[str, np.ndarray], prefix: str, p) -> None:
    """Plain conv with bias (the head's output projections)."""
    out[f"{prefix}.weight"] = _oihw(p["w"])
    out[f"{prefix}.bias"] = p["b"]


def _sub(s, key):
    return None if s is None else s[key]


def _bottleneck(out, prefix, p, s) -> None:
    for name in ("cv1", "cv2"):
        _conv(out, f"{prefix}.{name}", p[name], _sub(s, name))


def _c3k2(out, prefix, p, s) -> None:
    _conv(out, f"{prefix}.cv1", p["cv1"], _sub(s, "cv1"))
    _conv(out, f"{prefix}.cv2", p["cv2"], _sub(s, "cv2"))
    for j, mp in enumerate(p["m"]):
        ms = _sub(_sub(s, "m"), j)
        if "cv3" in mp:  # C3k inner block
            for name in ("cv1", "cv2", "cv3"):
                _conv(out, f"{prefix}.m.{j}.{name}", mp[name], _sub(ms, name))
            for q, bp in enumerate(mp["m"]):
                _bottleneck(out, f"{prefix}.m.{j}.m.{q}", bp, _sub(_sub(ms, "m"), q))
        else:
            _bottleneck(out, f"{prefix}.m.{j}", mp, ms)


def _c2psa(out, prefix, p, s) -> None:
    _conv(out, f"{prefix}.cv1", p["cv1"], _sub(s, "cv1"))
    _conv(out, f"{prefix}.cv2", p["cv2"], _sub(s, "cv2"))
    for j, mp in enumerate(p["m"]):
        ms = _sub(_sub(s, "m"), j)
        for name in ("qkv", "proj", "pe"):
            _conv(out, f"{prefix}.m.{j}.attn.{name}", mp["attn"][name], _sub(_sub(ms, "attn"), name))
        _conv(out, f"{prefix}.m.{j}.ffn.0", mp["ffn1"], _sub(ms, "ffn1"))
        _conv(out, f"{prefix}.m.{j}.ffn.1", mp["ffn2"], _sub(ms, "ffn2"))


# JAX's flat 5-node cls branch -> ultralytics Seq(Seq(DW, Conv), Seq(DW, Conv), Conv2d)
_CLS_NAMES = ("0.0", "0.1", "1.0", "1.1")


def _detect(out, prefix, p, s) -> None:
    for i, (bp, cp) in enumerate(zip(p["cv2"], p["cv3"])):
        bs, cs = _sub(_sub(s, "cv2"), i), _sub(_sub(s, "cv3"), i)
        _conv(out, f"{prefix}.cv2.{i}.0", bp[0], _sub(bs, 0))
        _conv(out, f"{prefix}.cv2.{i}.1", bp[1], _sub(bs, 1))
        _conv2d(out, f"{prefix}.cv2.{i}.2", bp[2])
        for q, name in enumerate(_CLS_NAMES):
            _conv(out, f"{prefix}.cv3.{i}.{name}", cp[q], _sub(cs, q))
        _conv2d(out, f"{prefix}.cv3.{i}.2", cp[4])


def _extra_branch(out, prefix, ps, ss) -> None:
    """The `cv4` branch: per level [Conv, Conv, Conv2d]."""
    for i, bp in enumerate(ps):
        bs = _sub(ss, i)
        _conv(out, f"{prefix}.{i}.0", bp[0], _sub(bs, 0))
        _conv(out, f"{prefix}.{i}.1", bp[1], _sub(bs, 1))
        _conv2d(out, f"{prefix}.{i}.2", bp[2])


def _proto(out, prefix, p, s) -> None:
    _conv(out, f"{prefix}.cv1", p["cv1"], _sub(s, "cv1"))
    # (kh, kw, O, I) -> torch ConvTranspose2d's (I, O, kh, kw)
    out[f"{prefix}.upsample.weight"] = np.ascontiguousarray(np.asarray(p["up"]["wt"], np.float32).transpose(3, 2, 0, 1))
    out[f"{prefix}.upsample.bias"] = p["up"]["b"]
    _conv(out, f"{prefix}.cv2", p["cv2"], _sub(s, "cv2"))
    _conv(out, f"{prefix}.cv3", p["cv3"], _sub(s, "cv3"))


def _classify(out, prefix, p, s) -> None:
    _conv(out, f"{prefix}.conv", p["conv"], _sub(s, "conv"))
    out[f"{prefix}.linear.weight"] = np.ascontiguousarray(np.asarray(p["linear"]["w"], np.float32).T)  # (I, O) -> (O, I)
    out[f"{prefix}.linear.bias"] = p["linear"]["b"]


def params_from_jax(params: Mapping[str, Any], spec: ModelSpec, state: Optional[Mapping[str, Any]] = None) -> YOLO11:
    """JAX parameter tree (numpy leaves) -> `YOLO11` holding the same weights.

    `state` is the JAX batch-norm state tree; pass it with unfolded params
    and leave it None for folded ones.
    """
    sd: Dict[str, np.ndarray] = {}
    for layer in spec.layers:
        key, prefix = str(layer.idx), f"model.{layer.idx}"
        p = params.get(key)
        s = state.get(key) if state is not None else None
        t = layer.typ
        if t == "Conv":
            _conv(sd, prefix, p, s)
        elif t == "C3k2":
            _c3k2(sd, prefix, p, s)
        elif t == "SPPF":
            _bottleneck(sd, prefix, p, s)  # same two convs, cv1 and cv2
        elif t == "C2PSA":
            _c2psa(sd, prefix, p, s)
        elif t in ("Detect", "Segment", "Pose", "OBB"):
            _detect(sd, prefix, p, s)
            if t != "Detect":
                _extra_branch(sd, f"{prefix}.cv4", p["cv4"], _sub(s, "cv4"))
            if t == "Segment":
                _proto(sd, f"{prefix}.proto", p["proto"], _sub(s, "proto"))
        elif t == "Classify":
            _classify(sd, prefix, p, s)
        elif t not in ("Upsample", "Concat"):
            raise NotImplementedError(f"layer type {t} is not ported yet")
    return load_state_dict(sd, spec)
