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
of weights through both packages. A quantized tree (`quantize_params_tree`:
`{"w_q", "w_scale", "b"}` nodes) loads into the int8 deploy form
(`models/yolo11.py quantize_model`), its int8 weights carried as they are:
the keys `….w_q` ((Co, k*k*Ci) int8 rows), `….w_scale` and `….b`.

`params_to_jax` is the way back: a `YOLO11` as the JAX package's parameter
tree (and batch-norm state tree when unfused), so that a checkpoint the port
writes (`core/model.py save`) loads in the JAX package.

`.pt` files: a jax-free copy of the JAX package's loader
(`yolo_infer_tpu/models/convert.py` `_PermissiveUnpickler`,
`permissive_torch_load`, `extract_state_dict`, `infer_model_meta`) unpickles
an ultralytics checkpoint without ultralytics and recovers its flat state
dict, whose names are already the port's (`load_pt_checkpoint`).
"""

from __future__ import annotations

import copy
import logging
import pickle
import types
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from yolo_infer_tpu_torch.models import blocks as B
from yolo_infer_tpu_torch.models.spec import ModelSpec, build_spec
from yolo_infer_tpu_torch.models.yolo11 import YOLO11, fold_model, quantize_model

logger = logging.getLogger(__name__)

# keys a checkpoint may carry that the port has no use for: BN step counters
# and the fixed DFL expectation conv (the decode computes it arithmetically)
_IGNORED = ("num_batches_tracked", ".dfl.")


def load_state_dict(sd: Mapping[str, Any], spec: ModelSpec) -> YOLO11:
    """Ultralytics-named flat state dict -> `YOLO11` (CPU, f32, eval).

    A dict with no batch-norm keys is taken as folded (`….conv.bias` in their
    place) and yields a folded model; one with `….w_q` keys, a quantized
    model (int8 `w_q` kept int8). Missing or unexpected keys raise KeyError,
    a tensor of the wrong shape ValueError.
    """
    tensors = {
        k: torch.tensor(np.asarray(v, np.int8 if k.endswith(".w_q") else np.float32))
        for k, v in sd.items()
        if not any(s in k for s in _IGNORED)
    }
    model = YOLO11(spec)
    if not any(".bn." in k for k in tensors):
        fold_model(model)
    if any(k.endswith(".w_q") for k in tensors):
        quantize_model(model)
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
    """One Conv(+BN) node: folded {"w","b"}, unfolded {"w","gamma","beta"} +
    state, or quantized {"w_q","w_scale","b"} (HWIO int8 -> (Co, k*k*Ci) rows)."""
    if "w_q" in p:
        w_q = np.asarray(p["w_q"], np.int8)
        out[f"{prefix}.w_q"] = np.ascontiguousarray(w_q.transpose(3, 0, 1, 2).reshape(w_q.shape[3], -1))
        out[f"{prefix}.w_scale"] = p["w_scale"]
        out[f"{prefix}.b"] = p["b"]
        return
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
    return load_state_dict(state_dict_from_jax(params, spec, state), spec)


def state_dict_from_jax(params: Mapping[str, Any], spec: ModelSpec,
                        state: Optional[Mapping[str, Any]] = None) -> Dict[str, np.ndarray]:
    """JAX parameter tree (numpy leaves) -> the port's state dict (numpy)."""
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
    return sd


# ---------------------------------------------------------------------------
# the way back: YOLO11 -> JAX parameter (and state) trees
# ---------------------------------------------------------------------------

def _leaf(t: torch.Tensor):
    """A numpy array of `t`; bfloat16 stays a torch tensor (numpy has no
    bfloat16 without ml_dtypes; `utils/msgpack.py` writes it as flax does)."""
    t = t.detach().cpu().contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _hwio(w: torch.Tensor):
    """OIHW (torch) -> HWIO (JAX)."""
    return _leaf(w.permute(2, 3, 1, 0))


def _conv_tree(m: B.Conv):
    """One Conv(+BN) as (params, state): unfolded {"w","gamma","beta"} and
    {"mean","var"}, folded {"w","b"}, or quantized {"w_q","w_scale","b"}
    (HWIO int8) with the state {} the JAX package has no use for."""
    if m.quantized:
        co = m.w_q.shape[0]
        w_q = m.w_q.view(co, m.k, m.k, -1).permute(1, 2, 3, 0)
        return {"w_q": _leaf(w_q), "w_scale": _leaf(m.w_scale), "b": _leaf(m.b)}, {}
    if m.bn is not None:
        return ({"w": _hwio(m.conv.weight), "gamma": _leaf(m.bn.weight), "beta": _leaf(m.bn.bias)},
                {"mean": _leaf(m.bn.running_mean), "var": _leaf(m.bn.running_var)})
    return {"w": _hwio(m.conv.weight), "b": _leaf(m.conv.bias)}, {}


def _plain_tree(m: nn.Conv2d):
    """The head's output projections: {"w","b"}, no state."""
    return {"w": _hwio(m.weight), "b": _leaf(m.bias)}, {}


def _named(pairs):
    """{name: (params, state)} -> (params dict, state dict)."""
    return {k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()}


def _listed(pairs):
    return [p for p, _ in pairs], [s for _, s in pairs]


def _bottleneck_tree(m):
    return _named({"cv1": _conv_tree(m.cv1), "cv2": _conv_tree(m.cv2)})


def _c3k2_tree(m: B.C3k2):
    inner = []
    for mm in m.m:
        if isinstance(mm, B.C3k):
            p, s = _named({"cv1": _conv_tree(mm.cv1), "cv2": _conv_tree(mm.cv2), "cv3": _conv_tree(mm.cv3)})
            p["m"], s["m"] = _listed([_bottleneck_tree(b) for b in mm.m])
            inner.append((p, s))
        else:
            inner.append(_bottleneck_tree(mm))
    p, s = _named({"cv1": _conv_tree(m.cv1), "cv2": _conv_tree(m.cv2)})
    p["m"], s["m"] = _listed(inner)
    return p, s


def _c2psa_tree(m: B.C2PSA):
    blocks = []
    for blk in m.m:
        a = blk.attn
        attn = _named({"qkv": _conv_tree(a.qkv), "proj": _conv_tree(a.proj), "pe": _conv_tree(a.pe)})
        blocks.append(_named({"attn": attn, "ffn1": _conv_tree(blk.ffn[0]), "ffn2": _conv_tree(blk.ffn[1])}))
    p, s = _named({"cv1": _conv_tree(m.cv1), "cv2": _conv_tree(m.cv2)})
    p["m"], s["m"] = _listed(blocks)
    return p, s


def _detect_tree(m: B.Detect, typ: str):
    box = [_listed([_conv_tree(br[0]), _conv_tree(br[1]), _plain_tree(br[2])]) for br in m.cv2]
    cls = [_listed([_conv_tree(br[0][0]), _conv_tree(br[0][1]), _conv_tree(br[1][0]), _conv_tree(br[1][1]),
                    _plain_tree(br[2])]) for br in m.cv3]
    p, s = {}, {}
    p["cv2"], s["cv2"] = _listed(box)
    p["cv3"], s["cv3"] = _listed(cls)
    if typ != "Detect":
        p["cv4"], s["cv4"] = _listed([_listed([_conv_tree(br[0]), _conv_tree(br[1]), _plain_tree(br[2])])
                                      for br in m.cv4])
    if typ == "Segment":
        pr = m.proto
        pp, ps = _named({"cv1": _conv_tree(pr.cv1), "cv2": _conv_tree(pr.cv2), "cv3": _conv_tree(pr.cv3)})
        # torch ConvTranspose2d's (I, O, kh, kw) -> the JAX package's (kh, kw, O, I)
        pp = {"cv1": pp["cv1"], "up": {"wt": _leaf(pr.upsample.weight.permute(2, 3, 1, 0)),
                                       "b": _leaf(pr.upsample.bias)}, "cv2": pp["cv2"], "cv3": pp["cv3"]}
        p["proto"], s["proto"] = pp, ps
    return p, s


def _classify_tree(m: B.Classify):
    cp, cs = _conv_tree(m.conv)
    return {"conv": cp, "linear": {"w": _leaf(m.linear.weight.t()), "b": _leaf(m.linear.bias)}}, {"conv": cs}


def params_to_jax(model: YOLO11, spec: ModelSpec, fused: bool) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """`YOLO11` -> (params, state): the JAX package's trees, the inverse of
    `params_from_jax`. `fused` gives the deploy form (a folded copy where
    the model still has batch norms) and state None; unfused needs a model
    with its batch norms and gives their state tree. Leaves are numpy
    arrays in the model's dtypes (bfloat16 as torch tensors)."""
    has_bn = any(isinstance(m, B.Conv) and m.bn is not None for m in model.modules())
    if fused and has_bn:
        model = fold_model(copy.deepcopy(model))
    elif not fused and not has_bn:
        raise ValueError("an unfused tree needs a model with its batch norms; this one is folded")
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    for layer in spec.layers:
        m, t, key = model.model[layer.idx], layer.typ, str(layer.idx)
        if t == "Conv":
            params[key], state[key] = _conv_tree(m)
        elif t in ("C3k2",):
            params[key], state[key] = _c3k2_tree(m)
        elif t == "SPPF":
            params[key], state[key] = _bottleneck_tree(m)
        elif t == "C2PSA":
            params[key], state[key] = _c2psa_tree(m)
        elif t in ("Detect", "Segment", "Pose", "OBB"):
            params[key], state[key] = _detect_tree(m, t)
        elif t == "Classify":
            params[key], state[key] = _classify_tree(m)
        elif t not in ("Upsample", "Concat"):
            raise NotImplementedError(f"layer type {t} is not ported yet")
    return params, (None if fused else state)


# ---------------------------------------------------------------------------
# ultralytics .pt files, without ultralytics
# ---------------------------------------------------------------------------

class _Stub:
    def __init__(self, *a, **k):  # pickle plumbing
        pass


# Only these module prefixes may resolve to real importable objects while
# unpickling; anything else (os, subprocess, builtins, shutil, ...) becomes an
# inert stub, closing the classic pickle gadgets. torch, numpy and collections
# rebuild the tensors; ultralytics classes become stubs whose module tree is
# walked structurally. Load checkpoints from trusted sources only all the same.
_SAFE_MODULE_PREFIXES = ("torch", "numpy", "collections")


class _PermissiveUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".", 1)[0] in _SAFE_MODULE_PREFIXES:
            try:
                return super().find_class(module, name)
            except Exception:  # noqa: BLE001 - a missing class becomes a stub
                pass
        return type(name, (_Stub,), {"__module__": module})


def permissive_torch_load(path: Union[str, Path]) -> Any:
    """`torch.load` of a checkpoint with its unimportable classes stubbed."""
    shim = types.ModuleType("permissive_pickle")
    shim.Unpickler = _PermissiveUnpickler
    shim.load = lambda f, **k: _PermissiveUnpickler(f).load()
    return torch.load(str(path), pickle_module=shim, weights_only=False, map_location="cpu")


def extract_state_dict(module: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Walk a (possibly stubbed) torch module tree -> flat {name: float32 array}."""
    out: Dict[str, np.ndarray] = {}

    def _tensor(v):
        return np.asarray(v.detach().float().numpy()) if hasattr(v, "detach") else np.asarray(v, np.float32)

    d = getattr(module, "__dict__", {})
    for store in ("_parameters", "_buffers"):
        for name, v in (d.get(store) or {}).items():
            if v is not None:
                out[f"{prefix}{name}"] = _tensor(v)
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            out.update(extract_state_dict(child, f"{prefix}{name}."))
    return out


_C0_TO_SIZE = {16: "n", 32: "s", 96: "x"}  # 64 is m or l (told apart by depth)


def infer_model_meta(sd: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """(size, task, nc, ...) from tensor shapes alone."""
    c0 = sd["model.0.conv.weight"].shape[0]
    if c0 == 64:
        size = "l" if "model.2.m.1.cv1.conv.weight" in sd else "m"
    else:
        size = _C0_TO_SIZE.get(c0)
    if size is None:
        raise ValueError(f"cannot infer model size from stem width {c0}")
    head_idx = max(int(k.split(".")[1]) for k in sd if k.startswith("model."))
    h = f"model.{head_idx}"
    meta: Dict[str, Any] = {"size": size, "head_idx": head_idx}
    if f"{h}.linear.weight" in sd:
        meta["task"] = "classify"
        meta["nc"] = sd[f"{h}.linear.weight"].shape[0]
        return meta
    meta["nc"] = sd[f"{h}.cv3.0.2.weight"].shape[0]
    if f"{h}.proto.cv1.conv.weight" in sd:
        meta["task"] = "segment"
        meta["nm"] = sd[f"{h}.cv4.0.2.weight"].shape[0]
    elif f"{h}.cv4.0.2.weight" in sd:
        c4_out = sd[f"{h}.cv4.0.2.weight"].shape[0]
        if c4_out == 1:
            meta["task"] = "obb"
            meta["ne"] = 1
        else:
            meta["task"] = "pose"
            meta["kpt_shape"] = (c4_out // 3, 3) if c4_out % 3 == 0 else (c4_out, 1)
    else:
        meta["task"] = "detect"
    return meta


def load_pt_checkpoint(path: Union[str, Path]) -> Tuple[YOLO11, ModelSpec, Dict[str, Any]]:
    """An ultralytics `.pt` checkpoint -> (unfolded f32 `YOLO11`, its spec,
    meta {"task", "size", "nc", "names"}). The EMA weights are taken where
    the checkpoint has them, as the JAX package takes them."""
    obj = permissive_torch_load(path)
    model_obj = None
    if isinstance(obj, dict):
        model_obj = obj.get("ema") or obj.get("model")
    if model_obj is None:
        model_obj = obj
    sd = extract_state_dict(model_obj)
    if not any(k.startswith("model.") for k in sd):  # ultralytics wraps the layer list in `.model`
        sd = {f"model.{k}": v for k, v in sd.items()}
    meta = infer_model_meta(sd)
    spec = build_spec(meta["task"], meta["size"], meta["nc"], **{k: meta[k] for k in ("nm", "kpt_shape", "ne")
                                                                 if k in meta})
    model = load_state_dict(sd, spec)
    raw_names = getattr(model_obj, "__dict__", {}).get("names")
    names = {int(k): str(v) for k, v in raw_names.items()} if isinstance(raw_names, dict) else None
    logger.info("loaded %s: %s/%s nc=%d", path, meta["task"], meta["size"], meta["nc"])
    return model, spec, {"task": meta["task"], "size": meta["size"], "nc": meta["nc"], "names": names}
