"""Physical structured pruning: channel surgery, not masks.

Port of `yolo_infer_tpu/optimization/surgery.py` (`Member`, `Group`,
`build_plan`, `slim_model`, `zero_removed` and the per-block groups). Masks
(`optimization/pruning.py`) zero channels but run at dense shapes; surgery
removes them, so the model runs narrower convs.

Every pruned channel group is internal to one block: a producer conv's
output channels consumed only by the listed consumers inside that block.
The inter-layer interfaces (concat widths, residual channel counts, the
C3k2 `q_split2` halves, head map channels, backbone taps) stay, so the port's
`YOLO11` runs a slim model unchanged: its blocks read every width from the
weights. A slim model is built from the tensors' shapes (`models/yolo11.py
reshape_like`), which is also how a slim checkpoint loads (`models/convert.py
load_state_dict`).

Groups: Bottleneck hidden (cv1.out with cv2.in); C3k's residual-tied a-chain,
its b path and each inner bottleneck; C3k2's chunk channels (equal a/b keep
counts for the split) and chain links; SPPF hidden (cv2.in at 4 concat
offsets); each C2PSA FFN hidden; the Detect/Segment/Pose/OBB branch
hiddens (cv3's depthwise convs pass through); the segment proto's three
links (cv1 -> ConvTranspose2d -> cv2 -> cv3); Classify's conv -> linear.
Importance is the sum over a group's producers of ||w[..., c]|| * |gamma[c]|;
kept counts round up to a multiple of `align` (8), and a group whose
rounded count is its width is skipped.

The plan is computed on the model's JAX-layout tree (`models/convert.py
params_to_jax`) by the JAX package's own arithmetic in numpy, so its kept
indices are the JAX package's. Invariant (tested): removing a group equals
zeroing its producers' weights, scale, shift and bias (`zero_removed`),
since a zeroed channel emits SiLU(0) = 0 and adds nothing downstream.
int8 models are refused: quantize after slimming.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from yolo_infer_tpu_torch.models.convert import load_state_dict, params_to_jax, state_dict_from_jax
from yolo_infer_tpu_torch.models.yolo11 import YOLO11, cast_model

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------- plan


@dataclasses.dataclass
class Member:
    """One tensor-slice participating in a group.

    kind: 'out'      conv block output channels (w last axis, γ/β/b, BN state)
          'in'       conv input channels (w axis 2); `index` overrides keep
          'dw'       depthwise pass-through (w last axis + γ/β + state)
          'up_i'     transposed-conv input axis (wt axis 3)
          'up_o'     transposed-conv output axis (wt axis 2) + bias
          'dense_in' dense weight input axis (w axis 0)
    """

    path: str
    kind: str
    index: Optional[np.ndarray] = None  # 'in' consumers with concat offsets


@dataclasses.dataclass
class Group:
    name: str
    width: int
    keep: Optional[np.ndarray]  # None = skipped (kept whole)
    members: List[Member]

    @property
    def kept(self) -> int:
        return self.width if self.keep is None else int(self.keep.size)


# ------------------------------------------------------------------ helpers


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _col_norms(conv: Dict[str, Any]) -> np.ndarray:
    """BN-scaled L2 norm per output channel of one conv dict."""
    w = _f32(conv["w"])
    n = np.sqrt((w.reshape(-1, w.shape[-1]) ** 2).sum(axis=0))
    if "gamma" in conv:
        n = n * np.abs(_f32(conv["gamma"]))
    return n


def _select(imp: np.ndarray, keep_frac: float, align: int) -> Optional[np.ndarray]:
    """Top-k keep indices (sorted), k rounded UP to `align`; None = skip."""
    c = int(imp.size)
    k = int(round(c * keep_frac))
    k = max(align, int(-(-k // align) * align))
    if k >= c:
        return None
    return np.sort(np.argpartition(-imp, k - 1)[:k])


def _slice_last(x, keep):
    return np.asarray(x)[..., keep]


def _apply_member(params_root, state_root, m: Member, keep: np.ndarray) -> None:
    p = _resolve(params_root, m.path)
    s = _resolve(state_root, m.path) if state_root is not None else None
    idx = m.index if m.index is not None else keep
    if m.kind == "out":
        p["w"] = _slice_last(p["w"], idx)
        for k in ("gamma", "beta", "b"):
            if k in p:
                p[k] = np.asarray(p[k])[idx]
        if s:
            for k in ("mean", "var"):
                if k in s:
                    s[k] = np.asarray(s[k])[idx]
    elif m.kind == "in":
        p["w"] = np.asarray(p["w"])[:, :, idx, :]
    elif m.kind == "dw":
        p["w"] = _slice_last(p["w"], idx)
        for k in ("gamma", "beta", "b"):
            if k in p:
                p[k] = np.asarray(p[k])[idx]
        if s:
            for k in ("mean", "var"):
                if k in s:
                    s[k] = np.asarray(s[k])[idx]
    elif m.kind == "up_i":
        p["wt"] = np.asarray(p["wt"])[:, :, :, idx]
    elif m.kind == "up_o":
        p["wt"] = np.asarray(p["wt"])[:, :, idx, :]
        if "b" in p:
            p["b"] = np.asarray(p["b"])[idx]
    elif m.kind == "dense_in":
        p["w"] = np.asarray(p["w"])[idx, :]
    else:  # pragma: no cover
        raise ValueError(m.kind)


def _resolve(root, path: str):
    cur = root
    for part in path.split("."):
        if cur is None:
            return None
        cur = cur[int(part)] if isinstance(cur, (list, tuple)) else cur.get(part)
    return cur


def _tree_map(fn, t):
    if isinstance(t, dict):
        return {k: _tree_map(fn, v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree_map(fn, v) for v in t]
    return fn(t)


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    elif isinstance(t, (list, tuple)):
        for v in t:
            yield from _leaves(v)
    else:
        yield t


def _copy_tree(t):
    return _tree_map(lambda x: np.array(x), t)


# ---------------------------------------------------------- per-block groups


def _bottleneck_hidden(path: str, p, keep_frac, align) -> List[Group]:
    keep = _select(_col_norms(p["cv1"]), keep_frac, align)
    return [Group(
        name=f"{path}:hidden", width=int(np.asarray(p["cv1"]["w"]).shape[-1]), keep=keep,
        members=[Member(f"{path}.cv1", "out"), Member(f"{path}.cv2", "in")],
    )]


def _c3k_groups(path: str, p, keep_frac, align) -> List[Group]:
    c_ = int(np.asarray(p["cv1"]["w"]).shape[-1])
    n_m = len(p["m"])
    # a-chain outer (residual-tied across the whole chain)
    imp_a = _col_norms(p["cv1"])
    for m in p["m"]:
        imp_a = imp_a + _col_norms(m["cv2"])
    keep_a = _select(imp_a, keep_frac, align)
    keep_b = _select(_col_norms(p["cv2"]), keep_frac, align)

    a_members = [Member(f"{path}.cv1", "out")]
    for i in range(n_m):
        a_members += [Member(f"{path}.m.{i}.cv1", "in"), Member(f"{path}.m.{i}.cv2", "out")]
    b_members = [Member(f"{path}.cv2", "out")]

    # cv3 consumes concat([a, b]); build its input index from both keeps
    ia = keep_a if keep_a is not None else np.arange(c_)
    ib = keep_b if keep_b is not None else np.arange(c_)
    cv3_index = np.concatenate([ia, c_ + ib])
    cv3 = Member(f"{path}.cv3", "in", index=cv3_index)

    groups = [
        Group(f"{path}:a", c_, keep_a, a_members),
        Group(f"{path}:b", c_, keep_b, b_members + ([cv3] if keep_a is None else [])),
    ]
    if keep_a is not None:
        groups[0].members.append(cv3)  # exactly one group applies the cv3 slice
    elif keep_b is None:
        groups[1].members.remove(cv3)  # nothing to slice
    for i, m in enumerate(p["m"]):
        groups += _bottleneck_hidden(f"{path}.m.{i}", m, keep_frac, align)
    return groups


def _select_k(imp: np.ndarray, k: int) -> np.ndarray:
    return np.sort(np.argpartition(-imp, k - 1)[:k])


def _c3k2_chunk_groups(path: str, p, c3k: bool, keep_frac, align) -> List[Group]:
    """Slim the C3k2 chunk channels themselves (the outer dims of the block's
    3x3 convs). Constraints honored:
      * `q_split2` halves cv1's output evenly -> the a- and b-chunk keep the
        SAME count (indices may differ), so cv1 is sliced once with the
        combined index and the split point stays exact.
      * non-c3k: residual adds tie b and every bottleneck output into ONE
        group (same keep at every concat segment).
      * c3k:    the chain has no outer residual, so b and each C3k output
        y_i are INDEPENDENT groups; C3k's own cv1+cv2 both consume the link.
      * cv2 consumes concat([a, b, y_1..y_n]); its input index is assembled
        across all segment keeps and applied exactly once.
    """
    c2x = int(np.asarray(p["cv1"]["w"]).shape[-1])
    c = c2x // 2
    n_m = len(p["m"])

    cols = _col_norms(p["cv1"])
    imp_a, imp_b = cols[:c].copy(), cols[c:].copy()
    if not c3k:  # residual chain: every m output shares the b channel space
        for m in p["m"]:
            imp_b = imp_b + _col_norms(m["cv2"])
    keep_a = _select(imp_a, keep_frac, align)
    keep_b = _select(imp_b, keep_frac, align)
    if keep_a is None or keep_b is None:
        keep_a = keep_b = None  # split2 needs equal halves: all or nothing
    elif keep_a.size != keep_b.size:
        k = max(keep_a.size, keep_b.size)
        keep_a, keep_b = _select_k(imp_a, k), _select_k(imp_b, k)

    ia = keep_a if keep_a is not None else np.arange(c)
    ib = keep_b if keep_b is not None else np.arange(c)
    seg_keeps: List[np.ndarray] = [ia, ib]
    groups: List[Group] = []

    if keep_a is not None:
        ga = Group(f"{path}:chunk_a", c, keep_a,
                   [Member(f"{path}.cv1", "out", index=np.concatenate([ia, c + ib]))])
        gb_members: List[Member] = []
        if c3k:
            gb_members += [Member(f"{path}.m.0.cv1", "in", index=keep_b),
                           Member(f"{path}.m.0.cv2", "in", index=keep_b)]
        else:
            for i in range(n_m):
                gb_members += [Member(f"{path}.m.{i}.cv1", "in"),
                               Member(f"{path}.m.{i}.cv2", "out")]
        groups += [ga, Group(f"{path}:chunk_b", c, keep_b, gb_members)]

    if c3k:  # chain link groups: y_i = m[i].cv3 output feeds m[i+1] + concat
        for i in range(n_m):
            cv3 = p["m"][i]["cv3"]
            cy = int(np.asarray(cv3["w"]).shape[-1])
            keep_y = _select(_col_norms(cv3), keep_frac, align)
            members = [Member(f"{path}.m.{i}.cv3", "out")]
            if i + 1 < n_m and keep_y is not None:
                members += [Member(f"{path}.m.{i + 1}.cv1", "in"),
                            Member(f"{path}.m.{i + 1}.cv2", "in")]
            groups.append(Group(f"{path}:y{i}", cy, keep_y, members))
            seg_keeps.append(keep_y if keep_y is not None else np.arange(cy))
    else:  # residual: every chain segment shares the b keep
        seg_keeps += [ib] * n_m

    if any(g.keep is not None for g in groups):
        offsets = np.cumsum([0] + [c] * (len(seg_keeps) - 1))
        idx = np.concatenate([off + sk for off, sk in zip(offsets, seg_keeps)])
        host = next(g for g in groups if g.keep is not None)
        host.members.append(Member(f"{path}.cv2", "in", index=idx))
    return groups


def _c3k2_groups(path: str, p, c3k: bool, keep_frac, align, chunks: bool = True) -> List[Group]:
    groups: List[Group] = []
    for i, m in enumerate(p["m"]):
        if c3k:
            groups += _c3k_groups(f"{path}.m.{i}", m, keep_frac, align)
        else:
            groups += _bottleneck_hidden(f"{path}.m.{i}", m, keep_frac, align)
    if chunks:
        groups += _c3k2_chunk_groups(path, p, c3k, keep_frac, align)
    return groups


def _sppf_groups(path: str, p, keep_frac, align) -> List[Group]:
    c_ = int(np.asarray(p["cv1"]["w"]).shape[-1])
    keep = _select(_col_norms(p["cv1"]), keep_frac, align)
    members = [Member(f"{path}.cv1", "out")]
    if keep is not None:
        idx = np.concatenate([keep + j * c_ for j in range(4)])
        members.append(Member(f"{path}.cv2", "in", index=idx))
    return [Group(f"{path}:hidden", c_, keep, members)]


def _c2psa_groups(path: str, p, keep_frac, align) -> List[Group]:
    groups = []
    for i, m in enumerate(p["m"]):
        keep = _select(_col_norms(m["ffn1"]), keep_frac, align)
        groups.append(Group(
            f"{path}.m.{i}:ffn", int(np.asarray(m["ffn1"]["w"]).shape[-1]), keep,
            [Member(f"{path}.m.{i}.ffn1", "out"), Member(f"{path}.m.{i}.ffn2", "in")],
        ))
    return groups


def _chain_groups(path: str, branch: Sequence[Dict[str, Any]], links: Sequence[Tuple[int, Optional[int], int]],
                  keep_frac, align) -> List[Group]:
    """Groups for a conv chain. links: (producer_idx, dw_idx or None, consumer_idx)."""
    groups = []
    for prod, dw, cons in links:
        keep = _select(_col_norms(branch[prod]), keep_frac, align)
        members = [Member(f"{path}.{prod}", "out")]
        if dw is not None:
            members.append(Member(f"{path}.{dw}", "dw"))
        members.append(Member(f"{path}.{cons}", "in"))
        groups.append(Group(
            f"{path}.{prod}:out", int(np.asarray(branch[prod]["w"]).shape[-1]), keep, members,
        ))
    return groups


def _proto_groups(path: str, p, keep_frac, align) -> List[Group]:
    c_ = int(np.asarray(p["cv1"]["w"]).shape[-1])
    g1 = Group(f"{path}.cv1:out", c_, _select(_col_norms(p["cv1"]), keep_frac, align),
               [Member(f"{path}.cv1", "out"), Member(f"{path}.up", "up_i")])
    wt = _f32(p["up"]["wt"])  # (kh, kw, O, I)
    up_imp = np.sqrt((wt.transpose(2, 0, 1, 3).reshape(wt.shape[2], -1) ** 2).sum(axis=1))
    g2 = Group(f"{path}.up:out", int(wt.shape[2]), _select(up_imp, keep_frac, align),
               [Member(f"{path}.up", "up_o"), Member(f"{path}.cv2", "in")])
    g3 = Group(f"{path}.cv2:out", int(np.asarray(p["cv2"]["w"]).shape[-1]),
               _select(_col_norms(p["cv2"]), keep_frac, align),
               [Member(f"{path}.cv2", "out"), Member(f"{path}.cv3", "in")])
    return [g1, g2, g3]


def _head_groups(path: str, p, keep_frac, align) -> List[Group]:
    groups: List[Group] = []
    for i, branch in enumerate(p["cv2"]):
        groups += _chain_groups(f"{path}.cv2.{i}", branch, [(0, None, 1), (1, None, 2)], keep_frac, align)
    for i, branch in enumerate(p["cv3"]):
        # [dw(c,c), conv(c,c3), dw(c3,c3), conv(c3,c3), pred(c3,nc)]
        groups += _chain_groups(f"{path}.cv3.{i}", branch, [(1, 2, 3), (3, None, 4)], keep_frac, align)
    if "cv4" in p:
        for i, branch in enumerate(p["cv4"]):
            groups += _chain_groups(f"{path}.cv4.{i}", branch, [(0, None, 1), (1, None, 2)], keep_frac, align)
    if "proto" in p:
        groups += _proto_groups(f"{path}.proto", p["proto"], keep_frac, align)
    return groups


def _classify_groups(path: str, p, keep_frac, align) -> List[Group]:
    keep = _select(_col_norms(p["conv"]), keep_frac, align)
    return [Group(f"{path}.conv:out", int(np.asarray(p["conv"]["w"]).shape[-1]), keep,
                  [Member(f"{path}.conv", "out"), Member(f"{path}.linear", "dense_in")])]


# ----------------------------------------------------------------- top level


def plan_tree(params: Dict[str, Any], spec, keep_frac: float = 0.5, align: int = 8,
              chunks: bool = True) -> List[Group]:
    """All slimming groups and keep sets of a JAX-layout params tree (no
    mutation): the JAX package's `build_plan`. chunks=False restricts surgery
    to strictly hidden dims (no C3k2 chunk and chain slimming)."""
    for leaf_path in ("w_q",):
        if any(leaf_path in d for d in _walk_dicts(params)):
            raise ValueError("physical surgery requires float weights; re-quantize after slimming")
    groups: List[Group] = []
    for layer in spec.layers:
        key = str(layer.idx)
        if key not in params:
            continue
        p = params[key]
        t = layer.typ
        if t == "C3k2":
            groups += _c3k2_groups(key, p, layer.kw["c3k"], keep_frac, align, chunks=chunks)
        elif t == "SPPF":
            groups += _sppf_groups(key, p, keep_frac, align)
        elif t == "C2PSA":
            groups += _c2psa_groups(key, p, keep_frac, align)
        elif t in ("Detect", "Segment", "Pose", "OBB"):
            groups += _head_groups(key, p, keep_frac, align)
        elif t == "Classify":
            groups += _classify_groups(key, p, keep_frac, align)
        # plain Conv / Upsample / Concat: outputs are inter-layer interfaces
    return groups


def _walk_dicts(t):
    if isinstance(t, dict):
        yield t
        for v in t.values():
            yield from _walk_dicts(v)
    elif isinstance(t, (list, tuple)):
        for v in t:
            yield from _walk_dicts(v)


def _tree(model: YOLO11) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """The model's JAX-layout (params, state) trees in f32 (state None when folded)."""
    if any(getattr(m, "quantized", False) for m in model.modules()):
        raise ValueError("physical surgery requires float weights; re-quantize after slimming")
    f32 = copy.deepcopy(model).float()
    fused = not any(getattr(m, "bn", None) is not None for m in f32.modules())
    return params_to_jax(f32, model.spec, fused=fused)


def _module(params, state, like: YOLO11) -> YOLO11:
    """A `YOLO11` of the trees' shapes, in `like`'s weight dtype."""
    model = load_state_dict(state_dict_from_jax(params, like.spec, state), like.spec)
    return cast_model(model, like.compute_dtype)


def build_plan(model: YOLO11, keep_frac: float = 0.5, align: int = 8, chunks: bool = True) -> List[Group]:
    """Every slimming group of the model and its keep set (no mutation)."""
    return plan_tree(_tree(model)[0], model.spec, keep_frac, align, chunks=chunks)


def slim_model(model: YOLO11, keep_frac: float = 0.5, align: int = 8,
               chunks: bool = True) -> Tuple[YOLO11, List[Group], Dict[str, Any]]:
    """Physically remove the low-importance internal channels. Returns (a new
    slim `YOLO11`, the plan, a report); the model given is not changed. An
    unfolded model gives an unfolded one (its batch-norm state sliced too)."""
    params, state = _tree(model)
    plan = plan_tree(params, model.spec, keep_frac, align, chunks=chunks)
    new_p = _copy_tree(params)
    new_s = _copy_tree(state) if state is not None else None
    n_before = sum(int(np.asarray(x).size) for x in _leaves(params))
    for g in plan:
        if g.keep is None:
            continue
        for m in g.members:
            _apply_member(new_p, new_s, m, g.keep)
    n_after = sum(int(np.asarray(x).size) for x in _leaves(new_p))
    report = {
        "groups_total": len(plan),
        "groups_slimmed": sum(1 for g in plan if g.keep is not None),
        "channels_before": sum(g.width for g in plan),
        "channels_after": sum(g.kept for g in plan),
        "params_before": n_before,
        "params_after": n_after,
        "params_ratio": n_after / max(n_before, 1),
        "keep_frac": keep_frac,
        "align": align,
    }
    return _module(new_p, new_s, model), plan, report


def zero_removed(model: YOLO11, plan: List[Group]) -> YOLO11:
    """A new model with every pruned channel zeroed instead of removed: the
    masked twin of `slim_model` that proves slim == zeroed. Only producers
    need zeroing: the w column, scale, shift (and bias) make the channel
    emit exactly 0."""
    params, state = _tree(model)
    new_p = _copy_tree(params)
    new_s = _copy_tree(state) if state is not None else None
    for g in plan:
        if g.keep is None:
            continue
        rm_group = np.setdiff1d(np.arange(g.width), g.keep)
        for m in g.members:
            p = _resolve(new_p, m.path)
            if m.kind == "out":
                # an explicit index spans the member's whole axis (e.g. a
                # partially-sliced multi-chunk producer): complement it there
                rm = (np.setdiff1d(np.arange(p["w"].shape[-1]), m.index)
                      if m.index is not None else rm_group)
                p["w"][..., rm] = 0
                for k in ("gamma", "beta", "b"):
                    if k in p:
                        p[k][rm] = 0
            elif m.kind == "dw":
                for k in ("gamma", "beta", "b"):
                    if k in p:
                        p[k][rm_group] = 0
            elif m.kind == "up_o":
                p["wt"][:, :, rm_group, :] = 0
                if "b" in p:
                    p["b"][rm_group] = 0
    return _module(new_p, new_s, model)
