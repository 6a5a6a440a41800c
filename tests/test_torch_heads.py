"""The port's segment, pose, obb and classify heads vs the goldens and the JAX forward, on the CPU.

Each golden fixture goes through the port's ultralytics-name loader the way
tests/test_golden.py runs it through the JAX converter, and, as a JAX
parameter tree, through `params_from_jax` against the JAX forward, unfolded
and folded, at f32.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest
from yolo_infer_tpu.models import build_spec as jax_build_spec
from yolo_infer_tpu.models import fold_model as jax_fold_model
from yolo_infer_tpu.models import forward as jax_forward
from yolo_infer_tpu.models.convert import convert_state_dict
from yolo_infer_tpu_torch.models.convert import load_state_dict, params_from_jax
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.models.yolo11 import build_model, cast_model, fold_model
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TASKS = ["segment", "pose", "obb", "classify"]
_EXTRA = {"segment": ("mc", "proto"), "pose": ("kpts",), "obb": ("angle",), "classify": ()}


def _golden(task):
    z = np.load(Path(__file__).parent / "golden" / f"golden_{task}_n_v{GOLDEN_VERSION}.npz")
    sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
    return z, sd, build_spec(task, "n", nc=int(z["nc"]))


def _forward(model, x_nhwc):
    with torch.no_grad():
        out = model(torch.from_numpy(x_nhwc))
    return {k: [t.numpy() for t in v] if isinstance(v, list) else v.numpy() for k, v in out.items()}


def _golden_keys(task, out):
    """(port output, golden key) pairs of the fixture's recorded tensors."""
    if task == "classify":
        return [(out["logits"], "out_logits")]
    pairs = [(f, f"out_feat{i}") for i, f in enumerate(out["feats"])]
    for key in _EXTRA[task]:
        if key == "proto":
            pairs.append((out["proto"], "out_proto"))
        else:
            pairs += [(f, f"out_{key}{i}") for i, f in enumerate(out[key])]
    return pairs


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("task", TASKS)
def test_golden_heads_through_ultralytics_loader(task, folded):
    z, sd, spec = _golden(task)
    model = load_state_dict(sd, spec)
    if folded:
        fold_model(model)
    pairs = _golden_keys(task, _forward(model, z["input"]))
    assert len(pairs) == {"segment": 7, "pose": 6, "obb": 6, "classify": 1}[task]
    for got, key in pairs:
        np.testing.assert_allclose(got, z[key], atol=2e-4, rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("task", TASKS)
def test_heads_match_jax_through_params_from_jax(task, folded):
    """The golden weights as a JAX parameter tree (`convert_state_dict`),
    through `params_from_jax` and through the JAX forward (jitted: one
    compile instead of one per operation)."""
    _, sd, spec = _golden(task)
    jspec = jax_build_spec(task, "n", nc=spec.nc)
    params, state = convert_state_dict(sd, jspec)
    if folded:
        params, state = jax.tree_util.tree_map(np.asarray, jax_fold_model(params, state)), None
    x = np.random.default_rng(6).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    want = jax.jit(lambda p, s, v: jax_forward(p, s, jspec, v, compute_dtype=jnp.float32)[0])(params, state, x)
    got = _forward(params_from_jax(params, spec, state), x)
    assert set(got) == set(want)
    for key in want:
        ws = want[key] if isinstance(want[key], list) else [want[key]]
        gs = got[key] if isinstance(got[key], list) else [got[key]]
        for i, (g, w) in enumerate(zip(gs, ws)):
            w = np.asarray(w)
            assert g.shape == w.shape, key
            assert float(w.std()) > 1e-3, key  # alive, not a vacuous match
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3, err_msg=f"{key}{i}")


@pytest.mark.parametrize("task", TASKS)
def test_seeded_model_runs_every_head_in_bf16(task):
    """The seeded `build_model` initialises every head (transposed conv and linear
    included) and `cast_model` casts all of it."""
    model, spec = build_model(task, "n", nc=7, seed=1)
    cast_model(fold_model(model), torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for n, p in model.named_parameters() if ".bn." not in n)
    with torch.no_grad():
        out = model(torch.rand(1, 64, 64, 3))
    flat = [t for v in out.values() for t in (v if isinstance(v, list) else [v])]
    assert all(torch.isfinite(t.float()).all() for t in flat)
    if task == "classify":
        assert out["logits"].dtype == torch.float32 and out["logits"].shape == (1, 7)
    else:
        assert out["feats"][0].shape == (1, 8, 8, 64 + 7)
