"""The port's YOLO11 forward vs the recorded golden and the JAX forward, on the CPU.

The golden detect fixture goes through the port's ultralytics-name loader the
way tests/test_golden.py runs it through the JAX converter; JAX parameter
trees go through `params_from_jax`, unfolded and folded, at f32.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest
from yolo_infer_tpu.models import build_model as jax_build_model
from yolo_infer_tpu.models import fold_model as jax_fold_model
from yolo_infer_tpu.models import forward as jax_forward
from yolo_infer_tpu_torch.models.convert import load_state_dict, params_from_jax
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.models.yolo11 import build_model, fold_model
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

GOLDEN = Path(__file__).parent / "golden" / f"golden_detect_n_v{GOLDEN_VERSION}.npz"


@pytest.fixture(scope="module")
def golden():
    z = np.load(GOLDEN)
    names = str(z["names"]).split("\n")
    sd = golden_state_dict(names, unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
    return z, sd, build_spec("detect", "n", nc=int(z["nc"]))


def _port_feats(model, x_nhwc):
    with torch.no_grad():
        return [f.numpy() for f in model(torch.from_numpy(x_nhwc))["feats"]]


@pytest.mark.parametrize("folded", [False, True])
def test_golden_detect_through_ultralytics_loader(golden, folded):
    z, sd, spec = golden
    model = load_state_dict(sd, spec)
    if folded:
        fold_model(model)
    feats = _port_feats(model, z["input"])
    for i, f in enumerate(feats):
        np.testing.assert_allclose(f, z[f"out_feat{i}"], atol=2e-4, rtol=1e-3, err_msg=f"feat{i}")


def test_golden_fixture_is_sensitive(golden):
    z, sd, spec = golden
    nudged = dict(sd, **{"model.0.conv.weight": sd["model.0.conv.weight"] + 1e-2})
    feat0 = _port_feats(load_state_dict(nudged, spec), z["input"])[0]
    assert float(np.abs(feat0 - z["out_feat0"]).max()) > 2e-4


def test_loader_rejects_a_state_dict_that_does_not_fit(golden):
    _, sd, spec = golden
    with pytest.raises(KeyError):
        load_state_dict({k: v for k, v in sd.items() if "model.10." not in k}, spec)
    with pytest.raises(ValueError):
        load_state_dict(sd, build_spec("detect", "s", nc=spec.nc))


def _jax_tree(size, seed):
    """A JAX detect model with batch-norm statistics drawn so activations
    stay O(0.1) through the graph (the plain init fades them)."""
    params, state, spec = jax_build_model(jax.random.PRNGKey(seed), "detect", size, nc=80)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.default_rng(seed)

    def walk(p, s):
        if isinstance(p, dict):
            if "gamma" in p:
                c = p["gamma"].shape
                p["gamma"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
                p["beta"] = rng.uniform(-0.1, 0.1, c).astype(np.float32)
                s["mean"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
                s["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                return
            for k in p:
                walk(p[k], s.get(k) if isinstance(s, dict) else None)
        elif isinstance(p, list):
            for i, pi in enumerate(p):
                walk(pi, s[i] if isinstance(s, list) else None)

    walk(params, state)
    return params, state, spec


@pytest.mark.parametrize("size,hw,folded", [("n", 96, False), ("n", 96, True), ("s", 64, False)])
def test_forward_matches_jax_through_params_from_jax(size, hw, folded):
    params, state, jspec = _jax_tree(size, seed=7)
    x = np.random.default_rng(8).uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    if folded:
        params = jax.tree_util.tree_map(np.asarray, jax_fold_model(params, state))
        state = None
    want, _ = jax_forward(params, state, jspec, jnp.asarray(x), compute_dtype=jnp.float32)
    model = params_from_jax(params, build_spec("detect", size, nc=80), state)
    got = _port_feats(model, x)
    for i, (g, w) in enumerate(zip(got, want["feats"])):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert float(w[..., 64:].std()) > 1e-3  # class logits alive, not a vacuous match
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3, err_msg=f"feat{i}")


def test_fold_model_keeps_the_forward():
    model, _ = build_model("detect", "n", seed=3)
    x = np.random.default_rng(9).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    before = _port_feats(model, x)
    after = _port_feats(fold_model(model), x)
    assert not any(".bn." in k for k in model.state_dict())
    for a, b in zip(before, after):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


def test_build_model_is_seeded():
    a, _ = build_model("detect", "n", seed=11)
    b, _ = build_model("detect", "n", seed=11)
    c, _ = build_model("detect", "n", seed=12)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["model.0.conv.weight"], sc["model.0.conv.weight"])
    assert sum(v.numel() for k, v in sa.items() if not k.startswith("model.23.") and "bn" not in k) > 2_000_000
