"""The port's train step (`yolo_infer_tpu_torch/core/train_step.py`) against
the JAX package's, fp32 on the CPU.

Both start from one JAX-built yolo11n detect (nc 3) tree carried into the
port (`models/convert.py`); the same seeded uint8 batches (64 px, b2) go
through three steps of each. The forward alone already differs by ~2e-5 of
a head map between XLA's and torch's CPU convolutions (their summation
orders), and three warmup steps (bias lr 0.1) carry that on: the test holds
the loss to 1e-3 relative and params, EMA and batch-norm state to 5e-4
absolute (parameters reach ~8; the measured worst is ~1.2e-4). The
optimizer itself is held tighter: given the same gradients the update
matches optax's chain to 1e-6 of the largest parameter, and the learning
rates and momentum of a 300-step warmup-plus-decay run match to 1e-7.
Gradient parity holds on seeded inputs without ties (see
`test_torch_train_losses.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401
from yolo_infer_tpu.core import train_step as JT
from yolo_infer_tpu.models.yolo11 import build_model as jax_build_model
from yolo_infer_tpu_torch.core import train_step as PT
from yolo_infer_tpu_torch.models.convert import params_from_jax, state_dict_from_jax
from yolo_infer_tpu_torch.models.spec import build_spec

NC, IMGSZ, B, M = 3, 64, 2, 6


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_start():
    params, state, spec = jax_build_model(jax.random.PRNGKey(0), "detect", "n", NC)
    return to_np(params), to_np(state), spec


def batches(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xy = rng.uniform(0, 40, (B, M, 2))
        wh = rng.uniform(6, 30, (B, M, 2))
        mask = np.ones((B, M), bool)
        mask[1, 4:] = False
        out.append({"images": rng.integers(0, 256, (B, IMGSZ, IMGSZ, 3), dtype=np.uint8),
                    "boxes": np.concatenate([xy, np.minimum(xy + wh, IMGSZ)], -1).astype(np.float32),
                    "classes": rng.integers(0, NC, (B, M)).astype(np.int32), "mask": mask})
    return out


def port_state(jax_start, tx):
    params, state, _ = jax_start
    model = params_from_jax(params, build_spec("detect", "n", NC), state)
    return PT.init_train_state(model, tx, device="cpu")


def tree_max_abs(a, b):
    return max(float(np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32)).max())
               for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


def test_three_steps_match_jax(jax_start):
    params, state, spec = jax_start
    tx = JT.make_optimizer(0.01, total_steps=30, warmup_steps=10)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ts = JT.TrainState(params=jp, bn_state=jax.tree_util.tree_map(jnp.asarray, state), opt_state=tx.init(jp),
                       ema_params=jax.tree_util.tree_map(jnp.array, params), step=jnp.int32(0),
                       skipped=jnp.int32(0), spec=spec, tx=tx, rng=jax.random.PRNGKey(0))
    jax_step = JT.make_train_step(spec, tx, compute_dtype=jnp.float32)
    ptx = PT.make_optimizer(0.01, total_steps=30, warmup_steps=10)
    pts = port_state(jax_start, ptx)
    port_step = PT.make_train_step(pts.spec, ptx, compute_dtype=torch.float32)
    for i, batch in enumerate(batches(3)):
        ts, jm = jax_step(ts, {k: jnp.asarray(v) for k, v in batch.items()})
        pts, pm = port_step(pts, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-3, err_msg=f"step {i}")
        assert int(pm["step_skipped"]) == int(jm["step_skipped"]) == 0
        back = PT.train_state_to_jax(pts)
        for key, want in (("params", ts.params), ("ema_params", ts.ema_params), ("bn_state", ts.bn_state)):
            assert tree_max_abs(back[key], to_np(want)) < 5e-4, (i, key)
    assert int(pts.step) == int(ts.step) == 3 and int(pts.opt_state["count"]) == 3


def test_optimizer_update_matches_optax(jax_start):
    """The same gradients through optax's chain (clip, masked decay, yolo_sgd,
    freeze) and the port's flat update: the gradient's norm above the clip
    (x 40) and below it (x 0.01), inside and after warmup."""
    params, state, spec = jax_start
    freeze = (lambda k: k in ("0", "1"))
    tx = JT.make_optimizer(0.01, total_steps=8, warmup_steps=3, freeze=freeze)
    ptx = PT.make_optimizer(0.01, total_steps=8, warmup_steps=3, freeze=freeze)
    pts = port_state(jax_start, ptx)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(jp)
    rng = np.random.default_rng(5)

    @jax.jit
    def jax_update(grads, opt, jp):
        updates, opt = tx.update(grads, opt, jp)
        return jax.tree_util.tree_map(lambda p, u: p + u, jp, updates), opt

    for i, scale in enumerate((40.0, 0.01, 40.0, 0.01, 1.0)):
        grads = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32) * scale), jp)
        jp, opt = jax_update(grads, opt, jp)
        g = pts.param_layout.flatten(state_dict_from_jax(to_np(grads), spec, state), "cpu")
        new, pts.opt_state = ptx.update(g, torch.sqrt(torch.sum(g * g)), pts.opt_state, pts.params, pts.masks)
        pts.params.copy_(new)
        want = pts.param_layout.flatten(state_dict_from_jax(to_np(jp), spec, state), "cpu")
        scale_p = float(want.abs().max())
        assert float((pts.params - want).abs().max()) <= 1e-6 * scale_p, i
        mom = pts.param_layout.flatten(state_dict_from_jax(to_np(opt[2]["mom"]), spec, state), "cpu")
        np.testing.assert_allclose(pts.opt_state["mom"].numpy(), mom.numpy(), rtol=1e-5, atol=1e-6 * scale)
    frozen = [n for n in pts.param_layout.names if n.split(".")[1] in ("0", "1")]
    start = pts.param_layout.flatten(state_dict_from_jax(params, spec, state), "cpu")
    views, start_views = pts.param_layout.views(pts.params), pts.param_layout.views(start)
    assert frozen and all(torch.equal(views[n], start_views[n]) for n in frozen)


@pytest.mark.parametrize("cos_lr", [True, False])
def test_schedule_matches_optax(cos_lr):
    """lr of both groups and momentum at every step of a 300-step run with
    a 100-step warmup, against JAX's `yolo_sgd` over optax's schedule: a
    zero gradient on a momentum buffer of ones gives -lr * m^2 and m."""
    total, warm = 300, 100
    tx = JT.make_optimizer(0.01, total_steps=total, warmup_steps=warm, cos_lr=cos_lr)
    ptx = PT.make_optimizer(0.01, total_steps=total, warmup_steps=warm, cos_lr=cos_lr)
    sgd = tx.update  # the chain: clip and decay pass a zero gradient through unchanged
    zero = {"w": jnp.zeros((1, 1)), "b": jnp.zeros((1,))}
    for count in range(total):
        state = tx.init(zero)
        state = (state[0], state[1], {"count": jnp.int32(count), "mom": {"w": jnp.ones((1, 1)), "b": jnp.ones((1,))}})
        upd, new = sgd(zero, state, zero)
        m = float(new[2]["mom"]["b"][0])
        lr_other, lr_bias = -float(upd["w"][0, 0]) / m ** 2, -float(upd["b"][0]) / m ** 2
        po, pb, pm = (float(v) for v in ptx.hyperparams(torch.tensor(count, dtype=torch.int32)))
        assert abs(pm - m) <= 1e-7 and abs(po - lr_other) <= 1e-7 and abs(pb - lr_bias) <= 1e-7, count


def test_nonfinite_step_leaves_the_state_bit_unchanged(jax_start):
    ptx = PT.make_optimizer(0.01, total_steps=10, warmup_steps=2)
    pts = port_state(jax_start, ptx)
    step = PT.make_train_step(pts.spec, ptx, compute_dtype=torch.float32)
    good = {k: torch.from_numpy(v) for k, v in batches(1)[0].items()}
    pts, _ = step(pts, good)  # a real step first: momentum, EMA and batch norms hold values
    before = {k: v.clone() for k, v in (("params", pts.params), ("bn", pts.bn_state), ("ema", pts.ema_params),
                                         ("mom", pts.opt_state["mom"]), ("count", pts.opt_state["count"]))}
    module_w = pts.module.model[0].conv.weight.detach().clone()
    bad = dict(good, images=torch.full((B, IMGSZ, IMGSZ, 3), float("nan")))
    pts, metrics = step(pts, bad)
    assert int(metrics["step_skipped"]) == 1 and int(pts.skipped) == 1 and int(pts.step) == 2
    after = {"params": pts.params, "bn": pts.bn_state, "ema": pts.ema_params, "mom": pts.opt_state["mom"],
             "count": pts.opt_state["count"]}
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert torch.equal(pts.module.model[0].conv.weight, module_w)  # the module's parameters are the state's views


def test_freeze_zeroes_updates_and_keeps_momentum(jax_start):
    ptx = PT.make_optimizer(0.01, total_steps=10, warmup_steps=1, freeze=lambda k: k in {str(i) for i in range(10)})
    pts = port_state(jax_start, ptx)
    step = PT.make_train_step(pts.spec, ptx, compute_dtype=torch.float32)
    start = pts.param_layout.views(pts.params.clone())
    for batch in batches(2):
        pts, _ = step(pts, {k: torch.from_numpy(v) for k, v in batch.items()})
    now, mom = pts.param_layout.views(pts.params), pts.param_layout.views(pts.opt_state["mom"])
    frozen = [n for n in now if int(n.split(".")[1]) < 10]
    assert all(torch.equal(now[n], start[n]) for n in frozen)
    assert any(float(mom[n].abs().max()) > 0 for n in frozen)  # momentum still accumulates
    assert any(not torch.equal(now[n], start[n]) for n in now if int(n.split(".")[1]) >= 10)


def test_train_state_carries_a_jax_tree_both_ways(jax_start):
    params, state, spec = jax_start
    tx = JT.make_optimizer(0.01, total_steps=10, warmup_steps=2)
    rng = np.random.default_rng(7)
    ema = jax.tree_util.tree_map(lambda x: x + rng.normal(size=x.shape).astype(np.float32), params)
    opt = to_np(tx.init(jax.tree_util.tree_map(jnp.asarray, params)))
    opt[2]["mom"] = jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
    opt[2]["count"] = np.int32(5)
    tree = {"params": params, "bn_state": state, "opt_state": opt, "ema_params": ema, "step": np.int32(5),
            "skipped": np.int32(1), "rng": np.zeros(2, np.uint32)}
    pts = PT.train_state_from_jax(tree, port_state(jax_start, PT.make_optimizer(0.01, total_steps=10)))
    assert int(pts.step) == 5 and int(pts.skipped) == 1 and int(pts.opt_state["count"]) == 5
    back = PT.train_state_to_jax(pts)
    for key in ("params", "bn_state", "ema_params"):
        assert tree_max_abs(back[key], tree[key]) == 0.0, key
    mom = pts.param_layout.flatten(state_dict_from_jax(opt[2]["mom"], spec, state), "cpu")
    assert torch.equal(pts.opt_state["mom"], mom)


@pytest.mark.parametrize("kw,item", [({"qat": True}, "6"), ({"param_mask": {"0": 1}}, "7"),
                                     ({"distill": {"alpha": 0.7}}, "7")])
def test_unported_step_options_raise(jax_start, kw, item):
    """The step options that raised, citing ROADMAP Queue 1 item 6 or 7,
    until they were ported now each take a finite step (against the JAX
    package's steps in `test_torch_prune_distill.py`): QAT, a pruning mask
    (here the magnitude masks at 0.5; the zeros stay zero) and a teacher."""
    from yolo_infer_tpu_torch.optimization.pruning import magnitude_masks

    ptx = PT.make_optimizer(0.01, total_steps=10, warmup_steps=2)
    pts = port_state(jax_start, ptx)
    if "param_mask" in kw:
        kw = {"param_mask": magnitude_masks(pts.model_from(pts.params), 0.5)}
        pts.params.mul_(pts.param_layout.flatten(kw["param_mask"], "cpu"))
    elif "distill" in kw:
        kw = {"distill": {**kw["distill"], "model": pts.model_from(pts.params)}}
    step = PT.make_train_step(pts.spec, ptx, compute_dtype=torch.float32, **kw)
    pts, metrics = step(pts, {k: torch.from_numpy(v) for k, v in batches(1)[0].items()})
    assert item in ("6", "7") and int(metrics["step_skipped"]) == 0 and torch.isfinite(metrics["loss"])
    if "param_mask" in kw:
        zero = pts.param_layout.flatten(kw["param_mask"], "cpu") == 0
        assert zero.any() and not pts.params[zero].any() and not pts.ema_params[zero].any()
    if "distill" in kw:
        assert torch.isfinite(metrics["loss_kd"])
