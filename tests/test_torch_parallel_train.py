"""The port's meshed training step on the CPU: two gloo
processes (`parallel/distributed.py launch`, `tests/torch_dist.py`) against
the JAX package's step over a 2-device mesh and against the port's own
one-process step on the whole batch.

All steps are f32, yolo11n detect (nc 3) at 64 px from one JAX-built state,
on a batch of 4 whose images hold 5, 1, 3 and 2 targets: each rank's half
has its own target-score sum, so a rank that normalised its loss by it, or
its batch norms by its own statistics, would miss the global step (the two
negative controls below do exactly that and miss it). Tolerances: against
JAX, phase 29's cuda-vs-cpu ones (loss 1e-4 relative, the update within
1e-3 of its norm, batch-norm state 1e-4); against the one-process step, loss
and batch-norm state within 1e-5 and the update within 5e-4 of its norm.
That last bound is not 1e-5 because the f32 step itself is not that exact:
its gradient differs from the same step's in f64 by more than 1e-5 of its
norm (measured 7.0e-5; `test_update_bound_is_above_the_f32_steps_own_error`
holds it), so two f32 summation orders cannot agree closer (the meshed and
one-process updates differ by 1.1e-4). In f64 the meshed forward and
backward of conv blocks give the one-process gradient to 1e-12, data and
tensor parallel (`test_meshed_batch_norm_and_tensor_parallel_convs_are_exact_in_f64`).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist import TIMEOUT_S, classify_batch, f64_grads, f64_rank, step_batch, train_step_ranks
from torch_threads import one_torch_thread  # noqa: F401
from yolo_infer_tpu.core import train_step as JT
from yolo_infer_tpu.models.yolo11 import build_model as jax_build_model
from yolo_infer_tpu.parallel.mesh import create_mesh as jax_create_mesh
from yolo_infer_tpu.parallel.mesh import shard_batch as jax_shard_batch
from yolo_infer_tpu.parallel.mesh import shard_params as jax_shard_params
from yolo_infer_tpu_torch.core.losses import detection_loss
from yolo_infer_tpu_torch.models.convert import params_from_jax, state_dict_from_jax
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.models.yolo11 import build_model
from yolo_infer_tpu_torch.parallel.distributed import launch

NC = 3
LOSS_RTOL_JAX, UPDATE_RTOL_JAX, BN_ATOL_JAX = 1e-4, 1e-3, 1e-4
LOSS_RTOL, UPDATE_RTOL, BN_ATOL = 1e-5, 5e-4, 1e-5


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_state(params, state, spec, tx):
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    return JT.TrainState(params=jp, bn_state=jax.tree_util.tree_map(jnp.asarray, state), opt_state=tx.init(jp),
                         ema_params=jax.tree_util.tree_map(jnp.array, params), step=jnp.int32(0),
                         skipped=jnp.int32(0), spec=spec, tx=tx, rng=jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def start():
    params, state, spec = jax_build_model(jax.random.PRNGKey(0), "detect", "n", NC)
    params, state = np_tree(params), np_tree(state)
    return params, state, spec, params_from_jax(params, build_spec("detect", "n", NC), state)


@pytest.fixture(scope="module")
def jax_dp_step(start):
    """The JAX step over a 2-device ('data') mesh: loss, update and
    batch-norm state, in the port's names."""
    params, state, spec, _ = start
    tx = JT.make_optimizer(0.01, total_steps=10, warmup_steps=0)
    mesh = jax_create_mesh(n_devices=2)
    ts = jax_state(params, state, spec, tx)
    ts = ts.replace_params(jax_shard_params(ts.params, mesh))
    new, m = JT.make_train_step(spec, tx, compute_dtype=jnp.float32, mesh=mesh)(ts, jax_shard_batch(step_batch(), mesh))
    update = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b, new.params, params)
    return {"loss": float(m["loss"]), "update": state_dict_from_jax(update, spec, state),
            "bn": state_dict_from_jax(params, spec, np_tree(new.bn_state))}


@pytest.fixture(scope="module")
def ranks(start):
    """Both ranks' results of every meshed step (`torch_dist.train_step_ranks`)
    and the port's one-process step on the whole batch."""
    from torch_dist import one_step

    model = start[3]
    cls_model, _ = build_model("classify", "n", 1000, seed=0)
    out = launch(train_step_ranks, 2, args=(model, step_batch(), cls_model, classify_batch()), timeout_s=TIMEOUT_S)
    return out, one_step(model, step_batch()), one_step(cls_model, classify_batch())


def flat(d, names):
    return np.concatenate([np.asarray(d[k], np.float64).ravel() for k in names])


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_step_close(got, want, loss_rtol, update_rtol, bn_atol):
    names = list(got["update"])
    bn_names = list(got["bn"])
    assert abs(got["loss"] - want["loss"]) <= loss_rtol * abs(want["loss"]), (got["loss"], want["loss"])
    assert rel(flat(got["update"], names), flat(want["update"], names)) <= update_rtol
    assert float(np.abs(flat(got["bn"], bn_names) - flat(want["bn"], bn_names)).max()) <= bn_atol
    assert got["skipped"] == 0


def test_dp_step_matches_jax_two_device_step(ranks, jax_dp_step):
    (r0, r1), _, _ = ranks
    for r in (r0, r1):
        assert_step_close(r["dp"], jax_dp_step, LOSS_RTOL_JAX, UPDATE_RTOL_JAX, BN_ATOL_JAX)


def test_dp_step_matches_one_process_step_on_the_whole_batch(ranks):
    (r0, r1), whole, _ = ranks
    for r in (r0, r1):
        assert_step_close(r["dp"], whole, LOSS_RTOL, UPDATE_RTOL, BN_ATOL)
        assert r["dp"]["metrics"]["num_fg"] == whole["metrics"]["num_fg"]  # metrics are the global ones


def test_data_ranks_end_in_the_same_state(ranks):
    """The gradient is summed over the data axis and the guard sees global
    values: both ranks apply the same update, bit for bit."""
    (r0, r1), _, _ = ranks
    for key in ("update", "bn"):
        assert all(np.array_equal(r0["dp"][key][k], r1["dp"][key][k]) for k in r0["dp"][key])
    assert r0["dp"]["loss"] == r1["dp"]["loss"]


@pytest.mark.parametrize("control", ["local_normalizers", "local_bn"])
def test_per_rank_normalizers_or_statistics_miss_the_global_step(ranks, jax_dp_step, control):
    """The negative controls: the same meshed step with the loss normalizers
    (target-score sums) or the batch-norm statistics of each rank's own half
    is off the JAX step by far more than the tolerance, on this batch of
    unequal target counts."""
    (r0, _), _, _ = ranks
    got = r0[control]
    names = list(got["update"])
    loss_off = abs(got["loss"] - jax_dp_step["loss"]) / abs(jax_dp_step["loss"])
    update_off = rel(flat(got["update"], names), flat(jax_dp_step["update"], names))
    assert max(loss_off / LOSS_RTOL_JAX, update_off / UPDATE_RTOL_JAX) > 10, (loss_off, update_off)


def test_nonfinite_loss_on_one_rank_drops_the_step_on_both(ranks, start):
    """Rank 1's loss alone is NaN (rank 0's is finite): the global loss and
    gradient are not, so both ranks keep params, momentum count and
    batch-norm state as they were."""
    (r0, r1), _, _ = ranks
    initial_bn = {k: v.numpy() for k, v in start[3].state_dict().items()}
    for r in (r0, r1):
        got = r["nonfinite"]
        assert got["skipped"] == 1 and got["metrics"]["step_skipped"] == 1 and got["count"] == 0
        assert all(not np.any(u) for u in got["update"].values())
        assert all(np.array_equal(v, initial_bn[k]) for k, v in got["bn"].items())


@pytest.mark.parametrize("case", ["detect", "classify"])
def test_tp_step_matches_one_process_step(ranks, case):
    """tp = 2 (dp 1): every conv of >= 256 output channels computes its half
    on each rank and gathers the other's (and a 1000-class classify head
    gathers its linear bias); the two halves of the update, put back
    together, are the one-process step's."""
    (r0, r1), whole_detect, whole_classify = ranks
    key_tp, whole = ("tp", whole_detect) if case == "detect" else ("tp_classify", whole_classify)
    assert r0["tp_sharded"], "yolo11n has convs of 256 output channels"
    merged = {}
    for key in ("update", "bn"):
        merged[key] = {k: (np.concatenate([r0[key_tp][key][k], r1[key_tp][key][k]])
                           if r0[key_tp][key][k].shape != whole[key][k].shape else r0[key_tp][key][k])
                       for k in whole[key]}
        assert any(r0[key_tp][key][k].shape != whole[key][k].shape for k in whole[key])
    if case == "classify":
        assert r0[key_tp]["update"]["model.10.linear.bias"].shape == (500,)
    assert_step_close({**r0[key_tp], **merged}, whole, LOSS_RTOL, UPDATE_RTOL, BN_ATOL)


@pytest.mark.parametrize("world,tp", [(2, 1), (4, 2)])
def test_meshed_batch_norm_and_tensor_parallel_convs_are_exact_in_f64(world, tp):
    """The meshed forward and backward compute the whole batch's function,
    not an approximation of it: a net with every kind of layer that shards
    at tp = 2 (conv blocks, a depthwise one among them, a head's output
    projection, a 256-class classify head) in f64, batch statistics
    included, gives the one-process loss and gradient to 1e-12 on dp 2 and
    on a 2 x 2 mesh (the sharded leaves' slices put back together). In f32
    the same steps differ by rounding alone."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 3, 16, 16)))
    w = torch.from_numpy(rng.normal(size=(4, 256)))
    loss, grads = f64_grads(x, w)
    out = launch(f64_rank, world, args=(x, w, tp), timeout_s=TIMEOUT_S)
    row = out[:tp]  # data row 0: model ranks 0 .. tp-1
    for r in out:
        assert abs(r[0] - loss) <= 1e-12 * abs(loss)
    scale = max(float(g.abs().max()) for g in grads.values())  # a bias before a batch norm has a zero gradient
    for name, want in grads.items():
        parts = [r[1][name] for r in row]
        got = torch.cat(parts) if parts[0].shape != want.shape else parts[0]
        assert float((got - want).abs().max()) <= 1e-12 * scale, name
    if tp > 1:
        assert any(r[1][n].shape != grads[n].shape for r in row for n in grads)


def test_update_bound_is_above_the_f32_steps_own_error(start):
    """Why the update is held to 5e-4 of its norm against the one-process
    step: the f32 gradient of the loss on this batch differs from the f64
    one by more than 1e-5 of its norm (and well below 5e-4)."""
    from yolo_infer_tpu_torch.core.losses import DEFAULT_HYP

    model = start[3]
    batch = {k: torch.from_numpy(v) for k, v in step_batch().items()}
    grads = {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(model).to(dtype).train()
        out, _ = m(batch["images"].to(dtype) / 255, dtype)
        loss, _ = detection_loss(out["feats"], batch, nc=NC, reg_max=16, strides=m.spec.strides, hyp=DEFAULT_HYP)
        grads[dtype] = torch.cat([g.reshape(-1).double() for g in torch.autograd.grad(loss, list(m.parameters()))])
    err = float((grads[torch.float32] - grads[torch.float64]).norm() / grads[torch.float64].norm())
    assert 1e-5 < err < UPDATE_RTOL, err
