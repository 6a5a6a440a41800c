"""The port's mesh and process helpers (`yolo_infer_tpu_torch/parallel/`) on
the CPU, against the JAX package's (the cases of `tests/test_parallel.py`).

Meshes made without a process group are shapes only (`create_mesh` checks
them before any group exists), so the shape and layout cases run in this
process; the collectives run in two gloo processes
(`parallel/distributed.py launch`, `tests/torch_dist.py`), each launch with a
time limit so that a hung rank fails its test instead of stalling the suite.
"""

import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import yolo_infer_tpu_torch.utils.helpers as helpers
from torch_dist import TIMEOUT_S, dying_rank, failing_rank, hanging_rank, helpers_rank
from torch_threads import one_torch_thread  # noqa: F401
from yolo_infer_tpu.models.yolo11 import build_model as jax_build_model
from yolo_infer_tpu.parallel import mesh as JM
from yolo_infer_tpu_torch.models.convert import state_dict_from_jax
from yolo_infer_tpu_torch.models.yolo11 import build_model
from yolo_infer_tpu_torch.parallel import distributed as dist
from yolo_infer_tpu_torch.parallel.mesh import Mesh, create_mesh, param_pspec, shard_batch, shard_params


def test_create_mesh_shapes():
    for kw in ({"n_devices": 8, "tp": 2}, {"n_devices": 4}, {"n_devices": 8, "dp": 2, "tp": 4}):
        assert create_mesh(**kw).shape == dict(JM.create_mesh(**kw).shape)
    assert create_mesh(n_devices=8, tp=2).shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        create_mesh(n_devices=8, dp=3, tp=2)
    with pytest.raises(ValueError):
        JM.create_mesh(n_devices=8, dp=3, tp=2)
    assert create_mesh(devices=["cpu", "cpu"]).devices == ("cpu", "cpu")


@pytest.mark.parametrize("dp,tp", [(4, 1), (4, 2)])
def test_shard_batch_lays_the_batch_out_as_named_sharding(dp, tp):
    """Rank r = d * tp + m holds what `jax.device_put(x, NamedSharding(mesh,
    P("data")))` puts on the mesh's device r: data slice d, the same for
    every m; a batch the data axis does not divide raises in both."""
    jmesh = JM.create_mesh(n_devices=dp * tp, tp=tp)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    placed = jax.device_put(x, NamedSharding(jmesh, P("data")))
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for r, device in enumerate(jmesh.devices.flat):
        mesh = Mesh({"data": dp, "model": tp}, (), rank=r)
        got = shard_batch({"x": x, "t": torch.from_numpy(x)}, mesh)
        np.testing.assert_array_equal(got["x"], by_device[device])
        np.testing.assert_array_equal(got["t"].numpy(), by_device[device])
    with pytest.raises(ValueError):
        shard_batch(x[:6], Mesh({"data": dp, "model": tp}, ()))
    with pytest.raises(ValueError):
        jax.device_put(x[:6], NamedSharding(jmesh, P("data")))


def _marks(tree, tp):
    """Each JAX leaf as ones where `param_pspec` shards it, zeros where not."""
    return jax.tree_util.tree_map(
        lambda x: np.full(x.shape, float(any(a is not None for a in JM.param_pspec(x, tp))), np.float32), tree)


@pytest.mark.parametrize("task,size,nc", [("detect", "n", 80), ("detect", "s", 80), ("segment", "n", 80),
                                          ("pose", "n", 1), ("obb", "n", 15), ("classify", "s", 1000)])
def test_param_pspec_shards_the_leaves_jax_shards(task, size, nc):
    """At tp = 2 the port's rule, on its OIHW layouts, picks the parameters
    that the JAX rule picks on its HWIO tree: each JAX leaf, marked 1 where
    sharded, carried to the port's names (`models/convert.py`)."""
    params, state, spec = jax_build_model(jax.random.PRNGKey(0), task, size, nc)
    marked = state_dict_from_jax(_marks(params, 2), spec, jax.tree_util.tree_map(np.asarray, state))
    model, _ = build_model(task, size, nc, seed=0)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) <= set(marked)
    want = {n for n in names if marked[n].all()}
    assert all(not marked[n].any() for n in names if n not in want)
    assert {n for n, p in model.named_parameters() if param_pspec(p, 2)} == want
    assert want and not {n for n, p in model.named_parameters() if param_pspec(p, 1)}


def test_shard_params_runs_every_leaf_the_rule_shards_or_says_where_it_does_not():
    """Every YOLO11 model's sharded leaves (a 1000-class classify head's bias
    among them) are conv blocks, head projections or a linear bias, which
    shard (given the group's row); a leaf of another kind (a 256-channel
    transposed conv) raises, pointing at the ROADMAP."""
    model, _ = build_model("classify", "n", 1000, seed=0)
    assert param_pspec(model.model[-1].linear.bias, 2) == ("model",)
    with pytest.raises(ValueError, match="process group"):
        shard_params(model, Mesh({"data": 1, "model": 2}, ()))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9.2"):
        shard_params(torch.nn.Sequential(torch.nn.ConvTranspose2d(256, 256, 2, 2)), Mesh({"data": 1, "model": 2}, ()))
    detect = build_model("detect", "n", 80, seed=0)[0]
    assert shard_params(detect, Mesh({"data": 2, "model": 1}, ())) is detect  # tp 1: the whole model


@pytest.mark.parametrize("shape,tp", [((256, 64, 3, 3), 2), ((255, 64, 3, 3), 2), ((258, 64, 1, 1), 4),
                                      ((512,), 4), ((254,), 2), ((256, 256), 2), ((512, 32, 3, 3), 1)])
def test_param_pspec_follows_the_jax_rule_at_the_edges(shape, tp):
    """Channel counts at and below TP_MIN_CHANNELS, a count the model axis
    does not divide, 2-D leaves and tp = 1: the port's spec on an OIHW (or
    1-D, 2-D) tensor is the JAX spec on the same leaf in its HWIO layout,
    with the dimensions carried along."""
    t = torch.zeros(shape)
    jax_leaf = np.zeros(tuple(shape[i] for i in (2, 3, 1, 0)) if len(shape) == 4 else shape, np.float32)
    want = tuple(JM.param_pspec(jax_leaf, tp))
    if len(shape) == 4 and want:
        want = tuple(want[i] for i in (3, 2, 0, 1))  # HWIO -> OIHW
    assert param_pspec(t, tp) == (want if any(want) else ())


def test_distributed_helpers_single_process():
    assert dist.is_main_process() and dist.process_index() == 0 and dist.process_count() == 1
    assert dist.broadcast_scalar(3.5) == 3.5
    assert dist.all_reduce_scalar(2.5, "max") == 2.5
    with pytest.raises(ValueError):
        dist.all_reduce_scalar(1.0, "mean")
    dist.sync_processes()  # no-op, must not raise


def test_distributed_helpers_over_two_processes():
    r0, r1 = dist.launch(helpers_rank, 2, timeout_s=TIMEOUT_S)
    assert (r0["index"], r1["index"], r0["count"], r0["main"], r1["main"]) == (0, 1, 2, True, False)
    for r in (r0, r1):
        assert (r["bcast0"], r["bcast1"]) == (10.0, 11.0)
        assert (r["sum"], r["max"], r["min"]) == (4.5, 3.0, 1.5)
        assert r["bad_op_raises"]
    assert r0["sync_wait_s"] > 1.0  # the barrier held rank 0 for rank 1's 2 s


def test_launch_fails_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        dist.launch(failing_rank, 2, timeout_s=TIMEOUT_S)


def test_launch_fails_when_a_rank_dies_without_a_report():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed:\nexited with code 3"):
        dist.launch(dying_rank, 2, timeout_s=TIMEOUT_S)
    assert time.monotonic() - t0 < 60  # not the launch's time limit


def test_launch_fails_when_a_rank_hangs():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        dist.launch(hanging_rank, 2, timeout_s=5.0)
    assert time.monotonic() - t0 < 60  # the hung rank was killed, not waited for


def test_get_device_info_reports_each_devices_process(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(helpers, "_device_memory_stats", lambda: {})
    devices = helpers.get_device_info()["devices"]
    assert devices == [{"id": i, "kind": "card", "platform": "gpu", "process": 0} for i in range(2)]
