"""The port's multi-device dry run (`yolo_infer_tpu_torch/parallel/dryrun.py`,
two gloo processes on the CPU) against `__graft_entry__.dryrun_multichip`'s
step from the same starting state, and where it refuses to run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist import dryrun_batch
from torch_threads import one_torch_thread  # noqa: F401
from yolo_infer_tpu.core import train_step as JT
from yolo_infer_tpu.models.yolo11 import build_model as jax_build_model
from yolo_infer_tpu.parallel import mesh as JM
from yolo_infer_tpu_torch.models.convert import params_from_jax
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.parallel.dryrun import dryrun_multichip


def test_dryrun_multichip_matches_jax_at_f32(capfd):
    """The port's `dryrun_multichip(2)` (tp = 2: yolo11n's 256-channel convs
    split over two processes) from the JAX dry run's starting state, against
    the JAX dry run's step (its mesh, batch and optimizer) at f32, within
    1e-4. In bf16, as both dry runs run by default, the JAX loss alone moves
    2.1% between its 1- and 2-device meshes at this state (21.64 and 21.19),
    so only f32 holds the two packages together."""
    params, state, _ = jax_build_model(jax.random.PRNGKey(0), "detect", "n")
    model = params_from_jax(jax.tree_util.tree_map(np.asarray, params), build_spec("detect", "n", 80),
                            jax.tree_util.tree_map(np.asarray, state))
    loss = dryrun_multichip(2, model, compute_dtype=torch.float32, device="cpu")
    assert f"dryrun_multichip ok: n=2 mesh={{'data': 1, 'model': 2}} loss={loss:.4f}" in capfd.readouterr().out
    ts = JT.init_train_state(jax.random.PRNGKey(0), task="detect", size="n", imgsz=64)
    mesh = JM.create_mesh(n_devices=2, tp=2)
    ts = ts.replace_params(JM.shard_params(ts.params, mesh))
    _, m = JT.make_train_step(ts.spec, ts.tx, mesh=mesh, compute_dtype=jnp.float32)(
        ts, JM.shard_batch(dryrun_batch(), mesh))
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-4)


def test_dryrun_multichip_raises_with_no_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)


def test_dryrun_multichip_takes_a_card_per_process(monkeypatch):
    """Outside a process group it starts one process per card over NCCL,
    and a host with fewer cards than processes raises before any starts
    (ranks that share a card come only from a group the caller made)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 processes need 2 cards and this host has 1"):
        dryrun_multichip(2)
