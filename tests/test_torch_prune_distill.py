"""The port's pruning, surgery, distillation and QAT steps against the JAX
package's, and their surfaces (optimizers, checkpoints, export, command
line), on the CPU.

Masks must equal the JAX package's bit for bit (ties included: the weights
are rounded to a coarse grid, so many magnitudes and channel norms tie),
surgery's kept indices must be the JAX package's for every task, and a slim
forward the JAX slim forward (2e-5 of the maps' largest value: the two
packages' f32 convolutions sum in other orders).

Three steps with a pruning mask and a teacher follow JAX's three steps as
`test_torch_train_step.py` holds the plain step (loss 1e-3 relative,
params, EMA and batch-norm state 5e-4 absolute; measured 3.4e-4 and
2.4e-4), and a port step that leaves out the mask or the teacher fails that
check (measured: the pinned zeros regrow and params move 0.015; the loss is
11% off).

QAT is held conv by conv inside the port's step: each conv block gets, on
the input it was given, JAX's fake-quant `conv_block` within 1e-5 of its
largest output (measured 1.7e-6; the plain step's blocks are all more than
1e-3 off). The whole QAT step cannot be held to JAX's: the fake-quant
training forward is ill-conditioned, since a value that lands at a rounding
edge takes one code or the next depending on the last bit of the float sum
before it, a flipped code moves its channel's batch statistics, and the
next quantizer magnifies that again. The port's own forward in f32 and in
f64 differs by 28% of the head maps under fake quantization (2.6e-5
without), and the first QAT step's loss differs from JAX's by 20% at
64 px, while every conv of that step agrees.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_trainer import write_rect_dataset
from torch_threads import one_torch_thread  # noqa: F401
from yolo_infer_tpu.core import train_step as JT
from yolo_infer_tpu.models import build_spec as jax_build_spec
from yolo_infer_tpu.models.yolo11 import fold_model as jax_fold_model
from yolo_infer_tpu.models.yolo11 import forward as jax_forward
from yolo_infer_tpu.nn.layers import conv_block as jax_conv_block
from yolo_infer_tpu.nn.quantize import QuantContext as JaxQuantContext
from yolo_infer_tpu.nn.quantize import quant_context as jax_quant_context
from yolo_infer_tpu.optimization import pruning as JP
from yolo_infer_tpu.optimization import surgery as JS
from yolo_infer_tpu_torch import cli as port_cli
from yolo_infer_tpu_torch.core import train_step as PT
from yolo_infer_tpu_torch.core.model import YOLO11Model
from yolo_infer_tpu_torch.models.blocks import Conv
from yolo_infer_tpu_torch.models.convert import params_from_jax, params_to_jax, state_dict_from_jax
from yolo_infer_tpu_torch.models.spec import build_spec
from yolo_infer_tpu_torch.models.yolo11 import build_model
from yolo_infer_tpu_torch.optimization import pruning as PP
from yolo_infer_tpu_torch.optimization import surgery as PS
from yolo_infer_tpu_torch.optimization.distillation import create_distiller
from yolo_infer_tpu_torch.optimization.pruning import create_pruner
from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

NC, IMGSZ, B, M = 3, 64, 2, 6
# the masked distillation steps against JAX: loss and loss_kd relative,
# params, EMA and batch-norm state absolute (module docstring)
STEP_TOL = {"loss": 1e-3, "loss_kd": 1e-3, "tree": 5e-4}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_tree(task, seed=0, coarse=False):
    """A yolo11n tree (nc 3) in the JAX layout, as a JAX pytree holds it
    (`tree_map` sorts dict keys), with its batch-norm state shifted off zero
    (so a zeroed channel's BN(0) is not 0 unless its affine is zeroed);
    `coarse` rounds every weight to steps of 0.02, which ties magnitudes.
    The weights are the port's seeded init carried across (faster to build
    than the JAX package's eager init); built once per argument set
    (nothing here changes a tree in place)."""
    model, _ = build_model(task, "n", NC, seed=seed)
    params, state = (to_np(t) for t in params_to_jax(model, model.spec, fused=False))
    spec = jax_build_spec(task, "n", nc=NC)
    state = jax.tree_util.tree_map(lambda v: (v + 0.3).astype(np.float32), state)
    if coarse:
        params = jax.tree_util.tree_map(lambda v: (np.round(v / 0.02) * 0.02).astype(np.float32), params)
    return params, state, spec


def _port_masks_from_jax(jmasks, spec, state, model):
    ones_state = jax.tree_util.tree_map(np.ones_like, state) if state is not None else None
    sd = state_dict_from_jax(jmasks, spec, ones_state)
    return {n: sd[n] for n, _ in model.named_parameters()}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("method", ["global", "layer", "channel"])
def test_masks_are_the_jax_masks_bit_for_bit(method, fused):
    params, state, spec = _jax_tree("detect", coarse=True)
    model = params_from_jax(params, build_spec("detect", "n", NC), state)
    if fused:  # the same folded weights in both (the two folds differ in the last bit)
        params, state = to_np(jax_fold_model(params, state)), None
        model = params_from_jax(params, build_spec("detect", "n", NC))
    if method == "channel":
        jmasks, got = JP.channel_masks(params, 0.5, fused=fused), PP.channel_masks(model, 0.5, fused=fused)
    else:
        jmasks = JP.magnitude_masks(params, 0.5, scope=method, fused=fused)
        got = PP.magnitude_masks(model, 0.5, scope=method, fused=fused)
    jmasks = to_np(jmasks)
    want = _port_masks_from_jax(jmasks, spec, state, model)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # ties: equal magnitudes straddle the global cut
    mags = np.concatenate([np.abs(np.asarray(c["w"])).ravel() for c in JP._walk_prunable(params, fused)])
    assert len(np.unique(mags)) < 0.01 * mags.size
    pruned = PP.apply_masks(model, got)
    jpruned = JP.apply_masks(params, jmasks)
    assert PP.sparsity_report(pruned, fused=fused) == JP.sparsity_report(jpruned, fused=fused)


@pytest.mark.parametrize("task", ["detect", "segment", "pose", "obb", "classify"])
def test_surgery_plan_and_slim_forward_match_jax(task):
    params, state, spec = _jax_tree(task)
    pspec = build_spec(task, "n", NC)
    model = params_from_jax(params, pspec, state)
    plan = PS.build_plan(model, keep_frac=0.5)
    jplan = JS.build_plan(params, spec, keep_frac=0.5)
    assert [(g.name, g.width) for g in plan] == [(g.name, g.width) for g in jplan]
    for g, jg in zip(plan, jplan):
        assert (g.keep is None) == (jg.keep is None) and (g.keep is None or np.array_equal(g.keep, jg.keep)), g.name
    slim, plan2, rep = PS.slim_model(model, keep_frac=0.5)
    sp, ss, _, jrep = JS.slim_model(params, state, spec, keep_frac=0.5)
    assert rep == jrep and rep["params_ratio"] < 0.8
    assert sum(p.numel() for p in slim.parameters()) == rep["params_after"]
    x = np.random.default_rng(2).uniform(0, 1, (1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want, _ = jax.jit(lambda p, s: jax_forward(p, s, spec, jnp.asarray(x), compute_dtype=jnp.float32))(sp, ss)
    zeroed = PS.zero_removed(model, plan2)
    with torch.no_grad():
        got, ref = slim(torch.from_numpy(x)), zeroed(torch.from_numpy(x))
    for key in got:
        for a, b, z in zip(*(v if isinstance(v, list) else [v] for v in (got[key], want[key], ref[key]))):
            a, b, z = a.numpy(), np.asarray(b), z.numpy()
            assert np.abs(a - b).max() <= 2e-5 * np.abs(b).max(), key
            assert np.abs(a - z).max() <= 1e-4 * max(np.abs(z).max(), 1.0), key  # slim == zeroed


def test_a_slim_msgpack_written_by_jax_loads_and_serves(tmp_path):
    from yolo_infer_tpu.core.model import YOLO11Model as JaxYOLO11Model

    params, state, spec = _jax_tree("detect")
    sp, ss, _, _ = JS.slim_model(params, state, spec, keep_frac=0.5)
    path = JaxYOLO11Model.from_params(sp, task="detect", size="n", nc=NC, fused=False, state=ss,
                                      compute_dtype=jnp.float32).save(tmp_path / "slim.msgpack")
    port = YOLO11Model(path, device="cpu", compute_dtype=torch.float32)
    assert sum(p.numel() for p in port.model.parameters()) == sum(np.asarray(v).size
                                                                   for v in jax.tree_util.tree_leaves(sp))
    x = np.random.default_rng(3).uniform(0, 1, (1, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want, _ = jax.jit(lambda p, s: jax_forward(p, s, spec, jnp.asarray(x), compute_dtype=jnp.float32))(sp, ss)
    with torch.no_grad():
        got = port.model(torch.from_numpy(x))
    for a, b in zip(got["feats"], want["feats"]):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 2e-5 * np.abs(np.asarray(b)).max()
    back = YOLO11Model(port.save(tmp_path / "again.msgpack"), device="cpu", compute_dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(back.model.state_dict().values(), port.model.state_dict().values()))
    frame = np.random.default_rng(4).integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
    assert np.isfinite(port.predict(frame, conf=0.0, imgsz=IMGSZ)[0].boxes).all()


def test_a_slim_model_exports_fewer_weights_and_replays_its_eager_body(tmp_path):
    from yolo_infer_tpu_torch.core.exported import ExportedPredictor, export_predictor

    dense = YOLO11Model("yolo11n", device="cpu", compute_dtype=torch.float32, nc=NC)
    slim = create_pruner(dense, {"method": "structured", "physical": True, "sparsity": 0.5}).optimize()
    p = export_predictor(slim, tmp_path / "slim.pt2", batch=1, imgsz=IMGSZ)
    d = export_predictor(dense, tmp_path / "dense.pt2", batch=1, imgsz=IMGSZ)
    assert p.stat().st_size < 0.8 * d.stat().st_size
    frames = np.random.default_rng(3).integers(0, 256, (1, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    got = ExportedPredictor.load(p).predict_raw(frames, 1e-4, 0.45)
    want = slim.predictor.predict_raw(torch.from_numpy(frames), 1e-4, 0.45, IMGSZ)
    assert all(torch.equal(got[k], want[k]) for k in want) and int(got["num"][0]) > 0


# ---------------------------------------------------------------- three steps against JAX

STEP_PX = 64  # the steps' image size (at 32 px the stride-32 level's batch norm sees 2 values)


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xy = rng.uniform(0, 0.6 * STEP_PX, (B, M, 2))
        wh = rng.uniform(0.1 * STEP_PX, 0.4 * STEP_PX, (B, M, 2))
        mask = np.ones((B, M), bool)
        mask[1, 4:] = False
        out.append({"images": rng.integers(0, 256, (B, STEP_PX, STEP_PX, 3), dtype=np.uint8),
                    "boxes": np.concatenate([xy, np.minimum(xy + wh, STEP_PX)], -1).astype(np.float32),
                    "classes": rng.integers(0, NC, (B, M)).astype(np.int32), "mask": mask})
    return out


def _tree_max_abs(a, b):
    return max(float(np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32)).max())
               for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


@pytest.fixture(scope="module")
def jax_option_steps():
    """Three JAX steps with a magnitude mask (sparsity 0.5, applied to the
    start) and a teacher, from the port's seeded init carried across;
    returns the start, the teacher and each step's loss, loss_kd, params,
    EMA and batch-norm state."""
    model, pspec = build_model("detect", "n", NC, seed=0)
    params, state = (to_np(t) for t in params_to_jax(model, pspec, fused=False))
    spec = jax_build_spec("detect", "n", nc=NC)
    jmask = to_np(JP.magnitude_masks(params, 0.5))
    params = to_np(JP.apply_masks(params, jmask))
    teacher, _ = build_model("detect", "n", NC, seed=5)
    tdeploy = to_np(params_to_jax(teacher, pspec, fused=True)[0])
    tx = JT.make_optimizer(0.01, total_steps=30, warmup_steps=10)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ts = JT.TrainState(params=jp, bn_state=jax.tree_util.tree_map(jnp.asarray, state), opt_state=tx.init(jp),
                       ema_params=jax.tree_util.tree_map(jnp.array, params), step=jnp.int32(0),
                       skipped=jnp.int32(0), spec=spec, tx=tx, rng=jax.random.PRNGKey(0))
    jax_step = JT.make_train_step(spec, tx, compute_dtype=jnp.float32, param_mask=jmask,
                                  distill={"params": tdeploy, "spec": spec, "temperature": 4.0, "alpha": 0.7})
    steps = []
    for batch in _batches(3):
        ts, jm = jax_step(ts, {k: jnp.asarray(v) for k, v in batch.items()})
        assert int(jm["step_skipped"]) == 0
        steps.append({"loss": float(jm["loss"]), "loss_kd": float(jm["loss_kd"]), "params": to_np(ts.params),
                      "ema_params": to_np(ts.ema_params), "bn_state": to_np(ts.bn_state)})
    return params, state, pspec, tdeploy, steps


@pytest.mark.parametrize("drop", [None, "param_mask", "distill"])
def test_three_masked_distillation_steps_match_jax(jax_option_steps, drop):
    """The port's step with the mask and the teacher follows JAX's three
    steps within `STEP_TOL` and keeps the pinned zeros; a port step that
    leaves one option out (`drop`) must fail that check, so each option is
    shown to act in the step."""
    params, state, pspec, tdeploy, steps = jax_option_steps
    model = params_from_jax(params, pspec, state)
    mask = PP.magnitude_masks(model, 0.5)  # bit-equal to JAX's (the mask test)
    kw = {"param_mask": mask, "distill": {"model": params_from_jax(tdeploy, pspec), "temperature": 4.0, "alpha": 0.7}}
    kw.pop(drop, None)
    ptx = PT.make_optimizer(0.01, total_steps=30, warmup_steps=10)
    pts = PT.init_train_state(model, ptx, device="cpu")
    port_step = PT.make_train_step(pts.spec, ptx, compute_dtype=torch.float32, **kw)
    worst = {"loss": 0.0, "loss_kd": 0.0, "tree": 0.0}
    for batch, want in zip(_batches(3), steps):
        pts, pm = port_step(pts, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert int(pm["step_skipped"]) == 0
        worst["loss"] = max(worst["loss"], abs(float(pm["loss"]) / want["loss"] - 1))
        worst["loss_kd"] = max(worst["loss_kd"], abs(float(pm.get("loss_kd", 0.0)) / want["loss_kd"] - 1))
        back = PT.train_state_to_jax(pts)
        worst["tree"] = max([worst["tree"]] + [_tree_max_abs(back[k], want[k])
                                               for k in ("params", "ema_params", "bn_state")])
    zero = pts.param_layout.flatten(mask, "cpu") == 0
    assert zero.sum() > 1e6
    kept_zeros = not pts.params[zero].any() and not pts.ema_params[zero].any()
    ok = kept_zeros and all(worst[k] <= STEP_TOL[k] for k in worst)
    assert ok == (drop is None), (drop, worst, kept_zeros)


@functools.lru_cache(maxsize=None)
def _jax_fake_convs(configs):
    """One compiled program: JAX's fake-quant `conv_block` (training mode)
    of each (node, input) pair; `configs` holds each block's (stride,
    groups, act)."""
    def fn(nodes, xs):
        with jax_quant_context(JaxQuantContext("fake")):
            return [jax_conv_block(n, {"mean": jnp.zeros(n["gamma"].shape), "var": jnp.ones(n["gamma"].shape)}, x,
                                   stride=s, groups=g, act=a, training=True)[0]
                    for (s, g, a), n, x in zip(configs, nodes, xs)]
    return jax.jit(fn)


@pytest.mark.parametrize("qat", [True, False])
def test_qat_step_fake_quantizes_every_conv_as_jax(qat):
    """Every conv block of the port's QAT step gives, on the input and
    weights it had in that step, JAX's fake-quant `conv_block`
    (training-mode batch norm) within 1e-5 of the block's largest output;
    the plain step's blocks do not (module docstring)."""
    model, pspec = build_model("detect", "n", NC, seed=0)
    ptx = PT.make_optimizer(0.01, total_steps=30, warmup_steps=10)
    pts = PT.init_train_state(model, ptx, device="cpu")
    seen = []  # (block, its JAX node and input before the update, its output)

    def hook(m, i, o):
        node = {"w": m.conv.weight.permute(2, 3, 1, 0), "gamma": m.bn.weight, "beta": m.bn.bias}
        seen.append((m, {k: np.array(v.detach()) for k, v in node.items()},  # copies: the step updates in place
                     np.array(i[0].detach().permute(0, 2, 3, 1)), np.array(o.detach().permute(0, 2, 3, 1))))

    hooks = [m.register_forward_hook(hook) for m in pts.module.modules() if isinstance(m, Conv)]
    port_step = PT.make_train_step(pts.spec, ptx, compute_dtype=torch.float32, qat=qat)
    port_step(pts, {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()})
    for h in hooks:
        h.remove()
    assert len(seen) == sum(isinstance(m, Conv) for m in pts.module.modules()) > 80
    wants = _jax_fake_convs(tuple((m.s, m.g, m.act) for m, *_ in seen))([n for _, n, _, _ in seen],
                                                                         [x for _, _, x, _ in seen])
    errs = [np.abs(y - np.asarray(w)).max() / max(np.abs(np.asarray(w)).max(), 1.0)
            for (_, _, _, y), w in zip(seen, wants)]
    if qat:
        assert max(errs) <= 1e-5, max(errs)
    else:
        assert min(errs) > 1e-3, min(errs)


# ---------------------------------------------------------------- optimizers, trainer and command line

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_rect_dataset(tmp_path_factory.mktemp("prune_ds"), n_train=2, n_val=2)


def _train_kw(tmp_path, name):
    return {"batch": 2, "imgsz": IMGSZ, "project": str(tmp_path), "name": name, "val": False}


def test_masked_fine_tune_keeps_its_zeros_and_gradual_rounds_ramp(data, tmp_path):
    model = YOLO11Model("yolo11n", device="cpu", compute_dtype=torch.float32, nc=2)
    pruner = create_pruner(model, {"method": "magnitude", "sparsity": 0.5})
    student = pruner.optimize(data=str(data), epochs=1, **_train_kw(tmp_path, "ft"))
    info = pruner.get_optimization_info()
    assert info["fine_tune"]["status"] == "completed" and info["before"]["prunable_sparsity"] == 0.0
    assert info["after"]["prunable_sparsity"] >= 0.5  # the EMA weights kept every pinned zero
    gradual = create_pruner(model, {"method": "gradual", "sparsity": 0.6, "prune_rounds": 2})
    gradual.optimize(data=str(data), epochs=2, **_train_kw(tmp_path, "gr"))
    hist = gradual.get_optimization_info()["fine_tune"]
    assert [round(h["sparsity"], 4) for h in hist] == [0.525, 0.6]
    assert abs(gradual.get_optimization_info()["after"]["prunable_sparsity"] - 0.6) < 1e-5  # floor(0.6 n) zeros
    assert student is not model and not PP.sparsity_report(model.model)["prunable_zeros"]
    with pytest.raises(ValueError, match="physical surgery requires method='structured'"):
        create_pruner(model, {"method": "magnitude", "physical": True})


def test_distillation_and_qat_through_the_optimizers(data, tmp_path):
    student = YOLO11Model("yolo11n", device="cpu", compute_dtype=torch.float32, nc=2)
    teacher = YOLO11Model("yolo11n", device="cpu", compute_dtype=torch.float32, nc=2, seed=3)
    d = create_distiller(student, {"teacher": teacher})
    out = d.optimize(str(data), epochs=1, **_train_kw(tmp_path, "kd"))
    info = d.get_optimization_info()
    assert out is not student and info["epochs_completed"] == 1 and np.isfinite(info["final_loss_kd"])
    with pytest.raises(ValueError, match="teacher nc"):
        create_distiller(student, {"teacher": YOLO11Model("yolo11n", device="cpu", nc=3)}).optimize(str(data))
    q = create_quantizer("qat", student, {"epochs": 1, "lr": 1e-4})
    qmodel = q.optimize(data=str(data), **_train_kw(tmp_path, "qat"))
    assert q.get_optimization_info()["train_status"] == "completed" and qmodel.predictor.quant_mode == "dynamic"
    frame = np.random.default_rng(0).integers(0, 256, (IMGSZ, IMGSZ, 3), dtype=np.uint8)
    assert np.isfinite(qmodel.predict(frame, conf=0.0, imgsz=IMGSZ)[0].boxes).all()


def _weights(path):
    return YOLO11Model(path, device="cpu", compute_dtype=torch.float32).model.state_dict()


@pytest.mark.parametrize("method", ["dynamic", "prune", "physical", "distill"])
def test_optimize_command_equals_the_python_api(method, data, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the trainers' run directories
    base = YOLO11Model("yolo11n", nc=2, device="cpu", compute_dtype=torch.float32)
    ckpt = base.save(tmp_path / "base.msgpack")
    cfg = tmp_path / "f32.yaml"
    cfg.write_text("model:\n  compute_dtype: float32\n")
    argv = ["--config", str(cfg), "optimize", "--model-path", str(ckpt), "--output", str(tmp_path / "cli.msgpack"),
            "--device", "cpu", "--imgsz", str(IMGSZ)]
    model = YOLO11Model(ckpt, device="cpu", compute_dtype=torch.float32)
    if method == "dynamic":
        argv += ["--method", "dynamic"]
        opt = create_quantizer("dynamic", model)
        opt.optimize()
    elif method in ("prune", "physical"):
        argv += ["--method", "prune", "--sparsity", "0.3"] + (["--physical"] if method == "physical" else [])
        opt = create_pruner(model, {"method": "structured" if method == "physical" else "magnitude",
                                    "sparsity": 0.3, "physical": method == "physical"})
        opt.optimize()
    else:
        teacher = YOLO11Model("yolo11n", nc=2, device="cpu", compute_dtype=torch.float32, seed=3)
        tpath = teacher.save(tmp_path / "teacher.msgpack")
        argv += ["--method", "distill", "--teacher", str(tpath), "--data", str(data), "--epochs", "1"]
        opt = create_distiller(model, {"teacher": str(tpath)})
        opt.optimize(str(data), epochs=1, imgsz=IMGSZ, name="api")
        assert port_cli.YOLO11CLI().run(argv[:-4] + ["--teacher", str(tpath), "--epochs", "1"]) == 2  # no data
        capsys.readouterr()
    assert port_cli.YOLO11CLI().run(argv) == 0
    assert json.loads(capsys.readouterr().out)["saved"] == str(tmp_path / "cli.msgpack")
    want = _weights(opt.save_optimized_model(tmp_path / "api.msgpack"))
    got = _weights(tmp_path / "cli.msgpack")
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)


def test_train_qat_command_runs(data, tmp_path, capsys):
    argv = ["train", "--data", str(data), "--epochs", "1", "--batch", "2", "--imgsz", str(IMGSZ), "--qat",
            "--project", str(tmp_path), "--device", "cpu"]
    assert port_cli.YOLO11CLI().run(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "completed" and out["skipped_steps"] == 0
