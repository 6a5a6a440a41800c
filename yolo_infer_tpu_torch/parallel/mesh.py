"""The ('data', 'model') mesh over a `torch.distributed` process group.

Port of `yolo_infer_tpu/parallel/mesh.py` (`create_mesh`, `TP_MIN_CHANNELS`,
`param_pspec`, `shard_params`, `shard_batch`). The JAX package is
single-controller: a `Mesh` of devices, `NamedSharding` annotations on the
arrays, and GSPMD inserting the collectives. The port is multi-controller: one process per
device, and the mesh lays the world's ranks out as a (dp, tp) grid, rank =
d * tp + m (the order of the JAX mesh's `devices.reshape(dp, tp)`), with a
process group for each column and each row:

  data   the ranks of one model index: batch-norm statistics, loss
         normalizers, metrics and gradients are summed over it (DP);
  model  the ranks of one data index: a conv whose output channels are
         sharded computes its slice and gathers the channels over it (TP).

A spec is a tuple of axis names, one per dimension (`("model", None, None,
None)`; `()` is replicated). The JAX package's `batch_sharding`,
`replicated` and `params_shardings` name placements for `jax.device_put`;
no process here places arrays on another, so the port has no counterpart:
`shard_batch` and `shard_params` return what this rank holds of the whole,
its contiguous slice of the batch and its slice of each sharded parameter.

What GSPMD makes global, the port makes global by hand while a mesh is
active (`data_parallel`, entered by `core/train_step.py` around the training
forward and the loss): `models/blocks.py Conv` computes batch-norm
statistics over the data axis (`all_reduce_sum`, two passes as `jnp.var`),
and `core/losses.py` takes its normalizers and batch factor from
`data_sum` and `global_batch`.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from yolo_infer_tpu_torch.parallel.distributed import initialized

# channels >= this get model-axis sharding when tp > 1
TP_MIN_CHANNELS = 256


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (dp, tp) grid of the group's ranks. `shape` is {"data": dp, "model":
    tp}; `devices` the mesh's devices in rank order where the caller named
    them (else empty); `data_group` and `model_group` this rank's column and
    row (None for a mesh made with no process group: a shape only, which
    places nothing and runs no collective)."""

    shape: Dict[str, int]
    devices: Tuple[Any, ...]
    data_group: Any = None
    model_group: Any = None
    rank: int = 0

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]

    def require_groups(self, what: str) -> None:
        if self.data_group is None:
            raise ValueError(f"{what} needs a mesh made inside an initialized process group "
                             "(torch.distributed.init_process_group, torchrun or parallel.distributed.launch)")

    def __deepcopy__(self, memo):  # process groups do not copy: a copy of a module keeps its mesh
        return self


def create_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1,
                devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A ('data', 'model') mesh over the first `n_devices` devices: by
    default every process of the initialized group, one device each. The
    shape is checked before any group is made (`ValueError` when dp * tp !=
    n), so it can be built and read with no group at all. Inside a group the
    mesh spans the whole world (each process is one device, and a process
    outside the mesh would have nothing to run), and every rank makes every
    row and column group, in one order."""
    if devices is not None:
        devices = list(devices)
    n = n_devices or (len(devices) if devices is not None else (dist.get_world_size() if initialized() else 1))
    if devices is not None:
        devices = devices[:n]
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != n_devices({n})")
    shape = {"data": dp, "model": tp}
    devs = tuple(devices or ())
    if not initialized():
        return Mesh(shape, devs)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh spans every process of the group: n_devices {n} != world size {world}")
    data_groups = [dist.new_group([d * tp + m for d in range(dp)]) for m in range(tp)]
    model_groups = [dist.new_group([d * tp + m for m in range(tp)]) for d in range(dp)]
    rank = dist.get_rank()
    return Mesh(shape, devs, data_groups[rank % tp], model_groups[rank // tp], rank)


def param_pspec(x: Any, tp: int) -> Tuple[Optional[str], ...]:
    """The spec of one parameter tensor: the JAX rule on the port's layouts.
    A 4-D conv weight (OIHW: Cout is dim 0) with Cout >= TP_MIN_CHANNELS and
    divisible by tp is sharded over its output channels, and so is a 1-D
    per-channel tensor of that size (batch-norm scale and shift, a bias)."""
    if tp > 1 and hasattr(x, "ndim"):
        if x.ndim == 4 and x.shape[0] >= TP_MIN_CHANNELS and x.shape[0] % tp == 0:
            return ("model", None, None, None)
        if x.ndim == 1 and x.shape[0] >= TP_MIN_CHANNELS and x.shape[0] % tp == 0:
            return ("model",)
    return ()


class TPShard:
    """A module's place on the model axis: the row's group, this rank's index
    in it, the row's size and the names of the module's parameters that hold
    this rank's slice (`leaves`). Copies of a module share it (a process
    group does not copy)."""

    def __init__(self, group: Any, index: int, size: int, leaves: Tuple[str, ...]):
        self.group, self.index, self.size, self.leaves = group, index, size, leaves

    def __deepcopy__(self, memo):
        return self


def _tp_leaves(m: torch.nn.Module, tp: int) -> Tuple[str, ...]:
    """The parameters of `m` (relative names) that the JAX rule shards and
    that `m` can run sharded: a `Conv` block's weight, batch-norm scale and
    shift (`Conv._forward_tp`), a head's output projection's weight and bias
    (`HeadConv2d._forward_tp`), a linear layer's bias (`Classify`: the
    weight, 2-D, stays whole)."""
    from yolo_infer_tpu_torch.models.blocks import Conv, HeadConv2d

    if isinstance(m, Conv) and not m.quantized and param_pspec(m.conv.weight, tp):
        return ("conv.weight", "bn.weight", "bn.bias")
    if isinstance(m, HeadConv2d) and param_pspec(m.weight, tp):
        return ("weight", "bias")
    if isinstance(m, torch.nn.Linear) and m.bias is not None and param_pspec(m.bias, tp):
        return ("bias",)
    return ()


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """This rank's part of `model` on the mesh. At tp = 1 that is the whole
    model (returned as it is). At tp > 1: a copy in which every module with
    leaves the JAX rule shards (`param_pspec`) keeps this rank's slice of
    their output channels and runs sharded (its `tp`): a `Conv` block
    (weight, batch-norm scale, shift and running statistics; its slice
    computed, then the channels gathered), a `HeadConv2d` (weight and bias;
    the same), a linear layer's bias (gathered where it is added). Those
    are all the leaves the rule shards in the YOLO11 models of every task
    and size; a leaf of another kind (a transposed conv of 256 channels or
    more) raises: ROADMAP Queue 1 item 9.2."""
    from yolo_infer_tpu_torch.models.blocks import Conv

    tp = mesh.shape["model"]
    if tp == 1:
        return model
    taken = {f"{n}.{leaf}" for n, m in model.named_modules() for leaf in _tp_leaves(m, tp)}
    left = [n for n, p in model.named_parameters() if param_pspec(p, tp) and n not in taken]
    if left:
        raise NotImplementedError(f"tensor parallelism of {left[:3]} is not ported yet (ROADMAP Queue 1 item 9.2)")
    mesh.require_groups("shard_params at tp > 1")
    model = copy.deepcopy(model)
    for name, m in model.named_modules():
        leaves = _tp_leaves(m, tp)
        if not leaves:
            continue
        if isinstance(m, Conv) and m.bn is None:
            raise ValueError(f"{name}: tensor parallelism needs the unfolded model (batch norms present)")
        if isinstance(m, Conv) and m.g != 1 and m.g != m.conv.weight.shape[0]:
            raise NotImplementedError(f"{name}: a grouped conv that is not depthwise")
        tensors = [(m.get_submodule(leaf.rpartition(".")[0]), leaf.rpartition(".")[2]) for leaf in leaves]
        if isinstance(m, Conv):
            tensors += [(m.bn, "running_mean"), (m.bn, "running_var")]
        with torch.no_grad():
            for owner, attr in tensors:
                t = getattr(owner, attr)
                per = t.shape[0] // tp
                local = t[mesh.model_index * per: (mesh.model_index + 1) * per].clone()
                setattr(owner, attr, torch.nn.Parameter(local) if isinstance(t, torch.nn.Parameter) else local)
        m.tp = TPShard(mesh.model_group, mesh.model_index, tp, leaves)
    return model


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This data rank's contiguous slice of every leaf's leading (batch)
    axis, in rank order, as `NamedSharding(P("data"))` lays a batch out. A
    batch that the data axis does not divide raises `ValueError`, as
    `jax.device_put` does. `batch` is a tensor, an array or a dict of them."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    dp = mesh.shape["data"]
    b = batch.shape[0]
    if b % dp:
        raise ValueError(f"the batch's dimension 0 should be divisible by the data axis ({dp}), "
                         f"but it is {b} (full shape: {tuple(batch.shape)})")
    per = b // dp
    return batch[mesh.data_index * per: (mesh.data_index + 1) * per]


def gather_batch(tensors: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole batch on every rank from each data rank's slice (the
    inverse of `shard_batch`): the tensors' bytes in one `all_gather` over
    the data axis, then each tensor's slices concatenated in rank order."""
    keys = sorted(tensors)
    parts = [tensors[k].contiguous() for k in keys]
    flat = torch.cat([p.reshape(-1).view(torch.uint8) for p in parts])
    out = [torch.empty_like(flat) for _ in range(mesh.shape["data"])]
    dist.all_gather(out, flat, group=mesh.data_group)
    sizes = [p.numel() * p.element_size() for p in parts]
    pieces = [torch.split(o, sizes) for o in out]
    return {k: torch.cat([pc[i].view(p.dtype).view(p.shape) for pc in pieces])
            for i, (k, p) in enumerate(zip(keys, parts))}


# ---------------------------------------------------------------------------
# the mesh of the running training step
# ---------------------------------------------------------------------------

_ACTIVE: List[Mesh] = []


def current_mesh() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


class data_parallel:
    """with data_parallel(mesh): forward and loss of one rank's slice, with
    batch-norm statistics and loss normalizers over the data axis. `None`
    changes nothing."""

    def __init__(self, mesh: Optional[Mesh]):
        if mesh is not None:
            mesh.require_groups("a meshed training step")
        self.mesh = mesh

    def __enter__(self) -> Optional[Mesh]:
        if self.mesh is not None:
            _ACTIVE.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc) -> bool:
        if self.mesh is not None:
            _ACTIVE.pop()
        return False


def data_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the data axis of the active mesh, detached (the loss
    normalizers: constants of the backward, as the JAX package's are); `t`
    itself with no mesh."""
    mesh = current_mesh()
    if mesh is None:
        return t
    t = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=mesh.data_group)
    return t


def global_batch(b: int) -> int:
    """The global batch size of a step whose rank holds `b` images."""
    mesh = current_mesh()
    return b if mesh is None else b * mesh.shape["data"]


def data_mean_var(y: torch.Tensor, dims: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(mean, biased variance, count) of f32 `y` over `dims` and over the
    data axis of the active mesh, in two passes as `jnp.mean` and `jnp.var`
    compute them over a sharded axis: the sum for the mean, then the sum of
    squared deviations from it, each all-reduced (a one-pass E[x^2] - mean^2
    loses digits). Both sums are differentiable: their backward sums the
    gradient over the data axis (a batch norm synchronised over the batch)."""
    from yolo_infer_tpu_torch.parallel.distributed import all_reduce_sum

    mesh = current_mesh()
    n = math.prod(y.shape[d] for d in dims)
    if mesh is None:
        var, mean = torch.var_mean(y, dim=tuple(dims), correction=0)
        return mean, var, n
    n *= mesh.shape["data"]
    keep = [slice(None) if d not in dims else None for d in range(y.dim())]
    mean = all_reduce_sum(y.sum(dim=tuple(dims)), mesh.data_group) / n
    var = all_reduce_sum(((y - mean[tuple(keep)]) ** 2).sum(dim=tuple(dims)), mesh.data_group) / n
    return mean, var, n

