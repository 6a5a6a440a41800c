"""Process coordination over `torch.distributed`.

Port of `yolo_infer_tpu/parallel/distributed.py` (`process_index`,
`process_count`, `is_main_process`, `broadcast_scalar`, `all_reduce_scalar`,
`sync_processes`). The JAX package is single-controller: one program drives
every device, and these helpers only matter across hosts. The port is
multi-controller, PyTorch's idiom: one process per device, joined by a
process group (`torchrun`, or `launch` below). Each helper is the identity or
a no-op when no process group is initialized, as the JAX helpers are at
`process_count() == 1`.

Scalars travel as f32 tensors on the group's device: the current CUDA device
under NCCL, the CPU under gloo. Only `all_reduce`, `all_gather` and
`broadcast` are used (gloo has no `reduce_scatter`, and takes CUDA tensors
only in those three).

Also here:
- `all_reduce_sum`, a sum over a group that autograd differentiates: its
  backward sums the incoming gradients over the same group, which is what a
  batch norm synchronised over the batch needs (the semantics of
  `torch.distributed.nn.functional.all_reduce`, without its deprecation);
- `copy_to_group` and `gather_channels`, the two halves of an output-channel
  sharded conv: the input goes in as it is and its gradient is summed over
  the group; the local channels are gathered, and the gradient of the
  gathered map is cut back to the local channels;
- `launch`, which starts one process per device, joins them in a group over
  a `FileStore` rendezvous, runs a function in each and returns what each
  returned (a rank that fails or hangs fails the launch and the others are
  killed).
"""

from __future__ import annotations

import datetime
import io
import multiprocessing
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main_process() -> bool:
    """The rank-0 gate (the reference's `RANK in {-1, 0}` checks)."""
    return process_index() == 0


def group_device(group: Any = None) -> torch.device:
    """Where a collective's tensors live for `group`'s backend: the current
    CUDA device under NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_scalar(value: float, root: int = 0) -> float:
    """Agree on a process-local scalar (stop flags, epochs): `root`'s value on
    every process. Without a process group: `value`."""
    if not initialized():
        return value
    t = torch.tensor([value if process_index() == root else 0.0], dtype=torch.float32, device=group_device())
    dist.broadcast(t, src=root)
    return float(t[0])


def all_reduce_scalar(value: float, op: str = "sum") -> float:
    """Combine a process-local scalar over every process: "sum", "max" or
    "min" (anything else raises `ValueError`). Without a process group: `value`."""
    if op not in _REDUCE_OPS:
        raise ValueError(op)
    if not initialized():
        return value
    t = torch.tensor([value], dtype=torch.float32, device=group_device())
    dist.all_reduce(t, op=_REDUCE_OPS[op])
    return float(t[0])


def sync_processes() -> None:
    """Barrier over every process (a no-op without a process group): an
    all-reduce that no process leaves before all have entered it."""
    if initialized():
        t = torch.zeros(1, dtype=torch.float32, device=group_device())
        dist.all_reduce(t)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


# ---------------------------------------------------------------------------
# collectives that autograd differentiates
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of `x` over `group`, as a new tensor; its gradient is the sum
    of the incoming gradients over `group`."""
    return _AllReduceSum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def copy_to_group(x: torch.Tensor, group: Any) -> torch.Tensor:
    """`x` unchanged; its gradient summed over `group` (every rank of the
    group computes a part of the layer that reads `x`)."""
    return _CopyToGroup.apply(x, group)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
        size = dist.get_world_size(group)
        ctx.index, ctx.c, ctx.dim = dist.get_rank(group), y.shape[dim], dim
        parts = [torch.empty_like(y, memory_format=torch.contiguous_format) for _ in range(size)]
        dist.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(ctx.dim, ctx.index * ctx.c, ctx.c), None, None


def gather_channels(y: torch.Tensor, group: Any, dim: int = 1) -> torch.Tensor:
    """Every rank of `group`'s `y` concatenated along `dim` in rank order:
    the channels of (N, C, ...) maps, or (dim 0) a per-channel tensor. The
    backward takes this rank's part of the incoming gradient: the layers
    after it run the same on every rank, so each rank's gradient of the
    gathered tensor is already the whole one (a backward that summed over
    the ranks would multiply it by the group's size)."""
    return _GatherChannels.apply(y, group, dim)


# ---------------------------------------------------------------------------
# starting a group of processes
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, world: int, backend: str, device: str, store_path: str, timeout_s: float, threads: int,
               args, results) -> None:
    torch.set_num_threads(threads)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        buf = io.BytesIO()  # by value: a tensor put in the queue as it is would be shared with this exiting process
        torch.save(out, buf)
        results.put((rank, True, buf.getvalue()))
    except Exception:  # reported to the launcher, which fails the launch
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable[..., Any], world: int, *, backend: str = "gloo",
           devices: Union[None, str, Sequence[Union[str, torch.device]]] = None, args: Sequence[Any] = (),
           timeout_s: float = 600.0) -> List[Any]:
    """Run `fn(*args)` in `world` new processes (the `spawn` start method),
    rank r on `devices[r]` (default: every rank on the CPU), joined in one
    `backend` process group through a `FileStore` in a new temporary
    directory. Returns each rank's result in rank order. `fn` and `args`
    must pickle (a module-level function). A rank that raises, or a launch
    that outlasts `timeout_s`, kills the remaining ranks and raises."""
    if isinstance(devices, (str, torch.device)) or devices is None:
        devices = [devices or "cpu"] * world
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} processes")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    root = tempfile.mkdtemp(prefix="yolo_dist_")
    threads = max(1, torch.get_num_threads() // world)  # the ranks share this process's cores
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, backend, str(devices[r]), f"{root}/store",
                                                    timeout_s, threads, tuple(args), results), daemon=True)
             for r in range(world)]
    out: List[Optional[Any]] = [None] * world
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + timeout_s
        failed, reported, grace = {}, set(), None
        while len(reported) < world:  # drain the queue before joining: a child blocks until its result is read
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                now = time.monotonic()
                # a rank gone without a report (killed, crashed) fails the launch, as does the time limit
                failed.update({r: f"exited with code {p.exitcode} and no result" for r, p in enumerate(procs)
                               if p.exitcode is not None and r not in reported and r not in failed})
                if failed:
                    # the others fail soon after (their peer is gone): wait a little for their reports
                    grace = grace or now + 5.0
                    if now > grace:
                        break
                elif now > end:
                    raise TimeoutError(f"launch: no result from ranks {sorted(set(range(world)) - reported)} "
                                       f"within {timeout_s} s")
                continue
            reported.add(rank)
            if ok:
                out[rank] = torch.load(io.BytesIO(value), weights_only=False)
            else:
                failed[rank] = value
        if failed:
            raise RuntimeError("launch: " + "\n".join(f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items())))
        for p in procs:
            p.join(timeout=max(end - time.monotonic(), 1.0))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(root, ignore_errors=True)
