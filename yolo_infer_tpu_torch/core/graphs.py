"""One serving signature captured into a CUDA graph and replayed.

The port's counterpart of a `jax.jit` program: the JAX package compiles one
XLA program per input signature and dispatches it per call; on the card the
port captures the ~600 kernel launches of one signature's serving call into
a CUDA graph and replays it, so a call costs the host one replay instead of
launching every kernel from Python. Used by the live `Predictor` (one
`CapturedProgram` per program-cache key, `core/predictor.py`) and by
`core/exported.py ExportedPredictor` (one per loaded artifact).

The sequence: static inputs (zero frames of the signature's shape, conf
0.25, iou 0.45) are made first, so nothing the program reads is created
inside the capture; `WARMUP_CALLS` eager calls run on a side stream (first-use
kernel builds and loads, kernel attributes, cuDNN's plans and handles all
happen there); then one call is captured, on the same stream, into the
graph's own memory pool. Every capture on a device uses one side stream:
cuBLAS keeps a workspace (32 MiB on an H100) per stream for the life of the
process, so a stream per capture would leave one behind for each program,
and a workspace first made inside a capture would pin that graph's pool.
A call copies its frames, conf and iou into the static inputs and replays.
conf and iou are runtime inputs, so one capture serves every threshold pair.
A capture that fails raises: there is no eager fallback on the card.

Memory: each program keeps its own pool (the default). One pool shared by a
predictor's graphs (`torch.cuda.graph_pool_handle()`) is safe only while
the graphs replay in the order they were captured, on one stream; the
predictor replays on the caller's stream (`predict`, `predict_raw`) and on
`predict_many`'s compute stream, so they do not share.

A replay overwrites the graph's static outputs. `__call__` hands back
clones made on the replaying stream, so a result outlives the next call, as
the arrays a JAX program returns do; `replay` hands back the static outputs
themselves, for a caller that reads what it needs before the next replay.

Unlike a compiled XLA executable, a graph holds its call's peak memory
(activations included) for as long as it lives; `release` gives it back.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence

import torch

WARMUP_CALLS = 1  # eager calls on a side stream before the capture
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}  # the warm-up and capture stream of each device, by index


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return _SIDE_STREAMS[index]


class CapturedProgram:
    """`fn(frames, conf, iou) -> dets`, captured once on the card at frames
    of shape `frames_shape` (uint8) and replayed by each call."""

    def __init__(self, fn: Callable[..., Dict[str, torch.Tensor]], frames_shape: Sequence[int],
                 device: torch.device):
        t0 = time.perf_counter()
        self.frames = torch.zeros(tuple(frames_shape), dtype=torch.uint8, device=device)
        self.conf = torch.full((), 0.25, dtype=torch.float32, device=device)
        self.iou = torch.full((), 0.45, dtype=torch.float32, device=device)
        side = _side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                fn(self.frames, self.conf, self.iou)
        torch.cuda.synchronize(device)  # a fault of the warm-up shows here, not inside the capture
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            self.out = fn(self.frames, self.conf, self.iou)
        torch.cuda.current_stream(device).wait_stream(side)
        self.capture_s = time.perf_counter() - t0  # warm-up and capture, on the host clock

    def replay(self, frames: torch.Tensor, conf: torch.Tensor, iou: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Copy the inputs into the static buffers and replay on the current
        stream. Returns the graph's static outputs, which the next replay
        overwrites. Nothing here waits for the device."""
        self.frames.copy_(frames)
        self.conf.copy_(conf)
        self.iou.copy_(iou)
        self.graph.replay()
        return self.out

    def __call__(self, frames: torch.Tensor, conf: torch.Tensor, iou: torch.Tensor) -> Dict[str, torch.Tensor]:
        """`replay`, then clones of the static outputs made on the same
        stream, so the result outlives the next replay."""
        return {k: v.clone() for k, v in self.replay(frames, conf, iou).items()}

    def release(self) -> None:
        """Wait for the card (a replay may still run), drop the static
        tensors and reset the graph, so its pool is free; the pool's memory
        goes back to the card at the next `torch.cuda.empty_cache()`. The
        program cannot replay after this."""
        torch.cuda.synchronize(self.frames.device)
        self.out = self.frames = self.conf = self.iou = None
        self.graph.reset()
