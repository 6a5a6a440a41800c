"""What kernels A, C and G share around the walk of `csrc/nms_walk.cuh`.

Each image's suppression bitmask is K rows of `bits_stride(K)` 32-bit
words: ceil(K/32) padded to a multiple of 4, so that every row starts on 16
bytes, as the walk's 16-byte copies need. The kernels write only the words
the walk reads; the rest of the scratch stays as `torch.empty` left it.

The threshold goes to the kernels as a 0-d f32 tensor on their device
(`threshold_tensor`), which the bits pass reads at run time, as the TPU
kernels read `thr_ref`: a captured CUDA graph or an exported program then
takes the value current at each run instead of the one it was made with.
"""

from __future__ import annotations

from typing import Callable, Union

import torch


def bits_stride(k: int) -> int:
    """Words per row of the bitmask: ceil(k/32) rounded up to a multiple of 4
    (`nms_walk::bits_stride`)."""
    return ((k + 31) // 32 + 3) // 4 * 4


def bits_scratch(b: int, k: int, device: torch.device) -> torch.Tensor:
    """The (b, k, bits_stride(k)) int32 scratch of one launch."""
    return torch.empty((b, k, bits_stride(k)), dtype=torch.int32, device=device)


def threshold_tensor(thr: Union[float, torch.Tensor], device: torch.device) -> torch.Tensor:
    """`thr` as a 0-d f32 tensor on `device`. A Python number is written
    with `torch.full`, a fill kernel on the card: no host copy and no
    synchronisation."""
    if torch.is_tensor(thr):
        if thr.dim() != 0:
            raise ValueError(f"a threshold must be a 0-d tensor, got shape {tuple(thr.shape)}")
        return thr.to(device=device, dtype=torch.float32)
    return torch.full((), float(thr), dtype=torch.float32, device=device)


def launch_keep(name: str, wrapper: Callable, launcher: Callable, x: torch.Tensor, valid: torch.Tensor,
                thr: torch.Tensor) -> torch.Tensor:
    """The CUDA side of ops A, C and G once their inputs are checked: the
    (B, K) keep mask and the bits scratch allocated, the bits pass and the
    walk launched on the current stream (`launcher()`'s C entry point), and
    `wrapper.launches` counted."""
    if not (x.is_contiguous() and valid.is_contiguous()):
        raise ValueError(f"{name}: the candidates and valid must be contiguous")
    b, k = valid.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=x.device)
    if b == 0 or k == 0:
        return keep
    bits = bits_scratch(b, k, x.device)
    with torch.cuda.device(x.device):
        err = launcher()(x.data_ptr(), valid.data_ptr(), keep.data_ptr(), bits.data_ptr(), b, k, thr.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    wrapper.launches += 1
    return keep
