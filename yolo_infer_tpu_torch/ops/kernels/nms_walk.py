"""The bits scratch that kernels A, C and G hand to the walk of `csrc/nms_walk.cuh`.

Each image's suppression bitmask is K rows of `bits_stride(K)` 32-bit
words: ceil(K/32) padded to a multiple of 4, so that every row starts on 16
bytes, as the walk's 16-byte copies need. The kernels write only the words
the walk reads; the rest of the scratch stays as `torch.empty` left it.
"""

from __future__ import annotations

import torch


def bits_stride(k: int) -> int:
    """Words per row of the bitmask: ceil(k/32) rounded up to a multiple of 4
    (`nms_walk::bits_stride`)."""
    return ((k + 31) // 32 + 3) // 4 * 4


def bits_scratch(b: int, k: int, device: torch.device) -> torch.Tensor:
    """The (b, k, bits_stride(k)) int32 scratch of one launch."""
    return torch.empty((b, k, bits_stride(k)), dtype=torch.int32, device=device)
