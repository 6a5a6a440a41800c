"""The port's C2PSA attention vs the JAX package, on the CPU.

The plain version of the port's attention kernel against the TPU kernel
`attention_qkv_fused_pallas` in interpret mode, on the same numpy-seeded
bf16 slabs; the CUDA kernel itself is checked in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_infer_tpu.models.blocks import apply_attention
from yolo_infer_tpu.ops.pallas.attention_fused import attention_qkv_fused_pallas
from yolo_infer_tpu_torch.models.blocks import Attention
from yolo_infer_tpu_torch.models.convert import _conv
from yolo_infer_tpu_torch.ops.kernels.attention_fused import attention_qkv, attention_qkv_reference


def _slab(seed, b, n, heads, kd, hd):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, n, heads * (2 * kd + hd))).astype(np.float32)


@pytest.mark.parametrize("n,kd,hd,heads", [(400, 32, 64, 2), (400, 32, 64, 4), (64, 16, 32, 1)])
def test_reference_matches_pallas_kernel_bf16(n, kd, hd, heads, b=3):
    x = _slab(1, b, n, heads, kd, hd)
    want = np.asarray(attention_qkv_fused_pallas(jnp.asarray(x, jnp.bfloat16), heads, kd, hd, interpret=True), np.float32)
    got = attention_qkv_reference(torch.from_numpy(x).to(torch.bfloat16), heads, kd, hd).float().numpy()
    assert got.shape == want.shape == (b, n, heads * hd)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_reference_matches_pallas_kernel_f32():
    x = _slab(2, 2, 64, 2, 16, 32)
    want = np.asarray(attention_qkv_fused_pallas(jnp.asarray(x), 2, 16, 32, interpret=True))
    got = attention_qkv_reference(torch.from_numpy(x), 2, 16, 32).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_wrapper_takes_the_plain_version_on_cpu_only():
    x = torch.from_numpy(_slab(3, 2, 16, 1, 16, 32))
    before = attention_qkv.launches
    assert torch.equal(attention_qkv(x, 1, 16, 32), attention_qkv_reference(x, 1, 16, 32))
    assert attention_qkv.launches == before
    with pytest.raises(ValueError):
        attention_qkv(x.to("meta"), 1, 16, 32)


def test_attention_block_matches_jax_apply_attention():
    """The whole Attention module (qkv conv, attention, pe on v, proj) in f32."""
    rng = np.random.default_rng(4)
    dim, heads = 128, 2
    key_dim = dim // heads // 2
    c_qkv = dim + heads * key_dim * 2

    def node(ci, co, k, groups=1):
        return {"w": (rng.standard_normal((k, k, ci // groups, co)) / np.sqrt(ci // groups * k * k)).astype(np.float32),
                "b": rng.uniform(-0.1, 0.1, co).astype(np.float32)}

    p = {"qkv": node(dim, c_qkv, 1), "proj": node(dim, dim, 1), "pe": node(dim, dim, 3, groups=dim)}
    x = rng.standard_normal((2, 7, 9, dim)).astype(np.float32)
    want, _ = apply_attention({k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in p.items()},
                              None, jnp.asarray(x), num_heads=heads, impl="xla")
    mod = Attention(dim, heads)
    for name in ("qkv", "proj", "pe"):
        getattr(mod, name).fold()
    sd = {}
    for name in ("qkv", "proj", "pe"):
        _conv(sd, name, p[name], None)
    mod.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
