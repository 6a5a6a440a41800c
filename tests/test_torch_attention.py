"""The port's C2PSA attention vs the JAX package, on the CPU.

The plain versions of the port's attention kernels against the TPU kernels
`attention_qkv_fused_pallas` (B) and `attention_fused_pallas` (H) in
interpret mode, on the same numpy-seeded slabs, and the three routes of
`YOLO_ATTN_IMPL`; the CUDA kernels themselves are checked in
test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_infer_tpu.models.blocks import apply_attention
from yolo_infer_tpu.ops.pallas.attention_fused import attention_fused_pallas, attention_qkv_fused_pallas
from yolo_infer_tpu_torch.models.blocks import ATTN_IMPLS, Attention, attn_impl_choice
from yolo_infer_tpu_torch.models.convert import _conv
from yolo_infer_tpu_torch.ops.kernels.attention_fused import (
    attention_packed,
    attention_packed_reference,
    attention_qkv,
    attention_qkv_reference,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


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


@pytest.mark.parametrize("dtype,atol", [(jnp.bfloat16, 2e-2), (jnp.float32, 1e-5)])
def test_packed_reference_matches_the_per_head_pallas_kernel(dtype, atol):
    """Kernel H's plain version against `attention_fused_pallas` in
    interpret mode, on a (G, N, 2kd+hd) slab packed head-major (G = 6)."""
    x = _slab(5, 6, 64, 1, 32, 64)
    want = np.asarray(attention_fused_pallas(jnp.asarray(x, dtype), 32, 64, interpret=True), np.float32)
    got = attention_packed_reference(torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32),
                                     32, 64).float().numpy()
    assert got.shape == want.shape == (6, 64, 64)
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol if dtype == jnp.bfloat16 else 0)


def test_packed_wrapper_takes_the_plain_version_on_cpu_only():
    x = torch.from_numpy(_slab(6, 4, 16, 1, 32, 64))
    before = attention_packed.launches
    assert torch.equal(attention_packed(x, 32, 64), attention_packed_reference(x, 32, 64))
    assert attention_packed.launches == before
    with pytest.raises(ValueError):
        attention_packed(x.to("meta"), 32, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_routes_agree(dtype, monkeypatch):
    """"fused" (B), "pallas" (H on the head-major copy) and "xla" (the
    einsum form) give the same Attention output; `YOLO_ATTN_IMPL` picks the
    route when the module's choice is "auto", an explicit choice wins."""
    torch.manual_seed(0)
    mod = Attention(256, 4).eval().to(dtype)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 256, 5, 6)).astype(np.float32)).to(dtype)
    outs = {}
    with torch.no_grad():
        for impl in ATTN_IMPLS:
            mod.impl = impl
            outs[impl] = mod(x).float()
    torch.testing.assert_close(outs["pallas"], outs["fused"], atol=0, rtol=0)
    torch.testing.assert_close(outs["xla"], outs["fused"], atol=1e-6 if dtype == torch.float32 else 2e-2,
                               rtol=1e-5 if dtype == torch.float32 else 2e-2)
    monkeypatch.setenv("YOLO_ATTN_IMPL", "pallas")
    assert attn_impl_choice("auto") == "pallas" and attn_impl_choice("xla") == "xla"
    monkeypatch.setenv("YOLO_ATTN_IMPL", "bogus")
    assert attn_impl_choice("auto") == "fused"
    with pytest.raises(ValueError):
        attn_impl_choice("flash")
