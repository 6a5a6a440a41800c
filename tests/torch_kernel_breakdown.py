"""Where kernels B and E spend their time on the card: the breakdown PERF.md cites.

Run from the repository root on a machine with an NVIDIA card (no jax
needed): `python tests/torch_kernel_breakdown.py`, about two minutes. It
compiles variants of `csrc/int8_conv.cu` and `csrc/attention_fused.cu` from
patched copies in a temporary directory (the port's sources and built
libraries are not touched), puts each in place of the port's library for
the timed calls, and prints one JSON line per kernel:

  int8_conv      E at the 48 inputs of a yolo11s static8 `predict` at
                 b32/640 (chip_smoke.py's int8 weights and frames), the
                 device time summed over the 48 launches for: the kernel as
                 built; its requantizing epilogue replaced by a cast; its
                 mma.sync removed; the cp.async loads of its main loop
                 removed; both of the last two with the cast epilogue
  attention_qkv  B on random bf16 (32, 400, 256) and (16, 1024, 256) slabs,
                 heads 2: as built, and with __expf and p = e * (1/l) in
                 place of expf and the correctly rounded quotient; beside
                 F.scaled_dot_product_attention on the same q, k, v

Device times are CUDA events around each call, the calls queued behind a
sleep (`chip_smoke.device_ms_each`). The variants compute wrong values on
purpose; only the kernels as built are held to their plain versions.
"""

import copy
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
import yolo_infer_tpu_torch.models.blocks as blocks_mod  # noqa: E402
from yolo_infer_tpu_torch.ops.kernels import _build  # noqa: E402
from yolo_infer_tpu_torch.ops.kernels import attention_fused as attn_mod  # noqa: E402
from yolo_infer_tpu_torch.ops.kernels import int8_conv as e_mod  # noqa: E402

E_CAST = ("q = requant2_bf16(a0, a1, s0, s1, bias2, bias != nullptr, act, syinv2);",
          "q.x = static_cast<char>(a0 * s0);\n          q.y = static_cast<char>(a1);")
E_NO_MMA = ("for (int j = 0; j < kNI; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);",
            "for (int j = 0; j < kNI; ++j) acc[i][j][0] += af[i][0] ^ bf[j][1];")
E_NO_LOADS = ("if (s + kStages - 1 < steps) load_step(s + kStages - 1, (s + kStages - 1) % kStages);", "")
E_VARIANTS = {"as_built": [], "epilogue_cast": [E_CAST], "no_mma": [E_NO_MMA], "no_loads": [E_NO_LOADS],
              "no_loads_epilogue_cast": [E_NO_LOADS, E_CAST]}
B_FAST = [("expf(__fsub_rn(", "__expf(__fsub_rn("),
          ("  const float q = __fmul_rn(a, rb);\n  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);",
           "  return __fmul_rn(a, rb);")]
B_VARIANTS = {"as_built": [], "fast_exp_reciprocal": B_FAST}


def build_variant(name: str, tag: str, patches, out_dir: Path):
    """csrc/<name>.cu with each (old, new) patch applied, built with the
    port's flags into out_dir and loaded."""
    src = (_build.CSRC_DIR / f"{name}.cu").read_text()
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"{name}: patch target not found: {old[:60]!r}")
        src = src.replace(old, new)
    cu = out_dir / f"{name}_{tag}.cu"
    cu.write_text(src)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    lib = out_dir / f"lib{name}_{tag}.so"
    subprocess.run([_build._nvcc(), *_build._flags(name), "-o", str(lib), str(cu)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def launcher(lib, name: str):
    """The variant's entry point with the argument types the port's wrapper sets."""
    fn = getattr(lib, {"int8_conv": "int8_conv_launch", "attention_fused": "attn_qkv_launch"}[name])
    port = {"int8_conv": e_mod, "attention_fused": attn_mod}[name]._launcher()
    fn.argtypes, fn.restype = port.argtypes, port.restype
    return fn


def static8_inputs():
    """The 48 kernel-E inputs of one yolo11s static8 predict at b32/640, as
    chip_smoke.py's phases 16 and 17 build the model and frames (pixel
    pitches kept)."""
    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

    calib = np.random.default_rng(cs.SEED + 13).integers(0, 256, (2, 640, 640, 3), dtype=np.uint8)
    model, _ = cs.smoke_weights(calib, size="s", calibrate_bn=False)
    batch, imgsz = cs.Q8_SERVE
    rng = np.random.default_rng(cs.SEED + 14)
    frames_calib = [rng.integers(0, 256, (8, imgsz, imgsz, 3), dtype=np.uint8) for _ in range(2)]
    frames = rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    ptq = create_quantizer("ptq", YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="s",
                                                          fused=False), {"imgsz": imgsz})
    ptq.set_calibration_data(frames_calib)
    qmodel = ptq.optimize()
    seen, e_fn = [], blocks_mod.int8_conv

    def capture(*args, **kw):
        seen.append((tuple(torch.empty_strided(a.size(), a.stride(), dtype=a.dtype, device=a.device).copy_(a)
                           if torch.is_tensor(a) else a for a in args), kw))
        return e_fn(*args, **kw)

    blocks_mod.int8_conv = capture
    try:
        qmodel.predict(frames, conf=0.25, imgsz=imgsz)
    finally:
        blocks_mod.int8_conv = e_fn
    return seen


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_breakdown: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="kernel_breakdown_") as tmp:
        libs = {(name, tag): build_variant(name, tag, patches, Path(tmp))
                for name, variants in (("int8_conv", E_VARIANTS), ("attention_fused", B_VARIANTS))
                for tag, patches in variants.items()}

        seen = static8_inputs()
        for args, kw in seen:
            if not torch.equal(e_mod.int8_conv(*args, **kw), e_mod.int8_conv_reference(*args, **kw)):
                raise AssertionError("kernel E differs from its plain version at a static8 input")
        port_e = e_mod._launcher
        e_ms = {}
        try:
            for tag in E_VARIANTS:
                fn = launcher(libs["int8_conv", tag], "int8_conv")
                e_mod._launcher = lambda fn=fn: fn
                e_ms[tag] = sum(cs.device_ms_each([lambda a=a, k=k: e_mod.int8_conv(*a, **k) for a, k in seen]))
        finally:
            e_mod._launcher = port_e
        cs.emit({"kernel": "int8_conv", "launches": len(seen), "ms_summed": e_ms})

        rng = np.random.default_rng(cs.SEED)
        port_b = attn_mod._launcher
        try:
            for b, n in ((32, 400), (16, 1024)):
                slab = torch.from_numpy(rng.standard_normal((b, n, 256)).astype(np.float32)).to("cuda", torch.bfloat16)
                q, k, v = (slab.view(b, n, 2, 128)[..., s].transpose(1, 2)
                           for s in (slice(0, 32), slice(32, 64), slice(64, None)))
                err = float((attn_mod.attention_qkv(slab, 2, 32, 64).float()
                             - attn_mod.attention_qkv_reference(slab, 2, 32, 64).float()).abs().max())
                row = {"kernel": "attention_qkv", "shape": [b, n, 256], "max_abs_err": err,
                       "sdpa_ms": cs.device_ms_each([lambda: F.scaled_dot_product_attention(q, k, v,
                                                                                            scale=32 ** -0.5)])[0]}
                for tag in B_VARIANTS:
                    fn = launcher(libs["attention_fused", tag], "attention_fused")
                    attn_mod._launcher = lambda fn=fn: fn
                    row[tag + "_ms"] = cs.device_ms_each([lambda: attn_mod.attention_qkv(slab, 2, 32, 64)])[0]
                cs.emit(row)
        finally:
            attn_mod._launcher = port_b
    return 0


if __name__ == "__main__":
    sys.exit(main())
