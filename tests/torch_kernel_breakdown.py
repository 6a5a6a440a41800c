"""Where kernels A, B, C, D, E, F and G spend their time on the card: the breakdown PERF.md cites.

Run from the repository root on a machine with an NVIDIA card (no jax
needed): `python tests/torch_kernel_breakdown.py [int8_conv] [attention_qkv]
[mask_pack] [rotated_nms] [greedy_nms] [nms_keep] [dfl_decode]` (all seven by default), a
few minutes. It compiles variants of the port's kernels, from patched copies of
`csrc/*.cu` and their headers and from the alternative designs in
`tests/kernel_variants/`, in a temporary directory (the port's sources and
built libraries are not touched), puts each in place of the port's library
for the timed calls, and prints one JSON line per kernel and input:

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
  mask_pack      D on chip_smoke.py's segment path input, on a dense uniform
                 (9600, 160, 160) input and on the same input with one
                 instance in ten holding a 50 x 50 box and the rest zero: as
                 built; with the compare made a PTX set (all ones or zero)
                 ANDed into the word; with the zero skip off; with 32-row
                 bands; the staged design (bands in shared memory by 16-byte
                 cp.async, a 16-byte-stored output tile), the same with
                 4-byte word stores and with one band in flight; the ballot
                 design (H taps once per output row in shared memory, one
                 output pixel per lane, __ballot_sync)
  rotated_nms    C at B = 16 on random candidates (85% valid) at K = 37,
                 160, 300 and 1024, all valid at K = 1024, and on
                 chip_smoke.py's OBB path input (b16/1024): as built (bits
                 pass, then the strip-staged walk); with the resident walk
                 of tests/kernel_variants/resident_walk.cuh (the whole mask
                 in shared memory, the port's walk up to K = 1024 until it
                 measured slower); with greedy_keep_walk over the resident
                 mask; the one-block-per-image kernel that C replaced. CUDA
                 events time each call; the kernels as built are also
                 profiled alone (`profiled_*`: the bits pass and the walk)
  greedy_nms     G at chip_smoke.py's phase-13 inputs: random (16, 4096),
                 (4, 1000) and (2, 8192), and (16, 4096) with a valid prefix
                 of 300..3000: as built (the walk's words staged 16 strips
                 ahead, the kept rows ORed by the helper warps from global
                 memory, 4 words a lane at once); with 4 stages; with the
                 decision as a mask in place of a predicate (chain_mask) or
                 as PTX (a predicate and ORs under it, chain_ptx); with the
                 helpers reading 2 words a lane at once (helper_words2);
                 with warp 0 carrying 2
                 or 3 words past its own (carry2, carry3); diagnostics,
                 wrong on purpose: warp 0 alone without helpers
                 (diag_walk_alone), and that without the decision chain
                 (diag_walk_alone_no_chain); the ring-staged walk of
                 tests/kernel_variants/ring_walk.cuh (whole strips staged by
                 one cp.async.bulk per row, the helpers ORing out of the
                 ring), the same with warp 0 ORing every word itself
                 (ring_bulk_single_or) and staged by 16-byte cp.async
                 (ring_cp_async); this bits pass with the earlier walk (two
                 strip buffers staged by 4-byte cp.async, a __syncthreads
                 per strip: two_buffer_walk); the earlier G (a warp per row
                 with 4-byte loads, then that walk: scalar_bits_two_buffer).
                 Each also profiled alone (`*_bits_ms`, `*_walk_ms`)
  nms_keep       A at B = 32 on random candidates (85% valid) at K = 160,
                 384 and 1024, and on chip_smoke.py's detect path input
                 (b32/640 bf16, K = 384): as built (the IoU bits pass on
                 every SM, then the strip-staged walk), with the resident
                 walk, and the one-block kernel it replaced
                 (tests/kernel_variants/nms_fused_variants.cu)
  dfl_decode     F at chip_smoke.py's validation-path input (b16/640, the
                 (16, 8400, 64) slice of the 144-channel bf16 slab, 16-byte
                 loads) and OBB-path input (b16/1024, the slice of the
                 79-channel slab, 2-byte loads), and the val input copied
                 contiguous: as built (one row a thread, evict-first loads);
                 with `__ldg` in place of the evict-first `__ldcs` (ldg); with
                 expf in place of ex2.approx (expf); with 2-byte loads at every alignment
                 (loads2); from tests/kernel_variants/dfl_decode_variants.cu,
                 two and four rows a thread (rows2, rows4) and the first port
                 (lanes16). Each timed warm, after chip_smoke.py's L2 write
                 flush (`cold`: L2 then holds ~50 MB of dirty lines) and
                 after a read flush (`cold_read`), profiled over 20 calls, in
                 two rounds; and the SASS instructions per logit of each
                 build's kernels

Device times are CUDA events around each call, the calls queued behind a
sleep (`chip_smoke.device_ms_each`), except F's (profiled). E's and B's
variants compute wrong values on purpose, and so do G's `diag_*` variants;
A's, C's, D's, F's and G's other variants are exact designs (F's within
1e-5), and every one is held to its plain version before it is timed.
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
from yolo_infer_tpu_torch.ops.kernels import dfl_decode as f_mod  # noqa: E402
from yolo_infer_tpu_torch.ops.kernels import greedy_nms as g_mod  # noqa: E402
from yolo_infer_tpu_torch.ops.kernels import nms_fused as a_mod  # noqa: E402
from yolo_infer_tpu_torch.ops.kernels import int8_conv as e_mod  # noqa: E402
from yolo_infer_tpu_torch.ops.kernels import mask_pack as d_mod  # noqa: E402
from yolo_infer_tpu_torch.ops.kernels import rotated_nms_fused as c_mod  # noqa: E402

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
D_SET_MASK = ("      if (x[kw] > 0.5f) word |= 1u << (8 * (m >> 3) + 7 - (m & 7));",
              "      uint32_t all;\n      asm(\"set.gt.u32.f32 %0, %1, 0f3F000000;\" : \"=r\"(all) : \"f\"(x[kw]));\n"
              "      word |= all & (1u << (8 * (m >> 3) + 7 - (m & 7)));")
D_VARIANTS = {"as_built": [], "set_mask": [D_SET_MASK],
              "no_skip": [("    if (fprv || fcur || fnxt) {", "    {")],
              "band32": [("constexpr int kBand = 16;", "constexpr int kBand = 32;")]}
# alternative designs: (source in tests/kernel_variants, entry point)
D_DESIGNS = {"staged": ("mask_pack_variants.cu", "mask_pack_staged_launch"),
             "staged_stores4": ("mask_pack_variants.cu", "mask_pack_staged_stores4_launch"),
             "staged_stages1": ("mask_pack_variants.cu", "mask_pack_staged_stages1_launch"),
             "ballot": ("mask_pack_variants.cu", "mask_pack_ballot_launch")}
C_VARIANTS = {"as_built": []}
G_STAGES = "constexpr int kWalkStages = 16;"
# the decision as a mask computed from the bit (shift, and, subtract), ANDed
# into the ORs, in place of a predicate
G_CHAIN_MASK = ("        if (!(cur & (1u << t))) {\n          cur |= diag[t];\n#pragma unroll\n"
                "          for (int d = 0; d < kWalkCarry; ++d) add[d] |= next[d][t];\n        }",
                "        const uint32_t take = ((cur >> t) & 1u) - 1u;\n        cur |= diag[t] & take;\n#pragma unroll\n"
                "        for (int d = 0; d < kWalkCarry; ++d) add[d] |= next[d][t] & take;")
# the decision written in PTX as a bit test setting a predicate and two ORs
# under it, so no select stands between the test and the OR on the chain
G_CHAIN_PTX = ("        if (!(cur & (1u << t))) {\n          cur |= diag[t];\n#pragma unroll\n"
               "          for (int d = 0; d < kWalkCarry; ++d) add[d] |= next[d][t];\n        }",
               "        asm(\"{\\n.reg .pred p;\\n.reg .b32 b;\\nand.b32 b, %0, %2;\\nsetp.eq.u32 p, b, 0;\\n\"\n"
               "            \"@p or.b32 %0, %0, %3;\\n@p or.b32 %1, %1, %4;\\n}\\n\"\n"
               "            : \"+r\"(cur), \"+r\"(add[0]) : \"r\"(1u << t), \"r\"(diag[t]), \"r\"(next[0][t]));")
G_CARRY = "constexpr int kWalkCarry = 1;"
G_HELPER_WORDS = "constexpr int kHelperWords = 4;"
# diagnostics, wrong on purpose (not held to the plain version): warp 0 alone,
# with no helper warps and no wait on them; and that with no decision chain
# (so no loads of the strip's words either)
G_NO_HELPERS = [("      if (helped >= 0) mbar_wait(&ored_bar[helped % kHandoff], (helped / kHandoff) & 1);\n"
                 "      uint32_t cur = sremoved[w]", "      uint32_t cur = sremoved[w]"),
                ("  } else {\n    // helpers:", "  } else if (false) {\n    // helpers:")]
G_NO_CHAIN = ("        if (!(cur & (1u << t))) {", "        if (t < 0) {")
G_VARIANTS = {"as_built": [], "stages4": [(G_STAGES, G_STAGES.replace("16", "4"))], "chain_mask": [G_CHAIN_MASK],
              "chain_ptx": [G_CHAIN_PTX], "helper_words2": [(G_HELPER_WORDS, G_HELPER_WORDS.replace("4", "2"))],
              "carry2": [(G_CARRY, G_CARRY.replace("1", "2"))], "carry3": [(G_CARRY, G_CARRY.replace("1", "3"))],
              "diag_walk_alone": G_NO_HELPERS, "diag_walk_alone_no_chain": [*G_NO_HELPERS, G_NO_CHAIN]}
G_DESIGNS = {"ring_bulk": ("greedy_nms_variants.cu", "greedy_nms_ring_bulk_launch"),
             "ring_bulk_single_or": ("greedy_nms_variants.cu", "greedy_nms_ring_bulk_single_or_launch"),
             "ring_cp_async": ("greedy_nms_variants.cu", "greedy_nms_ring_cp_async_launch"),
             "two_buffer_walk": ("greedy_nms_variants.cu", "greedy_nms_two_buffer_walk_launch"),
             "scalar_bits_two_buffer": ("greedy_nms_variants.cu", "greedy_nms_scalar_bits_launch")}
# the bits-pass kernel each G build launches (the walks' names end in _walk_kernel)
G_BITS = {"scalar_bits_two_buffer": "scalar_bits_kernel"}
A_VARIANTS = {"as_built": []}
A_DESIGNS = {"resident_walk": ("nms_fused_variants.cu", "nms_keep_resident_walk_launch"),
             "one_block": ("nms_fused_variants.cu", "nms_keep_one_block_launch")}
F_VARIANTS = {"as_built": [], "ldg": [("__ldcs(", "__ldg(")],
              "expf": [("e[k] = exp2_approx(fmaf(v[k], kLog2e, -mb));", "e[k] = expf(v[k] - m);")],
              "loads2": [("  switch (vector_bytes(x, sizeof(T), stride_b, stride_a)) {",
                          "  switch (sizeof(T) == 2 ? 2 : vector_bytes(x, sizeof(T), stride_b, stride_a)) {")]}
F_DESIGNS = {"rows2": ("dfl_decode_variants.cu", "dfl_decode_rows2_launch"),
             "rows4": ("dfl_decode_variants.cu", "dfl_decode_rows4_launch"),
             "lanes16": ("dfl_decode_variants.cu", "dfl_decode_lanes16_launch")}
# the logits one thread of each F build decodes, and the name of its kernels
F_SASS = {"rows2": (16, "rows2_dfl_decode_kernel"), "rows4": (32, "rows4_dfl_decode_kernel"),
          "lanes16": (4, "lanes16_dfl_decode_kernel")}
C_DESIGNS = {"resident_walk": ("rotated_nms_variants.cu", "rotated_nms_resident_walk_launch"),
             "keep_walk": ("rotated_nms_variants.cu", "rotated_nms_keep_walk_launch"),
             "one_block": ("rotated_nms_variants.cu", "rotated_nms_one_block_launch")}
VARIANTS_DIR = Path(__file__).resolve().parent / "kernel_variants"
ENTRY = {"int8_conv": "int8_conv_launch", "attention_fused": "attn_qkv_launch", "mask_pack": "mask_pack_launch",
         "rotated_nms_fused": "rotated_nms_keep_launch", "greedy_nms": "greedy_nms_launch",
         "nms_fused": "nms_keep_launch", "dfl_decode": "dfl_decode_launch"}


def start_variant(name: str, tag: str, patches, out_dir: Path):
    """Start building csrc/<name>.cu with each (old, new) patch applied to it
    or to one of its headers, with the port's flags, into out_dir; returns
    (process, library path)."""
    files = {f"{name}.cu": (_build.CSRC_DIR / f"{name}.cu").read_text()}
    files.update({h.name: h.read_text() for h in _build.CSRC_DIR.glob("*.cuh")})
    for old, new in patches:
        hits = [f for f, text in files.items() if old in text]
        if len(hits) != 1:
            raise RuntimeError(f"{name}: patch target found in {hits}: {old[:60]!r}")
        files[hits[0]] = files[hits[0]].replace(old, new)
    src_dir = out_dir / f"{name}_{tag}"
    src_dir.mkdir()
    for fname, text in files.items():
        (src_dir / fname).write_text(text)
    lib = out_dir / f"lib{name}_{tag}.so"
    cmd = [_build._nvcc(), *_build._flags(name), "-o", str(lib), str(src_dir / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def start_design(name: str, source: str, out_dir: Path):
    """Start building tests/kernel_variants/<source> (which includes
    csrc/<name>.cu) with kernel <name>'s flags; returns (process, library path)."""
    lib = out_dir / f"lib{Path(source).stem}.so"
    cmd = [_build._nvcc(), *_build._flags(name), "-I", str(_build.CSRC_DIR), "-o", str(lib), str(VARIANTS_DIR / source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def launcher(lib, name: str, entry: str = ""):
    """A variant's entry point (the port's by default) with the argument
    types the port's wrapper sets."""
    fn = getattr(lib, entry or ENTRY[name])
    port = {"int8_conv": e_mod, "attention_fused": attn_mod, "mask_pack": d_mod,
            "rotated_nms_fused": c_mod, "greedy_nms": g_mod, "nms_fused": a_mod, "dfl_decode": f_mod}[name]._launcher()
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
    wanted = sys.argv[1:] or ["int8_conv", "attention_qkv", "mask_pack", "rotated_nms", "greedy_nms", "nms_keep",
                              "dfl_decode"]
    print(cs.card_line(), flush=True)
    sources = {"int8_conv": ("int8_conv", E_VARIANTS, {}), "attention_qkv": ("attention_fused", B_VARIANTS, {}),
               "mask_pack": ("mask_pack", D_VARIANTS, D_DESIGNS),
               "rotated_nms": ("rotated_nms_fused", C_VARIANTS, C_DESIGNS),
               "greedy_nms": ("greedy_nms", G_VARIANTS, G_DESIGNS),
               "nms_keep": ("nms_fused", A_VARIANTS, A_DESIGNS),
               "dfl_decode": ("dfl_decode", F_VARIANTS, F_DESIGNS)}
    with tempfile.TemporaryDirectory(prefix="kernel_breakdown_") as tmp:
        builds = {}  # every nvcc at once
        for name, variants, designs in (sources[k] for k in wanted):
            for tag, patches in variants.items():
                builds[name, tag] = start_variant(name, tag, patches, Path(tmp))
            for source in sorted({src for src, _ in designs.values()}):
                builds[name, source] = start_design(name, source, Path(tmp))
        libs, ptxas = {}, {}
        for key, (proc, lib) in builds.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"building {key} failed:\n{log}")
            libs[key] = ctypes.CDLL(str(lib))
            ptxas["/".join(key)] = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                                    if "registers" in ln or "entry function" in ln]
        cs.emit({"ptxas": ptxas})  # registers and spills of every kernel in every build
        for name, _, designs in (sources[k] for k in wanted):
            for tag, (source, entry) in designs.items():
                libs[name, tag] = (libs[name, source], entry)
        if "mask_pack" in wanted:
            mask_pack_breakdown(libs)
        if "rotated_nms" in wanted:
            rotated_nms_breakdown(libs)
        if "greedy_nms" in wanted:
            greedy_nms_breakdown(libs)
        if "nms_keep" in wanted:
            nms_keep_breakdown(libs)
        if "dfl_decode" in wanted:
            dfl_breakdown(libs, Path(tmp))
        if "int8_conv" in wanted:
            int8_conv_breakdown(libs)
        if "attention_qkv" in wanted:
            attention_breakdown(libs)
    return 0


def variant_launcher(libs, name: str, tag: str):
    lib = libs[name, tag]
    return launcher(lib[0], name, lib[1]) if isinstance(lib, tuple) else launcher(lib, name)


def segment_path_soft_masks():
    """D's input on chip_smoke.py's segment path (phase 10: yolo11n-seg bf16,
    b32/640, the phase-9 weights)."""
    import yolo_infer_tpu_torch.ops.masks as masks_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor

    calib = np.random.default_rng(cs.SEED + 6).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    model, spec = cs.smoke_weights(calib, "segment", cs.TASK_NC["segment"])
    batch, imgsz = cs.SEG_SERVE
    frames = np.random.default_rng(cs.SEED + 7).integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16, mask_mode="device")
    seen = {}
    restore = cs.capture_inputs(masks_mod, "upsample4x_threshold_pack", seen)
    try:
        pred.predict(frames, conf=0.25, imgsz=imgsz)
    finally:
        restore()
    return seen["upsample4x_threshold_pack"][0]


def mask_pack_breakdown(libs):
    dense = torch.rand((9600, 160, 160), generator=torch.Generator("cuda").manual_seed(cs.SEED), device="cuda")
    boxes = torch.zeros_like(dense)
    rng = np.random.default_rng(cs.SEED)
    for i in range(0, 9600, 10):
        y0, x0 = rng.integers(0, 100, 2)
        boxes[i, y0:y0 + 50, x0:x0 + 50] = 1
    port_d, failed = d_mod._launcher, []
    try:
        for case, soft in (("segment path", segment_path_soft_masks()), ("dense", dense), ("boxes", dense * boxes)):
            want = d_mod.upsample4x_threshold_pack_reference(soft)
            row = {"kernel": "upsample4x_threshold_pack", "case": case, "shape": list(soft.shape),
                   "skip_share": cs.d_skip_share(soft)}
            for tag in [*D_VARIANTS, *D_DESIGNS]:
                fn = variant_launcher(libs, "mask_pack", tag)
                d_mod._launcher = lambda fn=fn: fn
                if not torch.equal(d_mod.upsample4x_threshold_pack(soft), want):
                    failed.append(f"{tag} ({case})")
                row[tag + "_ms"] = float(np.median(cs.device_ms_each([lambda: d_mod.upsample4x_threshold_pack(soft)],
                                                                     iters=5)))
            cs.emit(row)
            del want
    finally:
        d_mod._launcher = port_d
    if failed:
        raise AssertionError(f"kernel D differs from its plain version: {failed}")


def obb_path_terms():
    """C's input on chip_smoke.py's OBB path (phase 11: yolo11n-obb bf16,
    b16/1024, the phase-9 weights)."""
    import yolo_infer_tpu_torch.ops.rotated as rot_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor

    calib = np.random.default_rng(cs.SEED + 6).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    model, spec = cs.smoke_weights(calib, "obb", cs.TASK_NC["obb"])
    batch, imgsz = cs.OBB_SERVE
    frames = np.random.default_rng(cs.SEED + 8).integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
    seen = {}
    restore = cs.capture_inputs(rot_mod, "rotated_nms_keep", seen)
    try:
        pred.predict(frames, conf=0.25, imgsz=imgsz)
    finally:
        restore()
    return seen["rotated_nms_keep"]


def rotated_nms_breakdown(libs):
    rng = np.random.default_rng(cs.SEED + 4)
    cases = [(f"K={k} random", *cs.random_rotated(rng, 16, k), 0.45) for k in (37, 160, 300, 1024)]
    gauss, _ = cs.random_rotated(rng, 16, 1024)
    cases += [("K=1024 all valid", gauss, torch.ones((16, 1024), dtype=torch.bool, device="cuda"), 0.45),
              ("obb path", *obb_path_terms())]
    port_c, failed = c_mod._launcher, []
    try:
        for case, gauss, valid, thr in cases:
            want = c_mod.rotated_nms_keep_reference(gauss, valid, thr)
            row = {"kernel": "rotated_nms_keep", "case": case, "shape": list(gauss.shape),
                   "valid": int(valid.sum())}
            for tag in [*C_VARIANTS, *C_DESIGNS]:
                fn = variant_launcher(libs, "rotated_nms_fused", tag)
                c_mod._launcher = lambda fn=fn: fn
                if not torch.equal(c_mod.rotated_nms_keep(gauss, valid, thr), want):
                    failed.append(f"{tag} ({case})")
                row[tag + "_ms"] = float(np.median(cs.device_ms_each([lambda: c_mod.rotated_nms_keep(gauss, valid, thr)],
                                                                     iters=10)))
            c_mod._launcher = port_c
            # the port's kernels alone (torch.profiler): no gap between the two launches
            row.update({"profiled_" + k: v for k, v in cs.c_time_split(gauss, valid, thr).items()})
            cs.emit(row)
    finally:
        c_mod._launcher = port_c
    if failed:
        raise AssertionError(f"kernel C differs from its plain version: {failed}")


def greedy_nms_breakdown(libs):
    """G (which launches the same walk as A and C) on chip_smoke.py's
    phase-13 inputs: IoU of random boxes at 0.6."""
    from yolo_infer_tpu_torch.ops.iou import box_iou_matrix

    rng = np.random.default_rng(cs.SEED + 10)
    port_g, failed = g_mod._launcher, []
    try:
        for b, k, case in ((16, 4096, "random"), (4, 1000, "random"), (2, 8192, "random"), (16, 4096, "prefix")):
            boxes, valid = (torch.from_numpy(a).cuda() for a in cs.random_candidates(rng, b, k))
            if case == "prefix":
                valid = torch.arange(k, device="cuda")[None] < torch.from_numpy(rng.integers(300, 3000, (b, 1))).cuda()
            iou = box_iou_matrix(boxes, boxes)
            want = torch.cat([g_mod.greedy_nms_keep_reference(iou[i:i + 1], valid[i:i + 1], 0.6) for i in range(b)])
            row = {"kernel": "greedy_nms_keep", "case": f"K={k} {case}", "shape": list(iou.shape),
                   "valid": int(valid.sum())}
            for tag in [*G_VARIANTS, *G_DESIGNS]:
                fn = variant_launcher(libs, "greedy_nms", tag)
                g_mod._launcher = lambda fn=fn: fn
                if not torch.equal(g_mod.greedy_nms_keep(iou, valid, 0.6), want) and not tag.startswith("diag_"):
                    failed.append(f"{tag} ({case}, K={k})")
                row[tag + "_ms"] = float(np.median(cs.device_ms_each([lambda: g_mod.greedy_nms_keep(iou, valid, 0.6)],
                                                                     iters=10)))
                split = cs.keep_time_split(lambda: g_mod.greedy_nms_keep(iou, valid, 0.6),
                                           G_BITS.get(tag, "suppression_bits_kernel"))
                row[tag + "_bits_ms"], row[tag + "_walk_ms"] = split["bits_ms"], split["walk_ms"]
            cs.emit(row)
            del iou, want
    finally:
        g_mod._launcher = port_g
    if failed:
        raise AssertionError(f"kernel G differs from its plain version: {failed}")


def detect_path_boxes():
    """A's input on chip_smoke.py's detect path (phase 5: yolo11n bf16,
    b32/640, the phase-4 weights)."""
    import yolo_infer_tpu_torch.ops.nms as nms_ops
    from yolo_infer_tpu_torch.core.predictor import Predictor

    calib = np.random.default_rng(cs.SEED + 2).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    model, spec = cs.smoke_weights(calib)
    frames = np.random.default_rng(cs.SEED + 3).integers(0, 256, (32, 640, 640, 3), dtype=np.uint8)
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
    seen = {}
    restore = cs.capture_inputs(nms_ops, "nms_keep", seen)
    try:
        pred.predict(frames, conf=0.25)
    finally:
        restore()
    return seen["nms_keep"]


def nms_keep_breakdown(libs):
    rng = np.random.default_rng(cs.SEED)
    cases = [(f"K={k} random", *(torch.from_numpy(a).cuda() for a in cs.random_candidates(rng, 32, k)), 0.45)
             for k in (160, 384, 1024)]
    cases.append(("detect path", *detect_path_boxes()))
    port_a, failed = a_mod._launcher, []
    try:
        for case, boxes, valid, thr in cases:
            want = a_mod.nms_keep_reference(boxes, valid, thr)
            row = {"kernel": "nms_keep", "case": case, "shape": list(boxes.shape), "valid": int(valid.sum())}
            for tag in [*A_VARIANTS, *A_DESIGNS]:
                fn = variant_launcher(libs, "nms_fused", tag)
                a_mod._launcher = lambda fn=fn: fn
                if not torch.equal(a_mod.nms_keep(boxes, valid, thr), want):
                    failed.append(f"{tag} ({case})")
                row[tag + "_ms"] = float(np.median(cs.device_ms_each([lambda: a_mod.nms_keep(boxes, valid, thr)],
                                                                     iters=10)))
            a_mod._launcher = port_a
            # the port's kernels alone (torch.profiler): no gap between the two launches
            row.update({"profiled_" + k: v for k, v in cs.a_time_split(boxes, valid, thr).items()})
            cs.emit(row)
    finally:
        a_mod._launcher = port_a
    if failed:
        raise AssertionError(f"kernel A differs from its plain version: {failed}")


def dfl_path_inputs():
    """F's inputs on chip_smoke.py's validation path (phase 15: yolo11n detect
    bf16 at b16/640, multi-label, pre_topk 4096: the (16, 8400, 64) slice of
    the 144-channel head slab) and OBB path (phase 11: yolo11n-obb bf16 at
    b16/1024: the (16, 21504, 64) slice of the 79-channel slab), as captured
    views of the slabs (strides kept)."""
    import yolo_infer_tpu_torch.ops.decode as decode_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor

    calib = np.random.default_rng(cs.SEED + 6).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    out = {}
    for case, task, (batch, imgsz), kw in (
            ("val path", "detect", (cs.VAL["batch"], cs.VAL["imgsz"]), dict(multi_label=True, pre_topk=cs.VAL["pre_topk"])),
            ("obb path", "obb", cs.OBB_SERVE, {})):
        model, spec = cs.smoke_weights(calib, task, cs.TASK_NC.get(task, 80))
        pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
        frames = torch.from_numpy(np.random.default_rng(cs.SEED + 8).integers(
            0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)).cuda()
        seen = {}
        restore = cs.capture_inputs(decode_mod, "dfl_decode", seen, clone=False)
        try:
            pred.predict_raw(frames, cs.VAL["conf"], cs.VAL["iou"], imgsz, 300, **kw)
        finally:
            restore()
        out[case] = seen["dfl_decode"][0]
    return out


def l2_cold_read(call):
    """`call` preceded by a read of L2_FLUSH_BYTES (an `amax`), so it finds
    its inputs in HBM and L2 full of clean lines; chip_smoke.py's `l2_cold`
    writes them, and leaves dirty lines that the call's reads must write back
    to HBM first."""
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda").amax

    def run():
        flush()
        return call()
    return run


def dfl_breakdown(libs, tmp: Path):
    """F at its two paths' inputs, for the port's kernel, its variants and
    the other designs: device time warm, cold (`chip_smoke.l2_cold`, a write
    flush) and cold after a read flush (`l2_cold_read`), each profiled over 20
    calls, in two rounds; the SASS instructions per logit of each build's
    kernels."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = {}
    for tag in [*F_VARIANTS, *F_DESIGNS]:
        # a design's library also holds the port's kernels: its own are named apart
        per_thread, marker = F_SASS.get(tag, (cs.DFL_LOGITS_PER_THREAD, "dfl_decode_kernel"))
        path = tmp / (f"lib{Path(F_DESIGNS[tag][0]).stem}.so" if tag in F_DESIGNS else f"libdfl_decode_{tag}.so")
        counts = cs.sass_instructions(cs.sass_text(path, cuobjdump), marker)
        sass[tag] = {"logits_per_thread": per_thread,
                     "kernels": {k: {"instructions": n, "per_logit": n / per_thread} for k, n in counts.items()}}
    cs.emit({"kernel": "dfl_decode", "sass": sass})
    port_f, failed = f_mod._launcher, []
    try:
        inputs = dfl_path_inputs()
        inputs["val path, contiguous copy"] = inputs["val path"].contiguous()
        for case, x in inputs.items():
            want = f_mod.dfl_decode_reference(x)
            b, a, c = x.shape
            row = {"kernel": "dfl_decode", "case": case, "shape": [b, a, c], "strides": list(x.stride()),
                   "dtype": str(x.dtype), "bound_ms": 1e3 * (b * a * (c * x.element_size() + 16)) / cs.H100_BYTES_PER_S}
            tags = [*F_VARIANTS, *F_DESIGNS]
            for turn, order in enumerate((tags, tags[::-1])):  # two rounds, in turns
                for tag in order:
                    fn = variant_launcher(libs, "dfl_decode", tag)
                    f_mod._launcher = lambda fn=fn: fn
                    err = float((f_mod.dfl_decode(x) - want).abs().max())
                    if not err <= cs.DFL_TOL:
                        failed.append(f"{tag} ({case}): {err}")
                    row[tag + "_max_abs_err"] = err
                    call = lambda: f_mod.dfl_decode(x)  # noqa: E731
                    for clock, wrap in (("warm", lambda f: f), ("cold", cs.l2_cold), ("cold_read", l2_cold_read)):
                        named = cs.kernel_profile(wrap(call), calls=20, named=("dfl_decode_kernel",))["named"]
                        row.setdefault(f"{tag}_{clock}_ms", []).append(named["dfl_decode_kernel"]["ms"])
            cs.emit(row)
    finally:
        f_mod._launcher = port_f
    if failed:
        raise AssertionError(f"kernel F differs from its plain version: {failed}")


def int8_conv_breakdown(libs):
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


def attention_breakdown(libs):
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

if __name__ == "__main__":
    sys.exit(main())
