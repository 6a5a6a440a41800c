"""Where kernels B, C, D, E and G spend their time on the card: the breakdown PERF.md cites.

Run from the repository root on a machine with an NVIDIA card (no jax
needed): `python tests/torch_kernel_breakdown.py [int8_conv] [attention_qkv]
[mask_pack] [rotated_nms] [greedy_nms]` (all five by default), a few
minutes. It compiles variants of the port's kernels, from patched copies of
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
                 pass, then the resident walk); with the strip-staged walk;
                 each of those with the walk's decisions as branches and
                 its row ORs as a loop over the kept rows (the walk as it
                 was before it went branch-free); with greedy_keep_walk
                 over the resident mask; the one-block-per-image kernel that
                 C replaced. CUDA events time each call; the kernels as
                 built are also profiled alone (`profiled_*`: the bits pass
                 and the walk)
  greedy_nms     G at chip_smoke.py's random (16, 4096) and (4, 1000)
                 inputs: as built, and with the branching walk

Device times are CUDA events around each call, the calls queued behind a
sleep (`chip_smoke.device_ms_each`). E's and B's variants compute wrong
values on purpose; C's, D's and G's variants are exact designs, and every
one is held to its plain version before it is timed.
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
from yolo_infer_tpu_torch.ops.kernels import greedy_nms as g_mod  # noqa: E402
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
# the walk's two loops as they were before they went branch-free: a branch
# per decision, and a loop over the kept rows only for the row ORs
C_BRANCHY = [("    const uint32_t take = 0u - ((vbits & ~cur) >> t & 1u);  // all ones when candidate i0+t is kept\n"
              "    kept_bits |= take & (1u << t);\n    cur |= diag[t] & take;\n",
              "    if ((vbits & ~cur) >> t & 1u) {\n      kept_bits |= 1u << t;\n      cur |= diag[t];\n    }\n"),
             ("#pragma unroll\n  for (int t = 0; t < 32; ++t) {\n    const uint32_t take = 0u - (kept_bits >> t & 1u);\n",
              "  for (int t = 0; t < n; ++t) {\n    if (!(kept_bits >> t & 1u)) continue;  // the same in every lane\n"),
             ("      if (g < wpl && c >= w && c < We) removed[g] |= row[c] & take;",
              "      if (g < wpl && c >= w && c < We) removed[g] |= row[c];")]
C_STRIP = ("  const bool resident = K <= kNmsMaxK;", "  const bool resident = false;")
C_VARIANTS = {"as_built": [], "strip_walk": [C_STRIP], "branchy": C_BRANCHY, "strip_walk_branchy": [C_STRIP, *C_BRANCHY]}
G_VARIANTS = {"as_built": [], "branchy": C_BRANCHY}
C_DESIGNS = {"keep_walk": ("rotated_nms_variants.cu", "rotated_nms_keep_walk_launch"),
             "one_block": ("rotated_nms_variants.cu", "rotated_nms_one_block_launch")}
VARIANTS_DIR = Path(__file__).resolve().parent / "kernel_variants"
ENTRY = {"int8_conv": "int8_conv_launch", "attention_fused": "attn_qkv_launch", "mask_pack": "mask_pack_launch",
         "rotated_nms_fused": "rotated_nms_keep_launch", "greedy_nms": "greedy_nms_launch"}


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
            "rotated_nms_fused": c_mod, "greedy_nms": g_mod}[name]._launcher()
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
    wanted = sys.argv[1:] or ["int8_conv", "attention_qkv", "mask_pack", "rotated_nms", "greedy_nms"]
    print(cs.card_line(), flush=True)
    sources = {"int8_conv": ("int8_conv", E_VARIANTS, {}), "attention_qkv": ("attention_fused", B_VARIANTS, {}),
               "mask_pack": ("mask_pack", D_VARIANTS, D_DESIGNS),
               "rotated_nms": ("rotated_nms_fused", C_VARIANTS, C_DESIGNS),
               "greedy_nms": ("greedy_nms", G_VARIANTS, {})}
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
    """G (which launches the same walk as C) on chip_smoke.py's phase-13
    random inputs: IoU of (16, 4096) and (4, 1000) random boxes, 0.6."""
    from yolo_infer_tpu_torch.ops.iou import box_iou_matrix

    rng = np.random.default_rng(cs.SEED + 10)
    port_g, failed = g_mod._launcher, []
    try:
        for b, k in ((16, 4096), (4, 1000)):
            boxes, valid = (torch.from_numpy(a).cuda() for a in cs.random_candidates(rng, b, k))
            iou = box_iou_matrix(boxes, boxes)
            want = g_mod.greedy_nms_keep_reference(iou, valid, 0.6)
            row = {"kernel": "greedy_nms_keep", "case": f"K={k} random", "shape": list(iou.shape),
                   "valid": int(valid.sum())}
            for tag in G_VARIANTS:
                fn = variant_launcher(libs, "greedy_nms", tag)
                g_mod._launcher = lambda fn=fn: fn
                if not torch.equal(g_mod.greedy_nms_keep(iou, valid, 0.6), want):
                    failed.append(f"{tag} (K={k})")
                row[tag + "_ms"] = float(np.median(cs.device_ms_each([lambda: g_mod.greedy_nms_keep(iou, valid, 0.6)],
                                                                     iters=10)))
            cs.emit(row)
    finally:
        g_mod._launcher = port_g
    if failed:
        raise AssertionError(f"kernel G differs from its plain version: {failed}")


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
