#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one CUDA card and check them.

Run from the repository root with no arguments: `python3 chip_smoke.py`.
It imports only `torch`, numpy and `yolo_infer_tpu_torch`, builds the port's
CUDA kernels from `yolo_infer_tpu_torch/csrc/` with nvcc (in parallel), and
runs twenty phases, each printing one JSON line:

  1. card    nvidia-smi name and power limit, kernel build times, ptxas info
             and each library's tensor-core instructions in its SASS
             (`cuobjdump -sass`: HMMA, IMMA); B's library must hold HMMA and
             E's IMMA
  2. nms     kernel A (`nms_keep`) vs its plain version on the card: B=32 random
             candidates at K=384 and K=1024 and the 3-box suppression chain,
             keep masks equal bit for bit
  3. attn    kernel B (`attention_qkv`) vs its plain version on the card: bf16
             (32, 400, 256) heads=2, (32, 400, 512) heads=4, (16, 1024, 256)
             heads=2 (the OBB shape) and (2, 37, 256) (a ragged key tile)
             within atol = rtol = 2e-2, f32 (32, 400, 256) and (2, 37, 256)
             within atol 1e-5, and a streamed-K/V case at N=1600 (1280 px)
  4. fp32    yolo11n fp32 `Predictor.predict` on two 480x640 frames at 640 px,
             on cuda and on cpu (TF32 off): equal num and classes, boxes within
             1e-2 px, scores within 1e-5; both launch counters rise
  5. bf16    the main path: yolo11n bf16 `Predictor.predict` at batch 32 on
             640x640 frames, once with the launch counters reset (they must
             each read >= 1), then timed: 20 calls end to end (host clock,
             median img/s) and the device part alone (CUDA events, frames
             already on the card); per-kernel device times (torch.profiler)
             at the shapes that run gave each kernel, beside the plain
             version's and, for B, `F.scaled_dot_product_attention`'s (a
             yardstick only); `*call_ms` are the same calls timed back to
             back with CUDA events, host launch overhead included
  6. profile device time by kernel and by copy over three main-path
             predicts, and the kernels' busy share of the wall time
             (torch.profiler; the run is slower than the untraced one)
  7. rnms    kernel C (`rotated_nms_keep`) vs its plain version on the card:
             B=16 random oriented candidates at K=1024, 37, 160, 2048, 4096
             and 8192 (15% invalid) and at K=4096 with a valid prefix of
             300..1500, keep masks equal bit for bit; device time of each
             split into the probIoU bits pass and the walk (resident in
             shared memory up to K=1024, strip-staged above); the 3-box
             suppression chain; K=8193 raises
  8. mpack   kernel D (`upsample4x_threshold_pack`) vs its plain version on
             the card, packed bytes equal bit for bit: random (300, 160, 160),
             (37, 24, 40), (5, 17, 8) and (2, 6, 4096) soft masks (a band cut
             short, one word per row, a wide row), a dense uniform
             (9600, 160, 160)
             (timed beside its bound), and 0.5, nextafter(0.5, 1), -inf,
             +inf, NaN and negatives over zeros with all-zero instances;
             each case's share of zero-skipped steps
  9. tasks_fp32  yolo11n segment, obb (nc 15), pose and classify fp32
             `Predictor.predict` on two frames of different sizes (the host
             letterbox) at 640 px, on cuda and on cpu (TF32 off), on weights
             calibrated as in phase 4 (segment: mask logits at unit spread
             too): equal counts, detections paired as sets (same class), the
             pairs' boxes, obb and keypoints within 5e-2 px and scores within
             1e-4, mask pixels differing at most 1e-4, probs within 1e-5;
             each task's kernel counters rise; OBB again at pre_topk 2048
             (kernel C at K=2048)
 10. seg_bf16  the segment path: yolo11n-seg bf16 `predict` at batch 32 on
             640x640 frames, mask_mode "device": one call with the counters
             reset (A, B and D must each read >= 1), 20 timed calls and the
             device part as in phase 5, kernel D at the captured input
             (bit-equal to its plain version; times beside its bound, and
             the share of its steps that take the zero skip), and
             the device time by kernel over three predicts
 11. obb_bf16  the OBB path: yolo11n-obb (nc 15) bf16 `predict` at batch 16
             on 1024x1024 frames (the OBB models' input size): counters B,
             C and F >= 1 (OBB's full-grid decode runs F), timings as in
             phase 10, kernel C at the captured K=1024 input (bits pass and
             walk timed apart), and kernel B at
             its captured N=1024 input beside its bound, its plain version and
             `F.scaled_dot_product_attention`
 12. dfl     kernel F (`dfl_decode`) vs its plain version on the card:
             random (16, 8400, 64) f32 and bf16 logits, contiguous and as
             the strided slice of a (16, 8400, 144) head slab, within 1e-5
 13. gnms    kernel G (`greedy_nms_keep`) vs its plain version on the card,
             bit-equal: random sorted candidates' IoU at (16, 4096), K = 1000
             and 37 (not multiples of 32), an all-invalid image, and a
             4096-box suppression chain (each box overlaps the next)
 14. val_fp32  `YOLO11Validator.validate` of yolo11n detect and pose (fp32,
             640 px, the val defaults: batch 16, conf 0.001, iou 0.6,
             multi-label, pre_topk 4096) on cuda and on cpu over seeded PNG
             datasets of 24 frames of two sizes written with `save_image`
             and labelled with the cpu predictions at conf 0.25: mAP50-95,
             mAP50 and pose mAP within 1e-3, and each batch's detections
             with score >= 0.25 paired as sets (boxes within PX_TOL, scores
             within SCORE_TOL, keypoints within KPT_TOL); counters F and G
             rise
 15. val_bf16  the validation path: yolo11n detect bf16 validation at 640
             px, batch 16, conf 0.001, iou 0.6, pre_topk 4096 over 64
             frames, run twice (counters reset before the first; F and G
             must each read >= 1), the second timed: images/s and
             inference_ms_per_image from the validator, peak device
             memory, kernels F and G and the plain IoU build in front of G
             at the captured inputs (F within 1e-5, G bit-equal; device
             times beside their bounds), and the device time by kernel over
             three batches
 16. q8_fp32  yolo11s detect static8 (PTQ on the cpu, f32 compute) `predict`
             on two 480x640 frames at 640 px on cuda and on cpu (TF32 off):
             kernel E's counter rises, and at least Q8_PAIRED of the
             detections scoring >= 0.35 on either device have a partner on
             the other (same class, IoU >= 0.5, score within 0.1); the
             pairs' box and score errors are printed
 17. q8_bf16  the static8 path: yolo11s PTQ through `create_quantizer` on
             the card, then static8 `predict` at batch 32 on 640x640 frames,
             once with the counters reset (E must read 48, A and B >= 1) and
             every E input captured (channel chunks keep their pixel pitch),
             then timed beside the bf16 yolo11s on the same frames and
             weights; E at each of its 48 inputs (bit-equal to its plain
             version; per-launch and summed device times beside their
             bounds), the device time by kernel, the copy kernels with the
             chunks read in place against the same path with every E input
             copied to a contiguous NHWC tensor first, and the
             fidelity gate: both models validated (single-label, iou 0.45)
             on the frames labelled by the bf16 model's detections at conf
             0.25; static8 mAP50 >= 0.9
 18. int8     kernel E (`int8_conv`) vs its plain version on the card at
             random int8 inputs for each (k, stride) in {1, 3} x {1, 2} and
             both epilogues: contiguous (32, 20, 20, 256) -> 128 and (3, 13,
             11, 130) -> 70, the channel chunk of the first 128 of 256
             channels (pixel pitch 256) -> 128, and (2, 9, 9, 512) -> 64 of
             large positive codes (int32 sums of up to ~6e7, which round on
             their way to f32); bit-equal (any ±1-code count printed)
 19. attn_packed  kernel H (`attention_packed`) vs its plain version on the
             card: bf16 (64, 400, 128) within 2e-2, f32 within 1e-5, bf16 at
             N=1600; and H on a head-major copy vs B on the same slab
 20. attn_pallas  the `YOLO_ATTN_IMPL=pallas` route: yolo11n bf16 `predict`
             at batch 32 on 640x640 frames with the counters reset (H >= 1,
             B 0), Results equal to the default route's, timed as in phase
             5, and H at its captured input beside its bound

Then it prints the card's name and power limit, the per-kernel JSON line (A
and B measured on the detect path, C on the OBB path, D on the segment path,
F and G on the validation path, E on the static8 path, H on the pallas
route) and, last, {"ok": true, "device": {...}}.
Any failed phase exits non-zero without that last line; so does a host
without CUDA or a directory without the port.
"""

from __future__ import annotations

import copy
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

SEED = 0
H100_BYTES_PER_S = 3.35e12  # HBM3, SXM part (NVIDIA data sheet)
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, an FMA counted as two operations
# the same units without FMA: one f32 operation per lane and cycle. Kernels
# A, C and D are built with --fmad=false (each product and sum rounds apart,
# as the plain versions'), so their operation bounds divide by this rate
H100_F32_OPS_UNFUSED = H100_F32_FLOPS / 2
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores
H100_INT8_OPS = 1979e12  # dense int8 tensor cores
IOU_OPS = 14  # f32 operations for one IoU and its compare (ops/iou.py order)
# f32 operations for one probIoU and its compare (ops/rotated.py order): 9
# additions or subtractions, 12 products, 2 divisions, 2 square roots, one
# log, one exp, a negation, 4 clamp sides, one compare (ops per pair; each
# candidate's clamped determinant adds 4 ops per candidate)
PROBIOU_OPS = 38
# kernel D per output pixel: the W tap (2 products, 1 sum) and the compare;
# per upsampled row and source column: the H tap (2 products, 1 sum)
PACK_OPS_PER_PIXEL = 4
PACK_OPS_PER_HTAP = 3
# cuda vs cpu in f32 (phase 9): sums taken in another order through the 24
# layers move head outputs by ~1e-5 of their size; coordinates reach the
# frame's 640 px (keypoint offsets are also scaled by the stride, 32) and a
# logit of a few units moves its sigmoid by up to ~2e-5
PX_TOL = 5e-2
SCORE_TOL = 1e-4
# val_fp32 keypoints: a keypoint is (offset * 2 + anchor) * stride, so the
# head's cuda-vs-cpu difference reaches it 64x at stride 32, and the
# validation keeps ~9k pairs at score >= 0.25 (serving: ~600): 0.058 px seen
KPT_TOL = 0.1
SEG_SERVE = (32, 640)  # segment path: batch, imgsz
OBB_SERVE = (16, 1024)  # OBB path: batch, imgsz (the OBB models' input size)
# kernel F per logit: max, subtraction, exp, product and two sums; per side
# one division (exp counted as one operation)
DFL_OPS_PER_LOGIT = 6
VAL = dict(imgsz=640, batch=16, conf=0.001, iou=0.6, pre_topk=4096)  # the validator's defaults
VAL_FP32_FRAMES = 24
VAL_BF16_FRAMES = 64
Q8_SERVE = (32, 640)  # static8 path: yolo11s, batch, imgsz
ATTN_SERVE = (32, 640)  # YOLO_ATTN_IMPL=pallas route: yolo11n, batch, imgsz
Q8_E_LAUNCHES = 48  # static8 convs of yolo11s at b32/640 under the default eligibility
# q8_fp32: E equals its plain version, but a float op that rounds differently
# on the two devices (a bf16 exempted conv, an exp) moves an int8 code at a
# rounding edge, and each moved code is a whole quantization step at the next
# conv's input: the moved codes multiply layer by layer up to the int8 noise
# floor (~1% of the head maps, as between the port and the JAX package on the
# CPU), which reorders near-equal candidates in NMS. So the two devices are
# held as two int8 implementations are: detections paired by IoU and score,
# a share of them (the first run on the H100: 269 of 594 detections missed a
# partner within 1 px and 1e-2)
Q8_PAIRED = 0.9
Q8_CLS_SHARE = 2e-4  # (anchor, class) pairs scoring above 0.25 on the calibration frames
# B and H in bf16 against their plain versions: atol = rtol = 2e-2, as
# torch.testing.assert_close reads them (one bf16 ulp of an output in [4, 8)
# is 0.03125: the tensor cores sum p.v in another order than the plain f32
# product, so an output near a rounding edge may round the other way)
ATTN_BF16_TOL = 2e-2


def attn_tol_excess(got, want) -> float:
    """max(|got - want| - (atol + rtol * |want|)) at ATTN_BF16_TOL: <= 0 when within it."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - ATTN_BF16_TOL * (1 + w.abs())).max())


def bound(bytes_: float, ops: float, ops_per_s: float):
    """The least time for the work, in ms: the larger of the bytes over the
    memory rate and the operations over `ops_per_s`, and which of them it is."""
    by_bytes, by_ops = bytes_ / H100_BYTES_PER_S, ops / ops_per_s
    return {"bound_ms": 1e3 * max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of the kernels one call of `fn` launches (torch.profiler),
    without the host's launch overhead between calls; copies excluded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then hands back no device events: trace again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.key.startswith(("Memcpy", "Memset")) and e.key != "Activity Buffer Request")
        if total_us > 0:
            return total_us / 1e3 / iters
    raise AssertionError("torch.profiler recorded no device time in three traces")


def device_ms_each(fns, iters: int = 3):
    """Device time of each call in `fns` (median of `iters` rounds), by CUDA
    events around each call. Every launch is queued behind a sleep on the
    stream first, so the calls run back to back on the card and the host's
    launch overhead stays outside each event pair."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    marks = [[(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in fns]
             for _ in range(iters)]
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s of card cycles, longer than queueing the calls below
    t0 = time.perf_counter()
    for row in marks:
        for fn, (start, end) in zip(fns, row):
            start.record()
            fn()
            end.record()
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if queued_s > 0.4:
        raise AssertionError(f"queueing the timed calls took {queued_s:.3f} s, longer than the sleep ahead of them")
    ms = np.array([[start.elapsed_time(end) for start, end in row] for row in marks])
    return [float(v) for v in np.median(ms, axis=0)]


def random_candidates(rng, b: int, k: int):
    """Score-sorted random boxes in a 640 px frame, as in the JAX kernel tests."""
    cxy = rng.uniform(50, 590, (b, k, 2))
    wh = rng.uniform(10, 120, (b, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    scores = -np.sort(-rng.uniform(0, 1, (b, k)).astype(np.float32), axis=1)
    return boxes, scores > 0.15


def smoke_weights(frames_u8: np.ndarray, task: str = "detect", nc: int = 80, size: str = "n",
                  calibrate_bn: bool = True):
    """Weights of yolo11`size` `task` for the device comparisons.

    The seeded init (`build_model`) with the class-head biases at 0, and each
    batch norm's statistics set to those of its conv's output on `frames_u8`.
    The plain init's activations fade through the graph (class logits near
    1e-4, so scores tie at f32 resolution and any rounding reorders them);
    with the statistics calibrated, every layer feeds the next at unit scale
    and the logits spread over O(1). For segment the mask-coefficient convs
    are then scaled so the mask logits (prototypes x coefficients) spread at
    unit standard deviation too: mask pixels sit at sigmoid 0.5 only rarely.

    With `calibrate_bn=False` (the int8 phases) the batch norms keep the
    seeded init instead: its activations fade, so the rounding that each
    int8 conv adds does not grow with depth (at unit-scale statistics a
    random net carries it on to the head: 15-54% mean head error against
    f32, `tests/torch_int8_drift.py`). The detect head's box and class projections are then
    rescaled so their logits spread at standard deviation 2, and the class
    bias set so that Q8_CLS_SHARE of (anchor, class) pairs score above 0.25
    on `frames_u8`.
    """
    import torch

    from yolo_infer_tpu_torch.models.blocks import Conv, Detect
    from yolo_infer_tpu_torch.models.yolo11 import build_model
    from yolo_infer_tpu_torch.ops.preprocess import preprocess_batch

    model, spec = build_model(task, size, nc=nc, seed=SEED)
    head = model.model[-1]
    x = preprocess_batch(torch.from_numpy(frames_u8), (640, 640))
    hooks = []
    with torch.no_grad():
        if not calibrate_bn:
            for branch in list(head.cv2) + list(head.cv3):
                branch[-1].bias.zero_()
            feats = torch.cat([f.reshape(-1, f.shape[-1]) for f in model(x)["feats"]])
            box, cls = feats[:, :4 * spec.reg_max], feats[:, 4 * spec.reg_max:]
            for branch in head.cv2:
                branch[-1].weight.mul_(2.0 / box.std())
            for branch in head.cv3:
                branch[-1].weight.mul_(2.0 / cls.std())
                branch[-1].bias.fill_(float(np.log(1 / 3) - np.quantile((cls * (2.0 / cls.std())).numpy(),
                                                                        1 - Q8_CLS_SHARE)))
            return model, spec
        if isinstance(head, Detect):
            for branch in head.cv3:
                branch[-1].bias.zero_()
        for m in model.modules():
            if isinstance(m, Conv):
                def calibrate(conv, inp, out, bn=m.bn):
                    bn.running_mean.copy_(out.mean((0, 2, 3)))
                    bn.running_var.copy_(out.var((0, 2, 3)))
                hooks.append(m.conv.register_forward_hook(calibrate))
        out = model(x)
        for h in hooks:
            h.remove()
        if task == "segment":
            b = x.shape[0]
            mc = torch.cat([m.reshape(b, -1, m.shape[-1]) for m in out["mc"]], 1)
            pick = torch.from_numpy(np.random.default_rng(SEED).choice(mc.shape[1], 256, replace=False))
            spread = torch.bmm(out["proto"].reshape(b, -1, mc.shape[-1]), mc[:, pick].transpose(1, 2)).std()
            for branch in head.cv4:
                branch[-1].weight.div_(spread)
                branch[-1].bias.div_(spread)
    return model, spec


def match_detections(a, b, box_tol: float, score_tol: float):
    """Pair the detections of `a` with partners in `b` (same class, box and
    score within tolerance; equal scores may come out in either order).
    Returns (number of `a` detections with no partner, [(i, j), ...])."""
    used = np.zeros(len(b), bool)
    missing, pairs = 0, []
    for i in range(len(a)):
        hit = np.nonzero(~used & (b.classes == a.classes[i])
                         & (np.abs(b.boxes - a.boxes[i]).max(axis=1) <= box_tol)
                         & (np.abs(b.scores - a.scores[i]) <= score_tol))[0]
        if len(hit):
            used[hit[0]] = True
            pairs.append((i, int(hit[0])))
        else:
            missing += 1
    return missing, pairs


def counters():
    """The eight kernel wrappers, by name (their `launches` attributes are the counts)."""
    from yolo_infer_tpu_torch.ops.kernels import (
        attention_fused,
        dfl_decode,
        greedy_nms,
        int8_conv,
        mask_pack,
        nms_fused,
        rotated_nms_fused,
    )

    return {"nms_keep": nms_fused.nms_keep, "attention_qkv": attention_fused.attention_qkv,
            "rotated_nms_keep": rotated_nms_fused.rotated_nms_keep,
            "upsample4x_threshold_pack": mask_pack.upsample4x_threshold_pack,
            "dfl_decode": dfl_decode.dfl_decode, "greedy_nms_keep": greedy_nms.greedy_nms_keep,
            "int8_conv": int8_conv.int8_conv, "attention_packed": attention_fused.attention_packed}


def reset_counters() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in counters().items()}


def kernel_profile(fn, calls: int = 3, named=()):
    """Device time by kernel and by copy over `calls` calls of `fn`
    (torch.profiler), and the kernels' busy share of the wall time; for each
    substring in `named`, the summed time and launches per call of the
    kernels whose names hold it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then hands back no device events: trace again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / calls
        # device-side events only (CPU ops also carry their kernels' time); the
        # profiler's own buffer requests are not the program's work
        rows = [(e.key, e.self_device_time_total / 1e3 / calls, e.count // calls) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                and e.key != "Activity Buffer Request"]
        if all(any(sub in k for k, _, _ in rows) for sub in named) and rows:
            break
    else:
        raise AssertionError(f"torch.profiler missed the kernels {list(named)} in three traces")
    rows.sort(key=lambda r: -r[1])
    copy_ms = sum(ms for k, ms, _ in rows if k.startswith(("Memcpy", "Memset")))
    kernel_ms = sum(ms for k, ms, _ in rows if not k.startswith(("Memcpy", "Memset")))
    out = {"wall_ms_per_predict": wall_ms, "kernel_ms_per_predict": kernel_ms,
           "copy_ms_per_predict": copy_ms, "kernel_busy_share": kernel_ms / wall_ms,
           "top": [{"name": k[:100], "ms": ms, "calls": n} for k, ms, n in rows[:15]]}
    if named:
        out["named"] = {sub: {"ms": sum(ms for k, ms, _ in rows if sub in k),
                              "calls": sum(n for k, _, n in rows if sub in k)} for sub in named}
    return out


def timed_serving(pred, frames, imgsz: int):
    """20 end-to-end `predict` calls (numpy frames in, Results out; host
    clock) and the device part alone (frames already on the card, dets left
    there; CUDA events)."""
    import torch

    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict(frames, conf=0.25, imgsz=imgsz)
        times.append(time.perf_counter() - t0)
    times.sort()
    frames_dev = torch.from_numpy(frames).cuda()
    device = cuda_ms(lambda: pred.predict_raw(frames_dev, 0.25, 0.45, imgsz, 300), iters=20)
    median = times[len(times) // 2]
    b = frames.shape[0]
    return {"batch": int(b), "imgsz": imgsz, "calls": len(times), "img_per_s": b / median,
            "ms_per_batch_median": 1e3 * median, "ms_per_batch_min": 1e3 * times[0],
            "ms_per_batch_max": 1e3 * times[-1], "device_ms_per_batch": device,
            "device_img_per_s": 1e3 * b / device}


# the tensor-core instruction each redesigned library must hold in its SASS
TENSOR_CORE_SASS = {"attention_fused": "HMMA", "int8_conv": "IMMA"}


def sass_counts(path: Path, cuobjdump: Path):
    """Tensor-core instructions (HMMA, IMMA) in a built library's SASS."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True, timeout=120,
                          check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HMMA", "IMMA")}


def phase_card(report):
    from yolo_infer_tpu_torch.ops.kernels import _build

    line = card_line()
    t0 = time.perf_counter()
    built = _build.build(list(_build.KERNELS))
    report["card"] = line
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = {name: sass_counts(_build.library_path(name), cuobjdump) for name in _build.KERNELS}
    out = {"phase": "card", "card": line, "build_s": time.perf_counter() - t0, "kernels": built, "sass": sass}
    missing = {name: op for name, op in TENSOR_CORE_SASS.items() if sass[name][op] < 1}
    if missing:
        emit(out)
        raise AssertionError(f"no tensor-core instructions in {missing}")
    return out


def phase_nms(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.nms_fused import nms_keep, nms_keep_reference

    rng = np.random.default_rng(SEED)
    out = {"phase": "nms", "cases": []}
    for k in (384, 1024):
        boxes, valid = random_candidates(rng, 32, k)
        bx, va = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
        got = nms_keep(bx, va, 0.45)
        want_dev = nms_keep_reference(bx, va, 0.45)
        want_cpu = nms_keep_reference(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45)
        torch.cuda.synchronize()
        ok = torch.equal(got, want_dev) and torch.equal(got.cpu(), want_cpu)
        out["cases"].append({"K": k, "B": 32, "kept": int(got.sum()), "equal": ok})
        if not ok:
            raise AssertionError(f"keep mask differs at K={k}: {int((got != want_dev).sum())} entries")
    chain = torch.tensor([[[0, 0, 100, 100], [40, 0, 140, 100], [80, 0, 180, 100], [500, 500, 510, 510]]],
                         dtype=torch.float32, device="cuda")
    kept = nms_keep(chain, torch.tensor([[True, True, True, False]], device="cuda"), 0.3)
    if kept.cpu().tolist() != [[True, False, True, False]]:
        raise AssertionError(f"suppression chain: {kept.cpu().tolist()}")
    out["cases"].append({"chain": True, "equal": True})
    return out


def phase_attn(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.attention_fused import attention_qkv, attention_qkv_reference

    rng = np.random.default_rng(SEED + 1)
    out = {"phase": "attn", "cases": []}
    cases = [(32, 400, 2, torch.bfloat16, 2e-2, 2e-2), (32, 400, 4, torch.bfloat16, 2e-2, 2e-2),
             (16, 1024, 2, torch.bfloat16, 2e-2, 2e-2), (2, 37, 2, torch.bfloat16, 2e-2, 2e-2),
             (32, 400, 2, torch.float32, 1e-5, 0.0), (2, 37, 2, torch.float32, 1e-5, 0.0),
             (4, 1600, 2, torch.bfloat16, 2e-2, 2e-2)]
    for b, n, heads, dtype, atol, rtol in cases:
        qkv = torch.from_numpy(rng.standard_normal((b, n, heads * 128)).astype(np.float32)).to("cuda", dtype)
        got = attention_qkv(qkv, heads, 32, 64)
        want = attention_qkv_reference(qkv, heads, 32, 64)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        out["cases"].append({"B": b, "N": n, "heads": heads, "dtype": str(dtype), "max_abs_err": err})
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    return out


def phase_fp32(report):
    import torch

    import yolo_infer_tpu_torch.ops.kernels.attention_fused as attn_mod
    import yolo_infer_tpu_torch.ops.kernels.nms_fused as nms_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor

    rng = np.random.default_rng(SEED + 2)
    frames = rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    model, spec = smoke_weights(frames)
    report["weights"] = (model, spec)
    on_cpu = Predictor(model, spec, device="cpu", compute_dtype=torch.float32)
    on_gpu = Predictor(model, spec, device="cuda", compute_dtype=torch.float32)
    nms_mod.nms_keep.launches = attn_mod.attention_qkv.launches = 0
    torch.backends.cudnn.deterministic = True
    try:
        got = on_gpu.predict(list(frames), conf=0.001, iou=0.45, imgsz=640)
    finally:
        torch.backends.cudnn.deterministic = False
    launches = {"nms_keep": nms_mod.nms_keep.launches, "attention_qkv": attn_mod.attention_qkv.launches}
    want = on_cpu.predict(list(frames), conf=0.001, iou=0.45, imgsz=640)
    out = {"phase": "fp32", "launches": launches, "images": []}
    for g, w in zip(got, want):
        img = {"num_cuda": len(g), "num_cpu": len(w)}
        if len(g) == len(w):
            img["unmatched"] = match_detections(g, w, 1e-2, 1e-5)[0]
            img["classes_equal"] = bool(np.array_equal(np.sort(g.classes), np.sort(w.classes)))
        out["images"].append(img)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel did not run in the fp32 predict: {launches}")
    for img in out["images"]:
        if img["num_cuda"] != img["num_cpu"] or img["unmatched"] or not img["classes_equal"]:
            emit(out)
            raise AssertionError("fp32 predict on cuda differs from cpu")
    return out


def phase_bf16(report):
    import torch

    import yolo_infer_tpu_torch.models.blocks as blocks_mod
    import yolo_infer_tpu_torch.ops.nms as nms_ops
    from yolo_infer_tpu_torch.core.predictor import Predictor
    from yolo_infer_tpu_torch.ops.kernels import attention_fused as attn_mod
    from yolo_infer_tpu_torch.ops.kernels import nms_fused as nms_mod

    model, spec = report["weights"]
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(SEED + 3)
    frames = rng.integers(0, 256, (32, 640, 640, 3), dtype=np.uint8)
    pred.predict(frames, conf=0.25)  # warm-up (cuDNN plans, kernel loads)
    torch.cuda.synchronize()

    # the main path, once, with counters at 0 and the kernels' inputs captured
    seen = {}

    def capture(name, fn):
        def wrapped(*args):
            seen.setdefault(name, tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return fn(*args)
        return wrapped

    blocks_mod.attention_qkv = capture("attention_qkv", attn_mod.attention_qkv)
    nms_ops.nms_keep = capture("nms_keep", nms_mod.nms_keep)
    nms_mod.nms_keep.launches = attn_mod.attention_qkv.launches = 0
    try:
        results = pred.predict(frames, conf=0.25)
    finally:
        blocks_mod.attention_qkv = attn_mod.attention_qkv
        nms_ops.nms_keep = nms_mod.nms_keep
    launches = {"nms_keep": nms_mod.nms_keep.launches, "attention_qkv": attn_mod.attention_qkv.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel did not run on the main path: {launches}")
    nums = [len(r) for r in results]
    for r in results:
        if not (np.isfinite(r.boxes).all() and np.isfinite(r.scores).all() and len(r) <= 300):
            raise AssertionError("non-finite or oversized detections")
        if len(r) and ((r.boxes < 0).any() or (r.boxes[:, [0, 2]] > 640).any() or (r.boxes[:, [1, 3]] > 640).any()):
            raise AssertionError("boxes outside the frame")

    # end to end (numpy frames in, Results out) per call, and the device part
    # alone (frames already on the card, dets left there) by CUDA events
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.predict(frames, conf=0.25)
        times.append(time.perf_counter() - t0)
    times.sort()
    frames_dev = torch.from_numpy(frames).cuda()
    batch_device_ms = cuda_ms(lambda: pred.predict_raw(frames_dev, 0.25, 0.45, 640, 300), iters=20)

    kernels = []
    # kernel B at the main path's input
    row_b = attention_b_row(*seen["attention_qkv"])
    kernels.append({
        "name": "attention_qkv", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/attention_fused.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/attention_fused.py:114", "path": "detect b32 640 bf16",
        "launches": launches["attention_qkv"], **row_b,
    })
    # kernel A at the main path's input
    cboxes, valid, thr = seen["nms_keep"]
    err_a = float((nms_mod.nms_keep(cboxes, valid, thr) != nms_mod.nms_keep_reference(cboxes, valid, thr)).sum())
    bk, kk, _ = cboxes.shape
    bytes_a = cboxes.numel() * 4 + 2 * bk * kk
    ops_a = bk * kk * (kk - 1) // 2 * IOU_OPS
    kernel_a = lambda: nms_mod.nms_keep(cboxes, valid, thr)  # noqa: E731
    plain_a = lambda: nms_mod.nms_keep_reference(cboxes, valid, thr)  # noqa: E731
    kernels.append({
        "name": "nms_keep", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/nms_fused.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/nms_fused.py:86", "path": "detect b32 640 bf16",
        "launches": launches["nms_keep"],
        "max_abs_err": err_a,
        "ms": device_ms(kernel_a), "plain_ms": device_ms(plain_a, iters=10),
        "call_ms": cuda_ms(kernel_a), "plain_call_ms": cuda_ms(plain_a, iters=10),
        **bound(bytes_a, ops_a, H100_F32_OPS_UNFUSED),
        "library_ms": None,
        "shape": [bk, kk, 4], "valid": int(valid.sum()),
    })
    if err_a != 0 or row_b["tol_excess"] > 0:
        raise AssertionError(f"main-path kernel outputs differ from the plain versions: A {err_a}, "
                             f"B {row_b['max_abs_err']} (beyond atol = rtol = {ATTN_BF16_TOL} by {row_b['tol_excess']})")
    report["kernels"] = kernels
    report["serving"] = (pred, frames)
    median = times[len(times) // 2]
    return {"phase": "bf16", "batch": int(frames.shape[0]), "imgsz": 640, "calls": len(times),
            "img_per_s": frames.shape[0] / median, "ms_per_batch_median": 1e3 * median,
            "ms_per_batch_min": 1e3 * times[0], "ms_per_batch_max": 1e3 * times[-1],
            "device_ms_per_batch": batch_device_ms, "device_img_per_s": 1e3 * frames.shape[0] / batch_device_ms,
            "launches": launches, "detections_per_image": [min(nums), max(nums)]}


def attention_b_row(slab, heads: int, kd: int, hd: int):
    """Kernel B at one captured slab: its error against the plain version,
    device times (torch.profiler) beside its bound, the plain version and one
    `F.scaled_dot_product_attention` call on the same q, k, v (a yardstick
    only); `*call_ms` time the calls back to back with CUDA events."""
    import torch.nn.functional as F

    from yolo_infer_tpu_torch.ops.kernels import attention_fused as attn_mod

    ref = attn_mod.attention_qkv_reference(slab, heads, kd, hd)
    got = attn_mod.attention_qkv(slab, heads, kd, hd)
    err_b = float((got.float() - ref.float()).abs().max())
    b, n, d = slab.shape
    q, k, v = (slab.view(b, n, heads, 2 * kd + hd)[..., s].transpose(1, 2)
               for s in (slice(0, kd), slice(kd, 2 * kd), slice(2 * kd, None)))
    bytes_b = slab.numel() * slab.element_size() + b * n * heads * hd * slab.element_size()
    flops_b = 2 * b * heads * n * n * (kd + hd)
    kernel_b = lambda: attn_mod.attention_qkv(slab, heads, kd, hd)  # noqa: E731
    plain_b = lambda: attn_mod.attention_qkv_reference(slab, heads, kd, hd)  # noqa: E731
    library_b = lambda: F.scaled_dot_product_attention(q, k, v, scale=kd ** -0.5)  # noqa: E731
    return {"max_abs_err": err_b, "tol_excess": attn_tol_excess(got, ref), "max_abs_out": float(ref.float().abs().max()),
            "ms": device_ms(kernel_b), "plain_ms": device_ms(plain_b),
            **bound(bytes_b, flops_b, H100_BF16_FLOPS),
            "library_ms": device_ms(library_b),
            "call_ms": cuda_ms(kernel_b), "plain_call_ms": cuda_ms(plain_b), "library_call_ms": cuda_ms(library_b),
            "shape": [b, n, d], "dtype": str(slab.dtype)}


def phase_profile(report):
    """Device time by kernel over three main-path predicts (torch.profiler)."""
    pred, frames = report["serving"]
    return {"phase": "profile", **kernel_profile(lambda: pred.predict(frames, conf=0.25))}


def random_rotated(rng, b: int, k: int):
    """Random oriented candidates in a 640 px frame, as Gaussian terms, and a validity mask."""
    import torch

    from yolo_infer_tpu_torch.ops.rotated import gauss_terms

    rb = np.concatenate([rng.uniform(50, 590, (b, k, 2)), rng.uniform(10, 120, (b, k, 2)),
                         rng.uniform(-np.pi / 2, np.pi / 2, (b, k, 1))], -1).astype(np.float32)
    return gauss_terms(torch.from_numpy(rb).cuda()).contiguous(), torch.from_numpy(rng.uniform(0, 1, (b, k)) > 0.15).cuda()


def phase_rnms(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.rotated_nms_fused import rotated_nms_keep, rotated_nms_keep_reference
    from yolo_infer_tpu_torch.ops.rotated import gauss_terms

    rng = np.random.default_rng(SEED + 4)
    out = {"phase": "rnms", "cases": []}
    # (K, valid): random flags, or a prefix of 300..1500 (the serving pool's shape)
    for k, kind in ((1024, "random"), (37, "random"), (160, "random"), (2048, "random"), (4096, "random"),
                    (8192, "random"), (4096, "prefix")):
        gauss, valid = random_rotated(rng, 16, k)
        if kind == "prefix":
            valid = torch.arange(k, device="cuda")[None] < torch.from_numpy(rng.integers(300, 1500, (16, 1))).cuda()
        got = rotated_nms_keep(gauss, valid, 0.45)
        # the plain version one image at a time: its (K, K) temporaries are 268 MB each at K = 8192
        want = torch.cat([rotated_nms_keep_reference(gauss[i:i + 1], valid[i:i + 1], 0.45) for i in range(16)])
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        out["cases"].append({"K": k, "B": 16, "valid": kind, "valid_count": int(valid.sum()), "kept": int(got.sum()),
                             "equal": ok, **c_time_split(gauss, valid, 0.45)})
        if not ok:
            raise AssertionError(f"rotated keep mask differs at K={k} ({kind}): {int((got != want).sum())} entries")
        del want
    chain = torch.tensor([[[50, 50, 100, 40, 0.3], [90, 50, 100, 40, 0.3], [130, 50, 100, 40, 0.3],
                           [400, 400, 20, 20, 0.0]]], dtype=torch.float32, device="cuda")
    kept = rotated_nms_keep(gauss_terms(chain).contiguous(), torch.tensor([[True, True, True, False]], device="cuda"), 0.3)
    if kept.cpu().tolist() != [[True, False, True, False]]:
        raise AssertionError(f"rotated suppression chain: {kept.cpu().tolist()}")
    out["cases"].append({"chain": True, "equal": True})
    try:
        rotated_nms_keep(torch.zeros((1, 8193, 5), device="cuda"), torch.ones((1, 8193), dtype=torch.bool, device="cuda"), 0.45)
    except ValueError as exc:
        out["k_8193"] = str(exc)
    else:
        raise AssertionError("rotated_nms_keep took K = 8193")
    return out


def c_time_split(gauss, valid, thr):
    """Kernel C's device time per call (torch.profiler over 10 calls), split
    into its two launches: the probIoU bits pass and the walk (resident for
    K <= 1024, strip-staged above)."""
    from yolo_infer_tpu_torch.ops.kernels.rotated_nms_fused import rotated_nms_keep

    named = kernel_profile(lambda: rotated_nms_keep(gauss, valid, thr), calls=10,
                           named=("probiou_bits_kernel", "_walk_kernel"))["named"]
    bits_ms, walk_ms = named["probiou_bits_kernel"]["ms"], named["_walk_kernel"]["ms"]
    return {"ms": bits_ms + walk_ms, "bits_ms": bits_ms, "walk_ms": walk_ms, "walk_share": walk_ms / (bits_ms + walk_ms)}


def d_skip_share(soft) -> float:
    """Share of kernel D's (instance, source row, packed word) steps that take
    its zero skip: no value above 0.5 in source rows i-1..i+1 and columns
    8c-1..8c+8, clamped at the edges (a warp computes when any lane does)."""
    import torch.nn.functional as F

    above = F.pad((soft > 0.5).float()[:, None], (1, 1, 1, 1), mode="replicate")
    return float(1 - F.max_pool2d(above, (3, 10), stride=(1, 8)).mean())


def d_bound(soft, packed):
    """Kernel D's bound at this input: each soft mask byte read and packed
    byte written once, against the operations of the steps that do not take
    the zero skip (the taps of a skipped step are not needed)."""
    n, h, w = soft.shape
    dense_ops = n * 4 * h * 4 * w * PACK_OPS_PER_PIXEL + n * 4 * h * w * PACK_OPS_PER_HTAP
    return bound(soft.numel() * 4 + packed.numel(), dense_ops * (1 - d_skip_share(soft)), H100_F32_OPS_UNFUSED)


def phase_mpack(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.mask_pack import (
        upsample4x_threshold_pack,
        upsample4x_threshold_pack_reference,
    )

    rng = np.random.default_rng(SEED + 5)
    out = {"phase": "mpack", "cases": []}

    def check(case, soft, timed=False):
        got = upsample4x_threshold_pack(soft)
        want = upsample4x_threshold_pack_reference(soft)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        popcount = torch.tensor([bin(v).count("1") for v in range(256)], dtype=torch.uint8, device=got.device)
        row = {"case": case, "shape": list(soft.shape),
               "ones_share": float(popcount[got.int()].sum(dtype=torch.int64)) / (8 * got.numel()),
               "skip_share": d_skip_share(soft), "equal": ok}
        if timed:
            row.update(ms=device_ms(lambda: upsample4x_threshold_pack(soft), iters=10), **d_bound(soft, got))
        out["cases"].append(row)
        if not ok:
            raise AssertionError(f"packed masks differ ({case}, {tuple(soft.shape)}): {int((got != want).sum())} bytes")
        return got

    for shape in ((300, 160, 160), (37, 24, 40), (5, 17, 8), (2, 6, 4096)):
        check("random", torch.from_numpy(rng.random(shape).astype(np.float32)).cuda())
    # the segment path's shape, dense: no step skips
    check("dense", torch.rand((9600, 160, 160), generator=torch.Generator("cuda").manual_seed(SEED), device="cuda"),
          timed=True)
    # values at the threshold and beyond it scattered over zeros, all-zero
    # instances, and 2 x 2 blocks just above 0.5 (a single such value sets no bit)
    up = np.nextafter(np.float32(0.5), np.float32(1))
    vals = np.array([0.5, up, -np.inf, np.inf, np.nan, 0.49, 0.75, -3.0], np.float32)
    soft = np.where(rng.random((64, 24, 40)) < 0.1, vals[rng.integers(0, 8, (64, 24, 40))], 0).astype(np.float32)
    soft[::4] = 0
    soft[1::4, 6:8, 8:10] = up
    got = check("edge values", torch.from_numpy(soft).cuda())
    if got[::4].any() or not got[1::4].any():
        raise AssertionError("edge values: an all-zero instance set a bit, or a block above 0.5 set none")
    return out


# the kernels each task's predict must launch
TASK_KERNELS = {"segment": ("nms_keep", "attention_qkv", "upsample4x_threshold_pack"),
                "obb": ("attention_qkv", "rotated_nms_keep", "dfl_decode"),
                "pose": ("nms_keep", "attention_qkv"),
                "classify": ("attention_qkv",)}
TASK_NC = {"segment": 80, "obb": 15, "pose": 1, "classify": 1000}


def phase_tasks_fp32(report):
    import torch

    import yolo_infer_tpu_torch.ops.rotated as rot_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor

    rng = np.random.default_rng(SEED + 6)
    calib = rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8), rng.integers(0, 256, (360, 500, 3), dtype=np.uint8)]
    out = {"phase": "tasks_fp32", "tasks": {}}
    failures = []
    report["task_weights"] = {}
    # OBB also at pre_topk 2048: kernel C past the 1024 of its one-block form
    for task, pre_topk in (("segment", 1024), ("obb", 1024), ("obb", 2048), ("pose", 1024), ("classify", 1024)):
        name = task if pre_topk == 1024 else f"{task} pre_topk {pre_topk}"
        if task not in report["task_weights"]:
            report["task_weights"][task] = smoke_weights(calib, task, TASK_NC[task])
        model, spec = report["task_weights"][task]
        on_cpu = Predictor(model, spec, device="cpu", compute_dtype=torch.float32, pre_topk=pre_topk)
        on_gpu = Predictor(model, spec, device="cuda", compute_dtype=torch.float32, pre_topk=pre_topk)
        seen = {}
        restore = capture_inputs(rot_mod, "rotated_nms_keep", seen, clone=False)
        torch.backends.cudnn.deterministic = True
        try:
            reset_counters()
            got = on_gpu.predict(frames, conf=0.25, iou=0.45, imgsz=640)
            launches = read_counters()
        finally:
            torch.backends.cudnn.deterministic = False
            restore()
        want = on_cpu.predict(frames, conf=0.25, iou=0.45, imgsz=640)
        res = {"launches": launches, "images": []}
        if "rotated_nms_keep" in seen:
            res["rotated_nms_keep_shape"] = list(seen["rotated_nms_keep"][0].shape)
            if seen["rotated_nms_keep"][0].shape[1] != pre_topk:
                failures.append(f"{name}: kernel C ran at {res['rotated_nms_keep_shape']}")
        if min(launches[k] for k in TASK_KERNELS[task]) < 1:
            failures.append(f"{name}: a kernel did not run: {launches}")
        for g, w in zip(got, want):
            img = {"num_cuda": len(g), "num_cpu": len(w)}
            if task == "classify":
                img["probs_max_abs_err"] = float(np.abs(g.probs - w.probs).max())
                img["top5_equal"] = bool(np.array_equal(np.argsort(-g.probs)[:5], np.argsort(-w.probs)[:5]))
                if img["probs_max_abs_err"] > 1e-5:
                    failures.append(f"classify probs differ by {img['probs_max_abs_err']}")
            else:
                # pair detections loosely (same class, box within 1 px, score
                # within 1e-3), then hold the pairs to the tolerances
                missing, pairs = match_detections(g, w, 1.0, 1e-3)
                img["unmatched"] = missing + len(w) - len(pairs)
                errs = {}
                if pairs:
                    i, j = map(list, zip(*pairs))
                    errs["box_max_abs_err"] = float(np.abs(g.boxes[i] - w.boxes[j]).max())
                    errs["score_max_abs_err"] = float(np.abs(g.scores[i] - w.scores[j]).max())
                    if task == "obb":
                        errs["obb_max_abs_err"] = float(np.abs(g.obb[i] - w.obb[j]).max())
                    if task == "pose":
                        errs["kpts_max_abs_err"] = float(np.abs(g.keypoints[i] - w.keypoints[j]).max())
                    if task == "segment":
                        gm, wm = g.masks.numpy()[i], w.masks.numpy()[j]
                        img["mask_pixels"] = int(gm.size)
                        img["mask_ones_share"] = float(gm.mean())
                        img["mask_pixels_differing"] = int((gm != wm).sum())
                        if img["mask_pixels_differing"] > 1e-4 * gm.size:
                            failures.append(f"masks differ in {img['mask_pixels_differing']} of {gm.size} pixels")
                img.update(errs)
                for key, err in errs.items():
                    if err > (SCORE_TOL if key.startswith("score") else PX_TOL):
                        failures.append(f"{name}: {key} {err}")
                if len(g) != len(w) or img["unmatched"] or len(g) == 0:
                    failures.append(f"{name}: detections differ ({img})")
            res["images"].append(img)
        out["tasks"][name] = res
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


def capture_inputs(module, name: str, seen: dict, clone: bool = True):
    """Wrap `module.<name>` (a kernel wrapper as the calling module sees it)
    so its first call's arguments are cloned into `seen[name]` (or kept as
    they are, strided views included, with `clone=False`: for arguments the
    path never writes to again); returns the function that restores it."""
    import torch

    fn = getattr(module, name)

    def wrapped(*args):
        seen.setdefault(name, tuple(a.clone() if clone and torch.is_tensor(a) else a for a in args))
        return fn(*args)

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, fn)


def phase_seg_bf16(report):
    import torch

    import yolo_infer_tpu_torch.ops.masks as masks_mod
    from yolo_infer_tpu_torch.core.predictor import LazyMasks, Predictor
    from yolo_infer_tpu_torch.ops.kernels import mask_pack as mp_mod

    model, spec = report["task_weights"]["segment"]
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16, mask_mode="device")
    batch, imgsz = SEG_SERVE
    frames = np.random.default_rng(SEED + 7).integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    pred.predict(frames, conf=0.25, imgsz=imgsz)  # warm-up
    torch.cuda.synchronize()

    seen = {}
    restore = capture_inputs(masks_mod, "upsample4x_threshold_pack", seen)
    reset_counters()
    try:
        results = pred.predict(frames, conf=0.25, imgsz=imgsz)
    finally:
        restore()
    launches = read_counters()
    if min(launches[k] for k in TASK_KERNELS["segment"]) < 1:
        raise AssertionError(f"a kernel did not run on the segment path: {launches}")
    nums = [len(r) for r in results]
    if min(nums) < 1 or max(nums) > 300:
        raise AssertionError(f"segment detections per image out of range: {min(nums)}..{max(nums)}")
    LazyMasks.prefetch(results[:2], np.uint8)  # one device-to-host copy for both
    for r in results[:2]:
        m = r.masks.numpy()
        if m.shape != (len(r), imgsz, imgsz) or not (np.isfinite(r.boxes).all() and np.isfinite(r.scores).all()):
            raise AssertionError(f"bad segment output: masks {m.shape}, {len(r)} detections")
    mask_ones = float(np.mean([r.masks.numpy().mean() for r in results[:2]]))
    timing = timed_serving(pred, frames, imgsz)

    (soft,) = seen["upsample4x_threshold_pack"]
    kernel_d = lambda: mp_mod.upsample4x_threshold_pack(soft)  # noqa: E731
    plain_d = lambda: mp_mod.upsample4x_threshold_pack_reference(soft)  # noqa: E731
    got, want = kernel_d(), plain_d()
    err_d = float((got != want).sum())
    if err_d:
        raise AssertionError(f"kernel D differs from its plain version on the segment path: {err_d} bytes")
    n, h, w = soft.shape
    report["kernels"].append({
        "name": "upsample4x_threshold_pack", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/mask_pack.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/mask_pack.py:92", "path": f"segment b{batch} {imgsz} bf16",
        "launches": launches["upsample4x_threshold_pack"], "max_abs_err": err_d,
        "ms": device_ms(kernel_d), "plain_ms": device_ms(plain_d, iters=5),
        "call_ms": cuda_ms(kernel_d, iters=20), "plain_call_ms": cuda_ms(plain_d, iters=5, warmup=1),
        **d_bound(soft, got),
        "library_ms": None, "shape": [n, h, w], "skip_share": d_skip_share(soft),
    })
    del soft, got, want, seen
    profile = kernel_profile(lambda: pred.predict(frames, conf=0.25, imgsz=imgsz))
    return {"phase": "seg_bf16", **timing, "launches": launches, "detections_per_image": [min(nums), max(nums)],
            "mask_ones_share": mask_ones, "profile": profile}


def phase_obb_bf16(report):
    import torch

    import yolo_infer_tpu_torch.models.blocks as blocks_mod
    import yolo_infer_tpu_torch.ops.rotated as rot_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor
    from yolo_infer_tpu_torch.ops.kernels import rotated_nms_fused as rn_mod

    model, spec = report["task_weights"]["obb"]
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
    batch, imgsz = OBB_SERVE
    frames = np.random.default_rng(SEED + 8).integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    pred.predict(frames, conf=0.25, imgsz=imgsz)  # warm-up
    torch.cuda.synchronize()

    seen = {}
    restores = [capture_inputs(rot_mod, "rotated_nms_keep", seen), capture_inputs(blocks_mod, "attention_qkv", seen)]
    reset_counters()
    try:
        results = pred.predict(frames, conf=0.25, imgsz=imgsz)
    finally:
        for restore in restores:
            restore()
    launches = read_counters()
    if min(launches[k] for k in TASK_KERNELS["obb"]) < 1:
        raise AssertionError(f"a kernel did not run on the OBB path: {launches}")
    nums = [len(r) for r in results]
    if min(nums) < 1:
        raise AssertionError("an image without oriented detections")
    for r in results:
        if not (np.isfinite(r.obb).all() and np.isfinite(r.scores).all() and len(r) <= 300):
            raise AssertionError("non-finite or oversized oriented detections")
    timing = timed_serving(pred, frames, imgsz)

    gauss, valid, thr = seen["rotated_nms_keep"]
    kernel_c = lambda: rn_mod.rotated_nms_keep(gauss, valid, thr)  # noqa: E731
    plain_c = lambda: rn_mod.rotated_nms_keep_reference(gauss, valid, thr)  # noqa: E731
    err_c = float((kernel_c() != plain_c()).sum())
    if err_c:
        raise AssertionError(f"kernel C differs from its plain version on the OBB path: {err_c} entries")
    b, k, _ = gauss.shape
    bytes_c = gauss.numel() * 4 + 2 * b * k
    # the pairs of valid candidates (the kernel skips every other pair)
    nv = valid.sum(1).double()
    ops_c = float((nv * (nv - 1) / 2).sum()) * PROBIOU_OPS + b * k * 4
    report["kernels"].append({
        "name": "rotated_nms_keep", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/rotated_nms_fused.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/nms_fused.py:149", "path": f"obb b{batch} {imgsz} bf16",
        "launches": launches["rotated_nms_keep"], "max_abs_err": err_c,
        **c_time_split(gauss, valid, thr), "plain_ms": device_ms(plain_c, iters=5),
        "call_ms": cuda_ms(kernel_c, iters=20), "plain_call_ms": cuda_ms(plain_c, iters=5, warmup=1),
        **bound(bytes_c, ops_c, H100_F32_OPS_UNFUSED),
        "library_ms": None, "shape": [b, k, 5], "valid": int(valid.sum()),
    })
    # kernel B at the OBB path's N = 1024 slab
    row_b = attention_b_row(*seen["attention_qkv"])
    if row_b["tol_excess"] > 0:
        raise AssertionError(f"kernel B differs from its plain version on the OBB path by {row_b['max_abs_err']}")
    profile = kernel_profile(lambda: pred.predict(frames, conf=0.25, imgsz=imgsz))
    return {"phase": "obb_bf16", **timing, "launches": launches, "detections_per_image": [min(nums), max(nums)],
            "attention_qkv": row_b, "profile": profile}

def phase_dfl(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.dfl_decode import dfl_decode, dfl_decode_reference

    rng = np.random.default_rng(SEED + 9)
    slab = torch.from_numpy(rng.normal(0, 3, (16, 8400, 144)).astype(np.float32)).cuda()
    out = {"phase": "dfl", "cases": []}
    for dtype in (torch.float32, torch.bfloat16):
        typed = slab.to(dtype)
        for layout, x in (("contiguous", typed[..., :64].contiguous()), ("slab slice", typed[..., :64])):
            got = dfl_decode(x)
            want = dfl_decode_reference(x)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            out["cases"].append({"shape": list(x.shape), "dtype": str(dtype), "layout": layout,
                                 "strides": list(x.stride()), "max_abs_err": err})
            if not err <= 1e-5:
                raise AssertionError(f"kernel F differs from its plain version by {err} ({dtype}, {layout})")
    return out


def phase_gnms(report):
    import torch

    from yolo_infer_tpu_torch.ops.iou import box_iou_matrix
    from yolo_infer_tpu_torch.ops.kernels.greedy_nms import greedy_nms_keep, greedy_nms_keep_reference

    rng = np.random.default_rng(SEED + 10)
    out = {"phase": "gnms", "cases": []}

    def check(case, iou, valid, thr):
        got = greedy_nms_keep(iou, valid, thr)
        want = greedy_nms_keep_reference(iou, valid, thr)
        torch.cuda.synchronize()
        ok = torch.equal(got, want)
        out["cases"].append({"case": case, "B": iou.shape[0], "K": iou.shape[1], "valid": int(valid.sum()),
                             "kept": int(got.sum()), "equal": ok})
        if not ok:
            raise AssertionError(f"kernel G differs from its plain version ({case}): {int((got != want).sum())} entries")
        return got

    for b, k in ((16, 4096), (4, 1000), (3, 37)):
        boxes, valid = random_candidates(rng, b, k)
        bx, va = torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()
        if k == 37:
            va[1] = False  # an image with no valid candidate
        check("random" if k != 37 else "random, image 1 all invalid", box_iou_matrix(bx, bx), va, 0.6)
    # box i overlaps box i+1 at IoU 0.5 and box i+2 at 0.2: greedy keeps every other box
    x = torch.arange(4096, dtype=torch.float32, device="cuda")[:, None] * 10
    chain = torch.cat([x, torch.zeros_like(x), x + 30, torch.full_like(x, 10)], 1)[None]
    kept = check("chain", box_iou_matrix(chain, chain), torch.ones((1, 4096), dtype=torch.bool, device="cuda"), 0.3)
    if not torch.equal(kept[0], torch.arange(4096, device="cuda") % 2 == 0):
        raise AssertionError("suppression chain: kernel G did not keep every other box")
    return out


class _Recorder:
    """A predictor that records every `predict_raw` result on the host."""

    def __init__(self, pred):
        self.pred, self.spec, self.device, self.dets = pred, pred.spec, pred.device, []

    def predict_raw(self, *args, **kw):
        out = self.pred.predict_raw(*args, **kw)
        self.dets.append({k: v.cpu().numpy() for k, v in out.items()})
        return out


def write_val_dataset(root: Path, frames, results, task: str, nc: int):
    """YOLO-format dataset of `frames` (PNG, `save_image`) labelled with
    `results` (normalized xywh; pose keypoints with visibility 2 where the
    predicted keypoint confidence exceeds 0.5, else 1), as a dict config."""
    from yolo_infer_tpu_torch.data.loader import save_image

    (root / "labels" / "val").mkdir(parents=True, exist_ok=True)
    for i, (frame, r) in enumerate(zip(frames, results)):
        save_image(root / "images" / "val" / f"f{i:03d}.png", frame, compress_level=1)
        h, w = frame.shape[:2]
        lines = []
        for j in range(len(r)):
            x1, y1, x2, y2 = (r.boxes[j] / [w, h, w, h]).clip(0, 1)
            line = f"{r.classes[j]} {(x1 + x2) / 2:.6f} {(y1 + y2) / 2:.6f} {x2 - x1:.6f} {y2 - y1:.6f}"
            if task == "pose":
                line += "".join(f" {x / w:.6f} {y / h:.6f} {2 if v > 0.5 else 1}" for x, y, v in r.keypoints[j])
            lines.append(line)
        (root / "labels" / "val" / f"f{i:03d}.txt").write_text("\n".join(lines) + "\n")
    return {"path": str(root), "val": "images/val", "names": {c: str(c) for c in range(nc)}}


class _Dets(SimpleNamespace):
    """One image's detections (boxes, scores, classes, kpts) for `match_detections`."""

    def __len__(self):
        return len(self.scores)


def pair_val_detections(got, want):
    """Pair each recorded batch's detections with score >= 0.25 as sets, in
    both directions (a partner may sit just below the cut). Returns
    (unpaired count, largest keypoint error of the pairs, detections seen)."""
    unpaired, kpt_err, seen = 0, 0.0, 0
    for g, w in zip(got, want):
        for i in range(len(g["num"])):
            def dets(d, lo):
                k = int(d["num"][i])
                keep = d["scores"][i, :k] >= lo
                return _Dets(boxes=d["boxes"][i, :k][keep], scores=d["scores"][i, :k][keep],
                             classes=d["classes"][i, :k][keep], kpts=d["kpts"][i, :k][keep] if "kpts" in d else None)

            for a, b in ((dets(g, 0.25 + SCORE_TOL), dets(w, 0.25 - SCORE_TOL)),
                         (dets(w, 0.25 + SCORE_TOL), dets(g, 0.25 - SCORE_TOL))):
                missing, pairs = match_detections(a, b, PX_TOL, SCORE_TOL)
                unpaired += missing
                seen += len(a)
                if pairs and a.kpts is not None:
                    ia, ib = map(list, zip(*pairs))
                    kpt_err = max(kpt_err, float(np.abs(a.kpts[ia] - b.kpts[ib]).max()))
    return unpaired, kpt_err, seen


def phase_val_fp32(report):
    rng = np.random.default_rng(SEED + 11)
    half = VAL_FP32_FRAMES // 2
    frames = ([rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(half)]
              + [rng.integers(0, 256, (360, 500, 3), dtype=np.uint8) for _ in range(half)])
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_val_"))
    try:
        return _val_fp32(report, frames, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _val_fp32(report, frames, root: Path):
    import torch

    from yolo_infer_tpu_torch.core.predictor import Predictor
    from yolo_infer_tpu_torch.core.validator import YOLO11Validator

    out = {"phase": "val_fp32", "frames": len(frames), "tasks": {}}
    failures = []
    for task, (model, spec) in (("detect", report["weights"]), ("pose", report["task_weights"]["pose"])):
        on_cpu = Predictor(model, spec, device="cpu", compute_dtype=torch.float32)
        on_gpu = Predictor(model, spec, device="cuda", compute_dtype=torch.float32)
        labels = on_cpu.predict(frames, conf=0.25, iou=VAL["iou"], imgsz=VAL["imgsz"])
        data = write_val_dataset(root / task, frames, labels, task, spec.nc)
        gpu_rec, cpu_rec = _Recorder(on_gpu), _Recorder(on_cpu)
        torch.backends.cudnn.deterministic = True
        try:
            reset_counters()
            got = YOLO11Validator(model=SimpleNamespace(predictor=gpu_rec), output_dir=root / f"{task}_cuda").validate(
                data, verbose=False, **VAL)
            launches = read_counters()
        finally:
            torch.backends.cudnn.deterministic = False
        want = YOLO11Validator(model=SimpleNamespace(predictor=cpu_rec), output_dir=root / f"{task}_cpu").validate(
            data, verbose=False, **VAL)
        unpaired, kpt_err, seen = pair_val_detections(gpu_rec.dets, cpu_rec.dets)
        metrics = {"cuda": got["metrics"], "cpu": want["metrics"]}
        diffs = {k: abs(got["metrics"][k] - want["metrics"][k]) for k in ("mAP50-95", "mAP50")}
        if task == "pose":
            metrics.update(pose_cuda=got["pose_metrics"], pose_cpu=want["pose_metrics"])
            diffs.update({f"pose {k}": abs(got["pose_metrics"][k] - want["pose_metrics"][k])
                          for k in ("mAP50-95", "mAP50")})
        out["tasks"][task] = {"launches": launches, "metrics": metrics, "max_metric_diff": max(diffs.values()),
                              "dets_score_ge_0.25": seen, "unpaired": unpaired, "kpts_max_abs_err": kpt_err,
                              "num_images": got["num_images"]}
        if min(launches[k] for k in ("attention_qkv", "dfl_decode", "greedy_nms_keep")) < 1:
            failures.append(f"{task}: a kernel did not run in the cuda validation: {launches}")
        if max(diffs.values()) > 1e-3:
            failures.append(f"{task}: metrics differ between cuda and cpu: {diffs}")
        if unpaired or seen == 0 or kpt_err > KPT_TOL:
            failures.append(f"{task}: {unpaired} of {seen} detections unpaired, keypoints off by {kpt_err}")
        if not 0 < got["metrics"]["mAP50"] <= 1:
            failures.append(f"{task}: mAP50 {got['metrics']['mAP50']}")
    if failures:
        emit(out)
        raise AssertionError("; ".join(failures))
    return out


def phase_val_bf16(report):
    import torch

    from yolo_infer_tpu_torch.core.predictor import Predictor

    model, spec = report["weights"]
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
    frames = np.random.default_rng(SEED + 12).integers(0, 256, (VAL_BF16_FRAMES, 480, 640, 3), dtype=np.uint8)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_val_"))
    try:
        return _val_bf16(report, pred, spec, frames, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _val_bf16(report, pred, spec, frames, root: Path):
    import torch

    import yolo_infer_tpu_torch.ops.decode as decode_mod
    import yolo_infer_tpu_torch.ops.nms as nms_ops
    from yolo_infer_tpu_torch.core.validator import YOLO11Validator
    from yolo_infer_tpu_torch.ops.kernels import dfl_decode as f_mod
    from yolo_infer_tpu_torch.ops.kernels import greedy_nms as g_mod

    labels = pred.predict(frames, conf=0.25, iou=VAL["iou"], imgsz=VAL["imgsz"])
    data = write_val_dataset(root / "data", frames, labels, "detect", spec.nc)
    validator = YOLO11Validator(model=pred, output_dir=root / "out")

    # the validation path, once, with counters at 0 and kernel inputs captured
    seen = {}
    restores = [capture_inputs(decode_mod, "dfl_decode", seen, clone=False),
                capture_inputs(nms_ops, "box_iou_matrix", seen, clone=False),
                capture_inputs(nms_ops, "greedy_nms_keep", seen, clone=False)]
    reset_counters()
    try:
        first = validator.validate(data, verbose=False, **VAL)
    finally:
        for restore in restores:
            restore()
    launches = read_counters()
    batches = -(-VAL_BF16_FRAMES // VAL["batch"])
    if min(launches[k] for k in ("attention_qkv", "dfl_decode", "greedy_nms_keep")) < 1:
        raise AssertionError(f"a kernel did not run on the validation path: {launches}")
    if not 0 < first["metrics"]["mAP50"] <= 1 or first["num_images"] != VAL_BF16_FRAMES:
        raise AssertionError(f"validation result out of range: {first['metrics']}, {first['num_images']} images")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = validator.validate(data, verbose=False, **VAL)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # kernel F at the path's own input: the strided (16, 8400, 64) slice of the head slab
    x, reg_max = seen["dfl_decode"]
    kernel_f = lambda: f_mod.dfl_decode(x, reg_max)  # noqa: E731
    plain_f = lambda: f_mod.dfl_decode_reference(x, reg_max)  # noqa: E731
    err_f = float((kernel_f() - plain_f()).abs().max())
    b, a, c = x.shape
    bytes_f = b * a * c * x.element_size() + b * a * 4 * 4
    ops_f = b * a * c * DFL_OPS_PER_LOGIT + b * a * 4
    # kernel G at the path's own input, and the plain IoU build in front of it
    iou, valid, thr = seen["greedy_nms_keep"]
    sup, _ = seen["box_iou_matrix"]
    kernel_g = lambda: g_mod.greedy_nms_keep(iou, valid, thr)  # noqa: E731
    plain_g = lambda: g_mod.greedy_nms_keep_reference(iou, valid, thr)  # noqa: E731
    iou_build = lambda: nms_ops.box_iou_matrix(sup, sup)  # noqa: E731
    err_g = float((kernel_g() != plain_g()).sum())
    bk, k, _ = iou.shape
    # the upper triangle of the valid rows is all G must read (bits of the
    # other rows are never used), plus the valid flags in and the keep flags out
    rows = torch.nonzero(valid)[:, 1]
    pairs_g = int((k - 1 - rows).sum())
    bytes_g = 4 * pairs_g + 2 * bk * k
    if err_f > 1e-5 or err_g:
        raise AssertionError(f"validation-path kernel outputs differ from the plain versions: F {err_f}, G {err_g}")
    val_path = f"detect val b{VAL['batch']} {VAL['imgsz']} bf16"
    report["kernels"] += [{
        "name": "dfl_decode", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/dfl_decode.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/dfl_kernel.py:49", "path": val_path,
        "launches": launches["dfl_decode"], "max_abs_err": err_f,
        "ms": device_ms(kernel_f), "plain_ms": device_ms(plain_f),
        "call_ms": cuda_ms(kernel_f), "plain_call_ms": cuda_ms(plain_f),
        **bound(bytes_f, ops_f, H100_F32_FLOPS),
        "library_ms": None, "shape": [b, a, c], "strides": list(x.stride()), "dtype": str(x.dtype),
    }, {
        "name": "greedy_nms_keep", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/nms_kernel.py:48", "path": val_path,
        "launches": launches["greedy_nms_keep"], "max_abs_err": err_g,
        "ms": device_ms(kernel_g), "plain_ms": device_ms(plain_g, iters=3),
        "call_ms": cuda_ms(kernel_g, iters=20), "plain_call_ms": cuda_ms(plain_g, iters=3, warmup=1),
        **bound(bytes_g, pairs_g, H100_F32_FLOPS),
        "library_ms": None, "shape": [bk, k, k], "valid": int(valid.sum()),
    }]
    f_row, g_row = report["kernels"][-2:]
    frames_dev = torch.from_numpy(frames[:VAL["batch"]]).cuda()
    profile = kernel_profile(lambda: pred.predict_raw(frames_dev, VAL["conf"], VAL["iou"], VAL["imgsz"], 300,
                                                      multi_label=True, pre_topk=VAL["pre_topk"]))
    return {"phase": "val_bf16", "frames": VAL_BF16_FRAMES, "batch": VAL["batch"], "imgsz": VAL["imgsz"],
            "images_per_s": timed["speed"]["images_per_s"],
            "inference_ms_per_image": timed["speed"]["inference_ms_per_image"], "total_s": timed["speed"]["total_s"],
            "first_run": first["speed"], "metrics": timed["metrics"], "peak_memory_gb": peak_gb,
            "launches": launches, "launches_per_batch": {k: v / batches for k, v in launches.items()},
            "per_batch_ms": {"dfl_decode": f_row["ms"], "greedy_nms_keep": g_row["ms"],
                             "box_iou_matrix": device_ms(iou_build, iters=5)},
            "bound_ms": {"dfl_decode": f_row["bound_ms"], "greedy_nms_keep": g_row["bound_ms"]},
            "iou_matrix_gb": iou.numel() * 4 / 1e9, "profile": profile}


def box_iou_np(a, b):
    lt, rb = np.maximum(a[:, None, :2], b[None, :, :2]), np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    area = lambda z: np.prod(z[:, 2:] - z[:, :2], axis=-1)  # noqa: E731
    return inter / (area(a)[:, None] + area(b)[None] - inter)


def pair_share(got, want, lo: float = 0.35, score_tol: float = 0.1):
    """Both ways, the share of the detections scoring >= lo that have a
    partner in the other prediction (same class, IoU >= 0.5, score within
    score_tol), and the box and score errors of the best-IoU partners."""
    paired = seen = 0
    box_errs, score_errs = [], []
    for g, w in zip(got, want):
        for a, b in ((g, w), (w, g)):
            keep = a.scores >= lo
            if not keep.any() or not len(b):
                seen += int(keep.sum())
                continue
            iou = box_iou_np(a.boxes[keep], b.boxes)
            ok = (iou >= 0.5) & (a.classes[keep, None] == b.classes[None]) \
                & (np.abs(a.scores[keep, None] - b.scores[None]) <= score_tol)
            paired += int(ok.any(1).sum())
            seen += int(keep.sum())
            rows = np.nonzero(ok.any(1))[0]
            best = np.where(ok, iou, -1).argmax(1)[rows]
            box_errs += list(np.abs(a.boxes[keep][rows] - b.boxes[best]).max(1))
            score_errs += list(np.abs(a.scores[keep][rows] - b.scores[best]))
    q = lambda v: [float(np.quantile(v, p)) for p in (0.5, 0.9, 1.0)] if v else None  # noqa: E731
    return {"share": paired / max(seen, 1), "seen": seen, "box_err_p50_p90_max": q(box_errs),
            "score_err_p50_p90_max": q(score_errs)}


def phase_q8_fp32(report):
    import torch

    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

    rng = np.random.default_rng(SEED + 13)
    calib = rng.integers(0, 256, (2, 640, 640, 3), dtype=np.uint8)
    model, spec = smoke_weights(calib, size="s", calibrate_bn=False)
    report["q8_weights"] = (model, spec)
    base = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="s", fused=False,
                                   compute_dtype=torch.float32, device="cpu")
    ptq = create_quantizer("ptq", base, {"imgsz": 640})
    ptq.set_calibration_data([calib])
    on_cpu = ptq.optimize()
    on_gpu = YOLO11Model.from_params(copy.deepcopy(on_cpu.deploy_model), task="detect", size="s", fused=True,
                                     quant_act_scales=on_cpu.quant_act_scales, compute_dtype=torch.float32)
    frames = rng.integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    torch.backends.cudnn.deterministic = True
    try:
        reset_counters()
        got = on_gpu.predict(frames, conf=0.25)
        launches = read_counters()
    finally:
        torch.backends.cudnn.deterministic = False
    want = on_cpu.predict(frames, conf=0.25)
    pairs = pair_share(got, want)
    out = {"phase": "q8_fp32", "launches": launches, "quantized_convs": len(on_cpu.quant_act_scales),
           "num_cuda": [len(r) for r in got], "num_cpu": [len(r) for r in want], "pairs": pairs}
    if launches["int8_conv"] < 1 or pairs["seen"] == 0 or pairs["share"] < Q8_PAIRED:
        emit(out)
        raise AssertionError("static8 predict on cuda differs from cpu (or kernel E did not run)")
    return out


def _e_work(args, kw):
    """Bytes kernel E must move (input, weights, scale and bias read once,
    output written once) and its int8 operations (a multiply and an add per
    MAC) at one captured launch."""
    x, w_q, scale, bias = args[:4]
    b, h, w, ci = x.shape
    co, k = w_q.shape[0], w_q.shape[1]
    s = kw.get("stride", 1)
    ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
    nbytes = x.numel() + w_q.numel() + 4 * co * (2 if bias is not None else 1) + b * ho * wo * co
    return nbytes, 2 * b * ho * wo * co * ci * k * k, (b, h, w, ci, co, k, s)


def phase_q8_bf16(report):
    import torch

    import yolo_infer_tpu_torch.models.blocks as blocks_mod
    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.core.validator import YOLO11Validator
    from yolo_infer_tpu_torch.ops.kernels import int8_conv as e_mod
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

    model, spec = report["q8_weights"]
    batch, imgsz = Q8_SERVE
    rng = np.random.default_rng(SEED + 14)
    calib = [rng.integers(0, 256, (8, imgsz, imgsz, 3), dtype=np.uint8) for _ in range(2)]
    frames = rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    base = YOLO11Model.from_params(copy.deepcopy(model), task="detect", size="s", fused=False)  # bf16, cuda
    t0 = time.perf_counter()
    ptq = create_quantizer("ptq", base, {"imgsz": imgsz})
    ptq.set_calibration_data(calib)
    qmodel = ptq.optimize()
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    qpred, bpred = qmodel.predictor, base.predictor
    qpred.predict(frames, conf=0.25, imgsz=imgsz)  # warm-up
    bpred.predict(frames, conf=0.25, imgsz=imgsz)
    torch.cuda.synchronize()

    # the static8 path, once, with counters at 0 and every E input captured;
    # a channel chunk is copied with its pixel pitch, so E reads it as the path did
    seen = []
    e_fn = blocks_mod.int8_conv

    def keep_layout(t):
        return torch.empty_strided(t.size(), t.stride(), dtype=t.dtype, device=t.device).copy_(t)

    def capture(*args, **kw):
        seen.append((tuple(keep_layout(a) if torch.is_tensor(a) else a for a in args), kw))
        return e_fn(*args, **kw)

    blocks_mod.int8_conv = capture
    reset_counters()
    try:
        results = qmodel.predict(frames, conf=0.25, imgsz=imgsz)
    finally:
        blocks_mod.int8_conv = e_fn
    launches = read_counters()
    if launches["int8_conv"] != Q8_E_LAUNCHES or min(launches[k] for k in ("nms_keep", "attention_qkv")) < 1:
        raise AssertionError(f"static8 path launches {launches}, expected {Q8_E_LAUNCHES} of kernel E")
    nums = [len(r) for r in results]
    for r in results:
        if not (np.isfinite(r.boxes).all() and np.isfinite(r.scores).all() and len(r) <= 300):
            raise AssertionError("non-finite or oversized static8 detections")
    timing_q8 = timed_serving(qpred, frames, imgsz)
    timing_bf16 = timed_serving(bpred, frames, imgsz)

    # kernel E at each of its 48 inputs on the path
    per, diff_codes, max_err = [], 0, 0
    bytes_e = ops_e = 0
    e_ms = device_ms_each([lambda a=args, k=kw: e_mod.int8_conv(*a, **k) for args, kw in seen])
    for (args, kw), ms in zip(seen, e_ms):
        got, want = e_mod.int8_conv(*args, **kw), e_mod.int8_conv_reference(*args, **kw)
        d = (got.int() - want.int()).abs()
        diff_codes += int((d > 0).sum())
        max_err = max(max_err, int(d.max()))
        nbytes, ops, shape = _e_work(args, kw)
        bytes_e, ops_e = bytes_e + nbytes, ops_e + ops
        per.append({"shape": list(shape), "epilogue": str(kw.get("epilogue_dtype")),
                    "ms": ms,
                    "call_ms": cuda_ms(lambda: e_mod.int8_conv(*args, **kw), iters=10, warmup=2),
                    "plain_ms": cuda_ms(lambda: e_mod.int8_conv_reference(*args, **kw), iters=2, warmup=1),
                    "bound_ms": 1e3 * max(nbytes / H100_BYTES_PER_S, ops / H100_INT8_OPS)})
    del got, want, d
    if max_err:
        raise AssertionError(f"kernel E differs from its plain version on the static8 path: {diff_codes} codes, "
                             f"up to {max_err}")
    own = [p for p in per if p["shape"][5] == 3 and p["shape"][6] == 1]
    chunks = [args[0] for args, _ in seen if not args[0].is_contiguous()]
    profile = kernel_profile(lambda: qpred.predict(frames, conf=0.25, imgsz=imgsz),
                             named=("int8_conv_kernel", "copy"))
    e_prof = profile["named"]["int8_conv_kernel"]
    # the same path with every E input copied to a contiguous NHWC tensor first, chunks included
    nhwc_input = blocks_mod.nhwc_input
    blocks_mod.nhwc_input = lambda x: x.permute(0, 2, 3, 1).contiguous()
    try:
        copied = kernel_profile(lambda: qpred.predict(frames, conf=0.25, imgsz=imgsz),
                                named=("int8_conv_kernel", "copy"))
    finally:
        blocks_mod.nhwc_input = nhwc_input
    in_place = {"e_inputs_read_in_place": len(chunks), "bytes_not_copied": sum(c.numel() for c in chunks),
                "copy_kernels_in_place": profile["named"]["copy"], "copy_kernels_copied": copied["named"]["copy"],
                "kernel_ms_per_predict_copied": copied["kernel_ms_per_predict"]}
    report["kernels"].append({
        "name": "int8_conv", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/int8_conv.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/int8_conv.py:64", "path": f"yolo11s static8 b{batch} {imgsz} bf16",
        "launches": launches["int8_conv"], "max_abs_err": float(max_err), "codes_differing": diff_codes,
        "ms": e_prof["ms"], "plain_ms": sum(p["plain_ms"] for p in per),
        "call_ms": sum(p["call_ms"] for p in per), "per_launch_ms_sum": sum(p["ms"] for p in per),
        **bound(bytes_e, ops_e, H100_INT8_OPS),
        "library_ms": None, "gb": bytes_e / 1e9, "gmac": ops_e / 2e9,
        "note": "ms, plain_ms and bound_ms are summed over the launches of one predict",
    })
    del seen

    # fidelity: the bf16 model's detections at conf 0.25 are the labels
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_q8_"))
    try:
        labels = bpred.predict(frames, conf=0.25, imgsz=imgsz)
        data = write_val_dataset(root / "data", frames, labels, "detect", spec.nc)
        fid = {}
        for name, m in (("bf16", base), ("static8", qmodel)):
            r = YOLO11Validator(model=m, output_dir=root / name).validate(
                data, imgsz=imgsz, batch=16, conf=0.001, iou=0.45, multi_label=False, verbose=False)
            fid[name] = r["metrics"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"phase": "q8_bf16", "batch": batch, "imgsz": imgsz, "ptq_s": ptq_s,
           "calibration_batches": len(calib), "static8": timing_q8, "bf16": timing_bf16,
           "static8_vs_bf16_img_per_s": timing_q8["img_per_s"] / timing_bf16["img_per_s"],
           "static8_vs_bf16_device_ms": timing_q8["device_ms_per_batch"] / timing_bf16["device_ms_per_batch"],
           "launches": launches, "detections_per_image": [min(nums), max(nums)],
           "labels_per_image": [min(len(r) for r in labels), max(len(r) for r in labels)],
           "e_device_ms_per_predict": e_prof["ms"], "e_launches_profiled": e_prof["calls"],
           "e_call_ms_sum": sum(p["call_ms"] for p in per), "e_bound_ms_sum": report["kernels"][-1]["bound_ms"],
           "e_own_shape": own, "e_per_launch": per, "e_chunk_inputs": in_place, "fidelity": fid,
           "profile": profile}
    if not fid["static8"]["mAP50"] >= 0.9:
        emit(out)
        raise AssertionError(f"static8 fidelity mAP50 {fid['static8']['mAP50']} < 0.9 against the bf16 labels")
    return out


def phase_int8(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.int8_conv import int8_conv, int8_conv_reference

    rng = np.random.default_rng(SEED + 15)
    out = {"phase": "int8", "cases": []}
    for k, stride in ((1, 1), (1, 2), (3, 1), (3, 2)):
        for b, h, w, ci, co, pitch in ((32, 20, 20, 256, 128, 256), (3, 13, 11, 130, 70, 130),
                                       (32, 20, 20, 128, 128, 256), (2, 9, 9, 512, 64, None)):
            if pitch is not None:  # the first ci channels of a (b, h, w, pitch) tensor, read in place
                x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, pitch), dtype=np.int8)).cuda()[..., :ci]
                wq = torch.from_numpy(rng.integers(-127, 128, (co, k, k, ci), dtype=np.int8)).cuda()
                scale = rng.uniform(0.5, 1.5, co) / (127 * 60 * k * np.sqrt(ci))
            else:  # large positive codes: int32 sums in the millions (beyond 2^24 at k = 3: f32 rounds them)
                x = torch.from_numpy(rng.integers(100, 128, (b, h, w, ci), dtype=np.int8)).cuda()
                wq = torch.from_numpy(rng.integers(100, 128, (co, k, k, ci), dtype=np.int8)).cuda()
                scale = rng.uniform(0.5, 1.5, co) / (113.5 ** 2 * k * k * ci)
            scale = torch.from_numpy(scale.astype(np.float32)).cuda()
            bias = torch.from_numpy(rng.normal(0, 0.5, co).astype(np.float32)).cuda()
            for ed in (torch.float32, torch.bfloat16):
                got = int8_conv(x, wq, scale, bias, 1 / 0.02, stride=stride, epilogue_dtype=ed)
                want = int8_conv_reference(x, wq, scale, bias, 1 / 0.02, stride=stride, epilogue_dtype=ed)
                torch.cuda.synchronize()
                d = (got.int() - want.int()).abs()
                case = {"shape": [b, h, w, ci, co], "pitch": pitch, "k": k, "stride": stride, "epilogue": str(ed),
                        "codes_differing": int((d > 0).sum()), "max_code_diff": int(d.max()),
                        "mean_abs_code": float(got.float().abs().mean())}
                out["cases"].append(case)
                if case["max_code_diff"]:
                    emit(out)
                    raise AssertionError(f"kernel E differs from its plain version: {case}")
    return out


def phase_attn_packed(report):
    import torch

    from yolo_infer_tpu_torch.ops.kernels.attention_fused import (
        attention_packed,
        attention_packed_reference,
        attention_qkv,
    )

    rng = np.random.default_rng(SEED + 16)
    out = {"phase": "attn_packed", "cases": []}
    for g, n, dtype, atol, rtol in ((64, 400, torch.bfloat16, 2e-2, 2e-2), (64, 400, torch.float32, 1e-5, 0.0),
                                    (8, 1600, torch.bfloat16, 2e-2, 2e-2)):
        qg = torch.from_numpy(rng.standard_normal((g, n, 128)).astype(np.float32)).cuda().to(dtype)
        got, want = attention_packed(qg, 32, 64), attention_packed_reference(qg, 32, 64)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        out["cases"].append({"G": g, "N": n, "dtype": str(dtype), "max_abs_err": err})
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    # H on a head-major copy of a qkv slab against B reading the slab in place
    slab = torch.from_numpy(rng.standard_normal((32, 400, 256)).astype(np.float32)).cuda().to(torch.bfloat16)
    h_out = attention_packed(slab.view(32, 400, 2, 128).transpose(1, 2).reshape(64, 400, 128), 32, 64)
    b_out = attention_qkv(slab, 2, 32, 64).view(32, 400, 2, 64).transpose(1, 2).reshape(64, 400, 64)
    route_err = float((h_out.float() - b_out.float()).abs().max())
    out["h_vs_b_route"] = {"max_abs_err": route_err, "equal": bool(torch.equal(h_out, b_out))}
    if route_err > 2e-2:
        raise AssertionError(f"H's route differs from B's by {route_err}")
    return out


def phase_attn_pallas(report):
    import torch
    import torch.nn.functional as F

    import yolo_infer_tpu_torch.models.blocks as blocks_mod
    from yolo_infer_tpu_torch.core.predictor import Predictor
    from yolo_infer_tpu_torch.ops.kernels import attention_fused as attn_mod

    model, spec = report["weights"]
    pred = Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
    batch, imgsz = ATTN_SERVE
    frames = np.random.default_rng(SEED + 17).integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8)
    want = pred.predict(frames, conf=0.25, imgsz=imgsz)  # the default route (B)
    seen = {}
    os.environ["YOLO_ATTN_IMPL"] = "pallas"
    try:
        pred.predict(frames, conf=0.25, imgsz=imgsz)  # warm-up
        torch.cuda.synchronize()
        restore = capture_inputs(blocks_mod, "attention_packed", seen)
        reset_counters()
        try:
            got = pred.predict(frames, conf=0.25, imgsz=imgsz)
        finally:
            restore()
        launches = read_counters()
        timing = timed_serving(pred, frames, imgsz)
    finally:
        del os.environ["YOLO_ATTN_IMPL"]
    if launches["attention_packed"] < 1 or launches["attention_qkv"] != 0 or launches["nms_keep"] < 1:
        raise AssertionError(f"the pallas route did not run kernel H alone: {launches}")
    same = all(np.array_equal(g.boxes, w.boxes) and np.array_equal(g.scores, w.scores)
               and np.array_equal(g.classes, w.classes) for g, w in zip(got, want))
    if not same:
        raise AssertionError("the pallas route's Results differ from the default route's")
    qg, kd, hd = seen["attention_packed"]
    g, n, _ = qg.shape
    kernel_h = lambda: attn_mod.attention_packed(qg, kd, hd)  # noqa: E731
    plain_h = lambda: attn_mod.attention_packed_reference(qg, kd, hd)  # noqa: E731
    q, k, v = qg[..., :kd], qg[..., kd:2 * kd], qg[..., 2 * kd:]
    library_h = lambda: F.scaled_dot_product_attention(q, k, v, scale=kd ** -0.5)  # noqa: E731
    got_h, want_h = kernel_h(), plain_h()
    err_h, excess_h = float((got_h.float() - want_h.float()).abs().max()), attn_tol_excess(got_h, want_h)
    if excess_h > 0:
        raise AssertionError(f"kernel H differs from its plain version on the pallas route by {err_h}")
    bytes_h = qg.numel() * qg.element_size() + g * n * hd * qg.element_size()
    flops_h = 2 * g * n * n * (kd + hd)
    report["kernels"].append({
        "name": "attention_packed", "route": "cuda", "source": "yolo_infer_tpu_torch/csrc/attention_fused.cu",
        "replaces": "yolo_infer_tpu/ops/pallas/attention_fused.py:192", "path": f"detect b{batch} {imgsz} bf16 YOLO_ATTN_IMPL=pallas",
        "launches": launches["attention_packed"], "max_abs_err": err_h, "tol_excess": excess_h,
        "ms": device_ms(kernel_h), "plain_ms": device_ms(plain_h),
        **bound(bytes_h, flops_h, H100_BF16_FLOPS),
        "library_ms": device_ms(library_h),
        "call_ms": cuda_ms(kernel_h), "plain_call_ms": cuda_ms(plain_h), "library_call_ms": cuda_ms(library_h),
        "shape": [g, n, qg.shape[-1]], "dtype": str(qg.dtype),
    })
    return {"phase": "attn_pallas", **timing, "launches": launches, "results_equal_default_route": same,
            "detections_per_image": [min(len(r) for r in got), max(len(r) for r in got)]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import yolo_infer_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); run from the repository root",
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False  # f32 convs and products in full f32 (bf16 is unaffected)
    torch.backends.cuda.matmul.allow_tf32 = False

    report = {}
    failed = []
    phases = (phase_card, phase_nms, phase_attn, phase_fp32, phase_bf16, phase_profile,
              phase_rnms, phase_mpack, phase_tasks_fp32, phase_seg_bf16, phase_obb_bf16,
              phase_dfl, phase_gnms, phase_val_fp32, phase_val_bf16, phase_q8_fp32, phase_q8_bf16,
              phase_int8, phase_attn_packed, phase_attn_pallas)
    for phase in phases:
        t0 = time.perf_counter()
        try:
            result = phase(report)
            result["seconds"] = time.perf_counter() - t0
            emit(result)
        except Exception as exc:  # report every phase, then fail the run
            failed.append(phase.__name__)
            emit({"phase": phase.__name__, "ok": False, "error": repr(exc)})
            traceback.print_exc()
            if phase is phase_card:
                break
    if failed or len(report.get("kernels", ())) != 8:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(report["card"])
    order = ("nms_keep", "attention_qkv", "rotated_nms_keep", "upsample4x_threshold_pack", "int8_conv", "dfl_decode",
             "greedy_nms_keep", "attention_packed")
    emit({"kernels": sorted(report["kernels"], key=lambda k: order.index(k["name"]))})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
