"""Live detect serving on one card, for the checkouts given, in turns.

    python tests/torch_capture_ab.py ROOT_A ROOT_B ROOT_B ROOT_A

Each ROOT is a checkout of this repository (for example a parent commit
unpacked with `git archive` into a directory that .gitignore lists); each
argument runs in a fresh process that imports `yolo_infer_tpu_torch` from
that ROOT (its kernels build there), so two versions of the live
`Predictor` compare on one card in one call. Card only (exits 2 without a
card). One JSON line per run:

- `predict_raw` of yolo11n detect bf16 (seeded weights) at b32/640 and
  b1/640 on frames already on the card: the host ms until the call
  returns, and the host-clock ms per call, each after a synchronise
  (medians of 20);
- `predict` at b32/640, numpy frames to Results (median of 20);
- yolo11n segment bf16 (seeded weights, mask_mode "device") at b32/640:
  `predict_raw` on frames on the card and `predict` from numpy frames
  (medians of 10), at conf 0.25 and at conf 1e-4 (where the seeded weights
  fill most of the max_det rows), with the detections per image;
- `predict_many` over 150 frames at batch_size 32 (median of 3), and where
  its host time goes per chunk: the main thread waiting for the staging
  thread (`Future.result`), in `predict_raw`, waiting for the card
  (`Event.synchronize` at the drain) and building Results
  (`Predictor._postprocess`), and the staging thread's `np.stack` of a
  chunk and its wait for an upload (all host clock, summed over a run, per
  chunk; "(staging thread)" marks what that thread spent).

The card's name and power limit (nvidia-smi) are in every line.
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

FRAMES = 150
BATCH = 32


def _median_ms(fn, sync, calls: int = 20):
    host, total = [], []
    for _ in range(calls):
        sync()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        sync()
        host.append(t1 - t0)
        total.append(time.perf_counter() - t0)
    return {"host_ms": 1e3 * float(np.median(host)), "ms_per_call": 1e3 * float(np.median(total))}


class _Clock:
    """Host seconds spent inside some functions, by name, while `on`."""

    def __init__(self):
        self.s, self.lock, self.on = {}, threading.Lock(), False

    def wrap(self, name, fn):
        def timed(*a, **k):
            if not self.on:
                return fn(*a, **k)
            key = name if threading.current_thread() is threading.main_thread() else f"{name} (staging thread)"
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                with self.lock:
                    self.s[key] = self.s.get(key, 0.0) + time.perf_counter() - t0
        return timed


def run(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve()))
    import concurrent.futures

    import torch

    import yolo_infer_tpu_torch
    import yolo_infer_tpu_torch.core.predictor as pm
    from yolo_infer_tpu_torch.models.yolo11 import build_model

    assert Path(yolo_infer_tpu_torch.__file__).resolve().is_relative_to(Path(root).resolve())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    model, spec = build_model("detect", "n", seed=0)
    pred = pm.Predictor(model, spec, device="cuda", compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (BATCH, 640, 640, 3), dtype=np.uint8)
    many = list(rng.integers(0, 256, (FRAMES, 640, 640, 3), dtype=np.uint8))
    dev = torch.from_numpy(frames).cuda()
    one = dev[:1].contiguous()
    sync = torch.cuda.synchronize
    out = {"root": root, "card": card, "torch": torch.__version__,
           "program_cache": hasattr(pred, "_cache")}
    for _ in range(3):  # kernel builds, cuDNN plans and, where there is a cache, the captures
        pred.predict_raw(dev, 0.25, 0.45, 640)
        pred.predict_raw(one, 0.25, 0.45, 640)
        pred.predict(frames, conf=0.25)
    pred.predict_many(many[:64], conf=0.25, batch_size=BATCH)
    sync()
    out["predict_raw_b32"] = _median_ms(lambda: pred.predict_raw(dev, 0.25, 0.45, 640), sync)
    out["predict_raw_b1"] = _median_ms(lambda: pred.predict_raw(one, 0.25, 0.45, 640), sync)
    out["predict_b32"] = _median_ms(lambda: pred.predict(frames, conf=0.25), sync)
    out["predict_b32"]["img_per_s"] = 1e3 * BATCH / out["predict_b32"]["ms_per_call"]
    seg_model, seg_spec = build_model("segment", "n", seed=0)
    seg = pm.Predictor(seg_model, seg_spec, device="cuda", compute_dtype=torch.bfloat16, mask_mode="device")
    for conf in (0.25, 1e-4):
        for _ in range(3):
            got = seg.predict(frames, conf=conf)
        row = {"detections_per_image": [min(len(r) for r in got), max(len(r) for r in got)],
               "predict_raw": _median_ms(lambda: seg.predict_raw(dev, conf, 0.45, 640), sync, calls=10),
               "predict": _median_ms(lambda: seg.predict(frames, conf=conf), sync, calls=10)}
        row["predict"]["img_per_s"] = 1e3 * BATCH / row["predict"]["ms_per_call"]
        out[f"segment_b32_conf{conf:g}"] = row
    del seg, got
    times = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        pred.predict_many(many, conf=0.25, batch_size=BATCH)
        times.append(time.perf_counter() - t0)
    out["predict_many"] = {"img_per_s": FRAMES / float(np.median(times)), "s": times}

    clock = _Clock()
    chunks = -(-FRAMES // BATCH)
    patches = [(concurrent.futures.Future, "result", "wait_for_staging"),
               (pm.Predictor, "predict_raw", "predict_raw"),
               (torch.cuda.Event, "synchronize", "wait_for_card"),
               (pm.Predictor, "_postprocess", "results")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    stack = np.stack
    for obj, attr, name in patches:
        setattr(obj, attr, clock.wrap(name, getattr(obj, attr)))
    np.stack = clock.wrap("stack", stack)
    try:
        clock.on = True
        sync()
        t0 = time.perf_counter()
        pred.predict_many(many, conf=0.25, batch_size=BATCH)
        wall = time.perf_counter() - t0
        clock.on = False
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
        np.stack = stack
    out["predict_many_parts_ms_per_chunk"] = {"wall": 1e3 * wall / chunks,
                                              **{k: 1e3 * v / chunks for k, v in clock.s.items()}}
    return out


def main() -> int:
    if len(sys.argv) == 2 and not sys.argv[1].startswith("-"):
        import torch

        if not torch.cuda.is_available():
            print("torch_capture_ab: no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps(run(sys.argv[1])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in sys.argv[1:]:  # each in its own process: two package versions cannot share one
        rc |= subprocess.run([sys.executable, __file__, root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
