"""bf16 beside dynamic int8: the port's counterpart of `scripts/benchmark.py`.

    python -m yolo_infer_tpu_torch.scripts.benchmark yolo11n --imgsz 640 --batch 32 --int8

`YOLO11Model.benchmark` of the bf16 model and, with `--int8`, of its
`DynamicQuantizer` model (every quantized conv through the int8 conv
kernel's float epilogue on the card), printed as one JSON object under the
JAX script's keys: `bf16`, `int8_dynamic` and `speedup` (bf16 time over
int8 time).
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="bf16 and dynamic-int8 benchmark (the PyTorch port)")
    p.add_argument("model", nargs="?", default="yolo11n")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--runs", type=int, default=50)
    p.add_argument("--int8", action="store_true", help="also benchmark dynamic-int8")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from yolo_infer_tpu_torch.core.model import YOLO11Model

    model = YOLO11Model(args.model, device=args.device)
    out = {"bf16": model.benchmark(imgsz=args.imgsz, batch=args.batch, runs=args.runs)}
    if args.int8:
        from yolo_infer_tpu_torch.optimization.quantization.quantizers import DynamicQuantizer

        qmodel = DynamicQuantizer(model).optimize()
        out["int8_dynamic"] = qmodel.benchmark(imgsz=args.imgsz, batch=args.batch, runs=args.runs)
        out["speedup"] = out["bf16"]["avg_time_s"] / out["int8_dynamic"]["avg_time_s"]
    print(json.dumps(out, indent=2, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
