"""Dynamic-int8 export: the port's counterpart of `scripts/export_dynamic.py`.

    python -m yolo_infer_tpu_torch.scripts.export_dynamic yolo11n --output yolo11n_int8.msgpack

Per-output-channel int8 weights whose activation scales are taken on the
device at every call (`DynamicQuantizer`), saved as a fused native
checkpoint, the JAX package's file format, with `<output stem>.info.json`
beside it. The default output is `{model}_dynamic_int8.msgpack`.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Dynamic-int8 export (the PyTorch port)")
    p.add_argument("model")
    p.add_argument("--output", default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.optimization.quantization.quantizers import DynamicQuantizer, QuantizationUtils

    model = YOLO11Model(args.model, device=args.device)
    q = DynamicQuantizer(model)
    q.optimize()
    out = q.save_optimized_model(args.output or f"{args.model}_dynamic_int8.msgpack")
    sizes = QuantizationUtils.compare_model_sizes(model, q.optimized_model)
    print(f"saved {out}; compression {sizes['compression_ratio']:.2f}x "
          f"({sizes['original_mb']:.1f} -> {sizes['quantized_mb']:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
