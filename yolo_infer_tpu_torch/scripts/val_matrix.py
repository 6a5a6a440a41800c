"""Validation with a confusion matrix: the port's counterpart of `scripts/val_matrix.py`.

    python -m yolo_infer_tpu_torch.scripts.val_matrix yolo11n --data coco128.yaml

Prints the metrics as JSON and the path of `confusion_matrix.txt`, which
`YOLO11Validator.validate(..., confusion_matrix=True)` writes under
`validation_results/`.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Validation with a confusion matrix (the PyTorch port)")
    p.add_argument("model")
    p.add_argument("--data", required=True)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from yolo_infer_tpu_torch.core.validator import YOLO11Validator

    v = YOLO11Validator(model_path=args.model, device=args.device)
    out = v.validate(args.data, imgsz=args.imgsz, batch=args.batch, confusion_matrix=True)
    print(json.dumps(out["metrics"], indent=2))
    print(f"confusion matrix written to {v.output_dir / 'confusion_matrix.txt'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
