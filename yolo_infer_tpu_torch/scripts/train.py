"""QAT fine-tuning: the port's counterpart of `scripts/train.py`.

    python -m yolo_infer_tpu_torch.scripts.train yolo11n.msgpack --data d.yaml --epochs 10

Fine-tunes with fake-quant in the step (`TrainingConfig(qat=True,
lr0=1e-4)`), run under `runs/train/train_from_int8`, and prints the
trainer's summary without its per-epoch history. The model must be an
unfolded (trainable) checkpoint or a model name: a fused deploy checkpoint,
int8 or not, is refused before any step (`core/train_step.py
init_train_state`), as the JAX script cannot train one either (its first
step differentiates the int8 leaves and raises).
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="QAT fine-tuning (the PyTorch port)")
    p.add_argument("model")
    p.add_argument("--data", required=True)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from yolo_infer_tpu_torch.core.model import YOLO11Model
    from yolo_infer_tpu_torch.core.trainer import TrainingConfig, YOLO11Trainer

    model = YOLO11Model(args.model, device=args.device)
    cfg = TrainingConfig(
        data=args.data, epochs=args.epochs, batch=args.batch, imgsz=args.imgsz,
        qat=True, lr0=1e-4, name="train_from_int8",
    )
    out = YOLO11Trainer(model=model, config=cfg, device=args.device).train()
    print(json.dumps({k: v for k, v in out.items() if k != "history"}, indent=2, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
