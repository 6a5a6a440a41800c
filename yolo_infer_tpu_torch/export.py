"""Export a model for deployment: the port's counterpart of `scripts/model_export.py`.

    python -m yolo_infer_tpu_torch.export yolo11n --format torchexport --imgsz 640 --batch 1
    python -m yolo_infer_tpu_torch.export weights.pt --format msgpack --output weights.msgpack

`model` is a yolo11[nsmlx](-seg|-cls|-pose|-obb) name (seeded weights), a
native `.msgpack`/`.ckpt` checkpoint or an ultralytics `.pt` file. Formats:

  msgpack      the native fused checkpoint (`YOLO11Model.export`), the JAX
               package's file format
  safetensors  the deploy weights under the JAX package's flat names
  torchexport  the whole serving program with its weights baked in
               (`core/exported.py export_predictor`: a torch.export archive
               that `ExportedPredictor.load` serves without the model code);
               it is bound to the device it was exported on (`--device`,
               the card by default)

The JAX script's `jaxexport` is `torchexport` here; its `stablehlo` text
has no torch counterpart.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Export a YOLO11 model (the PyTorch port)")
    p.add_argument("model", help="model name (.pt/.msgpack path or yolo11[nsmlx] name)")
    p.add_argument("--format", default="msgpack", choices=["msgpack", "safetensors", "torchexport"])
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu; binds a torchexport artifact")
    args = p.parse_args(argv)

    from yolo_infer_tpu_torch.core.model import YOLO11Model

    model = YOLO11Model(args.model, device=args.device)
    if args.format in ("msgpack", "safetensors"):
        out = model.export(args.output, format=args.format)
        print(f"exported {args.format}: {out}")
        return 0
    from yolo_infer_tpu_torch.core.exported import export_predictor

    out = export_predictor(model, args.output or f"{Path(args.model).stem}_b{args.batch}_{args.imgsz}.pt2",
                           batch=args.batch, imgsz=args.imgsz)
    print(f"exported torch.export artifact: {out} ({out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
