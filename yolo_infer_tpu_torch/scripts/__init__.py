"""The repo's `scripts/` as modules of the port, each run with `python -m`.

    scripts/export_dynamic.py  ->  python -m yolo_infer_tpu_torch.scripts.export_dynamic
    scripts/val_matrix.py      ->  python -m yolo_infer_tpu_torch.scripts.val_matrix
    scripts/benchmark.py       ->  python -m yolo_infer_tpu_torch.scripts.benchmark
    scripts/train.py           ->  python -m yolo_infer_tpu_torch.scripts.train
    scripts/model_export.py    ->  python -m yolo_infer_tpu_torch.export

Each takes the JAX script's arguments and prints what it prints, plus
`--device`: the card by default, `--device cpu` on the host. None falls
back to the CPU. The scripts' code paths are the port's modules (the
quantizer, the validator, `YOLO11Model.benchmark`, the trainer); the
scripts only parse, call and print.
"""
