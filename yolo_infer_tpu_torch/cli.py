"""The port's command line: `python -m yolo_infer_tpu_torch <command> [options]`.

Port of the JAX package's `main.py` (`YOLO11CLI`): the same six subcommands
(demo, train, val, optimize, benchmark, info) with the same flags, the same
config precedence (a CLI flag, then `--config` merged over
`configs/default.yaml`, then the built-in default; YAML read by the port's
own `utils/yaml_io.py`) and the same exit codes from `run()`: 0 on success,
2 for a missing file (`FileNotFoundError`), 130 for an interrupt and 1 for
any other failure.

Each subcommand also takes `--device`: the card (`cuda`) unless it says
`cpu`. Nothing falls back to the CPU when there is no card. The config's
`model.compute_dtype` (bfloat16 by default, or float32) sets the compute
dtype of the models the commands build.

  demo       an image, a directory of images or a video: MPEG-4 Part 2 in
             MP4, MOV, Matroska or AVI, VP8 in WebM, or motion JPEG in AVI
             (`demos/detection_demo.py`; `--batch` frames a batch, `--output`
             an `.mp4`, `.m4v`, `.mov` or `.mkv` (MPEG-4 Part 2) or an `.avi`
             (motion JPEG)); other video containers and codecs exit 1
             (ROADMAP Queue 1 item 11.2), `.webm` output exits 1 as the JAX
             CLI does (no codec of its chain goes into WebM), and so does a
             camera index (item 11.3)
  val        `YOLO11Validator.validate` (detect, segment, pose, OBB), or
             `evaluate_classifier` on a class-per-directory tree for a
             classify model; `--save-json`
  optimize   `--method ptq` (calibrate on `--data` or on seeded synthetic
             frames, as `main.py` does; the static8 model), `dynamic`,
             `qat` (trains on `--data`), `prune` (`--prune-method`,
             `--sparsity`, `--physical` for channel surgery, a fine-tune on
             `--data` when given) and `distill` (`--teacher`, `--data`;
             without data it exits 2, as `main.py`); each saves its model
  benchmark  `SpeedBenchmark` (sizes, quantization, throughput, all)
  info       the card's name and power limit, system information and the
             port's dependencies
  train      training of every task (`core/trainer.py`), robust by
             default (`core/robust_trainer.py`; `--no-robust` raises instead);
             `--qat` trains with fake-quant; exits 0 only when the run's
             status starts with "completed"
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger("yolo_infer_tpu_torch.cli")

DEFAULT_CONFIG = Path(__file__).resolve().parent.parent / "configs" / "default.yaml"
_DTYPES = ("bfloat16", "float32")


def card_info() -> Dict[str, str]:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints them ({} without nvidia-smi)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return {}
    try:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"nvidia_smi": out} if out else {}


class YOLO11CLI:
    """Command-line interface of the PyTorch port."""

    def __init__(self):
        self.config: Dict[str, Any] = {}

    # ----------------------------------------------------------------- parser

    def setup_argument_parser(self) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(prog="yolo_infer_tpu_torch",
                                    description="YOLO11 inference on one CUDA card (the PyTorch port)")
        p.add_argument("--config", default=None, help="YAML config file (configs/default.yaml schema)")
        p.add_argument("--log-level", default=None, help="DEBUG/INFO/WARNING/ERROR")
        p.add_argument("--log-file", default=None)
        sub = p.add_subparsers(dest="command", required=True)

        d = sub.add_parser("demo", help="run the detection demo on an image, a directory or a video")
        d.add_argument("--input", required=True, help="image path, directory, video path or camera index")
        d.add_argument("--output", default=None,
                       help="annotated image, directory (for a directory input) or video (.mp4, .m4v, .mov: MPEG-4 "
                            "Part 2; .avi: motion JPEG)")
        d.add_argument("--task", default="detect", choices=["detect", "segment", "classify", "pose", "obb"])
        d.add_argument("--model-size", default=None, choices=list("nsmlx"))
        d.add_argument("--model-path", default=None)
        d.add_argument("--conf", type=float, default=None)
        d.add_argument("--iou", type=float, default=None)
        d.add_argument("--imgsz", type=int, default=None)
        d.add_argument("--batch", type=int, default=None, help="video batch size")
        d.add_argument("--display", action="store_true")

        t = sub.add_parser("train", help="train a detect or classify model")
        t.add_argument("--data", required=True, help="dataset yaml")
        t.add_argument("--model-size", default=None, choices=list("nsmlx"))
        t.add_argument("--model-path", default=None, help="checkpoint to start from")
        t.add_argument("--epochs", type=int, default=None)
        t.add_argument("--batch", type=int, default=None)
        t.add_argument("--imgsz", type=int, default=None)
        t.add_argument("--lr0", type=float, default=None)
        t.add_argument("--patience", type=int, default=None)
        t.add_argument("--checkpoint-period", type=int, default=None, dest="save_period")
        t.add_argument("--project", default=None)
        t.add_argument("--name", default=None)
        t.add_argument("--exist-ok", action="store_true")
        t.add_argument("--resume", action="store_true")
        t.add_argument("--no-robust", action="store_true", help="disable error-skipping robust training")
        t.add_argument("--qat", action="store_true", help="quantization-aware training")
        t.add_argument("--seed", type=int, default=None)

        v = sub.add_parser("val", help="validate a model")
        v.add_argument("--data", required=True)
        v.add_argument("--model-path", default=None)
        v.add_argument("--model-size", default=None, choices=list("nsmlx"))
        v.add_argument("--imgsz", type=int, default=None)
        v.add_argument("--batch", type=int, default=None)
        v.add_argument("--conf", type=float, default=None)
        v.add_argument("--iou", type=float, default=None)
        v.add_argument("--save-json", action="store_true")
        v.add_argument("--output-dir", default=None)

        o = sub.add_parser("optimize", help="quantize / prune / distill a model")
        o.add_argument("--model-path", default=None)
        o.add_argument("--model-size", default=None, choices=list("nsmlx"))
        o.add_argument("--method", default=None, choices=["dynamic", "ptq", "qat", "prune", "distill"])
        o.add_argument("--output", default=None)
        o.add_argument("--data", default=None, help="calibration dataset yaml")
        o.add_argument("--imgsz", type=int, default=None)
        o.add_argument("--calibration-batches", type=int, default=None)
        o.add_argument("--sparsity", type=float, default=None, help="prune: target sparsity")
        o.add_argument("--prune-method", default=None, choices=["magnitude", "structured", "unstructured", "gradual"])
        o.add_argument("--physical", action="store_true",
                       help="prune: channel surgery (physically smaller+faster model; implies structured)")
        o.add_argument("--teacher", default=None, help="distill: teacher model name/path")
        o.add_argument("--epochs", type=int, default=None, help="prune fine-tune / distill epochs")

        b = sub.add_parser("benchmark", help="speed benchmarks")
        b.add_argument("--type", default="sizes", choices=["sizes", "quantization", "throughput", "all"])
        b.add_argument("--model-sizes", nargs="+", default=None, choices=list("nsmlx"))
        b.add_argument("--image-sizes", nargs="+", type=int, default=None)
        b.add_argument("--batch-sizes", nargs="+", type=int, default=None)
        b.add_argument("--runs", type=int, default=None)
        b.add_argument("--duration", type=float, default=None)
        b.add_argument("--output-dir", default=None)

        sub.add_parser("info", help="show the card, system and dependencies")
        for parser in sub.choices.values():
            parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                                help="cuda (the default: the card) or cpu")
        return p

    # ----------------------------------------------------------------- config

    def load_configuration(self, path: Optional[str]) -> Dict[str, Any]:
        from yolo_infer_tpu_torch.utils.helpers import load_config, merge_configs

        cfg: Dict[str, Any] = load_config(DEFAULT_CONFIG) if DEFAULT_CONFIG.exists() else {}
        if path:
            cfg = merge_configs(cfg, load_config(path))
        self.config = cfg
        return cfg

    def _cfg(self, *keys, default=None):
        node: Any = self.config
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                return default
            node = node[k]
        return node

    @staticmethod
    def _pick(cli_value, cfg_value, default):
        """CLI flag > config file > built-in default."""
        if cli_value is not None:
            return cli_value
        if cfg_value is not None:
            return cfg_value
        return default

    def _dtype(self):
        import torch

        name = self._cfg("model", "compute_dtype", default="bfloat16")
        if name not in _DTYPES:
            raise ValueError(f"model.compute_dtype {name!r}: expected one of {_DTYPES}")
        return getattr(torch, name)

    def _model_path(self, args) -> str:
        return args.model_path or f"yolo11{self._pick(args.model_size, self._cfg('model', 'size'), 'n')}"

    def _model(self, args):
        from yolo_infer_tpu_torch.core.model import YOLO11Model

        return YOLO11Model(self._model_path(args), device=args.device, compute_dtype=self._dtype())

    # --------------------------------------------------------------- commands

    def run_demo(self, args) -> int:
        from yolo_infer_tpu_torch.demos.detection_demo import DetectionDemo

        demo = DetectionDemo(
            model_size=self._pick(args.model_size, self._cfg("model", "size"), "n"),
            model_path=args.model_path,
            device=args.device,
            conf_threshold=self._pick(args.conf, self._cfg("demo", "conf_threshold"), 0.5),
            iou_threshold=self._pick(args.iou, self._cfg("demo", "iou_threshold"), 0.45),
            imgsz=self._pick(args.imgsz, self._cfg("inference", "imgsz"), 640),
            task=args.task,
            compute_dtype=self._dtype(),
        )
        out = demo.run_source(args.input, args.output, display=args.display,
                              batch_size=self._pick(args.batch, self._cfg("demo", "video_batch_size"), 8))
        print(json.dumps(out, indent=2, default=str))
        return 0

    def run_training(self, args) -> int:
        from yolo_infer_tpu_torch.core.robust_trainer import create_robust_trainer
        from yolo_infer_tpu_torch.core.trainer import TrainingConfig, create_trainer

        tcfg = self._cfg("training", default={}) or {}
        cfg = TrainingConfig(
            data=args.data,
            epochs=self._pick(args.epochs, tcfg.get("epochs"), 100),
            batch=self._pick(args.batch, tcfg.get("batch"), 16),
            imgsz=self._pick(args.imgsz, tcfg.get("imgsz"), 640),
            lr0=self._pick(args.lr0, tcfg.get("lr0"), 0.01),
            patience=self._pick(args.patience, tcfg.get("patience"), 50),
            save_period=self._pick(args.save_period, tcfg.get("save_period"), -1),
            project=self._pick(args.project, None, "runs/train"),
            name=self._pick(args.name, None, "exp"),
            exist_ok=args.exist_ok,
            resume=args.resume,
            qat=args.qat,
            seed=self._pick(args.seed, tcfg.get("seed"), 0),
        )
        model_path = self._model_path(args)
        model = self._model(args)
        # robust (error-skipping) by default, as main.py
        if args.no_robust:
            trainer = create_trainer(model_path=model_path, config=cfg, model=model)
        else:
            trainer = create_robust_trainer(model_path=model_path, config=cfg, skip_errors=True, model=model)
        result = trainer.train()
        print(json.dumps({k: v for k, v in result.items() if k not in ("history", "traceback")}, indent=2,
                         default=str))
        return 0 if result.get("status", "").startswith("completed") else 1

    def run_validation(self, args) -> int:
        vcfg = self._cfg("validation", default={}) or {}
        imgsz = self._pick(args.imgsz, vcfg.get("imgsz"), 640)
        batch = self._pick(args.batch, vcfg.get("batch"), 16)
        model = self._model(args)
        if model.task == "classify":
            from yolo_infer_tpu_torch.data.classify import ClassifyDataset, evaluate_classifier

            result = evaluate_classifier(model, ClassifyDataset(args.data, "val"), imgsz=imgsz, batch=batch)
            print(json.dumps(result, indent=2, default=float))
            return 0
        from yolo_infer_tpu_torch.core.validator import YOLO11Validator

        v = YOLO11Validator(
            model=model,
            output_dir=self._pick(args.output_dir, self._cfg("paths", "validation_dir"), "validation_results"),
            device=args.device,
        )
        result = v.validate(
            args.data,
            imgsz=imgsz,
            batch=batch,
            conf=self._pick(args.conf, vcfg.get("conf_threshold"), 0.001),
            iou=self._pick(args.iou, vcfg.get("iou_threshold"), 0.6),
            save_json=args.save_json or bool(vcfg.get("save_json")),
        )
        print(json.dumps({k: v2 for k, v2 in result.items() if k != "per_class_ap50"}, indent=2, default=float))
        return 0

    def run_optimization(self, args) -> int:
        from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

        qcfg = self._cfg("optimization", "quantization", default={}) or {}
        method = self._pick(args.method, qcfg.get("method"), "ptq")
        model_path = self._model_path(args)
        imgsz = self._pick(args.imgsz, self._cfg("inference", "imgsz"), 640)
        model = self._model(args)
        if method == "prune":
            from yolo_infer_tpu_torch.optimization.pruning import create_pruner

            pcfg = self._cfg("optimization", "pruning", default={}) or {}
            physical = args.physical or bool(pcfg.get("physical", False))
            optimizer = create_pruner(model, {
                # physical surgery implies structured, from the flag or the config key
                "method": "structured" if physical else self._pick(args.prune_method, pcfg.get("method"),
                                                                   "magnitude"),
                "sparsity": self._pick(args.sparsity, pcfg.get("sparsity"), 0.5),
                "physical": physical,
            })
            optimizer.optimize(data=args.data, **({"epochs": args.epochs} if args.epochs else {}))
            out = args.output or f"{Path(model_path).stem}_pruned.msgpack"
        elif method == "distill":
            from yolo_infer_tpu_torch.optimization.distillation import create_distiller

            if not args.data:
                print("distill requires --data", file=sys.stderr)
                return 2
            dcfg = self._cfg("optimization", "distillation", default={}) or {}
            optimizer = create_distiller(model, {
                "teacher": args.teacher or dcfg.get("teacher"),
                "temperature": dcfg.get("temperature", 4.0),
                "alpha": dcfg.get("alpha", 0.7),
            })
            optimizer.optimize(data=args.data, epochs=args.epochs or 10, imgsz=imgsz)
            out = args.output or f"{Path(model_path).stem}_distilled.msgpack"
        else:
            optimizer = create_quantizer(method, model, {"imgsz": imgsz, "data": args.data})
            if method == "ptq":
                n_batches = self._pick(args.calibration_batches, qcfg.get("num_calibration_batches"), 100)
                optimizer.set_calibration_data(self._calibration_batches(args.data, imgsz, n_batches))
                optimizer.optimize()
            elif method == "qat":
                optimizer.optimize(data=args.data)
            else:
                optimizer.optimize()
            out = args.output or f"{Path(model_path).stem}_{method}.msgpack"
        path = optimizer.save_optimized_model(out)
        print(json.dumps({"saved": str(path), **optimizer.get_optimization_info()}, indent=2, default=float))
        return 0

    def _calibration_batches(self, data: Optional[str], imgsz: int, n: int) -> List:
        import numpy as np

        if data:
            try:
                from yolo_infer_tpu_torch.data.dataset import YOLODataset

                ds = YOLODataset(data, split="train")
                return [b["images"] for _, b in zip(range(n), ds.iter_val_batches(batch_size=4, imgsz=imgsz))]
            except (FileNotFoundError, ValueError) as e:
                logger.warning("calibration dataset unavailable (%s); using synthetic data", e)
        rng = np.random.default_rng(0)
        # seeded synthetic calibration frames, as the JAX package's CLI makes them
        return [rng.integers(0, 255, (4, imgsz, imgsz, 3), dtype=np.uint8) for _ in range(min(n, 16))]

    def run_benchmark(self, args) -> int:
        from yolo_infer_tpu_torch.benchmarks.speed_benchmark import SpeedBenchmark

        bcfg = self._cfg("benchmark", default={}) or {}
        bench = SpeedBenchmark(
            output_dir=self._pick(args.output_dir, self._cfg("paths", "benchmark_dir"), "benchmark_results"),
            benchmark_runs=self._pick(args.runs, bcfg.get("benchmark_runs"), 100),
            warmup_runs=bcfg.get("warmup_runs", 10),
            device=args.device,
        )
        sizes = self._pick(args.model_sizes, None, ["n"])
        image_sizes = self._pick(args.image_sizes, bcfg.get("image_sizes"), [640])
        batch_sizes = self._pick(args.batch_sizes, bcfg.get("batch_sizes"), [1, 32])
        if args.type in ("sizes", "all"):
            bench.benchmark_model_sizes(sizes, image_sizes, batch_sizes)
        if args.type in ("quantization", "all"):
            bench.benchmark_quantization(sizes[0], image_sizes[0])
        if args.type in ("throughput", "all"):
            bench.benchmark_throughput(sizes[0], image_sizes[0],
                                       duration_s=self._pick(args.duration, bcfg.get("duration_s"), 30.0))
        print(bench.generate_report())
        return 0

    def show_system_info(self, args) -> int:
        from yolo_infer_tpu_torch.utils.helpers import check_dependencies, get_system_info

        info = {**card_info(), **get_system_info()}
        info["dependencies"] = check_dependencies()
        print(json.dumps(info, indent=2, default=str))
        return 0

    # -------------------------------------------------------------------- run

    def run(self, argv: Optional[List[str]] = None) -> int:
        parser = self.setup_argument_parser()
        args = parser.parse_args(argv)
        from yolo_infer_tpu_torch.utils.helpers import setup_logging

        handlers = {
            "demo": self.run_demo,
            "train": self.run_training,
            "val": self.run_validation,
            "optimize": self.run_optimization,
            "benchmark": self.run_benchmark,
            "info": self.show_system_info,
        }
        self.load_configuration(args.config)
        setup_logging(
            level=args.log_level or self._cfg("logging", "level", default="INFO"),
            log_file=args.log_file or self._cfg("logging", "log_file"),
        )
        try:
            return handlers[args.command](args)
        except KeyboardInterrupt:
            logger.error("interrupted")
            return 130
        except FileNotFoundError as e:
            logger.error("not found: %s", e)
            return 2
        except Exception as e:  # noqa: BLE001 -- the CLI's exit-code contract
            logger.exception("command failed: %s", e)
            return 1


def main(argv: Optional[List[str]] = None) -> int:
    return YOLO11CLI().run(argv)


if __name__ == "__main__":
    sys.exit(main())
