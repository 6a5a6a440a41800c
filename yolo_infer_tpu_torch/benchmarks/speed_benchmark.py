"""SpeedBenchmark: latency, throughput and quantization sweeps.

Port of `yolo_infer_tpu/benchmarks/speed_benchmark.py`: `benchmark_model_sizes`
(model size x imgsz x batch), `benchmark_quantization` (the bf16 model
against its int8 variants), `benchmark_throughput` (a duration-bound loop
with a `ResourceMonitor` beside it) and the text report. Every time comes
from `YOLO11Model.benchmark` or is read after `torch.cuda.synchronize`,
so it is the device's, not the enqueue's.

Run on the card (the default device) or, for a smoke test, on the CPU:

    python -m yolo_infer_tpu_torch.benchmarks.speed_benchmark --type all --output-dir /tmp/bench
    python -m yolo_infer_tpu_torch.benchmarks.speed_benchmark --device cpu --image-sizes 64 --batch-sizes 1 --runs 2

The JSON files and the report go to `--output-dir` (default
`benchmark_results/`, which git ignores).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from yolo_infer_tpu_torch.core.model import YOLO11Model
from yolo_infer_tpu_torch.utils.helpers import ResourceMonitor, device_busy

logger = logging.getLogger(__name__)


class SpeedBenchmark:
    """Inference performance measurement harness."""

    def __init__(
        self,
        output_dir: Union[str, Path] = "benchmark_results",
        warmup_runs: int = 10,
        benchmark_runs: int = 100,
        device: Optional[str] = None,
    ):
        self.output_dir = Path(output_dir)
        self.warmup_runs = warmup_runs
        self.benchmark_runs = benchmark_runs
        self.device = device
        self.results: Dict[str, Any] = {}

    # ------------------------------------------------------------- model sweep

    def benchmark_model_sizes(
        self,
        model_sizes: Sequence[str] = ("n", "s", "m"),
        image_sizes: Sequence[int] = (320, 640),
        batch_sizes: Sequence[int] = (1, 8, 32),
    ) -> Dict[str, Any]:
        """`YOLO11Model.benchmark` over model size x imgsz x batch; a setting
        that fails (out of memory) is recorded as an error entry."""
        results: Dict[str, Any] = {}
        for size in model_sizes:
            model = YOLO11Model(f"yolo11{size}", device=self.device)
            for imgsz in image_sizes:
                for batch in batch_sizes:
                    key = f"yolo11{size}_imgsz{imgsz}_batch{batch}"
                    logger.info("benchmarking %s", key)
                    try:
                        r = model.benchmark(imgsz=imgsz, batch=batch, runs=self.benchmark_runs,
                                            warmup=self.warmup_runs)
                        results[key] = r
                        logger.info("%s: %.1f imgs/s", key, r["throughput_imgs_per_s"])
                    except Exception as e:  # noqa: BLE001 -- the sweep survives a setting that fails
                        logger.warning("%s failed: %s", key, e)
                        results[key] = {"error": str(e)}
        self.results["model_sizes"] = results
        self._save_json("model_sizes_benchmark.json", results)
        return results

    # ----------------------------------------------------------- quantization

    def benchmark_quantization(
        self,
        model_size: str = "n",
        imgsz: int = 640,
        batch: int = 32,
        methods: Sequence[str] = ("dynamic", "ptq"),
    ) -> Dict[str, Any]:
        """The model in its compute dtype against its int8 variants, with the
        speedup of each. "ptq" calibrates on 8 seeded batches and serves
        static8 (kernel E on the card); "dynamic" serves every quantized conv
        through kernel E's float epilogue. A method that fails is recorded as
        an error entry."""
        from yolo_infer_tpu_torch.optimization.quantization.quantizers import create_quantizer

        model = YOLO11Model(f"yolo11{model_size}", device=self.device)
        base = model.benchmark(imgsz=imgsz, batch=batch, runs=self.benchmark_runs, warmup=self.warmup_runs)
        results: Dict[str, Any] = {"fp_baseline": base}
        for method in methods:
            try:
                q = create_quantizer(method, model, {"imgsz": imgsz})
                if method == "ptq":
                    rng = np.random.default_rng(0)
                    q.set_calibration_data([rng.integers(0, 255, (batch, imgsz, imgsz, 3), dtype=np.uint8)
                                            for _ in range(8)])
                qmodel = q.optimize()
                r = qmodel.benchmark(imgsz=imgsz, batch=batch, runs=self.benchmark_runs, warmup=self.warmup_runs)
                r["speedup"] = base["avg_time_s"] / r["avg_time_s"]
                results[method] = r
                logger.info("%s: %.2fx speedup", method, r["speedup"])
            except Exception as e:  # noqa: BLE001 -- one method's failure is its result
                logger.warning("quantization %s failed: %s", method, e)
                results[method] = {"error": str(e)}
        self.results["quantization"] = results
        self._save_json("quantization_benchmark.json", results)
        return results

    # ------------------------------------------------------------- throughput

    def benchmark_throughput(
        self,
        model_size: str = "n",
        imgsz: int = 640,
        batch: int = 32,
        duration_s: float = 60.0,
    ) -> Dict[str, Any]:
        """`predict_raw` back to back on one seeded batch for `duration_s`,
        with a synchronisation every 50 batches to bound the queue, and a
        `ResourceMonitor` sampling once a second beside it. Each window of
        up to 50 batches and its synchronisation counts as device-busy."""
        model = YOLO11Model(f"yolo11{model_size}", device=self.device)
        predictor = model.predictor
        cuda = predictor.device.type == "cuda"
        rng = np.random.default_rng(0)
        images = torch.from_numpy(rng.integers(0, 255, (batch, imgsz, imgsz, 3), dtype=np.uint8)).to(predictor.device)

        def sync():
            if cuda:
                torch.cuda.synchronize(predictor.device)

        predictor.predict_raw(images, 0.25, 0.45, imgsz)  # kernel builds, cuDNN's search, the graph's capture
        sync()
        monitor = ResourceMonitor(interval=1.0)
        monitor.start()
        n = 0
        try:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < duration_s:
                with device_busy():
                    for _ in range(50):
                        predictor.predict_raw(images, 0.25, 0.45, imgsz)
                        n += batch
                        if time.perf_counter() - t0 >= duration_s:
                            break
                    sync()  # bounds the queue depth
            elapsed = time.perf_counter() - t0
        finally:
            resources = monitor.stop()
        result = {
            "images_processed": n,
            "duration_s": elapsed,
            "throughput_imgs_per_s": n / elapsed,
            "device": torch.cuda.get_device_name(predictor.device) if cuda else "cpu",
            "resources": resources,
        }
        self.results["throughput"] = result
        self._save_json("throughput_benchmark.json", result)
        monitor.save(self.output_dir / "resource_history.json")
        return result

    # --------------------------------------------------------------- reports

    def generate_report(self) -> str:
        """Every `*_benchmark.json` of the output directory as a text report
        (also written to `benchmark_report.txt` there)."""
        lines = ["YOLO11 Benchmark Report", "=" * 50, ""]
        for path in sorted(self.output_dir.glob("*_benchmark.json")):
            lines.append(path.stem.replace("_", " ").title())
            lines.append("-" * 40)
            lines.extend(self._fmt(json.loads(path.read_text()), indent=1))
            lines.append("")
        report = "\n".join(lines)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        (self.output_dir / "benchmark_report.txt").write_text(report)
        return report

    def _fmt(self, d: Dict[str, Any], indent: int = 0) -> List[str]:
        out = []
        pad = "  " * indent
        for k, v in d.items():
            if isinstance(v, dict):
                out.append(f"{pad}{k}:")
                out.extend(self._fmt(v, indent + 1))
            elif isinstance(v, float):
                out.append(f"{pad}{k}: {v:.4f}")
            else:
                out.append(f"{pad}{k}: {v}")
        return out

    def _save_json(self, name: str, data: Any) -> None:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        (self.output_dir / name).write_text(json.dumps(data, indent=2, default=float))


def main(argv: Optional[List[str]] = None) -> int:
    """Command line: `python -m yolo_infer_tpu_torch.benchmarks.speed_benchmark --help`."""
    import argparse

    p = argparse.ArgumentParser(description="YOLO11 speed benchmark (the PyTorch port)")
    p.add_argument("--type", default="sizes", choices=["sizes", "quantization", "throughput", "all"])
    p.add_argument("--model-sizes", nargs="+", default=["n"], choices=list("nsmlx"))
    p.add_argument("--image-sizes", nargs="+", type=int, default=[640])
    p.add_argument("--batch-sizes", nargs="+", type=int, default=[1, 32])
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--runs", type=int, default=100)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    p.add_argument("--output-dir", default="benchmark_results")
    args = p.parse_args(argv)

    bench = SpeedBenchmark(output_dir=args.output_dir, warmup_runs=args.warmup, benchmark_runs=args.runs,
                           device=args.device)
    if args.type in ("sizes", "all"):
        bench.benchmark_model_sizes(args.model_sizes, args.image_sizes, args.batch_sizes)
    if args.type in ("quantization", "all"):
        bench.benchmark_quantization(args.model_sizes[0], args.image_sizes[0], args.batch_sizes[-1])
    if args.type in ("throughput", "all"):
        bench.benchmark_throughput(args.model_sizes[0], args.image_sizes[0], args.batch_sizes[-1],
                                   duration_s=args.duration)
    print(bench.generate_report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
