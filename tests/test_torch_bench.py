"""The port's timing surface on the CPU: `YOLO11Model.benchmark` (the JAX
package's keys), `SpeedBenchmark` and its command line writing into a
temporary directory, the timing helpers of `optimization/`, and
`utils/helpers.py` (`ResourceMonitor` and `get_system_info` with `psutil`
blocked: the port reads /proc). Times here are the CPU's and say nothing of
the card; these tests check keys, counts and files.
"""

import ast
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from yolo_infer_tpu_torch.benchmarks import speed_benchmark
from yolo_infer_tpu_torch.benchmarks.speed_benchmark import SpeedBenchmark
from yolo_infer_tpu_torch.core.model import YOLO11Model
from yolo_infer_tpu_torch.optimization.quantization.quantizers import QuantizationUtils, create_quantizer
from yolo_infer_tpu_torch.utils import helpers
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = Path(__file__).resolve().parent.parent


def _jax_benchmark_keys():
    """The keys of the dict that the JAX package's `YOLO11Model.benchmark` returns (read from its source)."""
    tree = ast.parse((REPO / "yolo_infer_tpu" / "core" / "model.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "benchmark")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)][-1]
    return {k.value for k in ret.value.keys}


@pytest.fixture(scope="module")
def model():
    return YOLO11Model("yolo11n", device="cpu", nc=3, compute_dtype=torch.float32)


def test_benchmark_returns_the_jax_keys(model, tmp_path):
    keys = _jax_benchmark_keys()
    assert {"avg_time_s", "std_time_s", "window_avgs_ms", "latency_s", "fps", "compile_time_s"} <= keys
    out = model.benchmark(imgsz=64, batch=1, runs=2, warmup=1, profile_dir=str(tmp_path / "trace"))
    assert keys <= set(out) and out["device"] == "cpu"
    assert out["runs"] == 2 and len(out["window_avgs_ms"]) == 1 and out["batch"] == 1 and out["imgsz"] == 64
    assert out["fps"] == out["throughput_imgs_per_s"] == pytest.approx(1 / out["avg_time_s"])
    assert 0 < out["min_time_s"] <= out["latency_s"] <= out["max_time_s"] and out["compile_time_s"] > 0
    assert "traceEvents" in json.loads((tmp_path / "trace" / "benchmark_trace.json").read_text())
    assert len(model.benchmark(imgsz=64, batch=2, runs=6, warmup=0)["window_avgs_ms"]) == 3


def test_speed_benchmark_sweeps_and_report(tmp_path):
    bench = SpeedBenchmark(output_dir=tmp_path, warmup_runs=1, benchmark_runs=2, device="cpu")
    sizes = bench.benchmark_model_sizes(("n",), (64,), (1, 2))
    assert set(sizes) == {"yolo11n_imgsz64_batch1", "yolo11n_imgsz64_batch2"}
    assert all(r["throughput_imgs_per_s"] > 0 for r in sizes.values())
    quant = bench.benchmark_quantization("n", imgsz=64, batch=1)
    assert "not ported" in quant["dynamic"]["error"]  # dynamic int8 is a recorded failure
    assert quant["ptq"]["speedup"] > 0 and quant["fp_baseline"]["batch"] == 1
    thr = bench.benchmark_throughput("n", imgsz=64, batch=1, duration_s=1.2)
    assert thr["images_processed"] >= 1 and thr["resources"]["samples"] >= 1
    assert "max_memory_percent" in thr["resources"] and "max_device_util_percent" in thr["resources"]
    report = bench.generate_report()
    for name in ("model_sizes", "quantization", "throughput"):
        assert (tmp_path / f"{name}_benchmark.json").exists()
        assert name.replace("_", " ").title() in report
    assert (tmp_path / "benchmark_report.txt").read_text() == report
    assert json.loads((tmp_path / "resource_history.json").read_text())["summary"]["samples"] >= 1


def test_speed_benchmark_command_line(tmp_path, capsys):
    assert speed_benchmark.main(["--device", "cpu", "--image-sizes", "64", "--batch-sizes", "1", "--runs", "2",
                                 "--warmup", "1", "--output-dir", str(tmp_path)]) == 0
    assert "Model Sizes Benchmark" in capsys.readouterr().out
    assert set(json.loads((tmp_path / "model_sizes_benchmark.json").read_text())) == {"yolo11n_imgsz64_batch1"}


def test_optimization_timing_helpers(model):
    q = create_quantizer("ptq", model, {"imgsz": 64})
    q.set_calibration_data([np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)])
    qmodel = q.optimize()
    speed = QuantizationUtils.benchmark_inference_speed(model, qmodel, imgsz=64, batch=1, runs=2)
    assert speed["speedup"] == pytest.approx(speed["original"]["avg_time_s"] / speed["quantized"]["avg_time_s"])
    assert q.evaluate(imgsz=64, batch=1)["batch"] == 1  # no dataset: its speed
    cmp = q.compare_models(imgsz=64, batch=1, runs=2)
    assert cmp["compression_ratio"] > 3 and cmp["speedup"] > 0


def test_resource_monitor_and_system_info_without_psutil(monkeypatch):
    monkeypatch.setitem(sys.modules, "psutil", None)  # any import of psutil raises
    mon = helpers.ResourceMonitor(interval=0.05)
    mon.start()
    with helpers.device_busy():
        sum(range(200_000))
    summary = mon.stop()
    assert summary["samples"] >= 1 and not mon._thread.is_alive()
    for key in ("cpu_percent", "memory_percent", "memory_used_gb", "device_util_percent"):
        assert f"avg_{key}" in summary and f"max_{key}" in summary
    assert 0 <= summary["max_cpu_percent"] <= 100 and 0 < summary["max_memory_percent"] < 100
    info = helpers.get_system_info()
    assert info["memory_total_gb"] > 0 and 0 <= info["cpu_percent"] <= 100
    assert info["cuda_available"] is torch.cuda.is_available() and info["device_busy_events"] >= 1


def test_formatting_and_timer():
    assert helpers.format_time(2e-4) == "200.0us" and helpers.format_time(0.25) == "250.0ms"
    assert helpers.format_time(75) == "1m15s" and helpers.format_time(7300) == "2h1m"
    assert helpers.format_bytes(1536) == "1.5KB" and helpers.format_bytes(3 * 1024 ** 3) == "3.0GB"
    with helpers.Timer("x", sync={"a": torch.ones(2)}) as t:
        pass
    assert t.elapsed >= 0
