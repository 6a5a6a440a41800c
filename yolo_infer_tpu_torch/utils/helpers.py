"""Device and system information, a resource monitor, timing and formatting.

Port of `yolo_infer_tpu/utils/helpers.py` (`get_device_info`,
`DeviceDutyTracker`/`device_busy`, `ResourceMonitor`, `get_system_info`,
`calculate_model_size`, `format_time`, `format_bytes`, `device_sync`,
`Timer`, the config files `load_config`/`save_config`/`merge_configs`,
`create_experiment_dir`, `setup_logging`, `ProgressTracker`, the file
helpers, `validate_model_path` and `check_dependencies`). Device memory
comes from `torch.cuda.memory_stats`; host CPU and memory from `/proc/stat`
and `/proc/meminfo` (Linux), so the port needs no `psutil`. Where a source
is missing (no card, no `/proc`), the keys it would fill are left out. YAML
configs go through the port's own `utils/yaml_io.py`, not PyYAML.
`download_file` is not ported: the port runs with no network.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import platform
import shutil
import threading
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn

logger = logging.getLogger(__name__)

_STATE = ("running_mean", "running_var", "num_batches_tracked")  # batch-norm state, not parameters


# ---------------------------------------------------------------------------
# Host CPU and memory (procfs)
# ---------------------------------------------------------------------------

def _meminfo() -> Dict[str, int]:
    """/proc/meminfo in bytes, by field ({} where there is none)."""
    try:
        text = Path("/proc/meminfo").read_text()
    except OSError:
        return {}
    out = {}
    for line in text.splitlines():
        key, _, rest = line.partition(":")
        parts = rest.split()
        if parts and parts[0].isdigit():
            out[key] = int(parts[0]) * (1024 if parts[1:] == ["kB"] else 1)
    return out


def _host_memory() -> Dict[str, float]:
    """Total, available and used host memory (GB) and the used percent."""
    info = _meminfo()
    if "MemTotal" not in info:
        return {}
    total = info["MemTotal"]
    avail = info.get("MemAvailable", info.get("MemFree", 0))
    return {"total_gb": total / 1e9, "available_gb": avail / 1e9, "used_gb": (total - avail) / 1e9,
            "percent": 100.0 * (total - avail) / total}


def _cpu_times() -> Optional[List[int]]:
    """The jiffy counters of all CPUs, the first line of /proc/stat."""
    try:
        with open("/proc/stat") as f:
            return [int(v) for v in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None


def _cpu_busy_share(before: List[int], after: List[int]) -> Optional[float]:
    """Busy percent of all CPUs between two `_cpu_times` readings, as psutil
    takes it: each counter's rise (a counter that ran backwards, as iowait
    may, counts 0), idle and iowait idle, the guest counters left out of the
    total (user and nice hold them already). None when nothing advanced."""
    deltas = [max(b - a, 0) for a, b in zip(before, after)][:8]  # user .. steal
    total = sum(deltas)
    if total <= 0:
        return None
    idle = deltas[3] + (deltas[4] if len(deltas) > 4 else 0)
    return 100.0 * (total - idle) / total


class _CpuPercent:
    """Since the previous call whose /proc/stat counters had advanced (the
    first: since the object was made), the host's CPU use in percent of all
    its CPUs (None where /proc/stat is missing or has not advanced, as in
    some containers); since the previous call, this process's in percent of
    one CPU (`os.times`)."""

    def __init__(self):
        self._last = _cpu_times()
        self._last_proc = (sum(os.times()[:2]), time.perf_counter())

    def __call__(self) -> Tuple[Optional[float], float]:
        now = _cpu_times()
        host = None
        if now is not None and self._last is not None:
            host = _cpu_busy_share(self._last, now)
        if host is not None or self._last is None:
            self._last = now
        proc = (sum(os.times()[:2]), time.perf_counter())
        own = 100.0 * (proc[0] - self._last_proc[0]) / max(proc[1] - self._last_proc[1], 1e-9)
        self._last_proc = proc
        return host, own


# ---------------------------------------------------------------------------
# Device / system info
# ---------------------------------------------------------------------------

def _device_memory_stats() -> Dict[str, float]:
    """The card's memory in use, its peak and its capacity
    (`torch.cuda.memory_stats`, `get_device_properties`); {} without a card."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats()
    used = stats.get("allocated_bytes.all.current", 0)
    limit = torch.cuda.get_device_properties(0).total_memory
    return {"device_mem_used_gb": round(used / 1e9, 3),
            "device_mem_reserved_gb": round(stats.get("reserved_bytes.all.current", 0) / 1e9, 3),
            "device_mem_peak_gb": round(stats.get("allocated_bytes.all.peak", 0) / 1e9, 3),
            "device_mem_limit_gb": round(limit / 1e9, 3),
            "device_mem_percent": round(100.0 * used / limit, 1)}


def get_device_info() -> Dict[str, Any]:
    """Host platform and the CUDA devices torch sees."""
    mem = _host_memory()
    info: Dict[str, Any] = {
        "platform": platform.platform(),
        "python_version": platform.python_version(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cpu_count": os.cpu_count(),
    }
    if mem:
        info["memory_total_gb"] = round(mem["total_gb"], 2)
        info["memory_available_gb"] = round(mem["available_gb"], 2)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info["device_count"] = count
    info["cuda_available"] = count > 0
    info["devices"] = [{"id": i, "kind": torch.cuda.get_device_name(i), "platform": "gpu"} for i in range(count)]
    mem_dev = _device_memory_stats()
    if mem_dev:
        info["device_memory"] = mem_dev
    # the duty-cycle floor from instrumented regions (DeviceDutyTracker)
    info["device_busy_s"] = round(DEVICE_DUTY.snapshot(), 3)
    info["device_busy_events"] = DEVICE_DUTY.events
    return info


class DeviceDutyTracker:
    """Busy wall time of instrumented device regions (benchmark windows,
    predict calls that use `device_busy`). `ResourceMonitor` reports it per
    sample interval as `device_util_percent`: untracked work is not counted,
    so the number is a floor."""

    def __init__(self):
        self._lock = threading.Lock()
        self.busy_s = 0.0
        self.events = 0

    def record(self, seconds: float) -> None:
        with self._lock:
            self.busy_s += max(float(seconds), 0.0)
            self.events += 1

    def snapshot(self) -> float:
        with self._lock:
            return self.busy_s


DEVICE_DUTY = DeviceDutyTracker()


class device_busy:
    """Context manager marking a wall-clock window as device-busy."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        DEVICE_DUTY.record(time.perf_counter() - self._t0)
        return False


def get_system_info() -> Dict[str, Any]:
    """Host CPU, memory and disk use, with `get_device_info`."""
    out: Dict[str, Any] = {"timestamp": datetime.now().isoformat()}
    cpu = _CpuPercent()
    time.sleep(0.1)  # /proc/stat counts since boot: take the use over a short window
    host, own = cpu()
    if host is not None:
        out["cpu_percent"] = host
    out["process_cpu_percent"] = own
    mem = _host_memory()
    if mem:
        out["memory_percent"] = mem["percent"]
        out["memory_used_gb"] = round(mem["used_gb"], 2)
    disk = shutil.disk_usage("/")
    out["disk_usage_percent"] = 100.0 * disk.used / disk.total
    return {**out, **get_device_info()}


def calculate_model_size(model: nn.Module) -> Dict[str, float]:
    """Parameter count and bytes of a module's weights (float and int8
    tensors of its state dict, batch-norm statistics excluded)."""
    tensors = [t for k, t in model.state_dict().items() if not k.endswith(_STATE)]
    n_params = sum(t.numel() for t in tensors)
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    return {"parameters": n_params, "size_mb": round(n_bytes / (1024 * 1024), 3), "size_bytes": n_bytes}


# ---------------------------------------------------------------------------
# Formatting
# ---------------------------------------------------------------------------

def format_time(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:.1f}us"
    if seconds < 1:
        return f"{seconds * 1e3:.1f}ms"
    if seconds < 60:
        return f"{seconds:.2f}s"
    if seconds < 3600:
        m, s = divmod(seconds, 60)
        return f"{int(m)}m{s:.0f}s"
    h, rem = divmod(seconds, 3600)
    m = rem // 60
    return f"{int(h)}h{int(m)}m"


def format_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}PB"


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def device_sync(tree: Any = None) -> None:
    """Wait for the card's queued work (`torch.cuda.synchronize`); `tree`
    (tensors, dicts or lists of them) names the work, and with no CUDA
    tensor in it nothing is waited for."""
    def leaves(t):
        if torch.is_tensor(t):
            yield t
        elif isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                yield from leaves(v)

    devices = {t.device for t in leaves(tree) if t.is_cuda}
    if tree is None and torch.cuda.is_available():
        devices = {torch.device("cuda", torch.cuda.current_device())}
    for d in devices:
        torch.cuda.synchronize(d)


class Timer:
    """Context-manager wall timer; the work passed as `sync` is waited for
    (`device_sync`) before the clock stops."""

    def __init__(self, name: str = "", sync: Any = None, verbose: bool = False):
        self.name = name
        self.sync = sync
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            device_sync(self.sync)
        self.elapsed = time.perf_counter() - self.start
        if self.verbose:
            logger.info("%s took %s", self.name or "block", format_time(self.elapsed))
        return False


# ---------------------------------------------------------------------------
# Resource monitor (daemon-thread sampler)
# ---------------------------------------------------------------------------

class ResourceMonitor:
    """Background sampler of host CPU and memory, this process's CPU, the
    device duty cycle and the card's memory, with a bounded history."""

    def __init__(self, interval: float = 1.0, max_points: int = 1000, sample_device: bool = True):
        self.interval = interval
        self.max_points = max_points
        self.history: List[Dict[str, float]] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._device = bool(sample_device and _device_memory_stats())
        self._cpu = _CpuPercent()
        self._last_busy = DEVICE_DUTY.snapshot()
        self._last_t = time.perf_counter()

    def _sample(self) -> Dict[str, float]:
        out: Dict[str, float] = {"t": time.time()}
        host, own = self._cpu()
        if host is not None:
            out["cpu_percent"] = host
        out["process_cpu_percent"] = own
        mem = _host_memory()
        if mem:
            out["memory_percent"] = mem["percent"]
            out["memory_used_gb"] = mem["used_gb"]
        # duty cycle from instrumented device regions: busy wall time since
        # the last sample over the interval, capped at 100
        now = time.perf_counter()
        busy = DEVICE_DUTY.snapshot()
        dt = max(now - self._last_t, 1e-9)
        out["device_util_percent"] = round(min((busy - self._last_busy) / dt, 1.0) * 100.0, 1)
        self._last_busy, self._last_t = busy, now
        if self._device:
            out.update(_device_memory_stats())
        return out

    def _loop(self):
        while not self._stop.is_set():
            self.history.append(self._sample())
            if len(self.history) > self.max_points:
                self.history = self.history[-self.max_points:]
            self._stop.wait(self.interval)

    def start(self):
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> Dict[str, Any]:
        """Stop sampling, take a last sample (a run shorter than the interval
        is covered to its end) and return the summary."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval * 2 + 1)
        self.history.append(self._sample())
        return self.summary()

    def summary(self) -> Dict[str, Any]:
        if not self.history:
            return {}
        out: Dict[str, Any] = {}
        for k in ("cpu_percent", "process_cpu_percent", "memory_percent", "memory_used_gb", "device_util_percent",
                  "device_mem_used_gb", "device_mem_percent", "device_mem_peak_gb"):
            vals = [h[k] for h in self.history if k in h]  # a sample whose counters did not advance lacks cpu_percent
            if vals:
                out[f"avg_{k}"], out[f"max_{k}"] = sum(vals) / len(vals), max(vals)
        out["samples"] = len(self.history)
        return out

    def save(self, path: Union[str, Path]):
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps({"history": self.history, "summary": self.summary()}, indent=2))


# ---------------------------------------------------------------------------
# Config files (YAML or JSON) and a deep merge
# ---------------------------------------------------------------------------

def load_config(path: Union[str, Path]) -> Dict[str, Any]:
    """A `.yaml`/`.yml` (the port's `utils/yaml_io.py`) or `.json` config file."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"config not found: {path}")
    if path.suffix in (".yaml", ".yml"):
        from yolo_infer_tpu_torch.utils import yaml_io

        return yaml_io.load(path) or {}
    if path.suffix == ".json":
        return json.loads(path.read_text())
    raise ValueError(f"unsupported config format: {path.suffix}")


def save_config(config: Dict[str, Any], path: Union[str, Path]) -> None:
    path = Path(path)
    if path.suffix in (".yaml", ".yml"):
        from yolo_infer_tpu_torch.utils import yaml_io

        yaml_io.save(config, path)
    elif path.suffix == ".json":
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(config, indent=2, default=str))
    else:
        raise ValueError(f"unsupported config format: {path.suffix}")


def merge_configs(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Deep merge: override wins; nested dicts merge recursively."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_configs(out[k], v)
        else:
            out[k] = v
    return out


def create_experiment_dir(base_dir: Union[str, Path], name: str = "exp") -> Path:
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    path = Path(base_dir) / f"{name}_{stamp}"
    path.mkdir(parents=True, exist_ok=True)
    return path


# ---------------------------------------------------------------------------
# Logging and progress
# ---------------------------------------------------------------------------

def setup_logging(level: str = "INFO", log_file: Optional[Union[str, Path]] = None,
                  name: Optional[str] = None) -> logging.Logger:
    """Set `level` on the root (or `name`d) logger, with one stream handler
    and, with `log_file`, a file handler."""
    lg = logging.getLogger(name) if name else logging.getLogger()
    lg.setLevel(getattr(logging, str(level).upper(), logging.INFO))
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if not any(isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler) for h in lg.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        lg.addHandler(sh)
    if log_file:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        lg.addHandler(fh)
    return lg


class ProgressTracker:
    """Count, rate and time left of a loop of `total` steps."""

    def __init__(self, total: int, name: str = ""):
        self.total = total
        self.name = name
        self.count = 0
        self.start = time.perf_counter()

    def update(self, n: int = 1) -> Dict[str, float]:
        self.count += n
        elapsed = time.perf_counter() - self.start
        rate = self.count / elapsed if elapsed > 0 else 0.0
        remaining = (self.total - self.count) / rate if rate > 0 else float("inf")
        return {"count": self.count, "total": self.total, "rate": rate, "eta_s": remaining, "elapsed_s": elapsed}


# ---------------------------------------------------------------------------
# Files, model paths and dependencies
# ---------------------------------------------------------------------------

def get_file_hash(path: Union[str, Path], algorithm: str = "md5", chunk: int = 1 << 20) -> str:
    h = hashlib.new(algorithm)
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk)
            if not data:
                break
            h.update(data)
    return h.hexdigest()


def compare_files(a: Union[str, Path], b: Union[str, Path]) -> bool:
    pa, pb = Path(a), Path(b)
    if pa.stat().st_size != pb.stat().st_size:
        return False
    return get_file_hash(pa) == get_file_hash(pb)


def backup_file(path: Union[str, Path], backup_dir: Optional[Union[str, Path]] = None) -> Path:
    src = Path(path)
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    dst_dir = Path(backup_dir) if backup_dir else src.parent / "backups"
    dst_dir.mkdir(parents=True, exist_ok=True)
    dst = dst_dir / f"{src.stem}_{stamp}{src.suffix}"
    shutil.copy2(src, dst)
    return dst


def clean_old_files(directory: Union[str, Path], pattern: str = "*", keep_last: int = 5) -> List[Path]:
    files = sorted(Path(directory).glob(pattern), key=lambda p: p.stat().st_mtime)
    removed = files[: max(len(files) - keep_last, 0)]
    for f in removed:
        f.unlink(missing_ok=True)
    return removed


def validate_model_path(path: Union[str, Path]) -> bool:
    """True if `path` is a loadable model reference (a checkpoint file or a yolo11* name)."""
    p = Path(path)
    if p.exists():
        return p.suffix in (".msgpack", ".ckpt", ".pt", ".safetensors")
    from yolo_infer_tpu_torch.core.model import parse_model_name

    return parse_model_name(str(path)) is not None


def check_dependencies() -> Dict[str, bool]:
    """What the port needs, and whether it is there: torch, numpy, a CUDA
    card, `nvcc` (the kernels' compiler: `$CUDA_HOME/bin`, `/usr/local/cuda/bin`
    or the PATH), and PyYAML, which is optional (`utils/yaml_io.py` reads
    configs without it)."""
    import importlib.util

    from yolo_infer_tpu_torch.ops.kernels._build import _nvcc

    out = {mod: importlib.util.find_spec(mod) is not None for mod in ("torch", "numpy")}
    out["cuda"] = torch.cuda.is_available()
    try:
        out["nvcc"] = bool(_nvcc())
    except RuntimeError:
        out["nvcc"] = False
    out["yaml (optional)"] = importlib.util.find_spec("yaml") is not None
    return out
