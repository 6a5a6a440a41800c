"""Build and load the port's CUDA kernels (`csrc/*.cu`) at first use.

Each source compiles with nvcc into its own shared library with a plain C
interface, loaded with `ctypes`; no PyTorch headers are involved, so a build
takes seconds. Libraries land in `yolo_infer_tpu_torch/_build/` under a name
that carries a hash of the source, the `csrc/` headers it includes and the
flags, so an edited source or header rebuilds. A failed build or load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# every kernel that must equal its plain version bit for bit: no FMA
# contraction, so each operation rounds as PyTorch's elementwise kernels do
_EXTRA_FLAGS: Dict[str, List[str]] = {name: ["--fmad=false"]
                                      for name in ("nms_fused", "rotated_nms_fused", "mask_pack")}
KERNELS = ("nms_fused", "attention_fused", "rotated_nms_fused", "mask_pack", "dfl_decode", "greedy_nms")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")
    return found


def _flags(name: str) -> List[str]:
    return _BASE_FLAGS + _EXTRA_FLAGS.get(name, [])


def _sources(name: str) -> List[Path]:
    """`csrc/<name>.cu` and the `csrc/` headers it includes, transitively."""
    todo, seen = [CSRC_DIR / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC_DIR / inc for inc in re.findall(r'^#include "([^"]+)"', path.read_text(), re.M)]
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in _sources(name))
                            + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Dict[str, object]]:
    """Compile the named sources that are not built yet, all nvcc processes
    at once. Returns {name: {"seconds", "ptxas"}} for the ones compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    report: Dict[str, Dict[str, object]] = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0,
                        "ptxas": [ln.strip() for ln in log.splitlines() if "ptxas info" in ln]}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
