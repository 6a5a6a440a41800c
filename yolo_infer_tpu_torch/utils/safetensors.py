"""The safetensors file format, written and read with numpy alone.

A file is an 8-byte little-endian header length N, an N-byte JSON header
(padded with spaces to a multiple of 8 bytes) mapping each tensor's name to
its dtype, shape and [begin, end) byte offsets in the data that follows, and
an optional "__metadata__" map of strings; then the tensors' little-endian
bytes, back to back. `core/model.py export(format="safetensors")` writes the
deploy weights with it, as the JAX package does through the `safetensors`
package, which the port does not need.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np

_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32,
           "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def save_file(tensors: Mapping[str, np.ndarray], path: Union[str, Path],
              metadata: Optional[Mapping[str, str]] = None) -> Path:
    """Write `tensors` (name -> array), in name order, with `metadata`."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        a = np.ascontiguousarray(tensors[name])
        code = _CODES.get(a.dtype)
        if code is None:
            raise ValueError(f"{name}: dtype {a.dtype} has no safetensors code here")
        data = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": code, "shape": list(a.shape), "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    path = Path(path)
    path.write_bytes(struct.pack("<Q", len(text)) + text + b"".join(blobs))
    return path


def load_file(path: Union[str, Path]) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """(name -> array, metadata) of a safetensors file."""
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8: 8 + n])
    meta = header.pop("__metadata__", {})
    data = raw[8 + n:]
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        dtype = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        out[name] = np.frombuffer(data[begin:end], dtype=dtype).reshape(info["shape"])
    return out, meta
