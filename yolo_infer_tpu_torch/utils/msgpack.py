"""The flax msgpack wire format, in pure Python and numpy.

Port of what the JAX package reads and writes through `flax.serialization`
(`msgpack_serialize`, `msgpack_restore`): checkpoints (`core/model.py`,
`utils/checkpoint.py`) are msgpack maps of parameter trees. Neither `flax`
nor `msgpack` is needed, so a file moves between the two packages as it is.

The format, as flax writes it:
- maps, arrays, str (UTF-8), bin, int, float (64-bit), bool and nil, each in
  msgpack's shortest form;
- dict keys in sorted order: flax copies the tree with `jax.tree_util`
  first, which sorts every dict's keys (a chunked array's dict, made after
  that copy, keeps its own order);
- an ndarray is ext type 1 whose data is the msgpack array (shape, dtype
  name, C-order bytes); a numpy scalar is ext type 3 with the same data of
  its 0-d array;
- an array of more than `MAX_CHUNK_SIZE` bytes held by a dict (or the whole
  tree) is written as a dict {"__msgpack_chunked_array__": True, "shape":
  {"0": d0, ...}, "chunks": {"0": flat chunk, ...}} and joined on read.

`"bfloat16"` data (which numpy cannot hold without ml_dtypes) is read into a
`torch.bfloat16` tensor through its raw bytes; a `torch.bfloat16` tensor (or
an ml_dtypes bfloat16 array) is written with that dtype name. Other torch
tensors are written as their numpy arrays. A tuple is written as an array
(flax refuses tuples).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax's limit per array leaf, in bytes
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _pack_int(x: int, out: List[bytes]) -> None:
    if 0 <= x <= 0x7F:
        out.append(struct.pack("B", x))
    elif -0x20 <= x < 0:
        out.append(struct.pack("b", x))
    elif 0x80 <= x <= 0xFF:
        out.append(b"\xcc" + struct.pack("B", x))
    elif -0x80 <= x < 0:
        out.append(b"\xd0" + struct.pack("b", x))
    elif 0xFF < x <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", x))
    elif -0x8000 <= x < -0x80:
        out.append(b"\xd1" + struct.pack(">h", x))
    elif 0xFFFF < x <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", x))
    elif -0x80000000 <= x < -0x8000:
        out.append(b"\xd2" + struct.pack(">i", x))
    elif 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", x))
    elif -0x8000000000000000 <= x < -0x80000000:
        out.append(b"\xd3" + struct.pack(">q", x))
    else:
        raise OverflowError(f"int {x} does not fit in 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, int, int], out: List[bytes]) -> None:
    """A length header: the fix form below `fix_max`, else 8- (where the
    type has one), 16- or 32-bit."""
    c8, c16, c32 = codes
    if n < fix_max:
        out.append(struct.pack("B", fix | n))
    elif c8 and n <= 0xFF:
        out.append(struct.pack("BB", c8, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", c16, n))
    else:
        out.append(struct.pack(">BI", c32, n))


def _pack_bin(b: bytes, out: List[bytes]) -> None:
    n = len(b)
    if n <= 0xFF:
        out.append(struct.pack("BB", 0xC4, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xC5, n))
    else:
        out.append(struct.pack(">BI", 0xC6, n))
    out.append(b)


def _pack_ext(code: int, data: bytes, out: List[bytes]) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("Bb", fixed[n], code))
    elif n <= 0xFF:
        out.append(struct.pack("BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _array_parts(x) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-order bytes) of an ndarray or tensor."""
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    if x.dtype.hasobject or x.dtype.fields is not None:
        raise ValueError("object and structured dtypes cannot be serialized")
    return tuple(int(d) for d in x.shape), x.dtype.name, x.tobytes("C")


def _ndarray_bytes(x) -> bytes:
    shape, name, data = _array_parts(x)
    return packb([list(shape), name, data])


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif type(obj) in (bytes, bytearray, memoryview):
        _pack_bin(bytes(obj), out)
    elif type(obj) in (list, tuple):
        _pack_len(len(obj), 0x90, 16, (0, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _pack_len(len(obj), 0x80, 16, (0, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray) or torch.is_tensor(obj):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _sort_keys(tree: Any) -> Any:
    """`tree` with every dict's keys in sorted order, as `jax.tree_util`
    leaves them (keys of mixed types keep their order)."""
    if type(tree) is dict:
        try:
            keys = sorted(tree)
        except TypeError:
            keys = list(tree)
        return {k: _sort_keys(tree[k]) for k in keys}
    if type(tree) in (list, tuple):
        return [_sort_keys(v) for v in tree]
    return tree


def packb(obj: Any) -> bytes:
    """msgpack bytes of `obj`, dicts in their own order (no chunking)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if torch.is_tensor(x) else x.size * x.dtype.itemsize


def _chunk(x) -> Dict[str, Any]:
    flat = x.reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / (x.element_size() if torch.is_tensor(x) else x.dtype.itemsize)))
    chunks = [flat[i: i + size] for i in range(0, int(flat.shape[0]), size)]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_large(tree: Any) -> Any:
    """Arrays over MAX_CHUNK_SIZE bytes in dicts (and the whole tree) in
    flax's chunked form; arrays inside lists stay as they are, as in flax."""
    if isinstance(tree, dict):
        return {k: _chunk_large(v) if isinstance(v, dict) else (
            _chunk(v) if (isinstance(v, np.ndarray) or torch.is_tensor(v)) and _nbytes(v) > MAX_CHUNK_SIZE else v)
                for k, v in tree.items()}
    if (isinstance(tree, np.ndarray) or torch.is_tensor(tree)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes `flax.serialization.msgpack_serialize` writes for `tree`."""
    return packb(_chunk_large(_sort_keys(tree)))


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos: self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        return _ext_value(code, bytes(self.take(n)))

    def value(self) -> Any:
        c = self.unpack("B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map_(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str_(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        fmt = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in fmt:
            return self.unpack(fmt[c])
        lens = {0xC4: "B", 0xC5: ">H", 0xC6: ">I", 0xD9: "B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
                0xDE: ">H", 0xDF: ">I", 0xC7: "B", 0xC8: ">H", 0xC9: ">I"}
        if c in lens:
            n = self.unpack(lens[c])
            if c <= 0xC6:
                return bytes(self.take(n))
            if c <= 0xC9:
                return self.ext(n)
            if c <= 0xDB:
                return self.str_(n)
            if c <= 0xDD:
                return [self.value() for _ in range(n)]
            return self.map_(n)
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        raise ValueError(f"unknown msgpack type byte 0x{c:02x}")

    def map_(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _array_from(data: bytes):
    """An ext 1 / ext 3 payload -> a numpy array, or a torch.bfloat16 tensor."""
    shape, name, buf = _Reader(data, raw=True).value()
    shape = tuple(shape)
    if name == b"bfloat16":
        flat = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape)


def _ext_value(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _array_from(data)
    if code == _EXT_NPSCALAR:
        a = _array_from(data)
        return a if torch.is_tensor(a) else a[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            flat = torch.cat(chunks) if torch.is_tensor(chunks[0]) else np.concatenate(chunks)
            return flat.reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    """The object msgpack `data` holds (no unchunking)."""
    r = _Reader(data, raw=False)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return out


def msgpack_restore(data: bytes) -> Any:
    """The tree `flax.serialization.msgpack_restore` reads from `data`:
    numpy arrays (read-only views of `data`) and scalars, bfloat16 data as
    torch tensors."""
    return _unchunk(unpackb(data))
