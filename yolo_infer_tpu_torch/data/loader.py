"""Host-side image IO without OpenCV, batching and result export.

Port of `yolo_infer_tpu/data/loader.py` (`IMAGE_EXTS`, `list_image_files`,
`load_image`, `save_image`, `load_image_batch`, `DataLoader`,
`save_predictions_to_file`, `create_dataset_config`). The JAX package reads
and writes images with OpenCV; the port does not depend on OpenCV, so it
decodes and encodes the formats it supports itself, with `zlib` and
numpy, to the same pixels:

  JPEG baseline and extended-sequential Huffman, 8-bit, grey or YCbCr, any
       sampling, restart intervals, EXIF orientation (`data/jpeg.py`: the
       pixels of `cv2.imread(path, cv2.IMREAD_COLOR)` bit for bit)
  PNG  8-bit grey, grey + alpha, RGB and RGBA, non-interlaced, all five row
       filters (alpha is dropped and grey replicated, as `cv2.imread(path,
       cv2.IMREAD_COLOR)` does); chunk CRCs are checked
  BMP  24-bit, uncompressed, bottom-up or top-down rows

Any other format raises `NotImplementedError` (progressive JPEG, TIFF and
WebP are ROADMAP Queue 1 item 10). `save_image` writes `.jpg`/`.jpeg` as
`cv2.imwrite` does by default (quality 95, 4:2:0; `data/jpeg.py`, the same
bytes) and PNG otherwise (filter 0 on every row). Images are uint8 HWC, RGB
by default. `get_video_info` and `load_video` read motion JPEG in AVI
(`data/avi.py`; the frames of OpenCV's own MJPEG backend, bit for bit);
other containers and codecs raise before any frame is read (ROADMAP Queue
1 item 11.2). `create_dataset_config` writes its YAML with the port's
`utils/yaml_io.py`.
"""

from __future__ import annotations

import csv
import json
import random
import struct
import zlib
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from yolo_infer_tpu_torch.data.avi import AviReader
from yolo_infer_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp"}
VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v"}

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel (8-bit)
_UNSUPPORTED = ("the port reads baseline JPEG, PNG (8-bit grey, grey + alpha, RGB, RGBA; non-interlaced) and "
                "24-bit BMP; other formats are ROADMAP Queue 1 item 10")


def list_image_files(source: Union[str, Path]) -> List[Path]:
    p = Path(source)
    if p.is_dir():
        return sorted(q for q in p.rglob("*") if q.suffix.lower() in IMAGE_EXTS)
    if p.is_file() and p.suffix.lower() in IMAGE_EXTS:
        return [p]
    raise FileNotFoundError(f"no images at {source}")


def load_image(path: Union[str, Path], rgb: bool = True) -> np.ndarray:
    """Read an image file -> uint8 (H, W, 3), RGB by default (BGR with
    `rgb=False`); the pixels of `cv2.imread(path, cv2.IMREAD_COLOR)`."""
    try:
        data = Path(path).read_bytes()
    except OSError as exc:
        raise FileNotFoundError(f"could not read image: {path}") from exc
    if data.startswith(b"\xff\xd8"):
        try:
            img = decode_jpeg(data)
        except NotImplementedError as exc:
            raise NotImplementedError(f"{path}: {exc}") from exc
    elif data.startswith(PNG_SIGNATURE):
        img = _decode_png(data, path)
    elif data.startswith(b"BM"):
        img = _decode_bmp(data, path)
    else:
        raise NotImplementedError(f"{path}: {_UNSUPPORTED}")
    return img if rgb else np.ascontiguousarray(img[..., ::-1])


def save_image(path: Union[str, Path], img_rgb: np.ndarray, compress_level: int = 6) -> None:
    """Write a uint8 image: `.jpg`/`.jpeg` as JPEG ((H, W, 3) RGB or (H, W)
    grey, the bytes `cv2.imwrite` writes by default), anything else as PNG
    ((H, W, 3) RGB, (H, W, 4) RGBA or (H, W) grey)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix not in (".png", ".jpg", ".jpeg"):
        raise NotImplementedError(f"{path}: the port writes PNG and JPEG (ROADMAP Queue 1 item 10)")
    img = np.ascontiguousarray(img_rgb)
    if img.dtype != np.uint8:
        raise ValueError(f"save_image: expected uint8, got {img.dtype}")
    if suffix in (".jpg", ".jpeg"):
        data = encode_jpeg(img)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
        return
    colour = {2: 0, 3: {1: 0, 3: 2, 4: 6}.get(img.shape[-1])}.get(img.ndim)
    if colour is None:
        raise ValueError(f"save_image: expected (H, W), (H, W, 3) or (H, W, 4), got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0 per row

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw, compress_level)) + chunk(b"IEND", b""))


def get_video_info(path: Union[str, Path]) -> Dict[str, Any]:
    """width, height, fps, frame_count and duration_s of a motion-JPEG AVI."""
    return AviReader(path).info()


def load_video(path: Union[str, Path], rgb: bool = True, max_frames: Optional[int] = None) -> Iterator[np.ndarray]:
    """The frames of a motion-JPEG AVI as uint8 (H, W, 3), RGB by default (BGR
    with `rgb=False`), at most `max_frames` (None: all). The file's headers
    are read, and an unsupported file raises, before this returns."""
    reader = AviReader(path)

    def frames() -> Iterator[np.ndarray]:
        for n, frame in enumerate(reader.read(rgb), 1):
            yield frame
            if max_frames is not None and n >= max_frames:
                break

    return frames()


def load_image_batch(paths: Sequence[Union[str, Path]], rgb: bool = True) -> List[np.ndarray]:
    return [load_image(p, rgb) for p in paths]


class DataLoader:
    """Iterate images from a file, a directory or a list of paths in
    batches of `batch_size`, optionally shuffled (seeded); yields (paths,
    images) per batch."""

    def __init__(
        self,
        source: Union[str, Path, Sequence[Union[str, Path]]],
        batch_size: int = 1,
        shuffle: bool = False,
        rgb: bool = True,
        seed: Optional[int] = None,
    ):
        if isinstance(source, (str, Path)):
            self.files = list_image_files(source)
        else:
            self.files = [Path(f) for f in source]
        if not self.files:
            raise ValueError("DataLoader: empty source")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rgb = rgb
        self._rng = random.Random(seed)
        self._order: List[int] = []
        self.reset()

    def __len__(self) -> int:
        return (len(self.files) + self.batch_size - 1) // self.batch_size

    def reset(self) -> None:
        self._order = list(range(len(self.files)))
        if self.shuffle:
            self._rng.shuffle(self._order)
        self._pos = 0

    def __iter__(self) -> Iterator[Tuple[List[Path], List[np.ndarray]]]:
        self.reset()
        return self

    def __next__(self) -> Tuple[List[Path], List[np.ndarray]]:
        if self._pos >= len(self._order):
            raise StopIteration
        idxs = self._order[self._pos: self._pos + self.batch_size]
        self._pos += len(idxs)
        paths = [self.files[i] for i in idxs]
        return paths, [load_image(p, self.rgb) for p in paths]


_FIELDS = ["image", "class", "name", "confidence", "x1", "y1", "x2", "y2"]


def save_predictions_to_file(results: Sequence[Any], path: Union[str, Path], fmt: str = "json") -> None:
    """Write Results (one row per detection) as json, csv or txt."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for i, r in enumerate(results):
        for b, s, c in zip(r.boxes, r.scores, r.classes):
            rows.append({"image": i, "class": int(c), "name": r.names.get(int(c), str(int(c))),
                         "confidence": float(s), "x1": float(b[0]), "y1": float(b[1]), "x2": float(b[2]),
                         "y2": float(b[3])})
    if fmt == "json":
        path.write_text(json.dumps(rows, indent=2))
    elif fmt == "csv":
        with path.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=_FIELDS)
            writer.writeheader()
            writer.writerows(rows)
    elif fmt == "txt":
        with path.open("w") as f:
            for row in rows:
                f.write(f"{row['image']} {row['class']} {row['confidence']:.4f} {row['x1']:.1f} {row['y1']:.1f} "
                        f"{row['x2']:.1f} {row['y2']:.1f}\n")
    else:
        raise ValueError(f"unknown format {fmt}")


def create_dataset_config(
    path: Union[str, Path],
    train: str,
    val: str,
    names: Union[Dict[int, str], List[str]],
    test: Optional[str] = None,
) -> Path:
    """Write a YOLO-style dataset YAML (train, val, names, nc, test)."""
    from yolo_infer_tpu_torch.utils import yaml_io

    if isinstance(names, list):
        names = {i: n for i, n in enumerate(names)}
    cfg: Dict[str, Any] = {"train": train, "val": val, "names": names, "nc": len(names)}
    if test:
        cfg["test"] = test
    return yaml_io.save(cfg, path)


def _to_rgb(pixels: np.ndarray) -> np.ndarray:
    """(H, W, 1|2|3|4) samples -> (H, W, 3): grey replicated, alpha dropped."""
    c = pixels.shape[-1]
    if c in (1, 2):
        return np.ascontiguousarray(np.repeat(pixels[..., :1], 3, axis=-1))
    return np.ascontiguousarray(pixels[..., :3])


def _decode_png(data: bytes, path) -> np.ndarray:
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated PNG")
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        kind = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length: pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif not kind[0] & 0x20:  # an unknown critical chunk (PLTE included)
            raise NotImplementedError(f"{path}: PNG chunk {kind!r}; {_UNSUPPORTED}")
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace:
        raise NotImplementedError(f"{path}: PNG bit depth {depth}, colour type {colour}, "
                                  f"interlace {interlace}; {_UNSUPPORTED}")
    bpp = _PNG_CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp, path)
    return _to_rgb(pixels.reshape(h, w, bpp))


def _unfilter(raw: bytes, h: int, w: int, bpp: int, path) -> np.ndarray:
    """Undo the per-row PNG filters: (h, w*bpp) uint8. None, Sub and Up are
    numpy passes over a row (uint8 arithmetic wraps mod 256, as the filters
    do); Average and Paeth depend on the byte just decoded to their left,
    so they loop over the row's bytes."""
    stride = w * bpp
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < h * (stride + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = buf[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub
            out[y] = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prev
        elif kind == 3:
            out[y] = _unfilter_average(line.tobytes(), prev.tobytes(), bpp)
        elif kind == 4:
            out[y] = _unfilter_paeth(line.tobytes(), prev.tobytes(), bpp)
        else:
            raise ValueError(f"{path}: PNG row filter {kind}")
        prev = out[y]
    return out


def _unfilter_average(line: bytes, prev: bytes, bpp: int) -> np.ndarray:
    cur = bytearray(line)
    for i in range(bpp):
        cur[i] = (cur[i] + (prev[i] >> 1)) & 0xFF
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + prev[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter_paeth(line: bytes, prev: bytes, bpp: int) -> np.ndarray:
    cur = bytearray(line)
    for i in range(bpp):  # a = c = 0: the predictor is b
        cur[i] = (cur[i] + prev[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prev[i], prev[i - bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _decode_bmp(data: bytes, path) -> np.ndarray:
    if len(data) < 54:
        raise ValueError(f"{path}: truncated BMP")
    (offset,) = struct.unpack("<I", data[10:14])
    dib, width, height, _, bits, compression = struct.unpack("<IiiHHI", data[14:34])
    if dib < 40 or bits != 24 or compression != 0:
        raise NotImplementedError(f"{path}: BMP of {bits} bits, compression {compression}; {_UNSUPPORTED}")
    h, w = abs(height), width
    stride = (w * 3 + 3) & ~3  # rows pad to 4 bytes
    if w <= 0 or len(data) < offset + stride * h:
        raise ValueError(f"{path}: truncated BMP")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)[:, : w * 3]
    bgr = rows.reshape(h, w, 3)
    if height > 0:  # bottom-up
        bgr = bgr[::-1]
    return np.ascontiguousarray(bgr[..., ::-1])
