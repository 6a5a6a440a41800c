"""Host-side image IO without OpenCV, batching and result export.

Port of `yolo_infer_tpu/data/loader.py` (`IMAGE_EXTS`, `list_image_files`,
`load_image`, `save_image`, `load_image_batch`, `DataLoader`,
`save_predictions_to_file`, `create_dataset_config`). The JAX package reads
and writes images with OpenCV (`cv2.imread(path, cv2.IMREAD_COLOR)`,
`cv2.imwrite`); the port does not depend on OpenCV, so it decodes and
encodes every format of `IMAGE_EXTS` itself, with `zlib`, `struct` and
numpy, to the same pixels. `load_image` picks the decoder by the file's
signature, not its name:

  JPEG  baseline, extended-sequential and progressive Huffman, 8-bit; grey,
        YCbCr, RGB, CMYK and YCCK; any sampling, restart intervals, EXIF
        orientation (`data/jpeg.py`)
  PNG   every colour type and bit depth, palette, Adam7, `eXIf`
        orientation (`data/png.py`)
  BMP   1-, 4-, 8-bit palette, RLE4, RLE8, 16-, 24- and 32-bit, OS/2 core
        header, either row order (`data/bmp.py`)
  TIFF  the first page: strips or tiles, either byte order and planar
        configuration, none, LZW, Deflate and PackBits, predictor 2, 8- or
        16-bit grey, RGB and palette (`data/tiff.py`)
  WebP  lossless (VP8L) and lossy (VP8, `data/vp8.py`, with libwebp's
        fancy upsampling), simple or extended, alpha (dropped), EXIF
        orientation, an animation's first frame on its canvas
        (`data/webp.py`)

Still raising `NotImplementedError` (ROADMAP Queue 1 item 10): arithmetic-
coded, lossless (SOF3), hierarchical and 12-bit JPEG, and a progressive JPEG
cut before its AC1-AC9 are complete (libjpeg-turbo's block smoothing);
JPEG-in-TIFF (compressions 6 and 7), CCITT and
other TIFF compressions, BigTIFF, float samples and other TIFF kinds. A
TIFF whose Orientation transposes (5 to 8) raises `FileNotFoundError`, as
the JAX package does when `cv2.imread` returns None for it.

`save_image` writes by suffix what `cv2.imwrite` writes by default: `.jpg`
and `.jpeg` the same bytes (quality 95, 4:2:0), `.bmp` the same bytes
(24-bit, or 8-bit with a grey palette), `.tif`/`.tiff` LZW with predictor
2, `.webp` lossless VP8L, and PNG otherwise (filter 0 on every row); for
TIFF, WebP and PNG the pixels, not the bytes, are OpenCV's. Images are
uint8 HWC, RGB by default. `get_video_info` and `load_video` open a video
by its signature (`data/video.py`): motion JPEG in AVI (`data/avi.py`; the
frames of OpenCV's own MJPEG backend, bit for bit), MPEG-4 Part 2, H.263,
Microsoft's MPEG-4 family, MPEG-1 and MPEG-2 (`data/mpeg4.py`,
`data/h263.py`, `data/msmpeg4.py`, `data/mpeg12.py`) in MP4, MOV,
Matroska and AVI, and VP8 and VP9 in WebM (`data/vp8.py`, `data/vp9.py`),
all the frames of OpenCV's FFmpeg backend, bit for bit; other containers
and codecs raise before any frame is read (ROADMAP Queue 1 item 11.2).
`create_dataset_config` writes its YAML with the port's
`utils/yaml_io.py`.
"""

from __future__ import annotations

import csv
import json
import random
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from yolo_infer_tpu_torch.data.bmp import decode_bmp, encode_bmp
from yolo_infer_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
from yolo_infer_tpu_torch.data.png import PNG_SIGNATURE, decode_png, encode_png
from yolo_infer_tpu_torch.data.tiff import decode_tiff, encode_tiff
from yolo_infer_tpu_torch.data.video import open_video
from yolo_infer_tpu_torch.data.webp import decode_webp, encode_webp

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp"}
VIDEO_EXTS = {".mp4", ".avi", ".mov", ".mkv", ".webm", ".m4v"}

_UNSUPPORTED = ("the port reads JPEG, PNG, BMP, TIFF and WebP files (by their signature); other formats, and "
                "the kinds of those the module docstring lists, are ROADMAP Queue 1 item 10")
_WRITERS = {".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".bmp": encode_bmp, ".tif": encode_tiff,
            ".tiff": encode_tiff, ".webp": encode_webp}


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
        decoder = decode_jpeg
    elif data.startswith(PNG_SIGNATURE):
        decoder = decode_png
    elif data.startswith(b"BM"):
        decoder = decode_bmp
    elif data.startswith((b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")):
        decoder = decode_tiff
    elif data.startswith(b"RIFF") and data[8:12] == b"WEBP":
        decoder = decode_webp
    else:
        raise NotImplementedError(f"{path}: {_UNSUPPORTED}")
    try:
        img = decoder(data)
    except (NotImplementedError, ValueError, FileNotFoundError) as exc:
        raise type(exc)(f"{path}: {exc}") from exc
    return img if rgb else np.ascontiguousarray(img[..., ::-1])


def save_image(path: Union[str, Path], img_rgb: np.ndarray, compress_level: int = 6) -> None:
    """Write a uint8 image ((H, W, 3) RGB, (H, W) grey, or (H, W, 4) RGBA
    but for JPEG) by its suffix: `.jpg`/`.jpeg` and `.bmp` the bytes
    `cv2.imwrite` writes by default, `.tif`/`.tiff` LZW with predictor 2,
    `.webp` lossless, anything else PNG."""
    path = Path(path)
    img = np.ascontiguousarray(img_rgb)
    if img.dtype != np.uint8:
        raise ValueError(f"save_image: expected uint8, got {img.dtype}")
    writer = _WRITERS.get(path.suffix.lower())
    data = writer(img) if writer is not None else encode_png(img, compress_level)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)


def get_video_info(path: Union[str, Path]) -> Dict[str, Any]:
    """width, height, fps, frame_count and duration_s of a video file (any
    container and codec `data/video.py` opens), as OpenCV reports them."""
    return open_video(path).info()


def load_video(path: Union[str, Path], rgb: bool = True, max_frames: Optional[int] = None) -> Iterator[np.ndarray]:
    """The frames of a video file (any container and codec `data/video.py`
    opens) as uint8 (H, W, 3), RGB by default (BGR with `rgb=False`), at
    most `max_frames` (None: all). The file's headers
    are read, and an unsupported file raises, before this returns."""
    reader = open_video(path)

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
