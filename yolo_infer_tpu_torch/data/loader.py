"""Host-side image IO without OpenCV.

Port of `yolo_infer_tpu/data/loader.py` (`IMAGE_EXTS`, `list_image_files`,
`load_image`, `save_image`). The JAX package reads images with
`cv2.imread`; the card's machine has no OpenCV, so the port decodes the
formats it supports itself, with `zlib` and numpy, to the same pixels:

  PNG  8-bit grey, grey + alpha, RGB and RGBA, non-interlaced, all five row
       filters (alpha is dropped and grey replicated, as `cv2.imread(path,
       cv2.IMREAD_COLOR)` does); chunk CRCs are checked
  BMP  24-bit, uncompressed, bottom-up or top-down rows

Any other format raises `NotImplementedError` (JPEG, TIFF and WebP decoding
are ROADMAP Queue 1 item 4.3). `save_image` writes PNG (filter 0 on every row).
Images are uint8 HWC, RGB by default.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import List, Union

import numpy as np

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp"}

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel (8-bit)
_UNSUPPORTED = ("the port reads PNG (8-bit grey, grey + alpha, RGB, RGBA; non-interlaced) and 24-bit BMP; "
                "other formats are ROADMAP Queue 1 item 4.3 (JPEG decode)")


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
    if data.startswith(PNG_SIGNATURE):
        img = _decode_png(data, path)
    elif data.startswith(b"BM"):
        img = _decode_bmp(data, path)
    else:
        raise NotImplementedError(f"{path}: {_UNSUPPORTED}")
    return img if rgb else np.ascontiguousarray(img[..., ::-1])


def save_image(path: Union[str, Path], img_rgb: np.ndarray, compress_level: int = 6) -> None:
    """Write a uint8 (H, W, 3) RGB, (H, W, 4) RGBA or (H, W) grey image as PNG."""
    path = Path(path)
    if path.suffix.lower() != ".png":
        raise NotImplementedError(f"{path}: the port writes PNG only")
    img = np.ascontiguousarray(img_rgb)
    if img.dtype != np.uint8:
        raise ValueError(f"save_image: expected uint8, got {img.dtype}")
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
