"""PNG decode and encode with `zlib` and numpy, to the pixels of `cv2.imread`.

The JAX package reads PNG through OpenCV (`cv2.imread(path,
cv2.IMREAD_COLOR)`, libpng underneath); the port reads the same pixels
itself (`decode_png`):

  - every colour type and bit depth of the standard: grey at 1, 2, 4, 8 and
    16 bits, palette at 1, 2, 4 and 8, RGB, grey + alpha and RGBA at 8 and
    16; sub-byte rows unpacked (grey scaled to 0..255 as
    `png_set_expand_gray_1_2_4_to_8` scales it: 1-bit reads as 0/255), 16-bit
    samples reduced to their high byte (`png_set_strip_16`), palette
    indices looked up in `PLTE` (an index past its end is black), `tRNS` and
    alpha dropped, grey replicated to three channels;
  - all five row filters, and Adam7 interlacing (seven passes, each
    filtered on its own, scattered to their pixels);
  - the EXIF orientation of an `eXIf` chunk, applied as OpenCV applies it;
  - chunk CRCs are checked; a corrupt chunk or stream raises `ValueError`.

`encode_png` writes 8-bit grey, RGB or RGBA, non-interlaced, filter 0 on
every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from yolo_infer_tpu_torch.data.jpeg import apply_orientation, exif_orientation

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _to_rgb(pixels: np.ndarray) -> np.ndarray:
    """(H, W, 1|2|3|4) samples -> (H, W, 3): grey replicated, alpha dropped."""
    c = pixels.shape[-1]
    if c in (1, 2):
        return np.ascontiguousarray(np.repeat(pixels[..., :1], 3, axis=-1))
    return np.ascontiguousarray(pixels[..., :3])


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, 3) RGB, the pixels of `cv2.imread(path,
    cv2.IMREAD_COLOR)` in RGB order."""
    pos, header, idat, palette, orientation = len(PNG_SIGNATURE), None, [], None, 1
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG")
        (length,) = struct.unpack(">I", data[pos: pos + 4])
        kind = data[pos + 4: pos + 8]
        body = data[pos + 8: pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length: pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"corrupt PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if length % 3 or not 0 < length <= 768:
                raise ValueError("corrupt PNG palette")
            palette = np.zeros((256, 3), np.uint8)  # entries past the palette's end are black
            palette[: length // 3] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            orientation = exif_orientation(b"Exif\0\0" + body)
        elif kind == b"IEND":
            break
        elif not kind[0] & 0x20:  # a critical chunk the standard does not define
            raise ValueError(f"unknown critical PNG chunk {kind!r}")
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in _DEPTHS[colour] or interlace > 1 or not w or not h:
        raise ValueError(f"PNG of bit depth {depth}, colour type {colour}, interlace {interlace}")
    if colour == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    spp = _CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        samples = np.empty((h, w, spp), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for y0, x0, dy, dx in _ADAM7:
            ph, pw = -(-(h - y0) // dy) if h > y0 else 0, -(-(w - x0) // dx) if w > x0 else 0
            if not ph or not pw:
                continue
            stride = -(-pw * spp * depth // 8)
            part = raw[at: at + ph * (stride + 1)]
            at += ph * (stride + 1)
            samples[y0::dy, x0::dx] = _samples(part, ph, pw, spp, depth)
    else:
        samples = _samples(raw, h, w, spp, depth)
    if colour == 3:
        img = palette[samples[..., 0]]
    else:
        if depth == 16:
            samples = (samples >> 8).astype(np.uint8)
        elif depth < 8:
            samples = (samples.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        img = _to_rgb(samples)
    return apply_orientation(img, orientation)


def _samples(raw: bytes, h: int, w: int, spp: int, depth: int) -> np.ndarray:
    """One image's (or one Adam7 pass's) filtered rows -> (h, w, spp)
    samples: uint8 (depth <= 8) or uint16 (16)."""
    bpp = max(1, spp * depth // 8)
    stride = -(-w * spp * depth // 8)
    rows = _unfilter(raw, h, stride, bpp)
    if depth == 16:
        return rows.view(">u2").reshape(h, w, spp).astype(np.uint16)
    if depth == 8:
        return rows.reshape(h, w, spp)
    per = 8 // depth  # sub-byte samples (spp is 1), the first in the high bits
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    unpacked = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return unpacked.reshape(h, stride * per)[:, :w, None]


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: (h, stride) uint8. None, Sub and Up are
    numpy passes over a row (uint8 arithmetic wraps mod 256, as the filters
    do); Average and Paeth depend on the byte just decoded to their left,
    so they loop over the row's bytes."""
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = buf[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prev
        elif kind == 3:
            out[y] = _unfilter_average(line.tobytes(), prev.tobytes(), bpp)
        elif kind == 4:
            out[y] = _unfilter_paeth(line.tobytes(), prev.tobytes(), bpp)
        else:
            raise ValueError(f"PNG row filter {kind}")
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


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray, compress_level: int = 6) -> bytes:
    """uint8 (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA -> PNG bytes (8-bit,
    non-interlaced, filter 0 on every row)."""
    colour = {2: 0, 3: {1: 0, 3: 2, 4: 6}.get(img.shape[-1])}.get(img.ndim)
    if colour is None:
        raise ValueError(f"save_image: expected (H, W), (H, W, 3) or (H, W, 4), got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0 per row
    return (PNG_SIGNATURE + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + png_chunk(b"IDAT", zlib.compress(raw, compress_level)) + png_chunk(b"IEND", b""))
