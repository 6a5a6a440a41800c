"""BMP decode and encode in numpy, to the pixels and bytes of OpenCV.

OpenCV reads and writes BMP with its own code (`grfmt_bmp.cpp`), not a
library; `decode_bmp` follows it:

  - the 40-byte (and longer) info header and the 12-byte OS/2 core header
    (its palette of 3-byte entries);
  - 1-, 4- and 8-bit palette rows (entries past the palette read as black),
    RLE8 and RLE4 with their escapes as OpenCV runs them: end of line and
    delta fill the pixels they pass with palette entry 0, end of bitmap
    fills the rest of the image with it;
  - 16 bits: 5-5-5 (`BI_RGB`, or `BI_BITFIELDS` with those masks) and 5-6-5
    (`BI_BITFIELDS`), each field shifted up with zero low bits
    (`icvCvt_BGR5552BGR_8u_C2C3R`, `icvCvt_BGR5652BGR_8u_C2C3R`); the masks
    are read just after the info header, as OpenCV reads them;
  - 24 bits, and 32 bits (`BI_RGB` or `BI_BITFIELDS`) as B, G, R with the
    fourth byte dropped, whatever the masks;
  - bottom-up rows, or top-down ones for a negative height.

`encode_bmp` writes what `cv2.imwrite(".bmp")` writes, byte for byte: a
40-byte header and 24-bit rows, or 8-bit rows and a grey palette for a
grey image, or a 124-byte V5 header (B, G, R, A masks) and 32-bit rows for
four channels; bottom-up, each row padded to 4 bytes.
"""

from __future__ import annotations

import struct

import numpy as np

_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> uint8 (H, W, 3) RGB, the pixels of `cv2.imread(path,
    cv2.IMREAD_COLOR)` in RGB order."""
    if len(data) < 26:
        raise ValueError("truncated BMP")
    offset, size = struct.unpack("<II", data[10:18])
    palette = np.zeros((256, 3), np.uint8)  # B, G, R
    if size >= 36:
        width, height, _, bits, compression = struct.unpack("<iiHHI", data[18:34])
        (clrused,) = struct.unpack("<I", data[46:50])
        ok = ((bits in (1, 4, 8, 24, 32) and compression == _BI_RGB) or (bits == 16 and compression == _BI_RGB)
              or (bits in (16, 32) and compression == _BI_BITFIELDS)
              or (bits, compression) in ((4, _BI_RLE4), (8, _BI_RLE8)))
        if not ok or width <= 0 or height == 0:
            raise ValueError(f"BMP of {bits} bits, compression {compression}, {width}x{height}")
        after = 14 + size
        if bits <= 8:
            n = clrused or 1 << bits
            if n > 256:
                raise ValueError(f"BMP palette of {n} entries")
            entries = np.frombuffer(data, np.uint8, 4 * n, after).reshape(n, 4)
            palette[:n] = entries[:, :3]
        elif bits == 16 and compression == _BI_BITFIELDS:
            red, green, blue = struct.unpack("<III", data[after: after + 12])
            if (red, green, blue) == (0x7C00, 0x3E0, 0x1F):
                bits = 15
            elif (red, green, blue) != (0xF800, 0x7E0, 0x1F):
                raise ValueError(f"16-bit BMP masks {red:#x} {green:#x} {blue:#x} (OpenCV reads 5-5-5 "
                                 "and 5-6-5 only)")
        elif bits == 16:
            bits = 15
    elif size == 12:  # OS/2 BITMAPCOREHEADER
        width, height, planes, bits = struct.unpack("<HHHH", data[18:26])
        compression = _BI_RGB
        if planes != 1 or bits not in (1, 4, 8, 24) or not width or not height:
            raise ValueError(f"OS/2 BMP of {bits} bits, {planes} planes")
        if bits <= 8:
            n = 1 << bits
            palette[:n] = np.frombuffer(data, np.uint8, 3 * n, 26).reshape(n, 3)
    else:
        raise ValueError(f"BMP header of {size} bytes")
    h, w = abs(height), width
    if compression in (_BI_RLE8, _BI_RLE4):
        index = _decode_rle(data, offset, h, w, compression == _BI_RLE4)
        bgr = palette[index]
    else:
        stride = ((w * (16 if bits == 15 else bits) + 7) // 8 + 3) & ~3
        if len(data) < offset + stride * h:
            raise ValueError("truncated BMP")
        rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
        if bits <= 8:
            per = 8 // bits  # pixels per byte, the first in the high bits
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            index = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, stride * per)[:, :w]
            bgr = palette[index]
        elif bits in (15, 16):
            t = rows[:, : 2 * w].view("<u2").astype(np.int32)
            if bits == 15:
                parts = (t << 3, (t >> 2) & ~7, (t >> 7) & ~7)
            else:
                parts = (t << 3, (t >> 3) & ~3, (t >> 8) & ~7)
            bgr = np.stack([p & 0xFF for p in parts], axis=-1).astype(np.uint8)
        else:
            c = bits // 8
            bgr = rows[:, : w * c].reshape(h, w, c)[..., :3]
        if height > 0:  # bottom-up
            bgr = bgr[::-1]
    return np.ascontiguousarray(bgr[..., ::-1])


def _decode_rle(data: bytes, pos: int, h: int, w: int, four: bool) -> np.ndarray:
    """RLE8 / RLE4 -> (h, w) palette indices, top row first, as OpenCV's
    decoder runs the escapes: an encoded RLE8 run may wrap to the next row
    and an end of line right after a run that filled its row is then
    skipped; an RLE4 run stops at the row's end; end of line and delta fill
    what they pass with entry 0; end of bitmap fills the rest."""
    out = np.zeros(h * w, np.uint8)
    x = y = 0  # the next pixel: column and row in file order (bottom row first)
    wrapped = False  # RLE8: the last encoded run ended its row and moved to the next

    def fill(count: int, value: int) -> None:  # FillUniColor: at least one pass, so a full row moves on
        nonlocal x, y
        while y < h:
            n = min(count, w - x)
            out[y * w + x: y * w + x + n] = value
            x += n
            count -= n
            if x >= w:
                x, y = 0, y + 1
            if count <= 0:
                break

    n = len(data)
    while True:
        if pos + 2 > n:
            raise ValueError("truncated RLE BMP")
        count, code = data[pos], data[pos + 1]
        pos += 2
        if count:  # encoded run
            if x + count > w:
                break  # OpenCV stops at a run past the row's end
            if four:
                pair = (code >> 4, code & 15)
                out[y * w + x: y * w + x + count] = np.resize(np.array(pair, np.uint8), count)
                x += count
            else:
                before = y
                fill(count, code)
                wrapped = y != before
                if y >= h:
                    break
        elif code > 2:  # absolute run
            if x + code > w:
                break
            nbytes = (((code + 1) >> 1) + 1) & ~1 if four else (code + 1) & ~1
            run = np.frombuffer(data, np.uint8, nbytes, pos)
            pos += nbytes
            if four:
                run = np.stack([run >> 4, run & 15], axis=-1).reshape(-1)
            out[y * w + x: y * w + x + code] = run[:code]
            x += code
            wrapped = False
        else:  # 0: end of line, 1: end of bitmap, 2: delta
            left = w - x
            if four or code or not wrapped or left < w:
                if code == 2:
                    if pos + 2 > n:
                        raise ValueError("truncated RLE BMP")
                    left, rows = data[pos], data[pos + 1]
                    pos += 2
                else:
                    rows = h - y
                if code != 0:
                    left += rows * w
                if y >= h:
                    break
                fill(left, 0)
                if y >= h:
                    break
            wrapped = False
            if y >= h:
                break
    return out.reshape(h, w)[::-1]


def encode_bmp(img: np.ndarray) -> bytes:
    """uint8 (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA -> the bytes
    `cv2.imwrite(".bmp")` writes for the same image (BGR or BGRA to OpenCV)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        channels, rows = 1, img
    elif img.ndim == 3 and img.shape[-1] in (3, 4):
        channels = img.shape[-1]
        rows = img[..., [2, 1, 0, 3][:channels]].reshape(img.shape[0], -1)
    else:
        raise ValueError(f"save_image: expected (H, W), (H, W, 3) or (H, W, 4), got {img.shape}")
    height, width = img.shape[:2]
    step = (width * channels + 3) & -4
    palette = b"".join(bytes((i, i, i, 0)) for i in range(256)) if channels == 1 else b""
    if channels == 4:  # a BITMAPV5HEADER: B, G, R, A masks, sRGB
        info = (struct.pack("<IiiHHIIiiII", 124, width, height, 1, 32, _BI_BITFIELDS, 0, 0, 0, 0, 0)
                + struct.pack("<IIII", 0xFF0000, 0xFF00, 0xFF, 0xFF000000) + b"BGRs" + bytes(64))
    else:
        info = struct.pack("<IiiHHIIiiII", 40, width, height, 1, channels * 8, _BI_RGB, 0, 0, 0, 0, 0)
    header_size = 14 + len(info) + len(palette)
    body = np.zeros((height, step), np.uint8)
    body[:, : width * channels] = rows[::-1]
    head = b"BM" + struct.pack("<III", step * height + header_size, 0, header_size)
    return head + info + palette + body.tobytes()
