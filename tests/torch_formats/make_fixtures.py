"""Write the still-image fixtures of the port's decoders and their manifest.

    python tests/torch_formats/make_fixtures.py

Writes small files (at most 64x96) of every kind the port reads beside this
script, and `manifest.json`: for each file the tool that made it and the
sha256 and shape of `cv2.imread(path, cv2.IMREAD_COLOR)`'s pixels (BGR);
under "raises", the files the port refuses and what it raises. The tools:

  cv2      `cv2.imencode` (progressive JPEG, TIFF compressions, BMP, lossy
           WebP at two qualities)
  PIL      Pillow (CMYK and Adobe-RGB JPEG, palette, low-depth and 16-bit
           PNG, lossless WebP at several methods and palette sizes, lossy
           WebP at methods 0 and 6, with alpha, EXIF and as an animation,
           TIFF palette and alpha, BMP 1-bit)
  hand     bytes written here with `struct`, `zlib` and numpy: Adam7 PNG,
           RLE4/RLE8, 4-, 16- and 32-bit, top-down and OS/2 BMP, tiled,
           planar, big-endian and min-is-white TIFF (LZW strips and tiles
           by the port's `tiff._lzw_encode`), a YCCK JPEG (a CMYK file's
           Adobe transform set to 2), a progressive JPEG cut after its
           third scan, an animated WebP whose first frame is smaller than
           its canvas, and the headers of the kinds still refused

`tests/test_torch_formats.py` holds the manifest to OpenCV and the port to
both; `chip_smoke.py formats` holds the port to the manifest on the card's
host without importing OpenCV.
"""

import hashlib
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))

from yolo_infer_tpu_torch.data.tiff import _lzw_encode  # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422}


def frame(seed: int, h: int, w: int) -> np.ndarray:
    """RGB gradients, a flat box and noise: the structure of a photo, small."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w, 1), y * 255 // max(h, 1), (x + y) * 7 % 256], -1)
    img[h // 4: h // 2, w // 3: w // 2 + 1] = rng.integers(0, 256, 3)
    return np.clip(img + rng.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)


def blocks(seed: int, h: int, w: int, n: int, size: int = 6) -> np.ndarray:
    """(h, w) indices below n in flat blocks with some noise rows: runs for RLE."""
    rng = np.random.default_rng(seed)
    idx = np.repeat(np.repeat(rng.integers(0, n, (-(-h // size), -(-w // size))), size, 0), size, 1)[:h, :w]
    idx[::5] = rng.integers(0, n, (len(idx[::5]), w))
    return idx.astype(np.uint8)


def pil(img: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def cv2_bytes(ext: str, img: np.ndarray, params=()) -> bytes:
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok
    return buf.tobytes()


# --- PNG by hand -------------------------------------------------------------

def png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w * spp) samples -> (h, stride) bytes, big-endian for 16 bits."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    pad = -samples.shape[1] % per
    s = np.concatenate([samples, np.zeros((h, pad), samples.dtype)], 1).reshape(h, -1, per).astype(np.uint8)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (s << shifts).sum(-1).astype(np.uint8)


def sub_filter(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """Rows filtered by None (0) or Sub (1) in turn, each row led by its type."""
    out = []
    for y, row in enumerate(rows):
        kind = kinds[y % len(kinds)]
        if kind == 1:
            prev = np.concatenate([np.zeros(bpp, np.uint8), row[:-bpp]])
            row = row - prev
        out.append(bytes([kind]) + row.astype(np.uint8).tobytes())
    return b"".join(out)


def adam7_png(samples: np.ndarray, depth: int, colour: int, plte: bytes = b"") -> bytes:
    """An interlaced PNG of (h, w, spp) samples, each pass's rows filtered on their own."""
    h, w, spp = samples.shape
    bpp = max(1, spp * depth // 8)
    raw = b""
    for y0, x0, dy, dx in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
                           (1, 0, 2, 1)):
        part = samples[y0::dy, x0::dx]
        if part.size:
            raw += sub_filter(pack_rows(part.reshape(part.shape[0], -1), depth), bpp, (1, 0))
    body = png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 1))
    if plte:
        body += png_chunk(b"PLTE", plte)
    return b"\x89PNG\r\n\x1a\n" + body + png_chunk(b"IDAT", zlib.compress(raw)) + png_chunk(b"IEND", b"")


# --- BMP by hand -------------------------------------------------------------

def bmp(width: int, height: int, bits: int, pixels: bytes, palette: bytes = b"", compression: int = 0,
        masks: bytes = b"", core: bool = False) -> bytes:
    if core:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, width, height, 1, bits, compression, len(pixels), 2835, 2835,
                           len(palette) // 4 if palette else 0, 0)
    offset = 14 + len(info) + len(masks) + len(palette)
    return b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset) + info + masks + palette + pixels


def bmp_rows(rows: np.ndarray) -> bytes:
    """(h, nbytes) rows bottom-up, each padded to 4 bytes."""
    pad = -rows.shape[1] % 4
    return np.concatenate([rows, np.zeros((rows.shape[0], pad), np.uint8)], 1)[::-1].tobytes()


def rle8(idx: np.ndarray) -> bytes:
    """RLE8 of (h, w) indices, bottom row first: encoded runs of 3 or more,
    absolute runs between them (single pixels as runs of 1), an end of line
    per row but the last, a delta on row 2 and an end of bitmap one row early."""
    h, w = idx.shape
    out = bytearray()
    rows = idx[::-1]
    for y in range(h - 1):
        row, x = rows[y].tolist(), 0
        if y == 2:
            out += bytes([0, 2, 3, 0])  # delta: 3 pixels right (filled with entry 0)
            x = 3
        while x < w:
            n = 1
            while x + n < w and row[x + n] == row[x] and n < 255:
                n += 1
            if n >= 3 or w - x < 3:
                out += bytes([n, row[x]])
                x += n
                continue
            end = x
            while end < w and end - x < 255 and not (end + 2 < w and row[end] == row[end + 1] == row[end + 2]):
                end += 1
            count = end - x
            if count < 3:
                for v in row[x:end]:
                    out += bytes([1, v])
            else:
                out += bytes([0, count]) + bytes(row[x:end]) + b"\0" * (count & 1)
            x = end
        out += bytes([0, 0])
    out += bytes([0, 1])  # end of bitmap: the last row is palette entry 0
    return bytes(out)


def rle4(idx: np.ndarray) -> bytes:
    """RLE4 of (h, w) indices below 16: encoded runs of a pixel pair, absolute
    runs of the rest, an end of line per row, an end of bitmap at the end."""
    h, w = idx.shape
    out = bytearray()
    for row in idx[::-1].tolist():
        x = 0
        while x < w:
            n = 1
            while x + n < w and row[x + n] == row[x] and n < 255:
                n += 1
            if n >= 4 or w - x < 4:
                out += bytes([n, (row[x] << 4) | row[x]])
                x += n
                continue
            count = min(w - x, 8)
            vals = row[x: x + count] + [0] * (count & 1)
            packed = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, len(vals), 2))
            out += bytes([0, count]) + packed + b"\0" * (len(packed) & 1)
            x += count
        out += bytes([0, 0])
    out += bytes([0, 1])
    return bytes(out)


# --- TIFF by hand ------------------------------------------------------------

def tiff(order: str, tags: dict, chunks, pad_to_even: bool = True) -> bytes:
    """A one-page TIFF: `tags` {tag: (type, values)}, `chunks` the strip or
    tile bodies (their offsets and byte counts are filled in)."""
    head = (b"II*\0" if order == "<" else b"MM\0*")
    body, offsets = b"", []
    for c in chunks:
        offsets.append(8 + len(body))
        body += c + (b"\0" * (len(c) & 1) if pad_to_even else b"")
    tiled = 322 in tags
    tags = dict(tags)
    tags[324 if tiled else 273] = (4, offsets)
    tags[325 if tiled else 279] = (4, [len(c) for c in chunks])
    ifd_at = 8 + len(body)
    fmt = {1: "B", 3: "H", 4: "I"}
    entries = sorted(tags.items())
    extra_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, extra = struct.pack(order + "H", len(entries)), b""
    for tag, (typ, vals) in entries:
        packed = struct.pack(order + fmt[typ] * len(vals), *vals)
        if len(packed) <= 4:
            ifd += struct.pack(order + "HHI", tag, typ, len(vals)) + packed.ljust(4, b"\0")
        else:
            ifd += struct.pack(order + "HHII", tag, typ, len(vals), extra_at + len(extra))
            extra += packed + b"\0" * (len(packed) & 1)
    return head + struct.pack(order + "I", ifd_at) + body + ifd + struct.pack(order + "I", 0) + extra


def packbits(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        n = 1
        while i + n < len(data) and data[i + n] == data[i] and n < 128:
            n += 1
        if n >= 2:
            out += bytes([257 - n, data[i]])
            i += n
            continue
        j = i
        while j < len(data) and j - i < 128 and not (j + 1 < len(data) and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def predict(samples: np.ndarray) -> np.ndarray:
    """Horizontal differencing along axis 1 (mod the dtype's range)."""
    out = samples.copy()
    out[:, 1:] -= samples[:, :-1]
    return out


def base_tags(w, h, bits, photometric, spp, compression, predictor=1, planar=1):
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    return tags


def make() -> dict:
    files, raises = {}, {}

    def add(name, data, tool):
        files[name] = (data, tool)

    # --- progressive JPEG (cv2: libjpeg-turbo's jpeg_simple_progression; PIL: optimised tables)
    for i, (s, (h, w)) in enumerate(zip(SAMPLING, ((47, 61), (64, 96), (33, 17)))):
        add(f"prog_{s}_{h}x{w}.jpg", cv2_bytes(".jpg", frame(i, h, w), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[s], cv2.IMWRITE_JPEG_QUALITY, (90, 75, 95)[i]]), "cv2")
    add("prog_grey_31x23.jpg", cv2_bytes(".jpg", frame(5, 31, 23)[..., 1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]), "cv2")
    add("prog_rst2_420_48x64.jpg", cv2_bytes(".jpg", frame(6, 48, 64), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                                                       cv2.IMWRITE_JPEG_RST_INTERVAL, 2]), "cv2")
    add("prog_odd_1x1.jpg", cv2_bytes(".jpg", frame(7, 1, 1), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]), "cv2")
    add("prog_pil_40x56.jpg", pil(Image.fromarray(frame(8, 40, 56)), "JPEG", progressive=True, quality=80), "PIL")
    full = cv2_bytes(".jpg", frame(9, 48, 64), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    sos = [i for i in range(len(full) - 1) if full[i] == 0xFF and full[i + 1] == 0xDA]
    raises["prog_cut3_48x64.jpg"] = (full[: sos[3]] + b"\xff\xd9", "hand", "NotImplementedError")
    # --- four-component and untransformed JPEG (PIL writes CMYK with Adobe transform 0)
    cmyk = np.concatenate([frame(10, 40, 56), frame(11, 40, 56)[..., :1]], -1)
    data = pil(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=90)
    add("cmyk_40x56.jpg", data, "PIL")
    ycck = bytearray(data)
    ycck[data.index(b"Adobe") + 11] = 2
    add("ycck_40x56.jpg", bytes(ycck), "hand")
    at = data.index(b"\xff\xee")
    add("cmyk_no_adobe_40x56.jpg", data[:at] + data[at + 2 + struct.unpack(">H", data[at + 2: at + 4])[0]:], "hand")
    add("cmyk_prog_40x56.jpg", pil(Image.fromarray(cmyk, "CMYK"), "JPEG", quality=85, progressive=True), "PIL")
    add("adobe_rgb_40x56.jpg", pil(Image.fromarray(frame(12, 40, 56)), "JPEG", keep_rgb=True, quality=90), "PIL")
    # --- PNG
    f = frame(20, 37, 53)
    quant = Image.fromarray(f).quantize(50)
    add("pal8_37x53.png", pil(quant, "PNG"), "PIL")
    add("pal8_trns_37x53.png", pil(quant, "PNG", transparency=3), "PIL")
    for bits in (1, 2, 4):
        add(f"pal{bits}_37x53.png", pil(Image.fromarray(f).quantize(1 << bits), "PNG", bits=bits), "PIL")
        grey = (f[..., 0] >> (8 - bits)).astype(np.uint8) * (255 // ((1 << bits) - 1))
        add(f"grey{bits}_37x53.png", pil(Image.fromarray(grey), "PNG", bits=bits), "PIL")
    noise = np.random.default_rng(21).integers(0, 65536, (37, 53, 4), dtype=np.uint16)
    add("grey16_37x53.png", cv2_bytes(".png", noise[..., 0]), "cv2")
    add("rgb16_37x53.png", cv2_bytes(".png", noise[..., :3]), "cv2")
    add("rgba16_37x53.png", cv2_bytes(".png", noise), "cv2")
    add("la8_37x53.png", pil(Image.fromarray(np.stack([f[..., 0], f[..., 1]], -1), "LA"), "PNG"), "PIL")
    add("adam7_rgb_37x53.png", adam7_png(f, 8, 2), "hand")
    add("adam7_rgb16_21x13.png", adam7_png(noise[:21, :13, :3], 16, 2), "hand")
    pal_idx = blocks(22, 29, 35, 4)[..., None]
    plte = bytes(np.random.default_rng(23).integers(0, 256, 12, dtype=np.uint8))
    add("adam7_pal2_29x35.png", adam7_png(pal_idx, 2, 3, plte), "hand")
    exif = Image.Exif()
    exif[0x0112] = 6
    add("exif6_37x53.png", pil(Image.fromarray(f), "PNG", exif=exif), "PIL")
    # --- BMP
    f = frame(30, 31, 45)
    add("bgr24_31x45.bmp", cv2_bytes(".bmp", f), "cv2")
    add("grey8_31x45.bmp", cv2_bytes(".bmp", f[..., 0]), "cv2")
    add("bgra32_31x45.bmp", cv2_bytes(".bmp", np.concatenate([f, f[..., :1]], -1)), "cv2")
    add("bw1_31x45.bmp", pil(Image.fromarray(f[..., 0] > 128), "BMP"), "PIL")
    add("pal8_31x45.bmp", pil(Image.fromarray(f).quantize(40), "BMP"), "PIL")
    idx = blocks(31, 31, 45, 16)
    pal16 = np.random.default_rng(32).integers(0, 256, (16, 4), dtype=np.uint8)
    pal16[:, 3] = 0
    add("pal4_31x45.bmp", bmp(45, 31, 4, bmp_rows(pack_rows(idx, 4)), pal16.tobytes()), "hand")
    add("rle4_31x45.bmp", bmp(45, 31, 4, rle4(idx), pal16.tobytes(), compression=2), "hand")
    idx8 = blocks(33, 31, 45, 200)
    pal256 = np.random.default_rng(34).integers(0, 256, (200, 4), dtype=np.uint8)
    add("rle8_31x45.bmp", bmp(45, 31, 8, rle8(idx8), pal256.tobytes(), compression=1), "hand")
    v16 = np.random.default_rng(35).integers(0, 65536, (31, 45), dtype=np.uint16)
    rows16 = v16.astype("<u2").view(np.uint8).reshape(31, -1)
    add("rgb555_31x45.bmp", bmp(45, 31, 16, bmp_rows(rows16)), "hand")
    add("rgb565_31x45.bmp", bmp(45, 31, 16, bmp_rows(rows16), compression=3,
                                masks=struct.pack("<III", 0xF800, 0x7E0, 0x1F)), "hand")
    add("bitfields32_31x45.bmp", bmp(45, 31, 32, bmp_rows(np.concatenate([f, f[..., :1]], -1).reshape(31, -1)),
                                     compression=3, masks=struct.pack("<III", 0xFF0000, 0xFF00, 0xFF)), "hand")
    top = bmp(45, -31, 24, bmp_rows(f[::-1].reshape(31, -1)))
    add("topdown24_31x45.bmp", top, "hand")
    add("os2_pal8_31x45.bmp", bmp(45, 31, 8, bmp_rows(idx8), pal256[:, :3].tobytes() + bytes(3 * 56), core=True),
        "hand")
    add("os2_bgr24_31x45.bmp", bmp(45, 31, 24, bmp_rows(f.reshape(31, -1)), core=True), "hand")
    # --- TIFF
    f = frame(40, 37, 53)
    add("lzw_pred2_37x53.tif", cv2_bytes(".tif", f), "cv2")  # cv2.imwrite's default
    for comp, name in ((1, "none"), (8, "deflate"), (32946, "deflate32946"), (32773, "packbits")):
        add(f"{name}_37x53.tif", cv2_bytes(".tif", f, [cv2.IMWRITE_TIFF_COMPRESSION, comp]), "cv2")
    add("rgb16_lzw_37x53.tif", cv2_bytes(".tif", noise[..., :3]), "cv2")
    add("grey16_none_37x53.tif", cv2_bytes(".tif", noise[..., 0], [cv2.IMWRITE_TIFF_COMPRESSION, 1]), "cv2")
    add("pal8_lzw_37x53.tif", pil(Image.fromarray(f).quantize(60), "TIFF", compression="tiff_lzw"), "PIL")
    add("rgba_unassoc_37x53.tif", pil(Image.fromarray(np.concatenate([f, f[..., :1]], -1)), "TIFF"), "PIL")
    add("orient3_37x53.tif", pil(Image.fromarray(f), "TIFF", tiffinfo={274: 3}), "PIL")
    h, w = 37, 53
    tw = th = 16
    tags = base_tags(w, h, 8, 2, 3, 5, predictor=2)
    tags.update({322: (3, [tw]), 323: (3, [th])})
    padded = np.zeros((48, 64, 3), np.uint8)
    padded[:h, :w] = f
    tiles = [_lzw_encode(predict(padded[y: y + th, x: x + tw]).tobytes()) for y in range(0, h, th)
             for x in range(0, w, tw)]
    add("tiled_lzw_pred2_37x53.tif", tiff("<", tags, tiles), "hand")
    planes = [zlib.compress(f[y: y + 8, :, c].tobytes()) for c in range(3) for y in range(0, h, 8)]
    tags = base_tags(w, h, 8, 2, 3, 8, planar=2)
    tags[278] = (3, [8])
    add("planar2_deflate_37x53.tif", tiff("<", tags, planes), "hand")
    big = noise[..., :3].astype(np.uint16)
    tags = base_tags(w, h, 16, 2, 3, 5, predictor=2)
    tags[278] = (3, [10])
    strips = [_lzw_encode(predict(big[y: y + 10]).astype(">u2").tobytes()) for y in range(0, h, 10)]
    add("bigendian_rgb16_lzw_pred2_37x53.tif", tiff(">", tags, strips), "hand")
    tags = base_tags(w, h, 8, 2, 3, 32773, predictor=2)  # libtiff ignores a predictor after PackBits
    tags[278] = (3, [10])
    strips = [packbits(f[y: y + 10].tobytes()) for y in range(0, h, 10)]
    add("packbits_predictor_tag_37x53.tif", tiff("<", tags, strips), "hand")
    tags = base_tags(w, h, 8, 0, 1, 1)
    tags[278] = (3, [h])
    add("miniswhite_37x53.tif", tiff(">", tags, [f[..., 1].tobytes()]), "hand")
    cmap = np.random.default_rng(41).integers(0, 65536, (3, 256), dtype=np.uint16)
    tags = base_tags(w, h, 8, 3, 1, 1)
    tags.update({278: (3, [h]), 320: (3, cmap.reshape(-1).tolist())})
    add("pal8_cmap16_37x53.tif", tiff("<", tags, [blocks(42, h, w, 256).tobytes()]), "hand")
    tags = base_tags(w, h, 8, 2, 4, 1, planar=2)
    tags.update({278: (3, [h]), 338: (3, [2])})
    rgba = np.concatenate([f, np.random.default_rng(43).integers(0, 256, (h, w, 1), dtype=np.uint8)], -1)
    add("planar2_unassoc_alpha_37x53.tif", tiff("<", tags, [rgba[..., c].tobytes() for c in range(4)]), "hand")
    jpeg_tags = base_tags(w, h, 8, 2, 3, 7)
    jpeg_tags[278] = (3, [h])
    raises["jpeg_in_tiff_37x53.tif"] = (tiff("<", jpeg_tags, [b"\0" * 16]), "hand", "NotImplementedError")
    raises["orient6_37x53.tif"] = (pil(Image.fromarray(f), "TIFF", tiffinfo={274: 6}), "PIL", "FileNotFoundError")
    # --- lossless WebP (libwebp through PIL and cv2)
    f = frame(50, 37, 53)
    for method in (0, 3, 6):
        add(f"vp8l_m{method}_37x53.webp", pil(Image.fromarray(f), "WEBP", lossless=True, method=method), "PIL")
    add("vp8l_cv2_64x96.webp", cv2_bytes(".webp", frame(51, 64, 96)), "cv2")
    y, x = np.mgrid[0:48, 0:64]
    quad = np.stack([x * x // 16 + y, y * y // 9 + x, x * y // 8], -1).clip(0, 255).astype(np.uint8)
    add("vp8l_quad_m4_48x64.webp", pil(Image.fromarray(quad), "WEBP", lossless=True, method=4), "PIL")  # modes 12, 13
    for n in (2, 4, 12, 200):
        add(f"vp8l_pal{n}_37x53.webp", pil(Image.fromarray(f).quantize(n).convert("RGB"), "WEBP", lossless=True),
            "PIL")
    add("vp8l_rgba_37x53.webp", pil(Image.fromarray(np.concatenate([f, f[..., :1]], -1)), "WEBP", lossless=True),
        "PIL")
    add("vp8x_exif6_37x53.webp", pil(Image.fromarray(f), "WEBP", lossless=True, exif=exif), "PIL")
    # --- lossy WebP (VP8, libwebp through PIL and cv2; alpha and animations)
    add("vp8_lossy_37x53.webp", pil(Image.fromarray(f), "WEBP", quality=80), "PIL")
    add("vp8_alpha_37x53.webp", pil(Image.fromarray(np.concatenate([f, f[..., :1]], -1)), "WEBP", quality=80), "PIL")
    for quality in (90, 10):
        add(f"vp8_cv2_q{quality}_48x64.webp", cv2_bytes(".webp", frame(52, 48, 64), [cv2.IMWRITE_WEBP_QUALITY, quality]),
            "cv2")
    for method in (0, 6):
        add(f"vp8_m{method}_37x53.webp", pil(Image.fromarray(frame(53, 37, 53)), "WEBP", quality=75, method=method),
            "PIL")
    for h, w in ((1, 1), (17, 33)):
        add(f"vp8_{h}x{w}.webp", pil(Image.fromarray(frame(54, h, w)), "WEBP", quality=80), "PIL")
    add("vp8x_exif6_lossy_37x53.webp", pil(Image.fromarray(f), "WEBP", quality=80, exif=exif), "PIL")
    anim = [Image.fromarray(frame(55 + k, 40, 48)) for k in range(3)]
    add("vp8_anim_40x48.webp", pil(anim[0], "WEBP", save_all=True, append_images=anim[1:], quality=70, duration=100),
        "PIL")
    add("vp8_anmf_offset_40x48.webp", anmf_offset(), "hand")
    # --- JPEG kinds still refused: headers made from a baseline file
    base = cv2_bytes(".jpg", frame(60, 24, 32))
    sof = base.index(b"\xff\xc0")
    raises["arithmetic_24x32.jpg"] = (base[:sof] + b"\xff\xc9" + base[sof + 2:], "hand", "NotImplementedError")
    raises["lossless_sof3_24x32.jpg"] = (base[:sof] + b"\xff\xc3" + base[sof + 2:], "hand", "NotImplementedError")
    raises["twelve_bit_24x32.jpg"] = (base[:sof + 4] + b"\x0c" + base[sof + 5:], "hand", "NotImplementedError")
    return files, raises


def riff_chunk(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def anmf_offset() -> bytes:
    """A two-frame animated WebP on a 48x40 canvas whose first frame, lossy
    20x16, sits at (6, 4); the second covers the canvas (lossless)."""
    def frame_chunks(data: bytes) -> bytes:
        return data[12:]  # the chunks of a simple-format file
    small = frame_chunks(pil(Image.fromarray(frame(58, 16, 20)), "WEBP", quality=80))
    full = frame_chunks(pil(Image.fromarray(frame(59, 40, 48)), "WEBP", lossless=True))
    body = riff_chunk(b"VP8X", bytes([0x02, 0, 0, 0]) + (47).to_bytes(3, "little") + (39).to_bytes(3, "little"))
    body += riff_chunk(b"ANIM", bytes(4) + struct.pack("<H", 0))
    for (x, y, w, h), chunks in (((6, 4, 20, 16), small), ((0, 0, 48, 40), full)):
        head = b"".join(v.to_bytes(3, "little") for v in (x // 2, y // 2, w - 1, h - 1, 100)) + b"\0"
        body += riff_chunk(b"ANMF", head + chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def pixels_entry(path: Path) -> dict:
    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(), "shape": list(img.shape)}


def main() -> int:
    files, raises = make()
    manifest = {"files": {}, "raises": {}}
    for name, (data, tool) in files.items():
        (HERE / name).write_bytes(data)
        manifest["files"][name] = {"tool": tool, **pixels_entry(HERE / name)}
    for name, (data, tool, error) in raises.items():
        (HERE / name).write_bytes(data)
        manifest["raises"][name] = {"tool": tool, "error": error}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(len(d[0]) for d in list(files.values()) + list(raises.values()))
    print(f"{len(files)} fixtures and {len(raises)} refused, {total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
