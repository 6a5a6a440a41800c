"""Baseline TIFF decode and encode in numpy, to the pixels of `cv2.imread`.

The JAX package reads TIFF through OpenCV, which reads the first page with
libtiff's RGBA interface (`TIFFReadRGBAStrip` / `TIFFReadRGBATile`,
`tif_getimage.c`) when it wants 8-bit colour; `decode_tiff` gives the same
pixels:

  - both byte orders; the first IFD only (page 0);
  - strips and tiles, planar configuration 1 (contiguous) and 2 (separate);
  - compression none (1), LZW (5: MSB-first codes, 9 to 12 bits, the width
    growing one code early as libtiff's decoder grows it), Deflate (8 and
    32946, `zlib`) and PackBits (32773); fill order 2 reversed first;
  - horizontal differencing (predictor 2) at 8 and 16 bits, undone after
    LZW and Deflate only (libtiff ignores the tag for the other two);
  - 8 or 16 bits per sample: min-is-black and min-is-white grey (16-bit
    samples by their high byte, min-is-white inverted), RGB (16-bit samples
    as (v + 128) // 257, `Bitdepth16To8`), palette (the 16-bit colour map
    by its high byte unless every entry is below 256, `checkcmap`);
  - extra samples dropped; an unassociated alpha first premultiplies the
    colour ((a * v + 127) // 255, `UaToAa`) where libtiff's RGBA reader
    does: RGB contiguous, and every separate-plane image.

Compressions 6 and 7 (JPEG), CCITT, and every other one, BigTIFF, float or
signed samples, other bit depths, and photometric interpretations other
than grey, RGB and palette raise `NotImplementedError` (ROADMAP Queue 1
item 10). Orientations 2, 3 and 4 are applied (a flip, or both); 5 to 8,
which transpose, raise `FileNotFoundError`, as the JAX package's
`load_image` raises when `cv2.imread` returns None for such a file.

`encode_tiff` writes what `cv2.imwrite(".tif")` writes by default in kind
(not byte for byte): LZW with predictor 2, contiguous 8-bit samples, in
strips of about 8 KiB.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

from yolo_infer_tpu_torch.data.jpeg import _windows, apply_orientation, pack_msb_first

_UNSUPPORTED = ("the port reads baseline TIFF (8- or 16-bit grey, RGB or palette; none, LZW, Deflate or PackBits); "
                "{} is ROADMAP Queue 1 item 10")
_TYPES = {1: "B", 2: "c", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii", 11: "", 12: "d",
          16: "Q"}
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8}
_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))  # fill order 2
_COMPRESSIONS = (1, 5, 8, 32946, 32773)  # none, LZW, Deflate (two codes), PackBits


def _read_ifd(data: bytes, o: str, at: int) -> Dict[int, List]:
    (count,) = struct.unpack(o + "H", data[at: at + 2])
    tags: Dict[int, List] = {}
    for i in range(count):
        tag, typ, n, raw = struct.unpack(o + "HHI4s", data[at + 2 + 12 * i: at + 14 + 12 * i])
        if typ not in _TYPES:
            continue
        size = _SIZES[typ] * n
        body = raw[:size] if size <= 4 else data[struct.unpack(o + "I", raw)[0]:][:size]
        if len(body) != size:
            raise ValueError("corrupt TIFF: a tag's values run past the file")
        if typ == 2:
            tags[tag] = [body]
            continue
        vals = list(struct.unpack(o + _TYPES[typ] * n, body))
        tags[tag] = vals
    return tags


def _lzw_decode(data: bytes) -> bytes:
    """libtiff's LZWDecode: MSB-first codes, Clear 256, EOI 257, the width
    growing to 10, 11 and 12 bits when the next free entry is 511, 1023 and
    2047."""
    if data[:1] == b"\0" and len(data) > 1 and data[1] & 1:
        raise NotImplementedError(_UNSUPPORTED.format("old-style (LSB-first) LZW"))
    win = _windows(data)
    total = len(data) * 8
    table = [bytes((i,)) for i in range(256)] + [b"", b""]
    out = []
    p, nbits, prev = 0, 9, None
    while p + nbits <= total:
        code = (win[p >> 3] >> (32 - (p & 7) - nbits)) & ((1 << nbits) - 1)
        p += nbits
        if code == 256:
            del table[258:]
            nbits, prev = 9, None
            continue
        if code == 257:
            break
        if prev is None:
            if code > 255:
                raise ValueError("corrupt TIFF LZW data")
            prev = table[code]
            out.append(prev)
            continue
        if code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("corrupt TIFF LZW data")
        out.append(entry)
        prev = entry
        if len(table) >= (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    return b"".join(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    pos, n = 0, len(data)
    while pos < n:
        h = data[pos]
        pos += 1
        if h < 128:
            out += data[pos: pos + h + 1]
            pos += h + 1
        elif h > 128:
            if pos < n:
                out += data[pos: pos + 1] * (257 - h)
            pos += 1
    return bytes(out)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> uint8 (H, W, 3) RGB of the first page, the pixels of
    `cv2.imread(path, cv2.IMREAD_COLOR)` in RGB order."""
    o = {b"II": "<", b"MM": ">"}.get(data[:2])
    if o is None or len(data) < 8:
        raise ValueError("not a TIFF file")
    (version,) = struct.unpack(o + "H", data[2:4])
    if version == 43:
        raise NotImplementedError(_UNSUPPORTED.format("BigTIFF"))
    if version != 42:
        raise ValueError("not a TIFF file")
    tags = _read_ifd(data, o, struct.unpack(o + "I", data[4:8])[0])

    def one(tag: int, default=None):
        return tags[tag][0] if tag in tags else default

    w, h = one(256), one(257)
    if not w or not h:
        raise ValueError("TIFF without width or height")
    orientation = one(274, 1)
    if 5 <= orientation <= 8:  # OpenCV returns no image for these
        raise FileNotFoundError(f"could not read image (OpenCV reads no TIFF with orientation {orientation})")
    spp = one(277, 1)
    bits = tags.get(258, [1])
    compression, photometric = one(259, 1), one(262)
    planar, predictor, fmt = one(284, 1), one(317, 1), one(339, 1)
    if compression in (6, 7):
        raise NotImplementedError(_UNSUPPORTED.format(f"JPEG-in-TIFF (compression {compression})"))
    if compression not in _COMPRESSIONS:
        raise NotImplementedError(_UNSUPPORTED.format(f"TIFF compression {compression}"))
    depth = bits[0]
    if any(b != depth for b in bits) or depth not in (8, 16) or fmt != 1:
        raise NotImplementedError(_UNSUPPORTED.format(f"TIFF of {bits} bits, sample format {fmt}"))
    if photometric not in (0, 1, 2, 3) or (photometric == 2 and spp < 3) or (photometric == 3 and depth != 8):
        raise NotImplementedError(_UNSUPPORTED.format(
            f"TIFF photometric interpretation {photometric} of {spp} samples at {depth} bits"))
    if predictor not in (1, 2):
        raise NotImplementedError(_UNSUPPORTED.format(f"TIFF predictor {predictor}"))
    separate = planar == 2 and spp > 1
    dtype = np.dtype(o + "u2") if depth == 16 else np.dtype(np.uint8)
    if 322 in tags:  # tiles
        tw, th = one(322), one(323)
        offsets, counts = tags[324], tags[325]
    else:
        tw, th = w, min(one(278, h), h)
        offsets, counts = tags[273], tags.get(279)
        if counts is None:
            raise ValueError("TIFF without StripByteCounts")
    across, down = -(-w // tw), -(-h // th)
    planes = spp if separate else 1
    per_unit = 1 if separate else spp  # samples per pixel inside one strip or tile
    if len(offsets) < across * down * planes or len(counts) < len(offsets):
        raise ValueError("TIFF with too few strips or tiles")
    samples = np.zeros((h, w, spp), dtype.newbyteorder("=") if depth == 16 else np.uint8)
    fill_reversed = one(266, 1) == 2
    i = 0
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                raw = data[offsets[i]: offsets[i] + counts[i]]
                i += 1
                if fill_reversed:
                    raw = raw.translate(_REVERSED)
                if compression == 5:
                    raw = _lzw_decode(raw)
                elif compression in (8, 32946):
                    raw = zlib.decompressobj().decompress(raw)
                elif compression == 32773:
                    raw = _packbits_decode(raw)
                rows = th if 322 in tags else min(th, h - ty * th)
                need = rows * tw * per_unit * dtype.itemsize
                buf = np.zeros(need, np.uint8)
                buf[: min(need, len(raw))] = np.frombuffer(raw, np.uint8, min(need, len(raw)))
                unit = buf.view(dtype).astype(samples.dtype).reshape(rows, tw, per_unit)
                if predictor == 2 and compression != 1 and compression != 32773:  # libtiff: LZW and Deflate only
                    unit = np.cumsum(unit, axis=1, dtype=samples.dtype)
                y0, x0 = ty * th, tx * tw
                ph, pw = min(rows, h - y0), min(tw, w - x0)
                if separate:
                    samples[y0: y0 + ph, x0: x0 + pw, plane] = unit[:ph, :pw, 0]
                else:
                    samples[y0: y0 + ph, x0: x0 + pw] = unit[:ph, :pw]
    img = _to_rgb(samples, depth, photometric, spp, separate, tags)
    return apply_orientation(img, orientation) if orientation in (2, 3, 4) else img


def _extra_alpha(tags: Dict[int, List], spp: int, colour: int) -> int:
    """libtiff's `img->alpha`: 1 associated, 2 unassociated, 0 none."""
    extra = tags.get(338, [])
    if not extra:
        return 1 if spp == 4 and colour == 3 else 0  # DEFAULT_EXTRASAMPLE_AS_ALPHA
    if extra[0] == 0:
        return 1 if spp > 3 else 0
    return extra[0] if extra[0] in (1, 2) else 0


def _to_rgb(samples: np.ndarray, depth: int, photometric: int, spp: int, separate: bool,
            tags: Dict[int, List]) -> np.ndarray:
    """The samples as libtiff's RGBA reader puts them, alpha dropped."""
    def to8(v):  # Bitdepth16To8
        return ((v.astype(np.uint32) + 128) // 257).astype(np.uint8) if depth == 16 else v.astype(np.uint8)

    if photometric == 3:
        cmap = np.array(tags[320], np.int64).reshape(3, -1)
        if cmap.shape[1] < 256:
            cmap = np.concatenate([cmap, np.zeros((3, 256 - cmap.shape[1]), np.int64)], axis=1)
        if (cmap >= 256).any():  # checkcmap: a 16-bit map
            cmap = cmap >> 8
        return cmap.T.astype(np.uint8)[samples[..., 0]]
    colour = 1 if photometric in (0, 1) else 3
    alpha = _extra_alpha(tags, spp, colour)
    if colour == 1 and not separate:
        grey = (samples[..., 0] >> 8).astype(np.uint8) if depth == 16 else samples[..., 0].astype(np.uint8)
        if photometric == 0:
            grey = 255 - grey
        return np.repeat(grey[..., None], 3, axis=-1)
    rgb = to8(samples[..., [0, 0, 0] if colour == 1 else [0, 1, 2]])
    if alpha == 2 and spp > colour:  # UaToAa: premultiply by the unassociated alpha
        a = to8(samples[..., colour]).astype(np.uint32)[..., None]
        rgb = ((rgb.astype(np.uint32) * a + 127) // 255).astype(np.uint8)
    return np.ascontiguousarray(rgb)


def _lzw_encode(data: bytes) -> bytes:
    """LZW as libtiff's LZWEncode codes it (a Clear first, the width growing
    when the next free entry passes the current maximum, a Clear when the
    table is full, EOI last), MSB-first."""
    table = {bytes((i,)): i for i in range(256)}
    codes: List[Tuple[int, int]] = [(256, 9)]
    nbits, maxcode, free = 9, 511, 258
    cur = b""
    for i in range(len(data)):
        nxt = cur + data[i: i + 1]
        if nxt in table:
            cur = nxt
            continue
        codes.append((table[cur], nbits))
        table[nxt] = free
        free += 1
        if free == 4094:
            codes.append((256, nbits))
            table = {bytes((i,)): i for i in range(256)}
            nbits, maxcode, free = 9, 511, 258
        elif free > maxcode:
            nbits += 1
            maxcode = (1 << nbits) - 1
        cur = data[i: i + 1]
    if cur:
        codes.append((table[cur], nbits))
        free += 1
        if free == 4094:
            codes.append((256, nbits))
            nbits = 9
        elif free > maxcode:
            nbits += 1
    codes.append((257, nbits))
    values, widths = (np.array(column, np.int64) for column in zip(*codes))
    return pack_msb_first(values, widths).tobytes()


def encode_tiff(img: np.ndarray) -> bytes:
    """uint8 (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA -> a TIFF (LZW,
    predictor 2, contiguous, strips of about 8 KiB; an RGBA image's fourth
    sample is an unspecified extra sample, which readers do not apply)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3, 4) or img.dtype != np.uint8:
        raise ValueError(f"save_image: expected uint8 (H, W), (H, W, 3) or (H, W, 4), got {img.shape}")
    h, w, spp = img.shape
    rps = max(1, min(h, 8192 // (w * spp)))
    diff = img.astype(np.uint8).copy()
    diff[:, 1:] -= img[:, :-1]  # horizontal differencing, mod 256
    strips = [_lzw_encode(diff[y: y + rps].tobytes()) for y in range(0, h, rps)]
    body = b"".join(s + b"\0" * (len(s) & 1) for s in strips)
    offsets, at = [], 8
    for s in strips:
        offsets.append(at)
        at += len(s) + (len(s) & 1)
    ifd_at = 8 + len(body)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp), (259, 3, [5]), (262, 3, [2 if spp >= 3 else 1]),
               (273, 4, offsets), (277, 3, [spp]), (278, 4, [rps]), (279, 4, [len(s) for s in strips]),
               (284, 3, [1]), (317, 3, [2])] + ([(338, 3, [0])] if spp == 4 else [])
    extra_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, extra = struct.pack("<H", len(entries)), b""
    for tag, typ, vals in entries:
        packed = struct.pack("<" + _TYPES[typ] * len(vals), *vals)
        if len(packed) <= 4:
            ifd += struct.pack("<HHI", tag, typ, len(vals)) + packed.ljust(4, b"\0")
        else:
            ifd += struct.pack("<HHII", tag, typ, len(vals), extra_at + len(extra))
            extra += packed + b"\0" * (len(packed) & 1)
    return b"II*\0" + struct.pack("<I", ifd_at) + body + ifd + struct.pack("<I", 0) + extra
