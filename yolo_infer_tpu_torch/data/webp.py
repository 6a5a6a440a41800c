"""WebP decode (lossless and lossy) and lossless encode in numpy, to the pixels of `cv2.imread`.

The JAX package reads WebP through OpenCV (libwebp underneath); the port
reads it itself (`decode_webp`, RFC 9649):

  - the RIFF container: the simple form (one `VP8L` or `VP8 ` chunk) and
    the extended one (`VP8X`), whose `EXIF` chunk's orientation is applied
    as OpenCV applies it; an animation (`ANIM`, `ANMF`) gives its first
    frame, lossy or lossless, at its offset on a zeroed canvas, as
    libwebp's `WebPAnimDecoder` gives it;
  - lossy frames (`VP8 `): a VP8 key frame through `data/vp8.py`, then
    libwebp's default conversion to RGB (`fancy_upsample_rgb`); an `ALPH`
    chunk's header is checked;
  - lossless frames (`VP8L`): prefix codes (the simple one- and two-symbol
    codes and the normal code read through its code-length code, with
    repeat codes 16, 17 and 18 and the optional max_symbol; a code of one
    symbol takes no bits), meta prefix codes (the entropy image and its
    groups), the colour cache (hash 0x1e35a7bd), LZ77 backward references
    with the 120-entry distance map, and the four transforms, undone in
    reverse order: the predictor's 14 modes (with its top-row, left-column
    and right-edge rules), cross-colour, subtract-green, and colour
    indexing with pixel bundling for palettes of 16 colours or fewer;
  - alpha is dropped, as OpenCV's BGR read drops it.

The lossless entropy decoder and predictor are Python loops, the rest
numpy. Malformed data raises `ValueError`.

`encode_webp` writes a VP8L file: the subtract-green transform, no colour
cache, no backward references, one group of length-limited Huffman codes.
"""

from __future__ import annotations

import heapq
import struct
from typing import List, Sequence, Tuple, Union

import numpy as np

from yolo_infer_tpu_torch.data.jpeg import apply_orientation, exif_orientation
from yolo_infer_tpu_torch.data.vp8 import Vp8Decoder, key_frame_size

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# (dy << 4) | (8 - dx) of each of the 120 short distance codes (RFC 9649 4.2.2)
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c58454b343c035759131d565a232d"
    "444c555b333d68026769121e666a222e545c434d656b323e78017779535d111f646c424e767a212f757b313f636d525e"
    "00747c414f1020626e30737d515f40727e616f50717f6070")
_CACHE_MUL = 0x1E35A7BD
_PREDICTOR, _CROSS_COLOR, _SUBTRACT_GREEN, _COLOR_INDEXING = range(4)


class _Reader:
    """An LSB-first bit reader over 32-bit little-endian windows at every byte."""

    def __init__(self, data: bytes):
        b = np.frombuffer(data + b"\0" * 8, np.uint8).astype(np.uint32)
        self.win = (b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)).tolist()
        self.limit = len(data) * 8
        self.p = 0

    def bits(self, n: int) -> int:
        v = (self.win[self.p >> 3] >> (self.p & 7)) & ((1 << n) - 1)
        self.p += n
        if self.p > self.limit:
            raise ValueError("corrupt WebP: the bitstream ends early")
        return v


def _huffman(lengths: Sequence[int]) -> Tuple[List[int], int]:
    """(table, mask): table[next bits & mask] = (symbol << 4) | length, the
    canonical code (shorter codes first, then by symbol) read LSB-first; a
    code of one symbol takes no bits."""
    used = [(n, s) for s, n in enumerate(lengths) if n]
    if not used:
        raise ValueError("corrupt WebP: an empty prefix code")
    if len(used) == 1:
        return [used[0][1] << 4], 0
    if sum(1 << (15 - n) for n, _ in used) != 1 << 15:
        raise ValueError("corrupt WebP: an incomplete prefix code")
    top = max(n for n, _ in used)
    table = [0] * (1 << top)
    code, prev = 0, 0
    for n, s in sorted(used):
        code <<= n - prev
        prev = n
        rev = int(format(code, f"0{n}b")[::-1], 2)
        table[rev::1 << n] = [(s << 4) | n] * (1 << (top - n))
        code += 1
    return table, (1 << top) - 1


def _read_code(r: _Reader, alphabet: int) -> Tuple[List[int], int]:
    lengths = [0] * alphabet
    if r.bits(1):  # simple code
        two = r.bits(1)
        first = r.bits(8 if r.bits(1) else 1)
        if first >= alphabet:
            raise ValueError("corrupt WebP: a simple code's symbol is out of range")
        lengths[first] = 1
        if two:
            second = r.bits(8)
            if second >= alphabet:
                raise ValueError("corrupt WebP: a simple code's symbol is out of range")
            lengths[second] = 1
        return _huffman(lengths)
    clens = [0] * 19
    for i in range(r.bits(4) + 4):
        clens[_CODE_LENGTH_ORDER[i]] = r.bits(3)
    table, mask = _huffman(clens)
    max_symbol = alphabet
    if r.bits(1):
        max_symbol = 2 + r.bits(2 + 2 * r.bits(3))
        if max_symbol > alphabet:
            raise ValueError("corrupt WebP: max_symbol past the alphabet")
    symbol, prev = 0, 8
    while symbol < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        e = table[(r.win[r.p >> 3] >> (r.p & 7)) & mask]
        r.p += e & 15
        length = e >> 4
        if length < 16:
            lengths[symbol] = length
            symbol += 1
            if length:
                prev = length
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[length - 16]
        repeat = r.bits(extra) + offset
        if symbol + repeat > alphabet:
            raise ValueError("corrupt WebP: a code-length run past the alphabet")
        lengths[symbol: symbol + repeat] = [prev if length == 16 else 0] * repeat
        symbol += repeat
    return _huffman(lengths)


def _copy_value(r: _Reader, sym: int) -> int:
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + r.bits(extra) + 1


def _decode_image(r: _Reader, xsize: int, ysize: int, level0: bool) -> Union[List[int], np.ndarray]:
    """One entropy-coded image (the main image when `level0`, else a
    transform's or the entropy image's) -> ARGB ints, row-major; the main
    image comes back with its transforms undone."""
    transforms = []
    width = xsize
    if level0:
        seen = set()
        while r.bits(1):
            kind = r.bits(2)
            if kind in seen:
                raise ValueError("corrupt WebP: a transform appears twice")
            seen.add(kind)
            if kind in (_PREDICTOR, _CROSS_COLOR):
                bits = r.bits(3) + 2
                sub = _decode_image(r, -(-width // (1 << bits)), -(-ysize // (1 << bits)), False)
                transforms.append((kind, bits, sub, width))
            elif kind == _SUBTRACT_GREEN:
                transforms.append((kind, 0, None, width))
            else:
                n = r.bits(8) + 1
                palette = np.array(_decode_image(r, n, 1, False), np.uint32).view(np.uint8).reshape(n, 4)
                palette = np.cumsum(palette, axis=0, dtype=np.uint8)  # each entry coded as a delta to the one before
                bits = 3 if n <= 2 else 2 if n <= 4 else 1 if n <= 16 else 0
                full = np.zeros((256, 4), np.uint8)
                full[:n] = palette
                transforms.append((kind, bits, full.reshape(-1).view(np.uint32), width))
                width = -(-width // (1 << bits))
    cache_bits = 0
    if r.bits(1):
        cache_bits = r.bits(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError("corrupt WebP: colour cache bits out of range")
    meta_bits, groups_of = 0, None
    if level0 and r.bits(1):
        meta_bits = r.bits(3) + 2
        mw = -(-width // (1 << meta_bits))
        entropy = _decode_image(r, mw, -(-ysize // (1 << meta_bits)), False)
        groups_of = [(v >> 8) & 0xFFFF for v in entropy]
    ngroups = max(groups_of) + 1 if groups_of else 1
    alphabet = 256 + 24 + ((1 << cache_bits) if cache_bits else 0)
    groups = [tuple(_read_code(r, n) for n in (alphabet, 256, 256, 256, 40)) for _ in range(ngroups)]
    pixels = _entropy_decode(r, width, ysize, groups, groups_of, meta_bits, cache_bits)
    if not level0:
        return pixels
    img = np.array(pixels, np.uint32)
    for kind, bits, sub, w in reversed(transforms):
        img = _inverse(kind, bits, sub, w, ysize, img)
    return img


def _entropy_decode(r: _Reader, w: int, h: int, groups, groups_of, meta_bits: int, cache_bits: int) -> List[int]:
    n = w * h
    out = [0] * n
    win = r.win
    p = r.p
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    cached = 0  # pixels inserted into the cache so far (inserted lazily, before a lookup)
    meta = groups_of is not None
    mask = (1 << meta_bits) - 1
    mw = -(-w // (1 << meta_bits))
    (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = groups[0]
    pos = x = y = 0
    while pos < n:
        if meta and not x & mask:
            group = groups_of[(y >> meta_bits) * mw + (x >> meta_bits)]
            (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = groups[group]
        e = gt[(win[p >> 3] >> (p & 7)) & gm]
        p += e & 15
        code = e >> 4
        if code < 256:
            e = rt[(win[p >> 3] >> (p & 7)) & rm]
            p += e & 15
            red = e >> 4
            e = bt[(win[p >> 3] >> (p & 7)) & bm]
            p += e & 15
            blue = e >> 4
            e = at[(win[p >> 3] >> (p & 7)) & am]
            p += e & 15
            out[pos] = ((e >> 4) << 24) | (red << 16) | (code << 8) | blue
            pos += 1
            x += 1
            if x == w:
                x = 0
                y += 1
            continue
        if code < 280:
            r.p = p
            length = _copy_value(r, code - 256)
            e = dt[(win[r.p >> 3] >> (r.p & 7)) & dm]
            r.p += e & 15
            dist = _copy_value(r, e >> 4)
            p = r.p
            if dist > 120:
                dist -= 120
            else:
                plane = _CODE_TO_PLANE[dist - 1]
                dist = max(1, (plane >> 4) * w + 8 - (plane & 15))
            if dist > pos or pos + length > n:
                raise ValueError("corrupt WebP: a backward reference outside the image")
            src = pos - dist
            if dist >= length:
                out[pos: pos + length] = out[src: src + length]
            else:
                for i in range(length):
                    out[pos + i] = out[src + i]
            pos += length
            x += length
            while x >= w:
                x -= w
                y += 1
            if meta and x & mask and pos < n:  # a copy that ends inside a block: its group from here
                group = groups_of[(y >> meta_bits) * mw + (x >> meta_bits)]
                (gt, gm), (rt, rm), (bt, bm), (at, am), (dt, dm) = groups[group]
            continue
        if cache is None:
            raise ValueError("corrupt WebP: a colour cache code without a cache")
        while cached < pos:
            v = out[cached]
            cache[((v * _CACHE_MUL) & 0xFFFFFFFF) >> shift] = v
            cached += 1
        out[pos] = cache[code - 280]
        pos += 1
        x += 1
        if x == w:
            x = 0
            y += 1
    if p > r.limit:
        raise ValueError("corrupt WebP: the bitstream ends early")
    r.p = p
    return out


def _inverse(kind: int, bits: int, sub, w: int, h: int, img: np.ndarray) -> np.ndarray:
    """Undo one transform of the main image (ARGB uint32, row-major)."""
    if kind == _SUBTRACT_GREEN:
        green = (img >> 8) & 0xFF
        rb = ((img & 0x00FF00FF) + (green << 16 | green)) & 0x00FF00FF
        return (img & 0xFF00FF00) | rb
    if kind == _COLOR_INDEXING:
        if bits:
            per = 1 << bits
            packed = ((img >> 8) & 0xFF).reshape(h, -1)
            xs = np.arange(w)
            index = (packed[:, xs >> bits] >> ((xs & (per - 1)) * (8 >> bits)).astype(np.uint32)) & (
                (1 << (8 >> bits)) - 1)
        else:
            index = ((img >> 8) & 0xFF).reshape(h, w)
        return sub[index.reshape(-1)]
    bw = -(-w // (1 << bits))
    ys, xs = np.divmod(np.arange(w * h), w)
    block = np.array(sub, np.uint32)[(ys >> bits) * bw + (xs >> bits)]
    if kind == _CROSS_COLOR:
        def delta(t, c):  # ColorTransformDelta: int8 * int8 >> 5
            return (t.astype(np.uint8).view(np.int8).astype(np.int32) * c.astype(np.uint8).view(np.int8)) >> 5

        green = (img >> 8) & 0xFF
        red = ((img >> 16) + delta(block & 0xFF, green)) & 0xFF
        blue = ((img & 0xFF) + delta((block >> 8) & 0xFF, green) + delta((block >> 16) & 0xFF, red)) & 0xFF
        return (img & 0xFF00FF00) | (red.astype(np.uint32) << 16) | blue.astype(np.uint32)
    return np.array(_unpredict(img.tolist(), ((block >> 8) & 0xF).tolist(), w, h), np.uint32)


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _select(left: int, top: int, tl: int) -> int:
    d = 0
    for s in (0, 8, 16, 24):
        c = (tl >> s) & 0xFF
        d += abs(((left >> s) & 0xFF) - c) - abs(((top >> s) & 0xFF) - c)
    return top if d <= 0 else left


def _clamp_full(a: int, b: int, c: int) -> int:
    out = 0
    for s in (0, 8, 16, 24):
        v = ((a >> s) & 0xFF) + ((b >> s) & 0xFF) - ((c >> s) & 0xFF)
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _clamp_half(a: int, b: int) -> int:
    out = 0
    for s in (0, 8, 16, 24):
        x, y = (a >> s) & 0xFF, (b >> s) & 0xFF
        v = x + int((x - y) / 2)  # C division: toward zero
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _unpredict(px: List[int], modes: List[int], w: int, h: int) -> List[int]:
    """The predictor transform undone in place: the first pixel adds opaque
    black, the top row its left neighbour, the left column its top one, and
    every other pixel its block's mode; a pixel of the last column takes the
    first pixel of its own row as its top-right."""
    px[0] = _add(px[0], 0xFF000000)
    for i in range(1, w):
        px[i] = _add(px[i], px[i - 1])
    for y in range(1, h):
        row = y * w
        px[row] = _add(px[row], px[row - w])
        for i in range(row + 1, row + w):
            m = modes[i]
            if m == 1:
                pred = px[i - 1]
            elif m == 2:
                pred = px[i - w]
            elif m == 3:
                pred = px[i - w + 1]
            elif m == 4:
                pred = px[i - w - 1]
            elif m == 5:
                pred = _avg(_avg(px[i - 1], px[i - w + 1]), px[i - w])
            elif m == 6:
                pred = _avg(px[i - 1], px[i - w - 1])
            elif m == 7:
                pred = _avg(px[i - 1], px[i - w])
            elif m == 8:
                pred = _avg(px[i - w - 1], px[i - w])
            elif m == 9:
                pred = _avg(px[i - w], px[i - w + 1])
            elif m == 10:
                pred = _avg(_avg(px[i - 1], px[i - w - 1]), _avg(px[i - w], px[i - w + 1]))
            elif m == 11:
                pred = _select(px[i - 1], px[i - w], px[i - w - 1])
            elif m == 12:
                pred = _clamp_full(px[i - 1], px[i - w], px[i - w - 1])
            elif m == 13:
                pred = _clamp_half(_avg(px[i - 1], px[i - w]), px[i - w - 1])
            else:  # 0, and 14 and 15 as libwebp pads its table
                pred = 0xFF000000
            px[i] = _add(px[i], pred)
    return px


def _chunks(data: bytes, pos: int, end: int) -> List[Tuple[bytes, bytes]]:
    """The (fourcc, payload) chunks in data[pos:end], in order."""
    out = []
    while pos + 8 <= end:
        kind, size = data[pos: pos + 4], struct.unpack("<I", data[pos + 4: pos + 8])[0]
        out.append((kind, data[pos + 8: pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _mult_hi(v: np.ndarray, coeff: int) -> np.ndarray:
    return (v * coeff) >> 8


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~((256 << 6) - 1)) == 0, v >> 6, np.where(v < 0, 0, 255))


def fancy_upsample_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's default YUV 4:2:0 to RGB: "fancy" upsampling (each output
    pixel's chroma from its four nearest chroma samples, 9-3-3-1, as
    `UpsampleRgbLinePair` computes it; the first row, and the last of an
    even height, from one chroma row) and `VP8YUVToR/G/B` (14-bit
    fixed point). (h, w) luma, ((h+1)/2, (w+1)/2) chroma -> (h, w, 3)."""
    h, w = y.shape
    r = np.arange(h)
    near = np.where(r & 1, (r - 1) >> 1, r >> 1)
    far = np.clip(np.where(r & 1, near + 1, near - 1), 0, u.shape[0] - 1)
    out = []
    for c in (u, v):
        c = c.astype(np.int32)
        n, f = c[near], c[far]  # (h, cw)
        full = np.empty((h, w), np.int32)
        full[:, 0] = (3 * n[:, 0] + f[:, 0] + 2) >> 2
        pairs = (w - 1) >> 1
        if pairs:
            a, b, cc, d = n[:, :pairs], n[:, 1:pairs + 1], f[:, :pairs], f[:, 1:pairs + 1]
            full[:, 1:2 * pairs:2] = (((a + 3 * b + 3 * cc + d + 8) >> 3) + a) >> 1
            full[:, 2:2 * pairs + 1:2] = (((3 * a + b + cc + 3 * d + 8) >> 3) + b) >> 1
        if not w & 1:
            full[:, w - 1] = (3 * n[:, pairs] + f[:, pairs] + 2) >> 2
        out.append(full)
    uu, vv = out
    yy = _mult_hi(y.astype(np.int32), 19077)
    rgb = np.empty((h, w, 3), np.uint8)
    rgb[..., 0] = _clip8(yy + _mult_hi(vv, 26149) - 14234)
    rgb[..., 1] = _clip8(yy - _mult_hi(uu, 6419) - _mult_hi(vv, 13320) + 8708)
    rgb[..., 2] = _clip8(yy + _mult_hi(uu, 33050) - 17685)
    return rgb


def _check_alph(alph: bytes, w: int, h: int) -> None:
    """An ALPH chunk's header (alpha is dropped, so only its form is checked)."""
    if not alph or (alph[0] & 3) > 1 or ((alph[0] >> 2) & 3) > 3 or (not alph[0] & 3 and len(alph) < 1 + w * h):
        raise ValueError("WebP with a malformed ALPH chunk")


def _decode_lossy(frame: bytes, w: int = 0, h: int = 0) -> np.ndarray:
    """A `VP8 ` chunk (one key frame) -> (H, W, 3) RGB; w, h, when given,
    must be its size."""
    if len(frame) < 10 or frame[0] & 1:
        raise ValueError("a lossy WebP whose VP8 data is not a key frame")
    fw, fh = key_frame_size(frame)
    if w and (fw, fh) != (w, h):
        raise ValueError(f"a lossy WebP whose VP8 frame ({fw}x{fh}) is not the canvas's size ({w}x{h})")
    planes = Vp8Decoder().decode(frame)
    if planes is None:
        raise ValueError("a lossy WebP whose VP8 frame is not shown")
    return fancy_upsample_rgb(*planes)


def _decode_lossless(body: bytes) -> np.ndarray:
    """A `VP8L` chunk -> (H, W, 3) RGB (alpha dropped)."""
    if len(body) < 5 or body[0] != 0x2F:
        raise ValueError("WebP without a VP8L bitstream")
    r = _Reader(body[1:])
    w, h = r.bits(14) + 1, r.bits(14) + 1
    r.bits(1)  # alpha_is_used: a hint only
    if r.bits(3):
        raise ValueError("VP8L version is not 0")
    argb = _decode_image(r, w, h, True)
    return np.ascontiguousarray(argb.view(np.uint8).reshape(h, w, 4)[..., 2::-1])  # B, G, R, A in memory


def _decode_frame(chunks: List[Tuple[bytes, bytes]], w: int = 0, h: int = 0) -> np.ndarray:
    """The image of a still file's chunks, or of one ANMF frame's."""
    kinds = dict(chunks[::-1])  # the first chunk of each kind
    if b"VP8 " in kinds:
        if b"ALPH" in kinds:
            _check_alph(kinds[b"ALPH"], *key_frame_size(kinds[b"VP8 "]))
        return _decode_lossy(kinds[b"VP8 "], w, h)
    if b"VP8L" in kinds:
        return _decode_lossless(kinds[b"VP8L"])
    raise ValueError("WebP without a VP8 or VP8L bitstream")


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> uint8 (H, W, 3) RGB, the pixels of `cv2.imread(path,
    cv2.IMREAD_COLOR)` in RGB order: lossless or lossy, with or without
    alpha (dropped), an animation's first frame on its zeroed canvas."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    chunks = _chunks(data, 12, min(len(data), 8 + struct.unpack("<I", data[4:8])[0]))
    kinds = dict(chunks[::-1])
    vp8x = kinds.get(b"VP8X")
    cw = ch = 0
    if vp8x is not None:
        if len(vp8x) < 10:
            raise ValueError("WebP with a short VP8X chunk")
        cw, ch = int.from_bytes(vp8x[4:7], "little") + 1, int.from_bytes(vp8x[7:10], "little") + 1
    if b"ANMF" in kinds:
        if vp8x is None:
            raise ValueError("an animated WebP without a VP8X chunk")
        anmf = kinds[b"ANMF"]
        if len(anmf) < 16:
            raise ValueError("WebP with a short ANMF chunk")
        fx, fy = 2 * int.from_bytes(anmf[0:3], "little"), 2 * int.from_bytes(anmf[3:6], "little")
        fw, fh = int.from_bytes(anmf[6:9], "little") + 1, int.from_bytes(anmf[9:12], "little") + 1
        if fx + fw > cw or fy + fh > ch:
            raise ValueError("an animated WebP whose first frame leaves its canvas")
        frame = _decode_frame(_chunks(anmf, 16, len(anmf)), fw, fh)
        if frame.shape[:2] != (fh, fw):
            raise ValueError("an animated WebP whose frame is not the size its ANMF chunk gives")
        rgb = np.zeros((ch, cw, 3), np.uint8)
        rgb[fy:fy + fh, fx:fx + fw] = frame
        return rgb
    rgb = _decode_frame(chunks, cw, ch)
    orientation = 1
    exif = kinds.get(b"EXIF")
    if exif is not None and vp8x is not None:
        orientation = exif_orientation(exif if exif.startswith(b"Exif\0\0") else b"Exif\0\0" + exif)
    return apply_orientation(rgb, orientation)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _limited_lengths(hist: np.ndarray, limit: int) -> np.ndarray:
    """Huffman code lengths of at most `limit` bits for the symbols of
    `hist` (complete codes: counts below a floor are raised to it, doubled
    until the tree is shallow enough)."""
    nz = np.flatnonzero(hist)
    floor = 1
    while True:
        heap = [(max(int(hist[s]), floor), i, [int(s)]) for i, s in enumerate(nz)]
        heapq.heapify(heap)
        depth = dict.fromkeys(nz.tolist(), 0)
        tie = len(heap)
        while len(heap) > 1:
            a, _, sa = heapq.heappop(heap)
            b, _, sb = heapq.heappop(heap)
            for s in sa + sb:
                depth[s] += 1
            heapq.heappush(heap, (a + b, tie, sa + sb))
            tie += 1
        if max(depth.values()) <= limit:
            lengths = np.zeros(len(hist), np.int64)
            for s, d in depth.items():
                lengths[s] = d
            return lengths
        floor *= 2


def _canonical(lengths: np.ndarray) -> np.ndarray:
    """The bit-reversed canonical codes of `lengths` (written LSB-first)."""
    codes = np.zeros(len(lengths), np.int64)
    code, prev = 0, 0
    for n, s in sorted((int(n), int(s)) for s, n in enumerate(lengths) if n):
        code <<= n - prev
        prev = n
        codes[s] = int(format(code, f"0{n}b")[::-1], 2)
        code += 1
    return codes


def _write_code(emit, hist: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Write a prefix code for `hist` -> (codes, lengths) by symbol, a
    symbol of a one-symbol code taking no bits."""
    used = np.flatnonzero(hist)
    if len(used) <= 1:
        sym = int(used[0]) if len(used) else 0
        emit(1, 1)
        emit(0, 1)
        emit(int(sym >= 2), 1)
        emit(sym, 8 if sym >= 2 else 1)
        return np.zeros(len(hist), np.int64), np.zeros(len(hist), np.int64)
    lengths = _limited_lengths(hist, 15)
    clen_hist = np.bincount(lengths, minlength=19)
    clens = _limited_lengths(clen_hist, 7)
    if (clens > 0).sum() == 1:
        clens[np.flatnonzero(clens)[0]] = 1
    num = max(4, max(i + 1 for i, s in enumerate(_CODE_LENGTH_ORDER) if clens[s]))
    emit(0, 1)
    emit(num - 4, 4)
    for s in _CODE_LENGTH_ORDER[:num]:
        emit(int(clens[s]), 3)
    emit(0, 1)  # no max_symbol: every symbol's length follows
    if (clens > 0).sum() == 1:
        ccodes, cl = np.zeros(19, np.int64), np.zeros(19, np.int64)
    else:
        ccodes, cl = _canonical(clens), clens
    for n in lengths.tolist():
        emit(int(ccodes[n]), int(cl[n]))
    return _canonical(lengths), lengths


def encode_webp(img: np.ndarray) -> bytes:
    """uint8 (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA -> lossless WebP
    bytes (VP8L) that decode to the same pixels."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.ndim != 3 or img.shape[-1] not in (3, 4) or img.dtype != np.uint8:
        raise ValueError(f"save_image: expected uint8 (H, W), (H, W, 3) or (H, W, 4), got {img.shape}")
    h, w = img.shape[:2]
    if not (0 < w <= 16384 and 0 < h <= 16384):
        raise ValueError(f"save_image: {w}x{h} is outside WebP's size range")
    g = img[..., 1].reshape(-1)
    r = (img[..., 0] - img[..., 1]).reshape(-1)  # subtract green, mod 256
    b = (img[..., 2] - img[..., 1]).reshape(-1)
    a = img[..., 3].reshape(-1) if img.shape[-1] == 4 else np.full(h * w, 255, np.uint8)
    head_v: List[int] = []
    head_n: List[int] = []

    def emit(value: int, n: int) -> None:
        head_v.append(value)
        head_n.append(n)

    emit(0x2F, 8)
    emit(w - 1, 14)
    emit(h - 1, 14)
    emit(int(img.shape[-1] == 4 and bool((a != 255).any())), 1)
    emit(0, 3)
    emit(1, 1)  # a transform: subtract green
    emit(_SUBTRACT_GREEN, 2)
    emit(0, 1)  # no more transforms
    emit(0, 1)  # no colour cache
    emit(0, 1)  # no meta prefix codes
    tables = []
    for channel, size in ((g, 280), (r, 256), (b, 256), (a, 256)):
        tables.append(_write_code(emit, np.bincount(channel, minlength=size)))
    _write_code(emit, np.zeros(40, np.int64))  # distance: unused
    values = np.stack([t[0][c] for t, c in zip(tables, (g, r, b, a))], axis=1).reshape(-1)
    widths = np.stack([t[1][c] for t, c in zip(tables, (g, r, b, a))], axis=1).reshape(-1)
    values = np.concatenate([np.array(head_v, np.int64), values])
    widths = np.concatenate([np.array(head_n, np.int64), widths])
    bits = []
    for lo in range(0, len(widths), 1 << 20):  # LSB-first, a chunk of emits at a time
        v, n = values[lo: lo + (1 << 20)], widths[lo: lo + (1 << 20)]
        owner = np.repeat(np.arange(len(n), dtype=np.int32), n)
        at = np.arange(len(owner), dtype=np.int64) - (np.cumsum(n) - n)[owner]
        bits.append(((v[owner] >> at) & 1).astype(np.uint8))
    stream = np.packbits(np.concatenate(bits), bitorder="little").tobytes()
    stream += bytes(max(0, 12 - len(stream)))  # OpenCV reads no WebP file under 32 bytes
    chunk = b"VP8L" + struct.pack("<I", len(stream)) + stream + b"\0" * (len(stream) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
