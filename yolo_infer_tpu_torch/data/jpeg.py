"""Baseline JPEG decode and encode in numpy, to the pixels and bytes of libjpeg-turbo.

The JAX package reads and writes JPEG through OpenCV (`cv2.imread`,
`cv2.imwrite`), which calls libjpeg-turbo with its defaults. The port does
not depend on OpenCV, so it does the same arithmetic itself:

decode (`decode_jpeg`): SOF0, SOF1 and SOF2 (progressive) frames of 8-bit
  samples with Huffman coding, 1, 3 or 4 components, any sampling factors
  whose ratios are integers (444, 422, 420, 440, 411, ...), interleaved or
  one-component scans, DRI restart intervals, `FF00` byte stuffing and fill
  bytes, any width and height; a file without a DHT segment (motion-JPEG
  frames) takes the Annex K.3 Huffman tables, as libjpeg-turbo does.
  Progressive scans are the four kinds of ITU T.81 G.1.2 (`jdphuff.c`): DC
  first and refine, AC first with its end-of-band runs, AC refine with its
  correction bits; coefficients build up across scans in each component's
  array. The entropy decoder is a Python loop over 9-bit lookup tables (a
  code of up to 9 bits, and its magnitude bits where they fit, in one look);
  everything after it is numpy over all blocks at once:
    - the ISLOW integer inverse DCT (`jidctint.c`: 13-bit constants, two
      passes descaled by CONST_BITS - PASS1_BITS and CONST_BITS + PASS1_BITS
      + 3, the output clamped as the SIMD build saturates it);
    - fancy upsampling (`jdsample.c`): h2v1 and h1v2 triangle filters, h2v2
      with its 3/4-1/4 passes and +8/+7 biases, edge samples replicated at
      the component's own downsampled size; a component of width 2 or less,
      and every other ratio (411), replicated;
    - the colour space as `jdapimin.c` guesses it (JFIF, then the Adobe
      marker's transform, then the component ids): YCbCr -> RGB with
      `jdcolor.c`'s 16-bit fixed-point tables; RGB (Adobe transform 0)
      as stored; four components as CMYK (Adobe transform 0 or no Adobe
      marker) or YCCK (`ycck_cmyk_convert`), then to BGR by OpenCV's
      `icvCvt_CMYK2BGR_8u_C4C3R` (k - ((255 - c) * k >> 8));
    - the EXIF Orientation tag (APP1, values 1-8), applied as `cv2.imread`
      with IMREAD_COLOR applies it (transpose and flips).
  Grey files are replicated to three channels.
encode (`encode_jpeg`): what `cv2.imwrite(".jpg")` writes by default, byte
  for byte: quality 95 (`jcparam.c`'s scaled Annex K tables), 4:2:0 (grey:
  one component), the Annex K Huffman tables, no optimisation, a JFIF 1.01
  APP0 header; `jccolor.c`'s RGB -> YCbCr, `jcsample.c`'s edge expansion and
  h2v2 downsampling with alternating biases, `jfdctint.c`'s ISLOW
  forward DCT, `jcdctmgr.c`'s reciprocal quantisation, dummy blocks past the
  image edge as `jccoefct.c` makes them. The encoder is numpy throughout,
  the Huffman bit packing included.

Lossless (SOF3), hierarchical, arithmetic-coded and 12-bit files, a
height given by a DNL marker, and a progressive file whose scans stop
before AC1-AC9 of every component are complete (libjpeg-turbo smooths its
blocks, `jdcoefct.c decompress_smooth_data`, which is not ported) raise
`NotImplementedError` (ROADMAP Queue 1 item 10); malformed data raises
`ValueError`.
"""

from __future__ import annotations

import functools
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

_UNSUPPORTED = ("the port decodes baseline, extended-sequential and progressive Huffman JPEG of 8-bit samples "
                "(grey, YCbCr, RGB, CMYK, YCCK) whose progressive scans complete AC1-AC9; {} is ROADMAP Queue 1 "
                "item 10")

# the natural (row-major) index of the k-th coefficient in zigzag order; 16
# extra entries of 63 absorb a corrupt run past the block, as libjpeg's
# jpeg_natural_order does
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
    21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60,
    61, 54, 47, 55, 62, 63], np.int64)
_ZZ_SAFE = ZIGZAG.tolist() + [63] * 16

# Annex K.1 quantisation tables, natural order
STD_LUMA_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMA_QT = np.full(64, 99, np.int64)
STD_CHROMA_QT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3 Huffman tables: (counts of codes of length 1..16, symbols)
STD_HUFFMAN = {
    "dc_luma": ("00010501010101010100000000000000", "000102030405060708090a0b"),
    "ac_luma": ("0002010303020403050504040000017d",
                "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
                "292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a83848586878889"
                "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
                "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    "dc_chroma": ("00030101010101010101010000000000", "000102030405060708090a0b"),
    "ac_chroma": ("00020102040403040705040400010277",
                  "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a"
                  "262728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485"
                  "868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7"
                  "d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}

# the ISLOW DCT's constants, FIX(x) = round(x * 2**13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172

# the colour converters' constants, FIX(x) = round(x * 2**16)
SCALEBITS, ONE_HALF = 16, 1 << 15


def _fix16(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


FAST_BITS = 9  # the width of the entropy decoder's lookup tables


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------

class _HuffTable:
    """A decoding table: `lut[next 9 bits]` = (code length << 8) | symbol for
    codes of up to 9 bits (0: longer); `fast[next 9 bits]` = (bits used,
    run, value) where a code and its magnitude bits fit in 9 bits together
    (None: not); canonical `maxcode`/`valptr`/`mincode` for longer codes."""

    def __init__(self, counts: Sequence[int], symbols: Sequence[int], ac: bool):
        if sum(counts) != len(symbols) or len(symbols) > 256:
            raise ValueError("corrupt Huffman table")
        self.symbols = list(symbols)
        self.lut = [0] * (1 << FAST_BITS)
        self.fast = [None] * (1 << FAST_BITS)
        self.maxcode = [-1] * 17
        self.valptr = [0] * 17
        self.mincode = [0] * 17
        code = k = 0
        for length in range(1, 17):
            self.valptr[length], self.mincode[length] = k, code
            for _ in range(counts[length - 1]):
                if code >= 1 << length:
                    raise ValueError("corrupt Huffman table: code space overflows")
                sym = symbols[k]
                if length <= FAST_BITS:
                    spare = FAST_BITS - length
                    first = code << spare
                    for idx in range(first, first + (1 << spare)):
                        self.lut[idx] = (length << 8) | sym
                    size = sym & 15
                    if size and length + size <= FAST_BITS:  # the magnitude bits fit too
                        run = sym >> 4 if ac else 0
                        for idx in range(first, first + (1 << spare)):
                            bits = (idx >> (spare - size)) & ((1 << size) - 1)
                            value = bits if bits >= 1 << (size - 1) else bits - (1 << size) + 1
                            self.fast[idx] = (length + size, run, value)
                code += 1
                k += 1
            self.maxcode[length] = code - 1 if counts[length - 1] else -1
            code <<= 1

    def slow(self, window: int, off: int) -> Tuple[int, int]:
        """(symbol, length) of a code longer than FAST_BITS at bit `off` of a 32-bit window."""
        for length in range(FAST_BITS + 1, 17):
            code = (window >> (32 - off - length)) & ((1 << length) - 1)
            if code <= self.maxcode[length]:
                return self.symbols[self.valptr[length] + code - self.mincode[length]], length
        raise ValueError("corrupt JPEG data: bad Huffman code")


_STD_SLOTS = {(0, 0): "dc_luma", (1, 0): "ac_luma", (0, 1): "dc_chroma", (1, 1): "ac_chroma"}


@functools.lru_cache(maxsize=1)
def _std_tables() -> Dict[Tuple[int, int], _HuffTable]:
    """The Annex K.3 tables in slots 0 and 1 of each class (`STD_HUFFMAN`),
    built once; a decoder only reads them."""
    return {slot: _HuffTable(*(bytes.fromhex(s) for s in STD_HUFFMAN[key]), ac=bool(slot[0]))
            for slot, key in _STD_SLOTS.items()}


def _parse_dht(body: bytes, tables: Dict[Tuple[int, int], _HuffTable]) -> None:
    pos = 0
    while pos < len(body):
        tc_th = body[pos]
        counts = list(body[pos + 1: pos + 17])
        n = sum(counts)
        symbols = list(body[pos + 17: pos + 17 + n])
        if len(counts) != 16 or len(symbols) != n or tc_th >> 4 > 1 or tc_th & 15 > 3:
            raise ValueError("corrupt DHT segment")
        tables[(tc_th >> 4, tc_th & 15)] = _HuffTable(counts, symbols, ac=bool(tc_th >> 4))
        pos += 17 + n


def _parse_dqt(body: bytes, tables: Dict[int, np.ndarray]) -> None:
    pos = 0
    while pos < len(body):
        pq, tq = body[pos] >> 4, body[pos] & 15
        if pq > 1 or tq > 3:
            raise ValueError("corrupt DQT segment")
        n = 64 * (pq + 1)
        raw = body[pos + 1: pos + 1 + n]
        if len(raw) != n:
            raise ValueError("corrupt DQT segment")
        vals = np.frombuffer(raw, ">u2" if pq else np.uint8).astype(np.int64)
        qt = np.empty(64, np.int64)
        qt[ZIGZAG] = vals  # stored in zigzag order
        tables[tq] = qt
        pos += 1 + n


# ---------------------------------------------------------------------------
# EXIF orientation
# ---------------------------------------------------------------------------

def exif_orientation(app1: bytes) -> int:
    """The Orientation tag (0x0112) of IFD0 in an APP1 "Exif" body, 1 if
    there is none or it is out of range."""
    if not app1.startswith(b"Exif\0\0") or len(app1) < 14:
        return 1
    tiff = app1[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return 1
    try:
        (ifd,) = struct.unpack(order + "I", tiff[4:8])
        (count,) = struct.unpack(order + "H", tiff[ifd: ifd + 2])
        for i in range(count):
            entry = tiff[ifd + 2 + 12 * i: ifd + 14 + 12 * i]
            tag, typ, n = struct.unpack(order + "HHI", entry[:8])
            if tag == 0x0112 and typ == 3 and n >= 1:
                (value,) = struct.unpack(order + "H", entry[8:10])
                return value if 1 <= value <= 8 else 1
    except struct.error:
        return 1
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """`img` as OpenCV's ApplyExifOrientation leaves it for tag values 1-8."""
    if orientation >= 5:
        img = img.transpose(1, 0, *range(2, img.ndim))
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class _Component:
    __slots__ = ("cid", "h", "v", "tq", "qt", "bw", "bh", "coef", "dw", "dh")

    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None


def _entropy_segments(data: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from `pos`, unstuffed and split at RSTn
    markers, and the position of the marker that ends the scan."""
    segments, cur = [], bytearray()
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        if j < 0 or j + 1 >= n:
            raise ValueError("corrupt JPEG: the scan has no end marker")
        cur += data[pos:j]
        nxt = data[j + 1]
        if nxt == 0x00:  # a stuffed 0xFF data byte
            cur.append(0xFF)
            pos = j + 2
        elif nxt == 0xFF:  # a fill byte before a marker
            pos = j + 1
        elif 0xD0 <= nxt <= 0xD7:
            segments.append(bytes(cur))
            cur = bytearray()
            pos = j + 2
        else:
            segments.append(bytes(cur))
            return segments, j


def _windows(segment: bytes) -> List[int]:
    """32-bit big-endian windows starting at every byte (zero bits past the
    end, as libjpeg inserts zeros at a marker), and a few more all-zero ones."""
    b = np.frombuffer(segment + b"\0" * 8, np.uint8).astype(np.uint32)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


def _decode_scan(segments: List[bytes], comps: List[_Component], scomps: List[Tuple[_Component, _HuffTable,
                 _HuffTable]], mcux: int, mcuy: int, restart: int) -> None:
    """Entropy-decode one baseline scan into each component's `coef` list
    (64 coefficients per block, natural order, before dequantisation)."""
    zz = _ZZ_SAFE
    if len(scomps) == 1:  # a one-component scan covers the component's own blocks, one per MCU
        c = scomps[0][0]
        nx, ny = -(-c.dw // 8), -(-c.dh // 8)
        plan = [(0, 0, 0)]
    else:
        nx, ny = mcux, mcuy
        plan = [(si, dy, dx) for si, (c, _, _) in enumerate(scomps) for dy in range(c.v) for dx in range(c.h)]
    coefs = [c.coef for c, _, _ in scomps]
    dcs = [t for _, t, _ in scomps]
    acs = [t for _, _, t in scomps]
    geom = [(c.h, c.v, c.bw) if len(scomps) > 1 else (1, 1, c.bw) for c, _, _ in scomps]
    total = nx * ny
    seg_i = 0
    win = _windows(segments[0]) if segments else [0] * 8
    limit = len(win) - 4
    p = 0
    pred = [0] * len(scomps)
    for m in range(total):
        if restart and m and m % restart == 0:
            seg_i += 1
            win = _windows(segments[seg_i]) if seg_i < len(segments) else [0] * 8
            limit = len(win) - 4
            p = 0
            pred = [0] * len(scomps)
        my, mx = divmod(m, nx)
        for si, dy, dx in plan:
            h, v, bw = geom[si]
            blk = coefs[si]
            base = ((my * v + dy) * bw + mx * h + dx) * 64
            # DC
            t = dcs[si]
            if p >> 3 >= limit:
                raise ValueError("corrupt JPEG data: the scan ends early")
            w = win[p >> 3]
            off = p & 7
            idx = (w >> (32 - FAST_BITS - off)) & 511
            e = t.fast[idx]
            if e is not None:
                p += e[0]
                pred[si] += e[2]
            else:
                e = t.lut[idx]
                if e:
                    p += e >> 8
                    s = e & 255
                else:
                    s, length = t.slow(w, off)
                    p += length
                if s:
                    w = win[p >> 3]
                    bits = (w >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    pred[si] += bits if bits >> (s - 1) else bits - (1 << s) + 1
            blk[base] = pred[si]
            # AC
            t = acs[si]
            fast, lut = t.fast, t.lut
            k = 1
            while k < 64:
                w = win[p >> 3]
                off = p & 7
                idx = (w >> (23 - off)) & 511
                e = fast[idx]
                if e is not None:
                    p += e[0]
                    k += e[1]
                    blk[base + zz[k]] = e[2]
                    k += 1
                    continue
                e = lut[idx]
                if e:
                    p += e >> 8
                    rs = e & 255
                else:
                    rs, length = t.slow(w, off)
                    p += length
                s = rs & 15
                if s:
                    k += rs >> 4
                    w = win[p >> 3]
                    bits = (w >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                    p += s
                    blk[base + zz[k]] = bits if bits >> (s - 1) else bits - (1 << s) + 1
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break
            if p >> 3 >= limit:
                raise ValueError("corrupt JPEG data: the scan ends early")


def _decode_progressive_scan(segments: List[bytes], scomps: List[Tuple[_Component, _HuffTable, _HuffTable]],
                             mcux: int, mcuy: int, restart: int, ss: int, se: int, ah: int, al: int) -> None:
    """Entropy-decode one progressive scan (`jdphuff.c`) into each component's
    `coef` list: DC first (the prediction shifted left by Al) and refine (one
    bit per block), AC first over Ss..Se with end-of-band runs, AC refine
    with its correction bits on the coefficients already nonzero."""
    zz = _ZZ_SAFE
    if len(scomps) == 1:
        c = scomps[0][0]
        nx, ny = -(-c.dw // 8), -(-c.dh // 8)
        plan = [(0, 0, 0)]
    else:
        nx, ny = mcux, mcuy
        plan = [(si, dy, dx) for si, (c, _, _) in enumerate(scomps) for dy in range(c.v) for dx in range(c.h)]
    coefs = [c.coef for c, _, _ in scomps]
    geom = [(c.h, c.v, c.bw) if len(scomps) > 1 else (1, 1, c.bw) for c, _, _ in scomps]
    tables = [t for _, t, _ in scomps] if ss == 0 else [t for _, _, t in scomps]
    p1, m1 = 1 << al, -1 << al
    seg_i = 0
    win = _windows(segments[0]) if segments else [0] * 8
    limit = len(win) - 4
    p = 0
    pred = [0] * len(scomps)
    eobrun = 0

    def symbol(t: _HuffTable) -> int:
        nonlocal p
        w = win[p >> 3]
        off = p & 7
        e = t.lut[(w >> (23 - off)) & 511]
        if e:
            p += e >> 8
            return e & 255
        s, length = t.slow(w, off)
        p += length
        return s

    def bits(n: int) -> int:
        nonlocal p
        v = (win[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1)
        p += n
        return v

    for m in range(nx * ny):
        if restart and m and m % restart == 0:
            seg_i += 1
            win = _windows(segments[seg_i]) if seg_i < len(segments) else [0] * 8
            limit = len(win) - 4
            p = 0
            pred = [0] * len(scomps)
            eobrun = 0
        my, mx = divmod(m, nx)
        for si, dy, dx in plan:
            if p >> 3 >= limit:
                raise ValueError("corrupt JPEG data: the scan ends early")
            h, v, bw = geom[si]
            blk = coefs[si]
            base = ((my * v + dy) * bw + mx * h + dx) * 64
            if ss == 0:
                if ah:  # DC refine: one bit
                    if (win[p >> 3] >> (31 - (p & 7))) & 1:
                        blk[base] |= p1
                    p += 1
                else:  # DC first
                    s = symbol(tables[si])
                    if s:
                        b = bits(s)
                        pred[si] += b if b >> (s - 1) else b - (1 << s) + 1
                    blk[base] = pred[si] << al
                continue
            t = tables[si]
            if not ah:  # AC first
                if eobrun:
                    eobrun -= 1
                    continue
                k = ss
                while k <= se:
                    w = win[p >> 3]
                    idx = (w >> (23 - (p & 7))) & 511
                    e = t.fast[idx]
                    if e is not None:
                        p += e[0]
                        k += e[1]
                        blk[base + zz[k]] = e[2] << al
                        k += 1
                        continue
                    rs = symbol(t)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        b = bits(s)
                        blk[base + zz[k]] = (b if b >> (s - 1) else b - (1 << s) + 1) << al
                    elif r == 15:
                        k += 15
                    else:
                        eobrun = (1 << r) + (bits(r) if r else 0) - 1
                        break
                    k += 1
                continue
            # AC refine
            k = ss
            if not eobrun:
                while k <= se:
                    rs = symbol(t)
                    r, s = rs >> 4, rs & 15
                    if s:
                        s = p1 if bits(1) else m1
                    elif r != 15:
                        eobrun = (1 << r) + (bits(r) if r else 0)
                        break
                    while k <= se:  # pass r zero coefficients, correcting the nonzero ones on the way
                        at = base + zz[k]
                        cur = blk[at]
                        if cur:
                            if (win[p >> 3] >> (31 - (p & 7))) & 1 and not cur & p1:
                                blk[at] = cur + (p1 if cur >= 0 else m1)
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if s:
                        blk[base + zz[k]] = s
                    k += 1
            if eobrun:
                while k <= se:
                    at = base + zz[k]
                    cur = blk[at]
                    if cur:
                        if (win[p >> 3] >> (31 - (p & 7))) & 1 and not cur & p1:
                            blk[at] = cur + (p1 if cur >= 0 else m1)
                        p += 1
                    k += 1
                eobrun -= 1
        if p >> 3 >= limit:
            raise ValueError("corrupt JPEG data: the scan ends early")


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantised coefficients -> (N, 8, 8) uint8 samples: libjpeg's
    jpeg_idct_islow, output clamped to 0..255 after the level shift."""
    def one_pass(d, shift):
        # d: (..., 8) frequencies along the last axis -> (..., 8) samples
        z2, z3 = d[..., 2], d[..., 6]
        z1 = (z2 + z3) * FIX_0_541196100
        tmp2 = z1 - z3 * FIX_1_847759065
        tmp3 = z1 + z2 * FIX_0_765366865
        z2, z3 = d[..., 0], d[..., 4]
        tmp0 = (z2 + z3) << CONST_BITS
        tmp1 = (z2 - z3) << CONST_BITS
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        t0, t1, t2, t3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
        z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
        z5 = (z3 + z4) * FIX_1_175875602
        t0 = t0 * FIX_0_298631336
        t1 = t1 * FIX_2_053119869
        t2 = t2 * FIX_3_072711026
        t3 = t3 * FIX_1_501321110
        z1 = z1 * -FIX_0_899976223
        z2 = z2 * -FIX_2_562915447
        z3 = z3 * -FIX_1_961570560 + z5
        z4 = z4 * -FIX_0_390180644 + z5
        t0 = t0 + z1 + z3
        t1 = t1 + z2 + z4
        t2 = t2 + z2 + z3
        t3 = t3 + z1 + z4
        rnd = 1 << (shift - 1)
        out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], axis=-1)
        return (out + rnd) >> shift

    c = coef.astype(np.int64)
    ws = one_pass(c.transpose(0, 2, 1), CONST_BITS - PASS1_BITS)  # columns: (N, col, row)
    out = one_pass(ws.transpose(0, 2, 1), CONST_BITS + PASS1_BITS + 3)  # rows: (N, row, col)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _upsample(plane: np.ndarray, hx: int, vx: int) -> np.ndarray:
    """A component's (dh, dw) samples expanded by (vx, hx) as jdsample.c
    expands them with fancy upsampling on."""
    if hx == 1 and vx == 1:
        return plane
    x = plane.astype(np.int32)
    dh, dw = x.shape
    if hx == 2 and vx == 1 and dw > 2:  # h2v1_fancy_upsample
        left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        out = np.empty((dh, 2 * dw), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    if hx == 1 and vx == 2:  # h1v2_fancy_upsample (any width)
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * dh, dw), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out.astype(np.uint8)
    if hx == 2 and vx == 2 and dw > 2:  # h2v2_fancy_upsample
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * dh, 2 * dw), np.int32)
        for r0, near in ((0, up), (1, down)):
            col = 3 * x + near
            left = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
            right = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
            out[r0::2, 0::2] = (3 * col + left + 8) >> 4
            out[r0::2, 1::2] = (3 * col + right + 7) >> 4
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, vx, axis=0), hx, axis=1)  # h2v1/h2v2 at width <= 2, int_upsample


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert (its tables, as arithmetic)."""
    y = y.astype(np.int32)
    cb = cb.astype(np.int32) - 128
    cr = cr.astype(np.int32) - 128
    r = y + ((_fix16(1.40200) * cr + ONE_HALF) >> SCALEBITS)
    g = y + ((-_fix16(0.34414) * cb + ONE_HALF - _fix16(0.71414) * cr) >> SCALEBITS)
    b = y + ((_fix16(1.77200) * cb + ONE_HALF) >> SCALEBITS)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 (H, W, 3) RGB, the pixels `cv2.imread(path,
    cv2.IMREAD_COLOR)` gives (in RGB order), EXIF orientation applied."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG file (no SOI marker)")
    qts: Dict[int, np.ndarray] = {}
    # slots 0 and 1 start with the Annex K.3 tables, as libjpeg-turbo's
    # std_huff_tables fills every table no DHT defines: motion-JPEG frames
    # (AVI1) carry no DHT segment; a DHT, before or between scans, replaces them
    hts: Dict[Tuple[int, int], _HuffTable] = dict(_std_tables())
    comps: List[_Component] = []
    frame = None
    progressive = False
    coef_bits: List[List[int]] = []  # per component, the Al each zigzag coefficient was last sent at (-1: never)
    restart = 0
    orientation = 1
    adobe_transform = None
    jfif = False
    pos = 2
    n = len(data)
    while True:
        while pos < n and data[pos] == 0xFF and pos + 1 < n and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes
        if pos + 1 >= n or data[pos] != 0xFF:
            raise ValueError("corrupt JPEG: expected a marker")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError("corrupt JPEG: truncated segment")
        (length,) = struct.unpack(">H", data[pos: pos + 2])
        body = data[pos + 2: pos + length]
        if len(body) != length - 2:
            raise ValueError("corrupt JPEG: truncated segment")
        pos += length
        if marker == 0xE0 and body.startswith(b"JFIF\0") and len(body) >= 14:  # jdmarker.c examine_app0
            jfif = True
        elif marker == 0xE1 and body.startswith(b"Exif\0\0") and orientation == 1:
            orientation = exif_orientation(body)
        elif marker == 0xEE and body.startswith(b"Adobe") and len(body) >= 12:  # examine_app14
            adobe_transform = body[11]
        elif marker == 0xDB:
            _parse_dqt(body, qts)
        elif marker == 0xC4:
            _parse_dht(body, hts)
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError("corrupt JPEG: two frames")
            progressive = marker == 0xC2
            precision, height, width, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise NotImplementedError(_UNSUPPORTED.format(f"a {precision}-bit JPEG"))
            if nc not in (1, 3, 4):
                raise NotImplementedError(_UNSUPPORTED.format(f"a JPEG of {nc} components"))
            if height == 0:
                raise NotImplementedError(_UNSUPPORTED.format("a JPEG whose height comes in a DNL marker"))
            if width == 0 or width * height > 1 << 30:  # OpenCV's limit on the pixels of an image
                raise ValueError(f"JPEG of {width}x{height}: zero width or more than 2**30 pixels")
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i: 9 + 3 * i]
                if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4) or tq > 3:
                    raise ValueError("corrupt JPEG: bad sampling factors or table")
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            frame = (height, width)
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            if any(hmax % c.h or vmax % c.v for c in comps):
                raise NotImplementedError(_UNSUPPORTED.format("a JPEG whose sampling ratios are not integers"))
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c.dw, c.dh = -(-width * c.h // hmax), -(-height * c.v // vmax)
                c.bw, c.bh = mcux * c.h, mcuy * c.v
                c.coef = [0] * (c.bw * c.bh * 64)
            coef_bits = [[-1] * 64 for _ in comps]
        elif marker in (0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            kind = {0xC3: "a lossless JPEG (SOF3)"}.get(
                marker, f"a JPEG frame of type SOF{marker - 0xC0} (hierarchical or arithmetic-coded)")
            raise NotImplementedError(_UNSUPPORTED.format(kind))
        elif marker == 0xCC:
            raise NotImplementedError(_UNSUPPORTED.format("an arithmetic-coded JPEG"))
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG: a scan before the frame header")
            ns = body[0]
            ss, se, ahal = body[1 + 2 * ns: 4 + 2 * ns]
            ah, al = ahal >> 4, ahal & 15
            if progressive:
                if (ss == 0) != (se == 0) or se > 63 or ss > se or al > 13 or (ss and ns != 1):
                    raise ValueError("corrupt JPEG: bad progressive scan parameters")
            elif (ss, se, ahal) != (0, 63, 0):
                raise ValueError("corrupt JPEG: a sequential scan with spectral selection")
            scomps = []
            for i in range(ns):
                cid, tables = body[1 + 2 * i: 3 + 2 * i]
                c = next((c for c in comps if c.cid == cid), None)
                dc_needed = not progressive or (ss == 0 and ah == 0)
                ac_needed = not progressive or ss > 0
                if (c is None or (dc_needed and (0, tables >> 4) not in hts)
                        or (ac_needed and (1, tables & 15) not in hts)):
                    raise ValueError("corrupt JPEG: a scan names an unknown component or table")
                if c.qt is None:  # libjpeg latches a component's table at its first scan
                    if c.tq not in qts:
                        raise ValueError("corrupt JPEG: a component's quantisation table is missing")
                    c.qt = qts[c.tq].copy()
                scomps.append((c, hts.get((0, tables >> 4)), hts.get((1, tables & 15))))
                for k in range(ss, se + 1):
                    coef_bits[comps.index(c)][k] = al
            segments, pos = _entropy_segments(data, pos)
            try:
                if progressive:
                    _decode_progressive_scan(segments, scomps, mcux, mcuy, restart, ss, se, ah, al)
                else:
                    _decode_scan(segments, comps, scomps, mcux, mcuy, restart)
            except IndexError as exc:  # a code or run past the data or the block
                raise ValueError("corrupt JPEG data: the scan runs past its data") from exc
        elif marker == 0xDC:
            raise NotImplementedError(_UNSUPPORTED.format("a JPEG with a DNL marker"))
        # APPn, COM and other segments are skipped
    if frame is None or any(c.qt is None for c in comps):
        raise ValueError("corrupt JPEG: no frame or no scan")
    # jdcoefct.c smoothing_ok: with every DC known, a coefficient of AC1-AC9
    # not sent to its last bit makes libjpeg-turbo smooth the blocks
    if progressive and all(b[0] >= 0 for b in coef_bits) and any(any(b[1:10]) for b in coef_bits):
        raise NotImplementedError(_UNSUPPORTED.format(
            "a progressive JPEG whose scans stop before AC1-AC9 are complete (block smoothing)"))
    height, width = frame
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        blocks = np.array(c.coef, np.int64).reshape(c.bh * c.bw, 8, 8) * c.qt.reshape(8, 8)
        pix = _idct_islow(blocks).reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        pix = _upsample(pix[: c.dh, : c.dw], hmax // c.h, vmax // c.v)
        planes.append(pix[:height, :width])
    if len(planes) == 1:
        img = np.repeat(planes[0][..., None], 3, axis=-1)
    elif len(planes) == 3:
        # jdapimin.c default_decompress_parms: JFIF, then Adobe's transform, then the ids 'R', 'G', 'B'
        rgb = not jfif and (adobe_transform == 0 if adobe_transform is not None
                            else [c.cid for c in comps] == [82, 71, 66])
        img = np.stack(planes, axis=-1) if rgb else _ycc_to_rgb(*planes)
    else:
        if adobe_transform is not None and adobe_transform != 0:  # YCCK: jdcolor.c ycck_cmyk_convert
            cmy = 255 - _ycc_to_rgb(*planes[:3]).astype(np.int32)
        else:
            cmy = np.stack(planes[:3], axis=-1).astype(np.int32)
        k = planes[3].astype(np.int32)[..., None]
        img = (k - (((255 - cmy) * k) >> 8)).astype(np.uint8)  # OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, in RGB order
    return apply_orientation(img, orientation)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

QUALITY = 95  # cv2.imwrite's default IMWRITE_JPEG_QUALITY
# jcparam.c's jpeg_set_quality with force_baseline: the Annex K tables scaled
# by 200 - 2q percent (q >= 50), clamped to 1..255
LUMA_QT, CHROMA_QT = (np.clip((t * (200 - 2 * QUALITY) + 50) // 100, 1, 255)
                      for t in (STD_LUMA_QT, STD_CHROMA_QT))


def _rgb_to_ycc(rgb: np.ndarray) -> List[np.ndarray]:
    """jccolor.c's rgb_ycc_convert (its tables, as arithmetic)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    offset = (128 << SCALEBITS) + ONE_HALF - 1
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b + ONE_HALF) >> SCALEBITS
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.50000) * b + offset) >> SCALEBITS
    cr = (_fix16(0.50000) * r - _fix16(0.41869) * g - _fix16(0.08131) * b + offset) >> SCALEBITS
    return [y, cb, cr]


def _downsample(plane: np.ndarray, factor: int, out_cols: int) -> np.ndarray:
    """jcsample.c: the right edge expanded to `out_cols * factor` columns by
    replicating the last one, then fullsize (factor 1) or h2v2 (factor 2,
    biases 1, 2, 1, 2, ... along a row)."""
    rows, cols = plane.shape
    want = out_cols * factor
    if want > cols:
        plane = np.concatenate([plane, np.repeat(plane[:, -1:], want - cols, axis=1)], axis=1)
    plane = plane[:, :want]
    if factor == 1:
        return plane
    box = plane.reshape(rows // 2, 2, out_cols, 2).sum(axis=(1, 3))
    return (box + 1 + (np.arange(out_cols) & 1)) >> 2


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) level-shifted samples -> (N, 8, 8) coefficients scaled by 8:
    libjpeg's jpeg_fdct_islow."""
    def one_pass(d, even_shift, odd_shift, dc_shift):
        # d: (..., 8) samples along the last axis
        tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
        tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
        tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
        tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        out = [None] * 8
        if dc_shift >= 0:  # pass 1: scale up by PASS1_BITS
            out[0] = (tmp10 + tmp11) << dc_shift
            out[4] = (tmp10 - tmp11) << dc_shift
        else:  # pass 2: descale by PASS1_BITS
            s = -dc_shift
            out[0] = (tmp10 + tmp11 + (1 << (s - 1))) >> s
            out[4] = (tmp10 - tmp11 + (1 << (s - 1))) >> s

        def descale(x, s):
            return (x + (1 << (s - 1))) >> s

        z1 = (tmp12 + tmp13) * FIX_0_541196100
        out[2] = descale(z1 + tmp13 * FIX_0_765366865, even_shift)
        out[6] = descale(z1 - tmp12 * FIX_1_847759065, even_shift)
        z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * FIX_1_175875602
        tmp4 = tmp4 * FIX_0_298631336
        tmp5 = tmp5 * FIX_2_053119869
        tmp6 = tmp6 * FIX_3_072711026
        tmp7 = tmp7 * FIX_1_501321110
        z1 = z1 * -FIX_0_899976223
        z2 = z2 * -FIX_2_562915447
        z3 = z3 * -FIX_1_961570560 + z5
        z4 = z4 * -FIX_0_390180644 + z5
        out[7] = descale(tmp4 + z1 + z3, odd_shift)
        out[5] = descale(tmp5 + z2 + z4, odd_shift)
        out[3] = descale(tmp6 + z2 + z3, odd_shift)
        out[1] = descale(tmp7 + z1 + z4, odd_shift)
        return np.stack(out, axis=-1)

    d = blocks.astype(np.int64)
    rows = one_pass(d, CONST_BITS - PASS1_BITS, CONST_BITS - PASS1_BITS, PASS1_BITS)  # (N, row, u)
    cols = one_pass(rows.transpose(0, 2, 1), CONST_BITS + PASS1_BITS, CONST_BITS + PASS1_BITS, -PASS1_BITS)
    return cols.transpose(0, 2, 1)  # (N, v, u)


def _quantize(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's quantize with compute_reciprocal's 16-bit reciprocal,
    correction and shift (the SIMD build's DCTELEM), divisor = 8 * q."""
    divisor = qt.astype(np.int64) * 8
    recip = np.empty(64, np.int64)
    corr = np.empty(64, np.int64)
    shift = np.empty(64, np.int64)
    for i, d in enumerate(divisor.tolist()):
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    flat = coef.reshape(-1, 64)
    mag = ((np.abs(flat) + corr) * recip) >> shift
    return np.where(flat < 0, -mag, mag).reshape(coef.shape)


def _bits_of(values: np.ndarray) -> np.ndarray:
    """The magnitude category of each value: bit length of |v|."""
    a = np.abs(values).astype(np.int64)
    n = np.zeros(a.shape, np.int64)
    while True:
        nz = a > 0
        if not nz.any():
            return n
        n += nz
        a >>= 1


def _code_table(key: str) -> Tuple[np.ndarray, np.ndarray]:
    """(codes, lengths) by symbol for one of the standard tables."""
    counts, symbols = (bytes.fromhex(s) for s in STD_HUFFMAN[key])
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]], lengths[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


def _huffman_encode(zz: np.ndarray, table: np.ndarray, keys: Sequence[Tuple[str, str]]) -> bytes:
    """jchuff.c's encode_one_block over blocks in scan order, vectorised:
    `zz` (N, 64) quantised coefficients in zigzag order, `table[i]` the
    component of block i, `keys[c]` its (DC, AC) table names. Returns the
    stuffed entropy-coded bytes, padded with 1 bits."""
    nblk = zz.shape[0]
    tabs = {k: _code_table(k) for pair in keys for k in pair}
    # DC: the difference from the previous block of the same component
    dc = zz[:, 0]
    diff = np.empty(nblk, np.int64)
    for c in range(len(keys)):
        sel = np.flatnonzero(table == c)
        diff[sel] = np.diff(dc[sel], prepend=0)
    # one emit per DC, per ZRL, per nonzero AC and per EOB: (block, slot) orders them
    blk_e, slot_e, code_e, len_e = [], [], [], []

    def add(blocks, slots, symbols, extra_bits, extra_len, which):
        codes = np.zeros(len(blocks), np.int64)
        lens = np.zeros(len(blocks), np.int64)
        for c, pair in enumerate(keys):
            sel = table[blocks] == c
            cd, ln = tabs[pair[which]]
            codes[sel], lens[sel] = cd[symbols[sel]], ln[symbols[sel]]
        blk_e.append(blocks)
        slot_e.append(slots)
        code_e.append((codes << extra_len) | extra_bits)
        len_e.append(lens + extra_len)

    size = _bits_of(diff)
    add(np.arange(nblk), np.zeros(nblk, np.int64), size, (diff - (diff < 0)) & ((1 << size) - 1), size, 0)
    ac = zz[:, 1:]
    b_idx, k_idx = np.nonzero(ac)
    k_idx = k_idx + 1
    vals = ac[b_idx, k_idx - 1]
    first = np.ones(len(b_idx), bool)
    first[1:] = b_idx[1:] != b_idx[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k_idx[:-1]]))
    run = k_idx - prev - 1
    zrl = run // 16
    if zrl.any():
        owner = np.repeat(np.arange(len(b_idx)), zrl)
        add(b_idx[owner], 2 * k_idx[owner], np.full(len(owner), 0xF0, np.int64), np.zeros(len(owner), np.int64),
            np.zeros(len(owner), np.int64), 1)
    size = _bits_of(vals)
    add(b_idx, 2 * k_idx + 1, ((run % 16) << 4) | size, (vals - (vals < 0)) & ((1 << size) - 1), size, 1)
    last = np.zeros(nblk, np.int64)
    np.maximum.at(last, b_idx, k_idx)
    eob = np.flatnonzero(last < 63)
    add(eob, np.full(len(eob), 130, np.int64), np.zeros(len(eob), np.int64), np.zeros(len(eob), np.int64),
        np.zeros(len(eob), np.int64), 1)
    order = np.argsort(np.concatenate(blk_e) * 256 + np.concatenate(slot_e), kind="stable")
    return stuffed(pack_msb_first(np.concatenate(code_e)[order], np.concatenate(len_e)[order], pad_bit=1))


def pack_msb_first(codes: np.ndarray, lens: np.ndarray, pad_bit: int = 0) -> np.ndarray:
    """Codes of `lens` bits each, most significant bit first, into bytes
    (uint8), the last byte padded with `pad_bit`."""
    total = int(lens.sum())
    owner = np.repeat(np.arange(len(lens)), lens)
    shift = np.cumsum(lens)[owner] - 1 - np.arange(total)
    bits = ((codes[owner] >> shift) & 1).astype(np.uint8)
    return np.packbits(np.concatenate([bits, np.full(-total % 8, pad_bit, np.uint8)]))


def stuffed(entropy: np.ndarray) -> bytes:
    """Entropy-coded bytes with a 0 after every 0xFF (byte stuffing)."""
    return np.insert(entropy, np.flatnonzero(entropy == 0xFF) + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(img: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W) grey -> the JPEG bytes `cv2.imencode(".jpg")`
    writes for the same image (BGR to OpenCV) with its defaults: quality 95,
    4:2:0 colour."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg: expected uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        planes, factors = [img.astype(np.int64)], [(1, 1)]
    elif img.ndim == 3 and img.shape[-1] == 3:
        planes, factors = _rgb_to_ycc(img), [(2, 2), (1, 1), (1, 1)]
    else:
        raise ValueError(f"encode_jpeg: expected (H, W) or (H, W, 3), got {img.shape}")
    height, width = img.shape[:2]
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"encode_jpeg: {width}x{height} is outside JPEG's size range")
    qts = [LUMA_QT, CHROMA_QT, CHROMA_QT]
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    rows_padded = -(-height // vmax) * vmax
    comp_blocks = []
    for plane, (h, v), qt in zip(planes, factors, qts):
        bw_real, bh_real = -(-width * h // (hmax * 8)), -(-height * v // (vmax * 8))
        if rows_padded > height:  # jcprepct: the last row repeated to a whole row group
            plane = np.concatenate([plane, np.repeat(plane[-1:], rows_padded - height, axis=0)])
        ds = _downsample(plane, hmax // h, bw_real * 8)
        need = max(bh_real * 8, ds.shape[0])
        if need > ds.shape[0]:  # jcprepct: the last row repeated to a whole iMCU row
            ds = np.concatenate([ds, np.repeat(ds[-1:], need - ds.shape[0], axis=0)])
        ds = ds[: bh_real * 8]
        blocks = (ds - 128).reshape(bh_real, 8, bw_real, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        q = _quantize(_fdct_islow(blocks), qt).reshape(bh_real, bw_real, 64)
        comp_blocks.append((q, h, v))
    if len(planes) == 1:  # a one-component scan: its own blocks, one per MCU
        zz = comp_blocks[0][0].reshape(-1, 64)[:, ZIGZAG]
        table = np.zeros(len(zz), np.int64)
        keys = [("dc_luma", "ac_luma")]
    else:
        seq, comp_of = [], []
        for ci, (q, h, v) in enumerate(comp_blocks):
            bh_real, bw_real = q.shape[:2]
            grid = np.zeros((mcuy * v, mcux * h, 64), np.int64)
            grid[:bh_real, :bw_real] = q
            dummy = np.ones((mcuy * v, mcux * h), bool)
            dummy[:bh_real, :bw_real] = False
            # MCU order: (mcu row, mcu col, row in MCU, col in MCU)
            g = grid.reshape(mcuy, v, mcux, h, 64).transpose(0, 2, 1, 3, 4).reshape(mcuy * mcux, v, h, 64)
            dm = dummy.reshape(mcuy, v, mcux, h).transpose(0, 2, 1, 3).reshape(mcuy * mcux, v, h)
            # jccoefct: a dummy block is all zero with the DC of the block before
            # it in the MCU (the left neighbour past the right edge, the last
            # block of the row above in a row past the bottom edge)
            flat_g = g.reshape(mcuy * mcux, v * h, 64)
            flat_d = dm.reshape(mcuy * mcux, v * h)
            for j in range(1, v * h):
                take = flat_d[:, j]
                flat_g[take, j, :] = 0
                flat_g[take, j, 0] = flat_g[take, j - 1, 0]
            seq.append(flat_g)
            comp_of.append(np.full((mcuy * mcux, v * h), ci, np.int64))
        zz = np.concatenate(seq, axis=1).reshape(-1, 64)[:, ZIGZAG]
        table = np.concatenate(comp_of, axis=1).reshape(-1)
        keys = [("dc_luma", "ac_luma"), ("dc_chroma", "ac_chroma"), ("dc_chroma", "ac_chroma")]
    entropy = _huffman_encode(zz, table, keys)

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\0" + bytes([1, 1, 0, 0, 1, 0, 1, 0, 0]))]
    for tq, qt in enumerate(qts[: min(len(planes), 2)]):
        out.append(_segment(0xDB, bytes([tq]) + bytes(qt[ZIGZAG].astype(np.uint8).tolist())))
    sof = struct.pack(">BHHB", 8, height, width, len(planes))
    for ci, (h, v) in enumerate(factors):
        sof += bytes([ci + 1, (h << 4) | v, min(ci, 1)])
    out.append(_segment(0xC0, sof))
    for tc, key in ((0x00, "dc_luma"), (0x10, "ac_luma"), (0x01, "dc_chroma"), (0x11, "ac_chroma"))[
            : 2 if len(planes) == 1 else 4]:
        counts, symbols = STD_HUFFMAN[key]
        out.append(_segment(0xC4, bytes([tc]) + bytes.fromhex(counts) + bytes.fromhex(symbols)))
    sos = bytes([len(planes)])
    for ci in range(len(planes)):
        sos += bytes([ci + 1, 0x00 if ci == 0 else 0x11])
    out.append(_segment(0xDA, sos + bytes([0, 63, 0])))
    out.append(entropy)
    out.append(b"\xff\xd9")
    return b"".join(out)
