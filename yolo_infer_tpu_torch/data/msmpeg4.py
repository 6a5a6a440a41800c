"""Microsoft's MPEG-4 family in numpy: MS-MPEG-4 v2 (`MP42`), v3 (`DIV3`, `MP43`, DivX ;-)) and WMV1, over `data/mpeg4.py`'s machinery.

OpenCV's FFmpeg writer writes these codecs under the fourccs `MP42`,
`DIV3`/`MP43` and `WMV1` into `.avi` and `.mkv` files (and `DIV3` into
`.mov`), and OpenCV reads them back through libavcodec's `msmpeg4v2`,
`msmpeg4` and `wmv1` decoders. `MsMpeg4Decoder` decodes those streams to
the planes those decoders give, bit for bit (`msmpeg4dec.c`, `msmpeg4.c`;
the tables are `data/msmpeg4_tables.py`), and so, through `data/mpeg4.py
yuv420_to_bgr`, to the frames OpenCV returns. The streams carry no picture
size: the container gives it. WMV2 is `data/wmv2.py`, over this decoder.

Decoded:

  picture   the type (I or P), the quantiser, the slice code of an I
            picture (slices of equal height: each one's top row predicts
            as a picture's top row; v2 and v3 clear the AC predictors
            above it), the RL, DC and motion vector table indices, the
            skip flag, WMV1's per-macroblock RL flag; the extension header
            (fps, bit rate and v3's flip-flop rounding flag) that v2 and v3
            write after an I picture's last macroblock when 17 to 24 bits
            remain, and WMV1 inside its I picture header; the rounding that
            P pictures flip when the flag is set
  macroblocks an I picture's coded block pattern, its luma bits predicted
            from the left, above-left and above blocks; v3's and WMV1's
            joint type and pattern VLC of a P picture; v2's H.263 MCBPC and
            CBPY with its own I and P type tables; AC prediction; the DC
            predicted as `msmpeg4_pred_dc` divides (the bundled x86 build's
            multiply by libavcodec's reciprocal table), with WMV1's strict
            gradient test and its prediction from the picture's own pixels
            in small low-rate P pictures; the six RL tables with their
            three escapes (escape 3's run and level lengths fixed at their
            first use in a picture in WMV1)
  vectors   the two motion vector tables with their escape and wrap (v2:
            H.263's MVD, twice its range), median prediction
  pixels    libavcodec's simple IDCT and H.263 dequantisation, half-pel
            compensation (`data/mpeg4_motion.py`)

Refused: MS-MPEG-4 v1 (`MPG4`, `MP41`; the containers raise, ROADMAP Queue
1 item 11.2, point 5). A corrupt or truncated stream raises `ValueError`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

from yolo_infer_tpu_torch.data import msmpeg4_tables as T
from yolo_infer_tpu_torch.data.mpeg4 import (_ALT_H, _ALT_V, _DC_CHROM, _DC_LUM, _INTER_LAST, _INTER_LEVEL, _INTER_RUN,
                                             _INTER_VLC, _INTRA_LAST, _INTRA_LEVEL, _INTRA_RUN, _INTRA_VLC, _LUT_MVD,
                                             _ZIGZAG, Mpeg4Decoder, _Bits, _Ref, _Vop, decode_packets)

_ROADMAP = "ROADMAP Queue 1 item 11.2, point 5"
V2, V3, WMV1, WMV2 = 2, 3, 4, 5  # libavcodec's msmpeg4_version
NAMES = {V2: "MS-MPEG-4 v2", V3: "MS-MPEG-4 v3", WMV1: "WMV1", WMV2: "WMV2"}
MBAC_BITRATE = 50 * 1024  # above it WMV1 may code the RL table per macroblock
II_BITRATE = 128 * 1024  # at or below it (and below 320x240) WMV1 predicts intra DCs from pixels in P pictures
# libavcodec's ff_inverse: ceil(2^32 / i), the reciprocal its x86 DC prediction multiplies by
_INVERSE = [0, 0xFFFFFFFF] + [-(-(1 << 32) // i) for i in range(2, 257)]
_MPEG1_DC_SCALE = (8,) * 32


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not decoded by the port ({_ROADMAP})")


# ------------------------------------------------------------------ VLCs


class _Vlc:
    """A two-level lookup of a prefix code: `read(b)` gives the symbol of
    the code at the reader's position and moves past it."""

    __slots__ = ("bits", "table")

    def __init__(self, codes: Dict[int, Tuple[int, int]], bits: int = 10):
        self.bits = bits
        self.table: List[Optional[tuple]] = [None] * (1 << bits)
        longer: Dict[int, Dict[int, Tuple[int, int]]] = {}
        for sym, (code, length) in codes.items():
            if length <= bits:
                lo = code << (bits - length)
                for w in range(lo, lo + (1 << (bits - length))):
                    self.table[w] = (sym, length)
            else:
                rest = length - bits
                longer.setdefault(code >> rest, {})[sym] = (code & ((1 << rest) - 1), rest)
        for prefix, sub in longer.items():
            n = max(length for _, length in sub.values())
            self.table[prefix] = (None, n, _Vlc(sub, n).table)

    def read(self, b: _Bits):
        e = self.table[b.peek(self.bits)]
        if e is None:
            raise ValueError("corrupt stream: an invalid variable-length code")
        if e[0] is None:
            _, n, sub = e
            f = sub[b.peek(self.bits + n) & ((1 << n) - 1)]
            if f is None:
                raise ValueError("corrupt stream: an invalid variable-length code")
            b.pos += self.bits + f[1]
            return f[0]
        b.pos += e[1]
        return e[0]


def _pairs(flat: Sequence[int]) -> Dict[int, Tuple[int, int]]:
    return {i: (flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)}


def _canonical(lengths: Sequence[int], symbols: Sequence[int]) -> Dict[int, Tuple[int, int]]:
    """Codes assigned in order from lengths (libavcodec's `ff_vlc_init_from_lengths`)."""
    codes, code = {}, 0
    for length, sym in zip(lengths, symbols):
        codes[sym] = (code >> (32 - length), length)
        code += 1 << (32 - length)
    return codes


@lru_cache(maxsize=None)
def _mb_intra() -> _Vlc:
    return _Vlc(_pairs(T.MB_INTRA), 9)


@lru_cache(maxsize=None)
def _mb_non_intra(index: int) -> _Vlc:
    return _Vlc(_pairs((T.MB_NON_INTRA_0, T.MB_NON_INTRA_1, T.MB_NON_INTRA_2, T.MB_NON_INTRA_3)[index]), 10)


@lru_cache(maxsize=None)
def _dc(index: int, chroma: int) -> _Vlc:
    return _Vlc(_pairs(((T.DC0_LUMA, T.DC0_CHROMA), (T.DC1_LUMA, T.DC1_CHROMA))[index][chroma]), 10)


@lru_cache(maxsize=None)
def _mv(index: int) -> _Vlc:
    lengths, symbols = ((T.MV0_LENGTHS, T.MV0_SYMBOLS), (T.MV1_LENGTHS, T.MV1_SYMBOLS))[index]
    return _Vlc(_canonical(lengths, symbols), 10)


@lru_cache(maxsize=None)
def _small(name: str) -> _Vlc:
    return _Vlc(_pairs(getattr(T, name)), 7)


@lru_cache(maxsize=None)
def _v2_dc(chroma: int) -> _Vlc:
    """v2's DC size codes: MPEG-4's, every bit inverted, sizes 0..9."""
    table = _DC_CHROM if chroma else _DC_LUM
    return _Vlc({size: (code ^ ((1 << length) - 1), length) for size, (code, length) in enumerate(table[:10])}, 8)


_RL_SOURCES = (
    (T.RL0_VLC, T.RL0_RUN, T.RL0_LEVEL, T.RL0_LAST),
    (T.RL1_VLC, T.RL1_RUN, T.RL1_LEVEL, T.RL1_LAST),
    ([v for c in _INTRA_VLC + [(3, 7)] for v in c], _INTRA_RUN, _INTRA_LEVEL, _INTRA_LAST),
    (T.RL3_VLC, T.RL3_RUN, T.RL3_LEVEL, T.RL3_LAST),
    (T.RL4_VLC, T.RL4_RUN, T.RL4_LEVEL, T.RL4_LAST),
    ([v for c in _INTER_VLC + [(3, 7)] for v in c], _INTER_RUN, _INTER_LEVEL, _INTER_LAST),
)
_RL_BITS = 16  # the longest code (15) and its sign bit


class _Rl:
    """One RL table: a 16-bit lookup of (length with the sign bit, last,
    run, signed level), level 0 the escape (its length without a sign), and
    its largest level by (last, run) and largest run by (last, level)."""

    __slots__ = ("lut", "max_level", "max_run")

    def __init__(self, index: int):
        flat, runs, levels, last_from = _RL_SOURCES[index]
        n = len(runs)
        self.lut: List[Optional[tuple]] = [None] * (1 << _RL_BITS)
        for i in range(n + 1):
            code, length = flat[2 * i], flat[2 * i + 1]
            lo = code << (_RL_BITS - length)
            if i == n:
                entry = (length, 0, 0, 0)
                for w in range(lo, lo + (1 << (_RL_BITS - length))):
                    self.lut[w] = entry
                continue
            last = int(i >= last_from)
            half = 1 << (_RL_BITS - length - 1)
            plus, minus = (length + 1, last, runs[i], levels[i]), (length + 1, last, runs[i], -levels[i])
            for w in range(lo, lo + half):
                self.lut[w] = plus
            for w in range(lo + half, lo + 2 * half):
                self.lut[w] = minus
        self.max_level = ([0] * 65, [0] * 65)
        self.max_run = ([0] * 65, [0] * 65)
        for i, (run, level) in enumerate(zip(runs, levels)):
            last = int(i >= last_from)
            self.max_level[last][run] = max(self.max_level[last][run], level)
            self.max_run[last][level] = max(self.max_run[last][level], run)


@lru_cache(maxsize=None)
def _rl(index: int) -> _Rl:
    return _Rl(index)


def _decode012(b: _Bits) -> int:
    return b.bit() + 1 if b.bit() else 0


# ------------------------------------------------------------------ the decoder


class _Picture:
    """What the MPEG-4 machinery reads of a VOL, for these pictures: the
    size from the container, its macroblock grid, half-pel motion, H.263
    quantisation."""

    quarter_sample = quant_type = loaded_matrices = partitioned = resync = 0

    def __init__(self, width: int, height: int):
        self.width, self.height = width, height
        self.mb_w, self.mb_h = (width + 15) // 16, (height + 15) // 16


class MsMpeg4Decoder(Mpeg4Decoder):
    """Decode MS-MPEG-4 v2 or v3 or WMV1 packets (one picture each) of a
    `width` x `height` stream to frames, each the (Y, U, V) planes cropped
    to the picture: `decode` returns a packet's frame at once (no delay),
    `flush` nothing. `version` is `V2`, `V3` or `WMV1`. `counts` tallies
    each decoded case."""

    def __init__(self, width: int, height: int, version: int = V3):
        super().__init__()
        if version not in NAMES:
            raise ValueError(f"no MS-MPEG-4 version {version}")
        self.version = version
        self.vol = _Picture(width, height)
        self.slice_height = 0
        self.no_rounding = 0
        self.flipflop = 0
        self.bit_rate = 0
        if version >= WMV1:
            scans = [T.WMV1_SCANS[64 * k:64 * k + 64] for k in range(4)]
            self.scan_inter, self.scan_intra, self.scan_left, self.scan_top = scans[0], scans[1], scans[3], scans[2]
            self.dc_scales = (T.WMV1_Y_DC_SCALE, T.WMV1_C_DC_SCALE)
        else:
            self.scan_inter = self.scan_intra = _ZIGZAG
            self.scan_left, self.scan_top = _ALT_V, _ALT_H
            self.dc_scales = (T.OLD_Y_DC_SCALE, T.WMV1_C_DC_SCALE) if version == V3 else (_MPEG1_DC_SCALE,) * 2

    def flush(self):
        return None

    def check_stream(self, packets) -> None:
        """Nothing of v2, v3 and WMV1 is refused past the container (WMV2's decoder checks its pictures)."""

    def decode(self, packet: bytes):
        if not packet:
            return None
        b = _Bits(packet)
        pic = self._header(b, len(packet))
        if pic is None:  # a WMV2 P picture whose skip map skips every macroblock: no frame, as libavcodec
            self.counts["skipped_picture"] += 1
            return None
        self._pic, vop = pic, pic.vop
        try:
            self._macroblocks(b, pic)
        except IndexError as exc:  # a code read past the packet's zero padding
            raise self._corrupt("truncated") from exc
        if b.pos > b.end:
            raise self._corrupt("truncated")
        if vop.kind == 0 and self.version < WMV1:
            self._ext_header(b, len(packet))
        planes = self._reconstruct(vop, self.no_rounding if vop.kind else 0)
        self._deblock(planes, pic)
        self._future = _Ref(planes, vop.mvx, vop.mvy, vop.four, vop.skipped)
        return self._output(planes)

    def _deblock(self, planes, pic: "_Pic") -> None:
        """A loop filter over the reconstructed planes (WMV2's; none here)."""

    # ------------------------------------------------------------ headers

    def _corrupt(self, what: str) -> ValueError:
        return ValueError(f"corrupt {NAMES[self.version]} picture: {what}")

    def _header(self, b: _Bits, size: int) -> Optional["_Pic"]:
        """`ff_msmpeg4_decode_picture_header`: the picture's type, quantiser
        and table choices."""
        version, counts = self.version, self.counts
        mbs = self.vol.mb_w * self.vol.mb_h
        if size * 64 < mbs:
            raise self._corrupt("shorter than one bit per macroblock")
        kind = b.read(2)
        if kind > 1:
            raise self._corrupt("neither an I nor a P picture")
        q = b.read(5)
        if q == 0:
            raise self._corrupt("quantiser 0")
        if kind and self._future is None:
            raise ValueError(f"corrupt {NAMES[version]} stream: a P picture before any I picture")
        pic = _Pic(self, kind, q)
        if kind == 0:
            code = b.read(5)
            if code < 0x17:
                raise self._corrupt(f"slice code {code:#x}")
            self.slice_height = self.vol.mb_h // (code - 0x16)
            if not self.slice_height:
                raise self._corrupt(f"more slices ({code - 0x16}) than macroblock rows")
            counts[f"slices_{code - 0x16}"] += 1
            if version == V2:
                pic.rl_chroma = pic.rl_luma = 2
            elif version == V3:
                pic.rl_chroma = _decode012(b)
                pic.rl_luma = _decode012(b)
                pic.dc_table = b.bit()
            else:
                self._ext_header_at(b, 17, 4 * 8 - b.pos)
                pic.per_mb_rl = b.bit() if self.bit_rate > MBAC_BITRATE else 0
                if not pic.per_mb_rl:
                    pic.rl_chroma = _decode012(b)
                    pic.rl_luma = _decode012(b)
                pic.dc_table = b.bit()
            self.no_rounding = 1
        else:
            if version == V2:
                pic.skip_code = b.bit()
                pic.rl_luma = pic.rl_chroma = 2
            elif version == V3:
                pic.skip_code = b.bit()
                pic.rl_luma = pic.rl_chroma = _decode012(b)
                pic.dc_table = b.bit()
                pic.mv_table = b.bit()
            else:
                pic.skip_code = b.bit()
                pic.per_mb_rl = b.bit() if self.bit_rate > MBAC_BITRATE else 0
                if not pic.per_mb_rl:
                    pic.rl_luma = pic.rl_chroma = _decode012(b)
                pic.dc_table = b.bit()
                pic.mv_table = b.bit()
                pic.inter_intra = int(self.vol.width * self.vol.height < 320 * 240 and self.bit_rate <= II_BITRATE)
            self.no_rounding = self.no_rounding ^ 1 if self.flipflop else 0
        if b.pos > b.end:
            raise self._corrupt("truncated header")
        counts[("i_picture", "p_picture")[kind]] += 1
        self._tally_header(pic)
        return pic

    def _tally_header(self, pic: "_Pic") -> None:
        counts = self.counts
        if pic.vop.kind:
            counts[f"rounding_{self.no_rounding}"] += 1
            if self.version > V2:
                counts[f"mv_table_{pic.mv_table}"] += 1
            if self.version < WMV2:
                counts["skip_code" if pic.skip_code else "no_skip_code"] += 1
            if pic.inter_intra:
                counts["inter_intra_picture"] += 1
        if self.version > V2:
            counts[f"dc_table_{pic.dc_table}"] += 1
        if pic.per_mb_rl:
            counts["per_mb_rl_picture"] += 1
        else:
            counts[f"rl_luma_{pic.rl_luma}"] += 1
            counts[f"rl_chroma_{pic.rl_chroma}"] += 1

    def _ext_header_at(self, b: _Bits, length: int, left: int) -> None:
        """`ff_msmpeg4_decode_ext_header` with `left` bits to the end: fps,
        bit rate and (v3 and later) the flip-flop rounding flag where 17 to
        24 bits (v2: 16 to 23) remain; none below that; above it the
        previous flag stays."""
        if length <= left < length + 8:
            b.read(5)  # fps
            self.bit_rate = b.read(11) * 1024
            self.flipflop = b.bit() if self.version >= V3 else 0
            self.counts["ext_header"] += 1
        elif left < length + 8:
            self.flipflop = 0
            self.counts["no_ext_header"] += 1
        else:
            self.counts["ext_header_ignored"] += 1
        if self.flipflop:
            self.counts["flipflop_rounding"] += 1

    def _ext_header(self, b: _Bits, size: int) -> None:
        self._ext_header_at(b, 17 if self.version >= V3 else 16, 8 * size - b.pos)

    # ------------------------------------------------------------ macroblocks

    def _macroblocks(self, b: _Bits, pic: "_Pic") -> None:
        """The picture's macroblocks slice by slice (libavcodec's
        `decode_slice`): each slice's top row is its first slice line."""
        vol, vop = self.vol, pic.vop
        mb_w, mb_h, sh = vol.mb_w, vol.mb_h, self.slice_height
        for mby in range(mb_h):
            if mby % sh == 0:
                vop.start = mby * mb_w
                pic.first_row = mby
                if mby:
                    self.counts["slice"] += 1
                    if self.version < WMV1:
                        self._clear_ac_above(vop, mby)
            for mbx in range(mb_w):
                self._macroblock(b, pic, mby * mb_w + mbx, mbx, mby)

    @staticmethod
    def _clear_ac_above(vop: _Vop, mby: int) -> None:
        """`ff_mpeg4_clean_buffers` at a slice's start: the AC predictors of
        the block row above it zeroed."""
        zero7 = [0] * 7
        for plane, gw, row in ((0, vop.lw, 2 * mby), (1, vop.cw, mby), (2, vop.cw, mby)):
            for grid in (vop.ac_left[plane], vop.ac_top[plane]):
                grid[row * gw:(row + 1) * gw] = [zero7] * gw

    def _macroblock(self, b: _Bits, pic: "_Pic", mb: int, mbx: int, mby: int) -> None:
        vop, counts = pic.vop, self.counts
        v2 = self.version == V2
        if b.pos >= b.end:
            raise self._corrupt(f"truncated at macroblock {mb}")
        if vop.kind:
            if pic.skip_code and b.bit():
                self._skip(vop, mb)
                return
            if v2:
                code = _small("V2_MB_TYPE").read(b)
                intra, cbp = code >> 2, code & 3
            else:
                code = _mb_non_intra(pic.cbp_table).read(b)
                intra, cbp = not code & 0x40, code & 0x3F
        else:
            intra = 1
            if v2:
                cbp = _small("V2_INTRA_CBPC").read(b)
            else:
                cbp = pic.intra_cbp(_mb_intra().read(b), mbx, mby)
        if v2:
            if intra:
                ac_pred = b.bit()
                cbp |= self._cbpy(b, mb, 1) << 2
            else:
                cbp |= self._cbpy(b, mb, 1) << 2
                if cbp & 3 != 3:
                    cbp ^= 0x3C
        if not intra:
            if not v2 and pic.per_mb_rl and cbp:
                pic.rl_luma = pic.rl_chroma = _decode012(b)
                counts["per_mb_rl"] += 1
            self._inter(b, pic, mb, mbx, mby, cbp)
            return
        if vop.kind:
            counts["intra_mb_in_p"] += 1
        if not v2:
            ac_pred = b.bit()
            if pic.inter_intra:
                pic.aic_dir = _small("INTER_INTRA").read(b)
                counts["inter_intra_mb"] += 1
            if pic.per_mb_rl and cbp:
                pic.rl_luma = pic.rl_chroma = _decode012(b)
                counts["per_mb_rl"] += 1
        self._intra(b, pic, mb, mbx, mby, cbp, ac_pred)

    def _inter(self, b: _Bits, pic: "_Pic", mb: int, mbx: int, mby: int, cbp: int) -> None:
        """An inter macroblock: its vector from the median prediction, then its coded blocks."""
        vop = pic.vop
        self.counts["inter_mb"] += 1
        vop.mb_kind[mb] = 1
        stride, mvx, mvy = vop.stride, vop.mvx, vop.mvy
        top = (2 * mby + 1) * stride + 2 * mbx
        px, py = self._pred_motion(vop, 0, top, mb, mbx, mby)
        x, y = self._motion(b, pic, px, py)
        mvx[top] = mvx[top + 1] = mvx[top + stride] = mvx[top + stride + 1] = x
        mvy[top] = mvy[top + 1] = mvy[top + stride] = mvy[top + stride + 1] = y
        vop.motion[mb] = (1, 0, [(x, y)] * 4, None)
        self._inter_coefs(b, pic, mb, cbp)

    def _inter_coefs(self, b: _Bits, pic: "_Pic", mb: int, cbp: int) -> None:
        vop = pic.vop
        rl = _rl(3 + pic.rl_luma)
        run_diff = int(self.version != V2)
        for n in range(6):
            if cbp & (32 >> n):
                vop.coded[mb, n] = True
                self._coefs(b, pic, rl, -1, self.scan_inter, run_diff, None, (mb * 6 + n) * 64)

    def _motion(self, b: _Bits, pic: "_Pic", px: int, py: int) -> Tuple[int, int]:
        """One vector: v3's and WMV1's table (an escape gives both components
        in 6 bits each; 32 is no change), v2's H.263 MVD; wrapped to
        -63..63 as libavcodec wraps it."""
        if self.version == V2:
            return self._v2_mvd(b, px), self._v2_mvd(b, py)
        sym = _mv(pic.mv_table).read(b)
        if sym == 0:
            x, y = b.read(6), b.read(6)
            self.counts["mv_escape"] += 1
        else:
            x, y = sym >> 8, sym & 0xFF
        x += px - 32
        y += py - 32
        return x + 64 if x <= -64 else x - 64 if x >= 64 else x, y + 64 if y <= -64 else y - 64 if y >= 64 else y

    @staticmethod
    def _v2_mvd(b: _Bits, pred: int) -> int:
        hit = _LUT_MVD[b.peek(12)]
        if hit is None:
            raise ValueError("corrupt MS-MPEG-4 v2 picture: bad MVD")
        b.pos += hit[1]
        if not hit[0]:
            return pred
        v = pred - hit[0] if b.bit() else pred + hit[0]
        return v + 64 if v <= -64 else v - 64 if v >= 64 else v

    def _intra(self, b: _Bits, pic: "_Pic", mb: int, mbx: int, mby: int, cbp: int, ac_pred: int) -> None:
        """An intra macroblock's six blocks: the DC, the coefficients, then AC
        prediction from the block the DC predicted from."""
        vop, counts = pic.vop, self.counts
        vop.mb_kind[mb] = 2
        counts["intra_mb"] += 1
        if ac_pred:
            counts["ac_pred_mb"] += 1
        run_diff = int(self.version >= WMV1)
        for n in range(6):
            block = [0] * 64
            plane, at, scale, top, pred = self._dc_pred(pic, n, mb, mbx, mby)
            level = pred + self._dc_diff(b, pic, n)
            vop.dc[plane][at] = level * scale
            if level < 0:
                if not pic.inter_intra:
                    raise self._corrupt(f"a negative intra DC at macroblock {mb}")
                level = 0  # libavcodec zeroes it where the DC came from pixels
            elif level > 256 * scale:
                raise self._corrupt(f"an intra DC past 256 at macroblock {mb}")
            block[0] = level
            if ac_pred:
                scan = self.scan_top if top else self.scan_left
                counts["scan_horizontal" if top else "scan_vertical"] += 1
            else:
                scan = self.scan_intra
            if cbp & (32 >> n):
                rl = _rl(pic.rl_luma if n < 4 else 3 + pic.rl_chroma)
                self._coefs(b, pic, rl, 0, scan, run_diff, block, 0)
            gw = vop.lw if plane == 0 else vop.cw
            if ac_pred:
                if top:
                    src = vop.ac_top[plane][at - gw]
                    for k in range(7):
                        block[k + 1] += src[k]
                else:
                    src = vop.ac_left[plane][at - 1]
                    for k in range(7):
                        block[8 * k + 8] += src[k]
            vop.ac_top[plane][at] = block[1:8]
            vop.ac_left[plane][at] = block[8::8]
            vop.intra_at.append(mb * 6 + n)
            vop.intra_rows.append(block)
        vop.coded[mb] = True

    def _dc_diff(self, b: _Bits, pic: "_Pic", n: int) -> int:
        """A DC difference: v2's inverted MPEG-4 size code with its bits and
        a marker past size 8; v3's and later the DC table (119 the escape:
        8 bits) and a sign."""
        if self.version == V2:
            size = _v2_dc(n >= 4).read(b)
            if not size:
                return 0
            diff = b.read(size)
            if not diff >> (size - 1):
                diff -= (1 << size) - 1
            if size > 8 and not b.bit():
                raise self._corrupt("a DC marker bit missing")
            if not -256 <= diff < 256:
                raise self._corrupt("a DC difference out of range")
            return diff
        level = _dc(pic.dc_table, int(n >= 4)).read(b)
        if level == 119:
            level = b.read(8)
            self.counts["dc_escape"] += 1
        return -level if level and b.bit() else level

    def _dc_pred(self, pic: "_Pic", n: int, mb: int, mbx: int, mby: int):
        """`ff_msmpeg4_pred_dc`: (plane, grid index, scale, from the top,
        predicted DC level) of intra block n: the left, above-left and above
        DCs divided by the scale (the bundled x86 build multiplies by
        ceil(2^32 / scale) and keeps the high word), the gradient test (v2,
        v3: ties predict from the top; WMV1: from the left), WMV1's choice
        by the macroblock's direction code and the picture's own pixels in
        small low-rate P pictures."""
        vop, q = pic.vop, pic.vop.q
        if n < 4:
            plane, gw = 0, vop.lw
            at = (2 * mby + (n >> 1) + 1) * gw + 2 * mbx + (n & 1) + 1
            scale = self.dc_scales[0][q]
        else:
            plane, gw = n - 3, vop.cw
            at = (mby + 1) * gw + mbx + 1
            scale = self.dc_scales[1][q]
        dcp = vop.dc[plane]
        a, bb, c = dcp[at - 1], dcp[at - 1 - gw], dcp[at - gw]
        if mby == pic.first_row and not n & 2 and self.version < WMV1:
            bb = c = 1024
        inv, half = _INVERSE[scale], scale >> 1
        a, bb, c = ((a + half) * inv) >> 32, ((bb + half) * inv) >> 32, ((c + half) * inv) >> 32
        if self.version < WMV1:
            top = abs(a - bb) <= abs(bb - c)
        elif not pic.inter_intra or n in (1, 2, 3):
            if pic.inter_intra and n != 3:
                top = n == 2
            else:
                top = abs(a - bb) < abs(bb - c)
        else:
            y_, x_, size, p = (16 * mby, 16 * mbx, 8, 0) if n == 0 else (8 * mby, 8 * mbx, 8, n - 3)
            pixels = self._pixels_so_far(pic, mb)[p]
            edge = (1024 + half) // scale
            a = edge if mbx == 0 else (int(pixels[y_:y_ + 8, x_ - 8:x_].sum()) + 4 * scale) // (8 * scale)
            c = edge if mby == 0 else (int(pixels[y_ - 8:y_, x_:x_ + 8].sum()) + 4 * scale) // (8 * scale)
            d = pic.aic_dir
            top = d == 3 or (d == 1 and n == 0) or (d == 2 and n != 0)
            self.counts["dc_from_pixels"] += 1
        return plane, at, scale, top, c if top else a

    def _pixels_so_far(self, pic: "_Pic", mb: int):
        """The picture's planes as reconstructed up to macroblock mb (the
        macroblocks before it): libavcodec reconstructs each macroblock before
        it parses the next."""
        if pic.pixels_at != mb:
            pic.pixels = self._reconstruct(pic.vop, self.no_rounding)
            pic.pixels_at = mb
        return pic.pixels

    def _coefs(self, b: _Bits, pic: "_Pic", rl: _Rl, i: int, scan, run_diff: int, block: Optional[list],
               base: int) -> None:
        """One block's RL events from scan position i + 1 (`ff_msmpeg4_decode_block`):
        quantised levels into block (intra) or the picture's inter lists at
        base. libavcodec's end test: a last event, or any event past
        position 62; an event past 63 (or a non-last one past 62) ends the
        block unstored."""
        counts, lut, words = self.counts, rl.lut, b.words
        vop = pic.vop
        while True:
            p = b.pos
            if p >= b.end:
                raise self._corrupt("truncated inside a block")
            w = (words[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
            e = lut[w >> 16]
            if e is None:
                raise self._corrupt("a bad RL code")
            length, last, run, level = e
            p += length
            if not level:  # an escape
                w = (words[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
                if w >> 31:  # escape 1: the level past the largest of its run
                    e = lut[(w >> 15) & 0xFFFF]
                    if e is None or not e[3]:
                        raise self._corrupt("a bad RL escape")
                    length, last, run, level = e
                    level += rl.max_level[last][run] if level > 0 else -rl.max_level[last][run]
                    p += 1 + length
                    counts["escape_1"] += 1
                elif w >> 30:  # escape 2: the run past the largest of its level
                    e = lut[(w >> 14) & 0xFFFF]
                    if e is None or not e[3]:
                        raise self._corrupt("a bad RL escape")
                    length, last, run, level = e
                    run += rl.max_run[last][abs(level)] + run_diff
                    p += 2 + length
                    counts["escape_2"] += 1
                else:  # escape 3: last, run and level in fixed lengths
                    b.pos = p + 2
                    last = b.bit()
                    if self.version < WMV1:
                        run = b.read(6)
                        level = b.read(8)
                        if level >= 128:
                            level -= 256
                    else:
                        if not pic.esc3_level:
                            if vop.q < 8:
                                ll = b.read(3) or 8 + b.bit()
                            else:
                                ll = 2
                                while ll < 8 and not b.peek(1):
                                    ll += 1
                                    b.pos += 1
                                if ll < 8:
                                    b.pos += 1
                            pic.esc3_level, pic.esc3_run = ll, b.read(2) + 3
                            counts[f"escape_3_lengths_{ll}_{pic.esc3_run}"] += 1
                        run = b.read(pic.esc3_run)
                        sign = b.bit()
                        level = b.read(pic.esc3_level)
                        if sign:
                            level = -level
                    if not level and block is None:
                        raise self._corrupt("an escape-3 inter level of 0")
                    p = b.pos
                    counts["escape_3"] += 1
            b.pos = p
            i += run + 1 + 192 * last
            if i > 62:
                i -= 192
                if i & ~63:
                    counts["overflow_ignored"] += 1
                    return
                last = 1
            if block is not None:
                block[scan[i]] = level
            else:
                vop.idx.append(base + scan[i])
                vop.val.append(level)
            if last:
                return


class _Pic:
    """One picture's parse state: its `_Vop`, the table choices, the first
    row of the slice being parsed, the coded block predictors of an I
    picture, escape 3's lengths."""

    def __init__(self, decoder: MsMpeg4Decoder, kind: int, q: int):
        vol = decoder.vol
        self.vop = _Vop(vol, kind, q, 99, 1, 1)
        self.vop.dc_scales = decoder.dc_scales
        self.rl_luma = self.rl_chroma = self.dc_table = self.mv_table = 0
        self.skip_code = self.per_mb_rl = self.inter_intra = self.aic_dir = 0
        self.cbp_table = 3  # v3's and WMV1's joint type and pattern table
        self.esc3_level = self.esc3_run = 0
        self.first_row = 0
        self.lw = 2 * vol.mb_w + 1
        self.coded = bytearray(self.lw * (2 * vol.mb_h + 1))
        self.pixels, self.pixels_at = None, -1

    def intra_cbp(self, code: int, mbx: int, mby: int) -> int:
        """An I picture macroblock's coded block pattern from its code: each
        luma bit against `ff_msmpeg4_coded_block_pred` (the left block's flag
        where the above-left and above agree, else the above), stored for
        the blocks after it."""
        lw, coded = self.lw, self.coded
        cbp = code & 3
        for n in range(4):
            at = (2 * mby + (n >> 1) + 1) * lw + 2 * mbx + (n & 1) + 1
            a, bb, c = coded[at - 1], coded[at - 1 - lw], coded[at - lw]
            coded[at] = val = (code >> (5 - n)) & 1 ^ (a if bb == c else c)
            cbp |= val << (5 - n)
        return cbp


def is_fourcc(tag: bytes) -> bool:
    """Whether a container's tag names a version of this family (v1 too)."""
    return tag.decode("latin-1").upper() in FOURCCS


def version_of(fourcc: str) -> int:
    """The version a container's fourcc names; v1 raises."""
    version = FOURCCS[fourcc.upper()]
    if version == 1:
        raise _unsupported(f"MS-MPEG-4 v1 (fourcc {fourcc!r}: the bundled libavcodec decodes it but has no "
                           "encoder to make fixtures with)")
    return version


# the AVI, Matroska (V_MS/VFW/FOURCC) and QuickTime tags libavformat reads as each version, in any letter case
# (each checked by retagging a file and reading it with OpenCV); v1's are refused
FOURCCS = {"MPG4": 1, "MP41": 1, "MP42": V2, "DIV2": V2, "DIV3": V3, "MP43": V3, "MPG3": V3, "DIV4": V3, "DIV5": V3,
           "DIV6": V3, "DVX3": V3, "AP41": V3, "COL1": V3, "COL0": V3, "3IVD": V3, "WMV1": WMV1, "WMV2": WMV2,
           "GXVE": WMV2}


class MsMpeg4Track:
    """What a container's MS-MPEG-4 or WMV track adds to its reader
    (`data/avi.py`, `data/mkv.py`, `data/mp4.py` mix it in): `ms_version`
    (`open_msmpeg4`), `config` (WMV2's extension header) and the decoded
    frames."""

    ms_version = 0  # 0: not such a track

    def open_msmpeg4(self, tag) -> None:
        """Take the track as the version `tag` names (a fourcc, or a version
        number) and check every picture header before any frame: what the
        port refuses (v1, WMV2's IntraX8 pictures) raises here."""
        try:
            self.ms_version = tag if isinstance(tag, int) else version_of(tag)
            make_decoder(self.width, self.height, self.ms_version, self.config).check_stream(self.packets())
        except (NotImplementedError, ValueError) as exc:
            raise type(exc)(f"{self.path}: {exc}") from exc

    def read_msmpeg4(self, rgb: bool = True):
        """The decoded frames: uint8 (H, W, 3), RGB (BGR with `rgb=False`)."""
        decoder = make_decoder(self.width, self.height, self.ms_version, self.config)
        self.counts = decoder.counts
        yield from decode_packets(decoder, self.packets(), rgb, self.path)


def make_decoder(width: int, height: int, version: int, extradata: bytes = b"") -> MsMpeg4Decoder:
    """The decoder of a version: WMV2's reads its extension header from the extradata."""
    if version == WMV2:
        from yolo_infer_tpu_torch.data.wmv2 import Wmv2Decoder
        return Wmv2Decoder(width, height, extradata)
    return MsMpeg4Decoder(width, height, version)
