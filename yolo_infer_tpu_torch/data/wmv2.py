"""WMV2 (Windows Media Video 8) in numpy, over `data/msmpeg4.py`'s decoder.

OpenCV's FFmpeg writer writes WMV2 under the fourcc `WMV2` into `.avi` and
`.mkv` files, with a 4-byte extension header as the stream's extradata
(the AVI's BITMAPINFOHEADER tail, Matroska's CodecPrivate after it), and
OpenCV reads them back through libavcodec's `wmv2` decoder. `Wmv2Decoder`
decodes them to the planes that decoder gives, bit for bit (`wmv2dec.c`,
`wmv2.c`, `wmv2dsp.c`).

Decoded:

  extension header  fps, bit rate, the mspel, loop filter, ABT, j-type,
            top-left vector and per-macroblock RL flags, the slice count
  picture   the type (one bit), an I picture's 7 spare bits, the
            quantiser; an I picture's j-type, RL and DC table choices; a
            P picture's skip map (none, per macroblock, per row or per
            column, each row or column all skipped or coded), its joint
            type and pattern table (`cbp_table_index`: one of three by the
            quantiser), mspel, picture or per-macroblock ABT, RL, DC and
            vector tables; a P picture all of whose macroblocks are skipped
            gives no frame, as libavcodec gives none
  macroblocks WMV2's vector prediction (the left or the above vector by a
            bit where they differ by 8 or more and the top-left flag is set,
            else the median; the left on a slice's top row), the mspel
            half-shift bit of an odd vector, per-macroblock RL tables,
            per-macroblock or per-block ABT: an inter block coded as two
            8x4 or 4x8 halves (libavcodec's `ff_simple_idct84_add` and
            `ff_simple_idct48_add`), each with its own scan and flag
  pixels    WMV2's own IDCT (`wmv2_idct_row`, `wmv2_idct_col`) for every 8x8
            block, intra and inter; in mspel pictures the (-1, 9, 9, -1) / 16
            filters at half positions, averaged with the nearer sample
            where the half-shift bit is set (`ff_mspel_motion`); H.263's
            deblocking loop filter after each macroblock where the
            extension header sets it (`ff_h263_loop_filter`)

Refused before any frame (`check_stream`): IntraX8 pictures (j-type,
`ff_intrax8_decode_picture`, ROADMAP Queue 1 item 11.2, point 5): the bundled
`wmv2` encoder never writes one. A corrupt or truncated stream raises
`ValueError`.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

import numpy as np

from yolo_infer_tpu_torch.data import mpeg4_motion as mc
from yolo_infer_tpu_torch.data import msmpeg4_tables as T
from yolo_infer_tpu_torch.data.mpeg4 import _Bits, _idct_1d, _Vop
from yolo_infer_tpu_torch.data.msmpeg4 import (WMV2, MsMpeg4Decoder, _decode012, _mb_intra, _mb_non_intra, _Pic,
                                               _rl, _unsupported)

EXTRADATA_SIZE = 4
SKIP_NONE, SKIP_MPEG, SKIP_ROW, SKIP_COL = range(4)
_CBP_TABLE = ((0, 2, 1), (1, 0, 2), (2, 1, 0))  # by (q > 10) + (q > 20), then the picture's index
_SUB_CBP = (2, 3, 1)  # which ABT halves are coded, by their code 0, 10, 11
_SCAN_A = tuple(T.WMV2_SCAN_A) + (0,) * 32  # libavcodec's scans are 64 long, zero past their 32 positions
_SCAN_B = tuple(T.WMV2_SCAN_B) + (0,) * 32
# H.263's loop filter strength by quantiser (ff_h263_loop_filter_strength)
_STRENGTH = (0, 1, 1, 2, 2, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 7, 7, 8, 8, 8, 9, 9, 9, 10, 10, 10, 11, 11, 11, 12, 12, 12)


def _corrupt(what: str) -> ValueError:
    return ValueError(f"corrupt WMV2 picture: {what}")


# ------------------------------------------------------------------ transforms

_WMV2_W = (2048, 2841, 2676, 2408, 2048, 1609, 1108, 565)


def _wmv2_pass(b, col: bool):
    """One pass of `wmv2_idct_row` (col False) or `wmv2_idct_col` over the last axis of int64 b."""
    w0, w1, w2, w3, _, w5, w6, w7 = _WMV2_W
    x = [b[..., k] for k in range(8)]
    r, sh = (4, 3) if col else (0, 0)
    a1 = (w1 * x[1] + w7 * x[7] + r) >> sh
    a7 = (w7 * x[1] - w1 * x[7] + r) >> sh
    a5 = (w5 * x[5] + w3 * x[3] + r) >> sh
    a3 = (w3 * x[5] - w5 * x[3] + r) >> sh
    a2 = (w2 * x[2] + w6 * x[6] + r) >> sh
    a6 = (w6 * x[2] - w2 * x[6] + r) >> sh
    a0 = (w0 * x[0] + w0 * x[4]) >> sh
    a4 = (w0 * x[0] - w0 * x[4]) >> sh
    s1 = (181 * (a1 - a5 + a7 - a3) + 128) >> 8
    s2 = (181 * (a1 - a5 - a7 + a3) + 128) >> 8
    rnd, shift = (1 << 13, 14) if col else (1 << 7, 8)
    out = [a0 + a2 + a1 + a5, a4 + a6 + s1, a4 - a6 + s2, a0 - a2 + a7 + a3, a0 - a2 - a7 - a3, a4 - a6 - s2,
           a4 + a6 - s1, a0 + a2 - a1 - a5]
    return np.stack([(v + rnd) >> shift for v in out], -1).astype(np.int16).astype(np.int64)


def wmv2_idct(blocks: np.ndarray) -> np.ndarray:
    """WMV2's IDCT of (..., 8, 8) dequantised coefficients (rows, then
    columns, each result kept to 16 bits): (..., 8, 8) int32 before the
    clip to pixels."""
    x = blocks.astype(np.int16).astype(np.int64)
    rows = _wmv2_pass(x, False)
    cols = _wmv2_pass(np.swapaxes(rows, -1, -2), True)
    return np.ascontiguousarray(np.swapaxes(cols, -1, -2)).astype(np.int32)


_C = [int(v * math.sqrt(2) * (1 << 12) + 0.5) for v in (0.6532814824, 0.2705980501, 0.5)]  # simple_idct.c C1..C3
_R = [int(v * math.sqrt(2) * (1 << 15) + 0.5) for v in (0.6532814824, 0.2705980501, 0.5)]  # R1..R3


def _idct4(x, consts, rnd: int, shift: int):
    """The 4-point IDCT over the last axis (`idct4col_add`, `idct4row`)."""
    c1k, c2k, c3k = consts
    a0, a1, a2, a3 = (x[..., k] for k in range(4))
    c0 = (a0 + a2) * c3k + rnd
    c2 = (a0 - a2) * c3k + rnd
    c1 = a1 * c1k + a3 * c2k
    c3 = a1 * c2k - a3 * c1k
    return np.stack([c0 + c1, c2 + c3, c2 - c3, c0 - c1], -1) >> shift


def _simple_rows(x: np.ndarray) -> np.ndarray:
    """`idctRowCondDC` of the C simple IDCT over the last axis (a DC-only row is its DC times 8), kept to 16 bits."""
    rows = _idct_1d(x, 11, 1 << 10, col=False)
    dc_only = ~np.any(x[..., 1:] != 0, axis=-1, keepdims=True)
    return np.where(dc_only, x[..., :1] * 8, rows).astype(np.int16).astype(np.int64)


def idct84(block: np.ndarray) -> np.ndarray:
    """`ff_simple_idct84_add`'s residual of (..., 8, 8) blocks: an 8-point
    row IDCT of rows 0..3, then a 4-point one down each column -> (..., 4, 8)."""
    x = block[..., :4, :].astype(np.int16).astype(np.int64)
    rows = _simple_rows(x)
    cols = _idct4(np.swapaxes(rows, -1, -2), _C, 1 << 16, 17)
    return np.swapaxes(cols, -1, -2)


def idct48(block: np.ndarray) -> np.ndarray:
    """`ff_simple_idct48_add`'s residual of (..., 8, 8) blocks: a 4-point
    row IDCT of columns 0..3 of each row, then the simple IDCT's 8-point
    column pass -> (..., 8, 4)."""
    x = block[..., :, :4].astype(np.int16).astype(np.int64)
    rows = _idct4(x, _R, 1 << 10, 11).astype(np.int16).astype(np.int64)
    return np.swapaxes(_idct_1d(np.swapaxes(rows, -1, -2), 20, 0, col=True), -1, -2)


# ------------------------------------------------------------------ mspel


def _hlow(g: np.ndarray) -> np.ndarray:
    """(9 (a + b) - (a' + b') + 8) >> 4, clipped, along the last axis: len - 3 samples from len."""
    return np.clip((9 * (g[..., 1:-2] + g[..., 2:-1]) - (g[..., :-3] + g[..., 3:]) + 8) >> 4, 0, 255)


def _vlow(g: np.ndarray) -> np.ndarray:
    return np.swapaxes(_hlow(np.swapaxes(g, -1, -2)), -1, -2)


def mspel(ref: np.ndarray, sx: np.ndarray, sy: np.ndarray, dxy: np.ndarray) -> np.ndarray:
    """(n, 8, 8) predictions of `put_mspel_pixels_tab[dxy]` at integer
    (sx, sy): dxy = 2 (2 half-y + half-x) + the half-shift bit."""
    g = mc.gather(ref, sx - 1, sy - 1, 11).astype(np.int64)  # rows and columns -1..9
    full = g[:, 1:9, 1:9]
    h = _hlow(g)  # (n, 11, 8): every row's half samples across
    hv = _vlow(h)  # (n, 8, 8)
    v0, v1 = _vlow(g[:, :, 1:9]), _vlow(g[:, :, 2:10])
    avg = lambda a, b: (a + b + 1) >> 1  # noqa: E731
    d = dxy[:, None, None]
    out = np.where(d == 0, full, np.where(d == 1, avg(full, h[:, 1:9]), np.where(d == 2, h[:, 1:9], np.where(
        d == 3, avg(g[:, 1:9, 2:10], h[:, 1:9]), np.where(d == 4, v0, np.where(d == 5, avg(v0, hv), np.where(
            d == 6, hv, avg(v1, hv))))))))
    return out.astype(np.int32)


# ------------------------------------------------------------------ the decoder


class Wmv2Decoder(MsMpeg4Decoder):
    """Decode WMV2 packets (one picture each) of a `width` x `height` stream
    whose extradata is its 4-byte extension header."""

    def __init__(self, width: int, height: int, extradata: bytes):
        super().__init__(width, height, WMV2)
        if len(extradata) < EXTRADATA_SIZE:
            raise ValueError(f"corrupt WMV2 stream: an extension header of {len(extradata)} bytes (4 needed)")
        b = _Bits(extradata[:EXTRADATA_SIZE])
        b.read(5)  # fps
        self.bit_rate = b.read(11) * 1024
        self.mspel_bit, self.loop_filter, self.abt_flag, self.j_type_bit, self.top_left_mv, self.per_mb_rl_bit = (
            b.bit() for _ in range(6))
        code = b.read(3)
        if not code or code > self.vol.mb_h:
            raise ValueError(f"corrupt WMV2 extension header: {code} slices for {self.vol.mb_h} macroblock rows")
        self.slice_height = self.vol.mb_h // code

    def check_stream(self, packets: Iterable[bytes]) -> None:
        """Every picture's j-type bit read: IntraX8 raises here, before any frame."""
        for packet in packets:
            if packet and self.j_type_bit:
                b = _Bits(packet)
                if not b.bit():  # an I picture: 7 spare bits, the quantiser, then j-type
                    b.read(7 + 5)
                    if b.bit():
                        raise _unsupported("a WMV2 IntraX8 picture (j-type)")

    # ------------------------------------------------------------ headers

    def _header(self, b: _Bits, size: int) -> Optional[_Pic]:
        """`ff_wmv2_decode_picture_header` and its secondary header; None for
        a P picture whose skip map skips every macroblock."""
        counts, vol = self.counts, self.vol
        kind = b.bit()
        if kind == 0:
            b.read(7)
        q = b.read(5)
        if not q:
            raise _corrupt("quantiser 0")
        if kind and self._future is None:
            raise ValueError("corrupt WMV2 stream: a P picture before any I picture")
        if kind and b.peek(1):
            save = b.pos
            skip_type = b.read(2)
            run = vol.mb_w if skip_type == SKIP_COL else vol.mb_h
            while run > 0:
                block = min(run, 25)
                if b.read(block) + 1 != 1 << block:
                    break
                run -= block
            b.pos = save
            if not run:
                return None
        pic = _Pic(self, kind, q)
        vop = pic.vop
        vop.hshift = bytearray(vol.mb_w * vol.mb_h)
        vop.abt = np.zeros((vol.mb_w * vol.mb_h, 6), np.int8)  # 0: 8x8, 1: two 8x4 halves, 2: two 4x8 halves
        vop.idx2, vop.val2 = [], []  # the second half's levels
        pic.mspel = pic.per_mb_abt = pic.abt_type = 0
        pic.skip = None
        if kind == 0:
            if self.j_type_bit and b.bit():
                raise _unsupported("a WMV2 IntraX8 picture (j-type)")
            pic.per_mb_rl = b.bit() if self.per_mb_rl_bit else 0
            if not pic.per_mb_rl:
                pic.rl_chroma = _decode012(b)
                pic.rl_luma = _decode012(b)
            pic.dc_table = b.bit()
            if b.left() * 8 < vol.mb_w * vol.mb_h:
                raise _corrupt("shorter than one bit per macroblock")
            self.no_rounding = 1
        else:
            pic.skip = self._skip_map(b)
            pic.cbp_table = _CBP_TABLE[(q > 10) + (q > 20)][_decode012(b)]
            pic.mspel = b.bit() if self.mspel_bit else 0
            if self.abt_flag:
                pic.per_mb_abt = b.bit() ^ 1
                if not pic.per_mb_abt:
                    pic.abt_type = _decode012(b)
            pic.per_mb_rl = b.bit() if self.per_mb_rl_bit else 0
            if not pic.per_mb_rl:
                pic.rl_luma = pic.rl_chroma = _decode012(b)
            if b.left() < 2:
                raise _corrupt("truncated header")
            pic.dc_table = b.bit()
            pic.mv_table = b.bit()
            self.no_rounding ^= 1
            counts[f"cbp_table_{pic.cbp_table}"] += 1
            if pic.mspel:
                counts["mspel_picture"] += 1
            counts["per_mb_abt" if pic.per_mb_abt else f"abt_type_{pic.abt_type}"] += 1
        if b.pos > b.end:
            raise _corrupt("truncated header")
        counts[("i_picture", "p_picture")[kind]] += 1
        self._tally_header(pic)
        return pic

    def _skip_map(self, b: _Bits) -> bytearray:
        """`parse_mb_skip`: which macroblocks of a P picture are skipped."""
        vol = self.vol
        mb_w, mb_h = vol.mb_w, vol.mb_h
        skip = bytearray(mb_w * mb_h)
        kind = b.read(2)
        self.counts[f"skip_type_{kind}"] += 1
        if kind == SKIP_MPEG:
            if b.left() < mb_w * mb_h:
                raise _corrupt("a truncated skip map")
            for mb in range(mb_w * mb_h):
                skip[mb] = b.bit()
        elif kind in (SKIP_ROW, SKIP_COL):
            outer, inner = (mb_h, mb_w) if kind == SKIP_ROW else (mb_w, mb_h)
            for i in range(outer):
                if b.left() < 1:
                    raise _corrupt("a truncated skip map")
                whole = b.bit()
                for j in range(inner):
                    mb = i * mb_w + j if kind == SKIP_ROW else j * mb_w + i
                    skip[mb] = 1 if whole else b.bit()
        if mb_w * mb_h - sum(skip) > b.left():
            raise _corrupt("fewer bits than coded macroblocks")
        return skip

    # ------------------------------------------------------------ macroblocks

    def _macroblock(self, b: _Bits, pic: _Pic, mb: int, mbx: int, mby: int) -> None:
        vop, counts = pic.vop, self.counts
        if vop.kind:
            if pic.skip[mb]:
                self._skip(vop, mb)
                return
            if b.left() <= 0:
                raise _corrupt(f"truncated at macroblock {mb}")
            code = _mb_non_intra(pic.cbp_table).read(b)
            intra, cbp = not code & 0x40, code & 0x3F
        else:
            if b.left() <= 0:
                raise _corrupt(f"truncated at macroblock {mb}")
            intra, cbp = 1, pic.intra_cbp(_mb_intra().read(b), mbx, mby)
        if intra:
            if vop.kind:
                counts["intra_mb_in_p"] += 1
            ac_pred = b.bit()
            if pic.per_mb_rl and cbp:
                pic.rl_luma = pic.rl_chroma = _decode012(b)
                counts["per_mb_rl"] += 1
            self._intra(b, pic, mb, mbx, mby, cbp, ac_pred)
            return
        counts["inter_mb"] += 1
        vop.mb_kind[mb] = 1
        stride, mvx, mvy = vop.stride, vop.mvx, vop.mvy
        top = (2 * mby + 1) * stride + 2 * mbx
        px, py = self._wmv2_pred(b, pic, top, mbx, mby)
        per_block_abt = 0
        if cbp:
            if pic.per_mb_rl:
                pic.rl_luma = pic.rl_chroma = _decode012(b)
                counts["per_mb_rl"] += 1
            if self.abt_flag and pic.per_mb_abt:
                per_block_abt = b.bit()
                if not per_block_abt:
                    pic.abt_type = _decode012(b)
        x, y = self._motion(b, pic, px, py)
        if (x | y) & 1 and pic.mspel:
            vop.hshift[mb] = b.bit()
            counts["hshift_1" if vop.hshift[mb] else "hshift_0"] += 1
        mvx[top] = mvx[top + 1] = mvx[top + stride] = mvx[top + stride + 1] = x
        mvy[top] = mvy[top + 1] = mvy[top + stride] = mvy[top + stride + 1] = y
        vop.motion[mb] = (1, 0, [(x, y)] * 4, None)
        rl = _rl(3 + pic.rl_luma)
        for n in range(6):
            if not cbp & (32 >> n):
                continue
            vop.coded[mb, n] = True
            if per_block_abt:
                pic.abt_type = _decode012(b)
            abt = pic.abt_type
            base = (mb * 6 + n) * 64
            if not abt:
                self._coefs(b, pic, rl, -1, self.scan_inter, 1, None, base)
                continue
            counts[f"abt_{abt}"] += 1
            vop.abt[mb, n] = abt
            scan = _SCAN_A if abt == 1 else _SCAN_B
            sub = _SUB_CBP[_decode012(b)]
            if sub & 1:
                self._coefs(b, pic, rl, -1, scan, 1, None, base)
            if sub & 2:
                start = len(vop.idx)
                self._coefs(b, pic, rl, -1, scan, 1, None, base)
                vop.idx2 += vop.idx[start:]
                vop.val2 += vop.val[start:]
                del vop.idx[start:], vop.val[start:]

    def _wmv2_pred(self, b: _Bits, pic: _Pic, top: int, mbx: int, mby: int) -> Tuple[int, int]:
        """`wmv2_pred_motion`: the left (A) or above (B) vector by a bit where
        they differ by 8 or more (top-left flag, not mspel, not a slice's top
        row, not the left column), else the median of A, B and the above
        right C (A alone on a slice's top row)."""
        vop = pic.vop
        mvx, mvy, stride = vop.mvx, vop.mvy, vop.stride
        a, bb, c = top - 1, top - stride, top + 2 - stride
        first = mby == pic.first_row
        diff = 0
        if mbx and not first and not pic.mspel and self.top_left_mv:
            diff = max(abs(mvx[a] - mvx[bb]), abs(mvy[a] - mvy[bb]))
        kind = b.bit() if diff >= 8 else 2
        if kind < 2:
            self.counts[f"mv_pred_{'left' if kind == 0 else 'above'}"] += 1
        if kind == 0 or (kind == 2 and first):
            return mvx[a], mvy[a]
        if kind == 1:
            return mvx[bb], mvy[bb]
        med = lambda p, q, r: max(min(p, q), min(max(p, q), r))  # noqa: E731
        return med(mvx[a], mvx[bb], mvx[c]), med(mvy[a], mvy[bb], mvy[c])

    # ------------------------------------------------------------ pixels

    def _transform(self, vop: _Vop, work: np.ndarray, deq: np.ndarray) -> np.ndarray:
        """WMV2's IDCT of every 8x8 block; an ABT block's two halves through
        the 8x4 or 4x8 simple IDCT (the second half's levels dequantised
        here)."""
        res = wmv2_idct(deq)
        abt = vop.abt[work]
        if not abt.any():
            return res
        second = np.zeros((len(vop.abt), 6 * 64), np.int64)
        if vop.idx2:
            idx = np.asarray(vop.idx2, np.int64)
            second.reshape(-1)[idx] = vop.val2
        lv = second.reshape(-1, 6, 8, 8)[work]
        q = np.asarray(vop.mbq, np.int64)[work][:, None, None, None]
        deq2 = np.where(lv > 0, lv * 2 * q + ((q - 1) | 1), np.where(lv < 0, lv * 2 * q - ((q - 1) | 1), 0))
        for kind, first in ((1, idct84), (2, idct48)):
            m, n = np.nonzero(abt == kind)
            if not m.size:
                continue
            one, two = first(deq[m, n]), first(deq2[m, n])
            if kind == 1:
                res[m, n] = np.concatenate([one, two], -2)
            else:
                res[m, n] = np.concatenate([one, two], -1)
        return res

    def _predict(self, planes, sel: np.ndarray, four: np.ndarray, vec: np.ndarray, rounding: int):
        """In an mspel picture every inter macroblock through `ff_mspel_motion`; else H.263's half-pel."""
        pic = self._pic
        if not pic.mspel:
            return super()._predict(planes, sel, four, vec, rounding)
        vol = self.vol
        mb_w, ew, eh = vol.mb_w, 16 * vol.mb_w, 16 * vol.mb_h
        ry, ru, rv = planes[0][:eh, :ew], planes[1][:eh >> 1, :ew >> 1], planes[2][:eh >> 1, :ew >> 1]
        mx, my = vec[:, 0, 0], vec[:, 0, 1]
        mbx, mby = sel % mb_w, sel // mb_w
        hshift = np.frombuffer(bytes(pic.vop.hshift), np.uint8)[sel].astype(np.int64)
        dxy = 2 * (((my & 1) << 1) | (mx & 1)) + hshift
        sx = np.clip(16 * mbx + (mx >> 1), -16, vol.width)
        sy = np.clip(16 * mby + (my >> 1), -16, vol.height)
        dxy = np.where((sx <= -16) | (sx >= vol.width), dxy & ~3, dxy)
        dxy = np.where((sy <= -16) | (sy >= vol.height), dxy & ~4, dxy)
        n = len(sel)
        bx, by = np.tile([0, 8, 0, 8], n), np.tile([0, 0, 8, 8], n)
        blocks = mspel(ry, np.repeat(sx, 4) + bx, np.repeat(sy, 4) + by, np.repeat(dxy, 4))
        py = blocks.reshape(n, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4).reshape(n, 16, 16)
        self.counts["mspel_mb"] += n
        cfx, cfy = (mx & 3) != 0, (my & 3) != 0
        csx = np.clip(8 * mbx + (mx >> 2), -8, vol.width >> 1)
        csy = np.clip(8 * mby + (my >> 2), -8, vol.height >> 1)
        cfx = np.where(csx == vol.width >> 1, 0, cfx).astype(np.int64)
        cfy = np.where(csy == vol.height >> 1, 0, cfy).astype(np.int64)
        pc = np.empty((n, 2, 8, 8), np.int32)
        for k, ref in enumerate((ru, rv)):
            pc[:, k] = mc.halfpel(ref, csx, csy, cfx, cfy, 8, rounding)
        return py, pc

    def _deblock(self, planes, pic: _Pic) -> None:
        """Where the extension header sets the loop filter, `ff_h263_loop_filter`
        after each macroblock in decoding order: the edges inside it and
        those it shares with the macroblocks above, above-left and left,
        each at the quantiser of a coded macroblock on either side (skipped
        macroblocks count as 0)."""
        if not self.loop_filter:
            return
        y, u, v = planes
        vol, vop = self.vol, pic.vop
        mb_w, mb_h = vol.mb_w, vol.mb_h
        skip = pic.skip if pic.skip is not None else bytearray(mb_w * mb_h)
        qs = vop.mbq
        self.counts["loop_filter_picture"] += 1
        for mb in range(mb_w * mb_h):
            mby, mbx = divmod(mb, mb_w)
            x0, y0, cx, cy = 16 * mbx, 16 * mby, 8 * mbx, 8 * mby
            qp_c = 0 if skip[mb] else qs[mb]
            if qp_c:
                _v_edge(y, y0 + 8, x0, 16, qp_c)
            if mby:
                up = mb - mb_w
                qp_tt = 0 if skip[up] else qs[up]
                qp_tc = qp_c or qp_tt
                if qp_tc:
                    _v_edge(y, y0, x0, 16, qp_tc)
                    _v_edge(u, cy, cx, 8, qp_tc)
                    _v_edge(v, cy, cx, 8, qp_tc)
                if qp_tt:
                    _h_edge(y, y0 - 8, x0 + 8, qp_tt)
                if mbx:
                    qp_dt = qp_tt if qp_tt or skip[up - 1] else qs[up - 1]
                    if qp_dt:
                        _h_edge(y, y0 - 8, x0, qp_dt)
                        _h_edge(u, cy - 8, cx, qp_dt)
                        _h_edge(v, cy - 8, cx, qp_dt)
            if qp_c:
                _h_edge(y, y0, x0 + 8, qp_c)
                if mby + 1 == mb_h:
                    _h_edge(y, y0 + 8, x0 + 8, qp_c)
            if mbx:
                qp_lc = qp_c if qp_c or skip[mb - 1] else qs[mb - 1]
                if qp_lc:
                    _h_edge(y, y0, x0, qp_lc)
                    if mby + 1 == mb_h:
                        _h_edge(y, y0 + 8, x0, qp_lc)
                        _h_edge(u, cy, cx, qp_lc)
                        _h_edge(v, cy, cx, qp_lc)


def _filter(p0, p1, p2, p3, q: int):
    """H.263's deblocking of four samples across an edge (int arrays): the new p0..p3."""
    strength = _STRENGTH[q]
    t = p0 - p3 + 4 * (p2 - p1)
    d = np.where(t < 0, -((-t) >> 3), t >> 3)  # C's division by 8
    d1 = np.where(d < -2 * strength, 0, np.where(d < -strength, -2 * strength - d, np.where(
        d < strength, d, np.where(d < 2 * strength, 2 * strength - d, 0))))
    p1, p2 = np.clip(p1 + d1, 0, 255), np.clip(p2 - d1, 0, 255)
    ad1 = np.abs(d1) >> 1
    t = p0 - p3
    d2 = np.clip(np.where(t < 0, -((-t) >> 2), t >> 2), -ad1, ad1)
    return p0 - d2, p1, p2, p3 + d2


def _v_edge(plane: np.ndarray, row: int, col: int, width: int, q: int) -> None:
    """`h263_v_loop_filter` of the horizontal edge above `row`, over `width` columns from `col` (8 per call)."""
    for x in range(col, col + width, 8):
        s = plane[row - 2:row + 2, x:x + 8].astype(np.int32)
        out = _filter(s[0], s[1], s[2], s[3], q)
        plane[row - 2:row + 2, x:x + 8] = np.stack(out).astype(np.uint8)


def _h_edge(plane: np.ndarray, row: int, col: int, q: int) -> None:
    """`h263_h_loop_filter` of the vertical edge left of `col`, over 8 rows from `row`."""
    s = plane[row:row + 8, col - 2:col + 2].astype(np.int32)
    out = _filter(s[:, 0], s[:, 1], s[:, 2], s[:, 3], q)
    plane[row:row + 8, col - 2:col + 2] = np.stack(out, -1).astype(np.uint8)
