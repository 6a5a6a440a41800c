"""Random MS-MPEG-4 v2, v3, WMV1 and WMV2 streams that use the syntax libavcodec's encoders never write.

libavcodec's `msmpeg4v2`, `msmpeg4`, `wmv1` and `wmv2` encoders write one
slice, no AC prediction, DC table 1 and motion vector table 1, a skip flag
in every P picture, no per-macroblock RL tables, escape 3 with lengths 8
and 6 only, and (WMV2) neither mspel, ABT, a skip map, the top-left vector
prediction nor more than one slice. Real streams of other encoders use all
of it. `Synth(version, width, height, rng)` writes pictures that draw each
of these choices at random, with random coefficients in every escape form (levels kept to what
real pictures hold: no transform saturates),
so that libavcodec's decoders (the oracle, through
`tests/torch_mpeg4/libavcodec.py`) and the port's can be compared on them.

The writer codes from `data/msmpeg4_tables.py` and keeps the state the
syntax depends on (coded block predictors of I pictures, WMV2's vectors
for its prediction rule and half-shift bits, escape 3's lengths); what it
does not track (DCs, the other versions' vectors) it draws small, so that
the streams stay valid. A table or rule the writer and the port share and
get wrong still shows: libavcodec then decodes other planes. WMV2's
extension header flags are drawn, or set by `flags`.

    synth = Synth(3, 64, 48, random.Random(1))
    packets = [synth.picture(k) for k in (0, 1, 1, 0, 1)]   # 0 an I picture, 1 a P picture
"""

import random
from typing import Dict, List, Tuple

from yolo_infer_tpu_torch.data import msmpeg4_tables as T
from yolo_infer_tpu_torch.data.mpeg4 import _CBPY, _DC_CHROM, _DC_LUM, _MVD
from yolo_infer_tpu_torch.data.msmpeg4 import II_BITRATE, MBAC_BITRATE, V2, V3, WMV1, WMV2, _RL_SOURCES, _canonical
from yolo_infer_tpu_torch.data.wmv2 import _CBP_TABLE


def _pairs(flat) -> List[Tuple[int, int]]:
    return [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]


_MB_INTRA = _pairs(T.MB_INTRA)
_MB_NON_INTRA = [_pairs(t) for t in (T.MB_NON_INTRA_0, T.MB_NON_INTRA_1, T.MB_NON_INTRA_2, T.MB_NON_INTRA_3)]
_DC = [[_pairs(T.DC0_LUMA), _pairs(T.DC0_CHROMA)], [_pairs(T.DC1_LUMA), _pairs(T.DC1_CHROMA)]]
_MV = [_canonical(T.MV0_LENGTHS, T.MV0_SYMBOLS), _canonical(T.MV1_LENGTHS, T.MV1_SYMBOLS)]
_MV_SYMBOLS = [sorted(s for s in m if s) for m in _MV]
_V2_MB_TYPE, _V2_INTRA_CBPC, _INTER_INTRA = _pairs(T.V2_MB_TYPE), _pairs(T.V2_INTRA_CBPC), _pairs(T.INTER_INTRA)
_V2_DC = [[(c ^ ((1 << n) - 1), n) for c, n in t[:10]] for t in (_DC_LUM, _DC_CHROM)]


class _Rl:
    def __init__(self, index: int):
        flat, runs, levels, last_from = _RL_SOURCES[index]
        self.codes = _pairs(flat)
        self.escape = self.codes[len(runs)]
        self.events = [(int(i >= last_from), runs[i], levels[i]) for i in range(len(runs))]
        self.max_level: Dict[Tuple[int, int], int] = {}
        self.max_run: Dict[Tuple[int, int], int] = {}
        for last, run, level in self.events:
            self.max_level[last, run] = max(self.max_level.get((last, run), 0), level)
            self.max_run[last, level] = max(self.max_run.get((last, level), 0), run)


_RL = [_Rl(i) for i in range(6)]


class _Writer:
    """MSB-first bits."""

    def __init__(self):
        self.value, self.n = 0, 0

    def put(self, value: int, n: int) -> None:
        self.value = (self.value << n) | (value & ((1 << n) - 1))
        self.n += n

    def code(self, pair: Tuple[int, int]) -> None:
        self.put(*pair)

    def code012(self, v: int) -> None:
        self.put((0, 2, 3)[v], (1, 2, 2)[v])

    def bytes(self) -> bytes:
        pad = -self.n % 8
        return (self.value << pad).to_bytes((self.n + pad) // 8, "big")


class Synth:
    """A random stream of one version at one size; `picture(kind)` writes
    the next I (0) or P (1) picture. WMV2's extension header is
    `extradata`."""

    def __init__(self, version: int, width: int, height: int, rng: random.Random, flags: Dict[str, int] = None):
        self.version, self.rng = version, rng
        self.mb_w, self.mb_h = (width + 15) // 16, (height + 15) // 16
        self.width, self.height = width, height
        self.bit_rate = 0
        self.extradata = b""
        if version == WMV2:
            w = _Writer()
            w.put(rng.randint(0, 31), 5)
            self.bit_rate = rng.randint(0, 2047) * 1024
            w.put(self.bit_rate // 1024, 11)
            names = ("mspel_bit", "loop", "abt", "j_type_bit", "top_left", "per_mb_rl_bit")
            for name in names:  # drawn, or as `flags` sets them
                setattr(self, name, (flags or {}).get(name, rng.randint(0, 1)))
                w.put(getattr(self, name), 1)
            code = rng.randint(1, min(7, self.mb_h))
            w.put(code, 3)
            self.slice_height = self.mb_h // code
            self.extradata = w.bytes()

    # ---------------------------------------------------------------- pictures

    def picture(self, kind: int, ext_header: bool = True) -> bytes:
        """The next I (0) or P (1) picture; an I picture of v2 or v3 without
        the extension header after its macroblocks where `ext_header` is
        False."""
        rng, v = self.rng, self.version
        w = _Writer()
        self.q = q = rng.choice([rng.randint(1, 31), rng.randint(1, 7), rng.randint(8, 31)])
        self.esc3 = None
        self.rl_luma = self.rl_chroma = 2
        self.per_mb_rl = self.inter_intra = 0
        self.mvs = [[(0, 0)] * self.mb_w for _ in range(self.mb_h)]
        self.coded = {}
        if v == WMV2:
            return self._wmv2_picture(w, kind, q)
        w.put(kind, 2)
        w.put(q, 5)
        if kind == 0:
            slices = rng.randint(1, self.mb_h)
            w.put(0x16 + slices, 5)
            if v == V3:
                self.rl_chroma, self.rl_luma = rng.randint(0, 2), rng.randint(0, 2)
                w.code012(self.rl_chroma)
                w.code012(self.rl_luma)
                self.dc_table = rng.randint(0, 1)
                w.put(self.dc_table, 1)
            elif v == WMV1:
                w.put(rng.randint(0, 31), 5)
                self.bit_rate = rng.choice([rng.randint(0, 49), rng.randint(51, 127), rng.randint(129, 2047)]) * 1024
                w.put(self.bit_rate // 1024, 11)
                w.put(rng.randint(0, 1), 1)  # flip-flop rounding
                self._rl_choice(w, intra_picture=True)
                self.dc_table = rng.randint(0, 1)
                w.put(self.dc_table, 1)
            for mby in range(self.mb_h):
                for mbx in range(self.mb_w):
                    self._intra_mb(w, mbx, mby, p_picture=False)
            if v < WMV1 and ext_header:  # the extension header after the last macroblock
                w.put(rng.randint(0, 31), 5)
                w.put(rng.randint(0, 2047), 11)
                if v == V3:
                    w.put(rng.randint(0, 1), 1)
            return w.bytes()
        skip_code = rng.randint(0, 1)
        w.put(skip_code, 1)
        if v == V3:
            self.rl_luma = self.rl_chroma = rng.randint(0, 2)
            w.code012(self.rl_luma)
        elif v == WMV1:
            self._rl_choice(w, intra_picture=False)
            self.inter_intra = int(self.width * self.height < 320 * 240 and self.bit_rate <= II_BITRATE)
        if v > V2:
            self.dc_table, self.mv_table = rng.randint(0, 1), rng.randint(0, 1)
            w.put(self.dc_table, 1)
            w.put(self.mv_table, 1)
        for mby in range(self.mb_h):
            for mbx in range(self.mb_w):
                if skip_code:
                    skip = rng.random() < 0.2
                    w.put(int(skip), 1)
                    if skip:
                        continue
                if rng.random() < 0.15:
                    self._intra_mb(w, mbx, mby, p_picture=True)
                else:
                    self._inter_mb(w, mbx, mby)
        return w.bytes()

    def _rl_choice(self, w: _Writer, intra_picture: bool) -> None:
        """WMV1's per-macroblock RL flag (above MBAC_BITRATE), else the picture's table choice."""
        rng = self.rng
        if self.bit_rate > MBAC_BITRATE:
            self.per_mb_rl = rng.randint(0, 1)
            w.put(self.per_mb_rl, 1)
        if not self.per_mb_rl:
            if intra_picture:
                self.rl_chroma = rng.randint(0, 2)
                w.code012(self.rl_chroma)
            self.rl_luma = rng.randint(0, 2)
            w.code012(self.rl_luma)
            if not intra_picture:
                self.rl_chroma = self.rl_luma

    def _per_mb_rl(self, w: _Writer, cbp: int) -> None:
        if self.per_mb_rl and cbp:
            self.rl_luma = self.rl_chroma = self.rng.randint(0, 2)
            w.code012(self.rl_luma)

    # ---------------------------------------------------------------- macroblocks

    def _coded_bits(self, mbx: int, mby: int, cbp: int) -> int:
        """An I picture's pattern code: the luma bits against their prediction."""
        code = cbp & 3
        for n in range(4):
            x, y = 2 * mbx + (n & 1), 2 * mby + (n >> 1)
            a, b, c = self.coded.get((x - 1, y), 0), self.coded.get((x - 1, y - 1), 0), self.coded.get((x, y - 1), 0)
            val = (cbp >> (5 - n)) & 1
            self.coded[x, y] = val
            code |= (val ^ (a if b == c else c)) << (5 - n)
        return code

    def _intra_mb(self, w: _Writer, mbx: int, mby: int, p_picture: bool) -> None:
        rng, v = self.rng, self.version
        cbp = rng.randint(0, 63)
        ac_pred = rng.randint(0, 1)
        if v == V2:
            if p_picture:
                w.code(_V2_MB_TYPE[4 | cbp & 3])
            else:
                w.code(_V2_INTRA_CBPC[cbp & 3])
            w.put(ac_pred, 1)
            w.code(_CBPY[cbp >> 2])
        else:
            if p_picture:
                w.code(_MB_NON_INTRA[self.cbp_table][cbp])
            else:
                w.code(_MB_INTRA[self._coded_bits(mbx, mby, cbp)])
            w.put(ac_pred, 1)
            if self.inter_intra:
                w.code(_INTER_INTRA[rng.randint(0, 3)])
            self._per_mb_rl(w, cbp)
        for n in range(6):
            self._dc(w, n)
            if cbp & (32 >> n):
                self._coefs(w, self.rl_luma if n < 4 else 3 + self.rl_chroma, 0, int(v >= WMV1), 63)
        self.mvs[mby][mbx] = (0, 0)

    def _dc(self, w: _Writer, n: int) -> None:
        diff = self.rng.choice([-2, -1, 0, 0, 0, 1, 1, 2])
        if self.version == V2:
            size = abs(diff).bit_length()
            w.code(_V2_DC[n >= 4][size])
            if size:
                w.put(diff if diff > 0 else diff + (1 << size) - 1, size)
            return
        w.code(_DC[self.dc_table][n >= 4][abs(diff)])
        if diff:
            w.put(int(diff < 0), 1)

    def _inter_mb(self, w: _Writer, mbx: int, mby: int) -> None:
        rng, v = self.rng, self.version
        cbp = rng.randint(0, 63)
        if v == V2:
            w.code(_V2_MB_TYPE[cbp & 3])
            luma = cbp >> 2
            w.code(_CBPY[luma if cbp & 3 == 3 else luma ^ 15])
            for _ in range(2):
                m = rng.choice([0, 0, 1, 2, 3, rng.randint(0, 32)])
                w.code(_MVD[m])
                if m:
                    w.put(rng.randint(0, 1), 1)
        else:
            w.code(_MB_NON_INTRA[self.cbp_table][64 | cbp])
            self._per_mb_rl(w, cbp)
            self._mv_symbol(w)
        for n in range(6):
            if cbp & (32 >> n):
                self._coefs(w, 3 + self.rl_luma, -1, int(v != V2), 63)

    def _mv_symbol(self, w: _Writer) -> int:
        """A vector code (an escape now and then): the change it codes, before the wrap."""
        table = _MV[self.mv_table]
        if self.rng.random() < 0.1:
            x, y = self.rng.randint(0, 63), self.rng.randint(0, 63)
            w.code(table[0])
            w.put(x, 6)
            w.put(y, 6)
        else:
            sym = self.rng.choice(_MV_SYMBOLS[self.mv_table])
            w.code(table[sym])
            x, y = sym >> 8, sym & 0xFF
        return x - 32, y - 32

    @property
    def cbp_table(self) -> int:
        return self._cbp_table if self.version == WMV2 else 3

    # ---------------------------------------------------------------- coefficients

    def _coefs(self, w: _Writer, rl_index: int, i: int, run_diff: int, end: int) -> None:
        """One block's events from position i + 1 to at most `end`, the last
        one flagged; each level small enough that its dequantised value stays
        under 1000, as in real pictures."""
        rng, rl = self.rng, _RL[rl_index]
        most = max(1, 500 // self.q)  # the largest level
        events = rng.randint(1, 5)
        for k in range(events):
            room = end - i - 1  # the largest run that keeps the event in the block
            last = int(k == events - 1 or room < 2)
            room -= 1 - last  # an event that is not the last one stays before the block's end
            form = rng.choice("nnnnn123")
            fits = [e for e, (el, run, level) in enumerate(rl.events) if el == last and run <= room and level <= most]
            if form == "1":
                picks = [e for e in fits if rl.events[e][2] + rl.max_level[last, rl.events[e][1]] <= most]
            elif form == "2":
                picks = [e for e in fits if rl.events[e][1] + rl.max_run[last, rl.events[e][2]] + run_diff <= room]
            else:
                picks = fits
            if form in "12" and not picks:
                form, picks = "n", fits
            if form in "n12":
                e = rng.choice(picks)
                if form != "n":
                    w.code(rl.escape)
                    w.put(1, int(form))  # escape 1: a 1; escape 2: 01
                w.code(rl.codes[e])
                w.put(rng.randint(0, 1), 1)
                _, run, level = rl.events[e]
                i += run + 1 + (rl.max_run[last, level] + run_diff if form == "2" else 0)
            else:
                w.code(rl.escape)
                w.put(0, 2)
                w.put(last, 1)
                if self.version <= V3:
                    run = rng.randint(0, min(room, 63))
                    level = rng.randint(1, min(most, 40)) * rng.choice([1, -1])
                    w.put(run, 6)
                    w.put(level, 8)
                else:
                    if self.esc3 is None:
                        ll = rng.randint(1, 9) if self.q < 8 else rng.randint(2, 8)
                        run_len = rng.randint(3, 6)
                        self.esc3 = ll, run_len
                        if self.q < 8:
                            w.put(ll if ll < 8 else 0, 3)
                            if ll >= 8:
                                w.put(ll - 8, 1)
                        else:
                            w.put(1, ll - 1) if ll < 8 else w.put(0, 6)
                        w.put(run_len - 3, 2)
                    ll, run_len = self.esc3
                    run = rng.randint(0, min(room, (1 << run_len) - 1))
                    w.put(run, run_len)
                    w.put(rng.randint(0, 1), 1)
                    w.put(rng.randint(1, min((1 << ll) - 1, most, 40)), ll)
                i += run + 1
            if last:
                return

    # ---------------------------------------------------------------- WMV2

    def _wmv2_picture(self, w: _Writer, kind: int, q: int) -> bytes:
        rng = self.rng
        w.put(kind, 1)
        if kind == 0:
            w.put(rng.randint(0, 127), 7)
        w.put(q, 5)
        self.mspel = self.per_mb_abt = self.abt_type = 0
        if kind == 0:
            if self.j_type_bit:
                w.put(0, 1)
            self._wmv2_rl(w, True)
            self.dc_table = rng.randint(0, 1)
            w.put(self.dc_table, 1)
            for mby in range(self.mb_h):
                for mbx in range(self.mb_w):
                    self._intra_mb(w, mbx, mby, p_picture=False)
            return w.bytes()
        skip = self._skip_map(w)
        index = rng.randint(0, 2)
        w.code012(index)
        self._cbp_table = _CBP_TABLE[(q > 10) + (q > 20)][index]
        if self.mspel_bit:
            self.mspel = rng.randint(0, 1)
            w.put(self.mspel, 1)
        if self.abt:
            self.per_mb_abt = rng.randint(0, 1)
            w.put(self.per_mb_abt ^ 1, 1)
            if not self.per_mb_abt:
                self.abt_type = rng.randint(0, 2)
                w.code012(self.abt_type)
        self._wmv2_rl(w, False)
        self.dc_table, self.mv_table = rng.randint(0, 1), rng.randint(0, 1)
        w.put(self.dc_table, 1)
        w.put(self.mv_table, 1)
        for mby in range(self.mb_h):
            for mbx in range(self.mb_w):
                if skip[mby][mbx]:
                    self.mvs[mby][mbx] = (0, 0)
                elif rng.random() < 0.15:
                    self._intra_mb(w, mbx, mby, p_picture=True)
                else:
                    self._wmv2_inter(w, mbx, mby)
        return w.bytes()

    def _wmv2_rl(self, w: _Writer, intra_picture: bool) -> None:
        if self.per_mb_rl_bit:
            self.per_mb_rl = self.rng.randint(0, 1)
            w.put(self.per_mb_rl, 1)
        if not self.per_mb_rl:
            if intra_picture:
                self.rl_chroma = self.rng.randint(0, 2)
                w.code012(self.rl_chroma)
            self.rl_luma = self.rng.randint(0, 2)
            w.code012(self.rl_luma)
            if not intra_picture:
                self.rl_chroma = self.rl_luma

    def _skip_map(self, w: _Writer) -> List[List[int]]:
        """A random skip map of one of the four kinds (a fully skipped picture is left to `skipped_picture`)."""
        rng, mb_w, mb_h = self.rng, self.mb_w, self.mb_h
        kind = rng.randint(0, 3)
        w.put(kind, 2)
        skip = [[0] * mb_w for _ in range(mb_h)]
        if kind == 1:
            for mby in range(mb_h):
                for mbx in range(mb_w):
                    skip[mby][mbx] = int(rng.random() < 0.3)
                    w.put(skip[mby][mbx], 1)
        elif kind in (2, 3):
            outer, inner = (mb_h, mb_w) if kind == 2 else (mb_w, mb_h)
            whole_first = 0  # the first line coded: a map of whole lines would read as a skipped picture
            for i in range(outer):
                whole = int(rng.random() < 0.3) if i else whole_first
                w.put(whole, 1)
                for j in range(inner):
                    y, x = (i, j) if kind == 2 else (j, i)
                    skip[y][x] = 1 if whole else int(rng.random() < 0.3)
                    if not whole:
                        w.put(skip[y][x], 1)
        return skip

    def skipped_picture(self) -> bytes:
        """A WMV2 P picture whose skip map (per row) skips every macroblock: no frame."""
        w = _Writer()
        w.put(1, 1)
        w.put(self.rng.randint(1, 31), 5)
        w.put(2, 2)
        w.put((1 << self.mb_h) - 1, self.mb_h)
        w.put(0, 16)
        return w.bytes()

    def intrax8_picture(self) -> bytes:
        """A WMV2 I picture with its j-type bit set (IntraX8), random bytes after."""
        w = _Writer()
        w.put(0, 1)
        w.put(0, 7)
        w.put(self.rng.randint(1, 31), 5)
        w.put(1, 1)
        for _ in range(64):
            w.put(self.rng.randint(0, 255), 8)
        return w.bytes()

    def _wmv2_inter(self, w: _Writer, mbx: int, mby: int) -> None:
        rng = self.rng
        cbp = rng.randint(0, 63)
        w.code(_MB_NON_INTRA[self._cbp_table][64 | cbp])
        first = mby % self.slice_height == 0
        a = self.mvs[mby][mbx - 1] if mbx else (0, 0)
        b = self.mvs[mby - 1][mbx] if mby else (0, 0)
        c = self.mvs[mby - 1][mbx + 1] if mby and mbx + 1 < self.mb_w else (0, 0)
        diff = 0
        if mbx and not first and not self.mspel and self.top_left:
            diff = max(abs(a[0] - b[0]), abs(a[1] - b[1]))
        if diff >= 8:
            kind = rng.randint(0, 1)
            w.put(kind, 1)
            pred = a if kind == 0 else b
        elif first:
            pred = a
        else:
            pred = tuple(max(min(p, q), min(max(p, q), r)) for p, q, r in zip(a, b, c))
        per_block_abt = 0
        if cbp:
            self._per_mb_rl(w, cbp)
            if self.abt and self.per_mb_abt:
                per_block_abt = rng.randint(0, 1)
                w.put(per_block_abt, 1)
                if not per_block_abt:
                    self.abt_type = rng.randint(0, 2)
                    w.code012(self.abt_type)
        dx, dy = self._mv_symbol(w)
        mv = []
        for p, d in zip(pred, (dx, dy)):
            m = p + d
            mv.append(m + 64 if m <= -64 else m - 64 if m >= 64 else m)
        if (mv[0] | mv[1]) & 1 and self.mspel:
            w.put(rng.randint(0, 1), 1)
        self.mvs[mby][mbx] = tuple(mv)
        for n in range(6):
            if not cbp & (32 >> n):
                continue
            if per_block_abt:
                self.abt_type = rng.randint(0, 2)
                w.code012(self.abt_type)
            if self.abt_type:
                sub = rng.randint(0, 2)
                w.code012(sub)
                for half in (1, 2):
                    if (2, 3, 1)[sub] & half:
                        self._coefs(w, 3 + self.rl_luma, -1, 1, 31)
            else:
                self._coefs(w, 3 + self.rl_luma, -1, 1, 63)
