"""Random MPEG-1 and MPEG-2 streams of the syntax no bundled encoder writes, for the port's decoder against libavcodec's.

libavcodec's `mpeg1video` and `mpeg2video` encoders write one slice per
macroblock row (MPEG-2) or per picture (MPEG-1), no concealment motion
vectors, no macroblock stuffing or escapes, and code each level the
shortest way. `Synth` writes pictures whose every syntax element is drawn
at random within what a decoder must accept:

  slices       several per row in MPEG-2, across rows in MPEG-1, each with
               its own quantiser_scale_code and random extra slice bytes;
               the vertical position's extension past 2800 lines (MPEG-2)
  macroblocks  every macroblock type of I, P and B pictures, intra
               macroblocks in P and B pictures, quantiser updates, skip
               runs of any length (macroblock_escape past 33: now and then a
               slice of a P picture skips all but its ends) and, in
               MPEG-1, macroblock_stuffing before an address increment
  vectors      f_codes 1..7 (MPEG-1) or 1..9 per direction and component
               (MPEG-2), every vector inside the picture, so that libavcodec
               predicts every block; concealment motion vectors in intra
               macroblocks (MPEG-2), which move the forward predictor
  blocks       DC differences of every size at intra DC precision 8..11,
               levels coded by table zero or one or by the escapes (MPEG-1's
               8- and 16-bit forms, MPEG-2's 12-bit one) at random, the
               alternate scan, the non-linear quantiser scale

Levels are kept small enough that every IDCT output stays well inside
16 bits (`simple_idct` is exact there). `picture(kind)` returns one
picture's packet (the sequence and GOP headers before an I picture),
kinds in decoding order: a B picture predicts from the two references
before it.
"""

import random
from typing import List, Optional, Tuple

from yolo_infer_tpu_torch.data import mpeg12_tables as T

_CODES14 = {(T.RUN[i], T.LEVEL[i]): T.VLC_B14[i] for i in range(T.ESCAPE)}
_CODES15 = {(T.RUN[i], T.LEVEL[i]): T.VLC_B15[i] for i in range(T.ESCAPE)}
_DEFAULT_INTRA = T.DEFAULT_INTRA_MATRIX
# macroblock types by libavcodec's index (data/mpeg12.py P_TYPES, B_TYPES): (intra, quant, dirs, pattern, zero_mv)
_P = [(1, 0, 0, 0, 0), (0, 0, 1, 1, 1), (0, 0, 1, 0, 0), (0, 0, 1, 1, 0), (1, 1, 0, 0, 0), (0, 1, 1, 1, 1),
      (0, 1, 1, 1, 0)]
_B = [(1, 0, 0, 0, 0), (0, 0, 2, 0, 0), (0, 0, 2, 1, 0), (0, 0, 1, 0, 0), (0, 0, 1, 1, 0), (0, 0, 3, 0, 0),
      (0, 0, 3, 1, 0), (1, 1, 0, 0, 0), (0, 1, 2, 1, 0), (0, 1, 1, 1, 0), (0, 1, 3, 1, 0)]


class _Writer:
    def __init__(self):
        self.bits: List[str] = []

    def put(self, value: int, n: int) -> None:
        if n:
            self.bits.append(format(value & ((1 << n) - 1), f"0{n}b"))

    def code(self, pair) -> None:
        self.put(pair[0], pair[1])

    def aligned(self) -> bytes:
        s = "".join(self.bits)
        s += "0" * (-len(s) % 8)
        return int(s, 2).to_bytes(len(s) // 8, "big") if s else b""


class Synth:
    """Random pictures of one sequence, `mpeg2` or MPEG-1, w x h."""

    def __init__(self, w: int, h: int, mpeg2: bool, rng: random.Random, closed_gop: bool = False):
        self.w, self.h, self.mpeg2, self.rng, self.closed_gop = w, h, mpeg2, rng, closed_gop
        self.mb_w, self.mb_h = (w + 15) // 16, (h + 15) // 16
        self.pictures = 0
        self.q_scale_type = 0

    # ------------------------------------------------------------ headers

    def sequence(self) -> bytes:
        b = _Writer()
        b.put(self.w, 12); b.put(self.h, 12); b.put(1, 4); b.put(3, 4)
        b.put(0x3FFFF, 18); b.put(1, 1); b.put(112, 10); b.put(0, 1)
        b.put(0, 1); b.put(0, 1)  # the default matrices
        out = b"\x00\x00\x01\xb3" + b.aligned()
        if self.mpeg2:
            e = _Writer()
            e.put(1, 4); e.put(0x48, 8); e.put(1, 1); e.put(1, 2); e.put(0, 2); e.put(0, 2); e.put(0, 12); e.put(1, 1)
            e.put(0, 8); e.put(0, 1); e.put(0, 2); e.put(0, 5)
            out += b"\x00\x00\x01\xb5" + e.aligned()
        g = _Writer()
        g.put(1 << 12, 25); g.put(int(self.closed_gop), 1); g.put(0, 1)  # a time code with its marker
        return out + b"\x00\x00\x01\xb8" + g.aligned()

    def picture(self, kind: int) -> bytes:
        """One picture (1 I, 2 P, 3 B) and, before an I picture, the sequence's headers."""
        rng = self.rng
        out = self.sequence() if kind == 1 else b""
        f = [[rng.randint(1, 9 if self.mpeg2 else 7)] * 2 for _ in range(2)]
        if self.mpeg2:
            f = [[rng.randint(1, 9), rng.randint(1, 9)] for _ in range(2)]
        self.f_code = f
        self.kind = kind
        p = _Writer()
        p.put(self.pictures & 1023, 10); p.put(kind, 3); p.put(0xFFFF, 16)
        for d in range(kind - 1):
            p.put(0, 1)
            p.put(7 if self.mpeg2 else f[d][0], 3)
        p.put(0, 1)  # extra_bit_picture
        out += b"\x00\x00\x01\x00" + p.aligned()
        self.dc_precision = rng.randint(0, 3) if self.mpeg2 else 0
        self.concealment = int(self.mpeg2 and rng.random() < 0.5)
        self.q_scale_type = int(self.mpeg2 and rng.random() < 0.4)
        self.intra_vlc = int(self.mpeg2 and rng.random() < 0.5)
        self.alternate = int(self.mpeg2 and rng.random() < 0.4)
        if self.mpeg2:
            e = _Writer()
            e.put(8, 4)
            for d in range(2):
                for c in range(2):
                    e.put(f[d][c] if kind - 1 > d or (d == 0 and self.concealment) else 15, 4)
            e.put(self.dc_precision, 2); e.put(3, 2); e.put(0, 1); e.put(1, 1); e.put(self.concealment, 1)
            e.put(self.q_scale_type, 1); e.put(self.intra_vlc, 1); e.put(self.alternate, 1); e.put(0, 1)
            e.put(1, 1); e.put(1, 1); e.put(0, 1)
            out += b"\x00\x00\x01\xb5" + e.aligned()
        self.pictures += 1
        return out + self._slices()

    # ------------------------------------------------------------ slices

    def _slices(self) -> bytes:
        rng, mb_w = self.rng, self.mb_w
        n_mb = mb_w * self.mb_h
        starts = [0]
        if self.mpeg2:  # every row starts a slice; a few more inside rows
            starts = sorted({r * mb_w for r in range(self.mb_h)} | {rng.randrange(n_mb) for _ in range(self.mb_h)})
        else:
            starts = sorted({0} | {rng.randrange(n_mb) for _ in range(rng.randint(0, 3))})
        out = b""
        for k, first in enumerate(starts):
            last = (starts[k + 1] if k + 1 < len(starts) else n_mb) - 1
            out += self._slice(first, last)
        return out

    def _qcode(self) -> int:
        return self.rng.randint(1, 8)

    def _slice(self, first: int, last: int) -> bytes:
        rng = self.rng
        b = _Writer()
        row = first // self.mb_w
        if self.mpeg2 and self.mb_h > 2800 // 16:
            b.put(row >> 7, 3)  # slice_vertical_position_extension
        code = self._qcode()
        self.qs = self._scale(code)
        b.put(code, 5)
        while rng.random() < 0.3:  # extra_information_slice
            b.put(1, 1); b.put(rng.randrange(256), 8)
        b.put(0, 1)
        self.dc = [128 << self.dc_precision] * 3
        self.pmv = [[0, 0], [0, 0]]
        self.last_dirs, self.prev_intra = 1, False
        self._increment(b, first % self.mb_w + 1)
        mb, skip = first, 0
        chance = 1.0 if self.kind == 2 and rng.random() < 0.3 else 0.3  # now and then a slice of one long skip run
        while mb <= last:
            if mb not in (first, last) and self.kind != 1 and rng.random() < chance and self._can_skip(mb):
                skip += 1
                if self.kind == 2:
                    self.pmv[0] = [0, 0]
                self.dc = [128 << self.dc_precision] * 3
                mb += 1
                continue
            if mb != first:
                self._increment(b, skip + 1)
            skip = 0
            self._macroblock(b, mb)
            mb += 1
        return b"\x00\x00\x01" + bytes([(row & 127 if self.mb_h > 2800 // 16 else row) + 1]) + b.aligned()

    def _scale(self, code: int) -> int:
        return T.NON_LINEAR_QSCALE[code] if self.q_scale_type else code << 1

    def _increment(self, b: _Writer, incr: int) -> None:
        if not self.mpeg2 and self.rng.random() < 0.2:
            b.code(T.MB_ADDR_INCR[34])  # macroblock_stuffing
        while incr > 33:
            b.code(T.MB_ADDR_INCR[33])  # macroblock_escape
            incr -= 33
        b.code(T.MB_ADDR_INCR[incr - 1])

    def _in_bounds(self, mb: int, mx: int, my: int) -> bool:
        sx, sy = 16 * (mb % self.mb_w) + (mx >> 1), 16 * (mb // self.mb_w) + (my >> 1)
        return sx >= 0 and sy >= 0 and sx + 16 + (mx & 1) <= 16 * self.mb_w and sy + 16 + (my & 1) <= 16 * self.mb_h

    def _can_skip(self, mb: int) -> bool:
        if self.kind == 2:
            return True
        return not self.prev_intra and all(self._in_bounds(mb, *self.pmv[d]) for d in range(2)
                                           if self.last_dirs >> d & 1)

    # ------------------------------------------------------------ macroblocks

    def _macroblock(self, b: _Writer, mb: int) -> None:
        rng = self.rng
        if self.kind == 1:
            t = (1, rng.random() < 0.3, 0, 0, 0)
            b.put(1, 1) if not t[1] else b.put(1, 2)
        else:
            table = _P if self.kind == 2 else _B
            index = rng.randrange(len(table))
            t = table[index]
            b.code((T.MB_PTYPE if self.kind == 2 else T.MB_BTYPE)[index])
        intra, quant, dirs, pattern, zero_mv = t
        if quant:
            code = self._qcode()
            self.qs = self._scale(code)
            b.put(code, 5)
        if intra:
            if self.concealment:
                for c in range(2):
                    self.pmv[0][c] = self._vector(b, self.f_code[0][c], self.pmv[0][c], None)
                b.put(1, 1)
            else:
                self.pmv = [[0, 0], [0, 0]]
            self.prev_intra = True
            for n in range(6):
                self._intra_block(b, n)
            return
        self.prev_intra = False
        if zero_mv:
            self.pmv[0] = [0, 0]
        else:
            for d in range(2):
                if dirs >> d & 1:
                    target = self._target(mb, d)
                    self.pmv[d] = [self._vector(b, self.f_code[d][c], self.pmv[d][c], target[c]) for c in range(2)]
            self.last_dirs = dirs
        self.dc = [128 << self.dc_precision] * 3
        if pattern:
            cbp = rng.randint(1, 63)
            b.code(T.MB_PATTERN[cbp])
            for n in range(6):
                if cbp & (32 >> n):
                    self._inter_block(b)

    def _target(self, mb: int, d: int) -> Tuple[int, int]:
        """A vector in the f_codes' range whose block lies inside the picture."""
        rng = self.rng
        for _ in range(20):
            v = [rng.randrange(-16 << (self.f_code[d][c] - 1), 16 << (self.f_code[d][c] - 1)) for c in range(2)]
            if rng.random() < 0.3:
                v = [rng.randint(-6, 6), rng.randint(-6, 6)]
            if self._in_bounds(mb, *v):
                return v[0], v[1]
        return 0, 0

    def _vector(self, b: _Writer, f_code: int, pred: int, target: Optional[int]) -> int:
        """One component's motion_code and residual to `target` (random if None) from `pred`."""
        shift = f_code - 1
        span = 16 << shift
        if target is None:
            target = self.rng.randrange(-span, span)
        delta = (target - pred + span) % (2 * span) - span
        if delta == 0:
            b.code(T.MB_MOTION[0])
            return target
        mag = abs(delta) - 1
        b.code(T.MB_MOTION[(mag >> shift) + 1])
        b.put(int(delta < 0), 1)
        b.put(mag & ((1 << shift) - 1), shift)
        return target

    # ------------------------------------------------------------ blocks

    def _levels(self, intra: bool, chroma: bool) -> List[Tuple[int, int]]:
        """(scan position, level) of a block's coefficients past the DC:
        levels whose dequantised value stays within 300."""
        rng = self.rng
        out, pos = [], 0 if intra else -1
        for _ in range(rng.randint(0 if intra else 1, 4)):
            pos += rng.choice([1, 1, 2, 3, 7, 20])
            if pos > 63:
                break
            w = _DEFAULT_INTRA[(T.ALTERNATE_SCAN if self.alternate else T.ZIGZAG)[pos]] if intra else 16
            limit = max(1, (300 * 16) // (self.qs * w)) if intra else max(1, (300 * 32 // (self.qs * w) - 1) // 2)
            level = min(rng.choice([1, 1, 2, 3, rng.randint(4, 60), rng.randint(100, 255)]), limit)
            out.append((pos, level if rng.random() < 0.5 else -level))
        return out

    def _coefficients(self, b: _Writer, coefs, first_inter: bool, table) -> None:
        rng = self.rng
        prev = 0 if not first_inter else -1
        for k, (pos, level) in enumerate(coefs):
            run = pos - prev - 1
            prev = pos
            if first_inter and k == 0 and run == 0 and abs(level) == 1 and rng.random() < 0.8:
                b.put(1, 1); b.put(int(level < 0), 1)  # the first coefficient's own code
                continue
            code = table.get((run, abs(level)))
            if code is not None and rng.random() < 0.85 and not (first_inter and k == 0 and code[0] >> (code[1] - 1)):
                b.code(code); b.put(int(level < 0), 1)
                continue
            b.code(T.VLC_B14[T.ESCAPE]); b.put(run, 6)  # the escape (the same code in both tables)
            if self.mpeg2:
                b.put(level, 12)
            elif -128 < level < 128:
                b.put(level, 8)
            elif level > 0:
                b.put(0, 8); b.put(level, 8)
            else:
                b.put(0x80, 8); b.put(level + 256, 8)
        b.code(T.VLC_B15[T.END_OF_BLOCK] if table is _CODES15 else T.VLC_B14[T.END_OF_BLOCK])

    def _intra_block(self, b: _Writer, n: int) -> None:
        rng = self.rng
        c = 0 if n < 4 else n - 3
        p = self.dc_precision
        target = rng.randint(24 << p, (232 << p) - 1)
        diff = target - self.dc[c]
        self.dc[c] = target
        size = abs(diff).bit_length()
        code = (T.DC_LUM_CODE if c == 0 else T.DC_CHROMA_CODE)[size], (T.DC_LUM_BITS if c == 0 else T.DC_CHROMA_BITS)[size]
        b.code(code)
        b.put(diff if diff > 0 else diff + (1 << size) - 1, size)
        table = _CODES15 if self.intra_vlc else _CODES14
        self._coefficients(b, self._levels(True, c > 0), False, table)

    def _inter_block(self, b: _Writer) -> None:
        self._coefficients(b, self._levels(False, False), True, _CODES14)


def stream(rng: random.Random, mpeg2: bool, w: int, h: int, kinds, closed_gop: bool = False) -> List[bytes]:
    """The packets of one random stream: `kinds` in decoding order (the first an I picture)."""
    synth = Synth(w, h, mpeg2, rng, closed_gop)
    return [synth.picture(k) for k in kinds]


def kinds_of(rng: random.Random, n: int) -> List[int]:
    """Picture types in decoding order: I first, B pictures only after two references."""
    kinds, refs = [1], 1
    while len(kinds) < n:
        k = rng.choice([1, 2, 2, 3, 3]) if refs >= 2 else rng.choice([1, 2])
        kinds.append(k)
        refs += k != 3
    return kinds
