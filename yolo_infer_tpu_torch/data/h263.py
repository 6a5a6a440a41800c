"""H.263 baseline video (ITU-T H.263, no annexes) in numpy: the picture layer over `data/mpeg4.py`'s macroblock machinery.

OpenCV's FFmpeg writer writes H.263 under the fourcc `H263` into `.avi`
and `.mov` files (libavcodec's `h263` encoder: only the five source
formats, 128x96, 176x144, 352x288, 704x576 and 1408x1152), and OpenCV
reads them back through libavcodec's `h263` decoder. `H263Decoder`
decodes those streams to the planes that decoder gives, bit for bit, and
so, through `data/mpeg4.py yuv420_to_bgr`, to the frames OpenCV returns.
The containers are `data/avi.py` (the `H263` and `U263` tags in either
letter case), `data/mkv.py` (those tags under `V_MS/VFW/FOURCC`, as
OpenCV's writer puts them in a `.mkv`) and `data/mp4.py` (the `h263` and
`s263` sample entries).

Decoded:

  picture   the picture start code, TR, PTYPE with source formats 1 to 5
            and I and P pictures, PQUANT, CPM (0) and PEI with its spare
            bytes
  GOBs      a GOB header (GBSC after zero stuffing, GN, GFID, GQUANT)
            where the bits after a macroblock are 16 zeros, as libavcodec
            ends a slice there; each GOB header starts a slice: the
            macroblocks above it are unavailable to vector prediction
            (libavcodec's first slice line)
  macroblocks COD, MCBPC, CBPY and DQUANT (`data/mpeg4.py`'s tables), the
            MVD with no fcode (wrapped to 6 bits) and median prediction,
            four vectors where MCBPC says so (libavcodec decodes the
            inter-4V types, with DQUANT too, that the `h263` encoder writes
            under `+mv4` without the advanced prediction flag), skipped
            macroblocks
  blocks    an 8-bit INTRADC (255 is 128) with no DC or AC prediction, the
            inter TCOEF table for every block, its escape a fixed-length
            LAST, RUN and 8-bit LEVEL; H.263 dequantisation, the DC by 8
  output    libavcodec's simple IDCT, half-pel motion compensation with
            rounding type 0 (`data/mpeg4_motion.py`), one picture out per
            packet (no delay)

Raising `NotImplementedError` (ROADMAP Queue 1 item 11.2), checked over
every picture header before any frame (`check_stream`): H.263+ (PLUSPTYPE,
source format 7, as the `h263p` encoder writes; 6 is reserved), the PTYPE
annexes D (unrestricted vectors), E (syntax-based arithmetic coding), F
(advanced prediction: the `h263` encoder's `obmc`) and G (PB-frames),
continuous presence multipoint, and an escaped level of -128 (libavcodec's
11-bit extension; the `h263` encoder clips levels to +-127). A corrupt or
truncated stream raises `ValueError`.

The short video header of MPEG-4 Part 2 is this syntax inside an MPEG-4
stream. libavcodec's MPEG-4 decoder finds no VOP in it ("header damaged"),
so OpenCV returns no frame of such a stream and `data/mpeg4.py` returns
none either (`short_header` in its tallies); only the H.263 tags reach this
decoder.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from yolo_infer_tpu_torch.data.mpeg4 import _LUT_INTER, _ROADMAP, _ZIGZAG, Mpeg4Decoder, _Bits, _Ref, _Vop, decode_packets

# the picture sizes of PTYPE's source formats 1..5 (sub-QCIF, QCIF, CIF, 4CIF, 16CIF)
SOURCE_FORMATS = {1: (128, 96), 2: (176, 144), 3: (352, 288), 4: (704, 576), 5: (1408, 1152)}
# the AVI and VFW tags libavformat reads as H.263 and OpenCV writes (`U263` is UB Video's), in either letter case
# (libavformat upper-cases them)
H263_FOURCCS = (b"H263", b"U263")
H263_SAMPLE_ENTRIES = (b"h263", b"s263")  # QuickTime's and 3GPP's
_ANNEXES = ("unrestricted motion vectors (annex D)", "syntax-based arithmetic coding (annex E)",
            "advanced prediction (annex F: OBMC)", "PB-frames (annex G)")


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"H.263: {what} is not decoded by the port ({_ROADMAP})")


class _Picture:
    """What the MPEG-4 machinery reads of a VOL, for an H.263 picture: its
    size and macroblock grid, half-pel motion, H.263 quantisation."""

    quarter_sample = quant_type = loaded_matrices = partitioned = resync = 0

    def __init__(self, width: int, height: int):
        self.width, self.height = width, height
        self.mb_w, self.mb_h = width // 16, height // 16


def picture_header(b: _Bits) -> Tuple[int, int, int, int]:
    """Parse a picture header at the reader's position: (kind 0 I / 1 P,
    PQUANT, width, height)."""
    if b.read(22) != 0x20:
        raise ValueError("corrupt H.263 stream: no picture start code")
    b.read(8)  # TR
    if not b.bit():
        raise ValueError("corrupt H.263 picture header: PTYPE's marker bit missing")
    if b.bit():
        raise ValueError("corrupt H.263 picture header: PTYPE's second bit is not 0")
    b.read(3)  # split screen, document camera, freeze picture release
    source = b.read(3)
    if source == 7:
        raise _unsupported("H.263+ (an extended PTYPE: PLUSPTYPE, source format 7)")
    if source == 6:
        raise _unsupported("a picture of the reserved source format 6")
    if source == 0:
        raise ValueError("corrupt H.263 picture header: source format 0")
    kind = b.bit()
    for annex in _ANNEXES:
        if b.bit():
            raise _unsupported(annex)
    q = b.read(5)
    if q == 0:
        raise ValueError("corrupt H.263 picture header: PQUANT 0")
    if b.bit():
        raise _unsupported("continuous presence multipoint (CPM)")
    while b.bit():  # PEI, PSPARE
        b.read(8)
        if b.left() <= 0:
            raise ValueError("corrupt H.263 picture header: truncated")
    width, height = SOURCE_FORMATS[source]
    return kind, q, width, height


def is_h263_fourcc(tag: bytes) -> bool:
    return tag.upper() in H263_FOURCCS


def check_stream(packets: Iterable[bytes]) -> Tuple[int, int]:
    """Every picture header of a stream parsed (refusals raise here, before
    any frame); the first picture's (width, height)."""
    size = None
    for packet in packets:
        if packet:
            _, _, width, height = picture_header(_Bits(packet))
            size = size or (width, height)
    if size is None:
        raise ValueError("corrupt H.263 stream: no picture")
    return size


class H263Decoder(Mpeg4Decoder):
    """Decode H.263 baseline packets (one picture each) to frames, each the
    (Y, U, V) planes; `decode` returns a packet's frame at once (no delay),
    `flush` nothing. `counts` tallies each decoded case."""

    def decode(self, packet: bytes):
        if not packet:
            return None
        b = _Bits(packet)
        kind, q, width, height = picture_header(b)
        if self.vol is None or (width, height) != (self.vol.width, self.vol.height):
            self.vol = _Picture(width, height)
            self._future = None
        if kind and self._future is None:
            raise ValueError("corrupt H.263 stream: a P picture before any I picture")
        counts = self.counts
        counts[("i_picture", "p_picture")[kind]] += 1
        vop = _Vop(self.vol, kind, q, 99, 1, 1)
        vop.h263 = True
        self._gobs(b, vop)
        if b.pos > b.end:
            raise ValueError("corrupt H.263 picture: truncated")
        planes = self._reconstruct(vop, 0)
        self._future = _Ref(planes, vop.mvx, vop.mvy, vop.four, vop.skipped)
        return self._output(planes)

    def flush(self):
        return None

    def _gobs(self, b: _Bits, vop: _Vop) -> None:
        """The picture's macroblocks, a GOB header read where the 16 bits
        after a macroblock are zeros (libavcodec's slice end)."""
        pic = self.vol
        mb_w, n_mb = pic.mb_w, pic.mb_w * pic.mb_h
        gob_rows = 1 if pic.height <= 400 else 2 if pic.height <= 800 else 4
        for mb in range(n_mb):
            mby, mbx = divmod(mb, mb_w)
            if mb and not b.peek(16):
                if mbx or mby % gob_rows:
                    raise ValueError(f"corrupt H.263 picture: a slice ends inside GOB at macroblock {mb}")
                b.pos += 16
                zeros = 0
                while not b.bit():
                    zeros += 1
                    if zeros > 16 or b.left() <= 0:
                        raise ValueError("corrupt H.263 picture: no GOB start code")
                gn = b.read(5)
                b.read(2)  # GFID
                vop.q = b.read(5)
                if gn * gob_rows != mby or not vop.q:
                    raise ValueError(f"corrupt H.263 picture: GOB {gn} (GQUANT {vop.q}) at macroblock row {mby}")
                vop.start = mb
                self.counts["gob_header"] += 1
            if b.pos >= b.end:
                raise ValueError(f"corrupt H.263 picture: truncated at macroblock {mb} of {n_mb}")
            self._macroblock(b, vop, mb, mbx, mby)

    def _macroblock(self, b: _Bits, vop: _Vop, mb: int, mbx: int, mby: int) -> None:
        cbpc = self._mcbpc(b, vop, mb)
        if cbpc is None:
            self._skip(vop, mb)
            return
        intra = cbpc & 4
        cbp = self._cbpy(b, mb, intra) << 2 | cbpc & 3
        if cbpc & 8:
            self._dquant(b, vop, intra)
        vop.mbq[mb] = vop.q
        if not intra:
            if cbpc & 24 == 24:
                self.counts["inter4v_dquant_mb"] += 1
            self._p_vectors(b, vop, mb, mbx, mby, cbpc & 16)
            for n in range(6):
                if cbp & (32 >> n):
                    vop.coded[mb, n] = True
                    self._h263_tcoef(b, -1, (mb * 6 + n) * 64, vop, None)
            return
        self.counts["intra_mb_in_p" if vop.kind else "intra_mb"] += 1
        vop.mb_kind[mb] = 2
        for n in range(6):
            block = [0] * 64
            dc = b.read(8)
            block[0] = 128 if dc == 255 else dc
            if cbp & (32 >> n):
                self._h263_tcoef(b, 0, 0, vop, block)
            vop.intra_at.append(mb * 6 + n)
            vop.intra_rows.append(block)
        vop.coded[mb] = True

    def _h263_tcoef(self, b: _Bits, i: int, base: int, vop: _Vop, block: Optional[list]) -> None:
        """One block's TCOEF events from zigzag position i + 1: levels into
        block (intra) or the VOP's inter lists at base; the escape is
        LAST (1), RUN (6), LEVEL (8, signed)."""
        words = b.words
        while True:
            p = b.pos
            w = (words[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
            e = _LUT_INTER[w >> 19]
            if e is None:
                raise ValueError("corrupt H.263 picture: bad TCOEF code")
            length, last, run, level = e
            if level:
                p += length
            else:
                last, run, level = (w >> 24) & 1, (w >> 18) & 63, (w >> 10) & 0xFF
                if level >= 128:
                    level -= 256
                if level == -128:
                    raise _unsupported("an escaped TCOEF level of -128 (libavcodec's 11-bit extension)")
                p += 22
                self.counts["escape"] += 1
            b.pos = p
            i += run + 1
            if i > 63:
                raise ValueError("corrupt H.263 picture: more than 64 coefficients in a block")
            if block is not None:
                block[_ZIGZAG[i]] = level
            else:
                vop.idx.append(base + _ZIGZAG[i])
                vop.val.append(level)
            if last:
                return


class H263Track:
    """What a container's H.263 track adds to its reader (`data/avi.py`,
    `data/mkv.py`, `data/mp4.py` mix it in): the size from the first
    picture header once every header is checked (`h263_size`), and the
    decoded frames."""

    def h263_size(self) -> Tuple[int, int]:
        try:
            return check_stream(self.packets())
        except (NotImplementedError, ValueError) as exc:
            raise type(exc)(f"{self.path}: {exc}") from exc

    def read_h263(self, rgb: bool = True) -> Iterator[np.ndarray]:
        """The decoded frames: uint8 (H, W, 3), RGB (BGR with `rgb=False`)."""
        decoder = H263Decoder()
        self.counts = decoder.counts
        yield from decode_packets(decoder, self.packets(), rgb, self.path)
