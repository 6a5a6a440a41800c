"""MPEG-1 (ISO/IEC 11172-2) and MPEG-2 (ISO/IEC 13818-2) video in numpy: progressive frame pictures as OpenCV's FFmpeg backend decodes them.

OpenCV's FFmpeg writer writes MPEG-1 under the fourccs `PIM1` and `mpg1`
and MPEG-2 under `MPEG` and `mpg2` into `.avi`, `.mkv`, `.mp4` and `.mov`
files (libavcodec's `mpeg1video` and `mpeg2video` encoders; a `.mov` under
`MPEG` gets MPEG-1), and reads them back through libavcodec's
`mpeg1video`/`mpeg2video` decoder, which follows the stream: a sequence
header followed by a sequence extension is MPEG-2, one without it MPEG-1.
`Mpeg12Decoder` decodes those streams to the planes that decoder gives,
bit for bit, and so, through `data/mpeg4.py yuv420_to_bgr`, to the frames
OpenCV returns. The tables are `data/mpeg12_tables.py`; the containers
`data/avi.py`, `data/mkv.py` and `data/mp4.py` (`Mpeg12Track`).

Decoded:

  headers     the sequence header with loaded intra and non-intra matrices
              (a loaded intra matrix's first value taken as 8, as libavcodec
              does), the sequence extension (4:2:0), the sequence display
              extension (its matrix_coefficients pick swscale's conversion
              to BGR, `yuv_coeffs`: BT.709, FCC, SMPTE 240M and BT.2020 have
              their own; the primaries and transfer change no pixel), the
              group of pictures header (closed_gop), the picture header (I,
              P and B pictures; MPEG-1's f_codes), the picture coding
              extension (f_codes, intra_dc_precision 8 to 11 bits,
              q_scale_type, intra_vlc_format, alternate_scan,
              concealment_motion_vectors, progressive_frame; top_field_first
              and repeat_first_field are read and change no output, as in
              OpenCV), the quant matrix extension (luma and chroma
              matrices); a sequence header resets the matrices
  slices      slice_vertical_position (and its extension past 2800 lines),
              the quantiser scale (linear, or the non-linear table), the
              extra slice information; MPEG-1 slices across macroblock
              rows; the address increment with MPEG-1's escape and stuffing
  macroblocks the macroblock types of I, P and B pictures, quantiser
              updates, skipped macroblocks (P: a copy at the zero vector,
              the vector predictors reset; B: the previous macroblock's
              directions and vectors), intra DC prediction reset at each
              slice and at every non-intra macroblock, coded block patterns
  blocks      the DC size VLCs, table zero or (MPEG-2 intra under
              intra_vlc_format) table one, MPEG-1's escapes (6 + 8 and
              6 + 16 bits) and MPEG-2's (6 + 12), the zigzag or alternate
              scan; dequantisation as libavcodec does it (MPEG-1's
              oddification, MPEG-2's mismatch control on coefficient 63,
              values kept in 16 bits), libavcodec's simple IDCT
              (`data/mpeg4.py simple_idct`, what its `mpeg1video` and
              `mpeg2video` decoders pick)
  motion      motion_code and its residual, wrapped to the f_code's range,
              the predictors reset at each slice and intra macroblock;
              frame prediction at half-pel with rounding (the chroma vector
              the luma one halved toward zero, in MPEG-1 and MPEG-2 alike,
              as libavcodec derives it); B pictures' forward, backward and
              averaged prediction
  output      display order: I and P pictures held back one picture, B
              pictures at once, the last reference given at the end of the
              stream (OpenCV's drain); B pictures without a past
              reference are dropped in an open GOP (libavcodec skips
              them) and in a closed one predicted from libavcodec's gray
              dummy picture; the planes cropped to the sequence's size

Raising `NotImplementedError` (ROADMAP Queue 1 item 11.2), checked over
every header before any frame (`check_stream`): chroma formats other than
4:2:0, field pictures (`picture_structure` 1 or 2), field prediction and
field DCT (`frame_pred_frame_dct` 0), a picture with `progressive_frame` 0
in a sequence with `progressive_sequence` 0 (OpenCV returns no image for
it: swscale refuses the frame libavcodec marks interlaced; the same flag in
a progressive sequence decodes as a frame, as OpenCV shows), MPEG-1
D-pictures (libavcodec refuses them too) and `full_pel` vectors (no
encoder here writes them), odd heights (swscale converts those through its
scaling path, as `data/mpeg4.py` notes), and the matrix_coefficients 8
(YCgCo) and 10 upward, which swscale converts by other rules. A corrupt or
truncated stream raises `ValueError`; so does a motion vector that points
outside the reference (libavcodec leaves such a block unpredicted).
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from yolo_infer_tpu_torch.data import mpeg4_motion as mc
from yolo_infer_tpu_torch.data import mpeg12_tables as T
from yolo_infer_tpu_torch.data.mpeg4 import BT601, YUV2RGB_COEFFS, _Bits, decode_packets, simple_idct, start_codes

_ROADMAP = "ROADMAP Queue 1 item 11.2"

SEQUENCE, GOP, PICTURE, EXTENSION = 0xB3, 0xB8, 0x00, 0xB5  # the start codes decoding reads (user data it skips)
SLICE_FIRST, SLICE_LAST = 0x01, 0xAF
I_PICTURE, P_PICTURE, B_PICTURE, D_PICTURE = 1, 2, 3, 4

# AVI and VFW codec tags libavformat maps to mpeg1video or mpeg2video (in any letter case: it compares them
# upper-cased) and OpenCV reads as plain streams; not `VCR2` (its chroma planes swapped), `SLIF` (a first slice
# of its own) or `BW10`, which libavcodec decodes otherwise
FOURCCS = (b"PIM1", b"MPG1", b"MPEG", b"MPG2", b"PIM2", b"MPGV", b"MMES", b"DVR ", b"LMP2", b"EM2V", b"M701", b"XMPG",
           b"\x01\x00\x00\x10", b"\x02\x00\x00\x10")
SAMPLE_ENTRIES = (b"m1v ", b"m1v1", b"mpeg", b"m2v1")
CODEC_IDS = ("V_MPEG1", "V_MPEG2")  # Matroska
# the esds objectTypeIndication of MPEG-2 video (simple, main, SNR, spatial, high and 4:2:2 profiles) and MPEG-1
OBJECT_TYPES = (0x60, 0x61, 0x62, 0x63, 0x64, 0x65, 0x6A)

# macroblock types: libavcodec's ptype2mb_type and btype2mb_type, by the index of their VLC
INTRA, QUANT, FORWARD, BACKWARD, PATTERN, ZERO_MV = 1, 2, 4, 8, 16, 32
P_TYPES = (INTRA, PATTERN | ZERO_MV | FORWARD, FORWARD, FORWARD | PATTERN, QUANT | INTRA,
           QUANT | PATTERN | ZERO_MV | FORWARD, QUANT | FORWARD | PATTERN)
B_TYPES = (INTRA, BACKWARD, BACKWARD | PATTERN, FORWARD, FORWARD | PATTERN, FORWARD | BACKWARD,
           FORWARD | BACKWARD | PATTERN, QUANT | INTRA, QUANT | BACKWARD | PATTERN, QUANT | FORWARD | PATTERN,
           QUANT | FORWARD | BACKWARD | PATTERN)
_ESCAPE_RUN, _EOB_RUN = 64, 65  # the run fields of a coefficient table's escape and end-of-block entries


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"MPEG-1/2 video: {what} is not decoded by the port ({_ROADMAP})")


def _lut(codes, bits: int) -> list:
    """A `bits`-wide lookup: entry w is (symbol, length) of the code that prefixes w."""
    table: list = [None] * (1 << bits)
    for sym, (code, length) in enumerate(codes):
        lo = code << (bits - length)
        for w in range(lo, lo + (1 << (bits - length))):
            table[w] = (sym, length)
    return table


def _coefficient_lut(vlc) -> list:
    """17-bit lookup of a DCT coefficient table: (length with the sign bit,
    run, signed level); the escape (length 6) has run `_ESCAPE_RUN`, the end
    of block run `_EOB_RUN`, both level 0."""
    table: list = [None] * (1 << 17)
    for i, (code, length) in enumerate(vlc):
        if i >= T.ESCAPE:
            lo = code << (17 - length)
            entry = (length, _ESCAPE_RUN if i == T.ESCAPE else _EOB_RUN, 0)
            table[lo:lo + (1 << (17 - length))] = [entry] * (1 << (17 - length))
            continue
        for sign in (0, 1):
            lo = (code << 1 | sign) << (16 - length)
            entry = (length + 1, T.RUN[i], -T.LEVEL[i] if sign else T.LEVEL[i])
            table[lo:lo + (1 << (16 - length))] = [entry] * (1 << (16 - length))
    return table


_LUT_INCR = _lut(T.MB_ADDR_INCR, 11)
_LUT_PTYPE = _lut(T.MB_PTYPE, 6)
_LUT_BTYPE = _lut(T.MB_BTYPE, 6)
_LUT_PATTERN = _lut(T.MB_PATTERN, 9)
_LUT_MOTION = _lut(T.MB_MOTION, 10)
_LUT_DC = (_lut(list(zip(T.DC_LUM_CODE, T.DC_LUM_BITS)), 10), _lut(list(zip(T.DC_CHROMA_CODE, T.DC_CHROMA_BITS)), 10))
_LUT_B14 = _coefficient_lut(T.VLC_B14)
_LUT_B15 = _coefficient_lut(T.VLC_B15)
_DEFAULT_INTRA = np.array(T.DEFAULT_INTRA_MATRIX, np.int64)
_DEFAULT_INTER = np.full(64, 16, np.int64)
_ZIGZAG, _ALTERNATE = T.ZIGZAG, T.ALTERNATE_SCAN


def _load_matrix(b: _Bits, intra: bool) -> np.ndarray:
    """64 matrix values in zigzag order (libavcodec's `load_matrix`: a 0 is
    corrupt, an intra matrix's first value is taken as 8)."""
    m = np.empty(64, np.int64)
    for i in range(64):
        v = b.read(8)
        if v == 0:
            raise ValueError("corrupt MPEG-1/2 stream: a quantiser matrix value of 0")
        m[_ZIGZAG[i]] = 8 if intra and i == 0 else v
    return m


class Sequence:
    """A sequence header and its extensions: the picture size, the frame
    rate code, the matrices (luma and chroma, intra and non-intra), and
    whether a sequence extension made it MPEG-2."""

    def __init__(self, data: bytes):
        b = _Bits(data)
        self.width, self.height = b.read(12), b.read(12)
        b.read(4)  # aspect_ratio_information
        self.frame_rate_code = b.read(4)
        b.read(18)  # bit_rate_value
        b.marker("in a sequence header")
        b.read(10)  # vbv_buffer_size_value
        b.bit()  # constrained_parameters_flag
        self.loaded = 0
        if b.bit():
            self.intra = _load_matrix(b, True)
            self.loaded += 1
        else:
            self.intra = _DEFAULT_INTRA
        if b.bit():
            self.inter = _load_matrix(b, False)
            self.loaded += 1
        else:
            self.inter = _DEFAULT_INTER
        if b.pos > b.end:
            raise ValueError("corrupt MPEG-1/2 sequence header: truncated")
        if not (self.width and self.height):
            raise ValueError(f"corrupt MPEG-1/2 sequence header: a picture of {self.width}x{self.height}")
        self.chroma_intra, self.chroma_inter = self.intra, self.inter
        self.mpeg2 = False
        self.progressive = 1
        self.low_delay = 0
        self.rate_extension = (1, 1)  # MPEG-2's frame_rate_extension_n + 1, _d + 1

    def extension(self, b: _Bits) -> None:
        """The sequence extension (after its 4-bit id): MPEG-2."""
        b.read(8)  # profile_and_level_indication
        self.progressive = b.bit()
        chroma = b.read(2)
        if chroma not in (0, 1):  # libavcodec takes 0 (reserved) as 4:2:0
            raise _unsupported(f"chroma format {('4:2:0', '4:2:0', '4:2:2', '4:4:4')[chroma]} (OpenCV converts it "
                               "from another pixel format)")
        self.width |= b.read(2) << 12
        self.height |= b.read(2) << 12
        b.read(12)  # bit_rate_extension
        b.bit()  # marker
        b.read(8)  # vbv_buffer_size_extension
        self.low_delay = b.bit()
        self.rate_extension = (b.read(2) + 1, b.read(5) + 1)
        self.mpeg2 = True

    @property
    def frame_rate(self) -> Tuple[int, int]:
        """libavcodec's frame rate of the stream: the code's, times MPEG-2's extension (0/0 for a forbidden code)."""
        num, den = T.FRAME_RATES[self.frame_rate_code]
        return num * self.rate_extension[0], den * self.rate_extension[1]

    @property
    def mb_w(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_h(self) -> int:
        return (self.height + 15) // 16


class Picture:
    """A picture header and its coding extension: the type, the f_codes,
    and the coding parameters the macroblocks are read with."""

    def __init__(self, data: bytes, mpeg2: bool):
        b = _Bits(data)
        b.read(10)  # temporal_reference
        self.kind = b.read(3)
        if self.kind == D_PICTURE:
            raise _unsupported("an MPEG-1 D-picture (libavcodec refuses it too)")
        if self.kind not in (I_PICTURE, P_PICTURE, B_PICTURE):
            raise ValueError(f"corrupt MPEG-1/2 picture header: picture_coding_type {self.kind}")
        b.read(16)  # vbv_delay
        self.f_code = [[1, 1], [1, 1]]  # [forward, backward][horizontal, vertical]
        for d in range(self.kind - 1):
            full_pel, code = b.bit(), b.read(3)
            if full_pel and not mpeg2:
                raise _unsupported("full_pel motion vectors (no encoder here writes them)")
            self.f_code[d] = [max(code, 1)] * 2
        if b.pos > b.end:
            raise ValueError("corrupt MPEG-1/2 picture header: truncated")
        self.extended = False
        self.dc_precision = self.q_scale_type = self.intra_vlc = self.alternate = self.concealment = 0
        self.progressive_frame, self.top_field_first, self.repeat_first_field = 1, 0, 0

    def coding_extension(self, b: _Bits, sequence: Sequence) -> None:
        """The picture coding extension (after its 4-bit id)."""
        self.f_code = [[max(b.read(4), 1), max(b.read(4), 1)], [max(b.read(4), 1), max(b.read(4), 1)]]
        self.dc_precision = b.read(2)
        structure = b.read(2)
        self.top_field_first = b.bit()
        frame_dct = b.bit()
        self.concealment = b.bit()
        self.q_scale_type = b.bit()
        self.intra_vlc = b.bit()
        self.alternate = b.bit()
        self.repeat_first_field = b.bit()
        b.bit()  # chroma_420_type
        self.progressive_frame = b.bit()
        if structure != 3:
            raise _unsupported(f"a field picture (picture_structure {structure}: interlaced video)")
        if not frame_dct:
            raise _unsupported("field prediction and field DCT (frame_pred_frame_dct 0: interlaced video)")
        if not self.progressive_frame and not sequence.progressive:
            raise _unsupported("an interlaced frame (progressive_frame 0 in a sequence with progressive_sequence 0: "
                               "OpenCV's FFmpeg backend returns no image for it, swscale refuses the frame)")
        self.extended = True


class Mpeg12Decoder:
    """Decode MPEG-1 or MPEG-2 packets (one picture each, with any headers
    before it) to frames in display order, each the (Y, U, V) planes
    cropped to the picture (`yuv420_to_bgr` converts them as swscale
    does): `decode` returns the frame a packet completes, if any, and
    `flush` the picture held back at the end of the stream. `config` is the
    container's decoder configuration (a sequence header), decoded first.
    `counts` tallies each decoded case (the tests read it)."""

    def __init__(self, config: bytes = b""):
        self.sequence: Optional[Sequence] = None
        self.counts: Counter = Counter()
        self.yuv_coeffs = BT601  # swscale's conversion of the matrix_coefficients a sequence display extension names
        self._past = self._future = None  # the reference pictures' macroblock-aligned (Y, U, V) planes
        self._held = False
        self._closed_gop = 0
        if config:
            self.decode(config)

    # ------------------------------------------------------------ headers

    def _header(self, code: int, data: bytes, picture: Optional[Picture]) -> Optional[Picture]:
        """One header unit; the picture being read (a new one at a picture header)."""
        counts = self.counts
        if code == SEQUENCE:
            seq = Sequence(data)
            if seq.height % 2:
                raise _unsupported(f"an odd height ({seq.height}: swscale scales it)")
            old = self.sequence
            if old is None or (old.width, old.height) != (seq.width, seq.height):
                self._past = self._future = None
                self._held = False
            self.sequence = seq
            counts["sequence_header"] += 1
            if seq.loaded:
                counts["loaded_matrix_sequence"] += 1
            return picture
        if code == EXTENSION:
            b = _Bits(data)
            kind = b.read(4)
            seq = self.sequence
            if kind == 1 and seq is not None and picture is None:
                seq.extension(b)
                if seq.height % 2:
                    raise _unsupported(f"an odd height ({seq.height}: swscale scales it)")
            elif kind == 2 and seq is not None:  # sequence display: video format, colour, display size
                b.read(3)
                if b.bit():
                    b.read(16)  # colour_primaries, transfer_characteristics: no pixel of OpenCV's changes
                    matrix = b.read(8)
                    if matrix == 8 or matrix >= 10:
                        raise _unsupported(f"matrix_coefficients {matrix} (swscale converts it otherwise)")
                    self.yuv_coeffs = YUV2RGB_COEFFS.get(matrix, BT601)  # libavcodec keeps it for later frames
                    counts[f"matrix_coefficients_{matrix}"] += 1
                counts["sequence_display_extension"] += 1
            elif kind == 3 and seq is not None:  # quant matrix extension
                if b.bit():
                    seq.intra = seq.chroma_intra = _load_matrix(b, True)
                if b.bit():
                    seq.inter = seq.chroma_inter = _load_matrix(b, False)
                if b.bit():
                    seq.chroma_intra = _load_matrix(b, True)
                if b.bit():
                    seq.chroma_inter = _load_matrix(b, False)
                counts["quant_matrix_extension"] += 1
            elif kind == 8 and picture is not None and seq is not None:
                picture.coding_extension(b, seq)
            if b.pos > b.end:
                raise ValueError("corrupt MPEG-1/2 stream: a truncated extension")
            return picture
        if code == GOP:
            b = _Bits(data)
            b.read(25)  # time_code
            self._closed_gop = b.bit()
            counts["gop_header"] += 1
            return picture
        if code == PICTURE:
            if self.sequence is None:
                raise ValueError("corrupt MPEG-1/2 stream: a picture before any sequence header")
            return Picture(data, self.sequence.mpeg2)
        return picture

    def check(self, data: bytes) -> None:
        """Every header of a packet parsed (refusals raise here)."""
        picture = None
        for code, start, stop in start_codes(data):
            if SLICE_FIRST <= code <= SLICE_LAST:
                continue
            if code == PICTURE and picture is not None:
                break
            picture = self._header(code, data[start:stop], picture)

    # ------------------------------------------------------------ pictures

    def decode(self, packet: bytes):
        """Parse one packet; the planes of the frame it completes, if any.
        As libavcodec, only a packet's first picture is decoded."""
        picture, slices = None, []
        for code, start, stop in start_codes(packet):
            if SLICE_FIRST <= code <= SLICE_LAST:
                if picture is not None:
                    slices.append((code, packet[start:stop]))
                continue
            if code == PICTURE and picture is not None:
                self.counts["extra_picture"] += 1
                break
            picture = self._header(code, packet[start:stop], picture)
        if picture is None:
            return None
        if not slices:
            raise ValueError("corrupt MPEG-1/2 stream: a picture without slices")
        return self._picture(picture, slices)

    def flush(self):
        """The reference held back for display order, at the end of the stream."""
        if not self._held:
            return None
        self._held = False
        return self._output(self._future)

    def _output(self, planes):
        y, u, v = planes
        h, w = self.sequence.height, self.sequence.width
        return y[:h, :w], u[:h // 2, :(w + 1) // 2], v[:h // 2, :(w + 1) // 2]

    def _picture(self, pic: Picture, slices):
        seq, counts = self.sequence, self.counts
        if seq.mpeg2 and not pic.extended:
            raise ValueError("corrupt MPEG-2 stream: a picture without a picture coding extension")
        if pic.kind != I_PICTURE and self._future is None:
            raise ValueError("corrupt MPEG-1/2 stream: a P or B picture before any I picture")
        past = self._past
        if pic.kind == B_PICTURE and past is None:
            if not self._closed_gop:
                counts["b_picture_dropped"] += 1  # an open GOP's B picture without its past reference: skipped
                return None
            past = self._gray()  # libavcodec's dummy reference
            counts["b_picture_gray_past"] += 1
        counts[("", "i_picture", "p_picture", "b_picture")[pic.kind]] += 1
        counts["mpeg2_picture" if seq.mpeg2 else "mpeg1_picture"] += 1
        if seq.mpeg2:
            counts[f"dc_precision_{8 + pic.dc_precision}"] += 1
            for flag in ("q_scale_type", "intra_vlc", "alternate", "concealment", "repeat_first_field",
                         "top_field_first"):
                if getattr(pic, flag):
                    counts[f"{flag}_picture"] += 1
            if not pic.progressive_frame:
                counts["progressive_frame_0"] += 1
        if pic.kind != I_PICTURE:
            counts[f"f_code_{pic.f_code[0][0]}"] += 1
        state = _State(seq, pic)
        for code, data in slices:
            self._slice(state, code, data)
        if not all(state.done):
            raise ValueError(f"corrupt MPEG-1/2 picture: {state.done.count(0)} macroblocks in no slice")
        refs = (self._future, None) if pic.kind == P_PICTURE else (past, self._future)
        planes = self._reconstruct(state, refs)
        if pic.kind == B_PICTURE:
            return self._output(planes)
        shown = self._held
        self._past, self._future = self._future, planes
        if seq.low_delay:
            self._held = False
            return self._output(planes)
        self._held = True
        return self._output(self._past) if shown else None

    def _gray(self):
        seq = self.sequence
        h, w = 16 * seq.mb_h, 16 * seq.mb_w
        return np.full((h, w), 128, np.uint8), np.full((h // 2, w // 2), 128, np.uint8), \
            np.full((h // 2, w // 2), 128, np.uint8)

    # ------------------------------------------------------------ slices

    def _qscale(self, code: int, pic: Picture) -> int:
        return T.NON_LINEAR_QSCALE[code] if pic.q_scale_type else code << 1

    def _slice(self, st: "_State", code: int, data: bytes) -> None:
        """One slice: its header, then macroblocks until the eight zeros of
        the address increment that ends it (or the picture's last one)."""
        seq, pic, counts = st.seq, st.pic, self.counts
        b = _Bits(data)
        mb_w, mb_h = seq.mb_w, seq.mb_h
        mb_y = code - 1
        if seq.mpeg2 and mb_h > 2800 // 16:
            mb_y += b.read(3) << 7
        if mb_y >= mb_h:
            raise ValueError(f"corrupt MPEG-1/2 picture: a slice at macroblock row {mb_y} of {mb_h}")
        qcode = b.read(5)
        if not qcode:
            raise ValueError("corrupt MPEG-1/2 slice: quantiser_scale_code 0")
        st.q = self._qscale(qcode, pic)
        while b.bit():  # extra_bit_slice, extra_information_slice (and MPEG-2's intra_slice fields)
            b.read(8)
            if b.left() <= 0:
                raise ValueError("corrupt MPEG-1/2 slice: truncated header")
        mb_x = 0
        while True:
            incr = self._increment(b)
            if incr == 33:
                mb_x += 33
            elif incr < 33:
                mb_x += incr
                break
            elif b.left() <= 0:
                raise ValueError("corrupt MPEG-1/2 slice: no first macroblock")
        if mb_x >= mb_w:
            raise ValueError(f"corrupt MPEG-1/2 slice: a first macroblock at column {mb_x} of {mb_w}")
        counts["slice"] += 1
        st.dc = [128 << pic.dc_precision] * 3
        st.pmv = [[0, 0], [0, 0]]
        st.prev_intra = False
        skip = 0
        mb = mb_y * mb_w + mb_x
        n_mb = mb_w * mb_h
        while True:
            if st.done[mb]:
                raise ValueError(f"corrupt MPEG-1/2 picture: macroblock {mb} in two slices")
            if skip:
                self._skipped(st, mb)
                skip -= 1
            else:
                if b.pos >= b.end:
                    raise ValueError(f"corrupt MPEG-1/2 slice: truncated at macroblock {mb}")
                self._macroblock(b, st, mb)
                skip = -1
            mb += 1
            if mb >= n_mb:
                if b.pos > b.end or (b.left() and b.peek(min(b.left(), 23))):
                    raise ValueError("corrupt MPEG-1/2 picture: data past its last macroblock")
                return
            if skip == -1:
                skip = 0
                while True:
                    incr = self._increment(b)
                    if incr == 35:  # eight zeros: the end of the slice
                        if skip or b.peek(15):
                            raise ValueError("corrupt MPEG-1/2 slice: it ends inside a skip run")
                        return
                    if incr == 34:  # macroblock_stuffing
                        counts["mb_stuffing"] += 1
                        continue
                    skip += incr
                    if incr < 33:
                        break
                    counts["mb_escape"] += 1
                if skip:
                    if pic.kind == I_PICTURE:
                        raise ValueError("corrupt MPEG-1/2 picture: a skipped macroblock in an I picture")
                    st.dc = [128 << pic.dc_precision] * 3
                    if pic.kind == P_PICTURE:
                        st.pmv[0] = [0, 0]
                    elif st.prev_intra:
                        raise ValueError("corrupt MPEG-1/2 picture: a skipped macroblock after an intra one in a B "
                                         "picture")

    @staticmethod
    def _increment(b: _Bits) -> int:
        hit = _LUT_INCR[b.peek(11)]
        if hit is None:
            raise ValueError("corrupt MPEG-1/2 slice: bad macroblock_address_increment")
        b.pos += hit[1]
        return hit[0]

    def _skipped(self, st: "_State", mb: int) -> None:
        """A skipped macroblock: P, a copy at the zero vector; B, the last
        coded macroblock's directions at the vector predictors."""
        st.done[mb] = 1
        if st.pic.kind == P_PICTURE:
            st.dirs[mb] = 1
            self.counts["skipped_mb_p"] += 1
        else:
            st.dirs[mb] = st.last_dirs
            st.vec[mb] = st.pmv[0] + st.pmv[1]
            self.counts["skipped_mb_b"] += 1

    def _motion(self, b: _Bits, f_code: int, pred: int) -> int:
        """One vector component: motion_code, its residual, wrapped to the f_code's range."""
        hit = _LUT_MOTION[b.peek(10)]
        if hit is None:
            raise ValueError("corrupt MPEG-1/2 macroblock: bad motion_code")
        b.pos += hit[1]
        code = hit[0]
        if not code:
            return pred
        sign = b.bit()
        shift = f_code - 1
        if shift:
            code = ((code - 1) << shift | b.read(shift)) + 1
        pred += -code if sign else code
        half = 16 << shift
        return (pred + half) % (2 * half) - half

    def _macroblock(self, b: _Bits, st: "_State", mb: int) -> None:
        pic, counts = st.pic, self.counts
        kind = pic.kind
        if kind == I_PICTURE:
            if b.bit():
                t = INTRA
            elif b.bit():
                t = INTRA | QUANT
            else:
                raise ValueError(f"corrupt MPEG-1/2 picture: bad macroblock_type at macroblock {mb}")
        else:
            hit = (_LUT_PTYPE if kind == P_PICTURE else _LUT_BTYPE)[b.peek(6)]
            if hit is None:
                raise ValueError(f"corrupt MPEG-1/2 picture: bad macroblock_type at macroblock {mb}")
            b.pos += hit[1]
            t = (P_TYPES if kind == P_PICTURE else B_TYPES)[hit[0]]
        if t & QUANT:
            st.q = self._qscale(b.read(5), pic)
            counts["quant_mb"] += 1
        st.done[mb] = 1
        st.q_of[mb] = st.q
        if t & INTRA:
            st.intra[mb] = 1
            counts["intra_mb" if kind == I_PICTURE else "intra_mb_in_pb"] += 1
            if pic.concealment:
                st.pmv[0][0] = self._motion(b, pic.f_code[0][0], st.pmv[0][0])
                st.pmv[0][1] = self._motion(b, pic.f_code[0][1], st.pmv[0][1])
                b.bit()  # marker (libavcodec only warns)
                counts["concealment_vector"] += 1
            else:
                st.pmv = [[0, 0], [0, 0]]
            st.prev_intra = True
            self._intra_blocks(b, st, mb)
            return
        st.prev_intra = False
        if t & ZERO_MV:
            st.pmv[0] = [0, 0]
            dirs = 1
            counts["no_mc_mb"] += 1
        else:
            dirs = (t >> 2) & 3
            for d in range(2):
                if dirs >> d & 1:
                    st.pmv[d] = [self._motion(b, pic.f_code[d][0], st.pmv[d][0]),
                                 self._motion(b, pic.f_code[d][1], st.pmv[d][1])]
            counts[("", "forward_mb", "backward_mb", "bidirectional_mb")[dirs]] += 1
        st.dirs[mb] = st.last_dirs = dirs
        st.vec[mb] = st.pmv[0] + st.pmv[1]
        st.dc = [128 << pic.dc_precision] * 3
        if t & PATTERN:
            hit = _LUT_PATTERN[b.peek(9)]
            if hit is None or not hit[0]:
                raise ValueError(f"corrupt MPEG-1/2 macroblock: bad coded_block_pattern at macroblock {mb}")
            b.pos += hit[1]
            self._inter_blocks(b, st, mb, hit[0])
        else:
            counts["not_coded_mb"] += 1

    # ------------------------------------------------------------ blocks

    def _intra_blocks(self, b: _Bits, st: "_State", mb: int) -> None:
        """An intra macroblock's six blocks: the DC difference added to its
        component's predictor, then the AC coefficients."""
        pic = st.pic
        lut = _LUT_B15 if pic.intra_vlc else _LUT_B14
        dc = st.dc
        words = b.words
        for n in range(6):
            c = 0 if n < 4 else n - 3
            p = b.pos
            hit = _LUT_DC[c > 0][(words[p >> 3] >> (30 - (p & 7))) & 0x3FF]
            if hit is None:
                raise ValueError(f"corrupt MPEG-1/2 macroblock: bad dct_dc_size at macroblock {mb}")
            size = hit[0]
            b.pos = p + hit[1]
            if size:
                diff = b.read(size)
                if not diff >> (size - 1):
                    diff -= (1 << size) - 1
                dc[c] += diff
            st.dc_at.append(mb * 6 + n)
            st.dc_val.append(dc[c])
            self._coefficients(b, st, lut, 0, (mb * 6 + n) * 64)
        if b.pos > b.end:
            raise ValueError(f"corrupt MPEG-1/2 macroblock: truncated at macroblock {mb}")

    def _inter_blocks(self, b: _Bits, st: "_State", mb: int, cbp: int) -> None:
        coded = st.coded
        for n in range(6):
            if cbp & (32 >> n):
                coded[mb * 6 + n] = 1
                base = (mb * 6 + n) * 64
                if b.peek(1):  # the first coefficient's own code: "1s", run 0, level 1
                    level = -1 if b.peek(2) & 1 else 1
                    b.pos += 2
                    st.idx.append(base)
                    st.val.append(level)
                    self._coefficients(b, st, _LUT_B14, 0, base)
                else:
                    self._coefficients(b, st, _LUT_B14, -1, base)
        if b.pos > b.end:
            raise ValueError(f"corrupt MPEG-1/2 macroblock: truncated at macroblock {mb}")

    def _coefficients(self, b: _Bits, st: "_State", lut, i: int, base: int) -> None:
        """A block's coefficients after scan position i, to its end of block:
        (flat index, level) pairs into the picture's lists."""
        words, scan, idx, val = b.words, st.scan, st.idx, st.val
        mpeg2 = st.seq.mpeg2
        p = b.pos
        while True:
            e = lut[(words[p >> 3] >> (23 - (p & 7))) & 0x1FFFF]
            if e is None:
                raise ValueError("corrupt MPEG-1/2 block: bad DCT coefficient code")
            length, run, level = e
            if not level:
                if run == _EOB_RUN:
                    b.pos = p + length
                    return
                p += 6  # the escape: run (6 bits), then the level
                w = (words[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
                run = w >> 26
                if mpeg2:
                    level = (w >> 14) & 0xFFF
                    if level >= 2048:
                        level -= 4096
                    p += 18
                    self.counts["escape_12"] += 1
                else:
                    level = (w >> 18) & 0xFF
                    p += 14
                    if level == 128:  # -128: a further 8 bits, minus 256
                        level = ((w >> 10) & 0xFF) - 256
                        p += 8
                        self.counts["escape_16"] += 1
                    elif level == 0:  # a further 8 bits
                        level = (w >> 10) & 0xFF
                        p += 8
                        self.counts["escape_16"] += 1
                    else:
                        if level > 128:
                            level -= 256
                        self.counts["escape_8"] += 1
            else:
                p += length
            i += run + 1
            if i > 63:
                raise ValueError("corrupt MPEG-1/2 block: more than 64 coefficients")
            idx.append(base + scan[i])
            val.append(level)

    # ------------------------------------------------------------ reconstruction

    def _reconstruct(self, st: "_State", refs):
        """The picture's planes: every coefficient dequantised at once,
        every block through the IDCT, every macroblock's prediction in a
        few gathers."""
        seq, pic = st.seq, st.pic
        mb_w, mb_h = seq.mb_w, seq.mb_h
        n_mb = mb_w * mb_h
        intra = np.frombuffer(bytes(st.intra), np.uint8).astype(bool)
        q = np.asarray(st.q_of, np.int64)
        levels = np.zeros(n_mb * 384, np.int64)
        if st.idx:
            at = np.asarray(st.idx, np.int64)
            lv = np.asarray(st.val, np.int64)
            mb, pos = at // 384, at & 63
            chroma = (at // 64) % 6 >= 4
            is_intra = intra[mb]
            w = np.where(is_intra, np.where(chroma, seq.chroma_intra[pos], seq.intra[pos]),
                         np.where(chroma, seq.chroma_inter[pos], seq.inter[pos]))
            mag = np.abs(lv)
            qs = q[mb]
            mag = np.where(is_intra, (mag * qs * w) >> 4, ((2 * mag + 1) * qs * w) >> 5)
            if not seq.mpeg2:
                mag = (mag - 1) | 1  # MPEG-1's oddification
            levels[at] = np.where(lv < 0, -mag, mag)
        if st.dc_at:
            dc = np.asarray(st.dc_val, np.int64)
            levels[np.asarray(st.dc_at, np.int64) * 64] = dc * 8 if not seq.mpeg2 else dc << (3 - pic.dc_precision)
        blocks = levels.reshape(n_mb, 6, 64)
        coded = np.frombuffer(bytes(st.coded), np.uint8).reshape(n_mb, 6).astype(bool)
        coded |= intra[:, None]
        if seq.mpeg2:  # mismatch control: an even sum toggles the last coefficient's lowest bit
            toggle = coded & ((blocks.sum(-1) & 1) == 0)
            blocks[..., 63] ^= toggle
            self.counts["mismatch_toggle"] += int(toggle.sum())
        res = np.zeros((n_mb, 6, 8, 8), np.int32)
        work = np.nonzero(coded.any(1))[0]
        if work.size:
            res[work] = simple_idct(blocks[work].reshape(-1, 6, 8, 8))
        pred_y = np.zeros((n_mb, 16, 16), np.int32)
        pred_c = np.zeros((n_mb, 2, 8, 8), np.int32)
        dirs = np.frombuffer(bytes(st.dirs), np.uint8)
        vec = np.asarray(st.vec, np.int64).reshape(n_mb, 4)
        count = np.zeros(n_mb, np.int32)
        for d, ref in enumerate(refs):
            sel = np.nonzero((dirs >> d) & 1)[0]
            if not sel.size:
                continue
            py, pc = self._predict(ref, sel, vec[sel, 2 * d], vec[sel, 2 * d + 1])
            pred_y[sel] += py
            pred_c[sel] += pc
            count[sel] += 1
        both = count == 2  # B pictures' averaged prediction: the rounded mean of the two
        pred_y[both] = (pred_y[both] + 1) >> 1
        pred_c[both] = (pred_c[both] + 1) >> 1
        luma = res[:, :4].reshape(n_mb, 2, 2, 8, 8).transpose(0, 1, 3, 2, 4).reshape(n_mb, 16, 16)
        y = np.clip(pred_y + luma, 0, 255).astype(np.uint8)
        c = np.clip(pred_c + res[:, 4:], 0, 255).astype(np.uint8)
        y = y.reshape(mb_h, mb_w, 16, 16).transpose(0, 2, 1, 3).reshape(16 * mb_h, 16 * mb_w)
        u = c[:, 0].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3).reshape(8 * mb_h, 8 * mb_w)
        v = c[:, 1].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3).reshape(8 * mb_h, 8 * mb_w)
        return y, u, v

    def _predict(self, planes, sel: np.ndarray, mx: np.ndarray, my: np.ndarray):
        """(n, 16, 16) luma and (n, 2, 8, 8) chroma half-pel predictions of
        the macroblocks `sel` at vectors (mx, my) in half samples."""
        seq = self.sequence
        mb_w = seq.mb_w
        mbx, mby = sel % mb_w, sel // mb_w
        sx, sy = 16 * mbx + (mx >> 1), 16 * mby + (my >> 1)
        if ((sx < 0) | (sy < 0) | (sx + 16 + (mx & 1) > 16 * mb_w) | (sy + 16 + (my & 1) > 16 * seq.mb_h)).any():
            raise ValueError("corrupt MPEG-1/2 picture: a motion vector points outside the reference picture")
        py = mc.halfpel(planes[0], sx, sy, mx & 1, my & 1, 16, 0)
        cx = np.where(mx < 0, -((-mx) >> 1), mx >> 1)  # the luma vector halved toward zero
        cy = np.where(my < 0, -((-my) >> 1), my >> 1)
        pc = np.empty((len(sel), 2, 8, 8), np.int32)
        for k in (1, 2):
            pc[:, k - 1] = mc.halfpel(planes[k], 8 * mbx + (cx >> 1), 8 * mby + (cy >> 1), cx & 1, cy & 1, 8, 0)
        return py, pc


class _State:
    """One picture's parse: each macroblock's kind, quantiser, directions
    and vectors, the coefficients, and the predictors it is read with."""

    def __init__(self, seq: Sequence, pic: Picture):
        n_mb = seq.mb_w * seq.mb_h
        self.seq, self.pic = seq, pic
        self.scan = _ALTERNATE if pic.alternate else _ZIGZAG
        self.done = bytearray(n_mb)
        self.intra = bytearray(n_mb)
        self.dirs = bytearray(n_mb)  # 1 forward, 2 backward, 3 both
        self.vec: List[List[int]] = [[0, 0, 0, 0]] * n_mb  # forward x, y, backward x, y in half samples
        self.q_of = [0] * n_mb
        self.coded = bytearray(6 * n_mb)
        self.idx: List[int] = []
        self.val: List[int] = []
        self.dc_at: List[int] = []
        self.dc_val: List[int] = []
        self.q = 0
        self.dc = [128, 128, 128]
        self.pmv = [[0, 0], [0, 0]]
        self.last_dirs = 1
        self.prev_intra = False


def check_stream(packets: Iterable[bytes], config: bytes = b"") -> Sequence:
    """Every header of a stream parsed (refusals raise here, before any
    frame); the first sequence header, with its extension."""
    decoder = Mpeg12Decoder()
    first = None
    for data in ([config] if config else []) + list(packets):
        decoder.check(data)
        first = first or decoder.sequence
    if first is None:
        raise ValueError("corrupt MPEG-1/2 stream: no sequence header")
    return first


def is_fourcc(tag: bytes) -> bool:
    """An AVI or VFW codec tag libavformat reads as MPEG-1 or MPEG-2 video, in any letter case."""
    return tag.upper() in FOURCCS


class Mpeg12Track:
    """What a container's MPEG-1 or MPEG-2 track adds to its reader
    (`data/avi.py`, `data/mkv.py`, `data/mp4.py` mix it in): the size and
    the frame rate (`frame_rate`, a fraction) from the first sequence
    header once every header is checked (`open_mpeg12`), and the decoded
    frames."""

    frame_rate = (0, 0)

    def open_mpeg12(self) -> None:
        try:
            sequence = check_stream(self.packets(), self.config)
        except (NotImplementedError, ValueError) as exc:
            raise type(exc)(f"{self.path}: {exc}") from exc
        self.width, self.height = sequence.width, sequence.height
        self.frame_rate = sequence.frame_rate

    def read_mpeg12(self, rgb: bool = True) -> Iterator[np.ndarray]:
        """The decoded frames: uint8 (H, W, 3), RGB (BGR with `rgb=False`)."""
        decoder = Mpeg12Decoder(self.config)
        self.counts = decoder.counts
        yield from decode_packets(decoder, self.packets(), rgb, self.path)
