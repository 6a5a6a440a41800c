"""Matroska and WebM video without OpenCV: a demuxer for MPEG-4 Part 2, MS-MPEG-4, WMV, MPEG-1/2, H.263, VP8 and VP9 tracks and an MPEG-4 muxer.

`MkvReader` walks a Matroska file's EBML elements: the EBML header (whose
DocType must be `matroska` or `webm`), the Segment's Info (TimestampScale,
Duration), its Tracks and its Clusters. It takes the first video
TrackEntry (TrackType 1), which must be MPEG-4 Part 2, Microsoft's
MPEG-4 family, MPEG-1, MPEG-2, H.263, VP8, VP9 or AV1: a CodecID of
`V_MPEG4/ISO/SP`, `V_MPEG4/ISO/ASP` or `V_MPEG4/ISO/AP`, whose
CodecPrivate is the decoder configuration (the video object layer header), `V_MPEG4/MS/V3` (DivX ;-)
as OpenCV's `DIV3` writer writes it, `data/msmpeg4.py`),
`V_MS/VFW/FOURCC`, whose CodecPrivate is a BITMAPINFOHEADER with an
MPEG-4 fourcc (`data/mpeg4.py MPEG4_FOURCCS`) or an MS-MPEG-4 or WMV one
(`data/msmpeg4.py FOURCCS`: OpenCV writes `MP42`, `WMV1` and `WMV2` so),
an MPEG-1/2 one (`data/mpeg12.py FOURCCS`) or H.263's `H263` and `U263`
(as OpenCV's writer puts them in a `.mkv`; `data/h263.py`, the size from
the first picture header) and the configuration after it (WMV2's
extension header), `V_MPEG1` or `V_MPEG2` (`data/mpeg12.py`, the
CodecPrivate its sequence header; the size from the first sequence
header once every header is read), `V_VP8`
(`data/vp8.py`) or `V_VP9` (`data/vp9.py`, profile 0 as OpenCV's `VP90`
writer writes it; every frame's headers are read first). The first key
frame gives a VP8 or VP9 track's size, the track's PixelWidth and
PixelHeight an MS-MPEG-4 one's. An AV1 track (`V_AV1`) is read as the JAX
package reads it through OpenCV, whose bundled libavcodec has no AV1
decoder it can run (its native `av1` decoder needs a hardware one): the
track's size, rate and count, and no frame. Its
SimpleBlocks, and the Blocks of its BlockGroups, are the packets for the
decoder, in file order: an MPEG-4 track with B-VOPs (Advanced Simple
Profile, as libavformat's muxer writes it) has them in decoding order, its
timestamps out of order, and the decoder gives display order.

`fps` and `frame_count` are what OpenCV reports for the same file: the
average frame rate libavformat derives from DefaultDuration (10^9 /
DefaultDuration reduced to terms of at most 30000, `av_reduce`), and, as a
Matroska file counts no frames, the Segment's duration times that rate,
rounded. Without a DefaultDuration the rate is the blocks' count over their
time span.

Other codecs (H.264, ...), MS-MPEG-4 v1, laced blocks and elements of
unknown size raise `NotImplementedError` naming what was found (ROADMAP
Queue 1 item 11.2), before any frame is read; a malformed or truncated
file raises `ValueError`.

`MkvWriter` writes `Mpeg4Encoder`'s I-VOPs into Matroska (CodecID
`V_MPEG4/ISO/ASP`, the headers as CodecPrivate), as OpenCV's FFmpeg
writer lays out its `.mkv` files, through `MatroskaWriter`, which muxes
compressed frames of any codec into one video track (the fixtures put
VP8 and VP9 frames into WebM with it).
"""

from __future__ import annotations

import math
import os
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union


import numpy as np

from yolo_infer_tpu_torch.data import mpeg12
from yolo_infer_tpu_torch.data.avi import fps_ratio
from yolo_infer_tpu_torch.data.h263 import H263Track, is_h263_fourcc
from yolo_infer_tpu_torch.data.mpeg4 import MPEG4_FOURCCS, Mpeg4Encoder, Mpeg4Track
from yolo_infer_tpu_torch.data.mpeg12 import Mpeg12Track
from yolo_infer_tpu_torch.data.msmpeg4 import V3, MsMpeg4Track, is_fourcc
from yolo_infer_tpu_torch.data.vp8 import Vp8Track
from yolo_infer_tpu_torch.data.vp9 import Vp9Track

_ROADMAP = "ROADMAP Queue 1 item 11.2"
MPEG4_CODEC_IDS = ("V_MPEG4/ISO/SP", "V_MPEG4/ISO/ASP", "V_MPEG4/ISO/AP")
VP8_CODEC_ID = "V_VP8"
VP9_CODEC_ID = "V_VP9"
MSMPEG4V3_CODEC_ID = "V_MPEG4/MS/V3"
AV1_CODEC_ID = "V_AV1"
_VP_TRACKS = {VP8_CODEC_ID: Vp8Track, VP9_CODEC_ID: Vp9Track}

EBML, DOCTYPE = 0x1A45DFA3, 0x4282
SEGMENT, INFO, TRACKS, CLUSTER = 0x18538067, 0x1549A966, 0x1654AE6B, 0x1F43B675
TIMESTAMP_SCALE, DURATION = 0x2AD7B1, 0x4489
TRACK_ENTRY, TRACK_NUMBER, TRACK_TYPE, CODEC_ID, CODEC_PRIVATE = 0xAE, 0xD7, 0x83, 0x86, 0x63A2
DEFAULT_DURATION = 0x23E383
CLUSTER_TIMESTAMP, SIMPLE_BLOCK, BLOCK_GROUP, BLOCK = 0xE7, 0xA3, 0xA0, 0xA1
VIDEO, PIXEL_WIDTH, PIXEL_HEIGHT, TRACK_UID, MUXING_APP, WRITING_APP = 0xE0, 0xB0, 0xBA, 0x73C5, 0x4D80, 0x5741


def av_reduce(num: int, den: int, limit: int) -> Tuple[int, int]:
    """libavutil's `av_reduce`: the nearest fraction to num/den whose terms
    are at most `limit` (continued fractions, as libavformat computes rates)."""
    g = math.gcd(num, den)
    if g:
        num, den = num // g, den // g
    a0n, a0d, a1n, a1d = 0, 1, 1, 0
    if num <= limit and den <= limit:
        return num, den
    while den:
        x = num // den
        nxt = num - den * x
        a2n, a2d = x * a1n + a0n, x * a1d + a0d
        if a2n > limit or a2d > limit:
            if a1n:
                x = (limit - a0n) // a1n
            if a1d:
                x = min(x, (limit - a0d) // a1d)
            if den * (2 * x * a1d + a0d) > num * a1d:
                a1n, a1d = x * a1n + a0n, x * a1d + a0d
            break
        a0n, a0d, a1n, a1d = a1n, a1d, a2n, a2d
        num, den = den, nxt
    return a1n, a1d


class _File:
    """EBML element headers read from a file by seeking."""

    def __init__(self, f, size: int, path: Path):
        self.f, self.size, self.path = f, size, path

    def _vint(self, pos: int, keep_marker: bool) -> Tuple[int, int, bool]:
        self.f.seek(pos)
        head = self.f.read(8)
        if not head or head[0] == 0:
            raise ValueError(f"corrupt Matroska {self.path}: a bad element header at {pos}")
        n = 9 - head[0].bit_length()
        if len(head) < n:
            raise ValueError(f"corrupt Matroska {self.path}: truncated at {pos}")
        value = int.from_bytes(head[:n], "big")
        unknown = value == (1 << (7 * n)) - 1 + (1 << (7 * n))  # all value bits set
        return (value if keep_marker else value & ((1 << (7 * n)) - 1)), pos + n, unknown

    def elements(self, pos: int, end: int) -> Iterator[Tuple[int, int, int]]:
        """(id, body start, body end) of each element in [pos, end)."""
        while pos < end:
            eid, at, _ = self._vint(pos, True)
            size, body, unknown = self._vint(at, False)
            if unknown:
                raise NotImplementedError(f"{self.path}: a Matroska element (0x{eid:X}) of unknown size (a live "
                                          f"stream); the port reads sized elements only ({_ROADMAP})")
            if body + size > end:
                raise ValueError(f"corrupt Matroska {self.path}: element 0x{eid:X} runs past its parent "
                                 "(a truncated file?)")
            yield eid, body, body + size
            pos = body + size

    def read(self, start: int, end: int) -> bytes:
        self.f.seek(start)
        data = self.f.read(end - start)
        if len(data) != end - start:
            raise ValueError(f"corrupt Matroska {self.path}: truncated")
        return data

    def uint(self, start: int, end: int) -> int:
        return int.from_bytes(self.read(start, end), "big")

    def float(self, start: int, end: int) -> float:
        data = self.read(start, end)
        return struct.unpack(">f" if len(data) == 4 else ">d", data)[0] if data else 0.0


class MkvReader(Mpeg4Track, MsMpeg4Track, Mpeg12Track, H263Track):
    """The first video track of a Matroska or WebM file: `width`, `height`,
    `fps`, `frame_count`, `info()`, the blocks' frames (`packets()`) and the
    decoded frames (`read()`)."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        try:
            with open(self.path, "rb") as f:
                self._scan(_File(f, os.fstat(f.fileno()).st_size, self.path))
        except OSError as exc:
            raise FileNotFoundError(f"could not open video: {path}") from exc

    def _scan(self, ebml: _File) -> None:
        top = list(ebml.elements(0, ebml.size))
        if not top or top[0][0] != EBML:
            raise ValueError(f"corrupt Matroska {self.path}: no EBML header")
        doctype = next((ebml.read(s, e).rstrip(b"\0") for i, s, e in ebml.elements(*top[0][1:]) if i == DOCTYPE),
                       b"matroska")
        if doctype not in (b"matroska", b"webm"):
            raise NotImplementedError(f"{self.path}: a Matroska file of DocType {doctype.decode('latin-1')!r}; the "
                                      f"port reads 'matroska' and 'webm' ({_ROADMAP})")
        segment = next(((s, e) for i, s, e in top if i == SEGMENT), None)
        if segment is None:
            raise ValueError(f"corrupt Matroska {self.path}: no Segment")
        scale, duration, track, self._clusters = 1_000_000, None, None, []
        for eid, start, end in ebml.elements(*segment):
            if eid == INFO:
                for i, s, e in ebml.elements(start, end):
                    if i == TIMESTAMP_SCALE:
                        scale = ebml.uint(s, e)
                    elif i == DURATION:
                        duration = ebml.float(s, e)
            elif eid == TRACKS and track is None:
                track = self._track(ebml, start, end)
            elif eid == CLUSTER:
                self._clusters.append((start, end))
        if track is None:
            raise ValueError(f"corrupt Matroska {self.path}: no video track")
        self.number, self.config, default_duration, self.fourcc, self.codec, pixels = track
        self._blocks = self._index(ebml)
        if default_duration:
            num, den = av_reduce(1_000_000_000, default_duration, 30000)
        else:
            stamps = [t for t, _, _ in self._blocks]
            num, den = (len(stamps) - 1) * 1_000_000_000, (max(stamps) - min(stamps)) * scale if stamps else 0
        self.fps = num / den if num and den else 0.0
        self._open_codec(pixels)
        if self.codec == "mpeg12" and not default_duration and self.frame_rate[0]:
            # libavformat times each block by the sequence's frame rate, in whole ticks of the track's scale
            ticks = 1_000_000_000 * self.frame_rate[1] // (self.frame_rate[0] * scale)
            self.fps = 1_000_000_000 / (ticks * scale) if ticks else 0.0
        if duration:
            micros = int(duration * scale * 1000 / 1_000_000)  # libavformat's AVFormatContext.duration
            self.frame_count = math.floor(micros / 1_000_000 * self.fps + 0.5)
        else:
            self.frame_count = len(self._blocks)

    def _open_codec(self, pixels: Tuple[int, int]) -> None:
        """The track's size, and what its codec refuses raised, before any frame."""
        if self.codec in _VP_TRACKS:
            self.width, self.height = _VP_TRACKS[self.codec].size(self)
        elif self.codec == AV1_CODEC_ID:
            self.width, self.height = pixels
        elif self.codec == MSMPEG4V3_CODEC_ID or is_fourcc(self.fourcc.encode()):
            self.width, self.height = pixels
            self.open_msmpeg4(V3 if self.codec == MSMPEG4V3_CODEC_ID else self.fourcc)
        elif self.codec in mpeg12.CODEC_IDS or mpeg12.is_fourcc(self.fourcc.encode()):
            self.codec = "mpeg12"
            self.open_mpeg12()
        elif is_h263_fourcc(self.fourcc.encode()):
            self.codec = "h263"
            self.width, self.height = self.h263_size()
        else:
            vol = self._vol()
            if vol is None:
                raise NotImplementedError(f"{self.path}: an MPEG-4 track of the short (H.263) video header in "
                                          "Matroska (ROADMAP Queue 1 item 11.2)")
            self.width, self.height = vol.width, vol.height

    def read(self, rgb: bool = True) -> Iterator[np.ndarray]:
        """The decoded frames: uint8 (H, W, 3), RGB (BGR with `rgb=False`);
        none of an AV1 track, as OpenCV gives none."""
        if self.codec == AV1_CODEC_ID:
            return iter(())
        if self.ms_version:
            return self.read_msmpeg4(rgb)
        if self.codec == "mpeg12":
            return self.read_mpeg12(rgb)
        if self.codec == "h263":
            return self.read_h263(rgb)
        return _VP_TRACKS.get(self.codec, Mpeg4Track).read(self, rgb)

    def _track(self, ebml: _File, start: int, end: int):
        for eid, s, e in ebml.elements(start, end):
            if eid != TRACK_ENTRY:
                continue
            fields: Dict[int, Tuple[int, int]] = {i: (a, b) for i, a, b in ebml.elements(s, e)}
            if TRACK_TYPE not in fields or ebml.uint(*fields[TRACK_TYPE]) != 1:
                continue
            codec = ebml.read(*fields[CODEC_ID]).rstrip(b"\0").decode("latin-1") if CODEC_ID in fields else ""
            private = ebml.read(*fields[CODEC_PRIVATE]) if CODEC_PRIVATE in fields else b""
            fourcc = ""
            pixels = (0, 0)
            if VIDEO in fields:
                video = {i: ebml.uint(a, b) for i, a, b in ebml.elements(*fields[VIDEO])
                         if i in (PIXEL_WIDTH, PIXEL_HEIGHT)}
                pixels = (video.get(PIXEL_WIDTH, 0), video.get(PIXEL_HEIGHT, 0))
            if codec == "V_MS/VFW/FOURCC" and len(private) >= 40:
                fourcc = private[16:20].decode("latin-1")
                if private[16:20] not in MPEG4_FOURCCS and not is_fourcc(private[16:20]) \
                        and not mpeg12.is_fourcc(private[16:20]) and not is_h263_fourcc(private[16:20]):
                    raise NotImplementedError(f"{self.path}: a Matroska video track of VFW fourcc {fourcc!r}; the "
                                              f"port reads MPEG-4 Part 2, MS-MPEG-4, WMV, MPEG-1/2 and H.263 video "
                                              f"only ({_ROADMAP})")
                if pixels == (0, 0):
                    width, height = struct.unpack("<ii", private[4:12])
                    pixels = (width, abs(height))
                private = private[40:]
            elif codec not in MPEG4_CODEC_IDS + mpeg12.CODEC_IDS + (MSMPEG4V3_CODEC_ID, AV1_CODEC_ID) \
                    and codec not in _VP_TRACKS:
                raise NotImplementedError(f"{self.path}: a Matroska video track of codec {codec!r}; the port reads "
                                          f"MPEG-4 Part 2, MS-MPEG-4, WMV, MPEG-1/2, H.263, VP8 and VP9 video only "
                                          f"({_ROADMAP})")
            if TRACK_NUMBER not in fields:
                raise ValueError(f"corrupt Matroska {self.path}: a track without a number")
            default = ebml.uint(*fields[DEFAULT_DURATION]) if DEFAULT_DURATION in fields else 0
            return ebml.uint(*fields[TRACK_NUMBER]), private, default, fourcc, codec, pixels
        return None

    def _index(self, ebml: _File) -> List[Tuple[int, int, int]]:
        """(cluster timestamp + block offset, body start, body end) of the track's blocks."""
        blocks = []
        for start, end in self._clusters:
            base = 0
            for eid, s, e in ebml.elements(start, end):
                if eid == CLUSTER_TIMESTAMP:
                    base = ebml.uint(s, e)
                elif eid == SIMPLE_BLOCK:
                    blocks.extend(self._block(ebml, base, s, e))
                elif eid == BLOCK_GROUP:
                    for i, bs, be in ebml.elements(s, e):
                        if i == BLOCK:
                            blocks.extend(self._block(ebml, base, bs, be))
        return blocks

    def _block(self, ebml: _File, base: int, start: int, end: int):
        track, at, _ = ebml._vint(start, False)
        if track != self.number:
            return []
        head = ebml.read(at, at + 3)
        stamp, flags = struct.unpack(">hB", head)
        if flags & 0x06:
            raise NotImplementedError(f"{self.path}: a laced Matroska block; the port reads unlaced blocks only "
                                      f"({_ROADMAP})")
        return [(base + stamp, at + 3, end)]

    def packets(self) -> Iterator[bytes]:
        """Each block's frame, in file order."""
        with open(self.path, "rb") as f:
            for _, start, end in self._blocks:
                f.seek(start)
                data = f.read(end - start)
                if len(data) != end - start:
                    raise ValueError(f"corrupt Matroska {self.path}: a block is truncated")
                yield data


# ---------------------------------------------------------------- the muxer


def _vint_size(n: int) -> bytes:
    """An EBML size of 8 bytes (the form the writer patches in place)."""
    return bytes([1]) + n.to_bytes(7, "big")


def _el(eid: int, body: bytes) -> bytes:
    size = len(body)
    n = next(k for k in range(1, 9) if size < (1 << (7 * k)) - 1)
    return eid.to_bytes((eid.bit_length() + 7) // 8, "big") + ((1 << (7 * n)) | size).to_bytes(n, "big") + body


def _uint(eid: int, v: int) -> bytes:
    return _el(eid, v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big"))


def _matroska_head(doctype: str, codec: str, private: bytes, width: int, height: int, fps: float) -> bytes:
    """The EBML header, then the opening of a Segment of unknown size and its
    Info and Tracks (one video track, number 1); Duration is a placeholder
    that `MatroskaWriter` patches."""
    rate, scale = fps_ratio(fps)
    head = _el(EBML, _uint(0x4286, 1) + _uint(0x42F7, 1) + _uint(0x42F2, 4) + _uint(0x42F3, 8)
               + _el(DOCTYPE, doctype.encode()) + _uint(0x4287, 4 if doctype == "matroska" else 2) + _uint(0x4285, 2))
    video = _el(VIDEO, _uint(PIXEL_WIDTH, width) + _uint(PIXEL_HEIGHT, height))
    entry = (_uint(TRACK_NUMBER, 1) + _uint(TRACK_UID, 1) + _uint(TRACK_TYPE, 1) + _el(CODEC_ID, codec.encode())
             + _uint(DEFAULT_DURATION, round(1_000_000_000 * scale / rate)) + video)
    if private:
        entry += _el(CODEC_PRIVATE, private)
    info = _uint(TIMESTAMP_SCALE, 1_000_000) + _el(MUXING_APP, b"yolo_infer_tpu_torch") + _el(
        WRITING_APP, b"yolo_infer_tpu_torch") + _el(DURATION, struct.pack(">d", 0.0))
    return head + SEGMENT.to_bytes(4, "big") + _vint_size(0) + _el(INFO, info) + _el(TRACKS, _el(TRACK_ENTRY, entry))


def _cluster(stamp_ms: int, frames: List[Tuple[int, bytes, bool]]) -> bytes:
    """A Cluster at `stamp_ms` of SimpleBlocks (relative ms, data, key)."""
    body = _uint(CLUSTER_TIMESTAMP, stamp_ms)
    for rel, data, key in frames:
        body += _el(SIMPLE_BLOCK, b"\x81" + struct.pack(">hB", rel, 0x80 if key else 0) + data)
    return _el(CLUSTER, body)


class MatroskaWriter:
    """Frames (bytes) into one video track of a Matroska or WebM file: a
    Cluster per second, the Segment's size and Duration patched on
    `release()`. A frame's time slot may be given (`add(at=)`): a hidden
    VP8 frame shares the slot of the frame after it."""

    def __init__(self, path: Union[str, Path], doctype: str, codec: str, private: bytes, width: int, height: int,
                 fps: float):
        self.path = Path(path)
        self.fps = fps
        self.n = 0
        self._pending: List[Tuple[int, bytes, bool]] = []
        self._cluster_ms = 0
        self._f = open(self.path, "wb")
        head = _matroska_head(doctype, codec, private, width, height, fps)
        self._f.write(head)
        self._segment = head.index(SEGMENT.to_bytes(4, "big")) + 4
        self._duration = head.index(DURATION.to_bytes(2, "big") + b"\x88") + 3

    def add(self, data: bytes, key: bool = True, at: Optional[int] = None) -> None:
        """One frame, timed as frame `at` (by default the next one's slot)."""
        at = self.n if at is None else at
        self.n = max(self.n, at + 1)
        stamp = round(at * 1000 / self.fps)
        if self._pending and stamp - self._cluster_ms >= 1000:
            self._flush()
        if not self._pending:
            self._cluster_ms = stamp
        self._pending.append((stamp - self._cluster_ms, data, key))

    def _flush(self) -> None:
        if self._pending:
            self._f.write(_cluster(self._cluster_ms, self._pending))
            self._pending = []

    def release(self) -> None:
        if self._f.closed:
            return
        try:
            self._flush()
            end = self._f.tell()
            self._f.seek(self._segment)
            self._f.write(_vint_size(end - self._segment - 8))
            self._f.seek(self._duration)
            self._f.write(struct.pack(">d", self.n * 1000 / self.fps))
        finally:
            self._f.close()


class MkvWriter:
    """An MPEG-4 Part 2 Matroska writer with `cv2.VideoWriter`'s surface:
    `write` BGR uint8 frames of `frame_size` (w, h), then `release()`. As
    OpenCV's FFmpeg writer does, an odd height loses its last row."""

    def __init__(self, path: Union[str, Path], fps: float, frame_size: Tuple[int, int]):
        self.path = Path(path)
        self.width, self.height = (int(v) for v in frame_size)
        fps_ratio(fps)  # refuses a rate of 0 or below
        self.encoder = Mpeg4Encoder(self.width, self.height & ~1, fps)
        self._out = MatroskaWriter(self.path, "matroska", MPEG4_CODEC_IDS[1], self.encoder.headers(),
                                   self.encoder.width, self.encoder.height, fps)

    def isOpened(self) -> bool:  # noqa: N802 -- cv2.VideoWriter's name
        return not self._out._f.closed

    def write(self, frame_bgr: np.ndarray) -> None:
        if not self.isOpened():
            raise ValueError(f"{self.path}: write after release()")
        frame = np.asarray(frame_bgr)
        if frame.shape != (self.height, self.width, 3) or frame.dtype != np.uint8:
            raise ValueError(f"{self.path}: a frame of {frame.shape} {frame.dtype}; the writer takes uint8 "
                             f"({self.height}, {self.width}, 3) BGR")
        self._out.add(self.encoder.encode(frame[:self.encoder.height]))

    def release(self) -> None:
        self._out.release()
