"""AVI files without OpenCV: a motion-JPEG and MPEG-4 Part 2 reader and a motion-JPEG writer, in numpy and `struct`.

The JAX package reads and writes video through OpenCV (`cv2.VideoCapture`,
`cv2.VideoWriter`). In an AVI (RIFF) file the port reads the two codecs
that its own decoders handle: motion JPEG (`data/jpeg.py`) and MPEG-4
Part 2 (`data/mpeg4.py`), which OpenCV's FFmpeg writer puts in an AVI under
the fourccs `XVID`, `FMP4` and `DIVX`, and raw planar YUV 4:2:0 (`I420`,
`IYUV`: each chunk the Y, U and V planes, converted by swscale's copy,
`data/mpeg4.py yuv420_to_bgr`; an odd height, which swscale scales,
raises); it writes motion JPEG.

`AviReader` takes the first `vids` stream whose handler or compression is
motion JPEG (`MJPEG_CODECS`) or MPEG-4 Part 2 (`data/mpeg4.py
MPEG4_FOURCCS`). Its size comes from the stream format (`strf`; for MPEG-4
the video object layer header, in band or in the bytes after `strf`'s
BITMAPINFOHEADER), its fps is the stream header's dwRate / dwScale and its
frame count the OpenDML `dmlh` total where the file has one, else the
stream header's dwLength (what OpenCV reports for the same files). `packets()`
walks every `LIST movi` in file order, the first RIFF's and those of any
OpenDML `RIFF AVIX` parts after it: it descends into `LIST rec `, skips the
other streams' chunks (audio `01wb`), `JUNK` and the `ix##` indexes, and
honours the pad byte after an odd-sized chunk. Each `##dc` / `##db` chunk
of the stream is one packet. An MPEG-4 packet goes to `Mpeg4Decoder`, with
the `strf` extra bytes as its configuration and the compression as its
fourcc: OpenCV's FFmpeg backend's frames, bit for bit. A motion-JPEG packet
is a JPEG, decoded by `decode_jpeg`: the pixels of
`cv2.imdecode`, and so of OpenCV's own MJPEG backend
(`cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)`), not of its FFmpeg backend,
whose MJPEG decoder rounds differently.

`AviWriter` has the surface of `cv2.VideoWriter` that the demo uses
(`write(frame_bgr)`, `release()`, `isOpened()`). Each frame is encoded by
`encode_jpeg` (the bytes of `cv2.imencode(".jpg")`: quality 95, 4:2:0). It
writes `avih`, `strh`, `strf`, an OpenDML `dmlh` and an `idx1` index whose
offsets count from the `movi` list, as the usual readers expect; fps
becomes the rational dwRate / dwScale that gives it back. Past `RIFF_LIMIT`
bytes a file goes on in OpenDML `RIFF AVIX` parts, each `movi` list with an
`ix00` standard index, all of them listed in the stream's `indx` super
index: what FFmpeg and other OpenDML readers follow. OpenCV's own MJPEG
reader does not: it parses every RIFF part as a whole AVI (a header list,
a movie list, an `idx1`) and reads frames through `idx1` alone, so each
AVIX part also carries a copy of the header list and an `idx1` of its own
frames (OpenDML readers skip both). The counts are fixed on `release()`.

Other containers are read by `data/video.py`; AVI files of other codecs
(H.264, ...) raise `NotImplementedError` naming what was found (ROADMAP
Queue 1 item 11.2), and so do the MPEG-4 kinds `data/mpeg4.py` lists; a
malformed or truncated file raises `ValueError`.
"""

from __future__ import annotations

import os
import struct
from collections import Counter
from fractions import Fraction
from pathlib import Path
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np

from yolo_infer_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
from yolo_infer_tpu_torch.data.mpeg4 import MPEG4_FOURCCS, Mpeg4Track, yuv420_to_bgr

MJPEG_CODECS = (b"MJPG", b"mjpg", b"AVDJ", b"dmb1")  # stream handlers and compressions read as motion JPEG
I420_FOURCCS = (b"I420", b"IYUV")  # raw planar YUV 4:2:0
RIFF_LIMIT = 1 << 30  # bytes of one RIFF part; the writer goes on in an OpenDML `RIFF AVIX` part past it
SUPER_INDEX_ENTRIES = 256  # room in the writer's `indx` super index: the RIFF parts a file may have

_NOT_READ_AVI = ("the port reads motion JPEG, MPEG-4 Part 2 and raw I420 in AVI; other codecs are ROADMAP Queue 1 "
                 "item 11.2")

# the writer's header list: LIST hdrl, avih, LIST strl (strh, strf, the super
# index or JUNK in its place), LIST odml (dmlh)
_INDX_BODY = 24 + 16 * SUPER_INDEX_ENTRIES
_HDRL_BYTES = 12 + (8 + 56) + 12 + (8 + 56) + (8 + 40) + (8 + _INDX_BODY) + 12 + (8 + 248)
_KEYFRAME = 0x10  # AVIIF_KEYFRAME
_AVIF_FLAGS = 0x910  # AVIF_HASINDEX | AVIF_ISINTERLEAVED | AVIF_TRUSTCKTYPE


def _fourcc(code: bytes) -> str:
    return code.decode("latin-1").strip("\0 ") or repr(code)


def _container_of(head: bytes) -> Optional[str]:
    """What a file that is not an AVI is, from its first bytes (None: unknown)."""
    if head[4:8] == b"ftyp":
        return f"an MP4/MOV file (brand {_fourcc(head[8:12])!r})"
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return "a Matroska/WebM file (EBML header)"
    if head[:4] == b"RIFF" and head[8:12] != b"AVI ":
        return f"a RIFF {_fourcc(head[8:12])!r} file"
    return None


def _chunks(data: bytes, pos: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """(fourcc, body start, body size) of each chunk in data[pos:end]."""
    while pos + 8 <= end:
        fcc, size = data[pos: pos + 4], struct.unpack("<I", data[pos + 4: pos + 8])[0]
        if pos + 8 + size > end:
            raise ValueError(f"corrupt AVI: chunk {fcc!r} runs past its list")
        yield fcc, pos + 8, size
        pos += 8 + size + (size & 1)


class AviReader(Mpeg4Track):
    """The first motion-JPEG or MPEG-4 video stream of an AVI file: `width`,
    `height`, `fps`, `frame_count`, `info()`, the frames' packets
    (`packets()`: JPEGs or MPEG-4 VOPs, `codec` says which) and the decoded
    frames (`read()`)."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        try:
            with open(self.path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                head = f.read(12)
                other = _container_of(head) or (None if head[:4] == b"RIFF" else "not an AVI file (no RIFF header)")
                if other is not None:
                    raise NotImplementedError(f"{path}: {other}; {_NOT_READ_AVI}")
                self._movi = self._scan(f, size)
        except OSError as exc:
            raise FileNotFoundError(f"could not open video: {path}") from exc

    def _scan(self, f, size: int) -> List[Tuple[int, int]]:
        """Parse the headers; return each `movi` list's (body start, end)."""
        movi: List[Tuple[int, int]] = []
        hdrl = None
        pos = 0
        while pos + 12 <= size:  # the top-level RIFF parts: AVI first, then any AVIX
            f.seek(pos)
            fcc, riff_size, form = struct.unpack("<4sI4s", f.read(12))
            if fcc != b"RIFF" or form != (b"AVI " if pos == 0 else b"AVIX"):
                break
            end = min(pos + 8 + riff_size, size)
            at = pos + 12
            while at + 12 <= end:  # the part's top-level chunks
                f.seek(at)
                cfcc, csize, kind = struct.unpack("<4sI4s", f.read(12))
                if cfcc == b"LIST" and kind == b"movi":
                    movi.append((at + 12, min(at + 8 + csize, end)))
                elif cfcc == b"LIST" and kind == b"hdrl" and hdrl is None:
                    hdrl = f.read(csize - 4)
                at += 8 + csize + (csize & 1)
            pos += 8 + riff_size + (riff_size & 1)
        if hdrl is None or not movi:
            raise ValueError(f"corrupt AVI {self.path}: no header list or no movie list")
        self._movi = movi
        self._parse_hdrl(hdrl)
        return movi

    def _parse_hdrl(self, hdrl: bytes) -> None:
        streams, total = [], None
        for fcc, at, size in _chunks(hdrl, 0, len(hdrl)):
            kind = hdrl[at: at + 4] if fcc == b"LIST" else None
            if kind == b"strl":
                parts = {c: hdrl[a: a + s] for c, a, s in _chunks(hdrl, at + 4, at + size)}
                streams.append((parts.get(b"strh", b""), parts.get(b"strf", b"")))
            elif kind == b"odml":
                dmlh = {c: hdrl[a: a + s] for c, a, s in _chunks(hdrl, at + 4, at + size)}.get(b"dmlh")
                if dmlh is not None and len(dmlh) >= 4:
                    total = struct.unpack("<I", dmlh[:4])[0]
        videos = [(i, h, f) for i, (h, f) in enumerate(streams) if len(h) >= 48 and h[:4] == b"vids"]
        if not videos:
            raise ValueError(f"corrupt AVI {self.path}: no video stream")
        known = [(i, h, f) for i, h, f in videos
                 if {h[4:8], f[16:20]} & set(MJPEG_CODECS + MPEG4_FOURCCS + I420_FOURCCS)]
        if not known:
            _, h, f = videos[0]
            raise NotImplementedError(f"{self.path}: an AVI whose video is {_fourcc(h[4:8])!r} (compression "
                                      f"{_fourcc(f[16:20])!r}); {_NOT_READ_AVI}")
        index, strh, strf = known[0]
        if len(strf) < 40:
            raise ValueError(f"corrupt AVI {self.path}: a video stream format of {len(strf)} bytes")
        tags = {strh[4:8], strf[16:20]}
        self.codec = "mjpeg" if tags & set(MJPEG_CODECS) else "i420" if tags & set(I420_FOURCCS) else "mpeg4"
        self.fourcc = _fourcc(strf[16:20] if strf[16:20] in MPEG4_FOURCCS + I420_FOURCCS else strh[4:8])
        self.config = strf[40:]
        scale, rate, _, length = struct.unpack("<4I", strh[20:36])
        _, width, height = struct.unpack("<Iii", strf[:12])
        self.width, self.height = width, abs(height)
        self.fps = rate / scale if scale else 0.0
        self.frame_count = length if total is None else total
        self._ids = (b"%02ddc" % index, b"%02ddb" % index)
        if self.codec == "mpeg4":
            vol = self._vol()
            self.width, self.height = vol.width, vol.height
        if self.codec == "i420" and self.height % 2:  # swscale's scaled path, not ported (as data/mpeg4.py)
            raise NotImplementedError(f"{self.path}: raw I420 video of an odd height ({self.height}); "
                                      "ROADMAP Queue 1 item 11.2")

    def packets(self) -> Iterator[bytes]:
        """Each frame's packet (a JPEG or an MPEG-4 VOP), in file order."""
        with open(self.path, "rb") as f:
            for start, end in self._movi:
                yield from self._walk(f, start, end)

    def _walk(self, f, pos: int, end: int) -> Iterator[bytes]:
        while pos + 8 <= end:
            f.seek(pos)
            fcc, size = struct.unpack("<4sI", f.read(8))
            if fcc == b"LIST":
                if f.read(4) == b"rec ":
                    yield from self._walk(f, pos + 12, min(pos + 8 + size, end))
            elif fcc in self._ids and size:
                data = f.read(size)
                if len(data) != size:
                    raise ValueError(f"corrupt AVI {self.path}: a frame is truncated")
                yield data
            pos += 8 + size + (size & 1)

    def read(self, rgb: bool = True) -> Iterator[np.ndarray]:
        """The decoded frames: uint8 (H, W, 3), RGB (BGR with `rgb=False`)."""
        if self.codec == "mpeg4":
            yield from super().read(rgb)
            return
        self.counts = Counter()
        for data in self.packets():
            if self.codec == "i420":
                bgr = i420_frame(data, self.width, self.height)
                yield np.ascontiguousarray(bgr[..., ::-1]) if rgb else bgr
                continue
            img = decode_jpeg(data)
            yield img if rgb else np.ascontiguousarray(img[..., ::-1])


def i420_frame(data: bytes, width: int, height: int) -> np.ndarray:
    """One raw I420 frame (the Y plane, then U and V of (height / 2,
    ceil(width / 2)), no row padding) -> BGR, as OpenCV's FFmpeg backend
    converts it (`data/mpeg4.py yuv420_to_bgr`)."""
    cw, ch = (width + 1) // 2, (height + 1) // 2
    if len(data) < width * height + 2 * cw * ch:
        raise ValueError(f"corrupt I420 frame: {len(data)} bytes for {width}x{height}")
    b = np.frombuffer(data, np.uint8)
    y = b[: width * height].reshape(height, width)
    u = b[width * height: width * height + cw * ch].reshape(ch, cw)
    v = b[width * height + cw * ch: width * height + 2 * cw * ch].reshape(ch, cw)
    return yuv420_to_bgr(y, u, v)


def fps_ratio(fps: float) -> Tuple[int, int]:
    """(dwRate, dwScale) with dwRate / dwScale == fps (29.97 -> 2997/100)."""
    ratio = Fraction(fps).limit_denominator(1_000_000)
    if not 0 < ratio < 1 << 31:
        raise ValueError(f"fps must be positive, got {fps}")
    return ratio.numerator, ratio.denominator


class AviWriter:
    """A motion-JPEG AVI writer with `cv2.VideoWriter`'s surface: `write`
    BGR uint8 frames of `frame_size` (w, h), then `release()`."""

    def __init__(self, path: Union[str, Path], fps: float, frame_size: Tuple[int, int]):
        self.path = Path(path)
        self.width, self.height = (int(v) for v in frame_size)
        if not (0 < self.width < 65536 and 0 < self.height < 65536):
            raise ValueError(f"frame size {frame_size} is outside JPEG's range")
        self.rate, self.scale = fps_ratio(fps)
        self._riffs: List[int] = []  # the offset of each RIFF part
        self._ix: List[Tuple[int, int, int]] = []  # (ix00 offset, its size, frames) of each part, when several
        self._frames = 0
        self._first_part = 0  # frames of the first RIFF part, which avih counts alone
        self._max_frame = 0
        self._f = open(self.path, "wb")
        self._open_part()

    def isOpened(self) -> bool:  # noqa: N802 -- cv2.VideoWriter's name
        return not self._f.closed

    def _open_part(self) -> None:
        """Start a RIFF part at the end of the file: its header list (written
        on release) and the head of its movi list."""
        self._riffs.append(self._f.tell())
        self._f.write(b"RIFF\0\0\0\0" + (b"AVIX" if len(self._riffs) > 1 else b"AVI ") + bytes(_HDRL_BYTES))
        self._movi_at = self._f.tell()
        self._f.write(b"LIST\0\0\0\0movi")
        self._index: List[Tuple[int, int]] = []  # (chunk offset, size) of the part's frames

    def _part_bytes(self, data_size: int) -> int:
        """The current part's size with one more frame of `data_size` bytes and its two indexes."""
        n = len(self._index) + 1
        return self._f.tell() + 8 + data_size + 1 + (32 + 8 * n) + (8 + 16 * n) - self._riffs[-1]

    def write(self, frame_bgr: np.ndarray) -> None:
        if self._f.closed:
            raise ValueError(f"{self.path}: write after release()")
        frame = np.asarray(frame_bgr)
        if frame.shape != (self.height, self.width, 3) or frame.dtype != np.uint8:
            raise ValueError(f"{self.path}: a frame of {frame.shape} {frame.dtype}; the writer takes uint8 "
                             f"({self.height}, {self.width}, 3) BGR")
        data = encode_jpeg(frame[..., ::-1])
        if self._index and self._part_bytes(len(data)) > RIFF_LIMIT:
            if len(self._riffs) == SUPER_INDEX_ENTRIES:
                raise ValueError(f"{self.path}: more than {SUPER_INDEX_ENTRIES} RIFF parts")
            self._close_part(more=True)
            self._open_part()
        self._index.append((self._f.tell(), len(data)))
        self._f.write(b"00dc" + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1))
        self._frames += 1
        self._max_frame = max(self._max_frame, len(data))

    def _close_part(self, more: bool) -> None:
        """End the current part: its ix00 where the file has several parts,
        the movi list's size, its idx1 (offsets from the list's "movi") and
        the RIFF's size."""
        f, riff = self._f, self._riffs[-1]
        if more or len(self._riffs) > 1:
            ix_at = f.tell()
            body = struct.pack("<HBBI4sQI", 2, 0, 1, len(self._index), b"00dc", self._movi_at, 0)
            body += b"".join(struct.pack("<II", pos + 8 - self._movi_at, size) for pos, size in self._index)
            f.write(_chunk(b"ix00", body))
            self._ix.append((ix_at, 8 + len(body), len(self._index)))
        end = f.tell()
        f.seek(self._movi_at + 4)
        f.write(struct.pack("<I", end - self._movi_at - 8))
        f.seek(end)
        if len(self._riffs) == 1:
            self._first_part = len(self._index)
        f.write(_chunk(b"idx1", b"".join(b"00dc" + struct.pack("<III", _KEYFRAME, pos - self._movi_at - 8, size)
                                         for pos, size in self._index)))
        end = f.tell()
        f.seek(riff + 4)
        f.write(struct.pack("<I", end - riff - 8))
        f.seek(end)

    def release(self) -> None:
        """Close the last part, write the header lists with the final counts and close the file."""
        if self._f.closed:
            return
        try:
            self._close_part(more=False)
            hdrl = self._headers()
            for riff in self._riffs:
                self._f.seek(riff + 12)
                self._f.write(hdrl)
        finally:
            self._f.close()

    def _headers(self) -> bytes:
        """LIST hdrl: avih, the stream's strl (strh, strf, the super index or
        the JUNK that holds its place) and the OpenDML dmlh."""
        w, h = self.width, self.height
        avih = struct.pack("<14I", round(1e6 * self.scale / self.rate), 0, 0, _AVIF_FLAGS, self._first_part, 0, 1,
                           self._max_frame, w, h, 0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", b"MJPG", 0, 0, 0, 0, self.scale, self.rate, 0,
                           self._frames, self._max_frame, 0xFFFFFFFF, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
        if self._ix:
            entries = b"".join(struct.pack("<QII", at, size, n) for at, size, n in self._ix)
            indx = _chunk(b"indx", struct.pack("<HBBI4s3I", 4, 0, 0, len(self._ix), b"00dc", 0, 0, 0) + entries
                          + bytes(_INDX_BODY - 24 - len(entries)))
        else:
            indx = _chunk(b"JUNK", bytes(_INDX_BODY))
        strl = b"strl" + _chunk(b"strh", strh) + _chunk(b"strf", strf) + indx
        odml = b"odml" + _chunk(b"dmlh", struct.pack("<I", self._frames) + bytes(244))
        hdrl = _chunk(b"LIST", b"hdrl" + _chunk(b"avih", avih) + _chunk(b"LIST", strl) + _chunk(b"LIST", odml))
        if len(hdrl) != _HDRL_BYTES:
            raise AssertionError(f"header list of {len(hdrl)} bytes, {_HDRL_BYTES} reserved")
        return hdrl


def _chunk(fcc: bytes, body: bytes) -> bytes:
    return fcc + struct.pack("<I", len(body)) + body
