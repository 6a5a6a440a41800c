"""MP4, QuickTime and 3GPP (ISO base media file format) video without OpenCV: a demuxer and an MPEG-4 Part 2 writer.

`Mp4Reader` reads the first `vide` track of an `.mp4`, `.m4v`, `.mov` or
`.3gp` file: boxes with 32- or 64-bit sizes or a size of 0 (to the end of
the file), `moov` before or after `mdat`. The track's `mdhd` gives its
timescale; `stsd` its sample entry, which must be `mp4v` with an `esds`
whose DecoderConfigDescriptor names MPEG-4 Visual (object type 0x20) and
whose DecoderSpecificInfo holds the video object layer header (each sample
to `data/mpeg4.py`) or names MPEG-1 or MPEG-2 video (0x6A, 0x60-0x65: as
OpenCV's `PIM1` and `MPEG` writers write a `.mp4`) and holds a sequence
header (each sample to `data/mpeg12.py`), QuickTime's MPEG-1/2 entries
`m1v `, `m1v1`, `mpeg` and `m2v1` (OpenCV's writers' `.mov`; the size from
the first sequence header once every header is read), or H.263's `h263`
(QuickTime's, as OpenCV's `H263` writer writes a `.mov`) or `s263`
(3GPP's), whatever the extension (each
sample to `data/h263.py`; the size from the first picture header), or an
MS-MPEG-4 or WMV tag (`data/msmpeg4.py FOURCCS`, as libavformat falls back
to the AVI tags: OpenCV's `DIV3` writer writes `3IVD` into a `.mov`, its
`MP42`, `WMV1` and `WMV2` writers their own fourccs, WMV2's extension
header in a `glbl` box; the size from the sample entry); `stts`,
`stsc`, `stsz` and `stco` or `co64` the samples (`stss` is not needed:
every sample is decoded, in order). Each sample is one packet. `fps` is
libavformat's average frame rate
(the track's timescale over its one sample duration, or over the mean of
several) and `frame_count` the samples in `stts`: what OpenCV reports for
the same file, so that `info()` equals the JAX package's `get_video_info`.
A B-VOP track's samples are in decoding order and the decoder gives
display order, so its `ctts` is not read; nor is the edit list that
libavformat's muxer writes to start at the first displayed frame, since
neither moves the average rate or the count of `stts` in such a file.

An AV1 track (`av01`) is read as the JAX package reads it through OpenCV,
whose bundled libavcodec has no AV1 decoder it can run: the track's size,
rate and count, and no frame. Any other sample entry (`avc1`, `hvc1`,
`hev1`, `vp09`, ...) and MS-MPEG-4 v1 raise `NotImplementedError` naming it
(ROADMAP Queue 1 item 11.2), before any frame is read; a malformed or
truncated file raises `ValueError`.

`Mp4Writer` has `cv2.VideoWriter`'s surface (`write(frame_bgr)`,
`release()`, `isOpened()`). It encodes each frame with `Mpeg4Encoder` (an
odd height loses its last row, as with OpenCV's writer) and
writes `ftyp` (`isom` for `.mp4` and `.m4v`, `qt  ` for `.mov`), the
samples in one `mdat` with a 64-bit size, then on `release()` the `moov`:
`mvhd`, and one track of `tkhd`, `mdhd` (timescale and sample duration
from `data/avi.py fps_ratio`, so that readers get the fps back), `hdlr`,
`vmhd`, `dref`, and a sample table of `stsd` (`mp4v` + `esds`), a one-entry
`stts`, `stss`, `stsz`, `stsc` and `stco` (`co64` past 4 GiB).
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np

from yolo_infer_tpu_torch.data import mpeg12
from yolo_infer_tpu_torch.data.avi import fps_ratio
from yolo_infer_tpu_torch.data.h263 import H263_SAMPLE_ENTRIES, H263Track
from yolo_infer_tpu_torch.data.mpeg4 import Mpeg4Encoder, Mpeg4Track
from yolo_infer_tpu_torch.data.mpeg12 import Mpeg12Track
from yolo_infer_tpu_torch.data.msmpeg4 import MsMpeg4Track, is_fourcc

_ROADMAP = "ROADMAP Queue 1 item 11.2"
MPEG4_VISUAL = 0x20  # the esds objectTypeIndication of MPEG-4 Part 2 video


def _boxes(data: bytes, pos: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """(type, body start, body end) of each box in data[pos:end]."""
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError("corrupt MP4: a box header runs past its parent")
            size, head = struct.unpack(">Q", data[pos + 8:pos + 16])[0], 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"corrupt MP4: box {kind!r} runs past its parent")
        yield kind, pos + head, pos + size
        pos += size


def _find(data: bytes, pos: int, end: int, *path: bytes) -> Optional[Tuple[int, int]]:
    for kind, start, stop in _boxes(data, pos, end):
        if kind == path[0]:
            return (start, stop) if len(path) == 1 else _find(data, start, stop, *path[1:])
    return None


def _descriptor(data: bytes, pos: int) -> Tuple[int, int, int]:
    """(tag, body start, body end) of an MPEG-4 systems descriptor at pos."""
    tag, size, pos = data[pos], 0, pos + 1
    for _ in range(4):
        byte = data[pos]
        pos += 1
        size = size << 7 | byte & 0x7F
        if not byte & 0x80:
            break
    if pos + size > len(data):
        raise ValueError("corrupt MP4: an esds descriptor runs past its box")
    return tag, pos, pos + size


def esds_config(body: bytes) -> Tuple[int, bytes]:
    """The objectTypeIndication and DecoderSpecificInfo of an esds box body
    (after version and flags); raises unless the stream is MPEG-4 Visual,
    MPEG-1 or MPEG-2 video."""
    tag, pos, end = _descriptor(body, 4)
    if tag != 3:
        raise ValueError("corrupt MP4: esds without an ES descriptor")
    flags = body[pos + 2]
    pos += 3 + (2 if flags & 0x80 else 0) + (1 + body[pos + 3] if flags & 0x40 else 0) + (2 if flags & 0x20 else 0)
    tag, pos, end = _descriptor(body, pos)
    if tag != 4:
        raise ValueError("corrupt MP4: esds without a decoder configuration")
    kind = body[pos]
    if kind != MPEG4_VISUAL and kind not in mpeg12.OBJECT_TYPES:
        raise NotImplementedError(f"an mp4v sample entry whose esds names object type 0x{kind:02x}, not MPEG-4 "
                                  f"Visual, MPEG-1 or MPEG-2 video; the port reads those ({_ROADMAP})")
    pos += 13
    while pos < end:
        tag, start, stop = _descriptor(body, pos)
        if tag == 5:
            return kind, body[start:stop]
        pos = stop
    return kind, b""


def _full(data: bytes, start: int, fmt: str) -> Tuple[int, ...]:
    return struct.unpack_from(fmt, data, start + 4)


class Mp4Reader(Mpeg4Track, H263Track, MsMpeg4Track, Mpeg12Track):
    """The first video track of an MP4 or QuickTime file: `width`, `height`,
    `fps`, `frame_count`, `info()`, the samples (`packets()`) and the decoded
    frames (`read()`)."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        try:
            with open(self.path, "rb") as f:
                size = os.fstat(f.fileno()).st_size
                moov = self._top(f, size)
        except OSError as exc:
            raise FileNotFoundError(f"could not open video: {path}") from exc
        try:
            self._parse(moov, size)
        except (struct.error, IndexError) as exc:
            raise ValueError(f"corrupt MP4 {self.path}: {exc}") from exc

    def _top(self, f, size: int) -> bytes:
        """Walk the top-level boxes by their headers alone; return moov's body."""
        pos, moov = 0, None
        while pos + 8 <= size:
            f.seek(pos)
            head = f.read(16)
            box, kind = struct.unpack(">I4s", head[:8])
            skip = 8
            if box == 1:
                box, skip = struct.unpack(">Q", head[8:16])[0], 16
            elif box == 0:
                box = size - pos
            if box < skip:
                raise ValueError(f"corrupt MP4 {self.path}: a top-level box of {box} bytes")
            if kind == b"moov":
                if pos + box > size:
                    raise ValueError(f"corrupt MP4 {self.path}: the moov box is truncated")
                f.seek(pos + skip)
                moov = f.read(box - skip)
            pos += box
        if moov is None:
            raise ValueError(f"corrupt MP4 {self.path}: no moov box (a truncated file?)")
        return moov

    def _parse(self, moov: bytes, file_size: int) -> None:
        track = None
        for kind, start, end in _boxes(moov, 0, len(moov)):
            if kind == b"trak":
                hdlr = _find(moov, start, end, b"mdia", b"hdlr")
                if hdlr is not None and moov[hdlr[0] + 8:hdlr[0] + 12] == b"vide":
                    track = (start, end)
                    break
        if track is None:
            raise ValueError(f"corrupt MP4 {self.path}: no video track")
        mdia = _find(moov, *track, b"mdia")
        mdhd = _find(moov, *mdia, b"mdhd")
        stbl = _find(moov, *mdia, b"minf", b"stbl")
        if mdhd is None or stbl is None:
            raise ValueError(f"corrupt MP4 {self.path}: a video track without mdhd or stbl")
        self.timescale = _full(moov, mdhd[0], ">16xI" if moov[mdhd[0]] == 1 else ">8xI")[0]
        boxes = {kind: (start, end) for kind, start, end in _boxes(moov, *stbl)}
        for need in (b"stsd", b"stts", b"stsc", b"stsz"):
            if need not in boxes:
                raise ValueError(f"corrupt MP4 {self.path}: no {need.decode()} box")
        self.codec, self.config = self._sample_entry(moov, *boxes[b"stsd"])
        # stts: (count, duration) runs
        start = boxes[b"stts"][0]
        (n,) = _full(moov, start, ">I")
        stts = [struct.unpack_from(">II", moov, start + 8 + 8 * i) for i in range(n)]
        # stsz: the sample sizes
        start = boxes[b"stsz"][0]
        fixed, count = _full(moov, start, ">II")
        sizes = [fixed] * count if fixed else list(struct.unpack_from(f">{count}I", moov, start + 12))
        # stsc and the chunk offsets
        start = boxes[b"stsc"][0]
        (n,) = _full(moov, start, ">I")
        stsc = [struct.unpack_from(">III", moov, start + 8 + 12 * i)[:2] for i in range(n)]
        if b"stco" in boxes:
            start = boxes[b"stco"][0]
            (n,) = _full(moov, start, ">I")
            chunks = list(struct.unpack_from(f">{n}I", moov, start + 8))
        elif b"co64" in boxes:
            start = boxes[b"co64"][0]
            (n,) = _full(moov, start, ">I")
            chunks = list(struct.unpack_from(f">{n}Q", moov, start + 8))
        else:
            raise ValueError(f"corrupt MP4 {self.path}: no stco or co64 box")
        self._samples = self._layout(stsc, chunks, sizes)
        if any(at + size > file_size for at, size in self._samples):
            raise ValueError(f"corrupt MP4 {self.path}: a sample lies past the end of the file (truncated?)")
        self.frame_count = sum(c for c, _ in stts)
        if self.frame_count != len(self._samples):
            raise ValueError(f"corrupt MP4 {self.path}: stts counts {self.frame_count} samples, stsz "
                             f"{len(self._samples)}")
        # libavformat's average frame rate
        if len(stts) == 1 or (len(stts) == 2 and stts[1][0] == 1):
            num, den = self.timescale, stts[0][1]
        else:
            num, den = self.timescale * self.frame_count, sum(c * d for c, d in stts)
        self.fps = num / den if num and den else 0.0
        if self.codec == "h263":
            self.width, self.height = self.h263_size()
            return
        if self.codec == "msmpeg4":
            self.open_msmpeg4(self.fourcc)
            return
        if self.codec == "mpeg12":
            self.open_mpeg12()
            return
        if self.codec == "av1":
            return
        vol = self._vol()
        if vol is not None:  # else the short video header: the sample entry's size
            self.width, self.height = vol.width, vol.height

    def _sample_entry(self, moov: bytes, start: int, end: int) -> Tuple[str, bytes]:
        """The track's codec ("mpeg4", "mpeg12", "h263", "msmpeg4", "av1")
        and decoder configuration; the sample entry's width and height into
        `width`, `height`."""
        (n,) = _full(moov, start, ">I")
        if n < 1:
            raise ValueError(f"corrupt MP4 {self.path}: an empty stsd")
        entries = _boxes(moov, start + 8, end)
        kind, body, stop = next(entries)
        if kind in H263_SAMPLE_ENTRIES:
            return "h263", b""
        if kind in mpeg12.SAMPLE_ENTRIES:
            return "mpeg12", b""
        if kind == b"av01" or is_fourcc(kind):
            self.width, self.height = struct.unpack_from(">HH", moov, body + 24)
            if kind == b"av01":
                return "av1", b""
            self.fourcc = kind.decode("latin-1")
            glbl = [moov[a:b] for child, a, b in _boxes(moov, body + 78, stop) if child == b"glbl"]
            return "msmpeg4", glbl[0] if glbl else b""
        if kind != b"mp4v":
            name = kind.decode("latin-1")
            raise NotImplementedError(f"{self.path}: an MP4/MOV video track of sample entry {name!r}; the port reads "
                                      f"MPEG-4 Part 2 ('mp4v'), MS-MPEG-4, WMV and H.263 ('h263', 's263') only "
                                      f"({_ROADMAP})")
        self.width, self.height = struct.unpack_from(">HH", moov, body + 24)
        for child, cstart, cend in _boxes(moov, body + 78, stop):
            if child == b"esds":
                try:
                    kind, config = esds_config(moov[cstart:cend])
                except NotImplementedError as exc:
                    raise NotImplementedError(f"{self.path}: {exc}") from exc
                return ("mpeg4" if kind == MPEG4_VISUAL else "mpeg12"), config
        return "mpeg4", b""

    @staticmethod
    def _layout(stsc, chunks, sizes) -> List[Tuple[int, int]]:
        """(offset, size) of each sample from the chunk map."""
        samples, k = [], 0
        for i, (first, per_chunk) in enumerate(stsc):
            last = stsc[i + 1][0] - 1 if i + 1 < len(stsc) else len(chunks)
            for chunk in range(first - 1, min(last, len(chunks))):
                at = chunks[chunk]
                for _ in range(per_chunk):
                    if k == len(sizes):
                        return samples
                    samples.append((at, sizes[k]))
                    at += sizes[k]
                    k += 1
        if k != len(sizes):
            raise ValueError(f"corrupt MP4: the chunk map places {k} of {len(sizes)} samples")
        return samples

    def packets(self) -> Iterator[bytes]:
        """Each sample's bytes, in decoding order."""
        with open(self.path, "rb") as f:
            for at, size in self._samples:
                f.seek(at)
                data = f.read(size)
                if len(data) != size:
                    raise ValueError(f"corrupt MP4 {self.path}: a sample is truncated")
                yield data

    def read(self, rgb: bool = True) -> Iterator[np.ndarray]:
        """The decoded frames: uint8 (H, W, 3), RGB (BGR with `rgb=False`);
        none of an AV1 track, as OpenCV gives none."""
        if self.codec == "av1":
            return iter(())
        if self.codec == "msmpeg4":
            return self.read_msmpeg4(rgb)
        if self.codec == "mpeg12":
            return self.read_mpeg12(rgb)
        return self.read_h263(rgb) if self.codec == "h263" else super().read(rgb)



# ---------------------------------------------------------------- the writer


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags), *parts)


def _descr(tag: int, body: bytes) -> bytes:
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F, 0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


class Mp4Writer:
    """An MPEG-4 Part 2 MP4/QuickTime writer with `cv2.VideoWriter`'s surface:
    `write` BGR uint8 frames of `frame_size` (w, h), then `release()`.
    `.mov` gets a QuickTime `ftyp`, anything else ISO's."""

    def __init__(self, path: Union[str, Path], fps: float, frame_size: Tuple[int, int]):
        self.path = Path(path)
        self.width, self.height = (int(v) for v in frame_size)
        self.rate, self.scale = fps_ratio(fps)
        # an odd height loses its last row, as OpenCV's FFmpeg writer rounds
        # odd sizes down (an odd height would take swscale's scaled path in
        # every reader, one the port does not reproduce); odd widths are kept
        self.encoder = Mpeg4Encoder(self.width, self.height & ~1, fps)
        self._sizes: List[int] = []
        self._offsets: List[int] = []
        self._f = open(self.path, "wb")
        if self.path.suffix.lower() == ".mov":
            ftyp = _box(b"ftyp", b"qt  ", struct.pack(">I", 0x200), b"qt  ")
        else:
            ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")
        self._f.write(ftyp)
        self._mdat = self._f.tell()
        self._f.write(struct.pack(">I4sQ", 1, b"mdat", 16))

    def isOpened(self) -> bool:  # noqa: N802 -- cv2.VideoWriter's name
        return not self._f.closed

    def write(self, frame_bgr: np.ndarray) -> None:
        if self._f.closed:
            raise ValueError(f"{self.path}: write after release()")
        frame = np.asarray(frame_bgr)
        if frame.shape != (self.height, self.width, 3) or frame.dtype != np.uint8:
            raise ValueError(f"{self.path}: a frame of {frame.shape} {frame.dtype}; the writer takes uint8 "
                             f"({self.height}, {self.width}, 3) BGR")
        data = self.encoder.encode(frame[:self.encoder.height])
        self._offsets.append(self._f.tell())
        self._sizes.append(len(data))
        self._f.write(data)

    def release(self) -> None:
        """Fix the mdat size, write the moov and close the file."""
        if self._f.closed:
            return
        try:
            end = self._f.tell()
            self._f.seek(self._mdat + 8)
            self._f.write(struct.pack(">Q", end - self._mdat))
            self._f.seek(end)
            self._f.write(self._moov())
        finally:
            self._f.close()

    def _moov(self) -> bytes:
        n, w, h = len(self._sizes), self.encoder.width, self.encoder.height
        duration = n * self.scale  # in the track's timescale (self.rate)
        movie = round(duration * 1000 / self.rate)  # the movie timescale is 1000
        mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIIIIH10x", 0, 0, 1000, movie, 0x10000, 0x100), _MATRIX,
                         bytes(24), struct.pack(">I", 2))
        tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII8xhhH2x", 0, 0, 1, 0, movie, 0, 0, 0), _MATRIX,
                         struct.pack(">II", w << 16, h << 16))
        mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, self.rate, duration, 0x55C4, 0))
        hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"), b"VideoHandler\0")
        vmhd = _full_box(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1), _full_box(b"url ", 0, 1)))
        config = self.encoder.headers()
        bitrate = int(sum(self._sizes) * 8 * self.rate / max(duration, 1))
        esds = _full_box(b"esds", 0, 0, _descr(3, struct.pack(">HB", 1, 0) + _descr(
            4, struct.pack(">BB3sII", MPEG4_VISUAL, 0x11, max(self._sizes or [0]).to_bytes(3, "big"), bitrate,
                           bitrate) + _descr(5, config)) + _descr(6, b"\x02")))
        entry = _box(b"mp4v", bytes(6), struct.pack(">H16xHHIIIH32sHh", 1, w, h, 0x480000, 0x480000, 0, 1,
                                                              b"", 24, -1), esds)
        stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry)
        stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, self.scale) if n else struct.pack(">I", 0))
        stss = _full_box(b"stss", 0, 0, struct.pack(f">I{n}I", n, *range(1, n + 1)))
        stsz = _full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *self._sizes))
        stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1) if n else struct.pack(">I", 0))
        if self._offsets and self._offsets[-1] >= 1 << 32:
            stco = _full_box(b"co64", 0, 0, struct.pack(f">I{n}Q", n, *self._offsets))
        else:
            stco = _full_box(b"stco", 0, 0, struct.pack(f">I{n}I", n, *self._offsets))
        stbl = _box(b"stbl", stsd, stts, stss, stsz, stsc, stco)
        minf = _box(b"minf", vmhd, dinf, stbl)
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)
