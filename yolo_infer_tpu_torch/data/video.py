"""Open a video file by its signature, as OpenCV's FFmpeg backend probes it, not by its name.

  AVI         `RIFF....AVI ` -> `data/avi.py AviReader` (motion JPEG,
              MPEG-4 Part 2, MS-MPEG-4 v2 and v3, WMV1 and WMV2, H.263
              (`H263`, `U263`), MPEG-1 and MPEG-2, raw I420)
  MP4, MOV    an `ftyp` box (3GP too), or a QuickTime file that starts
              with `moov`, `mdat`, `wide`, `free` or `skip` ->
              `data/mp4.py Mp4Reader` (MPEG-4 Part 2, MS-MPEG-4 v2 and
              v3, WMV1 and WMV2, H.263, MPEG-1 and MPEG-2; AV1 gives its
              info and no frame)
  Matroska    the EBML magic -> `data/mkv.py MkvReader` (MPEG-4 Part 2,
              MS-MPEG-4 v2 and v3, WMV1 and WMV2, H.263, MPEG-1 and MPEG-2;
              WebM, VP8 through `data/vp8.py` and VP9 through `data/vp9.py`;
              AV1 gives its info and no frame)

Microsoft's MPEG-4 family decodes through `data/msmpeg4.py` and
`data/wmv2.py`, MPEG-1 and MPEG-2 through `data/mpeg12.py` (progressive
frame pictures, 4:2:0; OpenCV's `PIM1`, `mpg1`, `MPEG` and `mpg2` writers
and libavcodec's encoders write them so). An AV1 track is read as the JAX package reads it through
OpenCV, whose bundled libavcodec opens it and decodes no frame: the port
has no AV1 decoder, and gives the container's info and no frame.

Every reader has `width`, `height`, `fps`, `frame_count`, `info()` (the
JAX package's `get_video_info` keys) and `read(rgb)`, and raises on an
unsupported file before any frame is read: `NotImplementedError` citing
ROADMAP Queue 1 item 11.2 for a container or codec the port does not
decode, `ValueError` for a corrupt or truncated file, `FileNotFoundError`
for a file it cannot open.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

from yolo_infer_tpu_torch.data.avi import AviReader
from yolo_infer_tpu_torch.data.mkv import MkvReader
from yolo_infer_tpu_torch.data.mp4 import Mp4Reader

_QUICKTIME_FIRST = (b"ftyp", b"moov", b"mdat", b"wide", b"free", b"skip")


def open_video(path: Union[str, Path]):
    """The reader for the video file at `path`, picked by its first bytes."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError as exc:
        raise FileNotFoundError(f"could not open video: {path}") from exc
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return AviReader(path)
    if head[4:8] in _QUICKTIME_FIRST:
        return Mp4Reader(path)
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return MkvReader(path)
    what = f"a RIFF {head[8:12]!r} file" if head[:4] == b"RIFF" else f"a file that starts {head[:8].hex()}"
    raise NotImplementedError(f"{path}: {what}; the port reads AVI, MP4/MOV and Matroska/WebM video (ROADMAP Queue 1 "
                              "item 11.2)")
