"""Write the MPEG-4 Part 2 video fixtures of the port's decoder and their manifest.

    python tests/torch_video/make_fixtures.py

Writes small video files beside this script and `manifest.json`: for each
file the tool that made it, `get_video_info` as OpenCV reports it (the JAX
package's `yolo_infer_tpu.data.loader.get_video_info`) and the sha256 and
shape of every frame `cv2.VideoCapture(path)` (the FFmpeg backend) decodes
(BGR); under "raises", the files the port refuses and what it raises. The
tools:

  cv2    `cv2.VideoWriter` (OpenCV's FFmpeg backend, libavcodec's MPEG-4
         encoder under rate control: I-VOPs every 12 frames, P-VOPs between
         them) into `.mp4` and `.mov` (fourcc `mp4v`), `.mkv`, and `.avi`
         under `XVID`, `FMP4` and `DIVX`; a VP8 WebM (`VP80`); raw video in
         AVI (`I420`, `IYUV`)
  port   the port's `Mp4Writer` (AC prediction, which libavcodec's encoder
         does not use; the DC coded as an AC coefficient; quantiser 9),
         read back by OpenCV for the hashes; an MP4 whose sample entry says
         `avc1` (refused)
  hand   raw I420 AVIs of an odd width (read) and an odd height (refused);
         copies of the XVID AVI whose first video object layer header
         announces B-VOPs (`low_delay` 0: one frame of delay; the second
         group's own header ends it, and OpenCV then returns one frame
         fewer), quarter-pel motion or MPEG quantisation (read), or
         interlace (refused: OpenCV returns no frame for it), one under a
         lower-case `xvid` tag without its Lavc user data (read:
         libavcodec takes Xvid's IDCT and edge workaround), and an MP4 cut
         short (refused)

The frames are seeded: gradients under a drifting textured patch (so that
escapes and intra macroblocks in P-VOPs occur), a disc that moves fast
enough to leave the frame (motion vectors past the edge), a black bar,
and, three frames before the end, the whole picture inverted (a scene cut).

`tests/test_torch_mpeg4.py` holds the manifest to OpenCV and the port to
both; `chip_smoke.py mpeg4` holds the port to the manifest on the card's
host without importing OpenCV.
"""

import hashlib
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))

from yolo_infer_tpu.data.loader import get_video_info  # noqa: E402
from yolo_infer_tpu_torch.data.avi import AviReader, fps_ratio  # noqa: E402
from yolo_infer_tpu_torch.data.mp4 import Mp4Writer  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import USER_DATA, VOL_FIRST, VOL_LAST, Mpeg4Encoder, Vol, start_codes  # noqa: E402

# name: (tool, fourcc, (width, height), fps, frames)
VIDEOS = {
    "mp4v_176x144_2997.mp4": ("cv2", "mp4v", (176, 144), 29.97, 25),
    "mp4v_100x60_25.mov": ("cv2", "mp4v", (100, 60), 25, 19),
    "mp4v_64x48_30.mkv": ("cv2", "mp4v", (64, 48), 30, 13),
    "xvid_100x60_30.avi": ("cv2", "XVID", (100, 60), 30, 19),
    "fmp4_176x144_25.avi": ("cv2", "FMP4", (176, 144), 25, 25),
    "divx_64x48_2997.avi": ("cv2", "DIVX", (64, 48), 29.97, 13),
    "mp4v_640x480_30.mp4": ("cv2", "mp4v", (640, 480), 30, 24),
    "acpred_dcac_100x60_25.mp4": ("port", "mp4v", (100, 60), 25, 5),
    "acpred_q9_64x48_125.mov": ("port", "mp4v", (64, 48), 12.5, 5),
    "i420_64x48_25.avi": ("cv2", "I420", (64, 48), 25, 3),
    "iyuv_100x60_30.avi": ("cv2", "IYUV", (100, 60), 30, 2),
    "i420_99x60_25.avi": ("hand", "I420", (99, 60), 25, 2),
}
ROADMAP = r"ROADMAP Queue 1 item 11\.2"


def scene(n: int, h: int, w: int, seed: int):
    """`n` seeded BGR frames (see the module docstring)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(w + h - 2, 1) + 64], -1)
    tex = rng.integers(0, 256, (h // 3 + 1, w // 3 + 1, 3))
    frames = []
    for i in range(n):
        f = 255 - base if i >= n - 3 else base.copy()
        th, tw = h // 3, w // 3
        y0, x0 = h // 4 + i % 5, max(w // 2 - i, 0)
        f[y0:y0 + th, x0:x0 + tw] = tex[:min(th, h - y0), :min(tw, w - x0)]
        cy, cx = (h // 2 + 3 * i) % h, (w // 3 + 5 * i) % w
        f[(yy - cy) ** 2 + (xx - cx) ** 2 < (min(h, w) // 6) ** 2] = (20, 200, 240)
        f[h - h // 6:, :w // 4] = 0
        f[(yy * 7 + xx * 3 + i) % 11 == 0] += 1
        frames.append(np.clip(f, 0, 255).astype(np.uint8))
    return frames


def cv2_frames(path: Path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def write_video(name: str, seed: int) -> None:
    tool, fourcc, (w, h), fps, n = VIDEOS[name]
    frames = scene(n, h, w, seed)
    if tool == "hand":
        build_avi(HERE / name, [i420_planes(f) for f in frames], fourcc.encode(), w, h, fps)
        return
    if tool == "cv2":
        writer = cv2.VideoWriter(str(HERE / name), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
    else:  # the encoder's own options, which no program caller sets
        writer = Mp4Writer(HERE / name, fps, (w, h))
        options = {"dc_vlc": False} if name.startswith("acpred_dcac") else {"quant": 9}
        writer.encoder = Mpeg4Encoder(w, h, fps, **options)
    assert writer.isOpened(), name
    for f in frames:
        writer.write(f)
    writer.release()


def i420_planes(frame_bgr: np.ndarray) -> bytes:
    """A BGR frame as one raw I420 frame: the Y plane, then U and V of
    (ceil(h / 2), ceil(w / 2)) samples (an odd size converted at the even
    size above it and cropped)."""
    h, w = frame_bgr.shape[:2]
    even = np.pad(frame_bgr, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
    yuv = cv2.cvtColor(even, cv2.COLOR_BGR2YUV_I420).reshape(-1)
    H, W = even.shape[:2]
    y = yuv[: H * W].reshape(H, W)
    u = yuv[H * W: H * W * 5 // 4].reshape(H // 2, W // 2)
    v = yuv[H * W * 5 // 4:].reshape(H // 2, W // 2)
    return y[:h, :w].tobytes() + u.tobytes() + v.tobytes()


def vol_bits(width: int, height: int, resolution: int, low_delay=1, quarter_sample=0, interlaced=0,
             quant_type=0) -> bytes:
    """A video object layer unit (start code included) with the given flags."""
    bits = []

    def put(value, n):
        bits.extend((value >> (n - 1 - k)) & 1 for k in range(n))

    verid = 2 if quarter_sample else 1
    put(0, 1); put(1, 8); put(1, 1); put(verid, 4); put(1, 3); put(1, 4)
    put(1, 1); put(1, 2); put(low_delay, 1); put(0, 1); put(0, 2)
    put(1, 1); put(resolution, 16); put(1, 1); put(0, 1)
    put(1, 1); put(width, 13); put(1, 1); put(height, 13); put(1, 1)
    put(interlaced, 1); put(1, 1); put(0, 1 if verid == 1 else 2); put(0, 1)
    put(quant_type, 1)
    if quant_type:
        put(0, 2)  # no intra or non-intra matrix loaded
    if verid != 1:
        put(quarter_sample, 1)
    put(1, 1); put(1, 1); put(0, 1)
    if verid != 1:
        put(0, 2)
    put(0, 1)
    put(0, 1)
    while len(bits) % 8:
        put(1, 1)
    return b"\x00\x00\x01\x20" + bytes(int("".join(map(str, bits[k:k + 8])), 2) for k in range(0, len(bits), 8))


def build_avi(path: Path, packets, fourcc: bytes, w: int, h: int, fps: float, extra: bytes = b"") -> None:
    """A one-stream AVI of `packets`, with `extra` after strf's BITMAPINFOHEADER."""
    def chunk(fcc, body):
        return fcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)

    rate, scale = fps_ratio(fps)
    strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", fourcc, 0, 0, 0, 0, scale, rate, 0, len(packets), 0,
                       0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40 + len(extra), w, h, 1, 24, fourcc, w * h * 3, 0, 0, 0, 0) + extra
    avih = struct.pack("<14I", round(1e6 / fps), 0, 0, 0x10, len(packets), 0, 1, 0, w, h, 0, 0, 0, 0)
    hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + chunk(b"LIST", b"strl" + chunk(b"strh", strh)
                                                                 + chunk(b"strf", strf)))
    movi, idx = b"movi", b""
    for p in packets:
        idx += b"00dc" + struct.pack("<III", 0x10, len(movi), len(p))
        movi += chunk(b"00dc", p)
    body = b"AVI " + hdrl + chunk(b"LIST", movi) + chunk(b"idx1", idx)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def relabel_sample_entry(path: Path, kind: bytes) -> None:
    """Rename the `mp4v` sample entry of a port-written MP4 (its moov comes last)."""
    data = bytearray(path.read_bytes())
    at = data.index(b"mp4v", data.rindex(b"stsd"))
    data[at:at + 4] = kind
    path.write_bytes(bytes(data))


def write_vp8() -> None:
    """A VP8 WebM from OpenCV's writer (`tests/torch_vp8/` holds the VP8 decoder's own fixtures)."""
    writer = cv2.VideoWriter(str(HERE / "vp8_64x48.webm"), cv2.VideoWriter_fourcc(*"VP80"), 25, (64, 48))
    assert writer.isOpened()
    for f in scene(4, 48, 64, 90):
        writer.write(f)
    writer.release()


def write_refused():
    """The hand-made copies: ({refused name: (exception, regex)}, [names read])."""
    raises, read = {}, []
    frames = scene(4, 48, 64, 90)
    writer = Mp4Writer(HERE / "avc1_entry_64x48.mp4", 25, (64, 48))
    for f in frames:
        writer.write(f)
    writer.release()
    relabel_sample_entry(HERE / "avc1_entry_64x48.mp4", b"avc1")
    raises["avc1_entry_64x48.mp4"] = ("NotImplementedError", f"'avc1'.*{ROADMAP}")
    source = AviReader(HERE / "xvid_100x60_30.avi")
    packets = list(source.packets())
    code, start, end = next(u for u in start_codes(packets[0]) if VOL_FIRST <= u[0] <= VOL_LAST)
    vol = Vol(packets[0][start:end])
    for name, flags in (("low_delay0", {"low_delay": 0}), ("quarter_sample", {"quarter_sample": 1}),
                        ("interlaced", {"interlaced": 1}), ("quant_type1", {"quant_type": 1})):
        first = packets[0][:start - 4] + vol_bits(vol.width, vol.height, vol.time_resolution, **flags) \
            + packets[0][end:]
        file = f"{name}_100x60.avi"
        build_avi(HERE / file, [first] + packets[1:], b"XVID", vol.width, vol.height, 30)
        if name == "interlaced":
            raises[file] = ("NotImplementedError", f"interlaced.*returns no frame.*{ROADMAP}")
        else:
            read.append(file)
    # the XVID AVI under a lower-case `xvid` tag without its Lavc user data:
    # libavcodec upper-cases the tag and takes Xvid's IDCT (it keeps it when
    # the second group's Lavc user data comes)
    first = b"".join(packets[0][s - 4:e] for c, s, e in start_codes(packets[0]) if c != USER_DATA)
    build_avi(HERE / "xvid_lowercase_no_userdata_100x60.avi", [first] + packets[1:], b"xvid", vol.width,
              vol.height, 30)
    read.append("xvid_lowercase_no_userdata_100x60.avi")
    build_avi(HERE / "i420_99x61.avi", [i420_planes(f) for f in scene(2, 61, 99, 91)], b"I420", 99, 61, 25)
    raises["i420_99x61.avi"] = ("NotImplementedError", f"odd height.*{ROADMAP}")  # swscale's scaled path
    data = (HERE / "mp4v_176x144_2997.mp4").read_bytes()
    (HERE / "truncated_176x144.mp4").write_bytes(data[:len(data) * 2 // 3])
    raises["truncated_176x144.mp4"] = ("ValueError", "truncated")
    return raises, read


def manifest_entry(name: str, tool: str) -> dict:
    frames = cv2_frames(HERE / name)
    return {"tool": tool, "info": get_video_info(HERE / name), "shape": list(frames[0].shape),
            "frames": [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]}


def main() -> None:
    files = {}
    write_vp8()
    for seed, name in enumerate(list(VIDEOS) + ["vp8_64x48.webm"]):
        if name in VIDEOS:
            write_video(name, seed)
        files[name] = manifest_entry(name, VIDEOS[name][0] if name in VIDEOS else "cv2")
        n = len(files[name]["frames"])
        assert n == files[name]["info"]["frame_count"] == VIDEOS.get(name, (0,) * 4 + (4,))[4], (name, files[name])
    raises, read = write_refused()
    for name in read:
        files[name] = manifest_entry(name, "hand")
    manifest = {"files": files, "raises": {k: {"error": e, "match": m} for k, (e, m) in raises.items()}}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.iterdir() if p.suffix != ".py")
    print(f"{len(files)} videos, {len(raises)} refused files, {total} bytes")


if __name__ == "__main__":
    main()
