"""Write the VP9 WebM fixtures of the port's decoder (`data/vp9.py`) and their manifest.

    python tests/torch_vp9/make_fixtures.py

Writes small WebM files beside this script and `manifest.json`: for each
file the tool that made it, `get_video_info` as OpenCV reports it (the JAX
package's `yolo_infer_tpu.data.loader.get_video_info`) and the sha256 and
shape of every frame `cv2.VideoCapture(path)` (the FFmpeg backend) decodes
(BGR); under "raises", the files the port refuses and what it raises. The
tools:

  cv2     `cv2.VideoWriter(..., 'VP90')` (libvpx at OpenCV's FFmpeg
          settings: profile 0, a key frame every 12 frames, frame-parallel
          mode, tile columns by width: one at 176 wide, two at 512 and
          640, four at 1280)
  libvpx  libvpx's VP9 encoder through ctypes (`libvpx_vp9.py`), muxed by
          the port's `data/mkv.py MatroskaWriter`: an odd width (OpenCV's
          writer rounds it down), the real-time speed 9 that codes inter
          frames with the bilinear filter, a coarse quantiser (no
          high-precision vectors, zero vector differences); and refused:
          a two-pass encode with an automatic altref (superframes with
          hidden frames), error resilience, frame-parallel mode off
          (backward adaptation), lossless coding, AQ mode 3
          (segmentation), an odd height (swscale converts it through its
          scaled path)
  hand    the 176x144 file cut short (refused)

The 640x480 file is the video demo's input on the card (`chip_smoke.py
vp9`); the CPU tests decode it from its second key frame only. The frames are
`tests/torch_video/make_fixtures.py scene`.
"""

import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(REPO / "tests" / "torch_video"))

import libvpx_vp9  # noqa: E402
from make_fixtures import scene  # noqa: E402  (tests/torch_video)
from yolo_infer_tpu.data.loader import get_video_info  # noqa: E402
from yolo_infer_tpu_torch.data.mkv import VP9_CODEC_ID, MatroskaWriter  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import bgr_to_yuv420  # noqa: E402

ROADMAP = r"ROADMAP Queue 1 item 11\.2"
# name: (tool, (width, height), fps, frames, seed, libvpx options)
VIDEOS = {
    "vp9_64x48_25.webm": ("cv2", (64, 48), 25, 12, 200, {}),
    "vp9_176x144_30.webm": ("cv2", (176, 144), 30, 14, 201, {}),
    "vp9_1280x64_30.webm": ("cv2", (1280, 64), 30, 5, 202, {}),
    "vp9_640x480_30.webm": ("cv2", (640, 480), 30, 24, 203, {}),
    "vp9_512x64_30.webm": ("cv2", (512, 64), 30, 4, 206, {}),
    "vp9_99x60.webm": ("libvpx", (99, 60), 25, 6, 204, {}),
    "vp9_bilinear_176x144.webm": ("libvpx", (176, 144), 25, 6, 205, {"speed": 9, "realtime": True}),
    "vp9_coarse_256x192.webm": ("libvpx", (256, 192), 25, 8, 7, {"speed": 2, "quantizer": 50}),
}
# name: ((width, height), frames, libvpx options, what it raises)
REFUSED = {
    "vp9_altref_176x144.webm": ((176, 144), 20, {"altref": True}, "superframe index"),
    "vp9_errres_176x144.webm": ((176, 144), 4, {"error_resilient": True}, "error_resilient_mode 1"),
    "vp9_nofp_176x144.webm": ((176, 144), 4, {"frame_parallel": False}, "backward probability adaptation"),
    "vp9_lossless_64x48.webm": ((64, 48), 3, {"lossless": True}, "lossless"),
    "vp9_aq_176x144.webm": ((176, 144), 4, {"aq_mode": 3}, "segmentation"),
    "vp9_99x61.webm": ((99, 61), 3, {}, "odd height"),
}


def i420(frame_bgr: np.ndarray) -> np.ndarray:
    return np.concatenate([p.reshape(-1) for p in bgr_to_yuv420(frame_bgr)])


def write_libvpx(path: Path, w: int, h: int, fps: float, n: int, seed: int, options: dict) -> None:
    packets = libvpx_vp9.encode([i420(f) for f in scene(n, h, w, seed)], w, h, **options)
    out = MatroskaWriter(path, "webm", VP9_CODEC_ID, b"", w, h, fps)
    for data, key in packets:  # a superframe carries its hidden frame: one block, one time slot
        out.add(data, key)
    out.release()


def write_cv2(path: Path, w: int, h: int, fps: float, n: int, seed: int) -> None:
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"VP90"), fps, (w, h))
    assert writer.isOpened(), path
    for f in scene(n, h, w, seed):
        writer.write(f)
    writer.release()


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


def main() -> None:
    files = {}
    for name, (tool, (w, h), fps, n, seed, options) in VIDEOS.items():
        if tool == "cv2":
            write_cv2(HERE / name, w, h, fps, n, seed)
        else:
            write_libvpx(HERE / name, w, h, fps, n, seed, options)
        frames = cv2_frames(HERE / name)
        info = get_video_info(HERE / name)
        assert len(frames) == info["frame_count"] == n, (name, len(frames), info)
        files[name] = {"tool": tool, "info": info, "shape": list(frames[0].shape),
                       "frames": [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]}
    raises = {}
    for seed, (name, ((w, h), n, options, what)) in enumerate(REFUSED.items(), start=300):
        write_libvpx(HERE / name, w, h, 25, n, seed, options)
        raises[name] = ("NotImplementedError", f"{what}.*{ROADMAP}")
    data = (HERE / "vp9_176x144_30.webm").read_bytes()
    (HERE / "vp9_truncated_176x144.webm").write_bytes(data[:len(data) * 2 // 3])
    raises["vp9_truncated_176x144.webm"] = ("ValueError", "truncated")
    manifest = {"libvpx": libvpx_vp9.version(), "files": files,
                "raises": {k: {"error": e, "match": m} for k, (e, m) in raises.items()}}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.iterdir() if p.suffix == ".webm")
    print(f"{len(files)} videos, {len(raises)} refused files, {total} bytes")


if __name__ == "__main__":
    main()
