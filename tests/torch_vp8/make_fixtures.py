"""Write the VP8 WebM fixtures of the port's decoder (`data/vp8.py`) and their manifest.

    python tests/torch_vp8/make_fixtures.py

Writes small WebM files beside this script and `manifest.json`: for each
file the tool that made it, `get_video_info` as OpenCV reports it (the JAX
package's `yolo_infer_tpu.data.loader.get_video_info`) and the sha256 and
shape of every frame `cv2.VideoCapture(path)` (the FFmpeg backend) decodes
(BGR); under "raises", the files the port refuses and what it raises. The
tools:

  cv2     `cv2.VideoWriter(..., 'VP80')` (libvpx at OpenCV's FFmpeg
          settings: version 0, one token partition, a key frame every 12
          frames, golden and altref references without hidden frames); the
          VP9 files are `tests/torch_vp9/`'s
  libvpx  libvpx's encoder through ctypes (`libvpx.py`), muxed by the
          port's `data/mkv.py MatroskaWriter`: versions 1, 2 and 3
          (bilinear prediction, the simple loop filter, whole-pixel
          chroma), 8 token partitions, error resilience (probabilities
          restored, segmentation), filter sharpness 5, a two-pass encode
          with an automatic altref (hidden frames, refresh_last 0, the
          altref's sign bias), an odd width, and an odd height (refused:
          swscale converts it through its scaled path)
  hand    the 176x144 file cut short (refused)

The 640x480 file is the video demo's input on the card (`chip_smoke.py
vp8`); the CPU tests read its header only. The frames are
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

import libvpx  # noqa: E402
from make_fixtures import scene  # noqa: E402  (tests/torch_video)
from yolo_infer_tpu.data.loader import get_video_info  # noqa: E402
from yolo_infer_tpu_torch.data.mkv import VP8_CODEC_ID, MatroskaWriter  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import bgr_to_yuv420  # noqa: E402

ROADMAP = r"ROADMAP Queue 1 item 11\.2"
# name: (tool, (width, height), fps, frames, libvpx options)
VIDEOS = {
    "vp8_176x144_30.webm": ("cv2", (176, 144), 30, 14, {}),
    "vp8_640x480_30.webm": ("cv2", (640, 480), 30, 24, {}),
    "vp8_version1_64x48.webm": ("libvpx", (64, 48), 25, 8, {"profile": 1}),
    "vp8_version2_64x48.webm": ("libvpx", (64, 48), 25, 8, {"profile": 2}),
    "vp8_version3_64x48.webm": ("libvpx", (64, 48), 25, 8, {"profile": 3}),
    "vp8_parts8_64x48.webm": ("libvpx", (64, 48), 25, 8, {"partitions": 3}),
    "vp8_errres_64x48.webm": ("libvpx", (64, 48), 25, 8, {"error_resilient": True}),
    "vp8_sharp5_64x48.webm": ("libvpx", (64, 48), 25, 8, {"sharpness": 5}),
    "vp8_altref_64x48.webm": ("libvpx", (64, 48), 25, 40, {"altref": True}),
    "vp8_99x60.webm": ("libvpx", (99, 60), 25, 6, {}),
}


def i420(frame_bgr: np.ndarray) -> np.ndarray:
    return np.concatenate([p.reshape(-1) for p in bgr_to_yuv420(frame_bgr)])


def write_libvpx(path: Path, w: int, h: int, fps: float, n: int, seed: int, options: dict) -> None:
    packets = libvpx.encode([i420(f) for f in scene(n, h, w, seed)], w, h, **options)
    shown = np.array([(p[0] >> 4) & 1 for p, _ in packets])
    slots = (np.cumsum(shown) - shown).tolist()  # a hidden frame takes the slot of the shown one after it
    out = MatroskaWriter(path, "webm", VP8_CODEC_ID, b"", w, h, fps)
    for (data, key), slot in zip(packets, slots):
        out.add(data, key, slot)
    out.release()


def write_cv2(path: Path, fourcc: str, w: int, h: int, fps: float, n: int, seed: int) -> None:
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
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
    for seed, (name, (tool, (w, h), fps, n, options)) in enumerate(VIDEOS.items(), start=100):
        if tool == "cv2":
            write_cv2(HERE / name, "VP80", w, h, fps, n, seed)
        else:
            write_libvpx(HERE / name, w, h, fps, n, seed, options)
        frames = cv2_frames(HERE / name)
        info = get_video_info(HERE / name)
        assert len(frames) == info["frame_count"] == n, (name, len(frames), info)
        files[name] = {"tool": tool, "info": info, "shape": list(frames[0].shape),
                       "frames": [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]}
    raises = {}
    write_libvpx(HERE / "vp8_99x61.webm", 99, 61, 25, 4, 90, {})
    raises["vp8_99x61.webm"] = ("NotImplementedError", f"odd height.*{ROADMAP}")
    data = (HERE / "vp8_176x144_30.webm").read_bytes()
    (HERE / "vp8_truncated_176x144.webm").write_bytes(data[:len(data) * 2 // 3])
    raises["vp8_truncated_176x144.webm"] = ("ValueError", "truncated")
    manifest = {"libvpx": libvpx.version(), "files": files,
                "raises": {k: {"error": e, "match": m} for k, (e, m) in raises.items()}}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.iterdir() if p.suffix == ".webm")
    print(f"{len(files)} videos, {len(raises)} refused files, {total} bytes")


if __name__ == "__main__":
    main()
