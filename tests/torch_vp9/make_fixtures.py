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
          high-precision vectors, zero vector differences), a two-pass
          encode with an automatic altref (superframes with hidden frames,
          compound prediction, frame context 1), error resilience,
          frame-parallel mode off (backward adaptation), lossless coding,
          AQ mode 3 (segmentation), a real-time encode with AQ mode 3 and
          an active map (segments that skip, with their own loop filter
          level), six layers of automatic altrefs (frame contexts 1-3,
          show_existing_frame), frames with compound prediction in every
          block (two-pass altref layers at a coarse fixed quantiser; one
          with frame-parallel mode off), the library's own defaults at 352x288
          (two passes, automatic altref, lag 25, every other control
          unset: the manifest records what libvpx chose), and refused: an
          odd height (swscale converts it through its scaled path)
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
from yolo_infer_tpu_torch.data.mkv import VP9_CODEC_ID, MatroskaWriter, MkvReader  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import bgr_to_yuv420  # noqa: E402
from yolo_infer_tpu_torch.data.vp9 import Vp9Decoder  # noqa: E402

ROADMAP = r"ROADMAP Queue 1 item 11\.2"
ACTIVE_MAP = np.ones((9, 11), np.uint8)  # 176x144 by 16x16 block: the left quarter and a bottom-right corner inactive
ACTIVE_MAP[:, :4] = 0
ACTIVE_MAP[6:, 8:] = 0
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
    "vp9_altref_176x144.webm": ("libvpx", (176, 144), 25, 20, 300, {"altref": True}),
    "vp9_errres_176x144.webm": ("libvpx", (176, 144), 25, 4, 301, {"error_resilient": True}),
    "vp9_nofp_176x144.webm": ("libvpx", (176, 144), 25, 4, 302, {"frame_parallel": False}),
    "vp9_lossless_64x48.webm": ("libvpx", (64, 48), 25, 3, 303, {"lossless": True}),
    "vp9_aq_176x144.webm": ("libvpx", (176, 144), 25, 4, 304, {"aq_mode": 3}),
    "vp9_activemap_176x144.webm": ("libvpx", (176, 144), 25, 6, 308,
                                   {"speed": 7, "realtime": True, "aq_mode": 3, "active_map": ACTIVE_MAP}),
    "vp9_layers_176x144.webm": ("libvpx", (176, 144), 25, 32, 307, {"altref": 6, "quantizer": 40}),
    "vp9_default_352x288.webm": ("libvpx", (352, 288), 30, 30, 306,
                                 {"altref": True, "speed": None, "frame_parallel": None}),
    # compound prediction in every block of some frames (reference mode COMPOUND_REFERENCE)
    "vp9_compound_96x80.webm": ("libvpx", (96, 80), 25, 22, 475,
                                {"altref": 6, "aq_mode": 0, "speed": 3, "quantizer": 62}),
    "vp9_compound_64x64.webm": ("libvpx", (64, 64), 25, 9, 806,
                                {"altref": 3, "aq_mode": 3, "speed": 8, "quantizer": 57, "frame_parallel": None}),
    "vp9_compound_nofp_96x48.webm": ("libvpx", (96, 48), 25, 24, 590,
                                     {"altref": 1, "aq_mode": 0, "speed": 7, "quantizer": 63,
                                      "frame_parallel": False}),
    "vp9_compound_96x96.webm": ("libvpx", (96, 96), 25, 13, 246,
                                {"altref": 3, "aq_mode": 1, "speed": 6, "quantizer": 63}),
}
DEFAULTS = "vp9_default_352x288.webm"
# name: ((width, height), frames, seed, libvpx options, what it raises)
REFUSED = {
    "vp9_99x61.webm": ((99, 61), 3, 305, {}, "odd height"),
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


def libvpx_choices(path: Path) -> dict:
    """What the encoder chose where its controls were left unset, from the
    stream's frame headers (read by the port's decoder)."""
    decoder = Vp9Decoder()
    decoder.check_stream(MkvReader(path).packets())
    n = decoder.counts
    return {"frames": n["profile_0"], "hidden_frames": n["hidden_frame"], "superframes": n["superframe"],
            "frame_parallel_decoding_mode": int(not n["backward_adaptation"]),
            "compound_prediction_frames": n["compound"], "frame_contexts": sorted(
                int(k[-1]) for k in n if k.startswith("frame_context_"))}


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
    files[DEFAULTS]["libvpx_chose"] = libvpx_choices(HERE / DEFAULTS)
    raises = {}
    for name, ((w, h), n, seed, options, what) in REFUSED.items():
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
