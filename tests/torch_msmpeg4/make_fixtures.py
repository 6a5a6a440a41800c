"""Write the fixtures of the port's MS-MPEG-4 and WMV decoders (`data/msmpeg4.py`, `data/wmv2.py`), its AV1 files and their manifest.

    python tests/torch_msmpeg4/make_fixtures.py

Writes small video files beside this script and `manifest.json`: for each
file the tool that made it, `get_video_info` as OpenCV reports it (the JAX
package's `yolo_infer_tpu.data.loader.get_video_info`), the sha256 and
shape of every frame `cv2.VideoCapture(path)` (the FFmpeg backend) decodes
(BGR), and the decoder tallies (`counts`) the file must reach; under
"raises", the files the port refuses, what it raises and how many frames
OpenCV reads of each. The frames are `tests/torch_video/make_fixtures.py
scene`, blurred (`smooth`) where the bytes matter. The tools:

  cv2      `cv2.VideoWriter` with the fourccs `DIV3`, `MP43`, `MP42`,
           `WMV1` and `WMV2` into `.avi`, `.mkv` and `.mov` (libavcodec's
           `msmpeg4`, `msmpeg4v2`, `wmv1` and `wmv2` encoders at OpenCV's
           settings); the 640x480 `DIV3` AVI is the video demo's input on
           the card (`chip_smoke.py msmpeg4`), the 640x480 WMV2 AVI its
           second decode-speed file
  lavc     the same encoders through ctypes (`tests/torch_mpeg4/libavcodec.py`)
           where OpenCV's settings do not reach: quantisers at both ends
           of the range, widths that are not a multiple of 16, WMV1 at a
           low bit rate (its intra DCs in P pictures predicted from the
           picture's own pixels), WMV2 with the loop filter (`+loop`);
           written into AVIs by `tests/torch_video/make_fixtures.py
           build_avi`
  synth    streams of `synth.py` (random syntax no bundled encoder
           writes: slices, AC prediction, DC and vector tables 0, P
           pictures without a skip flag, WMV1's per-macroblock RL tables and
           escape 3 lengths, WMV2's skip maps, mspel, ABT, top-left vector
           prediction, per-macroblock RL tables and a fully skipped P
           picture, which gives no frame), written into AVIs
  av1      AV1 key frames (the OBUs of the AVIF OpenCV's bundled libavif
           writes) in WebM and MP4 by libavformat's muxers: OpenCV opens
           them and reads no frame, which the port matches
  refused  a v3 stream under v1's tag `MPG4`; a WMV2 stream whose second
           I picture is IntraX8 (`synth.py intrax8_picture`)

`tests/test_torch_msmpeg4.py` holds the port to the manifest, to the JAX
package and to libavcodec's decoders; `chip_smoke.py msmpeg4` holds it to
the manifest on the card's host without OpenCV.
"""

import hashlib
import importlib.util
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests" / "torch_mpeg4"))
sys.path.insert(0, str(REPO / "tests" / "torch_video"))
sys.path.append(str(HERE))  # synth, after tests/torch_video's make_fixtures

import libavcodec  # noqa: E402
import synth  # noqa: E402
from make_fixtures import build_avi, scene  # noqa: E402  (tests/torch_video)
from yolo_infer_tpu.data.loader import get_video_info  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import bgr_to_yuv420  # noqa: E402
from yolo_infer_tpu_torch.data.video import open_video  # noqa: E402

# tests/torch_mpeg4/make_fixtures.py, for `smooth`, under another name
_spec = importlib.util.spec_from_file_location("mpeg4_fixtures", REPO / "tests" / "torch_mpeg4" / "make_fixtures.py")
mpeg4_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mpeg4_fixtures)
smooth = mpeg4_fixtures.smooth

ROADMAP = r"ROADMAP Queue 1 item 11\.2, point 5"
DEMO = "div3_640x480.avi"  # the video demo's input on the card
DEMO_FRAMES = 12
WMV2_DEMO = "wmv2_640x480.avi"  # the card's second decode-speed file
# name: (fourcc, (width, height), frames, scene seed, tallies it must reach)
CV2_VIDEOS = {
    "div3_176x144.avi": ("DIV3", (176, 144), 10, 500, ["i_picture", "p_picture", "ext_header", "flipflop_rounding",
                                                       "rounding_1", "skipped_mb", "intra_mb_in_p"]),
    "div3_176x144.mkv": ("DIV3", (176, 144), 6, 501, ["i_picture", "p_picture"]),
    "div3_176x144.mov": ("DIV3", (176, 144), 6, 502, ["i_picture", "p_picture"]),
    "mp43_96x64.avi": ("MP43", (96, 64), 5, 503, ["i_picture", "p_picture"]),
    "mp42_176x144.avi": ("MP42", (176, 144), 8, 504, ["i_picture", "p_picture", "ext_header", "rounding_0"]),
    "mp42_176x144.mkv": ("MP42", (176, 144), 5, 505, ["i_picture", "p_picture"]),
    "mp42_64x48.mov": ("MP42", (64, 48), 4, 506, ["i_picture", "p_picture"]),
    "wmv1_176x144.avi": ("WMV1", (176, 144), 8, 507, ["i_picture", "p_picture", "ext_header", "rounding_1"]),
    "wmv1_176x144.mkv": ("WMV1", (176, 144), 5, 508, ["i_picture", "p_picture"]),
    "wmv1_64x48.mov": ("WMV1", (64, 48), 4, 509, ["i_picture", "p_picture"]),
    "wmv2_176x144.avi": ("WMV2", (176, 144), 8, 510, ["i_picture", "p_picture", "cbp_table_0", "rounding_1"]),
    "wmv2_176x144.mkv": ("WMV2", (176, 144), 5, 511, ["i_picture", "p_picture"]),
    "wmv2_64x48.mov": ("WMV2", (64, 48), 4, 512, ["i_picture", "p_picture"]),
    DEMO: ("DIV3", (640, 480), DEMO_FRAMES, 513, ["i_picture", "p_picture"]),
    WMV2_DEMO: ("WMV2", (640, 480), 6, 514, ["i_picture", "p_picture"]),
}
# name: (codec, (width, height), frames, scene seed, encoder options, tallies it must reach)
LAVC_VIDEOS = {
    "div3_fine_64x48.avi": ("msmpeg4", (64, 48), 6, 520, {"qmin": 1, "qmax": 2, "g": 3},
                            ["dc_escape", "escape_3", "rl_luma_1"]),
    "div3_coarse_100x60.avi": ("msmpeg4", (100, 60), 8, 521, {"qmin": 26, "qmax": 31, "g": 4},
                               ["escape_1", "mv_escape", "rl_luma_0", "rl_chroma_0"]),
    "mp42_fine_98x60.avi": ("msmpeg4v2", (98, 60), 6, 522, {"qmin": 1, "qmax": 3, "g": 3},
                            ["escape_3", "intra_mb_in_p"]),
    "wmv1_lowrate_96x64.avi": ("wmv1", (96, 64), 10, 523, {"b": 100_000, "g": 5},
                               ["inter_intra_picture", "inter_intra_mb", "dc_from_pixels"]),
    "wmv2_loop_100x60.avi": ("wmv2", (100, 60), 8, 524, {"flags": "+loop", "qmin": 21, "qmax": 31, "g": 4},
                             ["loop_filter_picture", "cbp_table_2"]),
    "wmv2_q15_64x48.avi": ("wmv2", (64, 48), 5, 525, {"qmin": 15, "qmax": 15, "g": 3}, ["cbp_table_1"]),
}
FOURCC_OF = {"msmpeg4": b"DIV3", "msmpeg4v2": b"MP42", "wmv1": b"WMV1", "wmv2": b"WMV2"}
# name: (version, (width, height), seed, pictures: 0 I, 1 P, 2 a fully skipped WMV2 P picture, 3 an I picture
# without the extension header, WMV2 flags, tallies)
SYNTH_VIDEOS = {
    "synth_mp42_80x48.avi": (2, (80, 48), 600, [0, 1, 1, 0, 1, 1], None,
                             ["ac_pred_mb", "slice", "no_skip_code", "skip_code", "escape_2"]),
    "synth_div3_80x64.avi": (3, (80, 64), 603, [0, 1, 1, 1, 3, 1, 1], None,
                             ["ac_pred_mb", "slice", "dc_table_0", "dc_table_1", "mv_table_0", "mv_table_1",
                              "no_skip_code", "mv_escape", "flipflop_rounding", "rounding_1", "no_ext_header"]),
    "synth_wmv1_64x48.avi": (4, (64, 48), 602, [0, 1, 1, 0, 1, 1, 1], None,
                             ["ac_pred_mb", "slice", "dc_table_0", "mv_table_0", "per_mb_rl", "no_skip_code"]),
    "synth_wmv2_64x48.avi": (5, (64, 48), 603, [0, 1, 1, 2, 1, 0, 1, 1, 1],
                             {"mspel_bit": 1, "loop": 1, "abt": 1, "j_type_bit": 1, "top_left": 1, "per_mb_rl_bit": 1},
                             ["ac_pred_mb", "mspel_mb", "hshift_1", "abt_1", "abt_2", "skip_type_1",
                              "skipped_picture", "loop_filter_picture", "per_mb_rl"]),
}
SYNTH_FOURCCS = {2: b"MP42", 3: b"DIV3", 4: b"WMV1", 5: b"WMV2"}


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


def write_cv2(path: Path, fourcc: str, w: int, h: int, n: int, seed: int) -> None:
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
    assert writer.isOpened(), path
    for f in smooth(scene(n, h, w, seed)):
        writer.write(f)
    writer.release()


def write_lavc(path: Path, codec: str, w: int, h: int, n: int, seed: int, options: dict):
    e = libavcodec.encode([bgr_to_yuv420(f) for f in smooth(scene(n, h, w, seed))], w, h, codec_name=codec, **options)
    build_avi(path, [p[0] for p in e.packets], FOURCC_OF[codec], w, h, 25, e.extradata)


def write_synth(path: Path, version: int, w: int, h: int, seed: int, kinds, flags) -> None:
    import random
    writer = synth.Synth(version, w, h, random.Random(seed), flags)
    packets = [writer.skipped_picture() if k == 2 else writer.picture(0 if k == 3 else k, k != 3) for k in kinds]
    build_avi(path, packets, SYNTH_FOURCCS[version], w, h, 25, writer.extradata)


def av1_key_frame(w: int, h: int) -> bytes:
    """The OBUs (temporal delimiter, sequence header, frame) of an AV1 key
    frame: the item of the AVIF OpenCV writes of a gradient."""
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 1] = np.arange(w, dtype=np.uint8)[None, :] * 3
    img[..., 2] = np.arange(h, dtype=np.uint8)[:, None] * 3
    ok, buf = cv2.imencode(".avif", img)
    assert ok
    data, pos = buf.tobytes(), 0
    while pos + 8 <= len(data):
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"mdat":
            return data[pos + 8:pos + size]
        pos += size
    raise AssertionError("no mdat in the AVIF")


def write_av1(path: Path, fmt: str, w: int, h: int, n: int) -> None:
    obus = av1_key_frame(w, h)
    assert obus[:2] == b"\x12\x00" and obus[2] >> 3 & 15 == 1  # a temporal delimiter, then the sequence header
    header = obus[2:4 + obus[3]]
    packets = [(obus, i, i, True) for i in range(n)]
    libavcodec.mux(path, libavcodec.Encoded(packets, header, (1, 25), libavcodec.parameters("av1", w, h, header)),
                   fmt)


def main() -> None:
    assert libavcodec.available(), "needs the libavcodec OpenCV's wheel bundles"
    for old in HERE.iterdir():
        if old.suffix in (".avi", ".mp4", ".mkv", ".mov", ".webm"):
            old.unlink()
    made = {}
    for name, (fourcc, (w, h), n, seed, reach) in CV2_VIDEOS.items():
        write_cv2(HERE / name, fourcc, w, h, n, seed)
        made[name] = ("cv2", reach)
    for name, (codec, (w, h), n, seed, options, reach) in LAVC_VIDEOS.items():
        write_lavc(HERE / name, codec, w, h, n, seed, options)
        made[name] = ("lavc", reach)
    for name, (version, (w, h), seed, kinds, flags, reach) in SYNTH_VIDEOS.items():
        write_synth(HERE / name, version, w, h, seed, kinds, flags)
        made[name] = ("synth", reach)
    write_av1(HERE / "av1_64x64.webm", "webm", 64, 64, 6)
    write_av1(HERE / "av1_64x64.mp4", "mp4", 64, 64, 6)
    made["av1_64x64.webm"] = made["av1_64x64.mp4"] = ("av1", [])
    files = {}
    for name, (tool, reach) in made.items():
        frames = cv2_frames(HERE / name)
        reader = open_video(HERE / name)
        mine = list(reader.read(rgb=False))
        hashes = [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]
        assert [hashlib.sha256(f.tobytes()).hexdigest() for f in mine] == hashes, name
        counts = getattr(reader, "counts", {})
        missing = [k for k in reach if not counts.get(k)]
        assert not missing, (name, missing, dict(counts))
        info = get_video_info(HERE / name)
        assert reader.info() == info, (name, reader.info(), info)
        files[name] = {"tool": tool, "info": info, "shape": list(frames[0].shape) if frames else None,
                       "frames": hashes, "reach": reach}
    raises = {}
    data = bytearray((HERE / "mp43_96x64.avi").read_bytes())
    for tag in (b"strh", b"strf"):
        at = data.index(tag) + (12 if tag == b"strh" else 24)
        data[at:at + 4] = b"MPG4"
    (HERE / "mpg4_v1_96x64.avi").write_bytes(bytes(data))
    raises["mpg4_v1_96x64.avi"] = {"error": "NotImplementedError", "match": f"MS-MPEG-4 v1.*{ROADMAP}",
                                   "cv2_frames": len(cv2_frames(HERE / "mpg4_v1_96x64.avi"))}
    import random
    writer = synth.Synth(5, 48, 32, random.Random(604), {"j_type_bit": 1})
    packets = [writer.picture(0), writer.picture(1), writer.intrax8_picture(), writer.picture(1)]
    build_avi(HERE / "wmv2_intrax8_48x32.avi", packets, b"WMV2", 48, 32, 25, writer.extradata)
    raises["wmv2_intrax8_48x32.avi"] = {"error": "NotImplementedError", "match": f"IntraX8.*{ROADMAP}",
                                        "cv2_frames": len(cv2_frames(HERE / "wmv2_intrax8_48x32.avi"))}
    manifest = {"libavcodec": libavcodec.version(), "files": files, "raises": raises}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.iterdir() if p.is_file() and p.suffix != ".pyc")
    print(f"{len(files)} videos, {len(raises)} refused files, {total} bytes")


if __name__ == "__main__":
    main()
