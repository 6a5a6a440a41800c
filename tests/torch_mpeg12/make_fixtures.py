"""Write the fixtures of the port's MPEG-1 and MPEG-2 decoder (`data/mpeg12.py`), of H.263 under the tags the demuxers added, and their manifest.

    python tests/torch_mpeg12/make_fixtures.py

Writes small video files beside this script and `manifest.json`: for each
file the tool that made it, `get_video_info` as OpenCV reports it (the JAX
package's `yolo_infer_tpu.data.loader.get_video_info`), the sha256 and
shape of every frame `cv2.VideoCapture(path)` (the FFmpeg backend) decodes
(BGR), and the decoder tallies (`reach`) the file must reach; under
"raises", the files the port refuses, what it raises and how many frames
OpenCV reads of each. The frames are `tests/torch_video/make_fixtures.py
scene`, blurred (`smooth`) where the bytes matter. The tools:

  cv2      `cv2.VideoWriter` with the fourccs `PIM1` and `mpg1` (MPEG-1)
           and `MPEG` and `mpg2` (MPEG-2, with B pictures) into `.avi`,
           `.mkv`, `.mp4` and `.mov` (a `.mov` under `MPEG` is MPEG-1:
           `m1v `; under `mpg2` `m2v1`), and `H263` and `U263` into `.avi`
           and `.mkv`; the 640x480 `MPEG` AVI is the video demo's input on
           the card (`chip_smoke.py mpeg12`)
  lavc     libavcodec's `mpeg1video` and `mpeg2video` encoders through
           ctypes (`tests/torch_mpeg4/libavcodec.py`) where OpenCV's settings
           do not reach: MPEG-1 with B pictures, `intra_vlc`,
           `intra_dc_precision` 9 to 11 (`dc`), `q_scale_type` 1
           (`non_linear_quant`), a still scene (skipped macroblocks in P and
           B pictures), sizes that are not a multiple of 16, quantiser 1
           (escapes), the BT.709 and FCC colour matrices, and 29.97 fps in
           Matroska and MP4 (libavformat's muxers)
  splice   an encode with its headers rewritten: the alternate scan and
           `progressive_frame` 0 in a progressive sequence, loaded matrices
           in the sequence header (MPEG-1) and in a quant matrix extension
           (MPEG-2, luma and chroma), a stream cut at its second I picture
           (an open GOP's B pictures without their past reference, which
           libavcodec drops)
  synth    `synth.py`'s random streams of the syntax no bundled encoder
           writes (slices inside and across rows, macroblock stuffing and
           escapes, concealment motion vectors, levels coded by the escapes
           at random)
  refused  interlaced MPEG-2 (`+ildct+ilme`: field prediction and field
           DCT; and an interlaced frame of an interlaced sequence, which
           OpenCV returns no image of), 4:2:2, an MPEG-1 D-picture, MPEG-1
           `full_pel` vectors, an odd height, the YCgCo colour matrix

`tests/test_torch_mpeg12.py` holds the port to the manifest, to the JAX
package and to libavcodec's decoder; `chip_smoke.py mpeg12` holds it to
the manifest on the card's host without OpenCV.
"""

import hashlib
import importlib.util
import json
import random
import re
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
from yolo_infer_tpu_torch.data.mpeg12_tables import DEFAULT_INTRA_MATRIX, ZIGZAG  # noqa: E402
from yolo_infer_tpu_torch.data.video import open_video  # noqa: E402

# tests/torch_mpeg4/make_fixtures.py, for `smooth`, under another name
_spec = importlib.util.spec_from_file_location("mpeg4_fixtures", REPO / "tests" / "torch_mpeg4" / "make_fixtures.py")
mpeg4_fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mpeg4_fixtures)
smooth = mpeg4_fixtures.smooth

ROADMAP = r"ROADMAP Queue 1 item 11\.2"
DEMO = "mpeg2_640x480.avi"  # the video demo's input on the card
DEMO_FRAMES = 12
# name: (fourcc, (width, height), frames, scene seed, tallies it must reach)
CV2_VIDEOS = {
    "pim1_128x96.avi": ("PIM1", (128, 96), 6, 800, ["mpeg1_picture", "i_picture", "p_picture", "skipped_mb_p"]),
    "pim1_128x96.mkv": ("PIM1", (128, 96), 5, 801, ["mpeg1_picture", "p_picture"]),
    "pim1_128x96.mp4": ("PIM1", (128, 96), 5, 802, ["mpeg1_picture", "p_picture"]),
    "pim1_128x96.mov": ("PIM1", (128, 96), 5, 803, ["mpeg1_picture", "p_picture"]),
    "mpg1_96x64.avi": ("mpg1", (96, 64), 4, 804, ["mpeg1_picture"]),
    "mpeg_128x96.avi": ("MPEG", (128, 96), 7, 805, ["mpeg2_picture", "b_picture", "bidirectional_mb",
                                                     "backward_mb", "skipped_mb_b", "mismatch_toggle"]),
    "mpeg_128x96.mkv": ("MPEG", (128, 96), 6, 806, ["mpeg2_picture", "b_picture"]),
    "mpeg_128x96.mp4": ("MPEG", (128, 96), 6, 807, ["mpeg2_picture", "b_picture"]),
    "mpeg_128x96.mov": ("MPEG", (128, 96), 5, 808, ["mpeg1_picture"]),
    "mpg2_96x64.avi": ("mpg2", (96, 64), 5, 809, ["mpeg2_picture"]),
    "mpg2_96x64.mov": ("mpg2", (96, 64), 5, 810, ["mpeg2_picture", "b_picture"]),
    DEMO: ("MPEG", (640, 480), DEMO_FRAMES, 530, ["mpeg2_picture", "i_picture", "p_picture", "b_picture"]),
    "h263_128x96.mkv": ("H263", (128, 96), 4, 811, ["i_picture", "p_picture"]),
    "u263_128x96.avi": ("U263", (128, 96), 4, 812, ["i_picture", "p_picture"]),
    "u263_128x96.mkv": ("U263", (128, 96), 4, 813, ["i_picture", "p_picture"]),
}
# name: (codec, (width, height), frames, scene seed, blur, encoder options, tallies it must reach)
LAVC_VIDEOS = {
    "mpeg1_b_176x144.avi": ("mpeg1video", (176, 144), 8, 820, True, {"bf": 2, "g": 6, "tcplx_mask": 0.8},
                            ["mpeg1_picture", "b_picture", "bidirectional_mb", "forward_mb", "backward_mb",
                             "skipped_mb_b", "intra_mb_in_pb", "not_coded_mb", "quant_mb"]),
    "mpeg1_escape_64x48.avi": ("mpeg1video", (64, 48), 4, 821, False, {"qmin": 1, "qmax": 1, "g": 3},
                               ["escape_8", "escape_16"]),
    "mpeg2_escape_64x48.avi": ("mpeg2video", (64, 48), 4, 822, False, {"qmin": 1, "qmax": 1, "g": 3},
                               ["escape_12"]),
    "mpeg2_ivlc_dc9_100x60.avi": ("mpeg2video", (100, 60), 6, 823, True, {"intra_vlc": 1, "dc": 9, "bf": 2},
                                  ["intra_vlc_picture", "dc_precision_9", "b_picture"]),
    "mpeg2_nlq_dc10_64x48.avi": ("mpeg2video", (64, 48), 5, 824, False,
                                 {"non_linear_quant": 1, "qmax": 28, "dc": 10, "bf": 1, "scplx_mask": 0.8},
                                 ["q_scale_type_picture", "dc_precision_10", "quant_mb"]),
    "mpeg2_dc11_80x48.avi": ("mpeg2video", (80, 48), 5, 825, True, {"dc": 11, "bf": 1}, ["dc_precision_11"]),
    "mpeg2_still_64x48.avi": ("mpeg2video", (64, 48), 7, 826, "still", {"bf": 2, "g": 7},
                              ["skipped_mb_p", "skipped_mb_b", "no_mc_mb"]),
    "mpeg1_still_98x62.avi": ("mpeg1video", (98, 62), 6, 827, "still", {"bf": 1, "g": 6},
                              ["skipped_mb_p", "skipped_mb_b"]),
    "mpeg2_bt709_64x48.avi": ("mpeg2video", (64, 48), 3, 828, True, {"colorspace": "bt709"},
                              ["matrix_coefficients_1"]),
    "mpeg2_fcc_64x48.avi": ("mpeg2video", (64, 48), 3, 829, True, {"colorspace": "fcc"}, ["matrix_coefficients_4"]),
    "mpeg2_2997_128x96.mkv": ("mpeg2video", (128, 96), 6, 830, True, {"bf": 2}, ["b_picture"]),
    "mpeg2_2997_128x96.mp4": ("mpeg2video", (128, 96), 6, 831, True, {"bf": 2}, ["b_picture"]),
}
FOURCC_OF = {"mpeg1video": b"PIM1", "mpeg2video": b"MPEG"}
# name: (codec, (width, height), frames, seed, encoder options, splice, tallies it must reach)
SPLICED_VIDEOS = {
    "mpeg2_alternate_64x48.avi": ("mpeg2video", (64, 48), 5, 840, {"bf": 1}, "alternate", ["alternate_picture"]),
    "mpeg2_pf0_64x48.avi": ("mpeg2video", (64, 48), 4, 841, {"bf": 1}, "progressive_frame_0",
                            ["progressive_frame_0"]),
    "mpeg1_matrix_64x48.avi": ("mpeg1video", (64, 48), 5, 842, {"bf": 1}, "sequence_matrices",
                               ["loaded_matrix_sequence"]),
    "mpeg2_qmatrix_64x48.avi": ("mpeg2video", (64, 48), 5, 843, {"bf": 1}, "quant_matrix_extension",
                                ["quant_matrix_extension"]),
    "mpeg2_open_gop_64x48.avi": ("mpeg2video", (64, 48), 12, 844, {"bf": 2, "g": 6}, "cut",
                                 ["b_picture_dropped"]),
}
# name: (MPEG-2, (width, height), pictures, seed, tallies it must reach): `synth.py` streams
SYNTH_VIDEOS = {
    "synth_mpeg1_560x32.avi": (False, (560, 32), 6, 861, ["mb_stuffing", "mb_escape", "escape_16", "skipped_mb_b"]),
    "synth_mpeg2_80x48.avi": (True, (80, 48), 6, 860, ["concealment_vector", "alternate_picture",
                                                       "q_scale_type_picture", "intra_vlc_picture", "dc_precision_11"]),
}
# name: (codec, (width, height), encoder options, splice, what it raises)
REFUSED_VIDEOS = {
    "mpeg2_interlaced_64x48.avi": ("mpeg2video", (64, 48), {"flags": "+ildct+ilme", "bf": 1}, None,
                                   "field prediction and field DCT"),
    "mpeg2_interlaced_frame_64x48.avi": ("mpeg2video", (64, 48), {"bf": 1}, "interlaced_frame", "an interlaced frame"),
    "mpeg2_422_64x48.avi": ("mpeg2video", (64, 48), {}, "chroma_422", "chroma format 4:2:2"),
    "mpeg1_dpicture_64x48.avi": ("mpeg1video", (64, 48), {}, "d_picture", "D-picture"),
    "mpeg1_fullpel_64x48.avi": ("mpeg1video", (64, 48), {}, "full_pel", "full_pel"),
    "mpeg2_odd_height_64x47.avi": ("mpeg2video", (64, 48), {}, "odd_height", "an odd height"),
    "mpeg2_ycgco_64x48.avi": ("mpeg2video", (64, 48), {"colorspace": "ycgco"}, None, "matrix_coefficients 8"),
}


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


def frames_of(n: int, w: int, h: int, seed: int, blur) -> list:
    """The scene's BGR frames; a still scene is its first frame with a small square moving over it."""
    frames = scene(n, h, w, seed)
    if blur == "still":
        still = smooth(frames[:1])[0]
        frames = []
        for i in range(n):
            f = still.copy()
            f[4:12, 4 + 2 * i:12 + 2 * i] = (30, 220, 90)
            frames.append(f)
        return frames
    return smooth(frames) if blur else frames


def encode(codec: str, w: int, h: int, n: int, seed: int, blur, options: dict, fps=(25, 1)):
    return libavcodec.encode([bgr_to_yuv420(f) for f in frames_of(n, w, h, seed, blur)], w, h, fps=fps,
                             codec_name=codec, **options)


# ------------------------------------------------------------ header splices


def _bits(data: bytes) -> str:
    return "".join(f"{b:08b}" for b in data)


def _bytes(bits: str) -> bytes:
    return int(bits, 2).to_bytes(len(bits) // 8, "big")


def edit_units(packet: bytes, code: int, edit) -> bytes:
    """Each `00 00 01 code` unit's payload (up to the next start code) through `edit`."""
    out, pos = [], 0
    for m in re.finditer(b"\x00\x00\x01" + bytes([code]), packet):
        start = m.end()
        nxt = packet.find(b"\x00\x00\x01", start)
        end = len(packet) if nxt < 0 else nxt
        if start < pos:
            continue
        out += [packet[pos:start], edit(packet[start:end])]
        pos = end
    return b"".join(out) + packet[pos:]


def set_bits(payload: bytes, at: int, value: str, kind=None) -> bytes:
    """payload with the bits from `at` replaced by `value` (an extension's only if its id is `kind`)."""
    if kind is not None and payload[0] >> 4 != kind:
        return payload
    b = _bits(payload)
    return _bytes(b[:at] + value + b[at + len(value):])


def matrix_bits(rng: random.Random, intra: bool) -> str:
    """A loaded matrix in zigzag order: each default value moved by up to a
    quarter (the encode's levels were chosen for the defaults; values much
    larger make IDCT outputs whose 16-bit lanes libavcodec's SIMD IDCT wraps,
    a case `simple_idct` does not model)."""
    default = DEFAULT_INTRA_MATRIX if intra else [16] * 64
    return "".join(f"{max(1, round(default[z] * rng.uniform(0.75, 1.25))):08b}" for z in ZIGZAG)


def splice(packets, how: str, rng: random.Random):
    """The packets with their headers rewritten as `how` says."""
    if how == "alternate":  # picture coding extension: alternate_scan (bit 29)
        return [edit_units(p, 0xB5, lambda u: set_bits(u, 29, "1", 8)) for p in packets]
    if how == "progressive_frame_0":  # progressive_frame (bit 32) in a progressive sequence
        return [edit_units(p, 0xB5, lambda u: set_bits(u, 32, "0", 8)) for p in packets]
    if how == "interlaced_frame":  # progressive_sequence (bit 12 of the sequence extension) and progressive_frame 0
        return [edit_units(edit_units(p, 0xB5, lambda u: set_bits(u, 12, "0", 1)), 0xB5,
                           lambda u: set_bits(u, 32, "0", 8)) for p in packets]
    if how == "chroma_422":  # chroma_format (bits 13-14 of the sequence extension)
        return [edit_units(p, 0xB5, lambda u: set_bits(u, 13, "10", 1)) for p in packets]
    if how == "d_picture":  # picture_coding_type (bits 10-12) of the I pictures
        return [edit_units(p, 0x00, lambda u: set_bits(u, 10, "100") if _bits(u)[10:13] == "001" else u)
                for p in packets]
    if how == "full_pel":  # full_pel_forward_vector (bit 29) of the P pictures
        return [edit_units(p, 0x00, lambda u: set_bits(u, 29, "1") if _bits(u)[10:13] == "010" else u)
                for p in packets]
    if how == "odd_height":  # vertical_size_value (bits 12-23) one less
        return [edit_units(p, 0xB3, lambda u: set_bits(u, 12, f"{int(_bits(u)[12:24], 2) - 1:012b}"))
                for p in packets]
    if how == "sequence_matrices":  # both matrices loaded (the intra one's first value, 16, taken as 8)
        intra = "00010000" + matrix_bits(rng, True)[8:]
        inter = matrix_bits(rng, False)
        return [edit_units(p, 0xB3, lambda u: _bytes(_bits(u)[:62] + "1" + intra + "1" + inter)) for p in packets]
    if how == "quant_matrix_extension":  # after each picture coding extension: all four matrices
        ext = b"\x00\x00\x01\xb5" + _bytes("0011" + "".join("1" + matrix_bits(rng, k % 2 == 0) for k in range(4)))

        def add(p):
            at = [m.start() for m in re.finditer(b"\x00\x00\x01\xb5", p) if p[m.end()] >> 4 == 8][0]
            nxt = p.find(b"\x00\x00\x01", at + 4)
            return p[:nxt] + ext + p[nxt:]
        return [add(p) for p in packets]
    if how == "cut":  # from the second I picture on
        kinds = [re.search(b"\x00\x00\x01\x00", p) for p in packets]
        firsts = [k for k, m in enumerate(kinds) if _bits(packets[k][m.end():m.end() + 2])[10:13] == "001"]
        return packets[firsts[1]:]
    raise ValueError(how)


def write_cv2(path: Path, fourcc: str, w: int, h: int, n: int, seed: int) -> None:
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
    assert writer.isOpened(), path
    for f in smooth(scene(n, h, w, seed)):
        writer.write(f)
    writer.release()


def main() -> None:
    assert libavcodec.available(), "needs the libavcodec OpenCV's wheel bundles"
    for old in HERE.iterdir():
        if old.suffix in (".avi", ".mp4", ".mkv", ".mov"):
            old.unlink()
    made = {}
    for name, (fourcc, (w, h), n, seed, reach) in CV2_VIDEOS.items():
        write_cv2(HERE / name, fourcc, w, h, n, seed)
        made[name] = ("cv2", reach)
    for name, (codec, (w, h), n, seed, blur, options, reach) in LAVC_VIDEOS.items():
        if "2997" in name:
            e = encode(codec, w, h, n, seed, blur, options, fps=(30000, 1001))
            libavcodec.mux(HERE / name, e, "matroska" if name.endswith(".mkv") else "mp4")
        else:
            e = encode(codec, w, h, n, seed, blur, options)
            build_avi(HERE / name, [p[0] for p in e.packets], FOURCC_OF[codec], w, h, 25)
        made[name] = ("lavc", reach)
    for name, (codec, (w, h), n, seed, options, how, reach) in SPLICED_VIDEOS.items():
        e = encode(codec, w, h, n, seed, True, options)
        packets = splice([p[0] for p in e.packets], how, random.Random(seed))
        build_avi(HERE / name, packets, FOURCC_OF[codec], w, h, 25)
        made[name] = ("splice", reach)
    for name, (mpeg2, (w, h), n, seed, reach) in SYNTH_VIDEOS.items():
        rng = random.Random(seed)
        packets = synth.stream(rng, mpeg2, w, h, synth.kinds_of(rng, n))
        build_avi(HERE / name, packets, FOURCC_OF["mpeg2video" if mpeg2 else "mpeg1video"], w, h, 25)
        made[name] = ("synth", reach)
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
        files[name] = {"tool": tool, "info": info, "shape": list(frames[0].shape), "frames": hashes, "reach": reach}
    raises = {}
    for name, (codec, (w, h), options, how, match) in REFUSED_VIDEOS.items():
        e = encode(codec, w, h, 3, 850, True, options)
        packets = [p[0] for p in e.packets]
        if how:
            packets = splice(packets, how, random.Random(850))
        build_avi(HERE / name, packets, FOURCC_OF[codec], w, h - (how == "odd_height"), 25)
        raises[name] = {"error": "NotImplementedError", "match": f"{re.escape(match)}.*{ROADMAP}",
                        "cv2_frames": len(cv2_frames(HERE / name))}
    manifest = {"libavcodec": libavcodec.version(), "files": files, "raises": raises}
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    total = sum(p.stat().st_size for p in HERE.iterdir() if p.is_file() and p.suffix != ".pyc")
    print(f"{len(files)} videos, {len(raises)} refused files, {total} bytes")


if __name__ == "__main__":
    main()
