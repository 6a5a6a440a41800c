"""Microsoft's MPEG-4 family in the port (`data/msmpeg4.py`, `data/wmv2.py`; AVI, Matroska and MOV) and AV1 as the JAX package reads it, against OpenCV, libavcodec and the JAX package.

The fixtures in `tests/torch_msmpeg4/` come from
`tests/torch_msmpeg4/make_fixtures.py` (OpenCV's `DIV3`, `MP43`, `MP42`,
`WMV1` and `WMV2` writers, libavcodec's encoders through ctypes where
OpenCV's settings do not reach, `synth.py`'s random streams for the syntax
no bundled encoder writes, AV1 key frames muxed by libavformat); its
manifest holds the sha256 of every frame OpenCV's FFmpeg backend decodes,
which is what the JAX package's `load_video` returns. The planes are held
to libavcodec's decoders too (`tests/torch_mpeg4/libavcodec.py`), and
every quantiser's DC scale and division through live encodes. The two
640x480 files are the card's inputs (`chip_smoke.py msmpeg4`): here only
their first frames are decoded.
"""

import hashlib
import json
import random
import struct
import subprocess
import sys
from collections import Counter
from itertools import islice
from pathlib import Path

import numpy as np
import pytest

from torch_threads import TORCH_SUBPROCESS_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_msmpeg4"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests" / "torch_mpeg4"))  # libavcodec
sys.path.insert(0, str(REPO / "tests" / "torch_video"))  # make_fixtures.scene
sys.path.append(str(FIXTURES))  # synth

import libavcodec  # noqa: E402
import synth  # noqa: E402
from make_fixtures import scene  # noqa: E402  (tests/torch_video)
from test_torch_mpeg4 import cv2_packets, run_demos  # noqa: E402
from test_torch_mpeg4 import ckpts  # noqa: E402,F401  (the module-scoped fixture)
from yolo_infer_tpu.data import loader as jax_loader  # noqa: E402
from yolo_infer_tpu_torch.data import msmpeg4, msmpeg4_tables, wmv2  # noqa: E402
from yolo_infer_tpu_torch.data.loader import get_video_info, load_video  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import bgr_to_yuv420  # noqa: E402
from yolo_infer_tpu_torch.data.video import open_video  # noqa: E402

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
BIG = ("div3_640x480.avi", "wmv2_640x480.avi")  # the card's demo and decode-speed inputs
AV1 = sorted(n for n in MANIFEST["files"] if n.startswith("av1_"))
VIDEOS = sorted(n for n in MANIFEST["files"] if n not in AV1)
SMALL = [n for n in VIDEOS if n not in BIG]
REFUSED = sorted(MANIFEST["raises"])
CODEC_NAMES = {msmpeg4.V2: "msmpeg4v2", msmpeg4.V3: "msmpeg4", msmpeg4.WMV1: "wmv1", msmpeg4.WMV2: "wmv2"}
# every case the decoders' docstrings list as decoded
CASES = ("i_picture", "p_picture", "slice", "ext_header", "no_ext_header", "flipflop_rounding", "rounding_0",
         "rounding_1", "dc_table_0", "dc_table_1", "mv_table_0", "mv_table_1", "skip_code", "no_skip_code",
         "per_mb_rl", "per_mb_rl_picture", "inter_intra_picture", "inter_intra_mb", "dc_from_pixels", "intra_mb",
         "intra_mb_in_p", "inter_mb", "skipped_mb", "ac_pred_mb", "scan_horizontal", "scan_vertical", "escape_1",
         "escape_2", "escape_3", "dc_escape", "mv_escape", "cbp_table_0", "cbp_table_1", "cbp_table_2",
         "skip_type_0", "skip_type_1", "skipped_picture", "mspel_picture", "mspel_mb", "hshift_0", "hshift_1",
         "abt_1", "abt_2", "per_mb_abt", "loop_filter_picture") \
    + tuple(f"rl_luma_{i}" for i in range(3)) + tuple(f"rl_chroma_{i}" for i in range(3))
_DECODED = {}


def decoded(name, frames=None):
    """The port's BGR frames of a fixture (the first `frames`) and its decoder counts (decoded once)."""
    if (name, frames) not in _DECODED:
        reader = open_video(FIXTURES / name)
        got = list(islice(reader.read(rgb=False), frames))
        _DECODED[name, frames] = got, Counter(reader.counts)
    return _DECODED[name, frames]


def hashes(frames):
    return [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]


@pytest.mark.parametrize("name", SMALL)
def test_fixture_frames_match_the_manifest(name):
    want = MANIFEST["files"][name]
    frames, _ = decoded(name)
    assert hashes(frames) == want["frames"]
    assert list(frames[0].shape) == want["shape"]


@pytest.mark.parametrize("name", BIG)
def test_card_inputs_first_frames_match_the_manifest(name):
    """The 640x480 files: an I and a P picture here (the card decodes them whole)."""
    frames, counts = decoded(name, 2)
    assert hashes(frames) == MANIFEST["files"][name]["frames"][:2]
    assert counts["i_picture"] == counts["p_picture"] == 1
    reader = open_video(FIXTURES / name)
    assert (reader.width, reader.height) == (640, 480) and len(list(reader.packets())) == reader.frame_count


@pytest.mark.parametrize("name", SMALL)
def test_frames_equal_the_jax_load_video(name):
    want = list(jax_loader.load_video(FIXTURES / name, rgb=True))
    got = list(load_video(FIXTURES / name, rgb=True))
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", VIDEOS + AV1)
def test_get_video_info_equals_the_jax_package(name):
    assert get_video_info(FIXTURES / name) == jax_loader.get_video_info(FIXTURES / name) \
        == MANIFEST["files"][name]["info"]


@pytest.mark.skipif(not libavcodec.available(), reason="OpenCV's bundled libavcodec is not found")
@pytest.mark.parametrize("name", SMALL)
def test_planes_equal_libavcodec(name):
    """The port's demuxed packets through libavcodec's own decoder give the port's planes."""
    reader = open_video(FIXTURES / name)
    packets = list(reader.packets())
    want = libavcodec.decode(packets, reader.config, codec_name=CODEC_NAMES[reader.ms_version],
                             video_size=f"{reader.width}x{reader.height}")
    decoder = msmpeg4.make_decoder(reader.width, reader.height, reader.ms_version, reader.config)
    got = [f for f in map(decoder.decode, packets) if f is not None]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", [n for n in SMALL if not n.endswith(".mov")] + ["wmv2_64x48.mov"])
def test_demuxer_packets_equal_opencv_raw_packets(name):
    """Each container's packets and WMV2's extension header are OpenCV's raw ones."""
    packets, extra = cv2_packets(FIXTURES / name)
    reader = open_video(FIXTURES / name)
    assert list(reader.packets()) == packets
    assert reader.config == extra


def test_every_decoder_case_is_met_across_the_fixtures():
    total = Counter()
    for name in SMALL:
        total.update(decoded(name)[1])
    assert {case: total[case] for case in CASES if not total[case]} == {}
    assert sum(total[k] for k in total if k.startswith("escape_3_lengths_")) and \
        len([k for k in total if k.startswith("escape_3_lengths_")]) > 1


@pytest.mark.skipif(not libavcodec.available(), reason="OpenCV's bundled libavcodec is not found")
@pytest.mark.parametrize("version", sorted(CODEC_NAMES))
def test_every_quantiser_dc_path_equals_libavcodec(version):
    """An I and a P picture at each quantiser 1..31: every DC scale of the
    version's table and its division, every WMV2 joint pattern table."""
    name = CODEC_NAMES[version]
    frames = [bgr_to_yuv420(f) for f in scene(2, 32, 32, 700 + version)]
    for q in range(1, 32):
        e = libavcodec.encode(frames, 32, 32, codec_name=name, qmin=q, qmax=q)
        packets = [p[0] for p in e.packets]
        want = libavcodec.decode(packets, e.extradata, codec_name=name, video_size="32x32")
        decoder = msmpeg4.make_decoder(32, 32, version, e.extradata)
        for p, w in zip(packets, want):
            got = decoder.decode(p)
            assert all(np.array_equal(x, y) for x, y in zip(got, w)), (name, q)


def test_dc_division_is_the_x86_multiply():
    """libavcodec's reciprocal table is ceil(2^32 / i); its multiply divides
    every DC the predictor meets (0..2^16) exactly, rounded half up."""
    assert msmpeg4._INVERSE[2:] == [-(-(1 << 32) // i) for i in range(2, 257)]
    scales = set(msmpeg4_tables.OLD_Y_DC_SCALE + msmpeg4_tables.WMV1_Y_DC_SCALE + msmpeg4_tables.WMV1_C_DC_SCALE) - {0}
    a = np.arange(0, 1 << 16, dtype=np.int64)
    for s in scales:
        inv = msmpeg4._INVERSE[s]
        assert np.array_equal(((a + (s >> 1)) * inv) >> 32, (a + (s >> 1)) // s), s


@pytest.mark.skipif(not libavcodec.available(), reason="OpenCV's bundled libavcodec is not found")
@pytest.mark.parametrize("version", sorted(CODEC_NAMES))
def test_synthetic_streams_equal_libavcodec(version):
    """`synth.py` streams (slices, AC prediction, both DC and vector tables,
    per-macroblock RL tables, WMV2's mspel and ABT, ...) at a few seeds."""
    for seed in range(4):
        rng = random.Random(1000 * version + seed)
        w, h = rng.choice([32, 48, 80]), rng.choice([16, 32, 48])
        writer = synth.Synth(version, w, h, rng)
        packets = [writer.picture(k) for k in [0] + [rng.choice([0, 1, 1]) for _ in range(3)]]
        want = libavcodec.decode(packets, writer.extradata, codec_name=CODEC_NAMES[version], video_size=f"{w}x{h}")
        decoder = msmpeg4.make_decoder(w, h, version, writer.extradata)
        got = [f for f in map(decoder.decode, packets) if f is not None]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert all(np.array_equal(x, y) for x, y in zip(a, b)), (version, seed)


@pytest.mark.parametrize("name", REFUSED)
def test_refused_files_raise_before_any_frame(name):
    """The refusals, and how many frames OpenCV reads of each (the manifest's `cv2_frames`)."""
    want = MANIFEST["raises"][name]
    for read in (get_video_info, load_video):
        with pytest.raises(NotImplementedError, match=want["match"]):
            read(FIXTURES / name)
    assert len(list(jax_loader.load_video(FIXTURES / name))) == want["cv2_frames"]


def test_a_wmv2_picture_with_every_macroblock_skipped_gives_no_frame():
    reader = open_video(FIXTURES / "synth_wmv2_64x48.avi")
    frames, counts = decoded("synth_wmv2_64x48.avi")
    assert counts["skipped_picture"] == 1 and len(frames) == reader.frame_count - 1


def test_corrupt_streams_raise_value_error():
    packets = list(open_video(FIXTURES / "div3_176x144.avi").packets())
    with pytest.raises(ValueError, match="before any I picture"):
        msmpeg4.MsMpeg4Decoder(176, 144, msmpeg4.V3).decode(packets[1])
    with pytest.raises(ValueError, match="quantiser 0"):
        msmpeg4.MsMpeg4Decoder(176, 144, msmpeg4.V3).decode(bytes([packets[0][0] & 0xC1]) + packets[0][1:])
    with pytest.raises(ValueError, match="truncated|invalid|corrupt"):
        msmpeg4.MsMpeg4Decoder(176, 144, msmpeg4.V3).decode(packets[0][:40])
    with pytest.raises(ValueError, match="extension header"):
        wmv2.Wmv2Decoder(64, 48, b"\x00\x01")


@pytest.mark.parametrize("name", AV1)
def test_av1_reads_as_the_jax_package(name):
    """AV1 in WebM and MP4: OpenCV opens it and reads no frame (its bundled
    libavcodec's native decoder needs a hardware one), and so does the
    port, which has no AV1 decoder; nothing raises."""
    reader = open_video(FIXTURES / name)
    assert reader.codec in ("av1", "V_AV1")
    assert list(load_video(FIXTURES / name)) == [] == list(jax_loader.load_video(FIXTURES / name))
    assert MANIFEST["files"][name]["frames"] == []


def test_detect_video_on_av1_processes_no_frame_as_the_jax_demo(ckpts, tmp_path, monkeypatch):  # noqa: F811
    (want, jax_draws, _), (got, draws, written) = run_demos(
        ckpts, tmp_path, monkeypatch, FIXTURES / "av1_64x64.webm", "detect", "draw_detections", batch_size=4)
    assert got["total_frames"] == want["total_frames"] == 0 == len(draws) == len(jax_draws) == len(written)
    assert got["video_info"] == want["video_info"]


@pytest.mark.parametrize("name", ["div3_176x144.mkv", "wmv2_loop_100x60.avi"])
def test_detect_video_on_msmpeg4_matches_the_jax_demo(ckpts, tmp_path, monkeypatch, name):  # noqa: F811
    """detect_video on DIV3 and WMV2, batched: the frames each demo drew on
    are equal, its detections within the f32 tolerances."""
    (want, jax_draws, _), (got, draws, written) = run_demos(
        ckpts, tmp_path, monkeypatch, FIXTURES / name, "detect", "draw_detections", batch_size=4)
    n = MANIFEST["files"][name]["info"]["frame_count"]
    assert got["total_frames"] == want["total_frames"] == n == len(draws) == len(jax_draws) == len(written)
    assert got["total_detections"] == want["total_detections"]
    assert got["video_info"] == want["video_info"]
    for (frame, (boxes, scores, classes, _), out), (jframe, (jboxes, jscores, jclasses, _), _), w in zip(
            draws, jax_draws, written):
        assert np.array_equal(frame, jframe) and np.array_equal(w, out[..., ::-1])
        np.testing.assert_array_equal(classes, jclasses)
        np.testing.assert_allclose(boxes, jboxes, atol=1e-2, rtol=0)
        np.testing.assert_allclose(scores, jscores, atol=1e-5, rtol=0)


def _library_rodata():
    lib = libavcodec._LIBS["avcodec"]._name if libavcodec.available() else None
    return Path(lib).read_bytes() if lib else None


@pytest.mark.skipif(not libavcodec.available(), reason="OpenCV's bundled libavcodec is not found")
def test_tables_are_the_bundled_libavcodecs_bytes():
    """Every table of `data/msmpeg4_tables.py` is found, as libavcodec
    stores it (uint16 or uint32 code/length pairs, uint8 runs, levels,
    lengths and scans, uint16 symbols), in the bundled library."""
    data = _library_rodata()
    t = msmpeg4_tables
    packed = {name: struct.pack(f"<{len(v)}{fmt}", *v) for name, v, fmt in [
        ("RL0_VLC", t.RL0_VLC, "H"), ("RL1_VLC", t.RL1_VLC, "H"), ("RL3_VLC", t.RL3_VLC, "H"),
        ("RL4_VLC", t.RL4_VLC, "H"), ("MB_INTRA", t.MB_INTRA, "H"), ("MB_NON_INTRA_0", t.MB_NON_INTRA_0, "I"),
        ("MB_NON_INTRA_1", t.MB_NON_INTRA_1, "I"), ("MB_NON_INTRA_2", t.MB_NON_INTRA_2, "I"),
        ("MB_NON_INTRA_3", t.MB_NON_INTRA_3, "I"),
        ("DC", t.DC0_LUMA + t.DC0_CHROMA + t.DC1_LUMA + t.DC1_CHROMA, "I"),
        ("MV0_SYMBOLS", t.MV0_SYMBOLS, "H"), ("MV1_SYMBOLS", t.MV1_SYMBOLS, "H")]}
    for name in ("RL0_RUN", "RL0_LEVEL", "RL1_RUN", "RL1_LEVEL", "RL3_RUN", "RL3_LEVEL", "RL4_RUN", "RL4_LEVEL",
                 "MV0_LENGTHS", "MV1_LENGTHS", "V2_MB_TYPE", "V2_INTRA_CBPC", "INTER_INTRA", "WMV1_SCANS",
                 "WMV1_Y_DC_SCALE", "WMV1_C_DC_SCALE", "OLD_Y_DC_SCALE", "WMV2_SCAN_A", "WMV2_SCAN_B"):
        packed[name] = bytes(getattr(t, name))
    assert [name for name, b in packed.items() if b not in data] == []


def test_fixtures_stay_small():
    """The folder stays under 500 kB, and each decoded file at or under 1280x64
    pixels but the two 640x480 card inputs."""
    assert sum(p.stat().st_size for p in FIXTURES.iterdir() if p.is_file()) < 500_000
    for name in SMALL:
        assert np.prod(MANIFEST["files"][name]["shape"][:2]) <= 1280 * 64


_NO_OPENCV_CODE = """
import hashlib, json, sys
from itertools import islice
from pathlib import Path
for name in ("jax", "cv2", "yaml", "PIL", "yolo_infer_tpu"):
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
from yolo_infer_tpu_torch.data.loader import get_video_info, load_video
fixtures = Path({repo!r}) / "tests" / "torch_msmpeg4"
manifest = json.loads((fixtures / "manifest.json").read_text())
for name in {names!r}:
    hashes = [hashlib.sha256(f.tobytes()).hexdigest() for f in load_video(fixtures / name, rgb=False)]
    assert hashes == manifest["files"][name]["frames"], name
    assert get_video_info(fixtures / name) == manifest["files"][name]["info"], name
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml", "PIL", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_msmpeg4_reads_without_jax_or_opencv():
    """DIV3 in AVI, MKV and MOV, MP42, WMV1, WMV2 and AV1, with jax, the JAX
    package, cv2, yaml and PIL blocked."""
    names = ["div3_176x144.mov", "mp42_176x144.mkv", "wmv1_64x48.mov", "synth_wmv2_64x48.avi", "av1_64x64.mp4",
             "av1_64x64.webm"]
    subprocess.run([sys.executable, "-I", "-c", _NO_OPENCV_CODE.format(repo=str(REPO), names=names)], check=True,
                   timeout=300, env=TORCH_SUBPROCESS_ENV)
