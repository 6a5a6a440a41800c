"""VP8 in the port (`data/vp8.py`; lossy, alpha and animated WebP in `data/webp.py`; WebM in
`data/mkv.py`; the video demo on WebM) against OpenCV, libvpx and the JAX package.

The WebM fixtures in `tests/torch_vp8/` come from `tests/torch_vp8/make_fixtures.py`
(OpenCV's `VP80` writer, and libvpx's encoder through ctypes for the syntax
that writer never emits); its manifest holds the sha256 of every frame
OpenCV's FFmpeg backend decodes, which is what the JAX package's
`load_video` returns. The lossy WebP fixtures are in `tests/torch_formats/`
(`tests/test_torch_formats.py` holds each to `cv2.imread` and the JAX
package's `load_image`). VP8 reconstruction is normative, so the port's Y, U
and V planes are also held to libvpx's decoder, through ctypes
(`tests/torch_vp8/libvpx.py`, the copy OpenCV bundles). The 640x480 file is
the card's demo input: here only its header is read.
"""

import hashlib
import json
import sys
from collections import Counter
from itertools import islice
from pathlib import Path

import cv2
import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_vp8"
FORMATS = REPO / "tests" / "torch_formats"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(FIXTURES))  # libvpx

import libvpx  # noqa: E402
from test_torch_mpeg4 import cv2_packets, run_demos  # noqa: E402,F401
from test_torch_mpeg4 import ckpts  # noqa: E402,F401  (the module-scoped fixture)
from yolo_infer_tpu.data import loader as jax_loader  # noqa: E402
from yolo_infer_tpu_torch.data import vp8, webp  # noqa: E402
from yolo_infer_tpu_torch.data.loader import get_video_info, load_image, load_video  # noqa: E402
from yolo_infer_tpu_torch.data.video import open_video  # noqa: E402

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
VIDEOS = sorted(MANIFEST["files"])
DEMO = "vp8_640x480_30.webm"
SMALL = [n for n in VIDEOS if n != DEMO]
REFUSED = sorted(MANIFEST["raises"])
FORMATS_MANIFEST = json.loads((FORMATS / "manifest.json").read_text())
LOSSY_WEBP = sorted(n for n in FORMATS_MANIFEST["files"] if n.startswith("vp8_") or "lossy" in n)
# every header and mode case the decoder's docstring lists as decoded
CASES = ("key_frame", "inter_frame", "version_0", "version_1", "version_2", "version_3", "hidden_frame",
         "segmentation", "segment_abs", "segment_delta", "segment_map", "lf_deltas", "lf_delta_update",
         "loop_filter_normal", "loop_filter_simple", "loop_filter_off", "sharpness", "partitions_1", "partitions_8",
         "quant_deltas", "probs_restored", "coef_prob_updates", "no_skip_flag", "mv_prob_updates", "refresh_golden",
         "refresh_altref", "copy_altref_2", "sign_bias_altref", "last_kept", "last", "golden", "altref", "kf_B_PRED",
         "kf_DC", "kf_V", "kf_H", "kf_TM", "intra_B_PRED", "intra_DC", "intra_H", "intra_TM", "ZERO", "NEAREST",
         "NEAR", "NEW", "SPLIT", "split_16x8", "split_8x16", "split_8x8", "split_4x4", "submv_left", "submv_above",
         "submv_zero", "submv_new", "mv_short", "mv_long", "subpel", "split_chroma") \
    + tuple(f"kf_b{m}" for m in range(10)) + tuple(f"b{m}" for m in range(10))
_DECODED = {}


def decoded(name):
    """The port's BGR frames of a WebM fixture and its decoder counts (decoded once)."""
    if name not in _DECODED:
        reader = open_video(FIXTURES / name)
        frames = list(reader.read(rgb=False))
        _DECODED[name] = frames, Counter(reader.counts)
    return _DECODED[name]


def webp_vp8_chunk(name):
    """The VP8 frame of a lossy WebP fixture (an animation's first frame)."""
    data = (FORMATS / name).read_bytes()
    chunks = dict(webp._chunks(data, 12, len(data))[::-1])
    if b"ANMF" in chunks:
        anmf = chunks[b"ANMF"]
        chunks = dict(webp._chunks(anmf, 16, len(anmf))[::-1])
    return chunks[b"VP8 "]


# ---------------------------------------------------------------- WebM


@pytest.mark.parametrize("name", SMALL)
def test_fixture_frames_match_the_manifest(name):
    frames, _ = decoded(name)
    entry = MANIFEST["files"][name]
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] == entry["frames"]
    assert list(frames[0].shape) == entry["shape"]


@pytest.mark.parametrize("name", SMALL)
def test_frames_equal_the_jax_load_video(name):
    want = list(jax_loader.load_video(FIXTURES / name, rgb=True))
    got = list(load_video(FIXTURES / name, rgb=True))
    assert len(got) == len(want) == MANIFEST["files"][name]["info"]["frame_count"]
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", VIDEOS)
def test_get_video_info_equals_the_jax_package(name):
    assert get_video_info(FIXTURES / name) == jax_loader.get_video_info(FIXTURES / name) \
        == MANIFEST["files"][name]["info"]


@pytest.mark.skipif(not libvpx.available(), reason="OpenCV's bundled libvpx is not found")
@pytest.mark.parametrize("name", SMALL)
def test_planes_equal_libvpx(name):
    """Y, U and V of every shown frame equal libvpx's decoder's; a hidden
    frame gives none in either."""
    packets = list(open_video(FIXTURES / name).packets())
    want = libvpx.decode(packets)
    decoder = vp8.Vp8Decoder()
    got = [p for p in (decoder.decode(data) for data in packets) if p is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))


@pytest.mark.parametrize("name", SMALL)
def test_demuxer_packets_equal_opencv_raw_packets(name):
    packets, extra = cv2_packets(FIXTURES / name)
    assert list(open_video(FIXTURES / name).packets()) == packets and extra == b""


def test_every_decoder_case_is_met_across_the_fixtures():
    """Each case the decoder's docstring lists as decoded occurs in some
    fixture (WebM or lossy WebP), and none of `UNREACHED`."""
    total = Counter()
    for name in SMALL:
        total.update(decoded(name)[1])
    for name in LOSSY_WEBP:
        decoder = vp8.Vp8Decoder()
        decoder.decode(webp_vp8_chunk(name))
        total.update(decoder.counts)
    assert {case: total[case] for case in CASES if not total[case]} == {}
    assert not set(total) & set(vp8.UNREACHED)


@pytest.mark.parametrize("name", REFUSED)
def test_refused_files_raise_before_any_frame(name):
    want = MANIFEST["raises"][name]
    error = {"NotImplementedError": NotImplementedError, "ValueError": ValueError}[want["error"]]
    for read in (get_video_info, load_video):
        with pytest.raises(error, match=want["match"]):
            read(FIXTURES / name)


def test_unreached_syntax_raises_before_any_frame(monkeypatch):
    """A stream that needs syntax `UNREACHED` names raises before its first
    frame, even where that syntax comes late (here the altref file's hidden
    frames, taken as unreached), and `decode` raises on such a frame."""
    monkeypatch.setitem(vp8.UNREACHED, "hidden_frame", "a hidden frame")
    frames = load_video(FIXTURES / "vp8_altref_64x48.webm")
    with pytest.raises(NotImplementedError, match=r"a hidden frame.*ROADMAP Queue 1 item 11\.2"):
        next(frames)
    packets = list(open_video(FIXTURES / "vp8_altref_64x48.webm").packets())
    hidden = next(i for i, p in enumerate(packets) if not (p[0] >> 4) & 1)
    decoder = vp8.Vp8Decoder()
    for p in packets[:hidden]:
        decoder.decode(p)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11.2"):
        decoder.decode(packets[hidden])


def test_corrupt_frames_raise_value_error():
    packets = list(open_video(FIXTURES / "vp8_176x144_30.webm").packets())
    with pytest.raises(ValueError, match="frame tag"):
        vp8.Vp8Decoder().decode(packets[0][:2])
    with pytest.raises(ValueError, match="start code"):
        vp8.Vp8Decoder().decode(packets[0][:3] + b"\0\0\0" + packets[0][6:])
    with pytest.raises(ValueError, match="first partition"):
        vp8.Vp8Decoder().decode(packets[0][:40])
    with pytest.raises(ValueError, match="before any key frame"):
        vp8.Vp8Decoder().decode(packets[1])


def test_the_demo_file_is_the_card_demo_size():
    """The 640x480 file: its header and packets only (the card decodes it).
    Key frames every 12 frames and at the scene cut three frames from the end."""
    reader = open_video(FIXTURES / DEMO)
    packets = list(reader.packets())
    keys = [i for i, p in enumerate(packets) if not p[0] & 1]
    assert (reader.width, reader.height, len(packets)) == (640, 480, 24) and keys == [0, 12, 21]
    assert 150_000 < (FIXTURES / DEMO).stat().st_size < 400_000


def test_fixtures_stay_small():
    assert sum(p.stat().st_size for p in FIXTURES.iterdir() if p.is_file()) < 600_000
    for name in SMALL:
        assert np.prod(MANIFEST["files"][name]["shape"][:2]) <= 176 * 144


# ---------------------------------------------------------------- transforms


def test_dc_only_transforms_take_the_shortcuts():
    """A block with only its DC is (dc + 4) >> 3 everywhere (libavcodec's
    DC-only add), a Y2 block with only its DC gives every Y block
    (dc + 3) >> 3."""
    blocks = np.zeros((3, 4, 4), np.int32)
    blocks[:, 0, 0] = (-2000, 5, 1023)
    out = vp8.inverse_dct(blocks)
    assert all((out[k] == (blocks[k, 0, 0] + 4) >> 3).all() for k in range(3))
    dc = vp8.inverse_wht(blocks)
    assert all((dc[k] == (blocks[k, 0, 0] + 3) >> 3).all() for k in range(3))


# ---------------------------------------------------------------- WebP


@pytest.mark.skipif(not libvpx.available(), reason="OpenCV's bundled libvpx is not found")
@pytest.mark.parametrize("name", LOSSY_WEBP)
def test_webp_planes_equal_libvpx(name):
    frame = webp_vp8_chunk(name)
    (want,) = libvpx.decode([frame])
    got = vp8.Vp8Decoder().decode(frame)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("h,w", [(1, 2), (2, 1), (2, 3), (3, 2), (5, 7), (6, 4), (16, 16), (31, 17), (18, 33)])
def test_fancy_upsampling_equals_opencv_at_small_sizes(tmp_path, h, w):
    """libwebp's upsampler at odd and even sizes: first and last rows and
    columns included."""
    img = np.random.default_rng(h * 100 + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 60])
    assert ok
    path = tmp_path / "f.webp"
    path.write_bytes(buf.tobytes())
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert np.array_equal(load_image(path, rgb=False), want)
    assert np.array_equal(load_image(path), jax_loader.load_image(path))


def test_animated_first_frame_sits_at_its_offset_on_a_zeroed_canvas():
    img = load_image(FORMATS / "vp8_anmf_offset_40x48.webp")
    small = webp.fancy_upsample_rgb(*vp8.Vp8Decoder().decode(webp_vp8_chunk("vp8_anmf_offset_40x48.webp")))
    assert img.shape == (40, 48, 3) and np.array_equal(img[4:20, 6:26], small)
    img[4:20, 6:26] = 0
    assert not img.any()


def test_alpha_is_dropped_and_a_malformed_alph_raises():
    data = bytearray((FORMATS / "vp8_alpha_37x53.webp").read_bytes())
    assert np.array_equal(load_image(FORMATS / "vp8_alpha_37x53.webp"),
                          jax_loader.load_image(FORMATS / "vp8_alpha_37x53.webp"))
    at = data.index(b"ALPH") + 8
    data[at] = 0x03  # compression method 3: none defined
    with pytest.raises(ValueError, match="ALPH"):
        webp.decode_webp(bytes(data))


# ---------------------------------------------------------------- the demo


def test_detect_video_on_webm_matches_the_jax_demo(ckpts, tmp_path, monkeypatch):  # noqa: F811
    """detect_video on VP8 WebM, batched: the frames each demo drew on are
    equal, its detections within the f32 tolerances."""
    name = "vp8_176x144_30.webm"
    (want, jax_draws, _), (got, draws, written) = run_demos(
        ckpts, tmp_path, monkeypatch, FIXTURES / name, "detect", "draw_detections", batch_size=4)
    n = MANIFEST["files"][name]["info"]["frame_count"]
    assert got["total_frames"] == want["total_frames"] == n == len(draws) == len(jax_draws) == len(written)
    assert got["total_detections"] == want["total_detections"] > 0
    assert got["video_info"] == want["video_info"]
    for (frame, (boxes, scores, classes, _), out), (jframe, (jboxes, jscores, jclasses, _), _), w in zip(
            draws, jax_draws, written):
        assert np.array_equal(frame, jframe) and np.array_equal(w, out[..., ::-1])
        np.testing.assert_array_equal(classes, jclasses)
        np.testing.assert_allclose(boxes, jboxes, atol=1e-2, rtol=0)
        np.testing.assert_allclose(scores, jscores, atol=1e-5, rtol=0)


def test_max_frames_stops_before_the_rest_is_decoded():
    got = list(islice(load_video(FIXTURES / "vp8_altref_64x48.webm", rgb=False), 3))
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in got] == \
        MANIFEST["files"]["vp8_altref_64x48.webm"]["frames"][:3]
