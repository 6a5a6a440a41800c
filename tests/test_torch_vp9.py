"""VP9 in the port (`data/vp9.py`; WebM in `data/mkv.py`; the video demo on VP9) against OpenCV, libvpx and the JAX
package.

The WebM fixtures in `tests/torch_vp9/` come from `tests/torch_vp9/make_fixtures.py`
(OpenCV's `VP90` writer, and libvpx's VP9 encoder through ctypes for an odd
width, the bilinear filter and the syntax the port refuses); its manifest
holds the sha256 of every frame OpenCV's FFmpeg backend decodes, which is
what the JAX package's `load_video` returns. VP9 reconstruction is
normative, so the port's Y, U and V planes are also held to libvpx's
decoder, through ctypes (`tests/torch_vp9/libvpx_vp9.py`, the copy OpenCV
bundles). The 640x480 file is the card's demo input: here it is decoded
from its second key frame to its first 32x64 block only (`DEMO_TAIL`).
"""

import hashlib
import json
import sys
from collections import Counter
from itertools import islice
from pathlib import Path

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_vp9"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(FIXTURES))  # libvpx_vp9

import libvpx_vp9  # noqa: E402
from test_torch_mpeg4 import cv2_packets, run_demos  # noqa: E402,F401
from test_torch_mpeg4 import ckpts  # noqa: E402,F401  (the module-scoped fixture)
from yolo_infer_tpu.data import loader as jax_loader  # noqa: E402
from yolo_infer_tpu_torch.data import vp9  # noqa: E402
from yolo_infer_tpu_torch.data.loader import get_video_info, load_video  # noqa: E402
from yolo_infer_tpu_torch.data.video import open_video  # noqa: E402

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
VIDEOS = sorted(MANIFEST["files"])
DEMO = "vp9_640x480_30.webm"
SMALL = [n for n in VIDEOS if n != DEMO]
REFUSED = sorted(MANIFEST["raises"])
DEMO_TAIL = slice(12, 17)  # the demo file's second key frame and the inter frames up to its first 32x64 block
# every header, mode and reconstruction case the decoder's docstring lists as decoded
CASES = ("profile_0", "key_frame", "inter_frame", "colour_space_0", "studio_range", "size_from_ref", "allow_hp",
         "no_hp", "filter_switchable", "filter_regular", "filter_bilinear", "refresh_frame_context", "frame_context_0",
         "lf_deltas", "lf_delta_update", "loop_filter", "loop_filter_off", "tile_cols_1", "tile_cols_2",
         "tile_cols_4", "tx_mode_2", "tx_mode_3", "tx_mode_4", "tx_selected", "tx_prob_update", "coef_prob_update",
         "coef_prob_delta", "skip_prob_update", "inter_mode_prob_update", "interp_prob_update",
         "intra_inter_prob_update", "single_ref_prob_update", "y_mode_prob_update", "partition_prob_update",
         "mv_prob_update", "partition_0", "partition_1", "partition_2", "partition_3", "skip", "ref_last",
         "ref_golden", "ref_altref", "NEAREST", "NEAR", "ZERO", "NEW", "sub8x8_NEAREST", "sub8x8_NEAR",
         "sub8x8_ZERO", "sub8x8_NEW", "switchable_regular", "switchable_smooth", "switchable_sharp",
         "mv_joint_0", "mv_joint_1", "mv_joint_2", "mv_joint_3", "mv_class0", "mv_class_n", "mv_hp_bit",
         "inter_regular", "inter_smooth", "inter_sharp", "inter_bilinear", "kf_sub8x8", "intra_sub8x8",
         "tx_4", "tx_8", "tx_16", "tx_32") \
    + tuple(f"block_{b}" for b in vp9.BLOCK_NAMES) + tuple(f"tx_type_{t}" for t in vp9.TX_TYPE_NAMES) \
    + tuple(f"{p}{m}" for p in ("kf_", "intra_", "uv_") for m in vp9.MODE_NAMES[:10]) \
    + tuple(f"refresh_slot_{i}" for i in range(8))
_DECODED = {}


def decoded(name):
    """The port's BGR frames of a WebM fixture and its decoder counts (decoded once)."""
    if name not in _DECODED:
        reader = open_video(FIXTURES / name)
        frames = list(reader.read(rgb=False))
        _DECODED[name] = frames, Counter(reader.counts)
    return _DECODED[name]


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


@pytest.mark.skipif(not libvpx_vp9.available(), reason="OpenCV's bundled libvpx is not found")
@pytest.mark.parametrize("name", SMALL)
def test_planes_equal_libvpx(name):
    """Y, U and V of every frame equal libvpx's VP9 decoder's."""
    packets = list(open_video(FIXTURES / name).packets())
    want = libvpx_vp9.decode(packets)
    decoder = vp9.Vp9Decoder()
    got = [decoder.decode(data) for data in packets]
    assert len(got) == len(want) == len(packets)
    for g, w in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))


def demo_tail():
    """The port's and libvpx's planes of the demo file's `DEMO_TAIL`, and the port's decoder counts (decoded once)."""
    if DEMO not in _DECODED:
        packets = list(open_video(FIXTURES / DEMO).packets())[DEMO_TAIL]
        decoder = vp9.Vp9Decoder()
        got = [decoder.decode(data) for data in packets]
        want = libvpx_vp9.decode(packets) if libvpx_vp9.available() else None
        _DECODED[DEMO] = got, want, Counter(decoder.counts)
    return _DECODED[DEMO]


@pytest.mark.skipif(not libvpx_vp9.available(), reason="OpenCV's bundled libvpx is not found")
def test_demo_file_from_its_second_key_frame_equals_libvpx():
    """The 640x480 file (two tile columns) from its second key frame on:
    every frame's planes equal libvpx's, up to its first 32x64 block."""
    got, want, counts = demo_tail()
    assert len(got) == len(want) == DEMO_TAIL.stop - DEMO_TAIL.start
    for g, w in zip(got, want):
        assert all(np.array_equal(a, b) for a, b in zip(g, w))
    assert counts["tile_cols_2"] == len(got) and counts["block_32x64"] and counts["key_frame"] == 1


@pytest.mark.parametrize("name", SMALL)
def test_demuxer_packets_equal_opencv_raw_packets(name):
    packets, extra = cv2_packets(FIXTURES / name)
    assert list(open_video(FIXTURES / name).packets()) == packets and extra == b""


def test_every_decoder_case_is_met_across_the_fixtures():
    """Each case the decoder's docstring lists as decoded occurs in some
    fixture (the demo file from its second key frame on among them), and
    none of `UNREACHED`."""
    total = Counter(demo_tail()[2])
    for name in SMALL:
        total.update(decoded(name)[1])
    assert {case: total[case] for case in CASES if not total[case]} == {}
    assert not set(total) & set(vp9.UNREACHED)


@pytest.mark.parametrize("name", REFUSED)
def test_refused_files_raise_before_any_frame(name):
    want = MANIFEST["raises"][name]
    error = {"NotImplementedError": NotImplementedError, "ValueError": ValueError}[want["error"]]
    for read in (get_video_info, load_video):
        with pytest.raises(error, match=want["match"]):
            read(FIXTURES / name)


def test_unreached_syntax_raises_before_any_frame(monkeypatch):
    """A stream that needs syntax `UNREACHED` names raises before its first
    frame, even where that syntax comes late (here the 176x144 file's first
    motion vector probability update, in its last frame, taken as
    unreached), and `decode` raises on such a frame."""
    packets = list(open_video(FIXTURES / "vp9_176x144_30.webm").packets())
    decoder = vp9.Vp9Decoder()
    for p in packets[:13]:
        decoder.decode(p)
    assert not decoder.counts["mv_prob_update"]
    monkeypatch.setitem(vp9.UNREACHED, "mv_prob_update", "a motion vector probability update")
    with pytest.raises(NotImplementedError, match=r"motion vector probability update.*ROADMAP Queue 1 item 11\.2"):
        next(load_video(FIXTURES / "vp9_176x144_30.webm"))
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 11\.2"):
        decoder.decode(packets[13])


def test_corrupt_frames_raise_value_error():
    packets = list(open_video(FIXTURES / "vp9_176x144_30.webm").packets())
    key = packets[0]
    with pytest.raises(ValueError, match="frame marker"):
        vp9.Vp9Decoder().decode(bytes([key[0] & 0x3F]) + key[1:])
    with pytest.raises(ValueError, match="sync code"):
        vp9.Vp9Decoder().decode(key[:1] + b"\0\0\0" + key[4:])
    with pytest.raises(ValueError, match="runs past"):
        vp9.Vp9Decoder().decode(key[:6])
    with pytest.raises(ValueError, match="before any key frame"):
        vp9.Vp9Decoder().decode(packets[1])
    with pytest.raises(ValueError):
        vp9.Vp9Decoder().decode(b"")


def test_the_demo_file_is_the_card_demo_size():
    """The 640x480 file: its headers and packets only (the card decodes it).
    Two tile columns, key frames every 12 frames."""
    reader = open_video(FIXTURES / DEMO)
    packets = list(reader.packets())
    keys = [i for i, p in enumerate(packets) if not (p[0] >> 2) & 1]
    assert (reader.width, reader.height, len(packets)) == (640, 480, 24) and keys == [0, 12]
    decoder = vp9.Vp9Decoder()
    decoder.check_stream(packets)
    assert decoder.counts["tile_cols_2"] == len(packets)
    assert 150_000 < (FIXTURES / DEMO).stat().st_size < 400_000


def test_fixtures_stay_small():
    assert sum(p.stat().st_size for p in FIXTURES.iterdir() if p.is_file()) < 500_000
    for name in SMALL:
        assert np.prod(MANIFEST["files"][name]["shape"][:2]) <= 1280 * 64


def test_superframe_index_is_found():
    """A superframe's index (its marker byte at both ends) gives its frames' sizes; plain frames have none."""
    packets, _ = cv2_packets(FIXTURES / "vp9_altref_176x144.webm")  # the port's reader refuses the file
    sizes = [vp9.superframe_sizes(p) for p in packets]
    found = [(p, s) for p, s in zip(packets, sizes) if s]
    assert found and all(len(p) == sum(s) + 2 + len(s) * (((p[-1] >> 3) & 3) + 1) for p, s in found)
    assert vp9.superframe_sizes(list(open_video(FIXTURES / "vp9_64x48_25.webm").packets())[0]) is None


# ---------------------------------------------------------------- transforms


@pytest.mark.parametrize("tx", range(4))
def test_dc_only_transforms_equal_the_dc_shortcut(tx):
    """A block with only its DC is libvpx's DC-only add everywhere:
    round14(round14(dc * c16) * c16) rounded by the size's final shift."""
    c16 = 11585
    dcs = np.array([-4000, -37, 0, 5, 1023, 2900])
    blocks = np.zeros((len(dcs), 4 << tx, 4 << tx), np.int64)
    blocks[:, 0, 0] = dcs
    out = vp9.inverse_transform(blocks, tx, vp9.DCT_DCT)
    a = (((dcs * c16 + 8192) >> 14) * c16 + 8192) >> 14
    shift = (4, 5, 6, 6)[tx]
    want = (a + (1 << (shift - 1))) >> shift
    assert all((out[k] == want[k]).all() for k in range(len(dcs)))


@pytest.mark.parametrize("tx,tx_type", [(t, k) for t in range(3) for k in range(4)] + [(3, 0)])
def test_inverse_transforms_are_near_orthonormal(tx, tx_type):
    """The integer transforms invert their float basis to within rounding:
    each basis block's output has the energy of one coefficient, and two
    of them are nearly orthogonal."""
    n = 4 << tx
    eye = np.zeros((n * n, n, n), np.int64)
    eye[np.arange(n * n), np.arange(n * n) // n, np.arange(n * n) % n] = 4096
    out = vp9.inverse_transform(eye, tx, tx_type).reshape(n * n, -1).astype(np.float64)
    gram = out @ out.T
    diag = np.diag(gram)
    assert np.allclose(diag, diag.mean(), rtol=0.02)
    assert np.abs(gram - np.diag(diag)).max() < 0.02 * diag.mean()


# ---------------------------------------------------------------- the demo


def test_detect_video_on_vp9_matches_the_jax_demo(ckpts, tmp_path, monkeypatch):  # noqa: F811
    """detect_video on VP9 WebM, batched: the frames each demo drew on are
    equal, its detections within the f32 tolerances."""
    name = "vp9_64x48_25.webm"
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


def test_max_frames_stops_before_the_rest_is_decoded():
    got = list(islice(load_video(FIXTURES / "vp9_176x144_30.webm", rgb=False), 3))
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in got] == \
        MANIFEST["files"]["vp9_176x144_30.webm"]["frames"][:3]
