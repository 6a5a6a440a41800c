"""VP9 in the port (`data/vp9.py`; WebM in `data/mkv.py`; the video demo on VP9) against OpenCV, libvpx and the JAX
package.

The WebM fixtures in `tests/torch_vp9/` come from `tests/torch_vp9/make_fixtures.py`
(OpenCV's `VP90` writer, and libvpx's VP9 encoder through ctypes for an odd
width, the bilinear filter, what libvpx writes outside OpenCV's one
setting and its own defaults, and what the port refuses); its manifest
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
DEFAULTS = "vp9_default_352x288.webm"  # libvpx's own defaults: two passes, an automatic altref, lag 25
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
         "tx_4", "tx_8", "tx_16", "tx_32", "superframe", "hidden_frame", "show_existing_frame", "prev_frame_mvs",
         "error_resilient", "keep_frame_context", "frame_context_1", "frame_context_2", "frame_context_3",
         "backward_adaptation", "compound", "compound_only", "reference_select", "comp_inter_prob_update",
         "ref_compound", "inter_compound", "segmentation", "seg_update_map", "seg_temporal_update", "seg_update_data", "seg_alt_q",
         "seg_alt_lf", "seg_skip", "seg_predicted", "seg_coded", "lossless", "tx_mode_0", "tx_mode_1") \
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
    got = [planes for planes in map(decoder.decode, packets) if planes is not None]
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


def test_compound_only_frames_decode_and_adapt_their_compound_counts_only():
    """Frames in reference mode COMPOUND_REFERENCE decode (libvpx's planes:
    `test_planes_equal_libvpx`), the frame-parallel-off one with backward
    adaptation after them; a forward update of the compound reference
    probabilities stays refused."""
    assert "compound_only" not in vp9.UNREACHED and "comp_ref_prob_update" in vp9.UNREACHED
    counts = decoded("vp9_compound_nofp_96x48.webm")[1]
    assert counts["compound_only"] and counts["backward_adaptation"]
    assert all(decoded(n)[1]["compound_only"] for n in SMALL if n.startswith("vp9_compound_"))


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
    """The folder stays under 500 kB, and each decoded file under 1280x64
    pixels but the one at libvpx's defaults, at 352x288 (CIF)."""
    assert sum(p.stat().st_size for p in FIXTURES.iterdir() if p.is_file()) < 500_000
    for name in SMALL:
        assert np.prod(MANIFEST["files"][name]["shape"][:2]) <= (352 * 288 if name == DEFAULTS else 1280 * 64)


def test_superframe_index_is_found():
    """A superframe's index (its marker byte at both ends) gives its frames' sizes; plain frames have none."""
    packets, _ = cv2_packets(FIXTURES / "vp9_altref_176x144.webm")
    sizes = [vp9.superframe_sizes(p) for p in packets]
    found = [(p, s) for p, s in zip(packets, sizes) if s]
    assert found and all(len(p) == sum(s) + 2 + len(s) * (((p[-1] >> 3) & 3) + 1) for p, s in found)
    assert all(b"".join(vp9.split_superframe(p)) == p[:sum(s)] for p, s in found)
    assert vp9.superframe_sizes(list(open_video(FIXTURES / "vp9_64x48_25.webm").packets())[0]) is None
    with pytest.raises(ValueError, match="superframe"):
        vp9.split_superframe(found[0][0][:sum(found[0][1]) // 2] + found[0][0][sum(found[0][1]):])


def test_hidden_altrefs_give_no_frame_and_no_vectors():
    """The two-pass altref file: 20 blocks hold 22 frames; its 2 hidden
    altrefs give no frame, and the frame after each (shown in the same
    superframe) does not take the hidden one's vectors: every other inter
    frame takes its predecessor's."""
    frames, counts = decoded("vp9_altref_176x144.webm")
    packets = list(open_video(FIXTURES / "vp9_altref_176x144.webm").packets())
    assert (len(packets), len(frames), counts["profile_0"]) == (20, 20, 22)
    assert counts["hidden_frame"] == counts["superframe"] == 2
    assert counts["prev_frame_mvs"] == counts["inter_frame"] - counts["hidden_frame"] == 19


def test_show_existing_frame_outputs_its_slot():
    """The altref-layers file: a one-byte frame shows a slot again (the
    altref decoded hidden earlier), decodes nothing and leaves the
    stream's state alone."""
    packets = list(open_video(FIXTURES / "vp9_layers_176x144.webm").packets())
    decoder = vp9.Vp9Decoder()
    shown = []
    for p in packets:
        if len(p) == 1:
            slot = p[0] & 7  # frame marker, profile 0, show_existing_frame, then the slot
            before = (*decoder.contexts, decoder.prev, decoder.seg_map, decoder.last_key)
            planes = decoder.decode(p)
            assert all(np.array_equal(a, b) for a, b in zip(planes, decoder.slots[slot]))
            after = (*decoder.contexts, decoder.prev, decoder.seg_map, decoder.last_key)
            assert all(x is y for x, y in zip(before, after))
            shown.append(slot)
        else:
            decoder.decode(p)
    assert len(shown) == decoder.counts["show_existing_frame"] > 0


def test_frame_parallel_streams_do_not_tally(monkeypatch):
    """OpenCV's files (frame-parallel) decode through the token loop that
    does not count; a stream that adapts counts every token."""
    def fail(*args):
        raise AssertionError("a frame-parallel stream reached the counting token loop")

    monkeypatch.setattr(vp9, "_coefs_tallied", fail)
    decoder = vp9.Vp9Decoder()
    for p in open_video(FIXTURES / "vp9_176x144_30.webm").packets():
        decoder.decode(p)
    with pytest.raises(AssertionError, match="counting token loop"):
        next(load_video(FIXTURES / "vp9_nofp_176x144.webm"))


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


def _iwht4x4_direct(block):
    """libvpx's vpx_iwht4x4_16_add as written: its two passes over one
    block of dequantised coefficients, element by element."""
    out = [[0] * 4 for _ in range(4)]
    for i in range(4):
        a, c, d, b = (int(v) >> 2 for v in block[i])
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        out[i] = [a, b, c, d]
    res = np.zeros((4, 4), np.int64)
    for i in range(4):
        a, c, d, b = (out[k][i] for k in range(4))
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        res[:, i] = (a, b, c, d)
    return res


def test_walsh_hadamard_inverse_equals_the_lifting_steps():
    """The batched lossless inverse equals libvpx's two passes of lifting
    steps, evaluated one element at a time, on dequantised (x4) blocks."""
    rng = np.random.default_rng(24)
    blocks = rng.integers(-300, 300, (64, 4, 4)) * 4
    blocks[:8, 1:, :] = 0
    blocks[:4, 0, 1:] = 0  # DC only (libvpx's vpx_iwht4x4_1_add gives the same)
    got = vp9.inverse_transform(blocks, 0, vp9.WHT_WHT)
    assert all((got[k] == _iwht4x4_direct(blocks[k])).all() for k in range(len(blocks)))


def test_probability_merges_equal_hand_worked_counts():
    """libvpx's merge_probs and its tree form on counts worked by hand."""
    # a mode or vector probability: prob(3 of 4) = 770 // 4 = 192, factor 128 * 4 // 20 = 25
    assert vp9.merge_prob(128, 3, 1) == (128 * 231 + 192 * 25 + 128) >> 8 == 134
    assert vp9.merge_prob(77, 0, 0) == 77
    # a coefficient probability: 40 counts saturate at 24; factor 112, or 128 after a key frame
    assert vp9.merge_prob(200, 10, 30, 24, 112) == (200 * 144 + 64 * 112 + 128) >> 8 == 141
    assert vp9.merge_prob(200, 10, 30, 24, 128) == (200 * 128 + 64 * 128 + 128) >> 8 == 132
    assert vp9.merge_prob(200, 1, 0, 24, 112) == (200 * 252 + 255 * 4 + 128) >> 8 == 201  # prob 256 clipped to 255
    # the inter-mode tree (ZERO | NEAREST | NEAR, NEW) over counts by offset (NEAREST 4, NEAR 0, ZERO 6, NEW 10)
    out = [0, 0, 0]
    assert vp9.merge_tree((-2, 2, 0, 4, -1, -3), [50, 150, 100], [4, 0, 6, 10], out) == 20
    assert out == [(50 * 128 + 77 * 128 + 128) >> 8, (150 * 167 + 73 * 89 + 128) >> 8, (100 * 192 + 1 * 64 + 128) >> 8]
    assert out == [64, 123, 75]


def test_compound_average_rounds_half_up():
    first, second = np.array([0, 1, 254, 255, 10, 7]), np.array([1, 2, 255, 255, 13, 7])
    assert vp9.compound_average(first, second).tolist() == [1, 2, 255, 255, 12, 7]


# ---------------------------------------------------------------- the demo


@pytest.mark.parametrize("name", ["vp9_64x48_25.webm", DEFAULTS])
def test_detect_video_on_vp9_matches_the_jax_demo(ckpts, tmp_path, monkeypatch, name):  # noqa: F811
    """detect_video on VP9 WebM, batched: the frames each demo drew on are
    equal, its detections within the f32 tolerances. At libvpx's defaults
    a superframe's hidden altref draws nothing: the demo counts OpenCV's
    frames."""
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
