"""MPEG-4 Part 2 Advanced Simple Profile, DivX and old libavcodec streams, and H.263 in the port (`data/mpeg4.py`,
`data/mpeg4_motion.py`, `data/h263.py`) against OpenCV, the JAX package and libavcodec.

The fixtures in `tests/torch_mpeg4/` come from libavcodec's own `mpeg4`
and `h263` encoders through ctypes (`tests/torch_mpeg4/make_fixtures.py`):
B-VOPs, 4MV, quarter-pel, MPEG quantisation, dquant, video packets and
data partitioning, loaded matrices, the header extension and a not-coded
VOP spliced in, Xvid, DivX and old libavcodec user data (their bug
workarounds; DivX's packed B-frames) in AVI, MP4 and Matroska, H.263 in
AVI and 3GP and as `cv2.VideoWriter('H263')` writes it in AVI and MOV, and
the short video header under an MPEG-4 tag. The manifest holds the sha256
of every frame OpenCV's FFmpeg backend decodes, which the JAX package's
`load_video` returns; libavcodec's decoder, driven through ctypes from the
copy OpenCV bundles, gives the Y, U and V planes (skipped where it is
missing). The demo tests hold the frames each demo drew on (equal) and
what it drew (detections within 1e-2 px and 1e-5, as
`tests/test_torch_mpeg4.py`) over the first `DEMO_FRAMES` frames of the
640x480 Xvid file and over a packed DivX file, both demos serving the
golden detect model from one fused checkpoint.
"""

import hashlib
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_threads import TORCH_SUBPROCESS_ENV, one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_mpeg4"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(FIXTURES))  # libavcodec

import libavcodec  # noqa: E402
from test_torch_mpeg4 import cv2_packets, run_demos  # noqa: E402
from test_torch_mpeg4 import ckpts  # noqa: E402,F401  (the module-scoped fixture)
from yolo_infer_tpu.data import loader as jax_loader  # noqa: E402
from yolo_infer_tpu_torch.data.h263 import H263Decoder  # noqa: E402
from yolo_infer_tpu_torch.data.loader import get_video_info, load_video  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import Mpeg4Decoder, simple_idct, xvid_idct, yuv420_to_bgr  # noqa: E402
from yolo_infer_tpu_torch.data.video import open_video  # noqa: E402

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
VIDEOS = list(MANIFEST["files"])
REFUSED = list(MANIFEST["raises"])
DEMO = "xvid_asp_640x480.avi"
DEMO_FRAMES = 8
PACKED_DEMO = "divx_packed_64x48.avi"
# every Advanced Simple Profile case the decoder's docstring lists as decoded, and every libavcodec
# workaround taken for DivX and old libavcodec builds, and the short video header
CASES = ("b_vop", "b_direct", "b_direct_skip", "b_direct_delta", "b_direct_4mv", "b_forward", "b_backward",
         "b_interpolate", "b_colocated_skip", "inter4v_mb", "qpel_vop", "mpeg_quant_vop", "loaded_matrix_vop",
         "dquant_mb", "video_packet", "hec", "partitioned_vop", "partition_packet", "not_coded_vop",
         "xvid_idct_vop", "xvid_edge", "xvid_dc_clip", "xvid_qpel_chroma", "packed_vop", "divx_qpel_chroma",
         "divx_qpel_chroma2", "divx_edge", "divx_hpel_chroma", "lavc_std_qpel", "lavc_direct_blocksize", "lavc_edge",
         "lavc_dc_clip", "lavc_iedge", "short_header")
_DECODED = {}


def decoded(name):
    """The port's (Y, U, V) planes of a fixture, its packets and configuration, and its decoder counts (decoded once)."""
    if name not in _DECODED:
        reader = open_video(FIXTURES / name)
        packets = list(reader.packets())
        decoder = H263Decoder() if reader.codec == "h263" else Mpeg4Decoder(reader.config, reader.fourcc)
        planes = [decoder.decode(p) for p in packets] + [decoder.flush()]
        _DECODED[name] = [p for p in planes if p is not None], packets, reader, Counter(decoder.counts)
    return _DECODED[name]


@pytest.mark.parametrize("name", VIDEOS)
def test_fixture_frames_match_the_manifest(name):
    want = MANIFEST["files"][name]
    planes, _, reader, counts = decoded(name)
    assert [hashlib.sha256(yuv420_to_bgr(*p).tobytes()).hexdigest() for p in planes] == want["frames"]
    assert (list(yuv420_to_bgr(*planes[0]).shape) if planes else None) == want["shape"]
    assert reader.info() == want["info"]
    assert {k: counts[k] for k in want["reach"] if not counts[k]} == {}


@pytest.mark.parametrize("name", VIDEOS)
def test_frames_equal_the_jax_load_video(name):
    """Every frame, RGB (the demo file's first `DEMO_FRAMES`: the manifest
    test holds all of its frames)."""
    limit = DEMO_FRAMES if name == DEMO else None
    want = list(jax_loader.load_video(FIXTURES / name, rgb=True, max_frames=limit))
    got = list(load_video(FIXTURES / name, rgb=True, max_frames=limit))
    assert len(got) == len(want) == (limit or len(MANIFEST["files"][name]["frames"]))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", VIDEOS)
def test_get_video_info_equals_the_jax_package(name):
    assert get_video_info(FIXTURES / name) == jax_loader.get_video_info(FIXTURES / name)


@pytest.mark.parametrize("name", VIDEOS)
def test_demuxer_packets_equal_opencv_raw_packets(name):
    """Decoding order in every container: the packets OpenCV's FFmpeg backend hands its decoder."""
    _, mine, reader, _ = decoded(name)
    packets, _ = cv2_packets(FIXTURES / name)
    assert mine == packets and len(mine) == reader.frame_count


@pytest.mark.skipif(not libavcodec.available(), reason="needs the libavcodec OpenCV's wheel bundles")
@pytest.mark.parametrize("name", VIDEOS)
def test_planes_equal_libavcodec(name):
    """Y, U and V of every output frame, in display order, equal libavcodec's
    decoder's (`h263` for an H.263 track, else `mpeg4`) on the same packets
    under the same codec tag, a refused packet ending the input as it ends
    OpenCV's."""
    planes, packets, reader, _ = decoded(name)
    want = libavcodec.decode(packets, reader.config, reader.fourcc.encode() if reader.fourcc else None,
                             codec_name="h263" if reader.codec == "h263" else "mpeg4", stop_on_error=True)
    assert len(planes) == len(want)
    for got, ref in zip(planes, want):
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))


def _coefficient_blocks(seed: int, n: int, limit: float):
    """`n` seeded sparse and dense blocks of dequantised coefficients whose
    exact IDCT stays within +-`limit` (at most 12-bit coefficients)."""
    rng = np.random.default_rng(seed)
    basis = np.array([[np.sqrt((1 if u else 0.5) / 4) * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                      for u in range(8)])
    out = []
    while len(out) < n:
        b = np.zeros((8, 8), np.int64)
        k = rng.integers(1, 12)
        b.flat[rng.integers(0, 64, k)] = rng.integers(-2048, 2048, k) >> rng.integers(0, 6)
        if np.abs(basis.T @ b @ basis).max() <= limit:
            out.append(b)
    return np.stack(out).astype(np.int16)


@pytest.mark.skipif(not libavcodec.available(), reason="needs the libavcodec OpenCV's wheel bundles")
@pytest.mark.parametrize("algo,port_idct,limit", [("auto", simple_idct, 600.0), ("xvid", xvid_idct, 1e9)])
def test_idct_equals_libavcodec(algo, port_idct, limit):
    """The IDCT the decoder takes, against libavcodec's on this machine
    (its SIMD version): the simple one over blocks whose exact IDCT stays
    in +-600 (past it, where a row's sum leaves 16 bits, libavcodec's
    SIMD passes saturate some lanes and wrap others), Xvid's over any
    12-bit blocks, its 16-bit saturation included."""
    blocks = _coefficient_blocks(3, 3000, limit)
    assert np.array_equal(port_idct(blocks.astype(np.int32)).astype(np.int16), libavcodec.idct(blocks, algo))


def test_every_asp_case_is_met_across_the_fixtures():
    total = Counter()
    for name in VIDEOS:
        if open_video(FIXTURES / name).codec == "mpeg4":
            total.update(decoded(name)[3])
    assert {case: total[case] for case in CASES if not total[case]} == {}


@pytest.mark.parametrize("name", REFUSED)
def test_refused_files_raise_before_any_frame(name):
    want = MANIFEST["raises"][name]
    for read in (get_video_info, load_video):
        with pytest.raises(NotImplementedError, match=want["match"]):
            read(FIXTURES / name)


def test_display_order_holds_one_reference_back():
    """A B-VOP stream gives nothing for its first packet, each B-VOP at
    once, each later reference the one before it, and the last reference
    at flush; a second flush gives nothing."""
    _, packets, reader, _ = decoded("lavc_asp_176x144.avi")
    decoder = Mpeg4Decoder(reader.config, reader.fourcc)
    out = [decoder.decode(p) is not None for p in packets]
    assert out[0] is False and all(out[1:])
    assert decoder.flush() is not None and decoder.flush() is None


@pytest.fixture(scope="module")
def fused_ckpts(ckpts, tmp_path_factory):  # noqa: F811
    """The golden detect checkpoint saved fused by the port, in the JAX
    package's format: both demos serve its folded weights as stored (the JAX
    package would fold an unfused file op by op, ~5 s on the CPU)."""
    from yolo_infer_tpu_torch.core.model import YOLO11Model

    model = YOLO11Model(ckpts["detect"], device="cpu", compute_dtype=torch.float32)
    return {"detect": model.save(tmp_path_factory.mktemp("mpeg4_asp_demo") / "detect_fused.msgpack", fused=True)}


def test_detect_video_on_xvid_asp_matches_the_jax_demo(fused_ckpts, tmp_path, monkeypatch):
    (want, jax_draws, _), (got, draws, written) = run_demos(
        fused_ckpts, tmp_path, monkeypatch, FIXTURES / DEMO, "detect", "draw_detections", batch_size=4,
        max_frames=DEMO_FRAMES)
    assert got["total_frames"] == want["total_frames"] == DEMO_FRAMES == len(draws) == len(jax_draws) == len(written)
    assert got["total_detections"] == want["total_detections"]
    assert got["video_info"] == want["video_info"]
    for (frame, (boxes, scores, classes, _), out), (jframe, (jboxes, jscores, jclasses, _), _), w in zip(
            draws, jax_draws, written):
        assert np.array_equal(frame, jframe) and np.array_equal(w, out[..., ::-1])
        np.testing.assert_array_equal(classes, jclasses)
        np.testing.assert_allclose(boxes, jboxes, atol=1e-2, rtol=0)
        np.testing.assert_allclose(scores, jscores, atol=1e-5, rtol=0)


def test_detect_video_on_packed_divx_matches_the_jax_demo(fused_ckpts, tmp_path, monkeypatch):
    """The packed B-frames come out in display order through both demos."""
    n = MANIFEST["files"][PACKED_DEMO]["info"]["frame_count"]
    (want, jax_draws, _), (got, draws, written) = run_demos(
        fused_ckpts, tmp_path, monkeypatch, FIXTURES / PACKED_DEMO, "detect", "draw_detections", batch_size=4)
    assert got["total_frames"] == want["total_frames"] == n == len(draws) == len(jax_draws) == len(written)
    assert got["total_detections"] == want["total_detections"]
    assert got["video_info"] == want["video_info"]
    for (frame, (boxes, scores, classes, _), out), (jframe, (jboxes, jscores, jclasses, _), _), w in zip(
            draws, jax_draws, written):
        assert np.array_equal(frame, jframe) and np.array_equal(w, out[..., ::-1])
        np.testing.assert_array_equal(classes, jclasses)
        np.testing.assert_allclose(boxes, jboxes, atol=1e-2, rtol=0)
        np.testing.assert_allclose(scores, jscores, atol=1e-5, rtol=0)


_NO_OPENCV_CODE = """
import hashlib, json, sys
from pathlib import Path
for name in ("jax", "cv2", "yaml", "PIL", "yolo_infer_tpu"):
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
from yolo_infer_tpu_torch.data.loader import get_video_info, load_video
fixtures = Path({repo!r}) / "tests" / "torch_mpeg4"
manifest = json.loads((fixtures / "manifest.json").read_text())
for name in {names!r}:
    hashes = [hashlib.sha256(f.tobytes()).hexdigest() for f in load_video(fixtures / name, rgb=False)]
    assert hashes == manifest["files"][name]["frames"], name
    assert get_video_info(fixtures / name) == manifest["files"][name]["info"], name
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml", "PIL", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_asp_reads_without_jax_or_opencv():
    """B-VOPs with quarter-pel, loaded matrices, HEC and a not-coded VOP,
    Xvid's IDCT and workarounds, and Matroska, with jax, the JAX package,
    cv2, yaml and PIL blocked."""
    names = ["spliced_asp_64x48.avi", "xvid_b1_100x60.avi", "lavc_asp_64x48.mkv"]
    subprocess.run([sys.executable, "-I", "-c", _NO_OPENCV_CODE.format(repo=str(REPO), names=names)], check=True,
                   timeout=120, env=TORCH_SUBPROCESS_ENV)
