"""DivX and old libavcodec streams in the port's MPEG-4 decoder (`data/mpeg4.py`): packed B-frames and the bug
workarounds libavcodec takes for them.

The fixtures are `tests/torch_mpeg4/`'s (`make_fixtures.py`); the manifest
holds, for each DivX and old-build file, whether its frames change when the
port leaves each workaround out (`workarounds_change_frames`): the bundled
libavcodec is the judge of which workaround acts. A packed file must decode
to the frames of its `mpeg4_unpack_bframes` output (libavcodec's bitstream
filter), and an AVI whose placeholders are zero-length chunks must read as
OpenCV reads it.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_mpeg4"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(FIXTURES))  # libavcodec
sys.path.insert(0, str(REPO / "tests" / "torch_video"))  # make_fixtures.build_avi

import libavcodec  # noqa: E402
from make_fixtures import build_avi  # noqa: E402  (tests/torch_video)
from yolo_infer_tpu.data import loader as jax_loader  # noqa: E402
from yolo_infer_tpu_torch.data import mpeg4  # noqa: E402
from yolo_infer_tpu_torch.data.loader import get_video_info, load_video  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import Mpeg4Decoder, start_codes  # noqa: E402
from yolo_infer_tpu_torch.data.video import open_video  # noqa: E402

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
PACKED = [n for n, f in MANIFEST["files"].items() if "packed_vop" in f["reach"]]
# the small files whose workaround effects the manifest records (the 640x480 demo file aside)
EFFECTS = [n for n, f in MANIFEST["files"].items() if f.get("workarounds_change_frames") and f["shape"][0] < 200]


def planes_of(packets, config=b"", fourcc=""):
    decoder = Mpeg4Decoder(config, fourcc)
    return [p for p in [decoder.decode(d) for d in packets] + [decoder.flush()] if p is not None]


def hashes_of(planes):
    return [hashlib.sha256(mpeg4.yuv420_to_bgr(*p).tobytes()).hexdigest() for p in planes]


@pytest.mark.skipif(not libavcodec.available(), reason="needs the libavcodec OpenCV's wheel bundles")
@pytest.mark.parametrize("name", PACKED)
def test_packed_file_equals_its_unpacked_stream(name):
    """The port's frames of the packed file, and its frames of the
    `mpeg4_unpack_bframes` output (one VOP a packet, the 'p' gone), are the
    manifest's."""
    reader = open_video(FIXTURES / name)
    packets = list(reader.packets())
    assert max(sum(c == mpeg4.VOP_START for c, _, _ in start_codes(p)) for p in packets) == 2
    unpacked, extra = libavcodec.unpack_bframes(packets, reader.config)
    assert max(sum(c == mpeg4.VOP_START for c, _, _ in start_codes(p)) for p in unpacked) == 1
    want = MANIFEST["files"][name]["frames"]
    assert hashes_of(planes_of(packets, reader.config, reader.fourcc)) == want
    assert hashes_of(planes_of(unpacked, extra, reader.fourcc)) == want


@pytest.mark.parametrize("name", EFFECTS)
def test_workaround_effects_equal_the_manifest(name, monkeypatch):
    """Leaving one workaround out changes the port's frames exactly where
    the manifest says it changes them (each workaround the manifest marks
    True is needed to reach OpenCV's frames)."""
    reader = open_video(FIXTURES / name)
    packets = list(reader.packets())
    real = mpeg4.workarounds
    got = {}
    for flag in MANIFEST["files"][name]["workarounds_change_frames"]:
        def without(ids, fourcc, vol, bugs, flag=flag):
            real(ids, fourcc, vol, bugs)
            bugs.pop(flag, None)

        monkeypatch.setattr(mpeg4, "workarounds", without)
        got[flag] = hashes_of(planes_of(packets, reader.config, reader.fourcc)) != MANIFEST["files"][name]["frames"]
    monkeypatch.setattr(mpeg4, "workarounds", real)
    assert got == MANIFEST["files"][name]["workarounds_change_frames"]


def test_the_workarounds_that_act_are_each_met():
    """Each workaround that changes frames does so in some fixture: DivX's
    quarter-pel chroma 1 and 2 and edge, old builds' old quarter-pel
    filters and edge."""
    acting = {(n.split("_")[0].rstrip("0123456789"), flag) for n, f in MANIFEST["files"].items()
              for flag, on in f.get("workarounds_change_frames", {}).items() if on}
    assert {("divx", "qpel_chroma"), ("divx", "qpel_chroma2"), ("divx", "edge"), ("lavc", "std_qpel"),
            ("lavc", "edge"), ("xvid", "edge"), ("xvid", "qpel_chroma")} <= acting


def test_zero_length_chunks_read_as_opencv_reads_them(tmp_path):
    """DivX placeholders written as zero-length chunks: OpenCV's reader skips
    them, so the stored B-VOP gives way to the next packed P-VOP, which is
    lost; the port's frames, frame count and info equal the JAX package's."""
    reader = open_video(FIXTURES / "divx_packed_64x48.avi")
    packets = [b"" if len(p) <= mpeg4.MAX_NVOP_SIZE else p for p in reader.packets()]
    assert packets.count(b"") >= 2
    path = tmp_path / "divx_empty_chunks_64x48.avi"
    build_avi(path, packets, b"DX50", 64, 48, 25)
    want = list(jax_loader.load_video(path, rgb=True))
    got = list(load_video(path, rgb=True))
    assert 0 < len(got) == len(want) < len(packets)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert get_video_info(path) == jax_loader.get_video_info(path)
    assert get_video_info(path)["frame_count"] == len(packets)


def test_a_low_delay_stream_ending_in_a_placeholder_repeats_its_last_frame():
    """libavcodec outputs the latest reference again at the end of a stream
    whose last VOP was not coded (OpenCV's drain): an Xvid file's P-VOPs with
    a DivX placeholder after the last."""
    reader = open_video(FIXTURES / "divx4_100x60.avi")
    packets = list(reader.packets())
    nvop = next(p for p in open_video(FIXTURES / "divx_packed_64x48.avi").packets() if len(p) < 20)
    planes = planes_of(packets, reader.config, reader.fourcc)
    with_nvop = planes_of(packets + [nvop], reader.config, reader.fourcc)
    assert len(with_nvop) == len(planes) + 1
    assert all(np.array_equal(a, b) for a, b in zip(with_nvop[-1], planes[-1]))
    if libavcodec.available():
        want = libavcodec.decode(packets + [nvop], reader.config, reader.fourcc.encode())
        assert len(want) == len(with_nvop)
        assert all(np.array_equal(a, b) for x, y in zip(with_nvop, want) for a, b in zip(x, y))


def test_user_data_names_as_libavcodec_reads_them():
    parse = mpeg4._user_data
    assert parse(b"DivX503b1393p") == {"divx": 503, "divx_build": 1393, "divx_packed": 1}
    assert parse(b"DivX609Build1896") == {"divx": 609, "divx_build": 1896, "divx_packed": 0}
    assert parse(b"ffmpeg") == {"lavc": 4600}
    assert parse(b"FFmpeg0.4.9-pre1b4654") == {"lavc": 4654}
    assert parse(b"FFmpeg v0.4.9 / libavcodec build: 4669") == {"lavc": 4669}
    assert parse(b"Lavc56.60.100") == {"lavc": (56 << 16) + (60 << 8) + 100}
    assert parse(b"XviD0012") == {"xvid": 12}
    assert parse(b"FFmpeb4600") == {}  # libavcodec's `FFmpe%*[^b]b%d` wants a character before the b


@pytest.mark.parametrize("ids,tag,want", [
    ({"divx": 503, "divx_build": 1393}, "DX50", {"qpel_chroma", "qpel_chroma2", "hpel_chroma"}),
    ({}, "DIVX", {"edge", "hpel_chroma"}),
    ({"lavc": 4600}, "FMP4", {"std_qpel", "direct_blocksize", "edge", "dc_clip"}),
    ({"lavc": (56 << 16) + (60 << 8) + 100}, "FMP4", {"iedge"}),
    ({"lavc": (57 << 16) + (64 << 8) + 101}, "FMP4", set()),
    ({"xvid": 1, "divx": 503, "divx_build": 1393}, "XVID", {"xvid_idct", "qpel_chroma", "edge", "dc_clip"}),
])
def test_workarounds_follow_libavcodec(ids, tag, want):
    """The workaround set by encoder ids and tag (DivX forgotten where Xvid
    is named; a DIVX tag over an object type 0 VOL without control
    parameters read as DivX 4)."""
    full = dict.fromkeys(("xvid", "divx", "divx_build", "lavc"))
    full.update(ids)
    vol = open_video(FIXTURES / "divx4_100x60.avi")._vol()
    bugs = {}
    mpeg4.workarounds(full, tag, vol, bugs)
    assert set(bugs) == want
