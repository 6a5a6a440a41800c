"""MPEG-1 and MPEG-2 video in the port (`data/mpeg12.py`; AVI, Matroska, MP4 and MOV) and H.263 under the tags the demuxers added, against OpenCV, libavcodec and the JAX package.

The fixtures in `tests/torch_mpeg12/` come from
`tests/torch_mpeg12/make_fixtures.py` (OpenCV's `PIM1`, `mpg1`, `MPEG`,
`mpg2`, `H263` and `U263` writers, libavcodec's `mpeg1video` and
`mpeg2video` encoders through ctypes where OpenCV's settings do not reach,
encodes with their headers rewritten for the syntax no bundled encoder
writes); its manifest holds the sha256 of every frame OpenCV's FFmpeg
backend decodes, which is what the JAX package's `load_video` returns. The
planes are held to libavcodec's decoder too (`tests/torch_mpeg4/libavcodec.py`).
The 640x480 MPEG-2 file is the card's input (`chip_smoke.py mpeg12`): here
only its first frames are decoded.
"""

import hashlib
import importlib.util
import json
import random
import re
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
FIXTURES = REPO / "tests" / "torch_mpeg12"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests" / "torch_mpeg4"))  # libavcodec
sys.path.insert(0, str(REPO / "tests" / "torch_video"))  # make_fixtures.build_avi

import libavcodec  # noqa: E402
from make_fixtures import build_avi  # noqa: E402  (tests/torch_video)
from test_torch_mpeg4 import cv2_packets, run_demos  # noqa: E402
from test_torch_mpeg4 import ckpts  # noqa: E402,F401  (the module-scoped fixture)
from yolo_infer_tpu.data import loader as jax_loader  # noqa: E402
from yolo_infer_tpu_torch.data import mpeg12, mpeg12_tables  # noqa: E402
from yolo_infer_tpu_torch.data.h263 import H263Decoder  # noqa: E402
from yolo_infer_tpu_torch.data.loader import get_video_info, load_video  # noqa: E402
from yolo_infer_tpu_torch.data.mkv import MatroskaWriter  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import BT601, simple_idct, yuv420_to_bgr  # noqa: E402
from yolo_infer_tpu_torch.data.video import open_video  # noqa: E402

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
BIG = "mpeg2_640x480.avi"  # the card's demo and decode-speed input
VIDEOS = sorted(MANIFEST["files"])
SMALL = [n for n in VIDEOS if n != BIG]
H263 = [n for n in SMALL if n.startswith(("h263_", "u263_"))]
MPEG = [n for n in SMALL if n not in H263]
REFUSED = sorted(MANIFEST["raises"])
# every case the decoder's docstring lists as decoded
CASES = ("mpeg1_picture", "mpeg2_picture", "i_picture", "p_picture", "b_picture", "sequence_header", "gop_header",
         "loaded_matrix_sequence", "quant_matrix_extension", "sequence_display_extension", "matrix_coefficients_1",
         "matrix_coefficients_4", "dc_precision_8", "dc_precision_9", "dc_precision_10", "dc_precision_11",
         "q_scale_type_picture", "intra_vlc_picture", "alternate_picture", "progressive_frame_0", "slice", "quant_mb",
         "intra_mb", "intra_mb_in_pb", "forward_mb", "backward_mb", "bidirectional_mb", "no_mc_mb", "not_coded_mb",
         "skipped_mb_p", "skipped_mb_b", "escape_8", "escape_16", "escape_12", "mismatch_toggle", "b_picture_dropped",
         "f_code_1", "f_code_2", "f_code_3", "concealment_vector", "mb_stuffing", "mb_escape")
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


def port_planes(packets, config=b""):
    decoder = mpeg12.Mpeg12Decoder(config)
    got = [f for f in map(decoder.decode, packets) if f is not None]
    last = decoder.flush()
    return got + ([last] if last is not None else [])


@pytest.mark.parametrize("name", SMALL)
def test_fixture_frames_match_the_manifest(name):
    want = MANIFEST["files"][name]
    frames, counts = decoded(name)
    assert hashes(frames) == want["frames"]
    assert list(frames[0].shape) == want["shape"]
    assert [k for k in want["reach"] if not counts[k]] == []


def test_card_input_first_frames_match_the_manifest():
    """The 640x480 file: its first two frames in display order here (the card decodes it whole)."""
    frames, counts = decoded(BIG, 2)
    assert hashes(frames) == MANIFEST["files"][BIG]["frames"][:2]
    assert counts["i_picture"] and counts["b_picture"]
    reader = open_video(FIXTURES / BIG)
    assert (reader.width, reader.height) == (640, 480) and len(list(reader.packets())) == reader.frame_count


@pytest.mark.parametrize("name", SMALL)
def test_frames_equal_the_jax_load_video(name):
    want = list(jax_loader.load_video(FIXTURES / name, rgb=True))
    got = list(load_video(FIXTURES / name, rgb=True))
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", VIDEOS)
def test_get_video_info_equals_the_jax_package(name):
    assert get_video_info(FIXTURES / name) == jax_loader.get_video_info(FIXTURES / name) \
        == MANIFEST["files"][name]["info"]


@pytest.mark.skipif(not libavcodec.available(), reason="OpenCV's bundled libavcodec is not found")
@pytest.mark.parametrize("name", SMALL)
def test_planes_equal_libavcodec(name):
    """The port's demuxed packets through libavcodec's own decoder give the port's planes."""
    reader = open_video(FIXTURES / name)
    packets = list(reader.packets())
    if reader.codec == "h263":
        want = libavcodec.decode(packets, codec_name="h263")
        decoder = H263Decoder()
        got = [decoder.decode(p) for p in packets]
    else:
        want = libavcodec.decode(packets, reader.config, codec_name="mpeg2video")
        got = port_planes(packets, reader.config)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", SMALL)
def test_demuxer_packets_equal_opencv_raw_packets(name):
    """Each container's packets are OpenCV's raw ones; an MP4's or Matroska's configuration its extradata."""
    packets, extra = cv2_packets(FIXTURES / name)
    reader = open_video(FIXTURES / name)
    assert list(reader.packets()) == packets
    if reader.config:
        assert reader.config == extra


def test_every_decoder_case_is_met_across_the_fixtures():
    total = Counter()
    for name in MPEG:
        total.update(decoded(name)[1])
    assert {case: total[case] for case in CASES if not total[case]} == {}


@pytest.mark.parametrize("name", ["mpeg2_bt709_64x48.avi", "mpeg2_fcc_64x48.avi"])
def test_colour_matrices_change_opencvs_pixels(name):
    """A sequence display extension's matrix_coefficients pick swscale's
    conversion: the fixture's frames are not the BT.601 conversion of its
    planes, and are that of the named matrix (the manifest's hashes)."""
    reader = open_video(FIXTURES / name)
    planes = port_planes(list(reader.packets()), reader.config)
    assert hashes(yuv420_to_bgr(*p, BT601) for p in planes) != MANIFEST["files"][name]["frames"]
    assert hashes(decoded(name)[0]) == MANIFEST["files"][name]["frames"]


@pytest.mark.parametrize("name", ["mpeg2_2997_128x96.mkv", "mpeg2_2997_128x96.mp4", "pim1_128x96.avi",
                                  "mpeg_128x96.mov"])
def test_frame_rate_codes(name):
    """The sequence header's frame rate code, as libavcodec reads it; a
    Matroska track without DefaultDuration takes OpenCV's rate from it."""
    reader = open_video(FIXTURES / name)
    want = (30000, 1001) if "2997" in name else (25, 1)
    assert reader.frame_rate == want
    if name.endswith(".mkv"):
        assert reader.fps == 1000 / (1000 * 1001 // 30000)


@pytest.mark.parametrize("tag", [t.decode("latin-1") for t in mpeg12.FOURCCS] + ["pim1", "Mpeg", "mpg2"])
def test_every_avi_tag_reads_as_opencv_reads_it(tag, tmp_path):
    """The MPEG-2 AVI under each tag the port takes: OpenCV's frames."""
    data = bytearray((FIXTURES / "mpeg_128x96.avi").read_bytes())
    for box, at in ((b"strh", 12), (b"strf", 24)):
        i = data.index(box) + at
        data[i:i + 4] = tag.encode("latin-1")
    path = tmp_path / "tagged.avi"
    path.write_bytes(bytes(data))
    want = MANIFEST["files"]["mpeg_128x96.avi"]["frames"]
    assert hashes(load_video(path, rgb=False)) == want == hashes(jax_loader.load_video(path, rgb=False))


def test_vfw_matroska_track_reads_as_opencv_reads_it(tmp_path):
    """MPEG-2 under `V_MS/VFW/FOURCC` (a BITMAPINFOHEADER tagged `MPEG`)."""
    reader = open_video(FIXTURES / "mpeg_128x96.avi")
    header = struct.pack("<IiiHH4sIiiII", 40, 128, 96, 1, 24, b"MPEG", 128 * 96 * 3, 0, 0, 0, 0)
    writer = MatroskaWriter(tmp_path / "vfw.mkv", "matroska", "V_MS/VFW/FOURCC", header, 128, 96, 25)
    for packet in reader.packets():
        writer.add(packet)
    writer.release()
    assert open_video(tmp_path / "vfw.mkv").codec == "mpeg12"
    assert hashes(load_video(tmp_path / "vfw.mkv", rgb=False)) == hashes(
        jax_loader.load_video(tmp_path / "vfw.mkv", rgb=False)) == MANIFEST["files"]["mpeg_128x96.avi"]["frames"]


@pytest.mark.parametrize("name", REFUSED)
def test_refused_files_raise_before_any_frame(name):
    """The refusals, and how many frames OpenCV reads of each (the manifest's `cv2_frames`)."""
    want = MANIFEST["raises"][name]
    for read in (get_video_info, load_video):
        with pytest.raises(NotImplementedError, match=want["match"]):
            read(FIXTURES / name)
    assert len(list(jax_loader.load_video(FIXTURES / name))) == want["cv2_frames"]


def _set_bits(payload: bytes, at: int, value: str) -> bytes:
    bits = "".join(f"{b:08b}" for b in payload)
    bits = bits[:at] + value + bits[at + len(value):]
    return int(bits, 2).to_bytes(len(payload), "big")


def _with_unit(packet: bytes, code: int, edit) -> bytes:
    at = packet.index(b"\x00\x00\x01" + bytes([code])) + 4
    end = packet.find(b"\x00\x00\x01", at)
    return packet[:at] + edit(packet[at:end]) + packet[end:]


@pytest.mark.parametrize("bit", [24, 30])
def test_top_field_first_and_repeat_first_field_change_no_frame(bit, tmp_path):
    """top_field_first (bit 24 of the picture coding extension) or
    repeat_first_field (bit 30) set in every picture of a progressive
    sequence: OpenCV returns the same frames, and so does the port."""
    reader = open_video(FIXTURES / "mpeg_128x96.avi")
    packets = []
    for p in reader.packets():
        at = [m.end() for m in re.finditer(b"\x00\x00\x01\xb5", p) if p[m.end()] >> 4 == 8][0]
        end = p.find(b"\x00\x00\x01", at)
        packets.append(p[:at] + _set_bits(p[at:end], bit, "1") + p[end:])
    build_avi(tmp_path / "flags.avi", packets, b"MPEG", 128, 96, 25)
    want = MANIFEST["files"]["mpeg_128x96.avi"]["frames"]
    assert hashes(load_video(tmp_path / "flags.avi", rgb=False)) == want
    assert hashes(jax_loader.load_video(tmp_path / "flags.avi", rgb=False)) == want


def test_field_pictures_and_the_flv1_tag_are_refused(tmp_path):
    """A field picture (picture_structure 1) raises as the port refuses
    it; Sorenson's H.263 (`FLV1`) is a codec of its own and stays refused."""
    first = next(open_video(FIXTURES / "mpeg_128x96.avi").packets())
    at = [m.end() for m in re.finditer(b"\x00\x00\x01\xb5", first) if first[m.end()] >> 4 == 8][0]
    end = first.find(b"\x00\x00\x01", at)
    field = first[:at] + _set_bits(first[at:end], 22, "01") + first[end:]  # picture_structure: a top field
    with pytest.raises(NotImplementedError, match=r"a field picture.*ROADMAP Queue 1 item 11\.2"):
        mpeg12.Mpeg12Decoder().decode(field)
    data = bytearray((FIXTURES / "u263_128x96.avi").read_bytes())
    for box, pos in ((b"strh", 12), (b"strf", 24)):
        i = data.index(box) + pos
        data[i:i + 4] = b"FLV1"
    (tmp_path / "flv1.avi").write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match=r"FLV1.*ROADMAP Queue 1 item 11\.2"):
        get_video_info(tmp_path / "flv1.avi")


def test_corrupt_streams_raise_value_error():
    reader = open_video(FIXTURES / "mpeg_128x96.avi")
    packets = list(reader.packets())
    with pytest.raises(ValueError, match="before any I picture"):
        decoder = mpeg12.Mpeg12Decoder()
        decoder.check(packets[0])  # the sequence header only
        decoder.decode(packets[1][packets[1].index(b"\x00\x00\x01\x00"):])
    with pytest.raises(ValueError, match="truncated|corrupt"):
        mpeg12.Mpeg12Decoder().decode(packets[0][:len(packets[0]) // 2])
    with pytest.raises(ValueError, match="before any sequence header"):
        mpeg12.Mpeg12Decoder().decode(packets[0][packets[0].index(b"\x00\x00\x01\x00"):])
    with pytest.raises(ValueError, match="quantiser_scale_code 0"):  # the first slice's quantiser_scale_code
        mpeg12.Mpeg12Decoder().decode(_with_unit(packets[0], 0x01, lambda u: _set_bits(u, 0, "00000")))
    with pytest.raises(ValueError, match="in no slice"):  # the last slice dropped
        mpeg12.Mpeg12Decoder().decode(packets[0][:packets[0].rindex(b"\x00\x00\x01")])
    with pytest.raises(ValueError, match="picture_coding_type"):
        mpeg12.Mpeg12Decoder().decode(_with_unit(packets[0], 0x00, lambda u: _set_bits(u, 10, "000")))
    with pytest.raises(ValueError, match="sequence header"):
        mpeg12.Mpeg12Decoder().decode(_with_unit(packets[0], 0xB3, lambda u: _set_bits(u, 0, "0" * 12)))


@pytest.mark.skipif(not libavcodec.available(), reason="OpenCV's bundled libavcodec is not found")
def test_the_idct_is_the_one_libavcodec_picks():
    """`simple_idct` equals the IDCT libavcodec's decoders pick here
    (`avcodec_dct_init` with idct `auto`), over MPEG-2's 12-bit levels in
    blocks whose exact IDCT stays in +-600 (past it libavcodec's SIMD passes
    wrap some 16-bit lanes, as `tests/test_torch_mpeg4_asp.py` notes)."""
    rng = np.random.default_rng(28)
    basis = np.array([[np.sqrt((1 if u else 0.5) / 4) * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                      for u in range(8)])
    found = []
    while len(found) < 600:
        b = np.zeros((8, 8), np.int64)
        k = rng.integers(1, 20)
        b.flat[rng.integers(0, 64, k)] = rng.integers(-2048, 2048, k) >> rng.integers(0, 5)
        if np.abs(basis.T @ b @ basis).max() <= 600:
            found.append(b)
    blocks = np.stack(found).astype(np.int16)
    assert np.array_equal(simple_idct(blocks.astype(np.int32)).astype(np.int16), libavcodec.idct(blocks, "auto"))


@pytest.mark.skipif(not libavcodec.available(), reason="OpenCV's bundled libavcodec is not found")
@pytest.mark.parametrize("codec", ["mpeg1video", "mpeg2video"])
def test_random_encodes_equal_libavcodec(codec):
    """A few of `fuzz.py`'s random encodes (sizes, B pictures, quantisers,
    intra_vlc, dc precision, q_scale_type, header splices)."""
    spec = importlib.util.spec_from_file_location("mpeg12_fuzz", FIXTURES / "fuzz.py")
    fuzz = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fuzz)
    for seed in range(3):
        assert fuzz.trial(random.Random(100 * seed + (codec == "mpeg2video")), codec) is None


def _synth():
    spec = importlib.util.spec_from_file_location("mpeg12_synth", FIXTURES / "synth.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    return synth


@pytest.mark.skipif(not libavcodec.available(), reason="OpenCV's bundled libavcodec is not found")
@pytest.mark.parametrize("closed_gop", [False, True])
def test_b_pictures_without_a_past_reference_equal_libavcodec(closed_gop):
    """B pictures decoded right after the first I picture: libavcodec drops
    them in an open GOP, and in a closed one predicts their forward
    vectors from its gray dummy reference; the port does the same."""
    synth = _synth()
    for seed in range(3):
        rng = random.Random(seed)
        packets = synth.stream(rng, seed % 2 == 0, 48, 32, [1, 3, 3, 2, 3], closed_gop)
        want = libavcodec.decode(packets, codec_name="mpeg2video")
        decoder = mpeg12.Mpeg12Decoder()
        got = [f for f in map(decoder.decode, packets) if f is not None] + [decoder.flush()]
        assert decoder.counts["b_picture_gray_past" if closed_gop else "b_picture_dropped"] == 2
        assert len(got) == len(want) == (5 if closed_gop else 3)
        for a, b in zip(got, want):
            assert all(np.array_equal(x, y) for x, y in zip(a, b)), (closed_gop, seed)


@pytest.mark.skipif(not libavcodec.available(), reason="OpenCV's bundled libavcodec is not found")
def test_slices_past_2800_lines_equal_libavcodec():
    """An MPEG-2 picture 2848 lines tall (178 macroblock rows): each slice's
    row takes slice_vertical_position_extension's 3 bits above its 7."""
    packets = _synth().stream(random.Random(7), True, 16, 2848, [1, 2])
    want = libavcodec.decode(packets, codec_name="mpeg2video")
    got = port_planes(packets)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.skipif(not libavcodec.available(), reason="OpenCV's bundled libavcodec is not found")
@pytest.mark.parametrize("mpeg2", [False, True])
def test_synthetic_streams_equal_libavcodec(mpeg2):
    """`synth.py` streams (slices inside and across rows, stuffing and
    macroblock escapes, concealment vectors, every macroblock type, levels
    by the escapes) at a few seeds and sizes."""
    synth = _synth()
    for seed in range(6):
        rng = random.Random(2 * seed + mpeg2)
        w, h = rng.choice([16, 48, 80, 560]), rng.choice([16, 32, 48])
        packets = synth.stream(rng, mpeg2, w, h, synth.kinds_of(rng, 5))
        want = libavcodec.decode(packets, codec_name="mpeg2video")
        got = port_planes(packets)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert all(np.array_equal(x, y) for x, y in zip(a, b)), (mpeg2, seed)


def test_tables_are_the_bundled_libavcodecs_bytes():
    """Every table of `data/mpeg12_tables.py` is found, as libavcodec
    stores it (uint16 code/length pairs of the coefficient tables, uint8
    pairs of the others, uint16 DC codes and the intra matrix, uint8 runs,
    levels, lengths, scans and the non-linear quantiser scale, int32 frame
    rates), in the bundled library."""
    if not libavcodec.available():
        pytest.skip("OpenCV's bundled libavcodec is not found")
    data = Path(libavcodec._LIBS["avcodec"]._name).read_bytes()
    t = mpeg12_tables
    pairs8 = lambda v: bytes(x for pair in v for x in pair)  # noqa: E731
    packed = {
        "VLC_B14": struct.pack("<226H", *(x for pair in t.VLC_B14 for x in pair)),
        "VLC_B15": struct.pack("<226H", *(x for pair in t.VLC_B15 for x in pair)),
        "MB_ADDR_INCR": pairs8(t.MB_ADDR_INCR), "MB_PTYPE": pairs8(t.MB_PTYPE), "MB_BTYPE": pairs8(t.MB_BTYPE),
        "MB_PATTERN": pairs8(t.MB_PATTERN), "MB_MOTION": pairs8(t.MB_MOTION),
        "DC_LUM_CODE": struct.pack("<12H", *t.DC_LUM_CODE), "DC_CHROMA_CODE": struct.pack("<12H", *t.DC_CHROMA_CODE),
        "DC_LUM_BITS": bytes(t.DC_LUM_BITS), "DC_CHROMA_BITS": bytes(t.DC_CHROMA_BITS),
        "RUN": bytes(t.RUN), "LEVEL": bytes(t.LEVEL), "DEFAULT_INTRA_MATRIX": struct.pack("<64H", *t.DEFAULT_INTRA_MATRIX),
        "ZIGZAG": bytes(t.ZIGZAG), "ALTERNATE_SCAN": bytes(t.ALTERNATE_SCAN),
        "NON_LINEAR_QSCALE": bytes(t.NON_LINEAR_QSCALE),
        "FRAME_RATES": struct.pack("<32i", *(x for pair in t.FRAME_RATES for x in pair)),
    }
    assert [name for name, b in packed.items() if b not in data] == []


@pytest.mark.parametrize("name", ["mpeg_128x96.mp4", "mpeg1_b_176x144.avi"])
def test_detect_video_on_mpeg12_matches_the_jax_demo(ckpts, tmp_path, monkeypatch, name):  # noqa: F811
    """detect_video on MPEG-2 (B pictures) and MPEG-1, batched: the frames
    each demo drew on are equal, its detections within the f32 tolerances."""
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


def test_fixtures_stay_small():
    """The folder stays under 500 kB, and each decoded file at or under
    560x32 pixels but a 176x144 one and the 640x480 card input."""
    assert sum(p.stat().st_size for p in FIXTURES.iterdir() if p.is_file()) < 500_000
    for name in SMALL:
        assert np.prod(MANIFEST["files"][name]["shape"][:2]) <= 560 * 32 or name == "mpeg1_b_176x144.avi"


_NO_OPENCV_CODE = """
import hashlib, json, sys
from pathlib import Path
for name in ("jax", "cv2", "yaml", "PIL", "yolo_infer_tpu"):
    sys.modules[name] = None  # any import of these raises
sys.path.insert(0, {repo!r})
from yolo_infer_tpu_torch.data.loader import get_video_info, load_video
fixtures = Path({repo!r}) / "tests" / "torch_mpeg12"
manifest = json.loads((fixtures / "manifest.json").read_text())
for name in {names!r}:
    hashes = [hashlib.sha256(f.tobytes()).hexdigest() for f in load_video(fixtures / name, rgb=False)]
    assert hashes == manifest["files"][name]["frames"], name
    assert get_video_info(fixtures / name) == manifest["files"][name]["info"], name
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cv2", "yaml", "PIL", "yolo_infer_tpu")
               for m in sys.modules if sys.modules[m] is not None)
"""


def test_mpeg12_reads_without_jax_or_opencv():
    """MPEG-1 and MPEG-2 in AVI, MKV, MP4 and MOV, and H.263 under `U263`,
    with jax, the JAX package, cv2, yaml and PIL blocked."""
    names = ["pim1_128x96.mov", "mpeg_128x96.mkv", "mpeg_128x96.mp4", "mpeg2_bt709_64x48.avi", "u263_128x96.mkv"]
    subprocess.run([sys.executable, "-I", "-c", _NO_OPENCV_CODE.format(repo=str(REPO), names=names)], check=True,
                   timeout=300, env=TORCH_SUBPROCESS_ENV)
