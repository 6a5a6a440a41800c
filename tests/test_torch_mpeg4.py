"""MPEG-4 Part 2 video in the port (`data/mpeg4.py`, `data/mp4.py`, `data/mkv.py`, MPEG-4 in `data/avi.py`,
`data/video.py`, the MP4 writer, the video demo) against OpenCV and the JAX package.

The fixtures in `tests/torch_video/` come from `tests/torch_video/make_fixtures.py`
(OpenCV's FFmpeg writer, and the port's writer with AC prediction, which
libavcodec's encoder does not use), and raw I420 AVIs; its manifest holds the sha256 of every
frame OpenCV's FFmpeg backend decodes. The JAX package opens video with
`cv2.VideoCapture(path)`, that same backend, so its `load_video` is the
reference for every frame, bit for bit. The demo tests hold the frames each
demo drew on (equal) and what it drew (detections within 1e-2 px and 1e-5,
as `tests/test_torch_video.py`); the JAX demo draws with OpenCV's
anti-aliasing and the port without, so annotated pixels are not compared
across packages.
"""

import hashlib
import json
import struct
import sys
from collections import Counter
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_video"
sys.path.insert(0, str(REPO))  # main.py
sys.path.insert(0, str(FIXTURES))  # make_fixtures.scene

import main as jax_main  # noqa: E402
import yolo_infer_tpu.core.model as jax_model_module  # noqa: E402
import yolo_infer_tpu.demos.detection_demo as jax_demo_module  # noqa: E402
from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest  # noqa: E402
from make_fixtures import build_avi, i420_planes, scene  # noqa: E402
from yolo_infer_tpu.data import loader as jax_loader  # noqa: E402
from yolo_infer_tpu.models import build_spec as jax_build_spec  # noqa: E402
from yolo_infer_tpu.models.convert import convert_state_dict  # noqa: E402
from yolo_infer_tpu_torch import cli as port_cli  # noqa: E402
from yolo_infer_tpu_torch.data.loader import get_video_info, load_video  # noqa: E402
from yolo_infer_tpu_torch.data.mp4 import Mp4Reader, Mp4Writer  # noqa: E402
from yolo_infer_tpu_torch.data.mpeg4 import Mpeg4Decoder, Mpeg4Encoder, simple_idct, yuv420_to_bgr  # noqa: E402
from yolo_infer_tpu_torch.data.video import open_video  # noqa: E402
from yolo_infer_tpu_torch.demos import detection_demo as port_demo_module  # noqa: E402
from yolo_infer_tpu_torch.utils.visualization import create_video_writer  # noqa: E402

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
VIDEOS = list(MANIFEST["files"])
REFUSED = list(MANIFEST["raises"])
IMGSZ = 64
CASES = ("i_vop", "p_vop", "intra_mb", "inter_mb", "skipped_mb", "intra_mb_in_p", "escape_1", "escape_2",
         "escape_3", "scan_zigzag", "scan_horizontal", "scan_vertical", "ac_pred_mb", "dc_as_ac", "rounding_0",
         "rounding_1", "mv_past_edge", "fcode_1", "fcode_2", "fcode_3")
_DECODED = {}


def decoded(name):
    """The port's BGR frames of a fixture and its reader's decoder counts (decoded once)."""
    if name not in _DECODED:
        reader = open_video(FIXTURES / name)
        frames = list(reader.read(rgb=False))
        _DECODED[name] = frames, Counter(reader.counts)
    return _DECODED[name]


def cv2_read(path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
    assert cap.isOpened()
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    info = (cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    return frames, info


def cv2_packets(path):
    """OpenCV's raw packets (`CAP_PROP_FORMAT` -1) and the stream's extradata."""
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG)
    assert cap.set(cv2.CAP_PROP_FORMAT, -1)
    ok, extra = cap.retrieve(None, int(cap.get(cv2.CAP_PROP_CODEC_EXTRADATA_INDEX)))
    packets = []
    while True:
        ok, packet = cap.read()
        if not ok:
            break
        packets.append(packet.tobytes())
    cap.release()
    return packets, (extra.tobytes() if extra is not None else b"")


def psnr(a, b):
    return 10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2))


# ---------------------------------------------------------------- reading


@pytest.mark.parametrize("name", VIDEOS)
def test_fixture_frames_match_the_manifest(name):
    want = MANIFEST["files"][name]
    frames, _ = decoded(name)
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in frames] == want["frames"]
    assert list(frames[0].shape) == want["shape"]
    assert get_video_info(FIXTURES / name) == want["info"]


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("name", VIDEOS)
def test_frames_equal_the_jax_load_video(name, rgb):
    frames, _ = decoded(name)
    for max_frames in (None, 0, 2, 50):
        want = list(jax_loader.load_video(FIXTURES / name, rgb=rgb, max_frames=max_frames))
        got = list(load_video(FIXTURES / name, rgb=rgb, max_frames=max_frames))
        assert len(got) == len(want) == min(len(frames), max(max_frames, 1) if max_frames is not None else 99)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", VIDEOS)
def test_get_video_info_equals_the_jax_package(name):
    assert get_video_info(FIXTURES / name) == jax_loader.get_video_info(FIXTURES / name)


@pytest.mark.parametrize("name", VIDEOS)
def test_demuxer_packets_equal_opencv_raw_packets(name):
    reader = open_video(FIXTURES / name)
    packets, extra = cv2_packets(FIXTURES / name)
    mine = list(reader.packets())
    assert len(mine) == len(packets) == MANIFEST["files"][name]["info"]["frame_count"]
    assert all(a == b for a, b in zip(mine, packets))
    # libavformat takes an AVI's configuration from the first packet: its
    # headers up to the first group-of-VOPs or VOP start code (a VP8 stream
    # has neither, and no configuration)
    cuts = [i for i in (mine[0].find(b"\x00\x00\x01\xb3"), mine[0].find(b"\x00\x00\x01\xb6")) if i >= 0]
    assert extra == (reader.config or (mine[0][:min(cuts)] if cuts else b""))


def test_every_decoder_case_is_met_across_the_fixtures():
    """Each case the decoder's docstring lists as decoded occurs in some fixture."""
    total = Counter()
    for name in VIDEOS:
        total.update(decoded(name)[1])
    assert {case: total[case] for case in CASES if not total[case]} == {}


def test_a_truncated_vop_raises_value_error():
    reader = Mp4Reader(FIXTURES / "mp4v_176x144_2997.mp4")
    packets = list(reader.packets())
    decoder = Mpeg4Decoder(reader.config)
    decoder.decode(packets[0])
    with pytest.raises(ValueError, match="corrupt MPEG-4 VOP"):  # a P-VOP cut in half
        decoder.decode(packets[1][:len(packets[1]) // 2])
    with pytest.raises(ValueError, match="corrupt MPEG-4"):  # an I-VOP cut after its header
        Mpeg4Decoder(reader.config).decode(packets[0][:40])


def test_simple_idct_takes_the_dc_only_row_shortcut():
    """A row with only its DC is DC << 3 (libavcodec's shortcut), not the full
    product, which differs for large DCs; a zero block is zero."""
    block = np.zeros((2, 8, 8), np.int32)
    block[0, 0, 0] = 2047
    out = simple_idct(block)
    assert out[0].min() == out[0].max() == (16376 * 16383 + 16383 * 32) >> 20
    assert not out[1].any()


@pytest.mark.parametrize("name", REFUSED)
def test_refused_files_raise_before_any_frame(name):
    want = MANIFEST["raises"][name]
    error = {"NotImplementedError": NotImplementedError, "ValueError": ValueError}[want["error"]]
    for read in (get_video_info, load_video):
        with pytest.raises(error, match=want["match"]):
            read(FIXTURES / name)


@pytest.mark.parametrize("fourcc", ["I420", "IYUV"])
@pytest.mark.parametrize("size", [(1, 2), (3, 2), (33, 18), (99, 60), (64, 48)])
def test_raw_i420_avi_equals_opencv_at_any_width(tmp_path, size, fourcc):
    """Raw planar 4:2:0 in AVI at odd and even widths: the frames of
    OpenCV's FFmpeg backend (swscale's copy), and its info."""
    w, h = size
    frames = [np.random.default_rng(w * h + k).integers(0, 256, (h, w, 3), dtype=np.uint8) for k in range(3)]
    path = tmp_path / "raw.avi"
    build_avi(path, [i420_planes(f) for f in frames], fourcc.encode(), w, h, 25)
    want, _ = cv2_read(path)
    got = list(load_video(path, rgb=False))
    assert len(got) == len(want) == 3 and all(np.array_equal(g, x) for g, x in zip(got, want))
    assert get_video_info(path) == jax_loader.get_video_info(path)


@pytest.mark.parametrize("size", [(64, 47), (99, 61), (2, 1)])
def test_raw_i420_of_an_odd_height_raises(tmp_path, size):
    """OpenCV reads these, but swscale converts an odd height on its scaled
    path, which the port does not reproduce: refused before any frame."""
    w, h = size
    path = tmp_path / "odd.avi"
    build_avi(path, [i420_planes(np.full((h, w, 3), 90, np.uint8))], b"I420", w, h, 25)
    assert len(cv2_read(path)[0]) == 1
    for read in (get_video_info, load_video):
        with pytest.raises(NotImplementedError, match=r"odd height.*ROADMAP Queue 1 item 11\.2"):
            read(path)


# ---------------------------------------------------------------- writing


@pytest.mark.parametrize("suffix,fps,size", [(".mp4", 25, (64, 48)), (".mov", 29.97, (99, 60)),
                                             (".m4v", 12.5, (65, 50)), (".mp4", 30, (63, 47))])
def test_port_written_video_reads_back_in_opencv(tmp_path, suffix, fps, size):
    """cv2 reads the port's MPEG-4 bit-equal to the port's own reading and to
    the encoder's reconstruction; the JAX package's get_video_info gives the
    fps, count and size back (an odd height less its last row, as cv2's
    writer rounds it); its PSNR is at least cv2's own mp4v writer's."""
    w, h = size[0], size[1] & ~1
    frames = scene(6, size[1], w, seed=40 + w)
    path = tmp_path / f"v{suffix}"
    writer = create_video_writer(path, fps, size)
    recon = []
    for f in frames:
        writer.write(f)
        recon.append(writer.encoder.reconstruction)
    writer.release()
    assert not writer.isOpened()
    got, info = cv2_read(path)
    mine = list(load_video(path, rgb=False))
    assert len(got) == len(mine) == 6
    assert all(np.array_equal(a, b) and np.array_equal(a, c) for a, b, c in zip(got, mine, recon))
    want = {"width": w, "height": h, "fps": fps, "frame_count": 6, "duration_s": 6 / fps}
    assert get_video_info(path) == jax_loader.get_video_info(path) == want
    assert info == (fps, 6, w, h)
    # cv2's own writer on the same frames (it rounds odd sizes down)
    theirs = cv2.VideoWriter(str(tmp_path / "cv2.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    for f in frames:
        theirs.write(f)
    theirs.release()
    back, _ = cv2_read(tmp_path / "cv2.mp4")
    hh, ww = back[0].shape[:2]
    ours = np.mean([psnr(r, f[:h]) for r, f in zip(recon, frames)])
    cv2s = np.mean([psnr(b, f[:hh, :ww]) for b, f in zip(back, frames)])
    assert ours >= cv2s, (ours, cv2s)


def test_encoder_options_read_back_in_opencv(tmp_path):
    """The DC coded as an AC coefficient and other quantisers (other DC
    scalers) decode in cv2 as the encoder reconstructs them."""
    frames = scene(3, 48, 64, seed=7)
    for quant, dc_vlc in ((1, False), (13, True), (31, False)):
        enc = Mpeg4Encoder(64, 48, 25, quant=quant, dc_vlc=dc_vlc)
        decoder = Mpeg4Decoder(enc.headers())
        for f in frames:
            assert np.array_equal(yuv420_to_bgr(*decoder.decode(enc.encode(f))), enc.reconstruction)
    path = tmp_path / "v.mp4"
    writer = Mp4Writer(path, 25, (64, 48))
    writer.encoder = Mpeg4Encoder(64, 48, 25, quant=31, dc_vlc=False)
    recon = []
    for f in frames:
        writer.write(f)
        recon.append(writer.encoder.reconstruction)
    writer.release()
    got, _ = cv2_read(path)
    assert len(got) == 3 and all(np.array_equal(a, b) for a, b in zip(got, recon))


def test_video_writer_containers(tmp_path):
    """`.mpg` still raises with its roadmap pointer and `.webm` raises the JAX
    package's RuntimeError, both before anything is written; `.mkv` is
    MPEG-4 Part 2 in Matroska, which OpenCV reads back as the encoder's
    reconstruction."""
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 11\.2"):
        create_video_writer(Path("/nonexistent") / "v.mpg", 25, (64, 48))
    with pytest.raises(RuntimeError, match="no working codec"):
        create_video_writer(Path("/nonexistent") / "v.webm", 25, (64, 48))
    writer = create_video_writer(tmp_path / "v.mkv", 25, (64, 48))
    recon = []
    for f in scene(3, 48, 64, 4):
        writer.write(f)
        recon.append(writer.encoder.reconstruction)
    writer.release()
    got, info = cv2_read(tmp_path / "v.mkv")
    assert info == (25, 3, 64, 48) and all(np.array_equal(a, b) for a, b in zip(got, recon))
    assert all(np.array_equal(a, b) for a, b in zip(load_video(tmp_path / "v.mkv", rgb=False), recon))


# ---------------------------------------------------------------- the demo


class _JaxF32Model(jax_model_module.YOLO11Model):
    """The JAX package's model, built in f32 wherever its demo builds one."""

    def __init__(self, *args, **kwargs):
        kwargs["compute_dtype"] = jnp.float32
        super().__init__(*args, **kwargs)


class Collector:
    """A video writer that keeps the BGR frames it is given."""

    def __init__(self, frames):
        self.frames = frames

    def write(self, frame):
        self.frames.append(np.array(frame))

    def release(self):
        pass

    def isOpened(self):  # noqa: N802
        return True


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The JAX-written golden detect and segment checkpoints."""
    root = tmp_path_factory.mktemp("mpeg4_demo")
    out = {}
    for task in ("detect", "segment"):
        z = np.load(REPO / "tests" / "golden" / f"golden_{task}_n_v{GOLDEN_VERSION}.npz")
        sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
        nc = int(z["nc"])
        params, state = convert_state_dict(sd, jax_build_spec(task, "n", nc=nc))
        model = jax_model_module.YOLO11Model.from_params(params, task=task, size="n", nc=nc, fused=False,
                                                         state=state, names={i: f"c{i}" for i in range(nc)},
                                                         compute_dtype=jnp.float32)
        out[task] = model.save(root / f"{task}.msgpack")
    return out


def run_demos(ckpts, tmp_path, monkeypatch, video, task, draw, **kw):
    """detect_video of both packages on `video` (each through its own reader:
    OpenCV's FFmpeg backend, the port's decoder): [(summary, [(frame, drawn,
    out)], written BGR frames)] for the JAX demo and the port's."""
    monkeypatch.setattr(jax_demo_module, "YOLO11Model", _JaxF32Model)
    runs = []
    for module, extra in ((jax_demo_module, {}), (port_demo_module, {"device": "cpu",
                                                                     "compute_dtype": torch.float32})):
        draws, written = [], []
        real = getattr(module, draw)

        def record(frame, *args, real=real, draws=draws, **kwargs):
            out = real(frame, *args, **kwargs)
            draws.append((np.array(frame), args, out))
            return out

        monkeypatch.setattr(module, draw, record)
        monkeypatch.setattr(module, "create_video_writer", lambda *a, written=written: Collector(written))
        demo = module.DetectionDemo(model_path=str(ckpts[task]), conf_threshold=0.25, imgsz=IMGSZ, **extra)
        runs.append((demo.detect_video(video, tmp_path / "out.mp4", **kw), draws, written))
    return runs


@pytest.mark.parametrize("name", ["mp4v_176x144_2997.mp4", "mp4v_64x48_30.mkv", "xvid_100x60_30.avi"])
def test_detect_video_matches_the_jax_demo(ckpts, tmp_path, monkeypatch, name):
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


def test_segment_video_per_frame_runs_on_mp4(ckpts, tmp_path, monkeypatch):
    (want, jax_draws, _), (got, draws, written) = run_demos(
        ckpts, tmp_path, monkeypatch, FIXTURES / "mp4v_176x144_2997.mp4", "segment", "draw_results", max_frames=3)
    assert got["total_frames"] == want["total_frames"] == len(draws) == len(written) == 3
    assert got["total_detections"] == want["total_detections"]
    for (frame, (r,), out), (jframe, (jr,), _), w in zip(draws, jax_draws, written):
        assert np.array_equal(frame, jframe) and np.array_equal(w, out[..., ::-1])
        np.testing.assert_array_equal(r.classes, jr.classes)
        np.testing.assert_allclose(r.boxes, jr.boxes, atol=1e-2, rtol=0)


def test_cli_demo_mp4_in_mp4_out_as_the_jax_cli(ckpts, tmp_path, capsys, monkeypatch):
    """`demo --input v.mp4 --output o.mp4` exits 0 in both CLIs; cv2 reads
    both outputs with the same count, size and fps."""
    monkeypatch.setattr(jax_demo_module, "YOLO11Model", _JaxF32Model)
    argv = ["demo", "--input", str(FIXTURES / "acpred_dcac_100x60_25.mp4"), "--model-path", str(ckpts["detect"]),
            "--imgsz", str(IMGSZ), "--conf", "0.25", "--batch", "4"]
    jax_rc = jax_main.YOLO11CLI().run(argv + ["--output", str(tmp_path / "jax.mp4")])
    port_rc = port_cli.YOLO11CLI().run(argv + ["--output", str(tmp_path / "port.mp4"), "--device", "cpu"])
    capsys.readouterr()
    assert jax_rc == port_rc == 0
    infos = [cv2_read(tmp_path / f"{who}.mp4")[1] for who in ("jax", "port")]
    assert infos[0] == infos[1] == (25, 5, 100, 60)
    assert len(list(load_video(tmp_path / "port.mp4"))) == 5


# ---------------------------------------------------------------- container layouts


def _box(kind, body):
    return struct.pack(">I", 8 + len(body)) + kind + body


def _rebox(data, offsets_to, co64=False):
    """A moov body with each chunk offset mapped by `offsets_to`, in `co64`
    boxes if asked; the boxes around them resized."""
    out, pos = b"", 0
    while pos < len(data):
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + size]
        if kind in (b"trak", b"mdia", b"minf", b"stbl"):
            body = _rebox(body, offsets_to, co64)
        elif kind in (b"stco", b"co64"):
            n = struct.unpack(">I", body[4:8])[0]
            old = struct.unpack(f">{n}{'I' if kind == b'stco' else 'Q'}", body[8:])
            new = [offsets_to(o) for o in old]
            kind = b"co64" if co64 else b"stco"
            body = body[:8] + struct.pack(f">{n}{'Q' if co64 else 'I'}", *new)
        out += _box(kind, body)
        pos += size
    return out


@pytest.mark.parametrize("layout", ["moov_first", "mdat_to_the_end", "co64"])
def test_mp4_box_layouts_read_as_opencv_reads_them(tmp_path, layout):
    """moov before mdat (32-bit mdat), a size-0 mdat running to the end of
    the file, and 64-bit chunk offsets: the port's frames and info equal
    cv2's."""
    src = (FIXTURES / "mp4v_176x144_2997.mp4").read_bytes()
    boxes, pos = {}, 0
    while pos < len(src):
        size, kind = struct.unpack(">I4s", src[pos:pos + 8])
        boxes[kind] = (pos, src[pos:pos + size])
        pos += size
    mdat_at, mdat = boxes[b"mdat"]
    ftyp, moov = boxes[b"ftyp"][1], boxes[b"moov"][1]
    if layout == "co64":
        data = src[:boxes[b"moov"][0]] + _box(b"moov", _rebox(moov[8:], lambda o: o, co64=True))
    else:
        new_moov = _box(b"moov", _rebox(moov[8:], lambda o: o))
        shift = len(ftyp) + len(new_moov) - mdat_at
        new_moov = _box(b"moov", _rebox(moov[8:], lambda o: o + shift))
        head = struct.pack(">I", 0 if layout == "mdat_to_the_end" else len(mdat)) + b"mdat"
        data = ftyp + new_moov + head + mdat[8:]
    path = tmp_path / "v.mp4"
    path.write_bytes(data)
    want, info = cv2_read(path)
    got = list(load_video(path, rgb=False))
    assert len(got) == len(want) == 25 and all(np.array_equal(a, b) for a, b in zip(got, want))
    assert get_video_info(path) == jax_loader.get_video_info(path)
    assert info == (29.97, 25, 176, 144)


def _ebml(eid, body):
    n = len(body)
    return eid + b"\x01" + n.to_bytes(7, "big") + body  # an 8-byte size


def test_matroska_block_groups_and_a_vfw_track_read_as_opencv_reads_them(tmp_path):
    """A Matroska file built here from an MP4 fixture's samples: a
    `V_MS/VFW/FOURCC` track (a BITMAPINFOHEADER with the VOL after it) and
    every frame in a BlockGroup; the port's frames and info equal cv2's."""
    reader = Mp4Reader(FIXTURES / "mp4v_100x60_25.mov")
    bih = struct.pack("<IiiHH4sIiiII", 40 + len(reader.config), 100, 60, 1, 24, b"FMP4", 100 * 60 * 3, 0, 0, 0, 0)
    uint = lambda eid, v: _ebml(eid, v.to_bytes(8, "big"))  # noqa: E731
    track = _ebml(b"\xae", uint(b"\xd7", 1) + uint(b"\x83", 1) + _ebml(b"\x86", b"V_MS/VFW/FOURCC")
                  + uint(b"\x23\xe3\x83", 40_000_000) + _ebml(b"\x63\xa2", bih + reader.config)
                  + _ebml(b"\xe0", uint(b"\xb0", 100) + uint(b"\xba", 60)))
    info = _ebml(b"\x15\x49\xa9\x66", uint(b"\x2a\xd7\xb1", 1_000_000) + _ebml(b"\x44\x89", struct.pack(">d", 760.0)))
    blocks = b"".join(_ebml(b"\xa0", _ebml(b"\xa1", b"\x81" + struct.pack(">hB", 40 * i, 0) + p))
                      for i, p in enumerate(reader.packets()))
    cluster = _ebml(b"\x1f\x43\xb6\x75", uint(b"\xe7", 0) + blocks)
    head = _ebml(b"\x1a\x45\xdf\xa3", _ebml(b"\x42\x82", b"matroska"))
    path = tmp_path / "v.mkv"
    path.write_bytes(head + _ebml(b"\x18\x53\x80\x67", info + _ebml(b"\x16\x54\xae\x6b", track) + cluster))
    want, cv2_info = cv2_read(path)
    got = list(load_video(path, rgb=False))
    assert len(got) == len(want) == 19 and all(np.array_equal(a, b) for a, b in zip(got, want))
    assert get_video_info(path) == jax_loader.get_video_info(path)
    assert cv2_info == (25, 19, 100, 60)


def test_avi_with_the_vol_in_its_stream_format_reads_as_opencv_reads_it(tmp_path):
    """An AVI whose headers sit after strf's BITMAPINFOHEADER, not in its first packet."""
    from make_fixtures import build_avi

    reader = open_video(FIXTURES / "fmp4_176x144_25.avi")
    packets = list(reader.packets())
    cut = packets[0].index(b"\x00\x00\x01\xb3")
    build_avi(tmp_path / "v.avi", [packets[0][cut:]] + packets[1:], b"FMP4", 176, 144, 25, extra=packets[0][:cut])
    want, info = cv2_read(tmp_path / "v.avi")
    got = list(load_video(tmp_path / "v.avi", rgb=False))
    assert len(got) == len(want) == 25 and all(np.array_equal(a, b) for a, b in zip(got, want))
    assert get_video_info(tmp_path / "v.avi") == jax_loader.get_video_info(tmp_path / "v.avi")


def test_the_container_is_found_by_its_signature_not_its_name(tmp_path):
    for name, alias in (("mp4v_64x48_30.mkv", "v.avi"), ("divx_64x48_2997.avi", "v.mp4"),
                        ("mp4v_100x60_25.mov", "v.mkv")):
        (tmp_path / alias).write_bytes((FIXTURES / name).read_bytes())
        hashes = [hashlib.sha256(f.tobytes()).hexdigest() for f in load_video(tmp_path / alias, rgb=False)]
        assert hashes == MANIFEST["files"][name]["frames"]
        assert get_video_info(tmp_path / alias) == MANIFEST["files"][name]["info"]
