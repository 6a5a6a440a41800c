"""Video sources of the port (`data/avi.py`, the loader, the writer, the video demo) against OpenCV and the JAX package.

Fixtures are motion-JPEG AVI files that `cv2.VideoWriter` writes here from
seeded numpy frames: FFmpeg's writer at even sizes and 29.97 and 12.5 fps,
OpenCV's own MJPEG writer at an odd size and 25 fps (FFmpeg's rounds odd
sizes down), and files rebuilt from their frames with an audio stream,
`LIST rec ` groups, odd-sized chunks or frames without a DHT segment.

The JAX package opens video with `cv2.VideoCapture(path)`, which takes the
FFmpeg backend; FFmpeg's MJPEG decoder rounds differently from libjpeg, so
the port's frames are held to OpenCV's own MJPEG backend
(`cv2.CAP_OPENCV_MJPEG`), which equals `cv2.imdecode` bit for bit. The demo
tests open video in the JAX package through that backend too (a patched
`cv2.VideoCapture`), so both packages see the same pixels. The JAX package
draws with OpenCV's anti-aliased primitives and the port without
(`tests/test_torch_visualization.py`), so the annotated frames are held by
what each demo drew on (equal frames) and what it drew (detections within
the f32 tolerances of `tests/test_torch_cli.py`: 1e-2 px, 1e-5; segment
masks with at most 1e-4 of their pixels differing), and each writer must get
exactly its package's drawing.
"""

import logging
import shutil
import struct
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))  # main.py

import main as jax_main  # noqa: E402
import yolo_infer_tpu.core.model as jax_model_module  # noqa: E402
import yolo_infer_tpu.demos.detection_demo as jax_demo_module  # noqa: E402
from golden_common import GOLDEN_VERSION, golden_state_dict, unpack_manifest  # noqa: E402
from yolo_infer_tpu.data import loader as jax_loader  # noqa: E402
from yolo_infer_tpu.models import build_spec as jax_build_spec  # noqa: E402
from yolo_infer_tpu.models.convert import convert_state_dict  # noqa: E402
from yolo_infer_tpu_torch import cli as port_cli  # noqa: E402
from yolo_infer_tpu_torch.data import avi  # noqa: E402
from yolo_infer_tpu_torch.data.jpeg import decode_jpeg  # noqa: E402
from yolo_infer_tpu_torch.data.loader import get_video_info, load_image, load_video  # noqa: E402
from yolo_infer_tpu_torch.demos import detection_demo as port_demo_module  # noqa: E402
from yolo_infer_tpu_torch.utils.visualization import create_video_writer  # noqa: E402

IMGSZ = 64
AVC1_MP4 = REPO / "tests" / "torch_video" / "avc1_entry_64x48.mp4"  # an MP4 whose sample entry says H.264
_VideoCapture = cv2.VideoCapture


def seeded_frames(n, h, w, seed):
    """BGR frames: a gradient with noise, so JPEG has work on every block."""
    rng = np.random.default_rng(seed)
    base = np.add.outer(np.arange(h), np.arange(w))[..., None] * np.array([1, 2, 3]) % 256
    return [np.clip(base + rng.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8) for _ in range(n)]


def cv2_write(path, frames, fps, backend=None):
    h, w = frames[0].shape[:2]
    args = (cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    writer = cv2.VideoWriter(str(path), *args) if backend is None else cv2.VideoWriter(str(path), backend, *args)
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()
    return path


def cv2_read(path, backend=cv2.CAP_OPENCV_MJPEG):
    cap = _VideoCapture(str(path), backend)
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


def riff_chunks(data, pos, end):
    while pos + 8 <= end:
        fcc, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        yield fcc, pos, size
        pos += 8 + size + (size & 1)


def avi_jpegs(path):
    """The JPEG frames of a one-stream AVI, in file order."""
    data = Path(path).read_bytes()
    movi = data.index(b"movi") + 4
    end = movi + struct.unpack("<I", data[movi - 8:movi - 4])[0] - 4
    return [data[p + 8:p + 8 + s] for fcc, p, s in riff_chunks(data, movi, end) if fcc == b"00dc"]


def strip_dht(jpeg):
    """The JPEG without its DHT segments."""
    out, pos = bytearray(jpeg[:2]), 2
    while jpeg[pos + 1] != 0xDA:
        (length,) = struct.unpack(">H", jpeg[pos + 2:pos + 4])
        if jpeg[pos + 1] != 0xC4:
            out += jpeg[pos:pos + 2 + length]
        pos += 2 + length
    return bytes(out + jpeg[pos:])


def build_avi(path, jpegs, w, h, rate, scale, audio=None, rec=False):
    """An AVI of `jpegs` built by hand: with `audio` ("second" or "first") an
    8 kHz PCM stream whose chunks (1001 bytes: odd, so padded) follow or
    precede each frame; with `rec` each frame and its audio in a `LIST rec `."""
    def chunk(fcc, body):
        return fcc + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)

    vid = 1 if audio == "first" else 0
    strh_v = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", b"MJPG", 0, 0, 0, 0, scale, rate, 0, len(jpegs), 0,
                         0xFFFFFFFF, 0, 0, 0, w, h)
    strf_v = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    strls = [chunk(b"LIST", b"strl" + chunk(b"strh", strh_v) + chunk(b"strf", strf_v))]
    if audio:
        strh_a = struct.pack("<4s4sIHHIIIIIIII4h", b"auds", b"\0" * 4, 0, 0, 0, 0, 1, 8000, 0, 1001 * len(jpegs),
                             0, 0xFFFFFFFF, 1, 0, 0, 0, 0)
        strf_a = struct.pack("<HHIIHHH", 1, 1, 8000, 8000, 1, 8, 0)
        strl_a = chunk(b"LIST", b"strl" + chunk(b"strh", strh_a) + chunk(b"strf", strf_a))
        strls.insert(0 if audio == "first" else 1, strl_a)
    avih = struct.pack("<14I", 40000, 0, 0, 0x10, len(jpegs), 0, len(strls), 0, w, h, 0, 0, 0, 0)
    hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + b"".join(strls))
    movi, idx = b"movi", b""
    for i, jpeg in enumerate(jpegs):
        parts = [(b"%02ddc" % vid, jpeg)]
        if audio:
            parts.append((b"%02dwb" % (1 - vid), bytes([i]) * 1001))
        group = b""
        base = len(movi) + (12 if rec else 0)
        for fcc, body in parts:
            idx += fcc + struct.pack("<III", 0x10, base + len(group), len(body))
            group += chunk(fcc, body)
        movi += chunk(b"LIST", b"rec " + group) if rec else group
    body = b"AVI " + hdrl + chunk(b"LIST", movi) + chunk(b"idx1", idx)
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path


FIXTURES = {"even_2997": (5, 48, 64, 29.97, None), "even_125": (4, 64, 80, 12.5, None),
            "odd_25": (4, 49, 65, 25, cv2.CAP_OPENCV_MJPEG)}


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    out = {}
    for i, (name, (n, h, w, fps, backend)) in enumerate(FIXTURES.items()):
        out[name] = cv2_write(root / f"{name}.avi", seeded_frames(n, h, w, seed=i), fps, backend)
    jpegs = avi_jpegs(out["even_2997"])
    for name, audio, rec in (("audio_first_rec", "first", True), ("audio_second", "second", False)):
        out[name] = build_avi(root / f"{name}.avi", jpegs, 64, 48, 2997, 100, audio=audio, rec=rec)
    out["no_dht"] = build_avi(root / "no_dht.avi", [strip_dht(j) for j in jpegs], 64, 48, 2997, 100)
    return out


@pytest.mark.parametrize("name", list(FIXTURES) + ["audio_first_rec", "audio_second", "no_dht"])
def test_load_video_equals_opencv_mjpeg_backend(videos, name):
    if name == "audio_second":
        # OpenCV's MJPEG backend opens an AVI only when its MJPEG stream is
        # the last: this file's frames are held to cv2.imdecode, which that
        # backend equals, and its header to the FFmpeg backend's reading
        want = [cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_COLOR) for j in avi_jpegs(videos["even_2997"])]
        _, (fps, count, w, h) = cv2_read(videos[name], cv2.CAP_FFMPEG)
    else:
        want, (fps, count, w, h) = cv2_read(videos[name])
    got = list(load_video(videos[name], rgb=False))
    assert len(got) == len(want) == count > 0
    assert all(np.array_equal(g, x) for g, x in zip(got, want))
    rgb = list(load_video(videos[name]))
    assert all(np.array_equal(g, x[..., ::-1]) for g, x in zip(rgb, want))
    info = get_video_info(videos[name])
    assert (info["fps"], info["frame_count"], info["width"], info["height"]) == (fps, count, w, h)


@pytest.mark.parametrize("max_frames", [None, 0, 2, 50])
def test_load_video_max_frames_as_the_jax_package(videos, monkeypatch, max_frames):
    monkeypatch.setattr(cv2, "VideoCapture", lambda src: _VideoCapture(src, cv2.CAP_OPENCV_MJPEG))
    want = list(jax_loader.load_video(videos["even_2997"], rgb=True, max_frames=max_frames))
    got = list(load_video(videos["even_2997"], rgb=True, max_frames=max_frames))
    assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_get_video_info_equals_the_jax_package(videos, name):
    assert get_video_info(videos[name]) == jax_loader.get_video_info(videos[name])


def test_unsupported_containers_and_codecs_raise_with_a_roadmap_pointer(tmp_path):
    """What the port still does not read or write: an MP4 whose track is
    H.264 (`avc1`), `.mpg` output; `.webm` output raises the JAX package's
    RuntimeError. VP8 and VP9 in WebM now read as OpenCV reads them, and
    `.mkv` output is written (`tests/test_torch_vp8.py` and
    `tests/test_torch_vp9.py` hold them in full)."""
    frames = seeded_frames(2, 48, 64, seed=9)
    for fourcc, name in (("VP80", "v.webm"), ("VP90", "v9.webm")):
        writer = cv2.VideoWriter(str(tmp_path / name), cv2.VideoWriter_fourcc(*fourcc), 25, (64, 48))
        for f in frames:
            writer.write(f)
        writer.release()
        want = list(jax_loader.load_video(tmp_path / name))
        assert len(want) == 2 and all(np.array_equal(g, w) for g, w in zip(load_video(tmp_path / name), want))
        assert get_video_info(tmp_path / name) == jax_loader.get_video_info(tmp_path / name)
    shutil.copyfile(AVC1_MP4, tmp_path / "h.mp4")
    for read in (get_video_info, load_video):
        with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 11\.2"):
            read(tmp_path / "h.mp4")
    with pytest.raises(NotImplementedError, match="avc1"):
        get_video_info(tmp_path / "h.mp4")
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 11\.2"):
        create_video_writer(tmp_path / "o.mpg", 25, (64, 48))
    with pytest.raises(RuntimeError, match="no working codec"):
        create_video_writer(tmp_path / "o.webm", 25, (64, 48))
    writer = create_video_writer(tmp_path / "o.mkv", 25, (64, 48))
    writer.write(frames[0])
    writer.release()
    assert get_video_info(tmp_path / "o.mkv")["frame_count"] == 1
    with pytest.raises(FileNotFoundError):
        get_video_info(tmp_path / "missing.avi")


@pytest.mark.parametrize("sampling", ["420", "422", "444", "grey"])
def test_jpeg_without_huffman_tables_decodes_as_opencv(tmp_path, sampling):
    """libjpeg-turbo gives a JPEG without DHT the Annex K.3 tables: a still
    through `load_image` and the bytes through `decode_jpeg` equal OpenCV's."""
    img = seeded_frames(1, 37, 53, seed=3)[0]
    factor = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
              "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "grey": None}[sampling]
    params = [] if factor is None else [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor]
    data = cv2.imencode(".jpg", img[..., 0] if factor is None else img, params)[1].tobytes()
    bare = strip_dht(data)
    assert len(bare) < len(data) and b"\xff\xc4" not in bare[:bare.index(b"\xff\xda")]
    want = cv2.imdecode(np.frombuffer(bare, np.uint8), cv2.IMREAD_COLOR)
    assert np.array_equal(want, cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    assert np.array_equal(decode_jpeg(bare)[..., ::-1], want)
    (tmp_path / "bare.jpg").write_bytes(bare)
    assert np.array_equal(load_image(tmp_path / "bare.jpg", rgb=False), want)


def test_jpeg_own_huffman_tables_replace_the_standard_ones():
    """An optimised JPEG's own DHT (not Annex K's) still decodes as OpenCV's."""
    img = seeded_frames(1, 40, 56, seed=4)[0]
    data = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_OPTIMIZE, 1])[1].tobytes()
    assert np.array_equal(decode_jpeg(data)[..., ::-1], cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))


@pytest.mark.parametrize("fps,size", [(25, (64, 48)), (29.97, (65, 49)), (12.5, (80, 64))])
def test_port_written_avi_reads_back_in_both_opencv_backends(tmp_path, fps, size):
    w, h = size
    frames = seeded_frames(4, h, w, seed=5)
    writer = create_video_writer(tmp_path / "out" / "v.avi", fps, size)
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()
    assert not writer.isOpened()
    for backend in (cv2.CAP_FFMPEG, cv2.CAP_OPENCV_MJPEG):
        got, info = cv2_read(tmp_path / "out" / "v.avi", backend)
        assert info == (fps, 4, w, h) and len(got) == 4
    want = [cv2.imdecode(cv2.imencode(".jpg", f)[1], cv2.IMREAD_COLOR) for f in frames]
    assert all(np.array_equal(g, x) for g, x in zip(got, want))
    assert all(np.array_equal(g, x) for g, x in zip(load_video(tmp_path / "out" / "v.avi", rgb=False), want))
    assert get_video_info(tmp_path / "out" / "v.avi")["fps"] == fps
    with pytest.raises(ValueError, match="frame"):
        avi.AviWriter(tmp_path / "bad.avi", fps, size).write(frames[0][:-1])


def test_opendml_parts_read_whole_in_both_opencv_backends(tmp_path, monkeypatch):
    monkeypatch.setattr(avi, "RIFF_LIMIT", 12_000)
    frames = seeded_frames(10, 48, 64, seed=6)
    writer = avi.AviWriter(tmp_path / "v.avi", 30, (64, 48))
    for f in frames:
        writer.write(f)
    writer.release()
    data = (tmp_path / "v.avi").read_bytes()
    parts = [fcc for fcc, _, _ in riff_chunks(data, 0, len(data))]
    assert parts[0] == b"RIFF" and data.count(b"AVIX") >= 3 and len(parts) == data.count(b"AVIX") + 1
    want = [cv2.imdecode(cv2.imencode(".jpg", f)[1], cv2.IMREAD_COLOR) for f in frames]
    for backend in (cv2.CAP_FFMPEG, cv2.CAP_OPENCV_MJPEG):
        got, info = cv2_read(tmp_path / "v.avi", backend)
        assert info == (30, 10, 64, 48) and len(got) == 10
    assert all(np.array_equal(g, x) for g, x in zip(got, want))
    mine = list(load_video(tmp_path / "v.avi", rgb=False))
    assert len(mine) == 10 and all(np.array_equal(g, x) for g, x in zip(mine, want))
    assert get_video_info(tmp_path / "v.avi")["frame_count"] == 10


def test_fps_becomes_a_rational_that_gives_it_back():
    assert avi.fps_ratio(29.97) == (2997, 100) and avi.fps_ratio(12.5) == (25, 2)
    assert avi.fps_ratio(30000 / 1001) == (30000, 1001) and avi.fps_ratio(25) == (25, 1)
    for bad in (0, -1.0):
        with pytest.raises(ValueError):
            avi.fps_ratio(bad)


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
def world(tmp_path_factory):
    """The JAX-written golden detect and segment checkpoints and an 11-frame video."""
    root = tmp_path_factory.mktemp("demo")
    ckpts = {}
    for task in ("detect", "segment"):
        z = np.load(REPO / "tests" / "golden" / f"golden_{task}_n_v{GOLDEN_VERSION}.npz")
        sd = golden_state_dict(str(z["names"]).split("\n"), unpack_manifest(z["shapes_flat"], z["shapes_ndims"]))
        nc = int(z["nc"])
        params, state = convert_state_dict(sd, jax_build_spec(task, "n", nc=nc))
        model = jax_model_module.YOLO11Model.from_params(params, task=task, size="n", nc=nc, fused=False,
                                                         state=state, names={i: f"c{i}" for i in range(nc)},
                                                         compute_dtype=jnp.float32)
        ckpts[task] = model.save(root / f"{task}.msgpack")
    rng = np.random.default_rng(7)
    video = cv2_write(root / "v.avi", [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(11)], 25)
    return {"root": root, "ckpts": ckpts, "video": video}


def run_demos(world, monkeypatch, task, draw, **kw):
    """detect_video of both packages on the world's video: (summary, [(frame,
    drawn, out)], written BGR frames) for the JAX demo and for the port's."""
    monkeypatch.setattr(jax_demo_module, "YOLO11Model", _JaxF32Model)
    monkeypatch.setattr(cv2, "VideoCapture",
                        lambda src, *a: _VideoCapture(src, *a) if a else _VideoCapture(src, cv2.CAP_OPENCV_MJPEG))
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
        demo = module.DetectionDemo(model_path=str(world["ckpts"][task]), conf_threshold=0.25, imgsz=IMGSZ, **extra)
        summary = demo.detect_video(world["video"], world["root"] / "out.avi", **kw)
        runs.append((summary, draws, written))
    return runs


@pytest.mark.parametrize("max_frames", [None, 6])
def test_detect_video_matches_the_jax_demo(world, monkeypatch, max_frames):
    (want, jax_draws, jax_written), (got, draws, written) = run_demos(
        world, monkeypatch, "detect", "draw_detections", batch_size=4, max_frames=max_frames, progress_every=1)
    n = max_frames or 11
    assert got["total_frames"] == want["total_frames"] == n == len(draws) == len(jax_draws) == len(written)
    assert got["total_detections"] == want["total_detections"] > 0
    assert got["video_info"] == want["video_info"]
    assert set(got) == set(want)
    for (frame, (boxes, scores, classes, _), out), (jframe, (jboxes, jscores, jclasses, _), _) in zip(
            draws, jax_draws):
        assert np.array_equal(frame, jframe)
        np.testing.assert_array_equal(classes, jclasses)
        np.testing.assert_allclose(boxes, jboxes, atol=1e-2, rtol=0)
        np.testing.assert_allclose(scores, jscores, atol=1e-5, rtol=0)
    assert all(np.array_equal(w, out[..., ::-1]) for w, (_, _, out) in zip(written, draws))
    assert all(np.array_equal(w, cv2.cvtColor(out, cv2.COLOR_RGB2BGR)) for w, (_, _, out) in zip(jax_written,
                                                                                                 jax_draws))


def test_segment_video_per_frame_matches_the_jax_demo(world, monkeypatch):
    (want, jax_draws, _), (got, draws, written) = run_demos(world, monkeypatch, "segment", "draw_results",
                                                            max_frames=3)
    assert got["total_frames"] == want["total_frames"] == len(draws) == len(written) == 3
    assert got["total_detections"] == want["total_detections"] > 0
    assert got["video_info"] == want["video_info"]
    for (frame, (r,), out), (jframe, (jr,), _), w in zip(draws, jax_draws, written):
        assert np.array_equal(frame, jframe) and np.array_equal(w, out[..., ::-1])
        np.testing.assert_array_equal(r.classes, jr.classes)
        np.testing.assert_allclose(r.boxes, jr.boxes, atol=1e-2, rtol=0)
        np.testing.assert_allclose(r.scores, jr.scores, atol=1e-5, rtol=0)
        assert (r.masks.numpy() != np.asarray(jr.masks)).mean() <= 1e-4


def test_decode_failure_reaches_the_caller(world, tmp_path):
    """A corrupt frame in the middle of a video fails the run: no summary."""
    jpegs = avi_jpegs(world["video"])
    jpegs[6] = jpegs[6][:40]
    video = build_avi(tmp_path / "broken.avi", jpegs, 64, 48, 25, 1)
    demo = port_demo_module.DetectionDemo(model_path=str(world["ckpts"]["detect"]), conf_threshold=0.25,
                                          imgsz=IMGSZ, device="cpu", compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="JPEG"):
        demo.detect_video(video, tmp_path / "out.avi", batch_size=4)
    with pytest.raises(NotImplementedError, match=r"item 11\.3"):
        demo.detect_webcam(0)


@pytest.mark.parametrize("container", ["avi", "mp4"])
def test_cli_video_demo_exits_as_the_jax_cli(world, tmp_path, capsys, caplog, monkeypatch, container):
    """`demo --input v.avi --output o.avi` exits 0 in both CLIs and writes a
    video cv2 reads; an `.mp4` whose track is H.264 (`avc1`) exits 1 in the
    port, as a failing demo exits in `main.py`, citing ROADMAP Queue 1 item
    11.2, and so does a camera index, citing item 11.3."""
    monkeypatch.setattr(jax_demo_module, "YOLO11Model", _JaxF32Model)
    if container == "mp4":
        video = tmp_path / "v.mp4"
        shutil.copyfile(AVC1_MP4, video)
        for source, item in ((str(video), "item 11.2"), ("0", "item 11.3")):
            caplog.clear()
            with caplog.at_level(logging.ERROR):
                rc = port_cli.YOLO11CLI().run(["demo", "--input", source, "--model-path",
                                               str(world["ckpts"]["detect"]), "--imgsz", str(IMGSZ), "--device",
                                               "cpu"])
            assert rc == 1 and any(item in r.getMessage() for r in caplog.records), source
        return
    argv = ["demo", "--input", str(world["video"]), "--model-path", str(world["ckpts"]["detect"]), "--imgsz",
            str(IMGSZ), "--conf", "0.25", "--batch", "4"]
    jax_rc = jax_main.YOLO11CLI().run(argv + ["--output", str(tmp_path / "jax.avi")])
    port_rc = port_cli.YOLO11CLI().run(argv + ["--output", str(tmp_path / "port.avi"), "--device", "cpu"])
    capsys.readouterr()
    assert jax_rc == port_rc == 0
    for name in ("jax", "port"):
        frames, (fps, count, w, h) = cv2_read(tmp_path / f"{name}.avi", cv2.CAP_FFMPEG)
        assert (fps, count, w, h, len(frames)) == (25, 11, 64, 48, 11)
