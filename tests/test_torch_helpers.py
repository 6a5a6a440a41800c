"""The port's batch loader and file helpers against the JAX package's, on the CPU.

`DataLoader` (batching, seeded shuffle, reset between epochs),
`load_image_batch`, `ProgressTracker`, `get_file_hash`, `compare_files`,
`backup_file`, `clean_old_files`, `validate_model_path` and
`create_experiment_dir` run on the same inputs through `yolo_infer_tpu` and
`yolo_infer_tpu_torch` and give the same results. Clocks are frozen where a
result carries the time.
"""

import os
from datetime import datetime

import cv2
import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from yolo_infer_tpu.data import loader as jloader
from yolo_infer_tpu.utils import helpers as jhelpers
from yolo_infer_tpu_torch.data import loader as tloader
from yolo_infer_tpu_torch.utils import helpers as thelpers


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """Seven small images, JPEG and PNG, one in a subdirectory."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    (root / "sub").mkdir()
    names = ["a.jpg", "b.png", "c.jpg", "d.jpeg", "sub/e.jpg", "sub/f.png", "g.jpg"]
    for i, name in enumerate(names):
        img = rng.integers(0, 256, (6 + i, 9 + i, 3), dtype=np.uint8)
        cv2.imwrite(str(root / name), img)
    return root


def _epochs(loader, n=2):
    """Each epoch's batches as (path strings, images)."""
    return [[([str(p) for p in paths], imgs) for paths, imgs in loader] for _ in range(n)]


@pytest.mark.parametrize("batch_size,shuffle,seed,rgb", [
    (1, False, None, True), (3, False, None, False), (2, True, 0, True), (3, True, 7, False), (8, True, 3, True)])
def test_data_loader_batches_equal_jax(image_dir, batch_size, shuffle, seed, rgb):
    """The same batches in the same order, over two epochs (a shuffled
    loader draws a new order at each reset from its seeded generator)."""
    kw = dict(batch_size=batch_size, shuffle=shuffle, seed=seed, rgb=rgb)
    want_loader, got_loader = jloader.DataLoader(image_dir, **kw), tloader.DataLoader(image_dir, **kw)
    assert len(got_loader) == len(want_loader) == -(-7 // batch_size)
    want, got = _epochs(want_loader), _epochs(got_loader)
    for we, ge in zip(want, got):
        assert [p for p, _ in ge] == [p for p, _ in we]
        for (_, wi), (_, gi) in zip(we, ge):
            assert all(np.array_equal(a, b) for a, b in zip(wi, gi)) and len(wi) == len(gi)
    if shuffle:
        assert [p for p, _ in got[0]] != [p for p, _ in got[1]]


def test_data_loader_from_a_list_and_empty_source(image_dir):
    files = [image_dir / "g.jpg", image_dir / "a.jpg", image_dir / "sub" / "f.png"]
    want = _epochs(jloader.DataLoader(files, batch_size=2), 1)
    got = _epochs(tloader.DataLoader(files, batch_size=2), 1)
    assert [p for p, _ in got[0]] == [p for p, _ in want[0]]
    for mod in (jloader, tloader):
        with pytest.raises(ValueError):
            mod.DataLoader([])


@pytest.mark.parametrize("rgb", [True, False])
def test_load_image_batch_equals_jax(image_dir, rgb):
    paths = sorted(p for p in image_dir.rglob("*") if p.is_file())
    want, got = jloader.load_image_batch(paths, rgb), tloader.load_image_batch(paths, rgb)
    assert len(got) == len(want) == 7
    assert all(np.array_equal(a, b) for a, b in zip(want, got))


def test_progress_tracker_equals_jax(monkeypatch):
    """On one clock, the two trackers report the same count, rate and ETA."""
    ticks = iter([100.0, 100.0, 102.0, 102.0, 105.0, 105.0, 105.0, 105.0])
    monkeypatch.setattr("time.perf_counter", lambda: next(ticks))
    want, got = jhelpers.ProgressTracker(10, "w"), thelpers.ProgressTracker(10, "w")
    assert got.update(4) == want.update(4) == {"count": 4, "total": 10, "rate": 2.0, "eta_s": 3.0,
                                              "elapsed_s": 2.0}
    assert got.update(6) == want.update(6)
    assert got.update(0) == want.update(0)


@pytest.mark.parametrize("algorithm", ["md5", "sha1", "sha256"])
@pytest.mark.parametrize("size", [0, 1, 4097])
def test_file_hash_equals_jax(tmp_path, algorithm, size):
    f = tmp_path / "blob.bin"
    f.write_bytes(np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes())
    want = jhelpers.get_file_hash(f, algorithm)
    assert thelpers.get_file_hash(f, algorithm) == want
    assert thelpers.get_file_hash(f, algorithm, chunk=7) == want


@pytest.mark.parametrize("other,equal", [(b"abcdef", True), (b"abcdeg", False), (b"abcde", False)])
def test_compare_files_equals_jax(tmp_path, other, equal):
    a, b = tmp_path / "a", tmp_path / "b"
    a.write_bytes(b"abcdef")
    b.write_bytes(other)
    assert thelpers.compare_files(a, b) == jhelpers.compare_files(a, b) == equal


class _FrozenDatetime(datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


@pytest.mark.parametrize("to_dir", [False, True])
def test_backup_file_equals_jax(tmp_path, monkeypatch, to_dir):
    """The same backup name and bytes, in `backups/` beside the file or in
    the given directory."""
    for mod in (jhelpers, thelpers):
        monkeypatch.setattr(mod, "datetime", _FrozenDatetime)
    out = {}
    for name, mod in (("jax", jhelpers), ("port", thelpers)):
        src = tmp_path / name / "weights.msgpack"
        src.parent.mkdir()
        src.write_bytes(b"\x01\x02" * 50)
        dst = mod.backup_file(src, tmp_path / name / "bk" if to_dir else None)
        assert dst.read_bytes() == src.read_bytes()
        out[name] = dst.relative_to(tmp_path / name)
    assert out["port"] == out["jax"]
    assert out["port"].name == "weights_20260102_030405.msgpack"


@pytest.mark.parametrize("pattern,keep_last", [("*", 5), ("*.log", 2), ("*.log", 0), ("*.txt", 9)])
def test_clean_old_files_equals_jax(tmp_path, pattern, keep_last):
    """The oldest files matching `pattern` go, the newest `keep_last` stay."""
    kept = {}
    for name, mod in (("jax", jhelpers), ("port", thelpers)):
        d = tmp_path / name
        d.mkdir()
        for i, fname in enumerate(["r3.log", "r1.log", "n.txt", "r2.log", "m.txt", "r0.log", "x.bin"]):
            (d / fname).write_text(fname)
            os.utime(d / fname, (1_000_000 + 60 * i, 1_000_000 + 60 * i))
        removed = mod.clean_old_files(d, pattern, keep_last)
        kept[name] = ([p.name for p in removed], sorted(p.name for p in d.iterdir()))
    assert kept["port"] == kept["jax"]


@pytest.mark.parametrize("ref,make", [
    ("yolo11n", False), ("yolo11x-seg", False), ("yolo11m-obb.pt", False), ("yolo11s-pose", False),
    ("yolo11l-cls", False), ("resnet50", False), ("yolo12n", False), ("w.msgpack", True), ("w.pt", True),
    ("w.safetensors", True), ("w.ckpt", True), ("yolo11n.txt", True), ("w.onnx", True)])
def test_validate_model_path_equals_jax(tmp_path, monkeypatch, ref, make):
    """Names by their pattern; files that exist by their suffix."""
    monkeypatch.chdir(tmp_path)
    if make:
        (tmp_path / ref).write_bytes(b"x")
    assert thelpers.validate_model_path(ref) == jhelpers.validate_model_path(ref)


@pytest.mark.parametrize("name", ["exp", "run-1"])
def test_create_experiment_dir_equals_jax(tmp_path, monkeypatch, name):
    for mod in (jhelpers, thelpers):
        monkeypatch.setattr(mod, "datetime", _FrozenDatetime)
    want = jhelpers.create_experiment_dir(tmp_path / "jax", name)
    got = thelpers.create_experiment_dir(tmp_path / "port", name)
    assert got.is_dir() and want.is_dir()
    assert got.relative_to(tmp_path / "port") == want.relative_to(tmp_path / "jax")
    assert got.name == f"{name}_20260102_030405"
    assert thelpers.create_experiment_dir(tmp_path / "port", name) == got  # a second call reuses it
