"""The port's OpenCV-free image IO and YOLO dataset vs OpenCV and the JAX package, on the CPU.

PNG and BMP files written by `cv2.imwrite` (grey, RGB, RGBA, odd widths,
every compression level, so libpng's Sub, Up, Average and Paeth rows all
occur) decode to exactly the pixels of `cv2.imread(path, cv2.IMREAD_COLOR)`;
`save_image` round-trips and OpenCV reads what it writes (its rows are
filter 0). Labels, records and the letterboxed val batches of a detect and
a pose dataset equal the JAX package's, images bit for bit. `cv2` is
imported here only: the port never imports it.
"""

import zlib

import cv2
import numpy as np
import pytest

from yolo_infer_tpu.data import dataset as jds
from yolo_infer_tpu_torch.data import dataset as tds
from yolo_infer_tpu_torch.data.loader import PNG_SIGNATURE, list_image_files, load_image, save_image
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _picture(rng, h, w, c):
    """Smooth gradients with noisy patches: libpng's adaptive filtering then
    picks different filters on different rows."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 3 + yy * k) % 256 for k in range(1, c + 1)], -1).astype(np.int64)
    noise = rng.integers(0, 256, (h, w, c))
    patch = (yy // 8 + xx // 8) % 3 == 0
    return np.where(patch[..., None], noise, base).astype(np.uint8)


def _png_filters(path):
    """The set of row filter types used in a (non-interlaced, 8-bit) PNG."""
    data = path.read_bytes()
    pos, idat, hdr = len(PNG_SIGNATURE), b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        hdr = body if kind == b"IHDR" else hdr
        idat += body if kind == b"IDAT" else b""
        pos += 12 + n
    w, h, ctype = int.from_bytes(hdr[:4], "big"), int.from_bytes(hdr[4:8], "big"), hdr[9]
    stride = w * {0: 1, 2: 3, 6: 4}[ctype] + 1
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


@pytest.mark.parametrize("level", range(10))
def test_png_decode_matches_cv2_at_every_compression_level(tmp_path, level):
    rng = np.random.default_rng(level)
    filters = set()
    for i, (h, w, c) in enumerate([(37, 53, 3), (41, 29, 4), (33, 61, 1)]):
        img = _picture(rng, h, w, c)
        path = tmp_path / f"im{i}.png"
        assert cv2.imwrite(str(path), img[..., 0] if c == 1 else img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(load_image(path, rgb=False), want)
        np.testing.assert_array_equal(load_image(path), cv2.cvtColor(want, cv2.COLOR_BGR2RGB))
        filters |= _png_filters(path)
    assert {1, 2, 3, 4} <= filters, filters  # filter 0: save_image's rows, below


@pytest.mark.parametrize("hw", [(31, 45), (16, 16), (7, 1)])
def test_bmp_decode_matches_cv2(tmp_path, hw):
    img = _picture(np.random.default_rng(hw[1]), *hw, 3)
    path = tmp_path / "im.bmp"
    assert cv2.imwrite(str(path), img)
    np.testing.assert_array_equal(load_image(path, rgb=False), cv2.imread(str(path), cv2.IMREAD_COLOR))


@pytest.mark.parametrize("shape", [(29, 47, 3), (20, 33, 4), (25, 18)])
def test_save_image_round_trips_and_cv2_reads_it(tmp_path, shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "sub" / "out.png"
    save_image(path, img)
    assert _png_filters(path) == {0}
    rgb = np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img[..., :3]
    np.testing.assert_array_equal(load_image(path), rgb)
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_COLOR), np.ascontiguousarray(rgb[..., ::-1]))


def test_unsupported_and_missing_files_raise(tmp_path):
    img = _picture(np.random.default_rng(0), 16, 16, 3)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4.3"):
        load_image(tmp_path / "a.jpg")
    with pytest.raises(FileNotFoundError):
        load_image(tmp_path / "missing.png")
    with pytest.raises(NotImplementedError):
        save_image(tmp_path / "b.jpg", img)
    save_image(tmp_path / "c.png", img)
    broken = bytearray((tmp_path / "c.png").read_bytes())
    broken[40] ^= 0xFF  # inside IDAT: the CRC no longer matches
    (tmp_path / "c.png").write_bytes(bytes(broken))
    with pytest.raises(ValueError, match="corrupt"):
        load_image(tmp_path / "c.png")


def _dataset(tmp_path, task):
    """Four PNG frames of three sizes with detect or pose labels (one frame
    unlabelled, one label line out of range), as a dict config."""
    rng = np.random.default_rng(7)
    img_dir, lbl_dir = tmp_path / "images" / "val", tmp_path / "labels" / "val"
    lbl_dir.mkdir(parents=True)
    for i, (h, w) in enumerate([(48, 64), (64, 40), (48, 64), (50, 50)]):
        save_image(img_dir / f"im{i}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        if i == 3:
            continue
        lines = []
        for j in range(i + 1):
            box = rng.uniform(0.2, 0.5, 4).round(4)
            kpts = " ".join(f"{x:.4f} {y:.4f} {v}" for x, y, v in zip(rng.uniform(0, 1, 17), rng.uniform(0, 1, 17),
                                                                    rng.integers(0, 3, 17)))
            lines.append(f"{j % 2} {' '.join(map(str, box))}" + (f" {kpts}" if task == "pose" else ""))
        lines.append("5 0.5 0.5 0.1 0.1" + (" 0.5 0.5 2" * 17 if task == "pose" else ""))  # class out of range
        (lbl_dir / f"im{i}.txt").write_text("\n".join(lines) + "\n")
    return {"path": str(tmp_path), "val": "images/val", "names": ["a", "b"]}


@pytest.mark.parametrize("task", ["detect", "pose"])
def test_dataset_and_letterboxed_batches_match_jax(tmp_path, task):
    cfg = _dataset(tmp_path, task)
    got, want = tds.YOLODataset(cfg, task=task), jds.YOLODataset(cfg, task=task)
    assert got.images == want.images and got.nc == want.nc == 2 and got.names == want.names
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)
    batches = list(zip(tds.iter_letterboxed_batches(got, 3, 64), jds.iter_letterboxed_batches(want, 3, 64)))
    assert len(batches) == 2
    for g, w in batches:
        assert g["n"] == w["n"]
        np.testing.assert_array_equal(g["images"], w["images"])
        for gm, wm in zip(g["metas"], w["metas"]):
            assert gm.keys() == wm.keys()
            for key in gm:
                np.testing.assert_array_equal(np.asarray(gm[key]), np.asarray(wm[key]), err_msg=key)


def test_labels_config_and_file_listing_match_jax(tmp_path):
    import yaml

    cfg = _dataset(tmp_path, "pose")
    (tmp_path / "data.yaml").write_text(yaml.safe_dump(cfg))
    assert tds.parse_dataset_config(tmp_path / "data.yaml") == jds.parse_dataset_config(tmp_path / "data.yaml")
    for lp in sorted((tmp_path / "labels" / "val").glob("*.txt")):
        for g, w in zip(tds.load_labels(lp, 2), jds.load_labels(lp, 2)):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(tds.load_labels_keypoints(lp, (17, 3), 2), jds.load_labels_keypoints(lp, (17, 3), 2)):
            np.testing.assert_array_equal(g, w)
    img = tmp_path / "images" / "val" / "im0.png"
    assert tds.label_path_for(img) == jds.label_path_for(img)
    assert list_image_files(tmp_path / "images") == sorted((tmp_path / "images" / "val").glob("*.png"))


@pytest.mark.parametrize("task", ["segment", "obb"])
def test_unported_dataset_tasks_raise(tmp_path, task):
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tds.YOLODataset(_dataset(tmp_path, "detect"), task=task)
