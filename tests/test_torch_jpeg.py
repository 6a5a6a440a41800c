"""The port's JPEG decoder and encoder against the JAX package's OpenCV IO.

`yolo_infer_tpu_torch/data/jpeg.py` decodes baseline JPEG to the pixels of
`cv2.imread(path, cv2.IMREAD_COLOR)` (the JAX package's `load_image`) and
encodes what `cv2.imwrite(".jpg")` writes (its `save_image`). Held here bit
for bit, RGB and BGR, over qualities 50, 75, 95 and 100, the five samplings
OpenCV writes (444, 422, 420, 440, 411), grey, restart intervals, sizes
1x1, 17x33 and 97x129, the eight EXIF orientations and `assets/sample.jpg`;
arithmetic and 12-bit files raise with a ROADMAP pointer (progressive,
CMYK, TIFF and WebP, which raised before, decode to OpenCV's pixels); the committed fixtures'
manifest (`tests/torch_jpeg/`, which the card's check reads) matches OpenCV.
"""

import hashlib
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
FIXTURES = REPO / "tests" / "torch_jpeg"

from yolo_infer_tpu.data.loader import load_image as jax_load_image  # noqa: E402
from yolo_infer_tpu.data.loader import save_image as jax_save_image  # noqa: E402
from yolo_infer_tpu_torch.data import jpeg  # noqa: E402
from yolo_infer_tpu_torch.data.loader import load_image, save_image  # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def frame(seed, h, w):
    """Gradients, flat boxes and noise: the structure of a photo, small."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w, 1), y * 255 // max(h, 1), (x + y) * 7 % 256], -1)
    img[h // 4: h // 2, w // 3: w // 2 + 1] = rng.integers(0, 256, 3)
    return np.clip(img + rng.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)


def write(tmp_path, name, img_rgb, params=()):
    path = tmp_path / name
    assert cv2.imwrite(str(path), np.ascontiguousarray(img_rgb[..., ::-1]) if img_rgb.ndim == 3 else img_rgb,
                       list(params))
    return path


def assert_decodes_as_opencv(path):
    for rgb in (True, False):
        got, want = load_image(path, rgb=rgb), jax_load_image(path, rgb=rgb)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want), f"{path.name} rgb={rgb}: {np.abs(got.astype(int) - want).max()}"


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decode_equals_opencv_over_quality_and_sampling(tmp_path, quality, sampling):
    img = frame(quality + len(sampling), 17, 33)
    path = write(tmp_path, "a.jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    assert_decodes_as_opencv(path)


@pytest.mark.parametrize("size", [(1, 1), (17, 33), (97, 129), (2, 3), (9, 4)])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decode_equals_opencv_at_edge_sizes(tmp_path, size, sampling):
    """Partial MCUs at the right and bottom edges, and chroma 1 or 2 samples
    wide (jdsample.c replicates there instead of filtering)."""
    path = write(tmp_path, "a.jpg", frame(sum(size), *size), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    assert_decodes_as_opencv(path)


@pytest.mark.parametrize("size", [(1, 1), (23, 31), (97, 129)])
def test_decode_grey_replicates_to_three_channels(tmp_path, size):
    path = write(tmp_path, "g.jpg", frame(3, *size)[..., 1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert_decodes_as_opencv(path)


@pytest.mark.parametrize("interval", [1, 2, 5])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_decode_restart_intervals(tmp_path, interval, sampling):
    path = write(tmp_path, "r.jpg", frame(interval, 48, 64), [cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
                                                               cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    data = path.read_bytes()
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert_decodes_as_opencv(path)


def with_exif_orientation(data: bytes, orientation: int, big_endian: bool) -> bytes:
    o = ">" if big_endian else "<"
    tiff = ((b"MM" if big_endian else b"II") + struct.pack(o + "HI", 42, 8) + struct.pack(o + "H", 1)
            + struct.pack(o + "HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(o + "I", 0))
    body = b"Exif\0\0" + tiff
    return data[:2] + struct.pack(">BBH", 0xFF, 0xE1, len(body) + 2) + body + data[2:]


@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_decode_applies_exif_orientation(tmp_path, orientation, big_endian):
    base = cv2.imencode(".jpg", frame(orientation, 40, 64))[1].tobytes()
    path = tmp_path / "o.jpg"
    path.write_bytes(with_exif_orientation(base, orientation, big_endian))
    assert_decodes_as_opencv(path)
    assert load_image(path).shape == ((64, 40, 3) if orientation >= 5 else (40, 64, 3))


def test_decode_sample_image():
    assert_decodes_as_opencv(REPO / "assets" / "sample.jpg")


def test_decode_unsupported_kinds_raise_with_a_roadmap_pointer(tmp_path):
    """Arithmetic-coded and 12-bit JPEG still raise citing the roadmap; the
    kinds this test once expected to raise (progressive, CMYK, TIFF and
    WebP written by cv2) now decode to OpenCV's pixels."""
    img = frame(0, 24, 32)
    progressive = write(tmp_path, "p.jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    base = cv2.imencode(".jpg", img)[1].tobytes()
    sof = base.index(b"\xff\xc0")
    arithmetic = tmp_path / "a.jpg"
    arithmetic.write_bytes(base[:sof] + b"\xff\xc9" + base[sof + 2:])
    twelve_bit = tmp_path / "t.jpg"
    twelve_bit.write_bytes(base[:sof + 4] + b"\x0c" + base[sof + 5:])
    # a CMYK frame: four components after an Adobe APP14 segment (transform 0), written by Pillow
    from PIL import Image

    cmyk = tmp_path / "c.jpg"
    Image.fromarray(np.concatenate([img, img[..., :1]], -1), "CMYK").save(cmyk, "JPEG")
    assert b"Adobe" in cmyk.read_bytes()
    tiff, webp = write(tmp_path, "x.tiff", img), write(tmp_path, "x.webp", img)
    for path in (progressive, cmyk, tiff, webp):
        assert_decodes_as_opencv(path)
    for path in (arithmetic, twelve_bit):
        with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 10"):
            load_image(path)
    with pytest.raises(FileNotFoundError):
        load_image(tmp_path / "missing.jpg")
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(base[: len(base) // 2])


@pytest.mark.parametrize("size", [(1, 1), (17, 33), (48, 64), (97, 129)])
def test_encode_bytes_equal_opencv_save_image(tmp_path, size):
    """The port's `.jpg` save_image writes the bytes cv2.imwrite writes (the
    JAX package's save_image), so OpenCV decodes both to the same pixels."""
    img = frame(size[0], *size)
    save_image(tmp_path / "port.jpg", img)
    jax_save_image(tmp_path / "jax.jpg", img)
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "jax.jpg").read_bytes()
    assert np.array_equal(jax_load_image(tmp_path / "port.jpg"), load_image(tmp_path / "jax.jpg"))


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("size", [(23, 37), (8, 16), (16, 9), (9, 16), (2, 31), (31, 2), (33, 17)])
def test_encode_bytes_equal_opencv_over_sizes(seed, size):
    img = frame(seed, *size)
    assert jpeg.encode_jpeg(img) == cv2.imencode(".jpg", img[..., ::-1])[1].tobytes()


def test_encode_grey_bytes_equal_opencv():
    grey = frame(5, 29, 41)[..., 0]
    assert jpeg.encode_jpeg(grey) == cv2.imencode(".jpg", grey)[1].tobytes()


def test_fixture_manifest_matches_opencv_and_the_port():
    """The committed fixtures decode under OpenCV to the manifest's pixels,
    the port decodes them to the same, and the encoder hashes are OpenCV's
    bytes of `chip_smoke.jpeg_frame` (the card's check reads all three)."""
    from chip_smoke import jpeg_frame

    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    assert len(manifest["files"]) >= 13
    for name, entry in manifest["files"].items():
        path = FIXTURES / name
        for img in (cv2.imread(str(path), cv2.IMREAD_COLOR), load_image(path, rgb=False)):
            assert list(img.shape) == entry["shape"], name
            assert hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest() == entry["sha256"], name
    for seed, digest in enumerate(manifest["encoder"]["sha256"]):
        frame_rgb = jpeg_frame(seed)
        assert hashlib.sha256(cv2.imencode(".jpg", frame_rgb[..., ::-1])[1].tobytes()).hexdigest() == digest
        assert hashlib.sha256(jpeg.encode_jpeg(frame_rgb)).hexdigest() == digest
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 200_000
