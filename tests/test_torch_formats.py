"""The port's still-image decoders and writers against the JAX package's OpenCV IO.

`yolo_infer_tpu_torch/data/` reads every format of `IMAGE_EXTS` to the
pixels of `cv2.imread(path, cv2.IMREAD_COLOR)` (the JAX package's
`load_image`): progressive, CMYK, YCCK and Adobe-RGB JPEG, every PNG
colour type and depth with palettes and Adam7, every BMP kind OpenCV reads,
baseline TIFF and lossless WebP. Held here bit for bit, RGB and BGR, on the
committed fixtures (`tests/torch_formats/`, made by its `make_fixtures.py`;
their manifest, which the card's check reads, matches OpenCV) and on files
written here: progressive JPEG at every sampling, a CMYK sweep over every K
level. The fixtures use every VP8L transform, predictor mode and coding
tool. `save_image` writes `.bmp` bytes equal to `cv2.imwrite`'s, and
`.tif`, `.tiff` and `.webp` that OpenCV and the port read back exactly. The
kinds still refused raise citing ROADMAP Queue 1 item 10 (a TIFF that
OpenCV cannot read raises what the JAX package raises).
"""

import hashlib
import io
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
FIXTURES = REPO / "tests" / "torch_formats"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())

from yolo_infer_tpu.data.loader import load_image as jax_load_image  # noqa: E402
from yolo_infer_tpu.data.loader import save_image as jax_save_image  # noqa: E402
from yolo_infer_tpu_torch.data import jpeg, webp  # noqa: E402
from yolo_infer_tpu_torch.data.loader import IMAGE_EXTS, load_image, save_image  # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def frame(seed, h, w):
    """Gradients, a flat box and noise: the structure of a photo, small."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w, 1), y * 255 // max(h, 1), (x + y) * 7 % 256], -1)
    img[h // 4: h // 2, w // 3: w // 2 + 1] = rng.integers(0, 256, 3)
    return np.clip(img + rng.integers(-20, 21, img.shape), 0, 255).astype(np.uint8)


def digest(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def assert_decodes_as_opencv(path):
    for rgb in (True, False):
        got, want = load_image(path, rgb=rgb), jax_load_image(path, rgb=rgb)
        assert got.dtype == np.uint8 and got.shape == want.shape, (path.name, got.shape, want.shape)
        assert np.array_equal(got, want), f"{path.name} rgb={rgb}: {np.abs(got.astype(int) - want).max()}"


@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_decodes_as_opencv(name):
    """Each committed fixture: the manifest's hash is OpenCV's pixels, and the
    port's `load_image` equals the JAX package's in RGB and BGR."""
    path, entry = FIXTURES / name, MANIFEST["files"][name]
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert list(want.shape) == entry["shape"] and digest(want) == entry["sha256"]
    assert_decodes_as_opencv(path)


def test_fixtures_cover_every_kind_and_stay_small():
    names = set(MANIFEST["files"])
    want = ["prog_444", "prog_420", "prog_grey", "prog_rst", "prog_odd", "cmyk_", "ycck_", "adobe_rgb", "pal8_trns",
            "pal1_", "pal2_", "pal4_", "grey1_", "grey2_", "grey4_", "grey16_", "rgb16_", "adam7_", "exif6_37x53.png",
            "bw1_", "pal4_31", "pal8_31", "rle4_", "rle8_", "rgb555_", "rgb565_", "bgr24_", "bitfields32_", "topdown",
            "os2_", "none_", "lzw_pred2", "deflate_", "packbits_", "tiled_", "planar2_", "bigendian_", "pal8_lzw",
            "miniswhite", "vp8l_m", "vp8l_pal", "vp8x_exif", "vp8_lossy", "vp8_alpha", "vp8_cv2_q", "vp8_m",
            "vp8_1x1", "vp8x_exif6_lossy", "vp8_anim", "vp8_anmf_offset"]
    missing = [w for w in want if not any(n.startswith(w) for n in names)]
    assert not missing, missing
    assert {Path(n).suffix for n in names} | {".jpeg", ".tiff"} == IMAGE_EXTS
    sizes = [p.stat().st_size for p in FIXTURES.iterdir()]
    assert sum(sizes) < 350_000
    for name, entry in MANIFEST["files"].items():
        assert entry["shape"][0] <= 64 and entry["shape"][1] <= 96, name


@pytest.mark.parametrize("name", sorted(MANIFEST["raises"]))
def test_refused_kinds_raise(name):
    """Arithmetic, lossless and 12-bit JPEG, a progressive JPEG cut before its
    AC1-AC9 are complete (libjpeg-turbo would smooth its blocks) and
    JPEG-in-TIFF raise citing the roadmap; a TIFF whose orientation
    OpenCV cannot read raises what the JAX package raises."""
    path, error = FIXTURES / name, MANIFEST["raises"][name]["error"]
    if error == "FileNotFoundError":
        with pytest.raises(FileNotFoundError):
            jax_load_image(path)
        with pytest.raises(FileNotFoundError):
            load_image(path)
    else:
        with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item 10"):
            load_image(path)


def test_progressive_cuts_raise_where_opencv_smooths_and_the_complete_file_decodes():
    """A progressive file cut after any of its scans but the last leaves some
    of AC1-AC9 incomplete: OpenCV decodes it with block smoothing, the port
    refuses it; the complete file never takes that branch."""
    full = cv2.imencode(".jpg", frame(9, 48, 64), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    sos = [i for i in range(len(full) - 1) if full[i: i + 2] == b"\xff\xda"]
    assert len(sos) == 10  # jpeg_simple_progression for YCbCr
    assert (FIXTURES / "prog_cut3_48x64.jpg").read_bytes() == full[: sos[3]] + b"\xff\xd9"
    for n in range(1, len(sos)):
        cut = full[: sos[n]] + b"\xff\xd9"
        assert cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR) is not None
        with pytest.raises(NotImplementedError, match=r"block smoothing.*ROADMAP Queue 1 item 10"):
            jpeg.decode_jpeg(cut)
    want = cv2.imdecode(np.frombuffer(full, np.uint8), cv2.IMREAD_COLOR)
    assert np.array_equal(jpeg.decode_jpeg(full)[..., ::-1], want)


@pytest.mark.parametrize("size", [(17, 33), (48, 64), (9, 4)])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_progressive_decode_equals_opencv(tmp_path, size, sampling):
    path = tmp_path / "p.jpg"
    assert cv2.imwrite(str(path), frame(sum(size), *size)[..., ::-1],
                       [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]])
    assert b"\xff\xc2" in path.read_bytes()
    assert_decodes_as_opencv(path)


@pytest.mark.parametrize("adobe", ["cmyk", "ycck", "none"])
def test_four_component_jpeg_sweep_equals_opencv(tmp_path, adobe):
    """Every K level against seeded C, M, Y at quality 100: OpenCV's
    icvCvt_CMYK2BGR_8u_C4C3R after libjpeg's CMYK or YCCK output."""
    rng = np.random.default_rng(len(adobe))
    cmyk = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
    cmyk[..., 3] = np.arange(64 * 64).reshape(64, 64) % 256
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=100)
    data = bytearray(buf.getvalue())
    at = data.index(b"Adobe")
    if adobe == "ycck":
        data[at + 11] = 2
    elif adobe == "none":
        del data[at - 4: at + 12]
    path = tmp_path / "c.jpg"
    path.write_bytes(bytes(data))
    assert_decodes_as_opencv(path)


def test_webp_fixtures_use_every_vp8l_tool(monkeypatch):
    """Across the WebP fixtures: all four transforms (colour indexing at each
    bundling width), the predictor's 14 modes, the colour cache, meta
    prefix codes and backward references."""
    seen = set()
    inverse, entropy, copy_value, unpredict = webp._inverse, webp._entropy_decode, webp._copy_value, webp._unpredict

    def spy_inverse(kind, bits, sub, w, h, img):
        seen.add(("transform", kind, bits if kind == webp._COLOR_INDEXING else None))
        return inverse(kind, bits, sub, w, h, img)

    def spy_entropy(r, w, h, groups, groups_of, meta_bits, cache_bits):
        seen.update({"cache"} if cache_bits else set())
        seen.update({"meta"} if groups_of else set())
        return entropy(r, w, h, groups, groups_of, meta_bits, cache_bits)

    def spy_copy(r, sym):
        seen.add("copy")
        return copy_value(r, sym)

    def spy_unpredict(px, modes, w, h):
        seen.update(("mode", m) for m in modes[w + 1:])
        return unpredict(px, modes, w, h)

    monkeypatch.setattr(webp, "_inverse", spy_inverse)
    monkeypatch.setattr(webp, "_entropy_decode", spy_entropy)
    monkeypatch.setattr(webp, "_copy_value", spy_copy)
    monkeypatch.setattr(webp, "_unpredict", spy_unpredict)
    for name in MANIFEST["files"]:
        if name.endswith(".webp"):
            load_image(FIXTURES / name)
    want = {("transform", k, None) for k in range(3)} | {("transform", 3, b) for b in range(4)}
    want |= {("mode", m) for m in range(14)} | {"cache", "meta", "copy"}
    assert want <= seen, sorted(map(str, want - seen))


@pytest.mark.parametrize("shape", [(29, 47, 3), (1, 1, 3), (20, 33, 3), (13, 9), (7, 5, 4)])
def test_bmp_save_bytes_equal_opencv(tmp_path, shape):
    """24-bit (the JAX package's save_image), 8-bit grey with its palette and
    32-bit BGRA: the bytes cv2.imwrite writes."""
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    save_image(tmp_path / "port.bmp", img)
    if len(shape) == 3 and shape[-1] == 3:
        jax_save_image(tmp_path / "ref.bmp", img)
    else:
        assert cv2.imwrite(str(tmp_path / "ref.bmp"), img if img.ndim == 2 else img[..., [2, 1, 0, 3]])
    assert (tmp_path / "port.bmp").read_bytes() == (tmp_path / "ref.bmp").read_bytes()
    assert_decodes_as_opencv(tmp_path / "port.bmp")


@pytest.mark.parametrize("shape", [(29, 47, 3), (1, 1, 3), (64, 96, 3), (13, 9), (20, 33, 4)])
@pytest.mark.parametrize("suffix", [".tif", ".tiff", ".webp"])
def test_tiff_and_webp_save_read_back_exactly(tmp_path, suffix, shape):
    """What the port writes (TIFF: LZW, predictor 2; WebP: VP8L) OpenCV and
    the port both read back to the written pixels."""
    img = np.random.default_rng(len(shape) + shape[0]).integers(0, 256, shape, dtype=np.uint8)
    img[: shape[0] // 2] //= 16  # runs for LZW and skewed histograms for the prefix codes
    path = tmp_path / f"out{suffix}"
    save_image(path, img)
    want = np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img[..., :3]
    assert np.array_equal(load_image(path), want)
    assert np.array_equal(cv2.imread(str(path), cv2.IMREAD_COLOR), np.ascontiguousarray(want[..., ::-1]))
    assert path.read_bytes()[:4] == (b"II*\0" if suffix != ".webp" else b"RIFF")


@pytest.mark.parametrize("value", [0, 200])
@pytest.mark.parametrize("suffix", [".bmp", ".tif", ".webp"])
def test_flat_images_save_and_read_back(tmp_path, suffix, value):
    """A one-colour image: one-symbol prefix codes (no bits a pixel) in WebP,
    padded to the 32 bytes under which OpenCV reads no WebP file."""
    img = np.full((5, 7, 3), value, np.uint8)
    path = tmp_path / f"flat{suffix}"
    save_image(path, img)
    assert np.array_equal(load_image(path), img)
    assert np.array_equal(cv2.imread(str(path), cv2.IMREAD_COLOR), img)
