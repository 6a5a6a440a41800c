"""The port's still-image decoders and writers against the JAX package's OpenCV IO.

`yolo_infer_tpu_torch/data/` reads every format of `IMAGE_EXTS` to the
pixels of `cv2.imread(path, cv2.IMREAD_COLOR)` (the JAX package's
`load_image`): progressive (cut short too: block smoothing), CMYK, YCCK
and Adobe-RGB JPEG, every PNG colour type and depth with palettes and
Adam7, every BMP kind OpenCV reads, baseline, 1-bit, CCITT and JPEG-in-TIFF
and lossless and lossy WebP. Held here bit for bit, RGB and BGR, on the
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
import importlib.util
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
from yolo_infer_tpu_torch.data import ccitt, jpeg, webp  # noqa: E402
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
            "vp8_1x1", "vp8x_exif6_lossy", "vp8_anim", "vp8_anmf_offset", "prog_cut1_", "prog_cut3_", "prog_cut9_",
            "bilevel_none_", "bilevel_packbits_", "bilevel_miniswhite_", "bilevel_fill2_", "ccitt_rle_",
            "ccitt_g3_1d_", "ccitt_g3_2d_3", "ccitt_g3_2d_fill_", "ccitt_g3_2d_strips_", "ccitt_g4_3",
            "ccitt_g4_fill2_", "ccitt_g4_miniswhite_", "ccitt_g4_strips_", "jpeg_in_tiff_rgb_3", "jpeg_in_tiff_grey_",
            "jpeg_in_tiff_rgb_strips_", "jpeg_in_tiff_ycc_strips_", "jpeg_in_tiff_420_strips_",
            "jpeg_in_tiff_420_tiles_"]
    missing = [w for w in want if not any(n.startswith(w) for n in names)]
    assert not missing, missing
    assert {Path(n).suffix for n in names} | {".jpeg", ".tiff"} == IMAGE_EXTS
    sizes = [p.stat().st_size for p in FIXTURES.iterdir()]
    assert sum(sizes) < 350_000
    for name, entry in MANIFEST["files"].items():
        assert entry["shape"][0] <= 64 and entry["shape"][1] <= 96, name


@pytest.mark.parametrize("name", sorted(MANIFEST["raises"]))
def test_refused_kinds_raise(name):
    """Arithmetic, lossless and 12-bit JPEG and old-style JPEG-in-TIFF
    (compression 6) raise citing the roadmap; a TIFF whose orientation
    OpenCV cannot read, and a JPEG-in-TIFF file whose strip is no JPEG
    stream, raise what the JAX package raises."""
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
    of AC1-AC9 incomplete: OpenCV decodes it with block smoothing, and so
    does the port now (the name is the test's from before the smoothing was
    ported); every cut and the complete file equal `cv2.imdecode`."""
    full = cv2.imencode(".jpg", frame(9, 48, 64), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    sos = [i for i in range(len(full) - 1) if full[i: i + 2] == b"\xff\xda"]
    assert len(sos) == 10  # jpeg_simple_progression for YCbCr
    for n in (1, 3, 9):
        assert (FIXTURES / f"prog_cut{n}_48x64.jpg").read_bytes() == full[: sos[n]] + b"\xff\xd9"
    for cut in [full[: sos[n]] + b"\xff\xd9" for n in range(1, len(sos))] + [full]:
        want = cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR)
        assert np.array_equal(jpeg.decode_jpeg(cut)[..., ::-1], want)


@pytest.mark.parametrize("size", [(24, 16), (40, 56), (17, 33), (9, 4), (8, 8), (1, 1)])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_every_progressive_cut_smooths_as_opencv(size, sampling):
    """`decompress_smooth_data` at every cut of a progressive file: the DC
    re-estimated while a component has no AC coefficient, AC1-AC9 from the
    5x5 DC neighbourhood after, clamped below 2**Al; the neighbour rows of
    the last iMCU row and the padding blocks below an iMCU row, and the
    repeated edge columns (two blocks wide: 16 px)."""
    img = frame(sum(size), *size)
    full = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      SAMPLING[sampling]])[1].tobytes()
    grey = cv2.imencode(".jpg", img[..., 1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    for data in (full, grey):
        sos = [i for i in range(len(data) - 1) if data[i: i + 2] == b"\xff\xda"]
        for n in range(1, len(sos)):
            cut = data[: sos[n]] + b"\xff\xd9"
            want = cv2.imdecode(np.frombuffer(cut, np.uint8), cv2.IMREAD_COLOR)
            assert np.array_equal(jpeg.decode_jpeg(cut)[..., ::-1], want), (n, len(sos))


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


def fixture_tools():
    """`tests/torch_formats/make_fixtures.py` under a name of its own (other
    fixture directories have a `make_fixtures` module too)."""
    spec = importlib.util.spec_from_file_location("formats_make_fixtures", FIXTURES / "make_fixtures.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CCITT = {"rle": ("tiff_ccitt", {}), "g3_1d": ("group3", {}), "g3_2d": ("group3", {292: 1}),
         "g3_2d_fill": ("group3", {292: 5}), "g4": ("group4", {})}


@pytest.mark.parametrize("kind", sorted(CCITT))
def test_ccitt_every_run_length_of_both_colours_equals_opencv(tmp_path, kind):
    """Every terminating, make-up and extended make-up code of both colours
    (runs 0..2623, and longer runs of several make-up codes), coded by
    libtiff through Pillow, decodes as OpenCV decodes it."""
    lengths = list(range(64)) + [64 * k + t for k in range(1, 42) for t in (0, 1, 63)] + [2624, 4000, 5200]
    width = 2 * max(lengths) + 9
    rows = []
    for n in lengths:
        for first in (True, False):
            row = np.full(width, first)
            row[n: 2 * n] = not first
            rows.append(row)
    path = tmp_path / "runs.tif"
    path.write_bytes(fixture_tools().pil_tiff(Image.fromarray(np.array(rows)), compression=CCITT[kind][0],
                                              tiffinfo=CCITT[kind][1]))
    assert_decodes_as_opencv(path)


BILEVEL = {"raw": ("raw", {}, 65536), "packbits": ("packbits", {}, 65536), "miniswhite": ("raw", {262: 0}, 65536),
           "g4_fill2": ("group4", {266: 2}, 65536), "g3_2d_strips": ("group3", {292: 1}, 24),
           **{k: (c, info, 65536) for k, (c, info) in CCITT.items()}}


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (37, 100)])
@pytest.mark.parametrize("kind", sorted(BILEVEL))
def test_bilevel_tiff_equals_opencv(tmp_path, kind, size):
    """Random blocks and single pixels, 1-bit uncompressed or PackBits or
    under each CCITT coding, min-is-white, fill order 2, several strips."""
    rng = np.random.default_rng(sum(size) + len(kind))
    h, w = size
    bits = np.kron(rng.random((h // 3 + 1, w // 5 + 1)) > 0.5, np.ones((3, 5), bool))[:h, :w]
    bits ^= rng.random((h, w)) > 0.93
    compression, info, strip_size = BILEVEL[kind]
    path = tmp_path / "b.tif"
    path.write_bytes(fixture_tools().pil_tiff(Image.fromarray(bits), strip_size, compression=compression,
                                              tiffinfo=info))
    assert_decodes_as_opencv(path)


@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("sampling", ["420", "422", "444"])
def test_jpeg_in_tiff_upsamples_within_each_strip_or_tile(tmp_path, sampling, layout):
    """YCbCr JPEG-in-TIFF: libjpeg converts each strip or tile on its own,
    so the fancy upsampler repeats the edge at every boundary."""
    tools = fixture_tools()
    img = frame(len(sampling) + len(layout), 45, 70)
    h, w = img.shape[:2]
    factors = {"420": [2, 2], "422": [2, 1], "444": [1, 1]}[sampling]
    tags = tools.base_tags(w, h, 8, 6, 3, 7)
    tags[530] = (3, factors)
    params = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if layout == "strips":
        tags[278] = (3, [16])
        units = [cv2.imencode(".jpg", img[y: y + 16, :, ::-1], params)[1].tobytes() for y in range(0, h, 16)]
    else:
        tags.update({322: (3, [32]), 323: (3, [16])})
        padded = np.pad(img, ((0, 48 - h), (0, 96 - w), (0, 0)), mode="reflect")
        units = [cv2.imencode(".jpg", padded[y: y + 16, x: x + 32, ::-1], params)[1].tobytes()
                 for y in range(0, h, 16) for x in range(0, w, 32)]
    path = tmp_path / "j.tif"
    path.write_bytes(tools.tiff("<", tags, units))
    assert_decodes_as_opencv(path)
    whole = jpeg.decode_jpeg(cv2.imencode(".jpg", img[..., ::-1], params)[1].tobytes())
    # the cuts part upsampling that crosses them: rows under vertical subsampling, columns in tiles
    crossed = sampling == "420" or (layout == "tiles" and sampling == "422")
    assert not crossed or not np.array_equal(load_image(path), whole)


def test_ccitt_uncompressed_mode_raises_citing_the_roadmap():
    with pytest.raises(NotImplementedError, match=r"uncompressed mode.*ROADMAP Queue 1 item 10"):
        ccitt.decode_ccitt(b"\0\1", 8, 1, 3, t4_options=3)
    with pytest.raises(NotImplementedError, match=r"uncompressed mode.*ROADMAP Queue 1 item 10"):
        ccitt.decode_ccitt(bytes([0b00000010, 0b11100000]), 8, 1, 4)  # an extension code
