"""The port's drawing utilities (`utils/visualization.py`) by geometry.

The JAX package draws with OpenCV's anti-aliased primitives; the port draws
the same shapes without anti-aliasing, so it is held to where it draws, not
to OpenCV's pixels: a box's edges carry its class colour, nothing is drawn
outside the boxes and their labels, masks blend only where they are set (and
as the JAX package blends them), oriented boxes follow the port's
rotated-box corners. The grid and the result files equal the JAX package's.
"""

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401

from yolo_infer_tpu_torch.core.predictor import Results
from yolo_infer_tpu_torch.ops.rotated import xywhr_to_corners
from yolo_infer_tpu_torch.utils import visualization as vis

BG = 40  # background grey: no palette colour has it in every channel


def canvas(h=96, w=128):
    return np.full((h, w, 3), BG, np.uint8)


def drawn(before, after):
    return (before != after).any(-1)


def box_band(shape, box, lw):
    """The pixels the outline of `box` may cover at thickness `lw`."""
    h, w = shape
    ys, xs = np.mgrid[0:h, 0:w]
    x1, y1, x2, y2 = (int(v) for v in box)
    lo, hi = lw // 2, lw - 1 - lw // 2
    outer = (xs >= x1 - lo) & (xs <= x2 + hi) & (ys >= y1 - lo) & (ys <= y2 + hi)
    inner = (xs > x1 + hi) & (xs < x2 - lo) & (ys > y1 + hi) & (ys < y2 - lo)
    return outer & ~inner


def rect_mask(shape, a, b):
    h, w = shape
    ys, xs = np.mgrid[0:h, 0:w]
    return ((xs >= min(a[0], b[0])) & (xs <= max(a[0], b[0])) & (ys >= min(a[1], b[1])) & (ys <= max(a[1], b[1])))


@pytest.mark.parametrize("line_width", [None, 1, 3])
def test_boxes_carry_their_colour_and_nothing_is_drawn_elsewhere(line_width):
    img = canvas(96, 256)
    boxes = np.array([[10, 30, 50, 70], [130, 5, 240, 40], [150, 60, 190, 94.7]], np.float32)
    scores, classes = np.array([0.9, 0.5, 0.25]), np.array([0, 3, 13])
    names = {0: "person", 3: "car", 13: "bench"}
    out = vis.draw_detections(img, boxes, scores, classes, names, line_width=line_width)
    assert out.shape == img.shape and out.dtype == np.uint8 and np.array_equal(img, canvas(96, 256))
    lw = line_width or max(round((96 + 256) / 2 * 0.003), 2)
    allowed = np.zeros(img.shape[:2], bool)
    for box, score, cls in zip(boxes, scores, classes):
        colour = vis.get_color(cls)
        alone = vis.draw_detections(img, box[None], score[None], cls[None], names, line_width=line_width)
        x1, y1, x2, y2 = (int(v) for v in box)
        # every edge pixel (the box's own outline, clipped to the image) carries the colour
        edge = np.concatenate([alone[y1, x1: x2 + 1], alone[min(y2, 95), x1: x2 + 1], alone[y1: y2 + 1, x1],
                               alone[y1: min(y2, 95) + 1, x2]])
        label_a, label_b, _ = vis.label_geometry((x1, y1), f"{names[int(cls)]} {score:.2f}", lw / 3)
        in_label = rect_mask(img.shape[:2], label_a, label_b)
        assert ((edge == colour).all(-1) | (edge == 255).all(-1)).all(), cls  # a label's text may cross an edge
        px = alone[in_label]
        assert ((px == colour).all(-1) | (px == 255).all(-1)).all()  # the filled label and its white text
        assert not (drawn(img, alone) & ~(box_band(img.shape[:2], box, lw) | in_label)).any()
        allowed |= box_band(img.shape[:2], box, lw) | in_label
    changed = drawn(img, out)
    assert changed.any() and not (changed & ~allowed).any()
    assert vis.get_color(3) == vis.get_color(13)  # a 10-colour cycle


def test_labels_hold_white_text_inside_their_filled_box():
    img = canvas(64, 200)
    out = vis.draw_detections(img, np.array([[20, 40, 180, 60]]), np.array([0.87]), np.array([1]), {1: "bicycle"})
    a, b, _ = vis.label_geometry((20, 40), "bicycle 0.87", 2 / 3)
    region = out[min(a[1], b[1]): max(a[1], b[1]) + 1, min(a[0], b[0]): max(a[0], b[0]) + 1]
    white = (region == 255).all(-1)
    assert 20 < white.sum() < white.size // 2  # glyph pixels, not a filled block
    assert ((region == vis.get_color(1)).all(-1) | white).all()
    w, h = vis.text_size("bicycle 0.87", 2 / 3)
    assert (w, h) == (abs(b[0] - a[0]), abs(b[1] - a[1]) - 3)


def test_masks_blend_only_where_set_and_as_the_jax_package():
    from yolo_infer_tpu.utils.visualization import draw_segmentation_masks as jax_masks

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    masks = (rng.random((3, 48, 64)) > 0.7).astype(np.float32)
    classes = np.array([2, 5, 7])
    out = vis.draw_segmentation_masks(img, masks, classes)
    assert np.array_equal(out, jax_masks(img, masks, classes))
    assert not drawn(img, out)[masks.max(0) <= 0.5].any()
    only = (masks[0] > 0.5) & (masks[1:].max(0) <= 0.5)
    want = (img[only] * 0.5 + np.array(vis.get_color(2), np.float32) * 0.5).astype(np.uint8)
    assert np.array_equal(out[only], want)


def test_masks_on_another_grid_are_resized_bilinearly():
    img = canvas(40, 60)
    m = np.zeros((1, 20, 30), np.float32)
    m[0, 5:15, 10:20] = 1.0
    out = vis.draw_segmentation_masks(img, m, np.array([4]))
    changed = drawn(img, out)
    ys, xs = np.nonzero(changed)
    assert changed.any() and ys.min() >= 9 and ys.max() <= 30 and xs.min() >= 19 and xs.max() <= 40


def _segment_distance(px, py, a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = b - a
    t = np.clip(((px - a[0]) * d[0] + (py - a[1]) * d[1]) / max(d @ d, 1e-12), 0, 1)
    return np.hypot(px - a[0] - t * d[0], py - a[1] - t * d[1])


def test_obb_outlines_follow_the_rotated_box_corners():
    img = canvas(120, 160)
    obb = np.array([[60.0, 55.0, 70.0, 30.0, 0.5], [120.0, 80.0, 30.0, 50.0, -1.1]], np.float32)
    out = vis.draw_obb(img, obb, np.array([0.8, 0.6]), np.array([1, 6]), {1: "ship", 6: "plane"})
    corners = xywhr_to_corners(obb).astype(np.int32)
    changed = drawn(img, out)
    near = np.zeros(changed.shape, bool)
    ys, xs = np.mgrid[0:120, 0:160]
    for pts, (cx, cy, *_), cls in zip(corners, obb, (1, 6)):
        colour = vis.get_color(cls)
        for x, y in pts:
            assert (out[y, x] == colour).all() or (out[y, x] == 255).all()  # or under a label's text
        for i in range(4):
            near |= _segment_distance(xs, ys, pts[i], pts[(i + 1) % 4]) <= 1.0
        # the label's text starts at the box's centre
        tw, th = vis.text_size("plane 0.60", 0.5)
        near |= rect_mask(changed.shape, (int(cx), int(cy) - 12), (int(cx) + tw, int(cy) + 4))
    assert changed.any() and not (changed & ~near).any()


def test_keypoints_draw_confident_points_and_their_skeleton_only():
    img = canvas(80, 80)
    kpts = np.zeros((1, 17, 3), np.float32)
    kpts[0, :, 0] = np.linspace(10, 70, 17)
    kpts[0, :, 1] = 40
    kpts[0, :, 2] = 0.9
    kpts[0, 3, 2] = 0.1  # not confident: no circle, no edge to it
    kpts[0, 3, :2] = (40, 5)
    out = vis.draw_keypoints(img, kpts)
    assert (out[37, int(kpts[0, 0, 0])] == (0, 255, 0)).all()  # the circle above the skeleton line
    assert (out[5, 40] == BG).all() and not drawn(img, out)[:30].any()


def test_classify_results_draw_the_top_label():
    img = canvas(64, 200)
    r = Results(boxes=np.zeros((0, 4)), scores=np.zeros(0), classes=np.zeros(0, np.int32), orig_shape=(64, 200),
                names={0: "cat", 1: "dog"}, probs=np.array([0.2, 0.8], np.float32))
    changed = drawn(img, vis.draw_results(img, r))
    ys, xs = np.nonzero(changed)
    tw, th = vis.text_size("dog 0.80", 1.0)
    assert changed.any() and xs.min() >= 10 and xs.max() < 10 + tw and ys.min() >= 30 - th - 4 and ys.max() <= 38


def test_grid_equals_the_jax_package():
    from yolo_infer_tpu.utils.visualization import create_grid_visualization as jax_grid

    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, s, dtype=np.uint8) for s in ((40, 60, 3), (64, 64, 3), (30, 90, 3))]
    got = vis.create_grid_visualization(imgs, cols=2, cell_size=(48, 40))
    assert got.shape == (80, 96, 3) and np.array_equal(got, jax_grid(imgs, cols=2, cell_size=(48, 40)))


@pytest.mark.parametrize("fmt", ["json", "csv", "txt"])
def test_result_files_equal_the_jax_package(tmp_path, fmt):
    from yolo_infer_tpu.utils.visualization import save_detection_results as jax_save

    results = [Results(boxes=np.array([[1.5, 2.25, 30.0, 40.0], [5, 6, 7, 8]], np.float32),
                       scores=np.array([0.9, 0.3125], np.float32), classes=np.array([0, 2], np.int32),
                       orig_shape=(48, 64), names={0: "a", 2: "c"}),
               Results(boxes=np.zeros((0, 4), np.float32), scores=np.zeros(0, np.float32),
                       classes=np.zeros(0, np.int32), orig_shape=(48, 64))]
    vis.save_detection_results(results, tmp_path / f"port.{fmt}", fmt)
    jax_save(results, tmp_path / f"jax.{fmt}", fmt)
    assert (tmp_path / f"port.{fmt}").read_text() == (tmp_path / f"jax.{fmt}").read_text()


def test_video_writer_raises_with_a_roadmap_pointer(tmp_path):
    """`.mp4`, `.m4v`, `.mov`, `.mkv` (MPEG-4 Part 2) and `.avi` (motion
    JPEG) are written; `.webm` raises the JAX package's RuntimeError and
    other containers (`.mpg`) raise with the roadmap pointer, both before
    anything is written."""
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 11"):
        vis.create_video_writer(tmp_path / "v.mpg", 30.0, (64, 48))
    with pytest.raises(RuntimeError, match="no working codec"):
        vis.create_video_writer(tmp_path / "v.webm", 30.0, (64, 48))
    assert not (tmp_path / "v.mpg").exists() and not (tmp_path / "v.webm").exists()
    writer = vis.create_video_writer(tmp_path / "v.mkv", 30.0, (64, 48))
    writer.release()
    assert (tmp_path / "v.mkv").read_bytes()[:4] == b"\x1a\x45\xdf\xa3"


@pytest.mark.parametrize("seed", range(4))
def test_rotated_box_corners_equal_opencv_box_points(seed):
    """`xywhr_to_corners` gives `cv2.boxPoints`' corners, in its order, for
    angles of both signs and past a quarter turn, within f32 rounding."""
    import cv2

    rng = np.random.default_rng(seed)
    n = 64
    boxes = np.stack([rng.uniform(0, 640, n), rng.uniform(0, 640, n), rng.uniform(1, 300, n),
                      rng.uniform(1, 300, n), rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)
    got = xywhr_to_corners(boxes)
    want = np.stack([cv2.boxPoints(((float(cx), float(cy)), (float(w), float(h)), float(np.degrees(r))))
                     for cx, cy, w, h, r in boxes])
    # OpenCV computes in float32: at most a few ulps of 640 (6.1e-5) apart
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
