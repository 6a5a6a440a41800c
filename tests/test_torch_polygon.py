"""The port's OpenCV-free polygon routines (`data/polygon.py`) vs OpenCV, on the CPU.

`cv2` is imported here only; the port never imports it. Hypothesis draws
the contours (derandomized, so every run checks the same examples):

- `fill_poly` equals `cv2.fillPoly(canvas, [pts], value)` bit for bit on
  uint8 and int32 canvases, for convex, concave, self-intersecting and
  collinear contours, single points, horizontal edges and points off the
  canvas, including far off it.
- `contour_area` equals `cv2.contourArea` exactly, on integer and float points.
- `convex_hull` equals `cv2.convexHull` point for point, and `min_area_rect`
  equals `cv2.minAreaRect` within 1e-4 px and 1e-5 rad (every example so
  far is bit-equal) on point sets, rotated rectangles and squares (exact
  ties between the calipers' edges).
"""

import cv2
import numpy as np
from hypothesis import given, settings, strategies as st

from yolo_infer_tpu_torch.data.polygon import contour_area, convex_hull, fill_poly, min_area_rect
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SETTINGS = settings(max_examples=100, deadline=None, derandomize=True)


def _canvas_and_contour(kind, h, w, n, data):
    """A contour of `kind` for an (h, w) canvas, from hypothesis' `data`."""
    coord = lambda lo, hi: st.integers(lo, hi)  # noqa: E731
    if kind == "inside":  # anything inside: concave and self-intersecting included
        pts = [(data.draw(coord(0, w - 1)), data.draw(coord(0, h - 1))) for _ in range(n)]
    elif kind == "convex":  # points around a centre in angle order
        cx, cy = data.draw(coord(-4, w + 4)), data.draw(coord(-4, h + 4))
        ang = sorted(data.draw(st.floats(0, 2 * np.pi, allow_nan=False)) for _ in range(n))
        rad = [data.draw(st.floats(1, 2 * max(h, w))) for _ in range(n)]
        pts = [(round(cx + r * np.cos(a)), round(cy + r * np.sin(a))) for a, r in zip(ang, rad)]
    elif kind == "off_canvas":  # ends past every side, by a little
        pts = [(data.draw(coord(-w, 2 * w)), data.draw(coord(-h, 2 * h))) for _ in range(n)]
    elif kind == "far":  # ends far past the canvas
        pts = [(data.draw(coord(-3000, 3000)), data.draw(coord(-3000, 3000))) for _ in range(n)]
    elif kind == "horizontal":  # pairs of points on one row: horizontal edges, repeated rows
        ys = [data.draw(coord(-2, h + 1)) for _ in range((n + 1) // 2)]
        pts = [(data.draw(coord(-2, w + 1)), ys[i // 2]) for i in range(n)]
    else:  # collinear: points on one line, a single point when n == 1
        x0, y0 = data.draw(coord(-3, w + 3)), data.draw(coord(-3, h + 3))
        dx, dy = data.draw(coord(-3, 3)), data.draw(coord(-3, 3))
        pts = [(x0 + dx * t, y0 + dy * t) for t in sorted(data.draw(coord(-6, 6)) for _ in range(n))]
    return np.asarray(pts, np.int32).reshape(-1, 2)


@SETTINGS
@given(kind=st.sampled_from(["inside", "convex", "off_canvas", "far", "horizontal", "collinear"]),
       h=st.integers(1, 40), w=st.integers(1, 40), n=st.integers(1, 12), data=st.data())
def test_fill_poly_equals_cv2_fillpoly(kind, h, w, n, data):
    pts = _canvas_and_contour(kind, h, w, n, data)
    for dtype, value in ((np.uint8, 1), (np.int32, data.draw(st.integers(1, 60)))):
        base = np.full((h, w), 2 if dtype == np.int32 else 0, dtype)
        want = cv2.fillPoly(base.copy(), [pts], value)
        got = fill_poly(base.copy(), pts, value)
        np.testing.assert_array_equal(got, want, err_msg=f"{kind} {pts.tolist()}")


def test_fill_poly_fills_the_shapes_the_masks_use():
    """The cases the validator draws: a proto-grid canvas, polygons reaching
    its far edge (a normalized 1.0 maps one column past it) and a dense
    hull of a blob."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        m = int(rng.integers(8, 48))
        poly = rng.uniform(0, 1, (int(rng.integers(3, 30)), 2))
        poly[rng.random(len(poly)) < 0.2] = 1.0
        pts = np.round(poly * m).astype(np.int32)
        want = cv2.fillPoly(np.zeros((m, m), np.uint8), [pts], 1)
        np.testing.assert_array_equal(fill_poly(np.zeros((m, m), np.uint8), pts, 1), want)
        assert want.any()


@SETTINGS
@given(pts=st.lists(st.tuples(st.integers(-500, 500), st.integers(-500, 500)), min_size=0, max_size=40),
       scale=st.sampled_from([1.0, 0.37, 1.5]))
def test_contour_area_equals_cv2(pts, scale):
    p = (np.asarray(pts, np.float64).reshape(-1, 2) * scale).astype(np.float32)
    assert contour_area(p) == cv2.contourArea(p)


def _rect_corners(cx, cy, w, h, a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[cx + dx * c - dy * s, cy + dx * s + dy * c]
                       for dx, dy in ((-w / 2, -h / 2), (w / 2, -h / 2), (w / 2, h / 2), (-w / 2, h / 2))], np.float32)


def _assert_rect_close(got, want, where):
    (gx, gy), (gw, gh), ga = got
    (wx, wy), (ww, wh), wa = want
    np.testing.assert_allclose([gx, gy, gw, gh], [wx, wy, ww, wh], atol=1e-4, rtol=0, err_msg=where)
    assert abs(np.deg2rad(ga) - np.deg2rad(wa)) <= 1e-5, (where, got, want)


@SETTINGS
@given(kind=st.sampled_from(["points", "grid", "rectangle", "square", "rounded"]), n=st.integers(1, 16),
       data=st.data())
def test_min_area_rect_and_hull_equal_cv2(kind, n, data):
    if kind in ("rectangle", "square", "rounded"):
        cx, cy = (data.draw(st.floats(0, 1024)) for _ in range(2))
        w = data.draw(st.floats(1, 600))
        h = w if kind == "square" else data.draw(st.floats(1, 600))
        p = _rect_corners(cx, cy, w, h, data.draw(st.floats(0, np.pi)))
        p = np.round(p) if kind == "rounded" else p
        p = p[data.draw(st.permutations(range(4)))]
    elif kind == "grid":  # repeated and collinear points
        p = np.asarray([(data.draw(st.integers(0, 6)), data.draw(st.integers(0, 6))) for _ in range(n)], np.float32)
    else:
        p = np.asarray([(data.draw(st.floats(0, 1024, width=32)), data.draw(st.floats(0, 1024, width=32)))
                        for _ in range(n)], np.float32)
    p = p + np.float32(0)  # no negative zeros: cv2.convexHull returns no hull for a set of them
    np.testing.assert_array_equal(convex_hull(p), cv2.convexHull(p).reshape(-1, 2))
    _assert_rect_close(min_area_rect(p), cv2.minAreaRect(p), f"{kind} {p.tolist()}")


def test_min_area_rect_on_axis_aligned_and_degenerate_sets():
    for pts in ([[0, 0], [10, 0], [10, 5], [0, 5]], [[0, 0], [4, 0], [4, 4], [0, 4]], [[3, 3]],
                [[0, 0], [3, 4]], [[3, 4], [0, 0]], [[0, 0], [0, 5]], [[0, 0], [5, 0]], [[5, 0], [0, 0]],
                [[0, 0], [1, 1], [2, 2]], [[0, 2], [1, 1], [2, 0]]):
        p = np.asarray(pts, np.float32)
        assert min_area_rect(p) == cv2.minAreaRect(p), pts
