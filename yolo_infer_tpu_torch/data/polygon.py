"""Polygon fill, contour area and minimum-area rectangle without OpenCV.

The JAX package builds segment and OBB ground truth with `cv2.fillPoly`,
`cv2.contourArea` and `cv2.minAreaRect`; the card's machine has no OpenCV,
so these are numpy copies of OpenCV's own algorithms (its `drawing.cpp`,
`shapedescr.cpp`, `convhull.cpp` and `rotcalipers.cpp`), step for step where
the order of operations decides the result:

  fill_poly       `cv2.fillPoly(canvas, [pts], value)` for one int32 contour,
                  LINE_8, shift 0: every edge drawn as an 8-connected
                  Bresenham line (clipped to the canvas), then the scanline
                  fill of the edge table with x in 16-bit fixed point, each
                  span from the ceiling of its left x to the floor of its
                  right. Bit for bit, points off the canvas and
                  self-intersecting contours included.
  contour_area    `cv2.contourArea(pts.astype(np.float32))`: the unsigned
                  shoelace sum, accumulated in float64 in OpenCV's order.
  min_area_rect   `cv2.minAreaRect(pts.astype(np.float32))`: Sklansky's
                  convex hull (OpenCV's orientation and start point), the
                  rotating calipers over its edges in f32 (OpenCV 5 picks
                  each turn by f32 cross products), the `RotatedRect` in f32
                  and OpenCV 5's angle convention, [-90, 0) degrees, so that
                  exact ties (a square) fall the same way.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

XY_SHIFT = 16  # drawing.cpp: x of the edge table in 16.16 fixed point
XY_ONE = 1 << XY_SHIFT

_f32 = np.float32


def _sign(v) -> int:
    return int(v > 0) - int(v < 0)


def _trunc_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """C's integer division (toward zero), elementwise; b != 0."""
    q = np.abs(a) // np.abs(b)
    return np.where((a >= 0) == (b >= 0), q, -q)


def _trunc(v: np.ndarray) -> np.ndarray:
    """C's cast of a double to int64 (toward zero)."""
    return np.trunc(v).astype(np.int64)


# --------------------------------------------------------------- fill_poly


def _clip_lines(w: int, h: int, x1, y1, x2, y2):
    """OpenCV's `clipLine(Size, Point2l&, Point2l&)` over arrays of segments:
    each clipped to [0, w-1] x [0, h-1] (an intersection truncated toward
    zero from a double, the second end's from the first's clipped end), and
    whether anything of it is inside."""
    right, bottom = w - 1, h - 1
    code = lambda x, y: (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8  # noqa: E731
    c1, c2 = code(x1, y1), code(x2, y2)
    go = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    f = lambda v: v.astype(np.float64)  # noqa: E731
    nz = lambda v: np.where(v == 0, 1, v)  # noqa: E731  (a masked-off lane's divisor)
    with np.errstate(all="ignore"):
        m = go & ((c1 & 12) != 0)
        a = np.where(c1 < 8, 0, bottom)
        x1 = np.where(m, x1 + _trunc(f(a - y1) * f(x2 - x1) / f(nz(y2 - y1))), x1)
        y1 = np.where(m, a, y1)
        c1 = np.where(m, (x1 < 0) + (x1 > right) * 2, c1)
        m = go & ((c2 & 12) != 0)
        a = np.where(c2 < 8, 0, bottom)
        x2 = np.where(m, x2 + _trunc(f(a - y2) * f(x2 - x1) / f(nz(y2 - y1))), x2)
        y2 = np.where(m, a, y2)
        c2 = np.where(m, (x2 < 0) + (x2 > right) * 2, c2)
        go = go & ((c1 & c2) == 0) & ((c1 | c2) != 0)
        m = go & (c1 != 0)
        a = np.where(c1 == 1, 0, right)
        y1 = np.where(m, y1 + _trunc(f(a - x1) * f(y2 - y1) / f(nz(x2 - x1))), y1)
        x1 = np.where(m, a, x1)
        c1 = np.where(m, 0, c1)
        m = go & (c2 != 0)
        a = np.where(c2 == 1, 0, right)
        y2 = np.where(m, y2 + _trunc(f(a - x2) * f(y2 - y1) / f(nz(x2 - x1))), y2)
        x2 = np.where(m, a, x2)
        c2 = np.where(m, 0, c2)
    return x1, y1, x2, y2, (c1 | c2) == 0


def _ragged(counts: np.ndarray):
    """(owner, index within owner) of sum(counts) items, counts[i] per owner i."""
    owner = np.repeat(np.arange(len(counts)), counts)
    starts = np.cumsum(counts) - counts
    return owner, np.arange(int(counts.sum())) - starts[owner]


def fill_polys(shape_hw: Tuple[int, int], polys: Sequence[np.ndarray]) -> np.ndarray:
    """What `cv2.fillPoly(np.zeros(shape_hw), [pts], 1)` sets, for each of
    `polys` (int32 points, LINE_8, shift 0): an (M, h, w) bool array, all
    polygons at once in numpy.

    `CollectPolyEdges`: each edge (the last point to the first, then in
    order) is drawn as an 8-connected line (a `LineIterator` left to right,
    the segment clipped to the canvas first: Bresenham with err = dx - 2dy,
    whose minor coordinate at step i is ceil((2dy i - dx) / 2dx)); an edge
    that is not horizontal enters the edge table with its original rows
    [y0, y1), its x at y0 in 16.16 fixed point and its slope dx (truncated
    toward zero). When an end lies off the canvas both come from the segment
    as `clipLine` leaves it (whether or not anything of it is inside): its
    clipped ends, or, when they share a row, its clipped x's at the original
    rows, so a stretch past a side runs down that side. `FillEdgeCollection`
    (a polygon with two edges or more): on each canvas row the active edges
    pair up in x order, and each pair fills columns ceil(x_left) to
    floor(x_right), clipped to the canvas. An active edge's x on row y is
    its x at y0 plus (y - y0) slopes, exactly as OpenCV's repeated int64
    additions give it.
    """
    h, w = shape_hw
    out = np.zeros((len(polys), h, w), bool)
    pts = [np.asarray(p).reshape(-1, 2).astype(np.int64) for p in polys]
    sizes = np.array([len(p) for p in pts], np.int64)
    if not sizes.sum():
        return out
    p1 = np.concatenate(pts)
    p0 = np.concatenate([np.roll(p, 1, axis=0) for p in pts])  # edge i: point i-1 -> point i
    poly = np.repeat(np.arange(len(pts)), sizes)
    x0, y0, x1, y1 = p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1]
    off = (x0 < 0) | (x0 >= w) | (x1 < 0) | (x1 >= w) | (y0 < 0) | (y0 >= h) | (y1 < 0) | (y1 >= h)
    cx0, cy0, cx1, cy1, inside = _clip_lines(w, h, x0, y0, x1, y1)
    cx0, cy0, cx1, cy1 = (np.where(off, c, v) for c, v in ((cx0, x0), (cy0, y0), (cx1, x1), (cy1, y1)))

    # the lines: clipped, left to right, Bresenham
    draw = ~off | inside
    swap = cx1 < cx0
    ax, ay = np.where(swap, cx1, cx0), np.where(swap, cy1, cy0)
    ddx, ddy = np.abs(cx1 - cx0), np.where(swap, cy0 - cy1, cy1 - cy0)
    sy, ady = np.where(ddy >= 0, 1, -1), np.abs(ddy)
    vert = ady > ddx
    major, minor_d = np.where(vert, ady, ddx), np.where(vert, ddx, ady)
    e, i = _ragged(np.where(draw, major + 1, 0))
    mi = -((major[e] - 2 * minor_d[e] * i) // np.maximum(2 * major[e], 1))  # ceil((2 minor i - major) / 2 major)
    xs = np.where(vert[e], ax[e] + mi, ax[e] + i)
    ys = np.where(vert[e], ay[e] + sy[e] * i, ay[e] + sy[e] * mi)
    out[poly[e], ys, xs] = True

    # the edge table
    keep_row = (cy0 != cy1) & off  # a clipped segment keeps its own rows unless they coincide
    ex0, ey0 = cx0 << XY_SHIFT, np.where(keep_row, cy0, y0)
    ex1, ey1 = cx1 << XY_SHIFT, np.where(keep_row, cy1, y1)
    edge = y0 != y1
    slope = _trunc_div(ex1 - ex0, np.where(edge, ey1 - ey0, 1))
    down = y0 < y1
    top, bottom = np.where(down, y0, y1), np.where(down, y1, y0)
    x_top = np.where(down, ex0 + (y0 - ey0) * slope, ex1 + (y1 - ey1) * slope)
    edge &= np.bincount(poly[edge], minlength=len(pts))[poly] >= 2
    lo, hi = np.maximum(top, 0), np.minimum(bottom, h)
    e, r = _ragged(np.where(edge, np.maximum(hi - lo, 0), 0))
    row = lo[e] + r
    x = x_top[e] + (row - top[e]) * slope[e]
    order = np.lexsort((x, row, poly[e]))
    e, row, x = e[order], row[order], x[order]
    if len(e) % 2 or (poly[e[0::2]] != poly[e[1::2]]).any() or (row[0::2] != row[1::2]).any():
        raise AssertionError("fill_polys: a row crosses an odd number of edges")
    left, right = x[0::2], x[1::2]
    s0 = (left + XY_ONE - 1) >> XY_SHIFT
    s1 = right >> XY_SHIFT
    ok = (s0 < w) & (s1 >= 0)
    s0, s1 = np.maximum(s0, 0), np.minimum(s1, w - 1)
    ok &= s0 <= s1
    k, c = _ragged(np.where(ok, s1 - s0 + 1, 0))
    out[poly[e[0::2]][k], row[0::2][k], s0[k] + c] = True
    return out


def fill_poly(canvas: np.ndarray, pts: np.ndarray, value) -> np.ndarray:
    """`cv2.fillPoly(canvas, [pts], value)` for one contour of int32 points
    (LINE_8, shift 0), in place on a 2-D canvas; returns the canvas."""
    canvas[fill_polys(canvas.shape[:2], [pts])[0]] = value
    return canvas


# ------------------------------------------------------------ contour_area


def contour_area(pts: np.ndarray) -> float:
    """`cv2.contourArea(pts.astype(np.float32))`: |sum of (prev.x * p.y -
    prev.y * p.x)| / 2 over the closed contour, products and sum in float64
    in order, from the last point around."""
    p = np.asarray(pts).reshape(-1, 2).astype(np.float32).astype(np.float64)
    if not len(p):
        return 0.0
    prev = np.roll(p, 1, axis=0)
    terms = prev[:, 0] * p[:, 1] - prev[:, 1] * p[:, 0]
    a = 0.0
    for t in terms.tolist():
        a += t
    return abs(a * 0.5)


# ----------------------------------------------------------- min_area_rect


def _sklansky(pts: np.ndarray, start: int, end: int, nsign: int, sign2: int) -> List[int]:
    """convhull.cpp `Sklansky_` over the x-sorted f32 points from `start`
    towards `end`: the stack of the half hull (its `stacksize - 1` entries)."""
    if start == end or (pts[start, 0] == pts[end, 0] and pts[start, 1] == pts[end, 1]):
        return [start]
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext]
    end += incr
    while pnext != end:
        cury, nexty = pts[pcur, 1], pts[pnext, 1]
        by = _f32(nexty - cury)
        if _sign(by) != nsign:
            ax = _f32(pts[pcur, 0] - pts[pprev, 0])
            bx = _f32(pts[pnext, 0] - pts[pcur, 0])
            ay = _f32(cury - pts[pprev, 1])
            convexity = float(ay) * float(bx) - float(ax) * float(by)
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                stack[1] = pcur
                pnext += incr
                stack[2] = pnext
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def convex_hull(points: np.ndarray) -> np.ndarray:
    """`cv2.convexHull(points.astype(np.float32))` (counter-clockwise): the
    hull's f32 points in OpenCV's order and start point. Points are sorted by
    (x, y) stably, as OpenCV's `std::sort` orders 16 points or fewer (its
    insertion sort); larger sets with repeated points may start elsewhere."""
    data = np.asarray(points, np.float32).reshape(-1, 2)
    total = len(data)
    if total == 0:
        return np.zeros((0, 2), np.float32)
    order = np.lexsort((data[:, 1], data[:, 0]))
    p = data[order]
    miny = maxy = 0
    for i in range(1, total):
        if p[miny, 1] > p[i, 1]:
            miny = i
        if p[maxy, 1] < p[i, 1]:
            maxy = i
    if p[0, 0] == p[-1, 0] and p[0, 1] == p[-1, 1]:
        hull = [0]
    else:
        tl = _sklansky(p, 0, maxy, -1, 1)
        tr = _sklansky(p, total - 1, maxy, -1, -1)
        tl, tr = tr, tl  # counter-clockwise: the upper half from the right
        hull = [tl[i] for i in range(len(tl) - 1)] + [tr[i] for i in range(len(tr) - 1, 0, -1)]
        stop = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
        bl = _sklansky(p, 0, miny, 1, -1)
        br = _sklansky(p, total - 1, miny, 1, 1)
        if stop >= 0:
            check = bl[1] if len(bl) > 2 else br[2 - len(bl)] if len(bl) + len(br) > 2 else -1
            if check == stop or (check >= 0 and p[check, 0] == p[stop, 0] and p[check, 1] == p[stop, 1]):
                # every point on one line: the lower half mirrors the upper
                bl, br = bl[:2], br[:2]
        hull += [bl[i] for i in range(len(bl) - 1)] + [br[i] for i in range(len(br) - 1, 0, -1)]
        hull = [int(order[i]) for i in hull]
        hull = _ascending_shift(hull)
        return data[hull]
    return data[[int(order[i]) for i in hull]]


def _ascending_shift(idx: List[int]) -> List[int]:
    """convhull.cpp's last step: a cyclic shift that makes the hull's input
    indices one ascending or descending run, where one exists."""
    nout = len(idx)
    if nout < 3:
        return idx
    min_i = max_i = lt = 0
    for i in range(1, nout):
        v = idx[i]
        lt += idx[i - 1] < v
        if 1 < lt <= i - 2:
            break
        if v < idx[min_i]:
            min_i = i
        if v > idx[max_i]:
            max_i = i
    mmdist = abs(max_i - min_i)
    if (mmdist == 1 or mmdist == nout - 1) and (lt <= 1 or lt >= nout - 2):
        ascending = (max_i + 1) % nout == min_i
        i0 = min_i if ascending else max_i
        j = i0
        if i0 > 0:
            out = []
            for i in range(nout):
                cur = idx[j]
                out.append(cur)
                nj = j + 1 if j + 1 < nout else 0
                if i < nout - 1 and ascending != (cur < idx[nj]):
                    break
                j = nj
            else:
                return out
    return idx


def _rotating_calipers(pts: np.ndarray):
    """rotcalipers.cpp `rotatingCalipers(..., CALIPERS_MINAREARECT)` in f32
    over the hull: (corner, side a, side b) of the least-area rectangle, as
    f32 pairs.

    The four calipers rest on the bottom, right, top and left points. Each
    step turns them to the polygon edge nearest in angle: the four support
    edges are rotated into caliper 0's frame and the first that lies
    strictly clockwise of the best so far (an f32 cross product below 0)
    wins, ties staying with the earlier caliper. The rectangle flush with
    that edge is measured, and the last of the least area is kept."""
    n = len(pts)
    px, py = pts[:, 0], pts[:, 1]
    vx = np.empty(n, np.float32)
    vy = np.empty(n, np.float32)
    inv = np.empty(n, np.float32)
    left = bottom = right = top = 0
    left_x = right_x = px[0]
    top_y = bottom_y = py[0]
    for i in range(n):
        x0, y0 = px[i], py[i]
        if x0 < left_x:
            left_x, left = x0, i
        if x0 > right_x:
            right_x, right = x0, i
        if y0 > top_y:
            top_y, top = y0, i
        if y0 < bottom_y:
            bottom_y, bottom = y0, i
        j = i + 1 if i + 1 < n else 0
        vx[i], vy[i] = px[j] - x0, py[j] - y0  # f32 differences; the length in double
        inv[i] = 1.0 / np.sqrt(float(vx[i]) * float(vx[i]) + float(vy[i]) * float(vy[i]))
    seq = [bottom, right, top, left]
    minarea = _f32(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        v = [(vx[s], vy[s]) for s in seq]
        # the support edges in caliper 0's frame: v0, v1 turned by -90, v2 by 180, v3 by 90
        rot = [v[0], (v[1][1], -v[1][0]), (-v[2][0], -v[2][1])]
        main = 1 if (-v[1][0]) * v[0][0] - v[1][1] * v[0][1] < 0 else 0
        wx, wy = rot[main]
        if rot[2][1] * wx + v[2][0] * wy < 0:
            main, (wx, wy) = 2, rot[2]
        if wx * v[3][0] + wy * v[3][1] < 0:
            main = 3
        p = seq[main]
        lead_x, lead_y = vx[p] * inv[p], vy[p] * inv[p]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x), (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = 0 if seq[main] + 1 == n else seq[main] + 1
        width = (px[seq[1]] - px[seq[3]]) * base_a + (py[seq[1]] - py[seq[3]]) * base_b
        height = (py[seq[2]] - py[seq[0]]) * base_a - (px[seq[2]] - px[seq[0]]) * base_b
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    lft, a1, width, b1, height, btm = best
    a2, b2 = -b1, a1
    c1 = a1 * px[lft] + py[lft] * b1
    c2 = a2 * px[btm] + py[btm] * b2
    idet = _f32(1) / (a1 * b2 - a2 * b1)
    corner = ((c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet)
    return corner, (a1 * width, b1 * width), (a2 * height, b2 * height)


def min_area_rect(points: np.ndarray) -> Tuple[Tuple[float, float], Tuple[float, float], float]:
    """`cv2.minAreaRect(points.astype(np.float32))`: ((cx, cy), (w, h),
    angle in degrees), each value a float32 of OpenCV's `RotatedRect`.

    The hull is counter-clockwise; with sides a and b from the calipers the
    rectangle is (|b|, |a|) at atan2(a.x, a.y) * -180 / pi degrees, or
    (|a|, |b|) at -90 when a points straight down the y axis. A hull of two
    points gives a zero-width rectangle along their segment, one point or
    none a zero rectangle at -90."""
    hull = convex_hull(points)
    n = len(hull)
    cx = cy = w = h = _f32(0)
    angle = _f32(-90)
    if n > 2:
        (ox, oy), (ax, ay), (bx, by) = _rotating_calipers(hull)
        cx = (ax + bx) * _f32(0.5) + ox
        cy = (ay + by) * _f32(0.5) + oy
        len_a = _f32(np.sqrt(float(ax) * float(ax) + float(ay) * float(ay)))
        len_b = _f32(np.sqrt(float(bx) * float(bx) + float(by) * float(by)))
        if ax == 0 and ay > 0:
            w, h = len_a, len_b
        else:
            w, h = len_b, len_a
            angle = _f32(np.arctan2(float(ax), float(ay)) * -180.0 / np.pi)
    elif n == 2:
        cx = (hull[0, 0] + hull[1, 0]) * _f32(0.5)
        cy = (hull[0, 1] + hull[1, 1]) * _f32(0.5)
        dx, dy = hull[0, 0] - hull[1, 0], hull[0, 1] - hull[1, 1]
        d = _f32(np.sqrt(float(dx) * float(dx) + float(dy) * float(dy)))
        if dx == 0:
            w = d
        elif dy < 0:
            w = d
            angle = _f32(np.arctan2(float(dy), float(dx)) * 180.0 / np.pi)
        else:
            h = d
            if dy > 0:
                angle = _f32(np.arctan2(float(dx), float(dy)) * -180.0 / np.pi)
    elif n == 1:
        cx, cy = hull[0, 0], hull[0, 1]
    return (float(cx), float(cy)), (float(w), float(h)), float(angle)
