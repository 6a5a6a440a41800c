"""Drawing and export utilities in numpy, without OpenCV.

Port of `yolo_infer_tpu/utils/visualization.py` (`get_color`,
`draw_detections`, `draw_results`, `draw_segmentation_masks`,
`draw_keypoints`, `draw_obb`, `create_grid_visualization`,
`save_detection_results`). The JAX package draws with OpenCV's
anti-aliased primitives; the port draws the same shapes, at the same
places, in the same colours, without anti-aliasing:

  - a rectangle of thickness t covers the t rows and columns centred on
    each edge (t // 2 outside, the rest inside); a filled one covers its
    corners inclusive;
  - a line covers the pixels within t / 2 (at least 0.75 px) of the segment;
    a filled circle those within its radius of the centre;
  - text is a bitmap font kept in this module (printable ASCII, rendered
    once from OpenCV's Hershey simplex at scale 0.5, 16 px cells with the
    baseline at row 12 and each glyph's advance), scaled by whole
    multiples of 0.5; a detection's label is clipped to its filled box.

Masks are resized with the port's copy of OpenCV's float bilinear resize
(`ops/letterbox.py resize_linear_f32`) and blended as the JAX package
blends them, and grid cells with its uint8 one (`resize_linear_u8`), so
those two give the JAX package's pixels. Oriented boxes take their corners
from `ops/rotated.py xywhr_to_corners`. Images are RGB uint8 (H, W, 3).

`create_video_writer` writes MPEG-4 Part 2 in MP4 or QuickTime for
`.mp4`, `.m4v` and `.mov` (`data/mp4.py Mp4Writer`, I-VOPs only) and in
Matroska for `.mkv` (`data/mkv.py MkvWriter`), and motion JPEG for `.avi`
(`data/avi.py AviWriter`). `.webm` raises `RuntimeError`, as the JAX
package's codec chain finds no codec that goes into WebM; any other
container (`.mpg`, ...) raises before anything is written (ROADMAP Queue 1
item 11.2).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from yolo_infer_tpu_torch.data.avi import AviWriter
from yolo_infer_tpu_torch.data.mkv import MkvWriter
from yolo_infer_tpu_torch.data.mp4 import Mp4Writer
from yolo_infer_tpu_torch.ops.letterbox import resize_linear_f32, resize_linear_u8
from yolo_infer_tpu_torch.ops.rotated import xywhr_to_corners

# 10-colour cycle (RGB)
_PALETTE: List[Tuple[int, int, int]] = [
    (255, 56, 56), (255, 157, 151), (255, 112, 31), (255, 178, 29),
    (207, 210, 49), (72, 249, 10), (26, 140, 255), (0, 212, 187),
    (132, 56, 255), (82, 0, 133),
]

# COCO-pose skeleton edges (17-keypoint convention)
POSE_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]

FONT_H, FONT_W, FONT_BASE = 16, 12, 12  # cell rows and columns, baseline row
FONT_CAP = 10  # rows from the top of a capital to the baseline, at scale 0.5
# per glyph (" " .. "~"): 2 hex digits of advance, then 16 rows of 3 hex digits (12 columns, MSB left)
_FONT_HEX = (
    "0400000000000000000000000000000000000000000000000004000000600600600600600600600000400600000000000000"
    "060004005805804000000000000000000000000000000000000b0000000901907f83f81301207f8320320000000000000000"
    "0a0800c03e06304006003c00700104186303e00800000000000c00000078c4984904a03600dc0b612231421c000000000000"
    "0b0000803e02202203c01802c84684386383ec00000000000004000400400400400000000000000000000000000000000000"
    "0a0e00801801001001001001001001001801800c00400000000a1800c00400400400400400400400400400c0180100000000"
    "070001005007c03802800000000000000000000000000000000a0000000000000800800807f8080080080000000000000000"
    "04000000000000000000000000000000600400400000000000080000000000000000000007c0000000000000000000000000"
    "04000000000000000000000000000000600600000000000000080200400400c0080180100100300200600400400000000000"
    "0a0000803e06706504504904905107107703e00000000000000a0000001c03c02c00c00c00c00c00c00c07f0000000000000"
    "0a0000803e06306300300600c01803007007f00000000000000a0000007f00600c00801e00300104106303e0000000000000"
    "0a0000000600e01a0320220620ff80700200200000000000000a0000003f02002007c07700100104106303e0000000000000"
    "0a0000000c00801003e07306104186106301e00000000000000a0000007f00300200600400c00c0080180100000000000000"
    "0a0000803e06306106303e06304104106303e00000000000000a0000803e06304104106303e00600c0080100000000000000"
    "0400000000000000060060000000000060060000000000000005000000000000000600600000000000600600400000000000"
    "080000000000000c01806004007001800c0000000000000000090000000000000007e00000000007e0000000000000000000"
    "080000000004006001800c00600c0380600000000000000000080001807e04204200600c0080180000000180000000000000"
    "0d0000000f830c20247a49a49b49b49a66c20018c0700000000b0000000c01e01201203302107f87f8408c0c000000000000"
    "0b0000007f06186186187f06186186186187f00000000000000a0000c03f06186084004004006006183381f0000000000000"
    "0b0000007f06186086086086086086186387e00000000000000a0000007f06006006007f06006006006007f0000000000000"
    "090000007f06006006007f07e06006006006000000000000000b0000403f06186084004384386086083181e0000000000000"
    "0b0000006086086086087f860860860860860800000000000005000000600600600600600600600600600600000000000000"
    "0a0000007f00100100100100100104306703e00000000000000a0000006306606c07807007806c0660630618000000000000"
    "090000006006006006006006006006006007f00000000000000c00000060670e70e79e6966f6666606606606000000000000"
    "0b0000006087087086886c86486286386186180000000000000b0000c03f06186184084084086086183301e0000000000000"
    "0a0000007f06186186186387e06006006006000000000000000b0000c03f06186184084084086086183301f0018000000000"
    "0a0000007f06106186186707e06206306186080000000000000a0000803e06306006003c00700104186303e0000000000000"
    "09000000ff00800800800800800800800800800000000000000b0000006086086086086086086082183381f0000000000000"
    "0a0000004086186102103303201201e01c00c00000000000000c0000004024026666662642b429c39c39c108000000000000"
    "0a0000006182303601c00c01c01603306104180000000000000a0000004186103301201e00c00c00c00c00c0000000000000"
    "090000007f00300600c00c01803002006007f000000000000005700700400400400400400400400400400400400700000000"
    "084004004002002003001001800800800c004006000000000005600700300300300300300300300300300300300700000000"
    "070001003800000000000000000000000000000000000000000c0000000000000000000000000000000007fc7fc000000000"
    "06000600300000000000000000000000000000000000000000090000000000003c06600201e07204204607a0000000000000"
    "090004006006007c07706306106106106307e0000000000000090000000000001c07606204004004206603c0000000000000"
    "090000000300303b06704304304304306703f0000000000000090000000000001c06604206307e04006201c0000000000000"
    "060001c0300200f80300200200200200200200000000000000090000000000003906704304304304306703f00306203e0000"
    "0a0004006006007e077063061061061061061000000000000004000400400000400600600600600600600400000000000000"
    "04000600600000400600600600600600600600600400800000080004006006006606c0780700700780640420000000000000"
    "040004006006006006006006006006006004000000000000000e0000000000005ce773631621621621621421000000000000"
    "0a0000000000005c0760630610610610610410000000000000090000000000001c07606304304304306603c0000000000000"
    "090000000000005e07706306106106106307e0600600400000090000000000003d07704304304304306703f0030030010000"
    "06000000000000580780600600600600600400000000000000080000000000003806604007001c00604603c0000000000000"
    "06000200200200f807002002002002003001800000000000000a0000000000004104304304304306306303f0000000000000"
    "090000000000004104206202602403c01801800000000000000d0000000000004624624626f629439c39c108000000000000"
    "090000000000004206603c01801803c0660420000000000000090000000000004104206202603401c0180180100100300000"
    "080000000000007e00e00c01801002006007e000000000000006080380200200200200600400600200200200300180000000"
    "0440040040040040040040040040040040040040040040000006000600200300300300100180100300300300200600000000"
    "090000000000000000000007e0000000000000000000000000"
)


def get_color(class_id: int) -> Tuple[int, int, int]:
    return _PALETTE[int(class_id) % len(_PALETTE)]


@lru_cache(maxsize=1)
def _font() -> Dict[str, Tuple[np.ndarray, int]]:
    per = 2 + 3 * FONT_H
    cols = 1 << np.arange(FONT_W - 1, -1, -1)
    out = {}
    for i in range(95):
        rec = _FONT_HEX[i * per: (i + 1) * per]
        rows = np.array([int(rec[2 + 3 * r: 5 + 3 * r], 16) for r in range(FONT_H)])
        out[chr(32 + i)] = ((rows[:, None] & cols) > 0, int(rec[:2], 16))
    return out


def _font_scale(scale: float) -> int:
    """The whole multiple of the font's 0.5 size nearest `scale` (at least 1)."""
    return max(1, int(round(scale / 0.5)))


def text_size(text: str, scale: float) -> Tuple[int, int]:
    """(width, height above the baseline) of `text` at OpenCV font scale `scale`."""
    s = _font_scale(scale)
    font = _font()
    return sum(font.get(ch, font["?"])[1] for ch in text) * s, FONT_CAP * s


def put_text(img: np.ndarray, text: str, org: Tuple[int, int], scale: float, color,
             clip: Optional[Tuple[int, int, int, int]] = None) -> None:
    """Draw `text` in place with its baseline's left end at `org` (x, y);
    `clip` (x1, y1, x2, y2, inclusive) limits the pixels drawn."""
    s = _font_scale(scale)
    font = _font()
    h, w = img.shape[:2]
    x1c, y1c, x2c, y2c = clip if clip is not None else (0, 0, w - 1, h - 1)
    x1c, y1c, x2c, y2c = max(x1c, 0), max(y1c, 0), min(x2c, w - 1), min(y2c, h - 1)
    x, y0 = int(org[0]), int(org[1]) - FONT_BASE * s
    col = np.asarray(color, img.dtype)
    for ch in text:
        glyph, adv = font.get(ch, font["?"])
        if s > 1:
            glyph = glyph.repeat(s, 0).repeat(s, 1)
        ys, xs = np.nonzero(glyph)
        ys, xs = ys + y0, xs + x
        keep = (xs >= x1c) & (xs <= x2c) & (ys >= y1c) & (ys <= y2c)
        img[ys[keep], xs[keep]] = col
        x += adv * s


def fill_rect(img: np.ndarray, p1, p2, color) -> None:
    """Fill the rectangle with corners `p1`, `p2` (inclusive), clipped to the image."""
    h, w = img.shape[:2]
    xa, xb = sorted((int(p1[0]), int(p2[0])))
    ya, yb = sorted((int(p1[1]), int(p2[1])))
    xa, ya, xb, yb = max(xa, 0), max(ya, 0), min(xb, w - 1), min(yb, h - 1)
    if xa <= xb and ya <= yb:
        img[ya: yb + 1, xa: xb + 1] = color


def draw_rect(img: np.ndarray, p1, p2, color, thickness: int) -> None:
    """The outline of the rectangle `p1`-`p2`: each edge a band of
    `thickness` pixels centred on it."""
    x1, x2 = sorted((int(p1[0]), int(p2[0])))
    y1, y2 = sorted((int(p1[1]), int(p2[1])))
    lo, hi = thickness // 2, (thickness - 1) - thickness // 2
    fill_rect(img, (x1 - lo, y1 - lo), (x2 + hi, y1 + hi), color)  # top
    fill_rect(img, (x1 - lo, y2 - lo), (x2 + hi, y2 + hi), color)  # bottom
    fill_rect(img, (x1 - lo, y1 - lo), (x1 + hi, y2 + hi), color)  # left
    fill_rect(img, (x2 - lo, y1 - lo), (x2 + hi, y2 + hi), color)  # right


def draw_line(img: np.ndarray, p1, p2, color, thickness: int = 1) -> None:
    """The pixels within thickness / 2 (at least 0.75) of the segment `p1`-`p2`."""
    h, w = img.shape[:2]
    (ax, ay), (bx, by) = (float(p1[0]), float(p1[1])), (float(p2[0]), float(p2[1]))
    r = max(thickness / 2.0, 0.75)
    x0, x1 = max(int(np.floor(min(ax, bx) - r)), 0), min(int(np.ceil(max(ax, bx) + r)), w - 1)
    y0, y1 = max(int(np.floor(min(ay, by) - r)), 0), min(int(np.ceil(max(ay, by) + r)), h - 1)
    if x0 > x1 or y0 > y1:
        return
    ys, xs = np.mgrid[y0: y1 + 1, x0: x1 + 1].astype(np.float64)
    dx, dy = bx - ax, by - ay
    t = np.clip(((xs - ax) * dx + (ys - ay) * dy) / max(dx * dx + dy * dy, 1e-12), 0.0, 1.0)
    near = (xs - ax - t * dx) ** 2 + (ys - ay - t * dy) ** 2 <= r * r
    img[y0: y1 + 1, x0: x1 + 1][near] = color


def fill_circle(img: np.ndarray, centre, radius: int, color) -> None:
    h, w = img.shape[:2]
    cx, cy = int(centre[0]), int(centre[1])
    x0, x1 = max(cx - radius, 0), min(cx + radius, w - 1)
    y0, y1 = max(cy - radius, 0), min(cy + radius, h - 1)
    if x0 > x1 or y0 > y1:
        return
    ys, xs = np.mgrid[y0: y1 + 1, x0: x1 + 1]
    inside = (xs - cx) ** 2 + (ys - cy) ** 2 <= radius * radius
    img[y0: y1 + 1, x0: x1 + 1][inside] = color


def label_geometry(p1, label: str, font_scale: float) -> Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]:
    """Where `draw_detections` puts a box's label (as the JAX package does):
    (one corner, the opposite corner) of its filled box and the text origin;
    above the box when there are 3 rows of room, else inside it."""
    tw, th = text_size(label, font_scale)
    outside = p1[1] - th >= 3
    corner = (p1[0] + tw, p1[1] - th - 3 if outside else p1[1] + th + 3)
    org = (p1[0], p1[1] - 2 if outside else p1[1] + th + 2)
    return p1, corner, org


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    names: Optional[Dict[int, str]] = None,
    line_width: Optional[int] = None,
    font_scale: Optional[float] = None,
    show_labels: bool = True,
    show_conf: bool = True,
) -> np.ndarray:
    """Draw xyxy boxes and class/score labels. Returns a new image."""
    out = image.copy()
    h, w = out.shape[:2]
    lw = line_width or max(round((h + w) / 2 * 0.003), 2)
    fs = font_scale or lw / 3
    for box, score, cls in zip(boxes, scores, classes):
        c = int(cls)
        color = get_color(c)
        p1 = (int(box[0]), int(box[1]))
        p2 = (int(box[2]), int(box[3]))
        draw_rect(out, p1, p2, color, lw)
        if show_labels:
            name = (names or {}).get(c, str(c))
            label = f"{name} {score:.2f}" if show_conf else name
            a, b, org = label_geometry(p1, label, fs)
            fill_rect(out, a, b, color)
            put_text(out, label, org, fs, (255, 255, 255),
                     clip=(min(a[0], b[0]), min(a[1], b[1]), max(a[0], b[0]), max(a[1], b[1])))
    return out


def draw_results(image: np.ndarray, result: Any) -> np.ndarray:
    """Draw a predictor Results object for any task (boxes, masks,
    keypoints, oriented boxes, or the classification label)."""
    out = image
    if getattr(result, "probs", None) is not None:
        top = int(np.argmax(result.probs))
        name = result.names.get(top, str(top))
        out = out.copy()
        put_text(out, f"{name} {float(result.probs[top]):.2f}", (10, 30), 1.0, (255, 255, 255))
        return out
    if result.masks is not None and len(result.masks):
        out = draw_segmentation_masks(out, np.asarray(result.masks), result.classes)
    if getattr(result, "obb", None) is not None and len(result.obb):
        return draw_obb(out, result.obb, result.scores, result.classes, result.names)
    out = draw_detections(out, result.boxes, result.scores, result.classes, result.names)
    if result.keypoints is not None and len(result.keypoints):
        out = draw_keypoints(out, result.keypoints)
    return out


def draw_segmentation_masks(
    image: np.ndarray,
    masks: np.ndarray,  # (n, Hm, Wm) float [0, 1]
    classes: np.ndarray,
    alpha: float = 0.5,
    threshold: float = 0.5,
) -> np.ndarray:
    """Blend each class colour into the pixels where its mask, resized
    bilinearly to the image, exceeds `threshold`."""
    out = image.copy().astype(np.float32)
    h, w = image.shape[:2]
    for m, c in zip(masks, classes):
        m = np.asarray(m, np.float32)
        if m.shape != (h, w):
            m = resize_linear_f32(m[..., None], w, h)[..., 0]
        mm = m > threshold
        color = np.array(get_color(int(c)), np.float32)
        out[mm] = out[mm] * (1 - alpha) + color * alpha
    return out.astype(np.uint8)


def draw_keypoints(
    image: np.ndarray,
    keypoints: np.ndarray,  # (n, K, 3) x, y, conf
    skeleton: Sequence[Tuple[int, int]] = POSE_SKELETON,
    conf_thres: float = 0.5,
    radius: int = 3,
) -> np.ndarray:
    out = image.copy()
    for kpts in keypoints:
        for x, y, c in kpts:
            if c >= conf_thres:
                fill_circle(out, (int(x), int(y)), radius, (0, 255, 0))
        for a, b in skeleton:
            if a < len(kpts) and b < len(kpts) and kpts[a, 2] >= conf_thres and kpts[b, 2] >= conf_thres:
                draw_line(out, (int(kpts[a, 0]), int(kpts[a, 1])), (int(kpts[b, 0]), int(kpts[b, 1])),
                          (255, 128, 0), 2)
    return out


def draw_obb(
    image: np.ndarray,
    boxes_xywhr: np.ndarray,  # (n, 5) cx, cy, w, h, rad
    scores: np.ndarray,
    classes: np.ndarray,
    names: Optional[Dict[int, str]] = None,
) -> np.ndarray:
    """Each oriented box's closed outline (its corners truncated to whole
    pixels, as `astype(np.int32)` truncates them), thickness 2, and its
    label at its centre."""
    out = image.copy()
    corners = xywhr_to_corners(boxes_xywhr).astype(np.int32)
    for pts, (cx, cy, _, _, _), score, cls in zip(corners, boxes_xywhr, scores, classes):
        color = get_color(int(cls))
        for i in range(4):
            draw_line(out, pts[i], pts[(i + 1) % 4], color, 2)
        name = (names or {}).get(int(cls), str(int(cls)))
        put_text(out, f"{name} {score:.2f}", (int(cx), int(cy)), 0.5, (255, 255, 255))
    return out


def create_video_writer(path: Union[str, Path], fps: float, frame_size: Tuple[int, int]):
    """A writer of BGR uint8 frames of `frame_size` (w, h) into `path`: MPEG-4
    Part 2 for `.mp4`, `.m4v` and `.mov` (`data/mp4.py Mp4Writer`) and
    `.mkv` (`data/mkv.py MkvWriter`), motion JPEG for `.avi`
    (`data/avi.py AviWriter`); `.webm` raises `RuntimeError` as the JAX
    package's codec chain does."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".webm":
        raise RuntimeError(f"no working codec for {path}")
    writer = {".mp4": Mp4Writer, ".m4v": Mp4Writer, ".mov": Mp4Writer, ".mkv": MkvWriter,
              ".avi": AviWriter}.get(suffix)
    if writer is None:
        raise NotImplementedError(f"{path}: the port writes MPEG-4 Part 2 in .mp4, .m4v, .mov and .mkv and motion "
                                  "JPEG in .avi; other containers and codecs are ROADMAP Queue 1 item 11.2")
    path.parent.mkdir(parents=True, exist_ok=True)
    return writer(path, fps, frame_size)


def create_grid_visualization(
    images: Sequence[np.ndarray],
    cols: int = 3,
    cell_size: Tuple[int, int] = (320, 320),
    pad_value: int = 114,
) -> np.ndarray:
    """Tile images into a grid, each resized to fit its cell and centred."""
    n = len(images)
    if n == 0:
        raise ValueError("no images")
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    cw, ch = cell_size
    grid = np.full((rows * ch, cols * cw, 3), pad_value, np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, cols)
        scale = min(cw / img.shape[1], ch / img.shape[0])
        nw, nh = int(img.shape[1] * scale), int(img.shape[0] * scale)
        resized = img if (nw, nh) == (img.shape[1], img.shape[0]) else resize_linear_u8(img, nw, nh)
        y0 = r * ch + (ch - nh) // 2
        x0 = c * cw + (cw - nw) // 2
        grid[y0: y0 + nh, x0: x0 + nw] = resized
    return grid


def save_detection_results(results: Sequence[Any], path: Union[str, Path], fmt: str = "json") -> None:
    """txt/json/csv result export (`data/loader.py save_predictions_to_file`)."""
    from yolo_infer_tpu_torch.data.loader import save_predictions_to_file

    save_predictions_to_file(results, path, fmt)
