"""Drawing on host images: what Results.plot draws, and the charts and batch
mosaics of val and training. Counterpart of the drawing the JAX package does
with cv2 and matplotlib (spectrogram_yolov11_tpu/engine/results.py:248-284
Results.plot: cv2.rectangle and cv2.putText; utils/plotting.py: Colors :19,
plot_results :48, plot_pr_curve :79, plot_images :117, plot_mc_curve :170,
plot_confusion_matrix :191, plot_val_curves :221); the port has neither cv2
nor matplotlib.

`rectangle(img, p1, p2, color, thickness)` is cv2.rectangle at LINE_8, pixel
for pixel, as OpenCV draws it: four segments through the corners p1, (p2.x,
p1.y), p2, (p1.x, p2.y). At thickness 1 each segment is the pixel run from
corner to corner; thicker, each is the band of its rasterised quad, half
width (thickness + 1) // 2 on each side of the centre line, and every corner
gets a filled midpoint circle of that radius (cv2's round joints), so the
outer corners are rounded. Segments of length 0 draw their circle only, so a
box with p1 == p2 is a disc, and everything is clipped to the image; a
negative thickness fills the box. `circle(img, center, radius, color)` is
cv2.circle(..., -1) at LINE_8, pixel for pixel: the midpoint algorithm's
horizontal spans, clipped to the image (the pose shapes' keypoints and
Results.plot's keypoints). `ellipse_filled` and `fill_poly` are
cv2.ellipse(..., 0, 0, 360, color, -1) and cv2.fillPoly at LINE_8 as
OpenCV rasterises them in fixed point (each function's docstring says how),
for the synthetic shapes of data/synth.py (JAX's data/synth.py:80-105).

`put_text(img, text, org, font_scale, color, thickness)` draws the printable
ASCII characters 32-126 (any other as "?", as cv2 does) in the port's own
stroke font (_GLYPHS below, one polyline set per character on a grid of cap
height 9 at font_scale 0.5) from the baseline origin `org`, each stroke the
pixels whose centres lie within thickness / 2 of it. It is not cv2's font: JAX's labels are drawn by the
installed cv2's FONT_HERSHEY_SIMPLEX, and OpenCV 5 draws that as anti-aliased
outline glyphs (OpenCV 4 as Hershey strokes), so no port without a copy of
cv2's font and rasteriser draws JAX's label pixels. The rule the port keeps
instead (tests/test_torch_plot.py): each character's advance is at most the
one cv2 5.0.0 gives it at scale 0.5 and the ink stays inside the cap height
and the descent cv2 gives it, so at font_scale 0.5 the label lies inside
the box cv2.getTextSize reports at the same origin, padded by the thickness
plus 1 px, and paints only the label's colour. `text_size` gives the port's
own box of a label: ((width, height above the baseline), depth below it).

`polylines(img, pts, is_closed, color, thickness)` is cv2.polylines at
LINE_8 and shift 0, pixel for pixel, as OpenCV's PolyLine draws it: at
thickness 1 each segment by Line (connectivity 8, clipped to the image);
thicker, each segment is first clipped (clipLine, integer ends) to the
image grown by the thickness on every side, then drawn as ThickLine's quad,
its ends moved by cvRound(thickness * 2^15 / length) of the normal in
XY_SHIFT fixed point (half a pixel more at an odd thickness), filled by
FillConvexPoly, with a filled circle of radius (thickness + 1) // 2 at the
segment's unclipped end (a closed polyline's every vertex; an open one's
first point as well), all clipped to the image. Results.plot of rotated
boxes draws with it (JAX engine/results.py:275-278), and so do the
train-batch mosaics of rotated boxes (JAX utils/plotting.py:132-134).

`plot_images` is JAX's train-batch mosaic byte for byte: the same tiles,
`rectangle` for cv2.rectangle (a rotated box: ops/boxes.py:box_points and
`polylines` for cv2.boxPoints and cv2.polylines),
data/augment.py:resize_linear_u8 for cv2.resize and the port's JPEG encoder
for cv2.imwrite.

The charts (`plot_pr_curve`, `plot_mc_curve`, `plot_confusion_matrix`,
`plot_val_curves`, `plot_results`) are the port's own drawing in numpy, at
the pixel size of JAX's figure (figsize x dpi) and with its file names,
series, legend texts and heatmap values, written as PNG
(data/imageio.py:imencode_png). matplotlib's pixels are not reproduced; the
yardstick (tests/test_torch_artifacts.py) is that each series' pixel at each
mapped data point, or one within 1 px of it, carries the series' colour
where no later series or the legend covers it, and that the heatmap's cells
are ordered as their values. Each `render_*` returns the `Chart` its
`plot_*` writes.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import LOGGER

# character -> (advance, strokes): x to the right and y up from the origin, in
# px at font_scale 0.5; each stroke a polyline "x,y x,y ...", strokes split by ";"
_GLYPHS = {
    " ": (3, ""), "!": (3, "1,9 1,3;1,1 1,0"), '"': (5, "1,9 1,7;3,9 3,7"),
    "#": (7, "1,0 2,9;4,0 5,9;0,3 5,3;0,6 5,6"),
    "$": (7, "5,8 4,9 1,9 0,8 0,6 1,5 4,5 5,4 5,2 4,1 1,1 0,2;2.5,10 2.5,-1"),
    "%": (7, "0,0 5,9;1,9 0,8 1,7 2,8 1,9;4,2 3,1 4,0 5,1 4,2"),
    "&": (7, "5,0 1,6 1,8 2,9 3,9 4,8 4,7 0,3 0,1 1,0 3,0 5,3"), "'": (3, "1,9 1,7"),
    "(": (5, "3,10 2,8 1.5,4.5 2,1 3,-1"), ")": (5, "1,10 2,8 2.5,4.5 2,1 1,-1"),
    "*": (6, "2,8 2,3;0,7 4,4;0,4 4,7"), "+": (7, "2,2 2,6;0,4 4,4"), ",": (3, "1,1 1,0 0,-1.5"),
    "-": (6, "0,4 4,4"), ".": (3, "1,1 1,0"), "/": (6, "0,-1 4,10"),
    "0": (7, "1,0 0,1 0,8 1,9 4,9 5,8 5,1 4,0 1,0;1,2 4,7"), "1": (7, "1,7 3,9 3,0;1,0 5,0"),
    "2": (7, "0,8 1,9 4,9 5,8 5,6 0,0 5,0"), "3": (7, "0,8 1,9 4,9 5,8 5,6 4,5 2,5;4,5 5,4 5,1 4,0 1,0 0,1"),
    "4": (7, "4,0 4,9 0,3 5,3"), "5": (7, "5,9 0,9 0,5 4,5 5,4 5,1 4,0 1,0 0,1"),
    "6": (7, "5,8 4,9 1,9 0,8 0,1 1,0 4,0 5,1 5,4 4,5 0,5"), "7": (7, "0,9 5,9 2,0"),
    "8": (7, "1,5 0,6 0,8 1,9 4,9 5,8 5,6 4,5 1,5 0,4 0,1 1,0 4,0 5,1 5,4 4,5"),
    "9": (7, "0,1 1,0 4,0 5,1 5,8 4,9 1,9 0,8 0,5 1,4 5,4"),
    ":": (3, "1,6 1,5;1,1 1,0"), ";": (3, "1,6 1,5;1,1 1,0 0,-1.5"), "<": (6, "4,8 0,4.5 4,1"),
    "=": (7, "0,3 5,3;0,6 5,6"), ">": (6, "0,8 4,4.5 0,1"), "?": (6, "0,8 1,9 3,9 4,8 4,6 2,4 2,3;2,1 2,0"),
    "@": (9, "5,3 5,6 4,7 3,7 2,6 2,4 3,3 5,3 6,4 7,6 7,8 6,9 1,9 0,8 0,1 1,0 6,0"),
    "A": (7, "0,0 2.5,9 5,0;1,3 4,3"), "B": (7, "0,0 0,9 4,9 5,8 5,6 4,5 0,5;4,5 5,4 5,1 4,0 0,0"),
    "C": (7, "5,8 4,9 1,9 0,8 0,1 1,0 4,0 5,1"), "D": (7, "0,0 0,9 3,9 5,7 5,2 3,0 0,0"),
    "E": (7, "5,9 0,9 0,0 5,0;0,5 4,5"), "F": (7, "5,9 0,9 0,0;0,5 4,5"),
    "G": (7, "5,8 4,9 1,9 0,8 0,1 1,0 4,0 5,1 5,4 3,4"), "H": (7, "0,0 0,9;5,0 5,9;0,5 5,5"),
    "I": (3, "1,0 1,9"), "J": (7, "5,9 5,1 4,0 1,0 0,1 0,2"), "K": (7, "0,0 0,9;5,9 0,3;2,5 5,0"),
    "L": (7, "0,9 0,0 5,0"), "M": (9, "0,0 0,9 3.5,4 7,9 7,0"), "N": (7, "0,0 0,9 5,0 5,9"),
    "O": (7, "1,0 0,1 0,8 1,9 4,9 5,8 5,1 4,0 1,0"), "P": (7, "0,0 0,9 4,9 5,8 5,6 4,5 0,5"),
    "Q": (7, "1,0 0,1 0,8 1,9 4,9 5,8 5,1 4,0 1,0;3,2 5,-1"), "R": (7, "0,0 0,9 4,9 5,8 5,6 4,5 0,5;2,5 5,0"),
    "S": (7, "5,8 4,9 1,9 0,8 0,6 1,5 4,5 5,4 5,1 4,0 1,0 0,1"), "T": (7, "0,9 4,9;2,9 2,0"),
    "U": (7, "0,9 0,1 1,0 4,0 5,1 5,9"), "V": (7, "0,9 2.5,0 5,9"), "W": (9, "0,9 2,0 3.5,6 5,0 7,9"),
    "X": (7, "0,0 5,9;0,9 5,0"), "Y": (7, "0,9 2,5 4,9;2,5 2,0"), "Z": (7, "0,9 5,9 0,0 5,0"),
    "[": (4, "3,10 1,10 1,-1.5 3,-1.5"), "\\": (6, "0,10 4,-1"), "]": (4, "0,10 2,10 2,-1.5 0,-1.5"),
    "^": (6, "0,6 2,9 4,6"), "_": (7, "0,-1 5,-1"), "`": (4, "1,9 2,8"),
    "a": (6, "0,5 1,6 3,6 4,5 4,0;4,3 1,3 0,2 0,1 1,0 3,0 4,1"), "b": (6, "0,9 0,0;0,4 2,6 3,6 4,5 4,1 3,0 2,0 0,2"),
    "c": (6, "4,5 3,6 1,6 0,5 0,1 1,0 3,0 4,1"), "d": (6, "4,9 4,0;4,4 2,6 1,6 0,5 0,1 1,0 2,0 4,2"),
    "e": (6, "0,3 4,3 4,5 3,6 1,6 0,5 0,1 1,0 3,0 4,1"), "f": (5, "3,9 2,9 1,8 1,0;0,6 3,6"),
    "g": (6, "4,6 4,-1.5 3,-2.5 1,-2.5 0,-1.5;4,4 2,6 1,6 0,5 0,2 1,1 2,1 4,3"),
    "h": (6, "0,9 0,0;0,4 2,6 3,6 4,5 4,0"), "i": (3, "1,0 1,6;1,8 1,9"), "j": (3, "1,6 1,-1.5 0,-2.5;1,8 1,9"),
    "k": (6, "0,9 0,0;4,6 0,2;1,3 4,0"), "l": (3, "1,9 1,0"),
    "m": (8, "0,0 0,6;0,5 1,6 2,6 3,5 3,0;3,5 4,6 5,6 6,5 6,0"),
    "n": (6, "0,0 0,6;0,5 1,6 3,6 4,5 4,0"), "o": (6, "1,0 0,1 0,5 1,6 3,6 4,5 4,1 3,0 1,0"),
    "p": (6, "0,6 0,-2.5;0,4 2,6 3,6 4,5 4,1 3,0 2,0 0,2"), "q": (6, "4,6 4,-2.5;4,4 2,6 1,6 0,5 0,1 1,0 2,0 4,2"),
    "r": (5, "0,0 0,6;0,4 2,6 3,6"), "s": (6, "4,5 3,6 1,6 0,5 0,4 1,3 3,3 4,2 4,1 3,0 1,0 0,1"),
    "t": (5, "1,9 1,1 2,0 3,0;0,6 3,6"), "u": (6, "0,6 0,1 1,0 3,0 4,1;4,6 4,0"), "v": (6, "0,6 2,0 4,6"),
    "w": (8, "0,6 1.5,0 3,4 4.5,0 6,6"), "x": (6, "0,0 4,6;0,6 4,0"), "y": (6, "0,6 2,0;4,6 1.5,-2.5"),
    "z": (6, "0,6 4,6 0,0 4,0"), "{": (5, "3,10 2,9 2,6 1,5 2,4 2,-0.5 3,-1.5"), "|": (3, "1,10 1,-2"),
    "}": (5, "0,10 1,9 1,6 2,5 1,4 1,-0.5 0,-1.5"), "~": (7, "0,4 1,5 2,5 3,4 4,4 5,5"),
}
_SEGMENTS = {c: np.array([[float(v) for p in (a, b) for v in p.split(",")]
                          for stroke in strokes.split(";") if stroke
                          for a, b in zip(stroke.split()[:-1], stroke.split()[1:])] or np.zeros((0, 4)), np.float64)
             .reshape(-1, 4) for c, (_, strokes) in _GLYPHS.items()}  # (n, 4): x0, y0, x1, y1 per segment


def _color(img: np.ndarray, color) -> np.ndarray:
    """The colour as the image's channels take it (cv2: the first C values of
    the scalar, rounded and saturated to the image's integer type): (C,) for
    an (H, W, C) image, a scalar for an (H, W) one."""
    c = np.asarray(color, np.float64).reshape(-1)
    info = np.iinfo(img.dtype)
    col = np.clip(np.round(c[: 1 if img.ndim == 2 else img.shape[2]]), info.min, info.max).astype(img.dtype)
    return col if img.ndim == 3 else col[0]


def _fill(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color: np.ndarray) -> None:
    """Pixels x0..x1, y0..y1 (inclusive) set to color, clipped to the image."""
    h, w = img.shape[:2]
    x0, x1 = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
    y0, y1 = max(min(y0, y1), 0), min(max(y0, y1), h - 1)
    if x0 <= x1 and y0 <= y1:
        img[y0 : y1 + 1, x0 : x1 + 1] = color


def _circle(img: np.ndarray, cx: int, cy: int, radius: int, color: np.ndarray) -> None:
    """A filled circle as cv2's Circle(fill=1) draws it: the midpoint
    algorithm's horizontal spans, clipped to the image."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for oy, half in ((dy, dx), (dx, dy)):
            _fill(img, cx - half, cy - oy, cx + half, cy - oy, color)
            _fill(img, cx - half, cy + oy, cx + half, cy + oy, color)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def circle(img: np.ndarray, center: Sequence[int], radius: int, color) -> np.ndarray:
    """cv2.circle(img, center, radius, color, -1) at LINE_8, in place on a
    uint8 (H, W) or (H, W, C) image; returns img."""
    _circle(img, int(center[0]), int(center[1]), int(radius), _color(img, color))
    return img


def rectangle(img: np.ndarray, p1: Sequence[int], p2: Sequence[int], color, thickness: int = 1) -> np.ndarray:
    """cv2.rectangle(img, p1, p2, color, thickness) at LINE_8, in place on a
    uint8 (H, W) or (H, W, C) image; returns img."""
    x1, y1, x2, y2 = int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1])
    col = _color(img, color)
    if thickness < 0:
        _fill(img, x1, y1, x2, y2, col)
        return img
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    half = (thickness + 1) // 2  # the quads' half width and the joints' radius: cv2's (t * 2^15 + 2^15) >> 16
    for (ax, ay), (bx, by) in zip(corners[-1:] + corners[:-1], corners):
        if thickness <= 1:
            _fill(img, ax, ay, bx, by, col)
            continue
        if (ax, ay) != (bx, by):
            if ay == by:
                _fill(img, ax, ay - half, bx, by + half, col)
            else:
                _fill(img, ax - half, ay, bx + half, by, col)
        _circle(img, bx, by, half, col)
    return img



# -- filled ellipses and polygons, as OpenCV's drawing.cpp rasterises them ----
XY_SHIFT = 16  # OpenCV's fixed-point fraction bits of drawn coordinates
XY_ONE = 1 << XY_SHIFT
# OpenCV's SinTable: sin of each whole degree 0..450, printed to 7 decimals, as float
_SIN_TABLE = [float(np.float32(float(f"{math.sin(math.radians(i)):.7f}"))) for i in range(451)]


def _cdiv(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _cv_round(x: float) -> int:
    """cvRound: nearest integer, halves to even."""
    return int(np.rint(x))


def _put(img: np.ndarray, x: int, y: int, col: np.ndarray) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = col


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's clipLine of a segment to a w x h box: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1, c1 = a, (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2, c2 = a, (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2, c2 = a, 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line8(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, col: np.ndarray) -> None:
    """OpenCV's Line at connectivity 8 (its LineIterator, left to right)."""
    h, w = img.shape[:2]
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, abs(y2 - y1), 1 if y2 >= y1 else -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        img[y, x] = col
        step = err < 0
        err += minus + (plus if step else 0)
        if vert:
            y += sy
            x += step
        else:
            x += 1
            y += sy if step else 0


def _line2(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, col: np.ndarray) -> None:
    """OpenCV's Line2: a segment between XY_SHIFT fixed-point ends."""
    h, w = img.shape[:2]
    inside, x1, y1, x2, y2 = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    half = XY_ONE >> 1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, x2, y1, y2, dy = x2, x1, y2, y1, -dy
        step, count = _cdiv(dy << XY_SHIFT, abs(dx) | 1), (x2 - x1) >> XY_SHIFT
        _put(img, (x2 + half) >> XY_SHIFT, (y2 + half) >> XY_SHIFT, col)
        x, y = (x1 + half) >> XY_SHIFT, y1 + half
        for _ in range(count + 1):
            _put(img, x, y >> XY_SHIFT, col)
            x, y = x + 1, y + step
    else:
        if dy < 0:
            x1, x2, y1, y2, dx = x2, x1, y2, y1, -dx
        step, count = _cdiv(dx << XY_SHIFT, abs(dy) | 1), (y2 - y1) >> XY_SHIFT
        _put(img, (x2 + half) >> XY_SHIFT, (y2 + half) >> XY_SHIFT, col)
        x, y = x1 + half, (y1 + half) >> XY_SHIFT
        for _ in range(count + 1):
            _put(img, x >> XY_SHIFT, y, col)
            x, y = x + step, y + 1


def _fill_convex_poly(img: np.ndarray, v, col: np.ndarray) -> None:
    """OpenCV's FillConvexPoly at LINE_8 of XY_SHIFT fixed-point vertices:
    the outline by _line2, then the rows between the two chains that walk
    down from the top vertex, each pixel whose centre the span covers."""
    h, w = img.shape[:2]
    n, half = len(v), XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line2(img, p0[0], p0[1], p[0], p[1], col)
        p0 = p
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(p[0] for p in v) + half) >> XY_SHIFT, (max(p[0] for p in v) + half) >> XY_SHIFT
    ymin, ymax = (min(ys) + half) >> XY_SHIFT, (max(ys) + half) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    idx, di, ye, ex, edx = [imin, imin], [1, n - 1], [ymin, ymin], [-XY_ONE, -XY_ONE], [0, 0]
    edges, y = n, ymin
    while True:
        for k in (0, 1):
            if y < ye[k]:
                continue
            i0, i = idx[k], (idx[k] + di[k]) % n
            while True:  # the next vertex of this chain below row y
                edges -= 1
                if edges < 0:
                    break
                ty = (v[i][1] + half) >> XY_SHIFT
                if ty > y:
                    ye[k], ex[k], idx[k] = ty, v[i0][0], i
                    edx[k] = _cdiv((v[i][0] - v[i0][0]) * 2 + (ty - y), 2 * (ty - y))
                    break
                i0, i = i, (i + di[k]) % n
        if edges < 0:
            break
        if y >= 0:
            x1, x2 = sorted(ex)
            x1, x2 = (x1 + half) >> XY_SHIFT, (x2 + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0) : min(x2, w - 1) + 1] = col
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def ellipse_filled(img: np.ndarray, center: Sequence[int], axes: Sequence[int], color) -> np.ndarray:
    """cv2.ellipse(img, center, axes, 0, 0, 360, color, -1) at LINE_8, in
    place on a uint8 (H, W, C) image; returns img. As OpenCV draws it: the
    polygon of ellipse2Poly (a vertex every 90, 30, 18 or 5 degrees as the
    longer semi-axis is under 3, 10, 15 px or more; sines from OpenCV's 7-digit
    table) at XY_SHIFT fixed point, filled by FillConvexPoly."""
    col = _color(img, color)
    cx, cy = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT
    aw, ah = abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT
    step = (max(aw, ah) + (XY_ONE >> 1)) >> XY_SHIFT
    step = 90 if step < 3 else 30 if step < 10 else 18 if step < 15 else 5
    v, prev = [], None
    for deg in range(0, 360 + step, step):
        deg = min(deg, 360)
        px, py = cx + aw * _SIN_TABLE[450 - deg], cy + ah * _SIN_TABLE[deg]  # rotation 0: cos 1, sin 0
        qx, qy = _cv_round(px / XY_ONE) << XY_SHIFT, _cv_round(py / XY_ONE) << XY_SHIFT
        pt = (qx + _cv_round(px - qx), qy + _cv_round(py - qy))
        if pt != prev:
            v.append(pt)
            prev = pt
    if len(v) == 1:
        v = [(cx, cy), (cx, cy)]
    _fill_convex_poly(img, v, col)
    return img


def _thick_line(img: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], col: np.ndarray, thickness: int,
                flags: int) -> None:
    """OpenCV's ThickLine at LINE_8 for integer ends (shift 0); flags bit 1:
    a joint at p0, bit 2: a joint at p1."""
    if thickness <= 1:
        _line8(img, p0[0], p0[1], p1[0], p1[1], col)
        return
    t = thickness << (XY_SHIFT - 1)
    h, w = img.shape[:2]  # the segment first clipped to the image grown by the thickness on every side
    m = thickness
    inside, x0, y0, x1, y1 = _clip_line(w + 2 * m, h + 2 * m, p0[0] + m, p0[1] + m, p1[0] + m, p1[1] + m)
    f0 = ((x0 - m) << XY_SHIFT, (y0 - m) << XY_SHIFT)
    f1 = ((x1 - m) << XY_SHIFT, (y1 - m) << XY_SHIFT)
    dx, dy = (f0[0] - f1[0]) / XY_ONE, (f1[1] - f0[1]) / XY_ONE
    r = dx * dx + dy * dy
    if inside and r > np.finfo(float).eps:
        r = (t + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = _cv_round(dy * r), _cv_round(dx * r)
        _fill_convex_poly(img, [(f0[0] + ox, f0[1] + oy), (f0[0] - ox, f0[1] - oy), (f1[0] - ox, f1[1] - oy),
                                (f1[0] + ox, f1[1] + oy)], col)
    for k, (cx, cy) in enumerate((p0, p1)):
        if flags & (k + 1):
            _circle(img, cx, cy, (t + (XY_ONE >> 1)) >> XY_SHIFT, col)


def polylines(img: np.ndarray, pts, is_closed: bool, color, thickness: int = 1) -> np.ndarray:
    """cv2.polylines(img, [pts], is_closed, color, thickness) at LINE_8, in
    place on a uint8 (H, W) or (H, W, C) image, for integer vertices (n, 2)
    anywhere; returns img."""
    v = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    if not v:
        return img
    col = _color(img, color)
    flags = 2 + (not is_closed)
    p0 = v[-1] if is_closed else v[0]
    for p in v[(not is_closed):]:
        _thick_line(img, p0, p, col, int(thickness), flags)
        p0, flags = p, 2
    return img


class _Edge:
    __slots__ = ("y0", "y1", "x", "dx", "next")

    def __init__(self, y0: int, y1: int, x: int, dx: int):
        self.y0, self.y1, self.x, self.dx, self.next = y0, y1, x, dx, None


def fill_poly(img: np.ndarray, pts, color) -> np.ndarray:
    """cv2.fillPoly(img, [pts], color) at LINE_8, shift 0, in place on an
    integer (H, W, C) or (H, W) image (uint8 pictures, the segment task's
    int32 instance masks and uint8 paste masks), for any integer vertices (inside the image, past its
    edges or thousands of pixels out, degenerate); returns img. As OpenCV
    5.0 draws it: each edge's LINE_8 outline, then the scanline fill of its
    edge table, which fills self-intersecting polygons by the even-odd rule.
    An edge is entered at its vertices' x in 16.16 fixed point, its slope
    rounded down. An edge that leaves the image runs between the ends
    clipLine leaves it, extended to its own rows; where clipping leaves it no
    height (it only touches the image, or misses it), it runs straight down
    the column of its clipped end. Each span fills the pixels whose x lies
    between its two edges, ends included, clipped to the image. Equal to cv2
    5.0.0 on seeded polygons inside and across the image's edges
    (tests/test_torch_host_augment.py)."""
    h, w = img.shape[:2]
    col = _color(img, color)
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    half, edges = XY_ONE >> 1, []
    p0x, p0y = pts[-1][0] << XY_SHIFT, pts[-1][1]
    for x, y in pts:
        p1x, p1y = x << XY_SHIFT, y
        t0x, t1x = (p0x + half) >> XY_SHIFT, (p1x + half) >> XY_SHIFT
        _line8(img, t0x, p0y, t1x, p1y, col)
        c0x, c0y, c1x, c1y = p0x, p0y, p1x, p1y
        if not (0 <= t0x < w and 0 <= t1x < w and 0 <= p0y < h and 0 <= p1y < h):
            _, a, b, c, d = _clip_line(w, h, t0x, p0y, t1x, p1y)
            if b != d:
                c0x, c0y, c1x, c1y = a << XY_SHIFT, b, c << XY_SHIFT, d
            else:  # no height left: a vertical edge at the clipped end's column
                c0x = c1x = a << XY_SHIFT
        if p0y != p1y:
            dx = (c1x - c0x) // (c1y - c0y)
            edges.append(_Edge(p0y, p1y, c0x + (p0y - c0y) * dx, dx) if p0y < p1y else
                         _Edge(p1y, p0y, c1x + (p1y - c1y) * dx, dx))
        p0x, p0y = p1x, p1y
    _fill_edges(img, edges, col)
    return img


def _fill_edges(img: np.ndarray, edges, col: np.ndarray) -> None:
    """OpenCV's FillEdgeCollection at LINE_8: the active edge list walked per
    row, spans drawn between alternate edges, then bubble-sorted by x."""
    h, w = img.shape[:2]
    total = len(edges)
    if total < 2:
        return
    ends = [e.x + (e.y1 - e.y0) * e.dx for e in edges]
    if (max(e.y1 for e in edges) < 0 or min(e.y0 for e in edges) >= h or max(*ends, *(e.x for e in edges)) < 0
            or min(*ends, *(e.x for e in edges)) >= (w << XY_SHIFT)):
        return
    y_max = min(max(e.y1 for e in edges), h)
    edges = sorted(edges, key=lambda e: (e.y0, e.x, e.dx)) + [_Edge(2**31 - 1, 0, 0, 0)]
    head, i = _Edge(0, 0, 0, 0), 0
    e = edges[0]
    for y in range(e.y0, y_max):
        draw, prelast, last = False, head, head.next
        while last is not None or e.y0 == y:
            if last is not None and last.y1 == y:  # this edge ends: drop it
                prelast.next = last = last.next
                continue
            keep = prelast
            if last is not None and (e.y0 > y or last.x < e.x):
                prelast, last = last, last.next
            elif i < total:  # an edge starts: insert it
                prelast.next, e.next, prelast = e, last, e
                i += 1
                e = edges[i]
            else:
                break
            if draw:
                if y >= 0:
                    lo, hi = sorted((keep.x, prelast.x))
                    x1, x2 = (lo + XY_ONE - 1) >> XY_SHIFT, hi >> XY_SHIFT  # the pixels from lo to hi
                    if x1 < w and x2 >= 0:
                        img[y, max(x1, 0) : min(x2, w - 1) + 1] = col
                keep.x += keep.dx
                prelast.x += prelast.dx
            draw = not draw
        stop = None
        while True:  # bubble sort of the active list by x
            prelast, last, swapped = head, head.next, None
            while last is not stop and last.next is not None:
                te = last.next
                if last.x > te.x:
                    prelast.next, last.next, te.next = te, te.next, last
                    prelast = swapped = te
                else:
                    prelast, last = last, te
            if swapped is None or swapped is head.next:
                break
            stop = swapped

def _ink(text: str, font_scale: float) -> np.ndarray:
    """(n, 4) segments of the text in px from the origin, y down."""
    s, pen, segs = font_scale * 2, 0, []
    for ch in text:
        ch = ch if ch in _GLYPHS else "?"  # as cv2 draws a character its font lacks
        g = _SEGMENTS[ch]
        if len(g):
            segs.append((g + [pen, 0, pen, 0]) * [s, -s, s, -s])
        pen += _GLYPHS[ch][0]
    return np.concatenate(segs) if segs else np.zeros((0, 4))


def text_size(text: str, font_scale: float = 0.5, thickness: int = 1) -> Tuple[Tuple[int, int], int]:
    """((width, height), baseline) of put_text's ink from its origin: width to
    the right, height above the baseline, baseline the depth below it."""
    segs = _ink(text, font_scale)
    if not len(segs):
        return (0, 0), 0
    r = max(thickness, 1) / 2
    xs, ys = segs[:, 0::2], segs[:, 1::2]
    return (math.ceil(xs.max() + r), math.ceil(r - ys.min())), max(math.ceil(ys.max() + r), 0)


@functools.lru_cache(maxsize=4096)
def _glyph(ch: str, font_scale: float, thickness: int, fx: float, fy: float) -> Tuple[int, int, np.ndarray]:
    """One character's pixels with its origin at (fx, fy), 0 <= fx, fy < 1:
    (x0, y0, mask), the mask's top-left pixel at (x0, y0). put_text places
    these at the pixel offsets of each character."""
    s = font_scale * 2
    segs = _SEGMENTS[ch] * [s, -s, s, -s] + [fx, fy, fx, fy]
    if not len(segs):
        return 0, 0, np.zeros((0, 0), bool)
    r = max(thickness, 1) / 2
    x0, x1 = math.floor(segs[:, 0::2].min() - r), math.ceil(segs[:, 0::2].max() + r)
    y0, y1 = math.floor(segs[:, 1::2].min() - r), math.ceil(segs[:, 1::2].max() + r)
    py, px = np.mgrid[y0 : y1 + 1, x0 : x1 + 1].astype(np.float64)
    px, py = px[..., None], py[..., None]
    ax, ay, bx, by = (segs[:, i] for i in range(4))
    dx, dy = bx - ax, by - ay
    t = np.clip(((px - ax) * dx + (py - ay) * dy) / np.maximum(dx * dx + dy * dy, 1e-12), 0.0, 1.0)
    return x0, y0, (((ax + t * dx - px) ** 2 + (ay + t * dy - py) ** 2) <= r * r + 1e-9).any(-1)


def put_text(img: np.ndarray, text: str, org: Sequence[int], font_scale: float, color,
             thickness: int = 1) -> np.ndarray:
    """Draw `text` with its baseline's left end at org, in place; returns img.
    Each stroke is the pixels whose centres lie within max(thickness, 1) / 2
    of it (each character's pixels computed once per scale, thickness and
    sub-pixel offset); only the colour is written."""
    col = _color(img, color)
    h, w = img.shape[:2]
    s, pen = font_scale * 2, 0
    oy = math.floor(org[1])
    for ch in text:
        ch = ch if ch in _GLYPHS else "?"  # as cv2 draws a character its font lacks
        px = org[0] + pen * s
        ox = math.floor(px)
        gx, gy, mask = _glyph(ch, float(font_scale), int(thickness), px - ox, org[1] - oy)
        pen += _GLYPHS[ch][0]
        x0, y0 = ox + gx, oy + gy
        cx0, cy0 = max(x0, 0), max(y0, 0)
        cx1, cy1 = min(x0 + mask.shape[1], w), min(y0 + mask.shape[0], h)
        if cx0 < cx1 and cy0 < cy1:
            img[cy0:cy1, cx0:cx1][mask[cy0 - y0 : cy1 - y0, cx0 - x0 : cx1 - x0]] = col
    return img


# -- the train-batch mosaic ----------------------------------------------------


class Colors:
    """The palette of JAX's plotting.py:19 (the ultralytics one): colors(i) RGB, colors(i, True) BGR."""

    def __init__(self):
        hexs = ("042AFF", "0BDBEB", "F3F3F3", "00DFB7", "111F68", "FF6FDD", "FF444F", "CCED00", "00F344", "BD00FF",
                "00B4FF", "DD00BA", "00FFFF", "26C000", "01FFB3", "7D24FF", "7B0068", "FF1B6C", "FC6D2F", "A2FF0B")
        self.palette = [tuple(int(h[i : i + 2], 16) for i in (0, 2, 4)) for h in hexs]
        self.n = len(self.palette)

    def __call__(self, i: int, bgr: bool = False):
        c = self.palette[int(i) % self.n]
        return (c[2], c[1], c[0]) if bgr else c


colors = Colors()


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def images_mosaic(batch: Dict, max_imgs: int = 16, imgsz_grid: int = 1920) -> np.ndarray:
    """The BGR canvas of JAX's plot_images (:117): the first max_imgs RGB
    images of the batch in a ceil(sqrt(n)) grid on white, each tile in BGR
    with its boxes (normalised xywh, int() corners; a rotated box, normalised
    xywh and the angle in radians, by its box_points corners truncated to
    int32) drawn 2 px wide in the palette's colour of the class, the canvas resized (cv2's INTER_LINEAR)
    to imgsz_grid on its long side when it is larger."""
    imgs = _host(batch["img"])[:max_imgs]
    if imgs.dtype != np.uint8:
        raise ValueError(f"images_mosaic: expected uint8 images, got {imgs.dtype}")
    bboxes, cls_all, mask = _host(batch["bboxes"]), _host(batch["cls"]), _host(batch["mask_gt"]).astype(bool)
    n = len(imgs)
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    h, w = imgs.shape[1:3]
    canvas = np.full((rows * h, cols * w, 3), 255, np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        tile = np.ascontiguousarray(im[..., ::-1])
        m = mask[i]
        for b, k in zip(bboxes[i][m], cls_all[i][m]):
            if b.shape[-1] == 5:  # a rotated box: its corners from cv2.boxPoints, drawn by cv2.polylines
                from ..ops.boxes import box_points

                pts = box_points(((b[0] * w, b[1] * h), (b[2] * w, b[3] * h), float(np.degrees(b[4]))))
                polylines(tile, pts.astype(np.int32), True, colors(int(k), True), 2)
                continue
            x1 = int((b[0] - b[2] / 2) * w)
            y1 = int((b[1] - b[3] / 2) * h)
            x2 = int((b[0] + b[2] / 2) * w)
            y2 = int((b[1] + b[3] / 2) * h)
            rectangle(tile, (x1, y1), (x2, y2), colors(int(k), True), 2)
        canvas[r * h : (r + 1) * h, c * w : (c + 1) * w] = tile
    scale = imgsz_grid / max(canvas.shape[:2])
    if scale < 1:
        import torch

        from ..data.augment import resize_linear_u8

        nh, nw = int(canvas.shape[0] * scale), int(canvas.shape[1] * scale)
        canvas = resize_linear_u8(torch.from_numpy(canvas)[None], nh, nw)[0].numpy()
    return canvas


def plot_images(batch: Dict, names: Dict[int, str], save_path: Path, max_imgs: int = 16,
                imgsz_grid: int = 1920) -> Path:
    """JAX's annotated train-batch mosaic (:117), written as cv2.imwrite
    writes it (JPEG at quality 95 for a .jpg path); returns save_path."""
    from ..data.imageio import imwrite

    save_path = Path(save_path)
    canvas = images_mosaic(batch, max_imgs, imgsz_grid)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    imwrite(save_path, canvas)
    return save_path


def feature_visualization(feats: np.ndarray, module_type: str, stage: int, n: int = 32,
                          save_dir: Path = Path("runs/features")) -> Path:
    """JAX's channel grid of a feature map (utils/plotting.py:150): `feats`
    (1, h, w, c) or (h, w, c), NHWC as JAX holds it; the first min(n, c)
    channels in a ceil(sqrt) x ceil(sqrt) grid, each min-max normalised (+1e-6)
    in f32, the canvas written as (canvas * 255).astype(uint8) to
    save_dir/stage{stage}_{module_type's last dotted part}.png (the port's PNG
    writer: cv2's pixels, not its bytes). Returns the path."""
    from ..data.imageio import imwrite

    f = np.asarray(feats[0] if feats.ndim == 4 else feats, np.float32)  # (h, w, c)
    c = min(n, f.shape[-1])
    cols = int(math.ceil(math.sqrt(c)))
    h, w = f.shape[:2]
    canvas = np.zeros((cols * h, cols * w), np.float32)
    for i in range(c):
        r, cc = divmod(i, cols)
        ch = f[..., i]
        rng = ch.max() - ch.min()
        canvas[r * h : (r + 1) * h, cc * w : (cc + 1) * w] = (ch - ch.min()) / (rng + 1e-6)
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    out = save_dir / f"stage{stage}_{module_type.split('.')[-1]}.png"
    imwrite(out, (canvas * 255).astype(np.uint8))
    return out


# -- charts --------------------------------------------------------------------

# matplotlib's default colour cycle (tab10), RGB; the port's own constants
CYCLE = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189), (140, 86, 75),
         (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207))
BLUE, BLACK, GREY = (0, 0, 255), (0, 0, 0), (204, 204, 204)  # RGB
# matplotlib's "Blues": the 9 ColorBrewer anchors, interpolated linearly over 256 entries
_BLUES = np.array([[247, 251, 255], [222, 235, 247], [198, 219, 239], [158, 202, 225], [107, 174, 214],
                   [66, 146, 198], [33, 113, 181], [8, 81, 156], [8, 48, 107]], np.float64) / 255.0
BLUES_LUT = np.round(np.stack([np.interp(np.linspace(0, 1, 256), np.linspace(0, 1, 9), _BLUES[:, i])
                               for i in range(3)], 1) * 255).astype(np.uint8)  # (256, 3) RGB
TICK, LABEL, SMALL = 0.6, 0.75, 0.45  # font scales: tick labels, axis labels and titles, legend and cell texts


def _bgr(rgb) -> Tuple[int, int, int]:
    return int(rgb[2]), int(rgb[1]), int(rgb[0])


def _text_mask(text: str, scale: float) -> np.ndarray:
    """put_text's ink of `text` as a bool mask, tight around the text."""
    (tw, th), base = text_size(text, scale)
    m = np.zeros((th + base + 2, tw + 2), np.uint8)
    put_text(m, text, (1, th + 1), scale, (1,))
    return m.astype(bool)


class Chart:
    """A white BGR canvas (h, w) and one axes box (x0, y0, x1, y1) in pixels,
    mapping data (x, y) in xlim x ylim into it, y up."""

    def __init__(self, w: int, h: int, box: Tuple[int, int, int, int], xlim=(0.0, 1.0), ylim=(0.0, 1.0)):
        self.img = np.full((h, w, 3), 255, np.uint8)
        self.box, self.xlim, self.ylim = box, tuple(map(float, xlim)), tuple(map(float, ylim))
        self.legend_box: Optional[Tuple[int, int, int, int]] = None

    def to_px(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        """Data (x, y) -> pixel (column, row) as floats."""
        x0, y0, x1, y1 = self.box
        (a, b), (c, d) = self.xlim, self.ylim
        px = x0 + (np.asarray(x, np.float64) - a) / (b - a) * (x1 - x0)
        py = y1 - (np.asarray(y, np.float64) - c) / (d - c) * (y1 - y0)
        return px, py

    def paint(self, mask: np.ndarray, x: int, y: int, rgb) -> None:
        """Set the pixels of a bool mask placed with its top-left at (x, y) to rgb, clipped to the canvas."""
        h, w = self.img.shape[:2]
        cx0, cy0, cx1, cy1 = max(x, 0), max(y, 0), min(x + mask.shape[1], w), min(y + mask.shape[0], h)
        if cx0 < cx1 and cy0 < cy1:
            self.img[cy0:cy1, cx0:cx1][mask[cy0 - y : cy1 - y, cx0 - x : cx1 - x]] = _bgr(rgb)

    def text(self, text: str, x: float, y: float, scale: float = TICK, ha: str = "center", va: str = "center",
             rotate: bool = False, rgb=BLACK) -> None:
        """`text` aligned at (x, y) (ha left|center|right, va top|center|bottom); rotate turns it 90 degrees
        counter-clockwise, as a y label or a rotated tick label reads."""
        m = _text_mask(text, scale)
        if rotate:
            m = np.rot90(m)
        h, w = m.shape
        ox = {"left": x, "center": x - w / 2, "right": x - w}[ha]
        oy = {"top": y, "center": y - h / 2, "bottom": y - h}[va]
        self.paint(m, int(round(ox)), int(round(oy)), rgb)

    def rect(self, x0: int, y0: int, x1: int, y1: int, rgb, fill=None) -> None:
        if fill is not None:
            self.img[y0 : y1 + 1, x0 : x1 + 1] = _bgr(fill)
        rectangle(self.img, (x0, y0), (x1, y1), _bgr(rgb), 1)

    def axes(self, xticks: Sequence[float], yticks: Sequence[float], xfmt=None, yfmt=None, xlabel: str = "",
             ylabel: str = "", title: str = "") -> None:
        """The axes' frame, ticks 5 px outside it with their labels, the axis labels and the title."""
        x0, y0, x1, y1 = self.box
        fx = xfmt or (lambda v: f"{v:.1f}")
        fy = yfmt or (lambda v: f"{v:.1f}")
        self.rect(x0, y0, x1, y1, BLACK)
        for v in xticks:
            px = int(round(float(self.to_px(v, self.ylim[0])[0])))
            self.img[y1 : y1 + 6, px] = 0
            self.text(fx(v), px, y1 + 10, TICK, "center", "top")
        for v in yticks:
            py = int(round(float(self.to_px(self.xlim[0], v)[1])))
            self.img[py, x0 - 5 : x0 + 1] = 0
            self.text(fy(v), x0 - 9, py, TICK, "right", "center")
        if xlabel:
            self.text(xlabel, (x0 + x1) / 2, y1 + 36, LABEL, "center", "top")
        if ylabel:
            left = x0 - 9 - max((_text_mask(fy(v), TICK).shape[1] for v in yticks), default=0)
            self.text(ylabel, left - 8, (y0 + y1) / 2, LABEL, "right", "center", rotate=True)
        if title:
            self.text(title, (x0 + x1) / 2, y0 - 8, LABEL, "center", "bottom")

    def polyline(self, x, y, rgb, width: int = 1) -> None:
        """The polyline through the data points, `width` px wide (a square
        brush), clipped to the axes box; every vertex's own pixel is drawn."""
        px, py = self.to_px(x, y)
        ok = np.isfinite(px) & np.isfinite(py)
        px, py = px[ok], py[ok]
        if not len(px):
            return
        if len(px) == 1:
            xs, ys = np.rint(px), np.rint(py)
        else:
            dx, dy = np.diff(px), np.diff(py)
            n = np.ceil(np.maximum(np.abs(dx), np.abs(dy))).astype(np.int64) + 1  # samples per segment
            seg = np.repeat(np.arange(len(n)), n)
            t = (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)) / np.maximum(np.repeat(n - 1, n), 1)
            xs, ys = np.rint(px[seg] + t * dx[seg]), np.rint(py[seg] + t * dy[seg])
        xs, ys = xs.astype(np.int64), ys.astype(np.int64)
        lo, hi = -(width // 2), (width - 1) // 2
        if width > 1:
            off = np.arange(lo, hi + 1)
            xs = (xs[:, None, None] + off[None, :, None] + 0 * off[None, None, :]).ravel()
            ys = (ys[:, None, None] + 0 * off[None, :, None] + off[None, None, :]).ravel()
        x0, y0, x1, y1 = self.box
        keep = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
        self.img[ys[keep], xs[keep]] = _bgr(rgb)

    def dots(self, x, y, rgb, radius: int = 2) -> None:
        """A filled disc at each data point (matplotlib's "." marker)."""
        px, py = self.to_px(x, y)
        for cx, cy in zip(np.rint(px).astype(int), np.rint(py).astype(int)):
            _circle(self.img, int(cx), int(cy), radius, np.asarray(_bgr(rgb), np.uint8))

    def legend(self, entries: Sequence[Tuple[str, tuple, int]],
               points: Sequence[Tuple[np.ndarray, np.ndarray]]) -> None:
        """A framed legend (a line sample and its label per entry) in the corner of
        the axes that covers the fewest of `points` (each an (x, y) data pair)."""
        if not entries:
            return
        x0, y0, x1, y1 = self.box
        rows = 18
        w = 46 + max(_text_mask(t, SMALL).shape[1] for t, _, _ in entries) + 8
        h = rows * len(entries) + 8
        pts = [np.stack(self.to_px(x, y), -1) for x, y in points]
        pts = np.concatenate(pts) if pts else np.zeros((0, 2))
        best = None
        for lx, ly in ((x1 - 8 - w, y0 + 8), (x0 + 8, y0 + 8), (x0 + 8, y1 - 8 - h), (x1 - 8 - w, y1 - 8 - h)):
            inside = int(((pts[:, 0] >= lx) & (pts[:, 0] <= lx + w) & (pts[:, 1] >= ly) & (pts[:, 1] <= ly + h)).sum())
            if best is None or inside < best[0]:
                best = (inside, lx, ly)
        _, lx, ly = best
        self.rect(lx, ly, lx + w, ly + h, GREY, fill=(255, 255, 255))
        self.legend_box = (lx, ly, lx + w, ly + h)
        for i, (label, rgb, width) in enumerate(entries):
            cy = ly + 4 + rows * i + rows // 2
            lo = -(width // 2)
            self.img[cy + lo : cy + lo + width, lx + 8 : lx + 38] = _bgr(rgb)
            self.text(label, lx + 46, cy, SMALL, "left", "center")

    def write(self, path: Path) -> Path:
        from ..data.imageio import imencode_png

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(imencode_png(self.img))
        return path


UNIT_TICKS = tuple(np.round(np.linspace(0, 1, 6), 1))


def render_pr_curve(p_curve: np.ndarray, r_curve: np.ndarray, ap: np.ndarray, names: Dict[int, str]) -> Chart:
    """JAX's plot_pr_curve (:79) figure, 7 x 6 in at 150 dpi: each class's
    precision against recall, labelled "<name> <AP50:.3f>" (names as given,
    JAX's caller remaps them by unique_classes) when there are fewer than 21."""
    ch = Chart(1050, 900, (131, 108, 945, 801))
    ch.axes(UNIT_TICKS, UNIT_TICKS, xlabel="Recall", ylabel="Precision")
    show = len(names) < 21
    entries, points = [], []
    for ci in range(p_curve.shape[0]):
        rgb = CYCLE[ci % len(CYCLE)]
        ch.polyline(r_curve[ci], p_curve[ci], rgb)
        points.append((r_curve[ci], p_curve[ci]))
        if show:
            entries.append((f"{names.get(ci, ci)} {ap[ci, 0]:.3f}", rgb, 1))
    ch.legend(entries, points)
    return ch


def plot_pr_curve(p_curve: np.ndarray, r_curve: np.ndarray, ap: np.ndarray, names: Dict[int, str],
                  save_dir: Path, x: Optional[np.ndarray] = None) -> Path:
    """PR_curve.png under save_dir (JAX :79)."""
    return render_pr_curve(p_curve, r_curve, ap, names).write(Path(save_dir) / "PR_curve.png")


def render_mc_curve(x: np.ndarray, y: np.ndarray, names: Dict[int, str], ylabel: str = "F1") -> Chart:
    """JAX's plot_mc_curve (:170) figure, 7 x 6 in at 150 dpi: each class's
    metric against confidence, 1 px, named through `names` when there are
    fewer than 21, then their mean 3 px in blue, labelled "all classes
    <max:.2f> at <x of the max:.3f>"."""
    ch = Chart(1050, 900, (131, 108, 945, 801))
    ch.axes(UNIT_TICKS, UNIT_TICKS, xlabel="Confidence", ylabel=ylabel)
    entries, points = [], []
    for ci in range(y.shape[0]):
        rgb = CYCLE[ci % len(CYCLE)]
        ch.polyline(x, y[ci], rgb, 1)
        points.append((x, y[ci]))
        if len(names) < 21:
            entries.append((str(names.get(ci, ci)), rgb, 1))
    my = y.mean(0)
    ch.polyline(x, my, BLUE, 3)
    points.append((x, my))
    entries.append((f"all classes {my.max():.2f} at {x[my.argmax()]:.3f}", BLUE, 3))
    ch.legend(entries, points)
    return ch


def plot_mc_curve(x: np.ndarray, y: np.ndarray, names: Dict[int, str], save_dir: Path, ylabel: str = "F1",
                  fname: Optional[str] = None) -> Path:
    """<ylabel>_curve.png (or fname) under save_dir (JAX :170)."""
    return render_mc_curve(x, y, names, ylabel).write(Path(save_dir) / (fname or f"{ylabel}_curve.png"))


def _nice_ticks(lo: float, hi: float, most: int = 6) -> Tuple[np.ndarray, str]:
    """Ticks at multiples of 1, 2, 2.5 or 5 x 10^k inside [lo, hi], at most `most`, and their format."""
    span = max(hi - lo, 1e-300)
    for k in range(int(math.floor(math.log10(span / most))), int(math.floor(math.log10(span))) + 2):
        for m in (1, 2, 2.5, 5):
            step = m * 10.0 ** k
            ticks = np.arange(math.ceil(lo / step - 1e-9), math.floor(hi / step + 1e-9) + 1) * step
            if len(ticks) <= most:
                decimals = max(0, -k + (1 if m == 2.5 else 0))
                return ticks, f"{{:.{decimals}f}}"
    return np.array([lo, hi]), "{:g}"


def _data_limits(v: np.ndarray) -> Tuple[float, float]:
    """matplotlib's autoscaled limits of the data: its range (a single value
    widened by 5 % of itself, or to +-0.05 at 0) and 5 % margins."""
    v = v[np.isfinite(v)]
    lo, hi = (float(v.min()), float(v.max())) if len(v) else (0.0, 1.0)
    if hi - lo <= 1e-12 * max(abs(lo), abs(hi), 1.0):
        lo, hi = (lo - 0.05 * abs(lo), hi + 0.05 * abs(hi)) if lo else (-0.05, 0.05)
    m = (hi - lo) * 0.05
    return lo - m, hi + m


def render_confusion_matrix(matrix: np.ndarray, names: Dict[int, str], normalize: bool = True) -> Chart:
    """JAX's plot_confusion_matrix (:191) figure, 8 x 7 in at 150 dpi: the
    matrix (normalised by its column sums + 1e-9) as a "Blues" heatmap from 0
    to its maximum with a colour bar, the class names and "background" as
    ticks (x turned 90 degrees), "True" / "Predicted", and each cell above
    0.005 written "<v:.2f>" when the matrix has at most 30 rows."""
    m = matrix.astype(np.float64)
    if normalize:
        m = m / (m.sum(0, keepdims=True) + 1e-9)
    n = m.shape[0]
    labels = [str(names.get(i, str(i))) for i in range(n - 1)] + ["background"]
    side = 820
    x0, y0 = 150, 60
    ch = Chart(1200, 1050, (x0, y0, x0 + side, y0 + side), xlim=(-0.5, n - 0.5), ylim=(n - 0.5, -0.5))
    vmax = float(m.max()) if m.size and m.max() > 0 else 1.0
    idx = np.clip((m / vmax * 256).astype(np.int64), 0, 255)
    edges = np.rint(np.linspace(0, side, n + 1)).astype(int)
    for i in range(n):
        for j in range(n):
            ch.img[y0 + edges[i] : y0 + edges[i + 1], x0 + edges[j] : x0 + edges[j + 1]] = _bgr(BLUES_LUT[idx[i, j]])
    ch.rect(x0, y0, x0 + side, y0 + side, BLACK)
    centres = x0 + (edges[:-1] + edges[1:]) / 2
    for i, lab in enumerate(labels):
        c = int(round(centres[i] - x0))
        ch.img[y0 + side : y0 + side + 6, x0 + c] = 0
        ch.text(lab, x0 + c, y0 + side + 10, TICK, "center", "top", rotate=True)
        ch.img[y0 + c, x0 - 5 : x0 + 1] = 0
        ch.text(lab, x0 - 9, y0 + c, TICK, "right", "center")
    below = y0 + side + 10 + max(_text_mask(t, TICK).shape[1] for t in labels)
    ch.text("True", x0 + side / 2, below + 14, LABEL, "center", "top")
    left = x0 - 9 - max(_text_mask(t, TICK).shape[1] for t in labels)
    ch.text("Predicted", left - 10, y0 + side / 2, LABEL, "right", "center", rotate=True)
    if n <= 30:
        for i in range(n):
            for j in range(n):
                if m[i, j] > 0.005:
                    ch.text(f"{m[i, j]:.2f}", centres[j], y0 + (edges[i] + edges[i + 1]) / 2, SMALL)
    cx0, cx1 = x0 + side + 50, x0 + side + 95  # the colour bar, 0 at the bottom
    rows = np.arange(side + 1)
    lut_i = np.clip(((side - rows) / side * 256).astype(np.int64), 0, 255)
    ch.img[y0 : y0 + side + 1, cx0 : cx1 + 1] = BLUES_LUT[lut_i][:, None, ::-1]
    ch.rect(cx0, y0, cx1, y0 + side, BLACK)
    ticks, fmt = _nice_ticks(0.0, vmax)
    for v in ticks:
        py = int(round(y0 + side - v / vmax * side))
        ch.img[py, cx1 : cx1 + 6] = 0
        ch.text(fmt.format(v), cx1 + 10, py, TICK, "left", "center")
    return ch


def plot_confusion_matrix(matrix: np.ndarray, names: Dict[int, str], save_dir: Path, normalize: bool = True) -> Path:
    """confusion_matrix_normalized.png or confusion_matrix.png under save_dir (JAX :191)."""
    out = Path(save_dir) / ("confusion_matrix_normalized.png" if normalize else "confusion_matrix.png")
    return render_confusion_matrix(matrix, names, normalize).write(out)


def plot_val_curves(metrics, names: Dict[int, str], save_dir: Path) -> list:
    """PR_curve.png, F1_curve.png, P_curve.png and R_curve.png from a
    DetMetrics' `curves_results` (JAX :221): the PR curve names its rows
    through a dict remapped by unique_classes, the others through `names`."""
    curves = getattr(metrics, "curves_results", None)
    if not curves:
        return []
    x = np.linspace(0, 1, curves["p_curve"].shape[1])
    return [
        plot_pr_curve(curves["p_curve"], curves["r_curve"], curves["ap"],
                      {i: names.get(int(c), int(c)) for i, c in enumerate(curves["unique_classes"])}, save_dir),
        plot_mc_curve(x, curves["f1_curve"], names, save_dir, "F1"),
        plot_mc_curve(x, curves["p_curve"], names, save_dir, "Precision", "P_curve.png"),
        plot_mc_curve(x, curves["r_curve"], names, save_dir, "Recall", "R_curve.png"),
    ]


def render_results(rows: Sequence[Dict[str, str]]) -> Chart:
    """JAX's plot_results (:48) figure: one panel per column of results.csv
    but `epoch`, at most 5 a row, each 4 x 3 in at 120 dpi, the column
    against the epoch with "." markers, titled with its name; each panel's
    limits are the data's with 5 % margins."""
    keys = [k for k in rows[0] if k != "epoch"]
    ncols = min(5, len(keys))
    nrows = (len(keys) + ncols - 1) // ncols
    pw, ph = 480, 360
    ch = Chart(pw * ncols, ph * nrows, (0, 0, 1, 1))
    epochs = np.array([float(r["epoch"]) for r in rows])
    for i, k in enumerate(keys):
        vals = np.array([float(r[k] or 0) for r in rows])
        r, c = divmod(i, ncols)
        ch.box = (c * pw + 70, r * ph + 36, c * pw + pw - 16, r * ph + ph - 40)
        ch.xlim, ch.ylim = _data_limits(epochs), _data_limits(vals)
        xt, xf = _nice_ticks(*ch.xlim)
        yt, yf = _nice_ticks(*ch.ylim)
        ch.axes(xt, yt, xfmt=xf.format, yfmt=yf.format, title=k)
        ch.polyline(epochs, vals, CYCLE[0], 1)
        ch.dots(epochs, vals, CYCLE[0])
    return ch


def plot_results(csv_file: str | Path, save_dir: Optional[Path] = None) -> Optional[Path]:
    """results.png beside results.csv (or under save_dir), as JAX's :48; None
    (with a warning) when the file is missing, None when it has no rows."""
    import csv as csvmod

    csv_file = Path(csv_file)
    if not csv_file.exists():
        LOGGER.warning(f"plot_results: {csv_file} not found")
        return None
    with open(csv_file) as f:
        rows = list(csvmod.DictReader(f))
    if not rows:
        return None
    return render_results(rows).write(Path(save_dir or csv_file.parent) / "results.png")
