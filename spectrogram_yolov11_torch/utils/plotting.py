"""Box and label drawing on host images: what Results.plot draws. Counterpart
of the drawing the JAX package does with cv2 (spectrogram_yolov11_tpu/engine/
results.py:248-284 Results.plot: cv2.rectangle and cv2.putText); the port
has no cv2.

`rectangle(img, p1, p2, color, thickness)` is cv2.rectangle at LINE_8, pixel
for pixel, as OpenCV draws it: four segments through the corners p1, (p2.x,
p1.y), p2, (p1.x, p2.y). At thickness 1 each segment is the pixel run from
corner to corner; thicker, each is the band of its rasterised quad, half
width (thickness + 1) // 2 on each side of the centre line, and every corner
gets a filled midpoint circle of that radius (cv2's round joints), so the
outer corners are rounded. Segments of length 0 draw their circle only, so a
box with p1 == p2 is a disc, and everything is clipped to the image; a
negative thickness fills the box.

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
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np

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
    """The colour as the image's channels take it (cv2: the first C values of the scalar)."""
    c = np.asarray(color, np.float64).reshape(-1)
    ch = 1 if img.ndim == 2 else img.shape[2]
    return np.clip(np.round(c[:ch]), 0, 255).astype(img.dtype)


def _fill(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color: np.ndarray) -> None:
    """Pixels x0..x1, y0..y1 (inclusive) set to color, clipped to the image."""
    h, w = img.shape[:2]
    x0, x1 = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
    y0, y1 = max(min(y0, y1), 0), min(max(y0, y1), h - 1)
    if x0 <= x1 and y0 <= y1:
        img[y0 : y1 + 1, x0 : x1 + 1] = color if img.ndim == 3 else color[0]


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
    col = col if img.ndim == 3 else col[0]
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
