"""The port's drawing against cv2 and against the JAX package's Results.plot.

- `utils/plotting.rectangle` equals cv2.rectangle (LINE_8) pixel for pixel at
  thickness 1 to 8 and filled (-1), on seeded boxes: inside, across and
  wholly outside the border, reversed corners, p1 == p2, zero width or
  height; on colour, one-channel and 2-D images of odd sizes.
- Results.plot against JAX's Results(...).plot built from the same numpy
  arrays (no JAX compile: the JAX side is cv2 on numpy):
  (a) show_labels=False: equal bit for bit, over seeded box sets at line
      widths 1-6 and the automatic one, on colour and gray-broadcast frames;
  (b) with labels: equal outside the label regions, a label's region being
      the box cv2.getTextSize(label, FONT_HERSHEY_SIMPLEX, 0.5, max(lw - 1,
      1)) gives at JAX's origin (x1, max(y1 - 4, 12)), the baseline
      included, padded by that thickness plus 1 px;
  (c) inside the regions, the port changes pixels only to the colour of a
      label whose region holds them, and every label draws a pixel.
  JAX's own label pixels come from the installed cv2's font (OpenCV 5.0.0
  here: anti-aliased outline glyphs); the port draws its own stroke font, so
  labels are held to (b) and (c), not to JAX's pixels.
- save and save_crop write the files JAX's write, with the same bytes, for
  the plots without labels and for the crops.
"""

import cv2
import numpy as np
import pytest
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.engine.results import _COLORS, Results
from spectrogram_yolov11_torch.utils.plotting import put_text, rectangle, text_size
from spectrogram_yolov11_tpu.engine.results import _COLORS as JAX_COLORS
from spectrogram_yolov11_tpu.engine.results import Results as JaxResults

NAMES = {0: "LTE", 1: "RF", 2: "5G NR", 3: "wifi_2.4GHz", 4: "Bluetooth LE", 5: "jammer (pulsed)", 6: "{?}|~@"}
LINE_WIDTHS = (None, 1, 2, 3, 4, 5, 6)


def test_colours_are_jaxs():
    np.testing.assert_array_equal(_COLORS, JAX_COLORS)


@pytest.mark.parametrize("thickness", [-1, 1, 2, 3, 4, 5, 6, 7, 8])
def test_rectangle_equals_cv2(thickness):
    rng = np.random.default_rng(thickness + 10)
    for trial in range(300):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        shape = ((h, w), (h, w, 1), (h, w, 3))[trial % 3]
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        x1, y1, x2, y2 = (int(v) for v in rng.integers(-25, 95, 4))
        if trial % 7 == 0:
            x2, y2 = x1, y1
        elif trial % 7 == 1:
            x2 = x1
        elif trial % 7 == 2:
            y2 = y1
        color = [int(v) for v in rng.integers(0, 256, 3)]
        ref = cv2.rectangle(img.copy(), (x1, y1), (x2, y2), color, thickness)
        got = rectangle(img.copy(), (x1, y1), (x2, y2), color, thickness)
        np.testing.assert_array_equal(got, ref, err_msg=f"{shape} ({x1}, {y1}) ({x2}, {y2}) t={thickness}")


def _frame(rng, i: int) -> np.ndarray:
    """Odd sizes; colour, or gray broadcast over three channels."""
    h, w = int(rng.integers(40, 400)), int(rng.integers(40, 500))
    if i % 2:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return np.repeat(rng.integers(0, 256, (h, w, 1), dtype=np.uint8), 3, -1)


def _boxes(rng, h: int, w: int, n: int) -> np.ndarray:
    """n boxes (x1, y1, x2, y2, conf, cls) in f32, some across or outside the border, some degenerate."""
    x = rng.uniform(-0.2 * w, 1.2 * w, (n, 2))
    y = rng.uniform(-0.2 * h, 1.2 * h, (n, 2))
    b = np.stack([x.min(1), y.min(1), x.max(1), y.max(1), rng.uniform(0, 1, n), rng.integers(0, 25, n)], 1)
    b[: n // 6, 2:4] = b[: n // 6, 0:2]  # points
    return b.astype(np.float32)


def _cases(seed: int, k: int = 12):
    rng = np.random.default_rng(seed)
    for i in range(k):
        img = _frame(rng, i)
        names = NAMES if i % 3 else {0: "LTE", 1: "RF"}  # classes without a name are labelled by their number
        yield img, _boxes(rng, *img.shape[:2], int(rng.integers(1, 14))), names


def _label_regions(boxes, names, lw: int, show_conf: bool):
    """Per box: the label region of yardstick (b) as (x0, y0, x1, y1), inclusive."""
    th = max(lw - 1, 1)
    out = []
    for b in boxes:
        c = int(b[5])
        label = names.get(c, str(c)) + (f" {b[4]:.2f}" if show_conf else "")
        (tw, tht), base = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, th)
        ox, oy = int(b[0]), max(int(b[1]) - 4, 12)
        pad = th + 1
        out.append((ox - pad, oy - tht - pad, ox + tw + pad, oy + base + pad))
    return out


def _lw(img, line_width):
    return line_width or max(round(sum(img.shape[:2]) / 2 * 0.003), 2)


@pytest.mark.parametrize("line_width", LINE_WIDTHS, ids=lambda v: f"lw{v}")
def test_plot_without_labels_equals_jax(line_width):
    """Yardstick (a)."""
    for img, boxes, names in _cases(100 + (line_width or 0)):
        got = Results(img, "x.jpg", names, boxes=boxes).plot(line_width=line_width, show_labels=False)
        ref = JaxResults(img, "x.jpg", names, boxes=boxes).plot(line_width=line_width, show_labels=False)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("line_width", LINE_WIDTHS, ids=lambda v: f"lw{v}")
@pytest.mark.parametrize("show_conf", [True, False], ids=["conf", "noconf"])
def test_plot_with_labels_keeps_the_yardstick(line_width, show_conf):
    """Yardstick (b) and (c)."""
    for img, boxes, names in _cases(200 + (line_width or 0) + 7 * show_conf):
        r = Results(img, "x.jpg", names, boxes=boxes)
        got = r.plot(line_width=line_width, show_conf=show_conf)
        ref = JaxResults(img, "x.jpg", names, boxes=boxes).plot(line_width=line_width, show_conf=show_conf)
        bare = r.plot(line_width=line_width, show_labels=False)
        h, w = img.shape[:2]
        yy, xx = np.mgrid[:h, :w]
        regions = [(xx >= x0) & (xx <= x1) & (yy >= y0) & (yy <= y1)
                   for x0, y0, x1, y1 in _label_regions(boxes, names, _lw(img, line_width), show_conf)]
        inside = np.logical_or.reduce(regions)
        np.testing.assert_array_equal(got[~inside], ref[~inside])  # (b)
        allowed = np.zeros((h, w), bool)
        for region, b in zip(regions, boxes):
            allowed |= region & (got == _COLORS[int(b[5]) % len(_COLORS)]).all(-1)
        changed = (got != bare).any(-1)
        assert not (changed & ~allowed).any()  # (c)
        th = max(_lw(img, line_width) - 1, 1)
        for b in boxes:  # (c): every label draws, in its colour only
            label = names.get(int(b[5]), str(int(b[5]))) + (f" {b[4]:.2f}" if show_conf else "")
            canvas = put_text(np.zeros((60, 400, 3), np.uint8), label, (10, 30), 0.5, (255, 0, 0), th)
            assert canvas.any(), f"{label!r} drew nothing"
            assert canvas[..., 1:].max() == 0 and set(np.unique(canvas[..., 0]).tolist()) == {0, 255}


def test_label_boxes_fit_cv2s_for_every_character():
    """Each printable character, eight times over, at thicknesses 1-7: the
    port's ink lies in the label region cv2 5.0.0's text size gives, and its
    own text_size bounds its ink."""
    for th in range(1, 8):
        for c in range(32, 127):
            label = chr(c) * 8
            (tw, tht), base = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, th)
            canvas = put_text(np.zeros((80, 200), np.uint8), label, (30, 40), 0.5, (255,), th)
            ys, xs = np.nonzero(canvas)
            pad = th + 1
            if c == 32:
                assert not len(xs)
                continue
            assert xs.min() >= 30 - pad and xs.max() <= 30 + tw + pad, (label, th)
            assert ys.min() >= 40 - tht - pad and ys.max() <= 40 + base + pad, (label, th)
            (pw, ph), pb = text_size(label, 0.5, th)
            assert xs.max() <= 30 + pw and ys.min() >= 40 - ph and ys.max() <= 40 + pb, (label, th)


def test_save_and_save_crop_write_jaxs_files(tmp_path):
    """save(show_labels=False) and save_crop: the same file names and bytes as JAX's."""
    for side in ("port", "jax"):
        (tmp_path / side).mkdir()
    for i, (img, boxes, names) in enumerate(_cases(300, k=6)):
        port, jax_r = (cls(img, f"frame{i}.png", names, boxes=boxes) for cls in (Results, JaxResults))
        assert port.save(tmp_path / "port" / f"{i}.jpg", show_labels=False) == str(tmp_path / "port" / f"{i}.jpg")
        jax_r.save(tmp_path / "jax" / f"{i}.jpg", show_labels=False)
        port.save_crop(tmp_path / "port" / "crops", f"frame{i}.jpg")
        jax_r.save_crop(tmp_path / "jax" / "crops", f"frame{i}.jpg")
    files = {side: sorted(p.relative_to(tmp_path / side) for p in (tmp_path / side).rglob("*.jpg"))
             for side in ("port", "jax")}
    assert files["port"] == files["jax"] and len(files["port"]) > 20
    for rel in files["port"]:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_show_raises():
    r = Results(np.zeros((8, 8, 3), np.uint8), "x", {0: "LTE"}, boxes=np.zeros((0, 6), np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 5"):
        r.show()
