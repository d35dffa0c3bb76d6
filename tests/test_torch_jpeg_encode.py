"""The port's JPEG encoder writes the bytes cv2.imencode(".jpg") writes.

`data/jpeg.py:encode_jpeg` (markers and quality-scaled tables in Python, the
scan in the host library's csrc/jpeg_encode.cpp) and `data/imageio.py`'s
imencode / imwrite must give, byte for byte, what cv2.imencode(".jpg", img,
[cv2.IMWRITE_JPEG_QUALITY, q]) gives (OpenCV 5.0.0 here, libjpeg-turbo
3.1.2 with SIMD) on

- quality 1, 10, 50, 75, 90, 95 and 100, by colour (BGR, 4:2:0) and gray
  ((H, W) and (H, W, 1)) frames of 1 x 1, 7 x 13, 17 x 33, 360 x 640 and
  481 x 723, each flat, seeded noise and a seeded spectrogram (the port's
  data/synth.py; tinted for colour);
- the committed encodes in tests/torch_data/jpeg_encode/: cv2's bytes of
  frames decoded from the decoder's fixtures (tests/torch_data/jpeg/), with
  their SHA-256 in cv2_encoded.json, which chip_smoke.py holds the card
  machine's build to (it has no cv2);

and imread of what imwrite writes equals cv2.imread of cv2's file. Run as a
script, the file rewrites the committed encodes and their digests
(`PYTHONPATH=. python tests/test_torch_jpeg_encode.py`), then prints the
encode time of a 640 x 360 spectrogram frame beside cv2's (CPU readings).
"""

import hashlib
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.data.imageio import imencode, imread, imwrite
from spectrogram_yolov11_torch.data.jpeg import encode_jpeg, quant_tables
from spectrogram_yolov11_torch.data.synth import synth_frames

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "torch_data" / "jpeg_encode"
DIGESTS = FIXTURES / "cv2_encoded.json"
QUALITIES = (1, 10, 50, 75, 90, 95, 100)
SIZES = ((1, 1), (7, 13), (17, 33), (360, 640), (481, 723))
# name -> (decoder fixture under tests/torch_data/jpeg/, crop [y0, y1, x0, x1] or None, gray, quality)
COMMITTED = {
    "odd641x359_q95.jpg": ("641x359.jpg", None, False, 95),
    "spectrogram320_gray_q90.jpg": ("spectrogram/images/val/00000.jpg", None, True, 90),
    "spectrogram320_q50.jpg": ("spectrogram/images/val/00001.jpg", None, False, 50),
    "crop17x33_q100.jpg": ("spectrogram/images/val/00002.jpg", [101, 118, 57, 90], False, 100),
    "1x1_q1.jpg": ("spectrogram/images/val/00003.jpg", [7, 8, 11, 12], False, 1),
}


def cv2_jpeg(img: np.ndarray, q: int) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])
    assert ok
    return buf.tobytes()


def frames(h: int, w: int, color: bool, seed: int):
    """Flat, noise and spectrogram content at (h, w): BGR (h, w, 3) or gray (h, w)."""
    rng = np.random.default_rng(seed)
    spec = synth_frames(1, max(h, 32), max(w, 32), seed=seed)[0][:h, :w, 0]
    if color:
        return {"flat": np.full((h, w, 3), (37, 140, 201), np.uint8),
                "noise": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                "spectrogram": (spec[..., None] * np.array([1.0, 0.9, 0.8])).astype(np.uint8)}
    return {"flat": np.full((h, w), 93, np.uint8), "noise": rng.integers(0, 256, (h, w), dtype=np.uint8),
            "spectrogram": np.ascontiguousarray(spec)}


def committed_input(source: str, crop, gray: bool) -> np.ndarray:
    img = imread(ROOT / "tests" / "torch_data" / "jpeg" / source)
    if crop:
        img = img[crop[0] : crop[1], crop[2] : crop[3]]
    return np.ascontiguousarray(img[..., 0] if gray else img)


@pytest.mark.parametrize("q", QUALITIES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("color", [True, False], ids=["bgr", "gray"])
def test_bytes_equal_cv2(color, size, q):
    for name, img in frames(*size, color, seed=q + size[0]).items():
        ref = cv2_jpeg(img, q)
        assert encode_jpeg(img, q) == ref, f"{name} {img.shape} at quality {q}"
        assert imencode(".jpg", img, quality=q) == ref and imencode(".JPEG", img, quality=q) == ref
        if not color:  # (H, W, 1) is gray too
            assert encode_jpeg(img[..., None], q) == ref == cv2_jpeg(img[..., None], q)


@pytest.mark.parametrize("name", sorted(COMMITTED))
def test_committed_encodes(name):
    """cv2's committed bytes and digest, and the port's bytes of the same frame, all equal."""
    source, crop, gray, q = COMMITTED[name]
    digests = json.loads(DIGESTS.read_text())["files"]
    data = (FIXTURES / name).read_bytes()
    assert hashlib.sha256(data).hexdigest() == digests[name]["sha256"]
    assert digests[name] == {"source": source, "crop": crop, "gray": gray, "quality": q,
                             "sha256": digests[name]["sha256"]}
    img = committed_input(source, crop, gray)
    assert encode_jpeg(img, q) == data == cv2_jpeg(img, q)


@pytest.mark.parametrize("color", [True, False], ids=["bgr", "gray"])
def test_imwrite_reads_back_as_cv2_reads_cv2s_file(tmp_path, color):
    img = frames(97, 131, color, seed=5)["spectrogram"]
    for suffix in (".jpg", ".jpeg"):
        assert imwrite(tmp_path / f"port{suffix}", img) is True
        assert cv2.imwrite(str(tmp_path / f"cv2{suffix}"), img)
        assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"cv2{suffix}").read_bytes()
        np.testing.assert_array_equal(imread(tmp_path / f"port{suffix}"), cv2.imread(str(tmp_path / f"cv2{suffix}")))
    imwrite(tmp_path / "q60.jpg", img, quality=60)
    assert (tmp_path / "q60.jpg").read_bytes() == cv2_jpeg(img, 60)


def test_quality_tables_and_clamping():
    """jpeg_set_quality's scaling: 50 keeps Annex K's tables, 100 gives ones,
    cv2 clamps the quality to 0..100 and libjpeg 0 to 1; the DQT of a file
    holds the table in zigzag order."""
    t50, t100 = quant_tables(50), quant_tables(100)
    assert t50[0, :8].tolist() == [16, 11, 10, 16, 24, 40, 51, 61] and (t50[1, 32:] == 99).all()
    assert (t100 == 1).all() and quant_tables(1).max() == 255
    img = frames(24, 40, True, seed=1)["noise"]
    for q, same in ((0, 1), (-5, 1), (101, 100), (250, 100)):
        assert encode_jpeg(img, q) == encode_jpeg(img, same) == cv2_jpeg(img, q)


def test_threads_and_bad_input():
    """Encodes in 8 threads (the host library releases the GIL) equal the
    serial ones; other dtypes, shapes and suffixes raise."""
    imgs = [frames(64 + i, 96 + 3 * i, bool(i % 2), seed=i)["spectrogram"] for i in range(8)]
    with ThreadPoolExecutor(8) as ex:
        assert list(ex.map(encode_jpeg, imgs)) == [cv2_jpeg(im, 95) for im in imgs]
    for bad in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 2), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((0, 4, 3), np.uint8), np.zeros((4,), np.uint8)):
        with pytest.raises(ValueError):
            encode_jpeg(bad)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        imencode(".bmp", imgs[0])


def make_fixtures() -> None:
    """Rewrite tests/torch_data/jpeg_encode/: cv2's encode of each COMMITTED
    frame, and cv2_encoded.json with the inputs and SHA-256s."""
    FIXTURES.mkdir(parents=True, exist_ok=True)
    files = {}
    for name, (source, crop, gray, q) in COMMITTED.items():
        data = cv2_jpeg(committed_input(source, crop, gray), q)
        (FIXTURES / name).write_bytes(data)
        files[name] = {"source": source, "crop": crop, "gray": gray, "quality": q,
                       "sha256": hashlib.sha256(data).hexdigest()}
    made = ("PYTHONPATH=. python tests/test_torch_jpeg_encode.py (make_fixtures): cv2.imencode('.jpg', frame, "
            "[IMWRITE_JPEG_QUALITY, quality]) of the frame decoded from tests/torch_data/jpeg/<source> (cropped "
            f"[y0, y1, x0, x1], its first channel where gray), cv2 {cv2.__version__}")
    rows = ",\n".join(f"  {json.dumps(k)}: {json.dumps(v)}" for k, v in files.items())
    DIGESTS.write_text(f'{{\n "made": {json.dumps(made)},\n "files": {{\n{rows}\n }}\n}}\n')


if __name__ == "__main__":
    import time

    make_fixtures()
    spec = synth_frames(1, 360, 640, seed=0)[0]
    for name, img in (("640 x 360 colour", (np.repeat(spec, 3, -1) * np.array([1.0, 0.9, 0.8])).astype(np.uint8)),
                      ("640 x 360 gray", np.ascontiguousarray(spec[..., 0]))):
        assert encode_jpeg(img) == cv2_jpeg(img, 95)
        t0 = time.perf_counter()
        for _ in range(30):
            encode_jpeg(img)
        t1 = time.perf_counter()
        for _ in range(30):
            cv2_jpeg(img, 95)
        t2 = time.perf_counter()
        print(f"{name} spectrogram, quality 95: encode_jpeg {(t1 - t0) / 30 * 1e3:.2f} ms, cv2.imencode "
              f"{(t2 - t1) / 30 * 1e3:.2f} ms, {len(encode_jpeg(img))} bytes (CPU readings)")
