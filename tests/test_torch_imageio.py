"""The port's PNG reader equals cv2.imread, and its writer round-trips.

`imread` must give what cv2.imread(path) gives (IMREAD_COLOR: BGR uint8)
bit for bit, on PNGs that cv2 writes (gray, BGR, BGRA; odd sizes;
compression levels 0 and 9) and on PNGs built here by hand: each of the five
row filters on gray + alpha and RGB rows, and a palette image. The test reads
the filter byte of every row of its files and asserts that all five filter
types occur among them (libpng's adaptive filtering, which cv2 uses, picks
among them row by row; the hand-built files use every filter on every kind of
row). The host library's Average and Paeth rows equal the plain Python
loop on seeded rows of every filter type, bpp 1-4; JPEG bytes decode
whatever the file's suffix, and BMP, TIFF and WebP raise. `imdecode` (the
server's BYTES ingest) gives what cv2.imdecode(buf, IMREAD_UNCHANGED) gives
on all those PNGs, on PNGs with a tRNS chunk and 16-bit ones, and on the JPEG
fixtures (a gray one comes back (H, W), EXIF not applied), and raises
ValueError where cv2 gives 4 channels or 16 bits; `imencode_png`'s bytes
decode to the image. Run as a script, it
prints the reader's time per 640 x 640 image for each filter.
"""

import struct
import time
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.data.imageio import (
    PNG_SIGNATURE,
    _unfilter,
    _unfilter_loop,
    imdecode,
    imencode_png,
    imread,
    imwrite,
)


def _texture(h, w, c, seed):
    """Smooth areas and noise: libpng's adaptive filtering picks several filters on it."""
    rng = np.random.default_rng(seed)
    img = cv2.resize(rng.integers(0, 256, (7, 9, c), dtype=np.uint8), (w, h), interpolation=cv2.INTER_LINEAR)
    img = img.reshape(h, w, c)
    img[h // 3 : h // 2, w // 4 : w // 2] = rng.integers(0, 256, (h // 2 - h // 3, w // 2 - w // 4, c))
    return img


def _filter_row(f, row, prior, bpp):
    """PNG filter `f` applied to one row (RFC 2083 §6), the encoder's side."""
    row, prior = row.astype(np.int32), prior.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
    if f == 0:
        pred = np.zeros_like(row)
    elif f == 1:
        pred = left
    elif f == 2:
        pred = prior
    elif f == 3:
        pred = (left + prior) // 2
    else:
        p = left + prior - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
    return ((row - pred) % 256).astype(np.uint8)


def _chunk(ctype, body):
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def write_png_by_hand(path, samples, color_type, filters, palette=None):
    """samples (H, W, C) uint8 as a PNG of `color_type`, row y filtered with filters[y % len(filters)]."""
    h, w, c = samples.shape
    prior, raw = np.zeros(w * c, np.uint8), b""
    for y in range(h):
        row = samples[y].reshape(-1)
        f = filters[y % len(filters)]
        raw += bytes([f]) + _filter_row(f, row, prior, c).tobytes()
        prior = row
    chunks = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
    if palette is not None:
        chunks += _chunk(b"PLTE", palette.tobytes())
    path.write_bytes(PNG_SIGNATURE + chunks + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def row_filters(path):
    """The filter byte of every row of a PNG."""
    data = path.read_bytes()
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        ctype, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        ihdr = struct.unpack(">IIBBBBB", body) if ctype == b"IHDR" else ihdr
        idat += body if ctype == b"IDAT" else b""
        pos += 12 + n
    w, h, _, ct = ihdr[:4]
    stride = w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ct] + 1
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Every PNG of this file: cv2-written and hand-built."""
    d = tmp_path_factory.mktemp("png")
    files = []
    for name, c in (("gray", 1), ("bgr", 3), ("bgra", 4)):
        for h, w in ((67, 101), (1, 3), (33, 1)):
            img = _texture(h, w, c, seed=h * w + c)
            for level in (0, 9):
                p = d / f"cv2_{name}_{h}x{w}_{level}.png"
                assert cv2.imwrite(str(p), img[..., 0] if c == 1 else img, [cv2.IMWRITE_PNG_COMPRESSION, level])
                files.append(p)
    for ct, c in ((4, 2), (2, 3), (0, 1)):  # gray + alpha, RGB, gray: every filter on every row kind
        p = d / f"hand_ct{ct}.png"
        write_png_by_hand(p, _texture(45, 53, c, seed=ct), ct, filters=[0, 1, 2, 3, 4])
        files.append(p)
    rng = np.random.default_rng(7)
    palette = rng.integers(0, 256, (13, 3), dtype=np.uint8)
    p = d / "hand_palette.png"
    write_png_by_hand(p, rng.integers(0, 13, (29, 31, 1), dtype=np.uint8), 3, filters=[4, 0, 2, 3, 1], palette=palette)
    files.append(p)
    return files


def test_imread_equals_cv2_on_every_png(pngs):
    seen = set()
    for p in pngs:
        ours, ref = imread(p), cv2.imread(str(p))
        assert ref is not None and ours.dtype == np.uint8 and ours.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(ours, ref, err_msg=p.name)
        seen |= row_filters(p)
    assert seen == {0, 1, 2, 3, 4}, f"filters seen: {sorted(seen)}"


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (6, 3, 3), (3, 6, 4), (1, 1, 3)])
def test_imwrite_png_round_trips_through_cv2(tmp_path, shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    p = tmp_path / "x.png"
    imwrite(p, img)
    assert row_filters(p) == {0}
    np.testing.assert_array_equal(cv2.imread(str(p), cv2.IMREAD_UNCHANGED).reshape(shape), img)
    np.testing.assert_array_equal(imread(p), cv2.imread(str(p)))


def _with_trns(data: bytes, trns: bytes) -> bytes:
    """PNG bytes with a tRNS chunk put before the first IDAT."""
    at = data.index(b"IDAT") - 4
    return data[:at] + _chunk(b"tRNS", trns) + data[at:]


def test_imdecode_equals_cv2_unchanged(pngs, tmp_path):
    rng = np.random.default_rng(3)
    blobs = {p.name: p.read_bytes() for p in pngs}
    p = tmp_path / "palette.png"
    write_png_by_hand(p, rng.integers(0, 5, (9, 11, 1), dtype=np.uint8), 3, filters=[0, 1],
                      palette=rng.integers(0, 256, (5, 3), dtype=np.uint8))
    blobs["palette_trns"] = _with_trns(p.read_bytes(), b"\x00\x80")
    p = tmp_path / "rgb.png"
    write_png_by_hand(p, _texture(9, 11, 3, seed=1), 2, filters=[0])
    blobs["rgb_trns"] = _with_trns(p.read_bytes(), b"\x00\x01\x00\x02\x00\x03")
    p = tmp_path / "gray.png"
    write_png_by_hand(p, _texture(9, 11, 1, seed=2), 0, filters=[2])
    blobs["gray_trns"] = _with_trns(p.read_bytes(), b"\x00\x07")
    blobs["gray16"] = cv2.imencode(".png", rng.integers(0, 65536, (5, 7), dtype=np.uint16))[1].tobytes()
    jpeg_dir = Path(__file__).resolve().parent / "torch_data" / "jpeg"
    blobs.update({f.name: f.read_bytes() for f in sorted(jpeg_dir.glob("*.jpg"))})
    refused = set()
    for name, data in blobs.items():
        ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        assert ref is not None, name
        if ref.dtype != np.uint8 or (ref.ndim == 3 and ref.shape[2] == 4):
            with pytest.raises(ValueError, match="16 bits or 4 channels"):
                imdecode(data)
            refused.add(name)
        else:
            np.testing.assert_array_equal(imdecode(data), ref, err_msg=name)
    assert {"palette_trns", "rgb_trns", "gray16", "hand_ct4.png"} <= refused and "gray_trns" not in refused
    assert imdecode(blobs["gray.jpg"]).ndim == 2 and imdecode(blobs["exif6.jpg"]).shape != imread(jpeg_dir / "exif6.jpg").shape


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (6, 3, 3), (3, 6, 4), (1, 1, 3)])
def test_imencode_png_decodes_to_the_image(shape):
    img = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    data = imencode_png(img)
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED).reshape(shape), img)
    if len(shape) == 2 or shape[2] != 4:
        np.testing.assert_array_equal(imdecode(data).reshape(shape), img)


def test_other_formats_and_broken_files_raise(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    for suffix in (".bmp", ".tiff", ".webp"):
        p = tmp_path / f"x{suffix}"
        cv2.imwrite(str(p), img)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            imread(p)
    for suffix in (".jpg", ".jpeg"):  # JPEG decodes (data/jpeg.py; tests/test_torch_jpeg.py), whatever the suffix
        p = tmp_path / f"x{suffix}"
        cv2.imwrite(str(p), img)
        ref = cv2.imread(str(p))
        np.testing.assert_array_equal(imread(p), ref)
        p.rename(tmp_path / "jpeg_bytes.png")
        np.testing.assert_array_equal(imread(tmp_path / "jpeg_bytes.png"), ref)
        (tmp_path / "jpeg_bytes.png").unlink()
    with pytest.raises(NotImplementedError, match="ROADMAP"):  # JPEG and PNG are written (test_torch_jpeg_encode.py)
        imwrite(tmp_path / "x.bmp", img)
    cv2.imwrite(str(tmp_path / "deep.png"), np.zeros((4, 4), np.uint16))
    with pytest.raises(NotImplementedError, match="bit depth 16"):
        imread(tmp_path / "deep.png")
    with pytest.raises(FileNotFoundError):
        imread(tmp_path / "missing.png")
    good = tmp_path / "good.png"
    imwrite(good, img)
    data = bytearray(good.read_bytes())
    data[-20] ^= 0xFF  # inside the IDAT chunk: its CRC no longer holds
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        imread(tmp_path / "bad.png")


def _unfilter_plain(raw: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    """Every row undone byte by byte in Python (RFC 2083 §6): _unfilter_loop for
    Average and Paeth, the three others written out here."""
    stride = width * bpp
    lines = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out, prior = np.empty((height, stride), np.uint8), np.zeros(stride, np.uint8)
    for y in range(height):
        f, row = int(lines[y, 0]), lines[y, 1:]
        if f >= 3:
            out[y] = _unfilter_loop(f, row, prior, bpp)
        else:
            for i in range(stride):
                pred = (0, out[y, i - bpp] if i >= bpp else 0, prior[i])[f]
                out[y, i] = (int(row[i]) + int(pred)) & 0xFF
        prior = out[y]
    return out


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_row_filters_equal_the_python_loop(bpp):
    """The host library's Average and Paeth rows (csrc/png_unfilter.cpp), inside
    _unfilter, against the plain Python loop: seeded rows of all five filter
    types, every type on every row position of the cycle, with rows of wide
    byte values so the sums wrap."""
    rng = np.random.default_rng(bpp)
    height, width = 25, 37
    filters = np.arange(height) % 5
    rng.shuffle(filters)
    rows = rng.integers(0, 256, (height, width * bpp), dtype=np.uint8)
    raw = np.concatenate([filters[:, None].astype(np.uint8), rows], axis=1).tobytes()
    np.testing.assert_array_equal(_unfilter(raw, height, width, bpp, "seeded"),
                                  _unfilter_plain(raw, height, width, bpp))


if __name__ == "__main__":  # the reader's time per 640 x 640 image, by filter
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        for c, ct in ((1, 0), (3, 2)):
            for f in range(5):
                p = Path(tmp) / f"f{f}.png"
                write_png_by_hand(p, _texture(640, 640, c, seed=f), ct, filters=[f])
                t0 = time.perf_counter()
                imread(p)
                print(f"{c} channel(s), filter {f}: {(time.perf_counter() - t0) * 1e3:.1f} ms per 640 x 640 image")
