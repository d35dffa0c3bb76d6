"""The port's JPEG decoder equals cv2.imread, byte for byte.

`data/jpeg.py:decode_jpeg` (markers in Python, the entropy decode, IDCT,
upsampling and colour conversion in the host library's csrc/jpeg_decode.cpp)
and `data/imageio.py:imread` must give what cv2.imread(path) gives
(IMREAD_COLOR: BGR uint8, libjpeg-turbo) on

- the committed fixtures in tests/torch_data/jpeg/: the 8 val frames the JAX
  package's generator writes for Spectrogram.yaml (gray spectrograms saved
  as 3-channel 4:2:0 JPEG at cv2's default quality 95, and their labels),
  the first 640 px val frame of its spectrogram_synth.yaml, and
  one small cv2 encode per decoder branch (samplings 4:4:4, 4:2:2, 4:4:0,
  4:1:1, gray, a restart interval, cv2's optimised Huffman tables, quality
  100, sizes 1 x 1, 17 x 33 and 641 x 359, an EXIF orientation), each held to
  the SHA-256 of cv2's decode recorded in cv2_decoded.json and to cv2 live;
- frames the JAX generator writes into a temporary directory;
- a seeded matrix of cv2 encodes: quality 50, 75, 95 and 100 by the five
  samplings at several sizes, gray, restart intervals 1 and 7, optimised
  tables, EXIF orientations 1-8 (both byte orders) injected as APP1 bytes,
  and a file whose Huffman tables were stripped (libjpeg's default tables);
- truncated files and files with corrupt entropy-coded bytes: cv2's image,
  or ValueError where cv2.imread returns None;
- files of several scans (non-interleaved and partly interleaved), which
  cv2 does not write: the test writes them from seeded coefficients.

Progressive, arithmetic-coded, lossless, 12-bit and 4-component files raise
NotImplementedError. Run as a script, the file rewrites the fixtures and the
digests (`PYTHONPATH=. python tests/test_torch_jpeg.py`), then prints the
decode time per frame beside cv2.imread's (CPU readings).
"""

import hashlib
import json
import struct
import time
from pathlib import Path

import cv2
import numpy as np
import pytest
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.data.imageio import imread
from spectrogram_yolov11_torch.data.jpeg import decode_jpeg

FIXTURES = Path(__file__).resolve().parent / "torch_data" / "jpeg"
DIGESTS = FIXTURES / "cv2_decoded.json"
SAMPLINGS = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111, "411": 0x411111}
Q, SF = cv2.IMWRITE_JPEG_QUALITY, cv2.IMWRITE_JPEG_SAMPLING_FACTOR
# name -> (height, width, channels, cv2.imwrite parameters, EXIF orientation to inject or 0)
SMALL = {
    "s444.jpg": (48, 40, 3, [Q, 90, SF, SAMPLINGS["444"]], 0),
    "s422.jpg": (48, 40, 3, [Q, 90, SF, SAMPLINGS["422"]], 0),
    "s440.jpg": (48, 40, 3, [Q, 90, SF, SAMPLINGS["440"]], 0),
    "s411.jpg": (48, 40, 3, [Q, 90, SF, SAMPLINGS["411"]], 0),
    "gray.jpg": (48, 40, 1, [Q, 90], 0),
    "rst5.jpg": (64, 72, 3, [Q, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 5], 0),
    "optimize.jpg": (64, 72, 3, [Q, 90, cv2.IMWRITE_JPEG_OPTIMIZE, 1], 0),
    "q100.jpg": (40, 56, 3, [Q, 100], 0),
    "1x1.jpg": (1, 1, 3, [Q, 95], 0),
    "17x33.jpg": (17, 33, 3, [Q, 95], 0),
    "641x359.jpg": (359, 641, 3, [Q, 75], 0),
    "exif6.jpg": (30, 50, 3, [Q, 90], 6),
}


def texture(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Smooth colour fields with noise: every frequency and chroma offset occurs."""
    rng = np.random.default_rng(seed)
    img = cv2.resize(rng.integers(0, 256, (7, 9, c), dtype=np.uint8), (w, h), interpolation=cv2.INTER_CUBIC)
    return np.clip(img.reshape(h, w, c).astype(np.int32) + rng.integers(-24, 25, (h, w, c)), 0, 255).astype(np.uint8)


def encode(img: np.ndarray, params: list) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def with_exif(jpeg: bytes, orientation: int, order: str = "II") -> bytes:
    """The JPEG with an APP1 EXIF segment after SOI whose IFD0 holds one orientation tag."""
    e = "<" if order == "II" else ">"
    tiff = (order.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHI", 0x0112, 3, 1) + struct.pack(e + "HH", orientation, 0) + struct.pack(e + "I", 0))
    body = b"Exif\0\0" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpeg[2:]


def segments(jpeg: bytes):
    """(marker, start, end) of each marker segment before the first SOS (SOS included)."""
    pos = 2
    while True:
        m, (n,) = jpeg[pos + 1], struct.unpack(">H", jpeg[pos + 2 : pos + 4])
        yield m, pos, pos + 2 + n
        if m == 0xDA:
            return
        pos += 2 + n


def sha(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def assert_as_cv2(path: Path):
    """imread(path) and decode_jpeg(bytes) equal cv2.imread(path); ValueError
    from both where cv2 returns None."""
    ref = cv2.imread(str(path))
    if ref is None:
        with pytest.raises(ValueError):
            decode_jpeg(path.read_bytes())
        with pytest.raises(ValueError):
            imread(path)
        return
    got = decode_jpeg(path.read_bytes())
    assert got.dtype == np.uint8 and got.shape == ref.shape, (got.shape, ref.shape)
    diff = int((got != ref).sum())
    assert diff == 0, f"{path.name}: {diff} samples differ from cv2.imread"
    np.testing.assert_array_equal(imread(path), ref)


def recorded() -> dict:
    """name -> {shape, sha256} of cv2's decode of each fixture (empty while make_fixtures rewrites them)."""
    return json.loads(DIGESTS.read_text())["files"] if DIGESTS.exists() else {}


def test_fixture_digests_are_cv2s():
    """Every committed JPEG is listed, and cv2 live still gives the recorded shape and digest."""
    rec = recorded()
    files = sorted(str(p.relative_to(FIXTURES)) for p in FIXTURES.rglob("*.jpg"))
    assert files == sorted(rec) and len(files) == 8 + 1 + len(SMALL)
    for name, d in rec.items():
        ref = cv2.imread(str(FIXTURES / name))
        assert list(ref.shape) == d["shape"] and sha(ref) == d["sha256"], name


@pytest.mark.parametrize("name", sorted(recorded()))
def test_fixture_decodes_to_the_recorded_digest(name):
    d = recorded()[name]
    got = imread(FIXTURES / name)
    assert list(got.shape) == d["shape"] and sha(got) == d["sha256"]
    assert_as_cv2(FIXTURES / name)


def test_jax_generator_frames(tmp_path):
    """Frames the JAX package's generator writes (cv2.imwrite of its 3-channel spectrograms)."""
    from spectrogram_yolov11_tpu.data.synth import _gen_spectrogram

    _gen_spectrogram(tmp_path, "val", 3, 640, 7)
    _gen_spectrogram(tmp_path, "small", 2, 96, 8)
    files = sorted(tmp_path.rglob("*.jpg"))
    assert len(files) == 5
    for f in files:
        assert_as_cv2(f)


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_encode_matrix(tmp_path, quality, sampling):
    """Each sampling at each quality over sizes that cut MCUs at every edge."""
    for k, (h, w) in enumerate(((1, 1), (2, 7), (3, 5), (17, 33), (64, 48), (33, 130), (359, 641))):
        p = tmp_path / f"{h}x{w}.jpg"
        p.write_bytes(encode(texture(h, w, 3, seed=quality + k), [Q, quality, SF, SAMPLINGS[sampling]]))
        assert_as_cv2(p)


def test_gray_restarts_and_optimized_tables(tmp_path):
    img = texture(97, 131, 3, seed=5)
    cases = {f"gray_q{q}_{h}x{w}": encode(texture(h, w, 1, seed=q)[..., 0], [Q, q])
             for q in (50, 100) for h, w in ((1, 1), (17, 33), (120, 77))}
    for ri in (1, 7):
        for s in ("444", "420", "411"):
            cases[f"rst{ri}_{s}"] = encode(img, [cv2.IMWRITE_JPEG_RST_INTERVAL, ri, SF, SAMPLINGS[s]])
        cases[f"rst{ri}_gray"] = encode(img[..., 0], [cv2.IMWRITE_JPEG_RST_INTERVAL, ri])
    for s in ("444", "422", "440"):
        cases[f"optimize_{s}"] = encode(img, [cv2.IMWRITE_JPEG_OPTIMIZE, 1, SF, SAMPLINGS[s]])
    cases["optimize_gray"] = encode(img[..., 0], [cv2.IMWRITE_JPEG_OPTIMIZE, 1])
    # cv2 writes the standard tables unless it optimises; with them stripped, libjpeg installs them itself
    full = encode(img, [Q, 80])
    cases["no_dht"] = full[:2] + b"".join(full[a:b] for m, a, b in segments(full) if m != 0xC4) + full[
        max(b for _, _, b in segments(full)):]
    assert cases["no_dht"].count(b"\xff\xc4") == 0
    for name, data in cases.items():
        p = tmp_path / f"{name}.jpg"
        p.write_bytes(data)
        assert_as_cv2(p)


@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation(tmp_path, orientation):
    """Orientations 2-8 transpose and flip as cv2's IMREAD_COLOR does; 0, 1 and 9 leave the frame."""
    base = encode(texture(30, 50, 3, seed=1), [Q, 90])
    for order in ("II", "MM"):
        p = tmp_path / f"o{orientation}{order}.jpg"
        p.write_bytes(with_exif(base, orientation, order))
        assert_as_cv2(p)
    assert imread(p).shape == ((50, 30, 3) if 5 <= orientation <= 8 else (30, 50, 3))


def test_truncated_and_corrupt_files(tmp_path):
    """Seeded cuts and byte corruptions of the entropy-coded data, with and
    without restart markers: cv2's image (zero bits, then gray, where data
    run out; the resync rules where a restart marker is lost; the SIMD IDCT's
    saturation where a coefficient leaves 16 bits), or ValueError where cv2
    gives None (cuts inside the headers)."""
    rng = np.random.default_rng(0)
    img = texture(120, 160, 3, seed=9)
    for params in ([Q, 95], [Q, 95, cv2.IMWRITE_JPEG_RST_INTERVAL, 3]):
        full = encode(img, params)
        sos_end = max(b for _, _, b in segments(full))
        cuts = [*range(0, sos_end + 4, 41), *rng.integers(sos_end, len(full), 16).tolist()]
        for i, cut in enumerate(cuts):
            p = tmp_path / f"cut{i}.jpg"
            p.write_bytes(full[:cut])
            assert_as_cv2(p)
        for i in range(24):
            data = bytearray(full)
            for at in rng.integers(sos_end, len(full) - 2, 1 + i % 4):
                data[int(at)] = int(rng.integers(0, 256))
            p = tmp_path / f"corrupt{i}.jpg"
            p.write_bytes(bytes(data))
            assert_as_cv2(p)
    with pytest.raises(ValueError):
        decode_jpeg(b"\xff\xd8\xff\xd9")


# ITU T.81 Annex K.3's tables (DC luminance, AC luminance), the ones cv2 writes unless it optimises
STD_DC = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
STD_AC = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], list(bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a34"
    "35363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a9293949596"
    "9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1"
    "f2f3f4f5f6f7f8f9fa")))
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7,
          14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
          53, 60, 61, 54, 47, 55, 62, 63]


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def sequential_jpeg(coefs: list, sampling: list, height: int, width: int, scans: list, restart: int = 0) -> bytes:
    """A baseline JPEG written here from quantised coefficients: coefs[c] is
    component c's (rows, cols, 64) block grid in natural order (its whole MCU
    grid), sampling[c] its (h, v); `scans` lists the components of each scan
    (one component: its own block grid; several: interleaved MCUs). One
    quantisation table of 2s, the standard Huffman tables, a restart interval
    of `restart` MCUs. cv2 writes one interleaved scan only, so this is how a
    file of several scans reaches the decoder."""
    codes = []
    for bits, vals in (STD_DC, STD_AC):
        table, code, k = {}, 0, 0
        for n in range(1, 17):
            for _ in range(bits[n - 1]):
                table[vals[k]] = (code, n)
                code, k = code + 1, k + 1
            code <<= 1
        codes.append(table)
    mh, mv = max(h for h, _ in sampling), max(v for _, v in sampling)
    out = b"\xff\xd8" + _segment(0xDB, bytes([0]) + bytes([2] * 64))
    out += _segment(0xC0, struct.pack(">BHHB", 8, height, width, len(coefs)) + b"".join(
        bytes([c + 1, (h << 4) | v, 0]) for c, (h, v) in enumerate(sampling)))
    for cls, (bits, vals) in enumerate((STD_DC, STD_AC)):
        out += _segment(0xC4, bytes([cls << 4]) + bytes(bits) + bytes(vals))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    for comps in scans:
        bitstr, pred = [], {c: 0 for c in comps}

        def put(code_len, value=None, size=0):
            code, n = code_len
            bitstr.append(format(code, f"0{n}b"))
            if size:
                bitstr.append(format(value if value > 0 else value + (1 << size) - 1, f"0{size}b"))

        def block(c, blk):
            diff = int(blk[0]) - pred[c]
            pred[c] = int(blk[0])
            size = abs(diff).bit_length()
            put(codes[0][size], diff, size)
            run = 0
            zz = [int(blk[i]) for i in ZIGZAG]
            last = max((i for i in range(1, 64) if zz[i]), default=0)
            for i in range(1, last + 1):
                if zz[i] == 0:
                    run += 1
                    continue
                while run > 15:
                    put(codes[1][0xF0])
                    run -= 16
                size = abs(zz[i]).bit_length()
                put(codes[1][(run << 4) | size], zz[i], size)
                run = 0
            if last < 63:
                put(codes[1][0x00])

        if len(comps) == 1:
            c = comps[0]
            h, v = sampling[c]
            rows, cols = -(-height * v // (8 * mv)), -(-width * h // (8 * mh))
            units = [[(c, y, x)] for y in range(rows) for x in range(cols)]
        else:
            rows, cols = -(-height // (8 * mv)), -(-width // (8 * mh))
            units = [[(c, my * sampling[c][1] + by, mx * sampling[c][0] + bx) for c in comps
                      for by in range(sampling[c][1]) for bx in range(sampling[c][0])]
                     for my in range(rows) for mx in range(cols)]
        data = b""
        for i, unit in enumerate(units):
            if restart and i and i % restart == 0:  # byte-align with 1s, then RSTn; the predictors restart
                bits = "".join(bitstr)
                bits += "1" * (-len(bits) % 8)
                data += bytes(int(bits[k : k + 8], 2) for k in range(0, len(bits), 8)).replace(b"\xff", b"\xff\x00")
                data += bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
                bitstr, pred = [], {c: 0 for c in comps}
            for c, y, x in unit:
                block(c, coefs[c][y, x])
        bits = "".join(bitstr)
        bits += "1" * (-len(bits) % 8)
        data += bytes(int(bits[k : k + 8], 2) for k in range(0, len(bits), 8)).replace(b"\xff", b"\xff\x00")
        sos = bytes([len(comps)]) + b"".join(bytes([c + 1, 0x00]) for c in comps) + bytes([0, 63, 0])
        out += _segment(0xDA, sos) + data
    return out + b"\xff\xd9"


@pytest.mark.parametrize("scans", [[[0], [1], [2]], [[0], [1, 2]], [[2], [0], [1]]], ids=["3-scans", "Y-then-CbCr", "Cr-first"])
@pytest.mark.parametrize("restart", [0, 5])
def test_multi_scan_files(tmp_path, scans, restart):
    """Sequential files of several scans (one or two components each), with
    and without restart intervals: the whole-frame coefficient buffers, the
    non-interleaved block grids and the partial interleave, against cv2."""
    rng = np.random.default_rng(len(scans) * 10 + restart)
    height, width, sampling = 37, 45, [(2, 2), (1, 1), (1, 1)]
    coefs = []
    for h, v in sampling:
        grid = np.zeros((-(-height // 16) * v, -(-width // 16) * h, 64), np.int16)
        grid[..., 0] = rng.integers(-60, 60, grid.shape[:2])
        for k in (1, 8, 9, 2, 16):
            grid[..., k] = rng.integers(-20, 21, grid.shape[:2]) * (rng.random(grid.shape[:2]) < 0.6)
        coefs.append(grid)
    p = tmp_path / "multi.jpg"
    p.write_bytes(sequential_jpeg(coefs, sampling, height, width, scans, restart))
    assert cv2.imread(str(p)) is not None
    assert_as_cv2(p)


def _patched_sof(jpeg: bytes, marker: int = None, precision: int = None, ncomp: int = None) -> bytes:
    m, a, b = next(s for s in segments(jpeg) if s[0] in (0xC0, 0xC1))
    sof = bytearray(jpeg[a:b])
    if marker is not None:
        sof[1] = marker
    if precision is not None:
        sof[4] = precision
    if ncomp is not None:  # the first component repeated under new ids
        comps = b"".join(bytes([i + 1]) + sof[11:13] for i in range(ncomp))
        sof = sof[:9] + bytes([ncomp]) + comps
        sof[2:4] = struct.pack(">H", len(sof) - 2)
    return jpeg[:a] + bytes(sof) + jpeg[b:]


def test_what_is_not_ported_raises():
    img = texture(24, 32, 3, seed=2)
    with pytest.raises(NotImplementedError, match="progressive.*ROADMAP"):
        decode_jpeg(encode(img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]))
    base = encode(img, [Q, 90])
    for marker, what in ((0xC3, "lossless"), (0xC9, "arithmetic"), (0xCA, "arithmetic"), (0xCB, "arithmetic")):
        with pytest.raises(NotImplementedError, match=what):
            decode_jpeg(_patched_sof(base, marker=marker))
    with pytest.raises(NotImplementedError, match="12-bit"):
        decode_jpeg(_patched_sof(base, marker=0xC1, precision=12))
    gray = encode(img[..., 0], [Q, 90])
    with pytest.raises(NotImplementedError, match="CMYK"):
        decode_jpeg(_patched_sof(gray, ncomp=4))
    # what libjpeg refuses: a hierarchical SOF, 2 components, 7-bit samples, no SOI
    for bad in (_patched_sof(base, marker=0xC5), _patched_sof(gray, ncomp=2), _patched_sof(base, precision=7),
                base[2:]):
        with pytest.raises(ValueError):
            decode_jpeg(bad)


def test_host_library_registry_and_a_missing_compiler(monkeypatch):
    """The host libraries (the decoder's, the encoder's and the augmentation's
    warps) sit in a registry of their own beside the two CUDA kernels, and without c++ or g++ on PATH
    a build raises, naming them, before any compiler starts; nothing falls
    back."""
    from spectrogram_yolov11_torch.utils import kernels

    assert set(kernels.KERNELS) == {"greedy_nms", "fused_bottleneck"}
    assert set(kernels.HOST_LIBS) == {"image_decode", "image_encode", "image_warp"}
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    for name in kernels.HOST_LIBS:
        with pytest.raises(RuntimeError, match=r"c\+\+ or g\+\+"):
            kernels.build_all([name], force=True)


def make_fixtures() -> None:
    """Rewrite tests/torch_data/jpeg/: the JAX generator's Spectrogram.yaml val
    split (8 frames at 320 px, seed 10000, and labels), the first val frame of
    its spectrogram_synth.yaml (640 px, seed 10000) and the SMALL encodes,
    with cv2_decoded.json."""
    import shutil

    from spectrogram_yolov11_tpu.data.synth import _gen_spectrogram
    from spectrogram_yolov11_tpu.utils import yaml_load

    cfg = yaml_load(Path(__file__).resolve().parents[1] / "spectrogram_yolov11_tpu/cfg/datasets/Spectrogram.yaml")
    shutil.rmtree(FIXTURES, ignore_errors=True)
    _gen_spectrogram(FIXTURES / "spectrogram", "val", int(cfg["n_val"]), int(cfg["gen_imgsz"]),
                     int(cfg.get("seed", 0)) + 10_000)
    _gen_spectrogram(FIXTURES / "spectrogram_synth", "val", 1, 640, 10_000)
    for i, (name, (h, w, c, params, orientation)) in enumerate(SMALL.items()):
        img = texture(h, w, c, seed=i)
        data = encode(img[..., 0] if c == 1 else img, params)
        (FIXTURES / name).write_bytes(with_exif(data, orientation) if orientation else data)
    files = {}
    for p in sorted(FIXTURES.rglob("*.jpg")):
        ref = cv2.imread(str(p))
        files[str(p.relative_to(FIXTURES))] = {"shape": list(ref.shape), "sha256": sha(ref)}
    made = (f"PYTHONPATH=. python tests/test_torch_jpeg.py (make_fixtures): spectrogram/ by the JAX package's "
            f"data/synth.py:_gen_spectrogram at the val settings of Spectrogram.yaml (spectrogram/) and "
            f"spectrogram_synth.yaml (its first frame), the rest by cv2.imencode; "
            f"sha256 of cv2.imread(path) (IMREAD_COLOR), cv2 {cv2.__version__}")
    rows = ",\n".join(f"  {json.dumps(k)}: {json.dumps(v)}" for k, v in files.items())
    DIGESTS.write_text(f'{{\n "made": {json.dumps(made)},\n "files": {{\n{rows}\n }}\n}}\n')


if __name__ == "__main__":
    make_fixtures()
    for name in ("spectrogram/images/val/00000.jpg", "spectrogram_synth/images/val/00000.jpg", "641x359.jpg"):
        p, n = FIXTURES / name, 50
        decode_jpeg(p.read_bytes())
        t0 = time.perf_counter()
        for _ in range(n):
            imread(p)
        t1 = time.perf_counter()
        for _ in range(n):
            cv2.imread(str(p))
        t2 = time.perf_counter()
        print(f"{name}: imread {(t1 - t0) / n * 1e3:.2f} ms, cv2.imread {(t2 - t1) / n * 1e3:.2f} ms (CPU readings)")
