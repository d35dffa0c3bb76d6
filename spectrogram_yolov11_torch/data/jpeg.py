"""Baseline JPEG on the host: decoding as cv2.imread(path, IMREAD_COLOR)
decodes, and encoding to the bytes cv2.imencode(".jpg", img) writes.

The JAX package writes its image datasets with cv2.imwrite(... .jpg) and reads
them with cv2.imread (libjpeg-turbo); the port has neither cv2 nor PIL. Here
the markers are parsed and checked, in libjpeg's order and with its checks,
and the host library's C body (csrc/jpeg_decode.cpp, built with the host C++
compiler at first use by utils/kernels.py) decodes each scan and rebuilds the
frame: Huffman decode, dequantisation, libjpeg's ISLOW integer IDCT, "fancy"
chroma upsampling, YCbCr -> BGR in fixed point. EXIF orientations 2-8 (APP1)
are applied as cv2's IMREAD_COLOR applies them.

Taken: SOF0 and SOF1 (8-bit Huffman sequential), one interleaved scan or
several, restart intervals, 8- and 16-bit DQT, any integral sampling factors
(4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, gray), JFIF / Adobe / component-id colour
spaces (YCbCr or RGB), and data that end early (zero bits, then gray blocks, as
libjpeg). Progressive (SOF2), lossless (SOF3), arithmetic coding (SOF9-11),
12-bit samples and 4-component CMYK/YCCK raise NotImplementedError
(ROADMAP.md §1 item 5); input that libjpeg refuses, for which cv2.imread
returns None, raises ValueError.

`encode_jpeg(img, quality)` writes what cv2.imencode(".jpg", img,
[IMWRITE_JPEG_QUALITY, quality]) writes with its other parameters at their
defaults, byte for byte: a JFIF 1.01 APP0 (no units, density 1:1), one DQT
per table, SOF0 (4:2:0 for a colour frame, one component for a gray one),
the four standard Huffman tables of ITU T.81 Annex K.3 (two for gray) each
in a DHT of its own, one interleaved scan and EOI. The quantisation tables
are Annex K.1's scaled as libjpeg's jpeg_set_quality(quality, TRUE) scales
them; the scan is the host library's csrc/jpeg_encode.cpp (libjpeg-turbo's
integer arithmetic: fixed-point YCbCr, h2v2 downsampling, the ISLOW forward
DCT, its reciprocal quantisation, dummy blocks at the edge of the MCU grid).
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils import kernels

_NOT_PORTED = "queued in ROADMAP.md §1 item 5 (image decode); the port decodes 8-bit Huffman sequential JPEG"
_SOF_NOT_PORTED = {0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)", 0xC9: "arithmetic-coded (SOF9)",
                   0xCA: "arithmetic-coded progressive (SOF10)", 0xCB: "arithmetic-coded lossless (SOF11)"}
_SOF_REFUSED = {0xC5, 0xC6, 0xC7, 0xC8, 0xCD, 0xCE, 0xCF}  # hierarchical and JPG: libjpeg refuses them
_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
                    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
                    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])  # zigzag index -> natural index


def _std_table(bits: str, vals: str) -> np.ndarray:
    t = np.zeros(273, np.uint8)
    t[0] = 1
    t[1:17] = np.frombuffer(bytes.fromhex(bits), np.uint8)
    v = bytes.fromhex(vals)
    t[17 : 17 + len(v)] = np.frombuffer(v, np.uint8)
    return t


# ITU T.81 Annex K.3's tables, which libjpeg-turbo installs in DC and AC slots 0
# and 1 when a file defines none there before its first scan (Motion-JPEG)
_STD_TABLES = {
    0: _std_table("00010501010101010100000000000000", "000102030405060708090a0b"),
    1: _std_table("00030101010101010101010000000000", "000102030405060708090a0b"),
    4: _std_table("0002010303020403050504040000017d",
                  "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25"
                  "262728292a3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a8384"
                  "85868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5"
                  "d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    5: _std_table("00020102040403040705040400010277",
                  "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718"
                  "191a262728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82"
                  "838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3"
                  "d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}


class _Source:
    """The file's bytes as libjpeg's stdio source gives them: past the end, a
    fake EOI marker (FF D9) again and again."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def byte(self) -> int:
        p = self.pos
        self.pos += 1
        return self.data[p] if p < len(self.data) else (0xD9 if (p - len(self.data)) & 1 else 0xFF)

    def u16(self) -> int:
        return (self.byte() << 8) | self.byte()

    def take(self, n: int) -> bytes:
        """n bytes, the fake EOI bytes standing in past the end."""
        if n <= 0:
            return b""
        end = self.pos + n
        if end <= len(self.data):
            out = self.data[self.pos : end]
            self.pos = end
            return out
        return bytes(self.byte() for _ in range(n))

    def next_marker(self) -> int:
        """jdmarker.c next_marker: skip to the next marker and return its code."""
        while True:
            c = self.byte()
            while c != 0xFF:
                c = self.byte()
            while c == 0xFF:
                c = self.byte()
            if c != 0:
                return c


class _Frame:
    """SOF's frame header, and from the first scan on (_setup) its colour
    space and coefficient buffers."""

    def __init__(self, height: int, width: int, comps: list):
        self.height, self.width = height, width
        self.ids = [c[0] for c in comps]
        self.h = [c[1] >> 4 for c in comps]
        self.v = [c[1] & 15 for c in comps]
        self.tq = [c[2] for c in comps]
        self.color = self.coefs = self.coef_off = self.strides = None


def _refuse(what: str) -> ValueError:
    return ValueError(f"not a JPEG that libjpeg decodes: {what}")


def _exif_orientation(app1: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 in the first APP1 segment, read as
    cv2 reads it (the TIFF header 6 bytes in, the value's 16 bits read
    whatever the tag's type); 0 where there is none or the EXIF is malformed."""
    tiff = app1[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 0
    e = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack(e + "H", tiff[2:4])[0] != 0x2A:
        return 0
    (ifd,) = struct.unpack(e + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 0
    (n,) = struct.unpack(e + "H", tiff[ifd : ifd + 2])
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(tiff):
            return 0
        if struct.unpack(e + "H", tiff[at : at + 2])[0] == 0x0112:
            return struct.unpack(e + "H", tiff[at + 8 : at + 10])[0]
    return 0


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientations 2-8 as cv2 applies them after decoding (1 and any other value: as decoded)."""
    if orientation >= 5 and orientation <= 8:
        img = img.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    return np.ascontiguousarray(np.flip(img, flip) if flip else img)


def decode_jpeg(data: bytes, color: bool = True) -> np.ndarray:
    """A baseline or extended-sequential Huffman JPEG -> (H, W, 3) uint8 BGR,
    as cv2.imread decodes it. color=False decodes as cv2's IMREAD_UNCHANGED:
    a one-component (gray) frame comes back (H, W), and the EXIF orientation
    is not applied."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise _refuse("no SOI marker")
    src = _Source(data)
    src.pos = 2  # after SOI
    lib = kernels.load("image_decode")
    qt = [None] * 4
    tables = np.zeros((8, 273), np.uint8)  # DC slots 0-3, AC slots 4-7
    restart, jfif, adobe, app1 = 0, False, None, None
    frame, latched = None, None
    first_scan, multi_scan = True, False
    while True:
        m = src.next_marker()
        if m == 0xD9:  # EOI (or the end of the file)
            if frame is None or first_scan:
                raise _refuse("no image before EOI")
            break
        if m == 0xD8:
            raise _refuse("a second SOI")
        if m in _SOF_NOT_PORTED:
            raise NotImplementedError(f"{_SOF_NOT_PORTED[m]} JPEG is not decoded: {_NOT_PORTED}")
        if m in _SOF_REFUSED:
            raise _refuse(f"SOF marker 0x{m:02X}")
        if 0xD0 <= m <= 0xD7 or m == 0x01:  # RSTn and TEM outside a scan: ignored, as libjpeg does
            continue
        length = src.u16()
        if m in (0xC0, 0xC1):
            if frame is not None:
                raise _refuse("a second SOF")
            precision, height, width, nc = src.byte(), src.u16(), src.u16(), src.byte()
            if height == 0 or width == 0 or nc == 0:
                raise _refuse(f"empty image {width} x {height} x {nc}")
            if length != 8 + 3 * nc:
                raise _refuse("bad SOF length")
            if precision == 12:
                raise NotImplementedError(f"12-bit JPEG samples are not decoded: {_NOT_PORTED}")
            if precision != 8:
                raise _refuse(f"{precision}-bit samples")
            body = src.take(3 * nc)
            frame = _Frame(height, width, [tuple(body[3 * i : 3 * i + 3]) for i in range(nc)])
        elif m == 0xC4:  # DHT
            body, pos = src.take(length - 2), 0
            while len(body) - pos > 16:
                index, bits = body[pos], np.frombuffer(body[pos + 1 : pos + 17], np.uint8)
                count = int(bits.sum(dtype=np.int64))
                pos += 17
                if count > 256 or count > len(body) - pos:
                    raise _refuse("bad Huffman table")
                slot = (index & 0x0F) + 4 if index & 0x10 else index
                if (index & ~0x10) >= 4:
                    raise _refuse(f"Huffman table index 0x{index:02X}")
                tables[slot] = 0
                tables[slot, 0], tables[slot, 1:17] = 1, bits
                tables[slot, 17 : 17 + count] = np.frombuffer(body[pos : pos + count], np.uint8)
                pos += count
            if pos != len(body):
                raise _refuse("bad DHT length")
        elif m == 0xDB:  # DQT
            body, pos = src.take(length - 2), 0
            while pos < len(body):
                pq, tq = body[pos] >> 4, body[pos] & 15
                pos += 1
                if tq >= 4:
                    raise _refuse(f"quantisation table index {tq}")
                left = len(body) - pos
                count = min(64, left // 2 if pq else left)
                q = np.ones(64, np.uint16)
                vals = np.frombuffer(body[pos : pos + count * (2 if pq else 1)], ">u2" if pq else np.uint8)
                q[_ZIGZAG[:count]] = vals
                qt[tq] = q
                pos += count * (2 if pq else 1)
            if pos != len(body):
                raise _refuse("bad DQT length")
        elif m == 0xDD:  # DRI
            if length != 4:
                raise _refuse("bad DRI length")
            restart = src.u16()
        elif m == 0xDA:  # SOS
            if frame is None:
                raise _refuse("SOS before SOF")
            n = src.byte()
            if length != 6 + 2 * n or n < 1 or n > 4:
                raise _refuse("bad SOS length")
            picked: list = [None] * 4
            scan = []
            for i in range(n):
                cid, sel = src.byte(), src.byte()
                ci = next((k for k in range(min(len(frame.ids), 4)) if frame.ids[k] == cid and picked[k] is None), None)
                if ci is None:
                    raise _refuse(f"scan component id {cid}")
                picked[i] = ci
                scan.append((ci, sel >> 4, sel & 15))
            src.take(3)  # Ss, Se, Ah/Al: ignored by libjpeg's sequential decoder
            if first_scan:
                _setup(frame, jfif, adobe)
                multi_scan = n < len(frame.ids)
                latched = [None] * len(frame.ids)
                for slot, t in _STD_TABLES.items():
                    if not tables[slot, 0]:
                        tables[slot] = t
            for ci, _, _ in scan:
                if latched[ci] is None:
                    tq = frame.tq[ci]
                    if tq >= 4 or qt[tq] is None:
                        raise _refuse(f"quantisation table {tq} is not defined")
                    latched[ci] = qt[tq].copy()
            src.pos = _scan(lib, data, src.pos, frame, scan, tables, restart)
            first_scan = False
            if not multi_scan:
                break
        elif 0xE0 <= m <= 0xEF or m == 0xFE or m == 0xDC or m == 0xCC:  # APPn, COM, DNL, DAC
            body = src.take(length - 2)
            if m == 0xE0 and len(body) >= 14 and body[:5] == b"JFIF\0":
                jfif = True
            elif m == 0xEE and len(body) >= 12 and body[:5] == b"Adobe":
                adobe = body[11]
            elif m == 0xE1 and app1 is None and first_scan:  # cv2 reads the first APP1 before the first scan
                app1 = body
        else:
            raise _refuse(f"unknown marker 0x{m:02X}")
    img = _render(lib, frame, latched)
    if not color:  # the render repeats a gray frame over the three channels
        return np.ascontiguousarray(img[..., 0]) if len(frame.ids) == 1 else img
    orientation = _exif_orientation(app1) if app1 is not None else 0
    return apply_orientation(img, orientation) if 2 <= orientation <= 8 else img


def _color_space(frame: _Frame, jfif: bool, adobe) -> int:
    """libjpeg's default_decompress_parms: 0 gray, 1 YCbCr, 2 RGB."""
    nc = len(frame.ids)
    if nc == 1:
        return 0
    if nc == 4:
        raise NotImplementedError(f"4-component (CMYK/YCCK) JPEG is not decoded: {_NOT_PORTED}")
    if nc != 3:
        raise _refuse(f"{nc} components")
    if jfif:
        return 1
    if adobe is not None:
        return 2 if adobe == 0 else 1
    return 2 if frame.ids == [82, 71, 66] else 1


def _setup(frame: _Frame, jfif: bool, adobe) -> None:
    """At the first scan: the colour space, jdinput.c initial_setup's checks,
    and the coefficient buffers (each component's blocks of the frame's MCU
    grid, padding included)."""
    frame.color = _color_space(frame, jfif, adobe)
    if frame.height > 65500 or frame.width > 65500:
        raise _refuse(f"image {frame.width} x {frame.height} larger than 65500")
    if len(frame.ids) > 10:
        raise _refuse(f"{len(frame.ids)} components")
    if not all(1 <= f <= 4 for f in frame.h + frame.v):
        raise _refuse("sampling factor outside 1..4")
    mh, mv = max(frame.h), max(frame.v)
    if any(mh % h or mv % v for h, v in zip(frame.h, frame.v)):
        raise _refuse("fractional sampling factors")
    mcus_x, mcus_y = -(-frame.width // (8 * mh)), -(-frame.height // (8 * mv))
    frame.strides = [mcus_x * h for h in frame.h]
    frame.coef_off = [0]
    for stride, v in zip(frame.strides, frame.v):
        frame.coef_off.append(frame.coef_off[-1] + stride * mcus_y * v)
    frame.coefs = np.zeros((frame.coef_off[-1], 64), np.int16)


def _scan(lib, data: bytes, start: int, frame: _Frame, scan: list, tables: np.ndarray, restart: int) -> int:
    """Decode one scan into the frame's coefficients; returns where marker parsing resumes."""
    mh, mv = max(frame.h), max(frame.v)
    if len(scan) == 1:  # non-interleaved: one block per MCU, the component's own block grid
        ci = scan[0][0]
        h, v = frame.h[ci], frame.v[ci]
        mcus_x, mcus_y = -(-frame.width * h // (8 * mh)), -(-frame.height * v // (8 * mv))
        comps = [(scan[0][1], scan[0][2] + 4, 1, 1, frame.strides[ci], frame.coef_off[ci])]
    else:
        if sum(frame.h[ci] * frame.v[ci] for ci, _, _ in scan) > 10:
            raise _refuse("more than 10 blocks in an MCU")
        mcus_x, mcus_y = -(-frame.width // (8 * mh)), -(-frame.height // (8 * mv))
        comps = [(dc, ac + 4, frame.h[ci], frame.v[ci], frame.strides[ci], frame.coef_off[ci]) for ci, dc, ac in scan]
    c = np.array(comps, np.int32)
    out = np.zeros(2, np.int64)
    buf = np.frombuffer(data, np.uint8)
    err = lib.jpeg_scan(buf.ctypes.data, len(data), start, tables.ctypes.data, c.ctypes.data, len(comps),
                        mcus_x, mcus_y, restart, frame.coefs.ctypes.data, out.ctypes.data)
    if err:
        raise _refuse({-1: "bad Huffman table", -2: "a scan uses an undefined Huffman table",
                       -3: "DC coefficient overflow"}.get(err, f"scan error {err}"))
    return int(out[0])


def _render(lib, frame: _Frame, latched: list) -> np.ndarray:
    """The frame from its coefficients, each component dequantised with the
    table latched at its first scan (zeros for a component no scan reached)."""
    nc = len(frame.ids)
    quant = np.zeros((nc, 64), np.uint16)
    for i, q in enumerate(latched):
        if q is not None:
            quant[i] = q
    comps = np.array([(frame.h[i], frame.v[i], frame.strides[i], frame.coef_off[i]) for i in range(nc)], np.int32)
    out = np.empty((frame.height, frame.width, 3), np.uint8)
    err = lib.jpeg_render(frame.coefs.ctypes.data, quant.ctypes.data, comps.ctypes.data, nc, frame.width,
                          frame.height, frame.color, out.ctypes.data)
    if err:
        raise _refuse(f"render error {err}")
    return out


# ITU T.81 Annex K.1's luminance and chrominance tables in natural order
_STD_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
    17, 18, 24, 47, *[99] * 4, 18, 21, 26, 66, *[99] * 4, 24, 26, 56, *[99] * 5, 47, 66, *[99] * 38,
], np.int64).reshape(2, 64)
_JFIF = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"  # version 1.01, no units, density 1:1, no thumbnail
_BYTES_PER_BLOCK = 448  # 64 codes of at most 27 bits each, every byte stuffed: the scan's bound


def quant_tables(quality: int) -> np.ndarray:
    """(2, 64) uint16 luma and chroma quantisation values in natural order, as
    libjpeg's jpeg_set_quality(quality, force_baseline=TRUE) makes them (the
    quality clamped to 1..100, as cv2 clamps IMWRITE_JPEG_QUALITY to 0..100
    and libjpeg 0 to 1)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((_STD_QUANT * scale + 50) // 100, 1, 255).astype(np.uint16)


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


def _dht(slot: int, index: int) -> bytes:
    table = _STD_TABLES[slot]
    n = int(table[1:17].sum(dtype=np.int64))
    return _marker(0xC4, bytes([index]) + table[1 : 17 + n].tobytes())


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """A uint8 frame as the JPEG bytes cv2.imencode(".jpg", img,
    [cv2.IMWRITE_JPEG_QUALITY, quality]) gives: (H, W, 3) BGR as 4:2:0 YCbCr,
    (H, W) or (H, W, 1) gray as one component. Other shapes and dtypes, and
    sides past libjpeg's 65500, raise ValueError."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] not in (1, 3)):
        raise ValueError(f"encode_jpeg: expected uint8 (H, W), (H, W, 1) or (H, W, 3), got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    if not (1 <= h <= 65500 and 1 <= w <= 65500):
        raise ValueError(f"encode_jpeg: a {w} x {h} image; libjpeg takes sides of 1 to 65500")
    a = np.ascontiguousarray(a.reshape(h, w, -1))
    gray = a.shape[2] == 1
    quant = quant_tables(quality)
    comps = [(1, 0x11, 0)] if gray else [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
    tables = range(1 if gray else 2)
    head = [b"\xff\xd8", _marker(0xE0, _JFIF)]
    head += [_marker(0xDB, bytes([t]) + quant[t][_ZIGZAG].astype(np.uint8).tobytes()) for t in tables]
    head.append(_marker(0xC0, struct.pack(">BHHB", 8, h, w, len(comps)) + b"".join(map(bytes, comps))))
    head += [_dht(slot, index) for t in tables for slot, index in ((t, t), (t + 4, 0x10 | t))]
    head.append(_marker(0xDA, bytes([len(comps), *(v for cid, _, t in comps for v in (cid, t << 4 | t)), 0, 63, 0])))
    blocks = -(-w // 8) * -(-h // 8) if gray else -(-w // 16) * -(-h // 16) * 6
    out = np.empty(blocks * _BYTES_PER_BLOCK + 16, np.uint8)
    written = np.zeros(1, np.int64)
    huff = np.stack([_STD_TABLES[0], _STD_TABLES[4], _STD_TABLES[1], _STD_TABLES[5]])
    err = kernels.load("image_encode").jpeg_encode(a.ctypes.data, h, w, a.shape[2], quant.ctypes.data,
                                                   huff.ctypes.data, out.ctypes.data, out.size, written.ctypes.data)
    if err:
        raise RuntimeError(f"jpeg_encode failed ({err}) on a {a.shape} frame")
    return b"".join(head) + out[: int(written[0])].tobytes() + b"\xff\xd9"
