"""Image files on the host: a PNG reader and writer in numpy and zlib, and
the dispatch to the JPEG decoder (data/jpeg.py).

The JAX package reads and writes images with cv2 (cv2.imread, cv2.imwrite);
the port uses neither cv2 nor PIL. `imread` returns what
cv2.imread(path, cv2.IMREAD_COLOR) returns, BGR uint8 (H, W, 3), choosing the
decoder by the file's signature as cv2 does, whatever its suffix: JPEG
(FF D8 FF) goes to data/jpeg.py; PNG to the reader here, for an 8-bit,
non-interlaced PNG: gray, gray + alpha, RGB, RGBA and palette images (alpha
dropped, gray repeated over the three channels, a palette looked up). It
undoes all five PNG row filters (RFC 2083 §6): None, Sub and Up as whole-row
numpy operations (Sub is a running sum modulo 256 along the row); Average and
Paeth depend on the decoded left neighbour through a non-linear step, so they
run in the host library's C loop (csrc/png_unfilter.cpp, built with the host
C++ compiler at first use), with `_unfilter_loop` kept as its plain version.

`imdecode` decodes bytes in memory as cv2.imdecode(buf, IMREAD_UNCHANGED)
does for 8-bit JPEG and PNG: a gray image comes back (H, W), a colour one BGR
(H, W, 3), and the EXIF orientation is not applied; an image cv2 would give 4
channels (alpha, or a tRNS chunk on a palette or RGB PNG) or 16 bits raises
ValueError. `imencode_png` encodes a gray or BGR(A) uint8 image as PNG bytes
with filter 0 on every row, and `imwrite_png` writes them to a file.
Other formats (bmp, tif, webp, ...) raise NotImplementedError naming the
ROADMAP.md item that ports their decoder; nothing falls back to another reader.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from ..utils import kernels
from .jpeg import decode_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
# the signatures of other formats cv2 reads, for a message that names the decoder missing
_OTHER_FORMATS = ((b"BM", "BMP"), (b"II*\0", "TIFF"), (b"MM\0*", "TIFF"), (b"RIFF", "WebP"),
                  (b"\0\0\0\x0cjP  ", "JPEG 2000"), (b"#?RADIANCE", "HDR"), (b"\x76\x2f\x31\x01", "OpenEXR"),
                  *((b"P%d" % k, "PNM") for k in range(1, 8)))
_NO_DECODER = ("queued in ROADMAP.md §1 item 5 (image decode); the port reads JPEG (8-bit Huffman sequential) "
               "and 8-bit PNG")
_NO_ENCODER = "queued in ROADMAP.md §1 item 5 (image encode); the port writes PNG only"


def _chunks(data: bytes, path: str):
    """(type, body) of each chunk after the signature, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if len(body) != length or zlib.crc32(ctype + body) != crc:
            raise ValueError(f"corrupt PNG {path}: bad {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"corrupt PNG {path}: no IEND chunk")


def _unfilter_loop(ftype: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Average (3) or Paeth (4) on one row, byte by byte: the plain version of
    the host library's png_unfilter_row."""
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    n = len(out)
    if ftype == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    else:
        for i in range(n):
            if i >= bpp:
                a, c = out[i - bpp], up[i - bpp]
            else:
                a = c = 0
            b = up[i]
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: bytes, height: int, width: int, bpp: int, path: str) -> np.ndarray:
    """The (height, width * bpp) samples from the decompressed scanlines (a
    read-only view of them when no row is filtered)."""
    stride = width * bpp
    if len(raw) < height * (stride + 1):
        raise ValueError(f"corrupt PNG {path}: {len(raw)} bytes of scanlines, expected {height * (stride + 1)}")
    lines = np.frombuffer(raw, np.uint8, count=height * (stride + 1)).reshape(height, stride + 1)
    filters, data = lines[:, 0], lines[:, 1:]
    if filters.max(initial=0) > 4:
        raise ValueError(f"corrupt PNG {path}: row filter {int(filters.max())}")
    if not filters.any():  # every row unfiltered, as imwrite_png writes them
        return data
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    lib = kernels.load("image_decode") if (filters >= 3).any() else None
    for y in range(height):
        f, row = int(filters[y]), data[y]
        if f == 0:
            out[y] = row
        elif f == 1:  # Sub: a running sum along each byte lane of the pixels, modulo 256
            out[y] = np.cumsum(row.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif f == 2:  # Up
            out[y] = row + prior
        else:  # the host library writes out[y] in place; row and prior are read-only views
            lib.png_unfilter_row(f, row.ctypes.data, prior.ctypes.data, out[y].ctypes.data, stride, bpp)
        prior = out[y]
    return out


def imread(path: str | Path) -> np.ndarray:
    """An image file as cv2.imread(path) gives it: (H, W, 3) uint8 BGR. The
    decoder is chosen by the file's first bytes, as cv2 chooses it: JPEG
    (data/jpeg.py) or PNG (8 bits per sample, not interlaced). Other formats
    raise NotImplementedError, a missing file FileNotFoundError, a file no
    decoder takes or a corrupt one ValueError (where cv2.imread returns None)."""
    path = str(path)
    if not Path(path).is_file():
        raise FileNotFoundError(f"no image file {path}")
    return _decode(Path(path).read_bytes(), path, color=True)


def imdecode(buf) -> np.ndarray:
    """Encoded image bytes as cv2.imdecode(buf, cv2.IMREAD_UNCHANGED) gives
    them for an 8-bit JPEG or PNG: (H, W) uint8 for a gray image, (H, W, 3)
    BGR for a colour one, the EXIF orientation not applied. What cv2 would
    decode to 4 channels or 16 bits, bytes no decoder takes and corrupt bytes
    raise ValueError (where cv2.imdecode returns None or those channels);
    other formats NotImplementedError, as `imread`."""
    return _decode(bytes(buf), "image bytes", color=False)


def _decode(data: bytes, where: str, color: bool) -> np.ndarray:
    """The decoder picked by the first bytes; color=True is IMREAD_COLOR, False IMREAD_UNCHANGED."""
    if data.startswith(b"\xff\xd8\xff"):
        try:
            return decode_jpeg(data, color=color)
        except ValueError as e:
            raise ValueError(f"{where}: {e}") from None
    if not data.startswith(PNG_SIGNATURE):
        fmt = next((name for sig, name in _OTHER_FORMATS if data.startswith(sig)), None)
        if fmt:
            raise NotImplementedError(f"cannot read {where}: no {fmt} decoder, {_NO_DECODER}")
        raise ValueError(f"{where} is neither a JPEG nor a PNG file")
    return _read_png(data, where, color)


def _read_png(data: bytes, path: str, color: bool = True) -> np.ndarray:
    header, palette, idat, trns = None, None, [], False
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"tRNS":
            trns = True
    if header is None:
        raise ValueError(f"corrupt PNG {path}: no IHDR chunk")
    width, height, depth, ctype, compression, filter_method, interlace = header
    if not color and (depth == 16 or ctype in (4, 6) or (ctype in (2, 3) and trns)):
        raise ValueError(f"{path}: a {depth}-bit PNG of colour type {ctype}{' with tRNS' if trns else ''} decodes "
                         "to 16 bits or 4 channels; only 8-bit gray and colour images are taken")
    if depth != 8 or interlace or ctype not in _CHANNELS:
        raise NotImplementedError(f"cannot read {path}: bit depth {depth}, colour type {ctype}, interlace "
                                  f"{interlace}; {_NO_DECODER}, non-interlaced")
    if compression or filter_method:
        raise ValueError(f"corrupt PNG {path}: compression {compression}, filter method {filter_method}")
    channels = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), height, width, channels, path).reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"corrupt PNG {path}: palette image without PLTE")
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"corrupt PNG {path}: palette index past the {len(palette)} entries")
        px = palette[px[..., 0]]
    elif channels <= 2:  # gray, gray + alpha: the three channels equal
        if not color:
            return np.ascontiguousarray(px[..., 0])
        bgr = np.empty((height, width, 3), np.uint8)
        bgr[...] = px[..., :1]
        return bgr
    return np.ascontiguousarray(px[..., 2::-1])  # RGB(A) -> BGR


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def imwrite_png(path: str | Path, img: np.ndarray) -> None:
    """Write a uint8 image as cv2.imwrite would read it back (imencode_png's bytes)."""
    if Path(path).suffix.lower() != ".png":
        raise NotImplementedError(f"cannot write {path}: no {Path(path).suffix or 'extension'} encoder, {_NO_ENCODER}")
    Path(path).write_bytes(imencode_png(img))


def imencode_png(img: np.ndarray) -> bytes:
    """A uint8 image as PNG bytes that cv2 decodes back to it: (H, W) or
    (H, W, 1) gray, (H, W, 3) BGR or (H, W, 4) BGRA; filter 0 on every row,
    zlib level 1 (cv2's default PNG compression)."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] not in (1, 3, 4)):
        raise ValueError(f"imencode_png: expected uint8 (H, W) or (H, W, 1|3|4), got {a.dtype} {a.shape}")
    a = a.reshape(a.shape[0], a.shape[1], -1)
    c = a.shape[2]
    if c >= 3:
        a = np.concatenate([a[..., 2::-1], a[..., 3:]], axis=-1)  # BGR(A) -> RGB(A)
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))
