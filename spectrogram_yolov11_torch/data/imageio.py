"""Image files on the host: a PNG reader and writer in numpy and zlib.

The JAX package reads and writes images with cv2 (cv2.imread, cv2.imwrite);
the port uses neither cv2 nor PIL. `imread` returns what
cv2.imread(path, cv2.IMREAD_COLOR) returns for an 8-bit, non-interlaced PNG:
BGR uint8 (H, W, 3), for gray, gray + alpha, RGB, RGBA and palette images
(alpha dropped, gray repeated over the three channels, a palette looked up).
It undoes all five PNG row filters (RFC 2083 §6): None, Sub and Up as whole-row
numpy operations (Sub is a running sum modulo 256 along the row); Average and
Paeth depend on the decoded left neighbour through a non-linear step, so they
run as a Python loop over the bytes of the row.

`imwrite_png` writes a gray or BGR(A) uint8 image with filter 0 on every row.
Other formats raise NotImplementedError naming the ROADMAP.md item that ports
their decoder; nothing falls back to another reader.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_NO_DECODER = "queued in ROADMAP.md §1 item 5 (image decode); the port reads 8-bit PNG only"


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
    """Average (3) or Paeth (4) on one row, byte by byte."""
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
    for y in range(height):
        f, row = int(filters[y]), data[y]
        if f == 0:
            out[y] = row
        elif f == 1:  # Sub: a running sum along each byte lane of the pixels, modulo 256
            out[y] = np.cumsum(row.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif f == 2:  # Up
            out[y] = row + prior
        else:
            out[y] = _unfilter_loop(f, row, prior, bpp)
        prior = out[y]
    return out


def imread(path: str | Path) -> np.ndarray:
    """An image file as cv2.imread(path) gives it: (H, W, 3) uint8 BGR.
    PNG only (8 bits per sample, not interlaced); other formats raise
    NotImplementedError, a missing file FileNotFoundError."""
    path = str(path)
    suffix = Path(path).suffix.lower()
    if suffix != ".png":
        raise NotImplementedError(f"cannot read {path}: no {suffix or 'extension'} decoder, {_NO_DECODER}")
    data = Path(path).read_bytes()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"corrupt PNG {path}: no IHDR chunk")
    width, height, depth, ctype, compression, filter_method, interlace = header
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
        bgr = np.empty((height, width, 3), np.uint8)
        bgr[...] = px[..., :1]
        return bgr
    return np.ascontiguousarray(px[..., 2::-1])  # RGB(A) -> BGR


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", zlib.crc32(ctype + body))


def imwrite_png(path: str | Path, img: np.ndarray) -> None:
    """Write a uint8 image as cv2.imwrite would read it back: (H, W) or
    (H, W, 1) gray, (H, W, 3) BGR or (H, W, 4) BGRA; filter 0 on every row,
    zlib level 1 (cv2's default PNG compression)."""
    if Path(path).suffix.lower() != ".png":
        raise NotImplementedError(f"cannot write {path}: no {Path(path).suffix or 'extension'} encoder, {_NO_DECODER}")
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim not in (2, 3) or (a.ndim == 3 and a.shape[2] not in (1, 3, 4)):
        raise ValueError(f"imwrite_png: expected uint8 (H, W) or (H, W, 1|3|4), got {a.dtype} {a.shape}")
    a = a.reshape(a.shape[0], a.shape[1], -1)
    c = a.shape[2]
    if c >= 3:
        a = np.concatenate([a[..., 2::-1], a[..., 3:]], axis=-1)  # BGR(A) -> RGB(A)
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    Path(path).write_bytes(PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                           + _chunk(b"IEND", b""))
