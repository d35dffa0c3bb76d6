"""Read the JAX package's `.ckpt` files without flax or msgpack.

File layout (written by spectrogram_yolov11_tpu/engine/checkpoint.py:
save_checkpoint): an 8-byte little-endian header length, a JSON metadata
block of that length, then `flax.serialization.msgpack_serialize(tree)` of
{variables, ema, opt_state}.

flax's msgpack is plain msgpack plus two extension types:
  ext 1 (ndarray)  -> msgpack array (shape, dtype name, raw C-order bytes)
  ext 3 (npscalar) -> the same encoding of a 0-d array, unpacked to a scalar
The decoder below covers the subset flax emits: maps, arrays, str, bin, ints,
floats, nil, bools and those two extensions.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Cursor over a msgpack byte string."""

    def __init__(self, buf: bytes, raw_str: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw_str = raw_str  # flax unpacks the ndarray payload with raw=True

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw_str else b.decode("utf-8")

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array_(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[t])))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            return self.ext(self.unpack(">b"), n)
        if t == 0xCA:
            return self.unpack(">f")
        if t == 0xCB:
            return self.unpack(">d")
        if 0xCC <= t <= 0xD3:
            return self.unpack(">" + "BHIQbhiq"[t - 0xCC])
        if 0xD4 <= t <= 0xD8:
            code = self.unpack(">b")
            return self.ext(code, 1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t]))
        if t in (0xDC, 0xDD):
            return self.array_(self.unpack(">H" if t == 0xDC else ">I"))
        if t in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def array_(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack_unpack(data, raw_str=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        raise ValueError("bfloat16 checkpoint leaves are not supported by the port's reader")
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def msgpack_unpack(blob: bytes, raw_str: bool = False) -> Any:
    """Decode one msgpack object; the whole of `blob` must be consumed."""
    r = _Reader(blob, raw_str)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after msgpack object")
    return out


def load_checkpoint(path: str | Path) -> Tuple[dict, dict]:
    """Returns (tree {variables, ema, opt_state}, meta dict), as the JAX loader does."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(n).decode())
        tree = msgpack_unpack(f.read())
    if meta.get("names"):
        meta["names"] = {int(k): v for k, v in meta["names"].items()}
    return tree, meta
