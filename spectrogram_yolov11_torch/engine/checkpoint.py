"""Read and write the JAX package's `.ckpt` files without flax or msgpack.

File layout (spectrogram_yolov11_tpu/engine/checkpoint.py: save_checkpoint
:40-80): an 8-byte little-endian header length, a JSON metadata block of that
length (epoch, best_fitness, updates, train_args, model_yaml, names, nc, date,
version), then `flax.serialization.msgpack_serialize(tree)` of {variables,
ema, opt_state}.

flax's msgpack is plain msgpack plus two extension types:
  ext 1 (ndarray)  -> msgpack array (shape, dtype name, raw C-order bytes)
  ext 3 (npscalar) -> the same encoding of a 0-d array, unpacked to a scalar
The decoder and the encoder below cover the subset flax emits: maps, arrays,
str, bin, ints, floats, nil, bools and those two extensions. The encoder
picks msgpack's smallest form for each value, as msgpack-python does, and
writes map keys sorted, as flax does, so a tree of numpy leaves encodes to
the bytes flax writes for it
(tests/test_torch_train_loop.py).
"""

from __future__ import annotations

import json
import struct
from datetime import datetime, timezone
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

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


def _pack_len(out: bytearray, n: int, fix: Optional[int], fix_max: int, codes: Tuple[int, ...]) -> None:
    """A length header: the fix form when n <= fix_max, else the 8-, 16- or
    32-bit form among `codes` (None where a width has no form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(data))
    if fixed is not None:
        out.append(fixed)
    else:
        _pack_len(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + data


def _pack(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    elif isinstance(x, int):
        if 0 <= x <= 0x7F or -32 <= x < 0:
            out += struct.pack(">b" if x < 0 else ">B", x)
        elif x >= 0:
            for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF),
                                   (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
                if x <= top:
                    out.append(code)
                    out += struct.pack(fmt, x)
                    return
            raise ValueError(f"integer {x} too large for msgpack")
        else:
            for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000), (0xD2, ">i", -0x80000000),
                                  (0xD3, ">q", -0x8000000000000000)):
                if x >= lo:
                    out.append(code)
                    out += struct.pack(fmt, x)
                    return
            raise ValueError(f"integer {x} too small for msgpack")
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _pack_len(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in sorted(x.items()):  # flax's tree_map rebuilds every dict with its keys sorted
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot msgpack a {type(x).__name__}")


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    """flax's ndarray payload: msgpack of (shape, dtype name, C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    return msgpack_pack((arr.shape, arr.dtype.name, arr.tobytes("C")))


def msgpack_pack(obj: Any) -> bytes:
    """Encode one object as flax's msgpack_serialize does (numpy leaves)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _write(path: Path, meta: dict, tree: dict) -> None:
    header = json.dumps(meta, default=str).encode()
    blob = msgpack_pack(tree)
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(blob)


def save_checkpoint(path: str | Path, *, variables: Dict[str, Any], ema_variables: Optional[Dict[str, Any]],
                    opt_state: Optional[Dict[str, Any]], epoch: int, best_fitness: float, updates: int,
                    train_args: Optional[dict] = None, model_yaml: Optional[dict] = None,
                    names: Optional[dict] = None, nc: Optional[int] = None, version: str = "") -> None:
    """One file in the JAX package's layout (save_checkpoint :40-80): the
    JSON header and msgpack of {variables, ema, opt_state}, each a tree of
    numpy leaves under flax paths (utils/jax_compat.py) or None."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = {
        "epoch": epoch,
        "best_fitness": float(best_fitness),
        "updates": int(updates),
        "train_args": {k: (str(v) if isinstance(v, Path) else v) for k, v in (train_args or {}).items()},
        "model_yaml": model_yaml,
        "names": {int(k): v for k, v in (names or {}).items()},
        "nc": nc,
        "date": datetime.now(timezone.utc).isoformat(),
        "version": version,
    }
    _write(path, meta, {"variables": variables, "ema": ema_variables, "opt_state": opt_state})


def strip_optimizer(path: str | Path) -> None:
    """Finalise a checkpoint as JAX's strip_optimizer (:95-109): the EMA becomes
    the weights, and the EMA and the optimizer state are dropped."""
    tree, meta = load_checkpoint(path)
    if tree.get("ema") is not None:
        tree["variables"] = tree["ema"]
    tree["ema"] = None
    tree["opt_state"] = None
    _write(Path(path), meta, tree)
