"""Small helpers shared by the port."""

from __future__ import annotations

import contextlib
import logging
import math
import os
import re
import threading
from pathlib import Path
from typing import Any, Dict, List, Tuple

import torch

LOGGER = logging.getLogger("spectrogram_yolov11_torch")
REPO_ROOT = Path(__file__).resolve().parents[2]
RUNS_DIR = Path(os.getenv("SYT_RUNS_DIR", REPO_ROOT / "runs"))


class SimpleClass:
    """Readable repr and attribute errors that list the class's docstring."""

    def __str__(self):
        attr = []
        for a in dir(self):
            v = getattr(self, a)
            if not callable(v) and not a.startswith("_"):
                attr.append(f"{a}: {v.__class__.__module__}.{v.__class__.__name__} object")
        return f"{self.__class__.__module__}.{self.__class__.__name__} object with attributes:\n\n" + "\n".join(attr)

    def __repr__(self):
        return self.__str__()

    def __getattr__(self, attr):
        raise AttributeError(f"'{self.__class__.__name__}' object has no attribute '{attr}'. "
                             f"See valid attributes below.\n{self.__doc__}")


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a feature the port does not have yet, naming its ROADMAP.md item."""
    return NotImplementedError(f"{what} is not ported yet: queued in ROADMAP.md §1 {item}")


def increment_path(path: str | Path, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    """runs/exp -> runs/exp2, runs/exp3, ... unless exist_ok."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{path}{sep}{n}{suffix}"
            if not os.path.exists(p):
                path = Path(p)
                break
    if mkdir:
        path.mkdir(parents=True, exist_ok=True)
    return path


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round a channel count up to the nearest multiple of `divisor`."""
    return math.ceil(x / divisor) * divisor


_f32_lock = threading.Lock()
_f32_state = {"inside": 0, "saved": None}  # callers inside full_f32, and the settings to restore when the last leaves


@contextlib.contextmanager
def full_f32():
    """The port's precision policy, as a context or a decorator: f32 work on
    the card runs in full f32, with TF32 off for cuDNN convolutions (torch
    leaves it on by default) and cuBLAS matmuls while any caller is inside;
    the settings, which are process-wide, come back when the last one leaves,
    so nested and concurrent callers (threads) all run in f32. The network's
    forward and the plain bottleneck run under it, and so does the device
    function of a predict or serve batch (engine/pipeline.py)."""
    with _f32_lock:
        if _f32_state["inside"] == 0:
            _f32_state["saved"] = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        _f32_state["inside"] += 1
    try:
        yield
    finally:
        with _f32_lock:
            _f32_state["inside"] -= 1
            if _f32_state["inside"] == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _f32_state["saved"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default and is never
    replaced by the CPU: without a card a CUDA request raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but no CUDA card is available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


_YAML_NULL = {"", "~", "null", "Null", "NULL"}
_YAML_BOOL = {**dict.fromkeys(("true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"), True),
              **dict.fromkeys(("false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"), False)}
_YAML_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_YAML_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_YAML_KEY = re.compile(r"([A-Za-z0-9_][A-Za-z0-9_.\-]*)\s*:(\s+(.*))?$")


def _yaml_scalar(text: str, where: str) -> Any:
    """One plain or quoted YAML scalar, resolved as yaml.safe_load resolves it."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t[:1] in "[]{}&*!|>'\"%@`" and t:
        raise ValueError(f"unsupported YAML value at {where}: {text!r}")
    if t in _YAML_NULL:
        return None
    if t in _YAML_BOOL:
        return _YAML_BOOL[t]
    if _YAML_INT.match(t):
        return int(t.replace("_", ""))
    if _YAML_FLOAT.match(t) and any(c.isdigit() for c in t):
        return float(t.replace("_", ""))
    if t.lower() in {".inf", "+.inf", "-.inf", ".nan"}:
        return float(t.replace(".", "", 1))
    return t


def _flow_seq(t: str, i: int, where: str) -> Tuple[list, int]:
    """The flow sequence that opens at t[i] == '[' (nested ones too, of plain
    or quoted scalars) -> (its list, the index after its ']')."""
    out: list = []
    i += 1
    while True:
        while i < len(t) and t[i] == " ":
            i += 1
        if i < len(t) and t[i] == "]":
            return out, i + 1
        if i < len(t) and t[i] == "[":
            item, i = _flow_seq(t, i, where)
        else:
            j = t.find(t[i], i + 1) + 1 if i < len(t) and t[i] in "'\"" else i
            if j == 0:
                raise ValueError(f"unterminated quote at {where}: {t!r}")
            while j < len(t) and t[j] not in ",]":
                j += 1
            if not t[i:j].strip():
                raise ValueError(f"empty or unterminated YAML flow list item at {where}: {t!r}")
            item, i = _yaml_scalar(t[i:j], where), j
        out.append(item)
        while i < len(t) and t[i] == " ":
            i += 1
        if i < len(t) and t[i] == ",":
            i += 1
        elif i >= len(t) or t[i] != "]":
            raise ValueError(f"unsupported YAML flow list at {where}: {t!r}")


def _yaml_value(text: str, where: str) -> Any:
    """A scalar, or a one-line flow list [a, [b, c], ...] of scalars and flow lists."""
    t = text.strip()
    if not t.startswith("["):
        return _yaml_scalar(t, where)
    value, end = _flow_seq(t, 0, where)
    if end != len(t):
        raise ValueError(f"text after a YAML flow list at {where}: {text!r}")
    return value


def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a # at its start or after a space, outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            quote = None if c == quote else quote
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def yaml_load(file: str | Path, append_filename: bool = False) -> Dict[str, Any]:
    """Read a dataset or model YAML: the subset those configs use, as
    yaml.safe_load reads it (the port reads no YAML library). It takes
    comments, top-level `key: value` with a scalar (str, int, float, bool,
    null) or a one-line flow list `[a, [b, c]]` (nested, as a model's layer
    rows), and a key with an empty value followed by a block: indented
    `key: value` lines (`names:` with `0: LTE` under it, `scales:` with
    `n: [0.50, 0.25, 1024]`) or `- value` lines (`backbone:` and `head:`).
    Anything else raises a ValueError naming the line."""
    path = Path(file)
    data: Dict[str, Any] = {}
    block: Dict[Any, Any] | List[Any] | None = None
    block_key, block_indent = "", 0
    for n, raw in enumerate(path.read_text(encoding="utf-8").splitlines(), 1):
        where = f"{path}:{n}"
        line = _strip_comment(raw)
        if not line.strip() or line.strip() == "---":
            continue
        if line[0] == "\t":
            raise ValueError(f"tab indentation at {where}")
        indent = len(line) - len(line.lstrip(" "))
        text = line.strip()
        if text == "-" or text.startswith("- "):  # an item of the block sequence under the last key
            if block == {}:
                block, block_indent = [], indent
                data[block_key] = block
            if not isinstance(block, list) or indent != block_indent:
                raise ValueError(f"unexpected sequence item at {where}: {raw!r}")
            block.append(_yaml_value(text[1:], where))
            continue
        m = _YAML_KEY.match(text)
        if not m:
            raise ValueError(f"unsupported YAML at {where}: {raw!r}")
        key, value = m.group(1), m.group(3)
        if indent:
            block_indent = block_indent or indent
            if not isinstance(block, dict) or indent != block_indent:
                raise ValueError(f"unexpected indentation at {where}: {raw!r}")
            block[_yaml_scalar(key, where) if _YAML_INT.match(key) else key] = _yaml_value(value or "", where)
            continue
        if key in data:
            raise ValueError(f"duplicate key {key!r} at {where}")
        if value is None:  # a block of `key: value` or `- value` lines follows, or the value is null
            block, block_key, block_indent = {}, key, 0
            data[key] = block
        else:
            block = None
            data[key] = _yaml_value(value, where)
    data = {k: (None if v == {} else v) for k, v in data.items()}
    if append_filename:
        data["yaml_file"] = str(file)
    return data


def get_latest_run(search_dir: str | Path | None = None) -> str:
    """The newest last*.ckpt under the runs dir, for resume=True ("" when there is none)."""
    ckpts = list(Path(search_dir or RUNS_DIR).rglob("last*.ckpt"))
    return str(max(ckpts, key=lambda p: p.stat().st_mtime)) if ckpts else ""
