"""Predict configuration. Counterpart of spectrogram_yolov11_tpu/cfg/__init__.py
(get_cfg :125, check_dict_alignment :79, check_cfg :92, get_save_dir :151)
over the predict keys of its cfg/default.yaml, held here as a dict because the
port reads no YAML.

Two defaults differ from the JAX package's: `save` is False (True writes
annotated JPEGs with cv2, which the port does not use), and `mode` is
"predict", so `save_txt` writes under runs/detect/predict*.
"""

from __future__ import annotations

import difflib
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Optional

from ..utils import RUNS_DIR, increment_path

DEFAULT_CFG_DICT: Dict[str, Any] = {
    "task": "detect",
    "mode": "predict",
    "imgsz": 640,
    "batch": 16,
    "device": None,  # None -> "cuda"; "cpu" runs the plain versions on the host
    "conf": None,  # None -> 0.25
    "iou": 0.7,
    "max_det": 300,
    "pre_nms_topk": 0,  # 0 -> 1024, the predict default
    "classes": None,
    "agnostic_nms": False,
    "half": False,
    "save": False,
    "save_txt": False,
    "save_conf": False,
    "save_crop": False,
    "project": None,
    "name": None,
    "exist_ok": False,
    "verbose": True,
}

FRACTION_KEYS = {"conf", "iou"}
INT_KEYS = {"max_det", "pre_nms_topk"}
BOOL_KEYS = {"agnostic_nms", "half", "save", "save_txt", "save_conf", "save_crop", "exist_ok", "verbose"}


class IterableSimpleNamespace(SimpleNamespace):
    """SimpleNamespace with iteration over (key, value) pairs and dict-style get."""

    def __iter__(self):
        return iter(vars(self).items())

    def __str__(self):
        return "\n".join(f"{k}={v}" for k, v in vars(self).items())

    def get(self, key, default=None):
        return getattr(self, key, default)


def check_dict_alignment(base: dict, custom: dict) -> None:
    """Raise SyntaxError, with close matches, for keys of `custom` not in `base`."""
    lines = []
    for k in set(custom) - set(base):
        matches = difflib.get_close_matches(k, set(base))
        lines.append(f"'{k}' is not a valid argument. {f'Similar arguments: {matches}.' if matches else ''}")
    if lines:
        raise SyntaxError("\n".join(lines))


def check_cfg(cfg: dict) -> None:
    """Type-check the values, raising TypeError as the JAX package's hard check does."""
    for k, v in cfg.items():
        if v is None:
            continue
        if k in FRACTION_KEYS and not isinstance(v, (int, float)):
            raise TypeError(f"'{k}={v}' must be a number")
        if k in INT_KEYS and not isinstance(v, int):
            raise TypeError(f"'{k}={v}' must be an int")
        if k in BOOL_KEYS and not isinstance(v, bool):
            raise TypeError(f"'{k}={v}' must be a bool")
        if k == "batch" and not isinstance(v, (int, float)):
            raise TypeError(f"'{k}={v}' must be a number")


def get_cfg(cfg: Optional[dict] = None, overrides: Optional[dict] = None) -> IterableSimpleNamespace:
    """Merge defaults <- cfg <- overrides into a checked namespace."""
    cfg = dict(DEFAULT_CFG_DICT if cfg is None else cfg)
    if overrides:
        overrides = dict(overrides)
        if "save_dir" not in cfg:
            overrides.pop("save_dir", None)
        check_dict_alignment(cfg if set(cfg) >= set(DEFAULT_CFG_DICT) else DEFAULT_CFG_DICT, overrides)
        cfg = {**cfg, **overrides}
    for k in ("project", "name"):
        if isinstance(cfg.get(k), (int, float)):
            cfg[k] = str(cfg[k])
    check_cfg(cfg)
    return IterableSimpleNamespace(**cfg)


def get_save_dir(args: SimpleNamespace, name: Optional[str] = None) -> Path:
    """runs/{task}/{name}, incremented unless exist_ok; `save_dir` wins when set."""
    if getattr(args, "save_dir", None):
        return Path(args.save_dir)
    project = args.project or RUNS_DIR / args.task
    return increment_path(Path(project) / (name or args.name or f"{args.mode}"), exist_ok=getattr(args, "exist_ok", False))
