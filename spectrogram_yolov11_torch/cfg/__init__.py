"""Predict, val and train configuration. Counterpart of
spectrogram_yolov11_tpu/cfg/__init__.py (get_cfg :125, check_dict_alignment
:79, check_cfg :92, get_save_dir :151) over the predict and val keys of its
cfg/default.yaml and the keys the detect trainer and its augmenting loader
read, held here as a dict because the port reads no config YAML.

Defaults that differ from the JAX package's: `plots` is False (True would
write plots with matplotlib, which the port does not use; val and train raise
for plots=True); `save` is None, which is True in train (checkpoints, as
JAX's default) and False in predict (annotated images with cv2, not ported);
and `mode` is "predict", so `save_txt` writes under runs/detect/predict*.
`conf` None is 0.25 in predict and 0.001 in val, `pre_nms_topk` 0 is 1024 in
predict and 2048 in val, as in the JAX package.

`entrypoint` is the `yolo` command's parser (JAX :232) with one verb,
`serve` (JAX :307-321), which also takes device=; every other verb or mode
raises. The port installs no console script: `yolo` stays the JAX package's.
"""

from __future__ import annotations

import ast
import difflib
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Optional

from ..utils import RUNS_DIR, increment_path, not_ported

DEFAULT_CFG_DICT: Dict[str, Any] = {
    "task": "detect",
    "mode": "predict",
    "data": None,  # val: a dataset YAML (path or packaged name) or dict
    "imgsz": 640,
    "batch": 16,
    "workers": 8,  # val: host threads that read and decode the images
    "seed": 0,  # accepted as in the JAX package; val draws no random numbers
    "device": None,  # None -> "cuda"; "cpu" runs the plain versions on the host
    "single_cls": False,
    "split": "val",  # val: the dataset split to score
    "save_json": False,  # val: COCO-protocol JSON, not ported (raises)
    "plots": False,  # val: PR curves and confusion matrix plots, not ported (raises)
    "conf": None,  # None -> 0.25 predict / 0.001 val
    "iou": 0.7,
    "max_det": 300,
    "pre_nms_topk": 0,  # 0 -> 1024 predict / 2048 val
    "classes": None,
    "agnostic_nms": False,
    "half": False,
    "save": None,  # None -> True in train (checkpoints), False in predict (annotated images)
    "save_txt": False,
    "save_conf": False,
    "save_crop": False,
    "project": None,
    "name": None,
    "exist_ok": False,
    "verbose": True,
    # the training step (engine/trainer.py), with the JAX package's defaults
    "epochs": 100,
    "optimizer": "auto",  # SGD | Adam | AdamW | NAdam | RAdam | RMSProp | auto
    "lr0": 0.01,
    "lrf": 0.01,
    "momentum": 0.937,
    "weight_decay": 0.0005,
    "warmup_epochs": 3.0,
    "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.1,
    "box": 7.5,
    "cls": 0.5,
    "dfl": 1.5,
    "nbs": 64,
    "cos_lr": False,
    "amp": True,  # bf16 compute in training (parameters, optimizer, EMA and BN statistics f32); False: f32
    # the epoch loop (engine/trainer.py: DetectionTrainer.train)
    "time": None,  # wall-clock hours; training stops after the epoch that passes it
    "patience": 100,  # epochs without a better fitness before training stops
    "save_period": -1,  # also keep weights/epoch{n}.ckpt every this many epochs
    "resume": False,  # True (the newest last*.ckpt under the runs dir) or a checkpoint path
    "val": True,  # validate the EMA every epoch (the last epoch always)
    "fraction": 1.0,  # the share of the train images used
    "cache": False,  # False | "ram" (decoded images kept); "disk" is not ported
    "profile": False,  # not ported (raises)
    "multi_scale": False,  # not ported (host augmentation, raises)
    "close_mosaic": 10,  # the last epochs without mosaic
    # augmentation (data/augment.py: TrainTransform), JAX's defaults
    "device_augment": "auto",  # auto | True: the image half on the card; False (host images) is not ported
    "hsv_h": 0.015,
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "translate": 0.1,
    "scale": 0.5,
    "shear": 0.0,
    "perspective": 0.0,
    "flipud": 0.0,
    "fliplr": 0.5,
    "mosaic": 1.0,
    "mixup": 0.0,  # > 0 is not ported (host augmentation, raises)
    "copy_paste": 0.0,  # inert for detect, as in the JAX package (it needs segments)
}

FRACTION_KEYS = {"conf", "iou"}
FLOAT_KEYS = {"lr0", "lrf", "momentum", "weight_decay", "warmup_epochs", "warmup_momentum", "warmup_bias_lr", "box",
              "cls", "dfl", "time", "fraction", "hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale", "shear",
              "perspective", "flipud", "fliplr", "mosaic", "mixup", "copy_paste"}
INT_KEYS = {"max_det", "pre_nms_topk", "workers", "seed", "epochs", "nbs", "patience", "save_period", "close_mosaic"}
BOOL_KEYS = {"agnostic_nms", "half", "save", "save_txt", "save_conf", "save_crop", "exist_ok", "verbose",
             "single_cls", "save_json", "plots", "cos_lr", "amp", "val", "profile", "multi_scale"}


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
        if k in FRACTION_KEYS | FLOAT_KEYS and not isinstance(v, (int, float)):
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


def parse_key_value_pairs(pairs: list) -> dict:
    """['k=v', ...] command-line tokens -> a typed dict (none/true/false in any
    case, Python literals, else the string), as JAX's :160."""
    out = {}
    for pair in pairs:
        k, sep, v = pair.partition("=")
        if not sep:
            raise SyntaxError(f"'{pair}' is not a 'key=value' pair")
        k, v = k.strip(), v.strip()
        if v.lower() in ("none", "true", "false"):
            out[k] = {"none": None, "true": True, "false": False}[v.lower()]
        else:
            try:
                out[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                out[k] = v
    return out


def entrypoint(debug: str = "") -> Any:
    """`yolo serve model=best.ckpt [port=8000 host=127.0.0.1 half=False
    device=cuda block=True data_parallel=False model_parallel=1]`: the
    KServe-v2 server of serve.py, returned (block=False: started, on its
    thread). `debug` is a command line to parse instead of sys.argv."""
    argv = (debug.split(" ") if debug else sys.argv)[1:]
    verbs = [a for a in argv if "=" not in a]
    if verbs != ["serve"]:
        raise not_ported(f"`yolo {' '.join(argv)}`: the port's command line has the serve verb only",
                         "item 12 (the cfg CLI)")
    kv = parse_key_value_pairs([a for a in argv if "=" in a])
    from ..serve import serve

    return serve(kv.get("model") or "yolo11n.yaml", host=str(kv.get("host", "127.0.0.1")),
                 port=int(kv.get("port", 8000)), block=bool(kv.get("block", True)),
                 data_parallel=bool(kv.get("data_parallel", False)),
                 half=bool(kv.get("half", False)), model_parallel=int(kv.get("model_parallel", 1)),
                 device=kv.get("device", "cuda"))
