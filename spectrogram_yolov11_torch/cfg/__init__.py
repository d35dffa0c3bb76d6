"""Predict, val and train configuration, and the command line. Counterpart
of spectrogram_yolov11_tpu/cfg/__init__.py (get_cfg :125, check_dict_alignment
:79, check_cfg :92, get_save_dir :151, entrypoint :232) over every key of its
cfg/default.yaml, held here as a dict with JAX's defaults.

The one default that differs from the JAX package's: `mode` is "predict", so
predict's saved images, labels and crops go under runs/detect/predict*.
JAX's facade leaves `mode` at "train" and writes them under
runs/detect/train*, a fault of the reference not carried over (ROADMAP.md
§3.14). `save` is True, as JAX's: checkpoints in train, the annotated
<stem>.jpg of every image in predict. `plots` is True, as JAX's: val writes
its PR/F1/P/R curves and confusion matrices, train its first three batch
mosaics and results.png (the port's own drawing, utils/plotting.py).
`save_json=True` (val's COCO JSON and protocol eval), `profile=True` (a
torch.profiler trace of training) and `batch=-1` (AutoBatch,
utils/autobatch.py) are honoured.
`conf` None is 0.25 in predict and 0.001 in val, `pre_nms_topk` 0 is 1024 in
predict and 2048 in val, as in the JAX package.

The keys that JAX's detect path reads the port reads as JAX does. Of the
rest (every one is accepted at its default, and `get_cfg` handles it so):

| Keys | JAX | The port |
| --- | --- | --- |
| `model` | the trainer builds `args.model` when it has no model (engine/trainer.py:204-205); the CLI builds it | the same (engine/trainer.py:setup_model, `entrypoint`); YOLO.train hands it its model's path, as JAX's facade |
| `source` | predict's source, from the CLI | the same (`entrypoint` hands it to YOLO.predict) |
| `cfg` | the CLI's `cfg=<yaml>` of overrides | the same; inert in get_cfg, as in JAX |
| `rect` | warns and is set False (cfg/__init__.py:139-146) | warns and is set False |
| `pretrained`, `deterministic`, `freeze`, `bgr`, `dropout`, `save_hybrid`, `dnn` | read nowhere | inert |
| `overlap_mask`, `mask_ratio` | the segment task's loss (overlap), its instance masks and validator (mask_ratio) | read as JAX does by the segment task (engine/trainer.py:SegmentationTrainer; overlap_mask=False raises JAX's ValueError); inert for detect |
| `pose`, `kobj` | the pose task's loss gains | read as JAX does by the pose task (engine/trainer.py:PoseTrainer); inert for detect, segment and obb |
| `retina_masks`, `copy_paste_mode`, `auto_augment`, `erasing`, `crop_fraction` | read by the classify path only, or nowhere | inert (JAX's segment, pose, obb and classify paths read none of them: its classify augmentations are fixed) |
| `augment`, `visualize` | TTA and feature maps in predict; read by no other mode | honoured in predict (engine/predictor.py: TTA's device function, the feature-map PNGs); read by no other mode, as in JAX |
| `line_width`, `show_conf`, `show_labels` | predict's saved plots | honoured (Results.plot) |
| `show_boxes` | read nowhere | inert |
| `show` | a window in predict | another value than the default raises: item 5 (no display on the card's machine) |
| `save_frames`, `vid_stride`, `stream_buffer` | video and stream sources | another value than the default raises: item 5 (video and streams) |
| `embed` | read by no mode (YOLO.embed takes its layers as an argument) | inert; YOLO.embed(embed=...) honours its argument |
| `format`, `int8`, `opset`, `nms` | the Exporter (`int8` and `opset` in its TensorFlow rows only) | read by the Exporter as JAX's (engine/exporter.py); `int8` and `opset` reach only the TensorFlow rows, which raise without tensorflow |
| `keras`, `simplify`, `dynamic`, `optimize`, `workspace` | read nowhere | inert (a .pt2 program is dynamic in batch, height and width whatever `dynamic` says) |
| `tracker` | YOLO.track | the same: item 12 |

`entrypoint` is the `yolo` command's parser (JAX :232) for the verbs
`train`, `val`, `predict` and `export` (the task word `detect`, `segment`, `pose`, `obb`
or `classify` optional), with `k=v`
and `cfg=<yaml>` overrides, and `serve` (JAX :307-321), which also takes
device=; the other modes and verbs raise with their ROADMAP.md items. It
defaults as JAX's: mode train, model yolo11n.yaml, data (train and val
without it, and no checkpoint data) shapes128.yaml, the port's copy of JAX's
(64 + 16 synthetic shapes at 640 px, written as JAX writes them at first
use, data/synth.py); for `segment`, yolo11n-seg.yaml and shapes128-seg.yaml;
for `pose`, yolo11n-pose.yaml and shapes128-pose.yaml; for `obb`,
yolo11n-obb.yaml and shapes128-obb.yaml; for `classify`, yolo11n-cls.yaml
and imagenette160 (a folder under the repo's datasets/, synthesised by the
trainer at first use; val and predict read `data` and `source` as paths, as
JAX's). `python -m
spectrogram_yolov11_torch ...` runs it; the
port installs no console script: `yolo` stays the JAX package's.
"""

from __future__ import annotations

import ast
import difflib
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Optional

from ..utils import LOGGER, RUNS_DIR, increment_path, not_ported, yaml_load

DEFAULT_CFG_DICT: Dict[str, Any] = {
    "task": "detect",
    "mode": "predict",
    "data": None,  # val: a dataset YAML (path or packaged name) or dict
    "imgsz": 640,
    "batch": 16,  # train: -1 picks it by AutoBatch
    "workers": 8,  # host threads: val's and train's image reads and decodes, predict's saved images
    "seed": 0,  # accepted as in the JAX package; val draws no random numbers
    "device": None,  # None -> "cuda"; "cpu" runs the plain versions on the host
    "single_cls": False,
    "split": "val",  # val: the dataset split to score
    "save_json": False,  # val: predictions.json, annotations.json and the COCO-protocol stats
    "plots": True,  # val: PR/F1/P/R curves and confusion matrices; train: batch mosaics and results.png
    "conf": None,  # None -> 0.25 predict / 0.001 val
    "iou": 0.7,
    "max_det": 300,
    "pre_nms_topk": 0,  # 0 -> 1024 predict / 2048 val
    "classes": None,
    "agnostic_nms": False,
    "half": False,
    "save": True,  # train: checkpoints; predict: each image's plot as <stem>.jpg
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
    "cache": False,  # False | "ram" (decoded images kept) | "disk" (.npy sidecars beside the images)
    "profile": False,  # train: a torch.profiler trace under <save_dir>/profile
    "multi_scale": False,  # host augmentation: each step's images resized to a size drawn from 0.5-1.5 x imgsz
    "close_mosaic": 10,  # the last epochs without mosaic
    # augmentation (data/augment.py: TrainTransform), JAX's defaults
    "device_augment": "auto",  # auto | True: the image half on the card; False: on the host (JAX's resolution)
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
    "mixup": 0.0,  # > 0 augments on the host (mosaic pairs blended by beta(32, 32))
    "copy_paste": 0.0,  # the segment and obb tasks' 'flip' copy-paste (host mode); inert for detect, as in JAX
    # the rest of JAX's cfg/default.yaml, at its defaults (the module's table says how each is read)
    "model": None,  # the trainer builds it when it has no model; YOLO.train passes its model's path
    "source": None,  # predict's source (the command line)
    "cfg": None,  # the command line's cfg=<yaml> of overrides
    "rect": False,  # True warns and is set False, as in JAX
    "pretrained": True,
    "deterministic": True,
    "freeze": None,
    "bgr": 0.0,
    "dropout": 0.0,
    "save_hybrid": False,
    "dnn": False,
    "pose": 12.0,
    "kobj": 1.0,
    "overlap_mask": True,
    "mask_ratio": 4,
    "retina_masks": False,
    "copy_paste_mode": "flip",
    "auto_augment": "randaugment",
    "erasing": 0.4,
    "crop_fraction": 1.0,
    "augment": False,
    "visualize": False,
    "show": False,
    "show_labels": True,
    "show_conf": True,
    "show_boxes": True,
    "line_width": None,
    "save_frames": False,
    "vid_stride": 1,
    "stream_buffer": False,
    "embed": None,
    "format": "stablehlo",
    "keras": False,
    "int8": False,
    "opset": None,
    "simplify": True,
    "dynamic": False,
    "optimize": False,
    "workspace": None,
    "nms": False,
    "tracker": "botsort.yaml",
}

# keys of features the port does not have: another value than the default raises, naming the ROADMAP.md item
_VIDEO = "item 5 (video and streams)"
NOT_PORTED_KEYS = {
    "show": "item 5 (show: a window)",
    "save_frames": _VIDEO, "vid_stride": _VIDEO, "stream_buffer": _VIDEO,
    "tracker": "item 12 (host-side remainder: trackers)",
}

FRACTION_KEYS = {"conf", "iou"}
FLOAT_KEYS = {"lr0", "lrf", "momentum", "weight_decay", "warmup_epochs", "warmup_momentum", "warmup_bias_lr", "box",
              "cls", "dfl", "time", "fraction", "hsv_h", "hsv_s", "hsv_v", "degrees", "translate", "scale", "shear",
              "perspective", "flipud", "fliplr", "mosaic", "mixup", "copy_paste", "dropout", "bgr", "workspace"}
INT_KEYS = {"max_det", "pre_nms_topk", "workers", "seed", "epochs", "nbs", "patience", "save_period", "close_mosaic",
            "mask_ratio", "vid_stride", "line_width"}
BOOL_KEYS = {"agnostic_nms", "half", "save", "save_txt", "save_conf", "save_crop", "exist_ok", "verbose",
             "single_cls", "save_json", "plots", "cos_lr", "amp", "val", "profile", "multi_scale", "deterministic",
             "rect", "overlap_mask", "save_hybrid", "dnn", "show", "save_frames", "show_labels", "show_conf",
             "visualize", "augment", "retina_masks", "show_boxes", "keras", "optimize", "int8", "dynamic",
             "simplify", "nms"}


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
    if cfg.get("rect"):
        LOGGER.warning("rect=True is not supported (one static image shape per batch); using square letterbox")
        cfg["rect"] = False
    check_cfg(cfg)
    for k, item in NOT_PORTED_KEYS.items():
        if k in cfg and cfg[k] != DEFAULT_CFG_DICT[k]:
            raise not_ported(f"{k}={cfg[k]!r}", item)
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


TASKS = {"detect", "segment", "classify", "pose", "obb"}
MODES = {"train", "val", "predict", "export", "track", "benchmark"}
TASK2DATA = {"detect": "shapes128.yaml", "segment": "shapes128-seg.yaml", "classify": "imagenette160",
             "pose": "shapes128-pose.yaml", "obb": "shapes128-obb.yaml"}  # JAX's (cfg/__init__.py:32-45)
TASK2MODEL = {"detect": "yolo11n.yaml", "segment": "yolo11n-seg.yaml", "classify": "yolo11n-cls.yaml",
              "pose": "yolo11n-pose.yaml", "obb": "yolo11n-obb.yaml"}

CLI_HELP_MSG = """
    Usage: python -m spectrogram_yolov11_torch [TASK] MODE [ARGS]

        TASK (optional): detect, segment, pose, obb or classify
        MODE (required): one of {train, val, predict, export}, or serve
        ARGS (optional): 'key=value' overrides, e.g. imgsz=640 data=spectrogram_synth.yaml, and cfg=<yaml>

    Examples:
        python -m spectrogram_yolov11_torch detect train model=spectrogram_yolo11.yaml data=spectrogram_synth.yaml epochs=2
        python -m spectrogram_yolov11_torch detect val model=runs/detect/train/weights/best.ckpt data=spectrogram_synth.yaml
        python -m spectrogram_yolov11_torch predict model=runs/detect/train/weights/best.ckpt source=frames/
        python -m spectrogram_yolov11_torch segment train data=shapes128-seg.yaml epochs=3
        python -m spectrogram_yolov11_torch pose train data=shapes128-pose.yaml epochs=3
        python -m spectrogram_yolov11_torch obb train data=shapes128-obb.yaml epochs=3
        python -m spectrogram_yolov11_torch classify train data=imagenette160 epochs=3
        python -m spectrogram_yolov11_torch export model=runs/detect/train/weights/best.ckpt format=stablehlo imgsz=640
        python -m spectrogram_yolov11_torch serve model=runs/detect/train/weights/best.ckpt port=8000
"""


def _serve(argv: list) -> Any:
    extra = [a for a in argv if "=" not in a and a != "serve"]
    if extra:
        raise SyntaxError(f"`yolo serve` takes key=value arguments only, got {extra}")
    kv = parse_key_value_pairs([a for a in argv if "=" in a])
    from ..serve import serve

    return serve(kv.get("model") or "yolo11n.yaml", host=str(kv.get("host", "127.0.0.1")),
                 port=int(kv.get("port", 8000)), block=bool(kv.get("block", True)),
                 data_parallel=bool(kv.get("data_parallel", False)),
                 half=bool(kv.get("half", False)), model_parallel=int(kv.get("model_parallel", 1)),
                 device=kv.get("device", "cuda"))


def entrypoint(debug: str = "") -> Any:
    """The `yolo` command line (JAX :232): `[detect|segment|pose|obb|classify] train|val|predict|export k=v ...
    [cfg=<yaml>]` builds YOLO(model, task=task) and calls the mode with the
    overrides (the card unless device=cpu); `serve model=best.ckpt [port=8000
    host=127.0.0.1 half=False device=cuda block=True data_parallel=False
    model_parallel=1]` returns the KServe-v2 server of serve.py (block=False:
    started, on its thread). `debug` is a command line to parse instead of
    sys.argv. The other modes and verbs raise with their ROADMAP.md items."""
    argv = (debug.split(" ") if debug else sys.argv)[1:]
    if not argv or argv[0] in {"help", "-h", "--help"}:
        print(CLI_HELP_MSG)
        return None
    overrides: dict = {}
    task = mode = None
    kv: list = []
    for a in argv:
        if a in TASKS:
            task = a
        elif a in MODES:
            mode = a
        elif a == "serve":
            return _serve(argv)
        elif a in {"settings", "cfg", "copy-cfg", "hub", "login", "logout", "solutions", "checks", "version"}:
            raise not_ported(f"`yolo {a}`", "item 12 (host-side remainder: the CLI's other verbs)")
        elif a.startswith("cfg="):
            overrides.update(yaml_load(a.split("=", 1)[1]))
        elif "=" in a:
            kv.append(a)
        else:
            raise SyntaxError(f"'{a}' is not a valid argument.\n{CLI_HELP_MSG}")
    overrides.update(parse_key_value_pairs(kv))
    check_dict_alignment({**DEFAULT_CFG_DICT, "task": task, "mode": mode}, overrides)
    mode = mode or overrides.pop("mode", None) or "train"
    task = task or overrides.pop("task", None)
    model = overrides.pop("model", None) or TASK2MODEL.get(task or "detect")
    from .. import YOLO

    m = YOLO(model, task=task)
    if mode in {"train", "val"} and "data" not in overrides and not getattr(m, "ckpt_data", None):
        overrides["data"] = TASK2DATA.get(m.task or "detect")
        LOGGER.warning(f"'data' argument missing, using default {overrides['data']}")
    return getattr(m, mode)(**overrides)  # track and benchmark raise with their items
