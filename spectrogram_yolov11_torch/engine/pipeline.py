"""The serving pipeline: uint8 letterboxed frames -> detections.

Counterpart of bench.py:_build_pipeline (the path every predict and serve
request runs once per batch):
  1. pad the (B, nh, nw, 1|3) uint8 frames to (imgsz, imgsz) with 114;
  2. broadcast gray to 3 channels, flip BGR -> RGB, divide by 255;
  3. forward (the fused bottleneck kernel runs inside C3k);
  4. DFL decode;
  5. class-offset greedy NMS (the NMS kernel); build_pipeline runs it at
     conf 0.25, iou 0.7, max_det 300, pre_nms_topk 512, the predictor at its
     arguments (pre_nms_topk 1024 by default).

`build_device_fn` is steps 2-5 for frames already letterboxed to S x S; the
predictor (engine/predictor.py) letterboxes any frame sizes on the card
(data/augment.py) and calls it, and `build_pipeline` pads frames of one known
size and calls it.

On the card the network runs channels_last: the NHWC input is viewed as NCHW
for free, and so is every C3k activation handed to the fused bottleneck.

half=True runs the network in bf16 (DetectionModel.set_dtype), as
bench.py:_build_pipeline builds the JAX model with dtype=bfloat16: the f32
input (frames / 255) is rounded to bf16 by the network, the six C3k
bottlenecks run the bf16 kernel, the head's logits come out bf16, the decode
takes its exp and sigmoid in bf16 and gives f32 boxes and scores, and NMS runs
in f32 as before.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.augment import letterbox_geometry
from ..nn.tasks import DetectionModel, build_model
from ..ops.decode import decode_detections
from ..ops.nms import non_max_suppression
from ..utils import full_f32, resolve_device
from .checkpoint import load_checkpoint

CONF_THRES, IOU_THRES, MAX_DET, PRE_NMS_TOPK = 0.25, 0.7, 300, 512


def load_model(ckpt: str | Path) -> Tuple[DetectionModel, dict]:
    """A checkpoint's detection model on the host (EMA weights before the raw
    ones, BN folded for the bottleneck kernel) and its metadata."""
    tree, meta = load_checkpoint(ckpt)
    return build_model(meta["model_yaml"], nc=meta.get("nc"), variables=tree.get("ema") or tree["variables"]), meta


def build_device_fn(model: DetectionModel, conf: float = CONF_THRES, iou: float = IOU_THRES, max_det: int = MAX_DET,
                    classes: Optional[Sequence[int]] = None, agnostic: bool = False,
                    pre_nms_topk: int = PRE_NMS_TOPK, half: bool = False, multi_label: bool = False) -> Callable:
    """The device function of a predict, serve or val batch: fn(uint8 (B, S, S,
    1|3) letterboxed frames on the model's device) -> (out (B, max_det, 6), n
    (B,)), rows [x1, y1, x2, y2, conf, cls] in the JAX layout. Steps 2-5
    above, NMS over every (anchor, class) pair with `multi_label` (the
    validator's setting) and over each anchor's best class otherwise; the
    network in bf16 with `half` (an f32 model is converted by set_dtype,
    which leaves it as it is) and in f32 otherwise, everything else in full
    f32 (utils.full_f32: the DFL decode is a matmul)."""
    classes = None if classes is None else [classes] if isinstance(classes, int) else list(classes)
    model = model.set_dtype(torch.bfloat16 if half else torch.float32)

    @torch.inference_mode()
    @full_f32()
    def fn(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        rgb = frames.expand(-1, -1, -1, 3).flip(-1).float() / 255.0  # gray broadcast, BGR -> RGB
        feats = model(rgb.permute(0, 3, 1, 2))  # NCHW view of NHWC memory
        preds = decode_detections(feats, model.nc, model.stride)
        return non_max_suppression(preds, conf_thres=conf, iou_thres=iou, nc=model.nc, multi_label=multi_label,
                                   agnostic=agnostic, max_det=max_det, pre_nms_topk=pre_nms_topk, classes=classes)

    return fn


def build_pipeline(
    ckpt: str | Path, device: str | torch.device = "cuda", imgsz: int = 640, src_hw: Tuple[int, int] = (720, 1280),
    half: bool = False,
) -> Tuple[Callable, DetectionModel, int, int]:
    """Returns (fn, model, nh, nw); fn(uint8 (B, nh, nw, 1|3)) -> (out (B, 300, 6), n (B,)),
    rows [x1, y1, x2, y2, conf, cls] in the JAX layout, at the settings of
    step 5; the network in bf16 with half=True. Raises without a card unless
    device='cpu'."""
    dev = resolve_device(device)
    model, _ = load_model(ckpt)
    model = model.set_dtype(torch.bfloat16 if half else torch.float32)
    model = model.to(dev, memory_format=torch.channels_last) if dev.type == "cuda" else model
    nh, nw, top, left = letterbox_geometry(imgsz, src_hw)
    device_fn = build_device_fn(model, half=half)

    @torch.inference_mode()
    def fn(frames) -> Tuple[torch.Tensor, torch.Tensor]:
        x = (frames if isinstance(frames, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(frames))).to(dev)
        if x.dtype != torch.uint8 or x.dim() != 4 or tuple(x.shape[1:3]) != (nh, nw) or x.shape[3] not in (1, 3):
            raise ValueError(f"expected uint8 frames (B, {nh}, {nw}, 1|3), got {x.dtype} {tuple(x.shape)}")
        full = torch.full((x.shape[0], imgsz, imgsz, x.shape[3]), 114, dtype=torch.uint8, device=dev)
        full[:, top : top + nh, left : left + nw] = x
        return device_fn(full)

    return fn, model, nh, nw
