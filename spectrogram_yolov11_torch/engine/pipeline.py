"""The serving pipeline: uint8 letterboxed frames -> detections.

Counterpart of bench.py:_build_pipeline (the path every predict and serve
request runs once per batch):
  1. pad the (B, nh, nw, 1|3) uint8 frames to (imgsz, imgsz) with 114;
  2. broadcast gray to 3 channels, flip BGR -> RGB, divide by 255;
  3. forward (the fused bottleneck kernel runs inside C3k);
  4. DFL decode;
  5. class-offset greedy NMS (the NMS kernel), conf 0.25, iou 0.7,
     max_det 300, pre_nms_topk 512.

On the card the network runs channels_last: the NHWC input is viewed as NCHW
for free, and so is every C3k activation handed to the fused bottleneck.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Tuple

import numpy as np
import torch

from ..nn.tasks import DetectionModel, build_model
from ..ops.decode import decode_detections
from ..ops.nms import non_max_suppression
from ..utils import resolve_device
from .checkpoint import load_checkpoint

CONF_THRES, IOU_THRES, MAX_DET, PRE_NMS_TOPK = 0.25, 0.7, 300, 512


def letterbox_geometry(imgsz: int, src_hw: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """(nh, nw, top, left) of a src_hw frame letterboxed into imgsz x imgsz."""
    src_h, src_w = src_hw
    r = min(imgsz / src_h, imgsz / src_w)
    nh, nw = int(round(src_h * r)), int(round(src_w * r))
    top = int(round((imgsz - nh) / 2 - 0.1))
    left = int(round((imgsz - nw) / 2 - 0.1))
    return nh, nw, top, left


def build_pipeline(
    ckpt: str | Path, device: str | torch.device = "cuda", imgsz: int = 640, src_hw: Tuple[int, int] = (720, 1280)
) -> Tuple[Callable, DetectionModel, int, int]:
    """Returns (fn, model, nh, nw); fn(uint8 (B, nh, nw, 1|3)) -> (out (B, 300, 6), n (B,)),
    rows [x1, y1, x2, y2, conf, cls] in the JAX layout. Raises without a card
    unless device='cpu'."""
    dev = resolve_device(device)
    tree, meta = load_checkpoint(ckpt)
    model = build_model(meta["model_yaml"], nc=meta.get("nc"), variables=tree.get("ema") or tree["variables"])
    model = model.to(dev, memory_format=torch.channels_last) if dev.type == "cuda" else model
    nh, nw, top, left = letterbox_geometry(imgsz, src_hw)

    @torch.inference_mode()
    def fn(frames) -> Tuple[torch.Tensor, torch.Tensor]:
        x = (frames if isinstance(frames, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(frames))).to(dev)
        if x.dtype != torch.uint8 or x.dim() != 4 or tuple(x.shape[1:3]) != (nh, nw) or x.shape[3] not in (1, 3):
            raise ValueError(f"expected uint8 frames (B, {nh}, {nw}, 1|3), got {x.dtype} {tuple(x.shape)}")
        full = torch.full((x.shape[0], imgsz, imgsz, x.shape[3]), 114, dtype=torch.uint8, device=dev)
        full[:, top : top + nh, left : left + nw] = x
        rgb = full.expand(-1, -1, -1, 3).flip(-1).float() / 255.0  # gray broadcast, BGR -> RGB
        feats = model(rgb.permute(0, 3, 1, 2))  # NCHW view of NHWC memory
        preds = decode_detections(feats, model.nc, model.stride)
        return non_max_suppression(preds, conf_thres=CONF_THRES, iou_thres=IOU_THRES, nc=model.nc,
                                   max_det=MAX_DET, pre_nms_topk=PRE_NMS_TOPK)

    return fn, model, nh, nw
