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

`build_device_fn` is steps 2-5 for frames already letterboxed to S x S
(`build_segment_fn` the segment task's, with its masks, `build_pose_fn` the
pose task's, with its keypoints, `build_obb_fn` the obb task's, rotated
boxes through ops/nms.py:nms_rotated, no keep kernel); the
predictor (engine/predictor.py) letterboxes any frame sizes on the card
(data/augment.py) and calls it, and `build_pipeline` pads frames of one known
size and calls it; with augment=True it is TTA's (three scaled and flipped
passes into one NMS). `build_ensemble_fn` is the device function of a
weight ensemble (every member's predictions into one NMS).

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

import math
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.augment import letterbox_geometry
from ..nn.tasks import DetectionModel, build_model
from ..ops.decode import decode_detections, decode_e2e, decode_kpts, decode_obb, nms_free_postprocess
from ..ops.masks import crop_masks_device
from ..ops.nms import nms_rotated, non_max_suppression, non_max_suppression_extras
from ..utils import full_f32, resolve_device
from .checkpoint import load_checkpoint

CONF_THRES, IOU_THRES, MAX_DET, PRE_NMS_TOPK = 0.25, 0.7, 300, 512


def load_model(ckpt: str | Path) -> Tuple[DetectionModel, dict]:
    """A checkpoint's detection model on the host (EMA weights before the raw
    ones, BN folded for the bottleneck kernel) and its metadata."""
    tree, meta = load_checkpoint(ckpt)
    return build_model(meta["model_yaml"], nc=meta.get("nc"), variables=tree.get("ema") or tree["variables"]), meta


def eval_network(model: DetectionModel, half: bool, device: torch.device) -> DetectionModel:
    """The network a predictor or validator runs for `model`, on `device`
    (channels_last on the card): the model itself in f32, its bf16 copy with
    `half` (set_dtype) or when the model was set to compute in bf16 (amp
    training, set_compute_dtype), as the JAX model keeps the dtype its
    trainer set. A model left in training mode is put in eval mode
    first, which folds its fused bottlenecks from the weights it holds now:
    it runs BN on its running statistics and the kernels on its current
    weights, as the JAX predictor and validator apply a model with
    train=False."""
    if model.training:
        model.eval()
    fmt = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    half = half or model.compute_dtype == torch.bfloat16
    return model.set_dtype(torch.bfloat16 if half else torch.float32).to(device, memory_format=fmt)


def forward_decode(model: DetectionModel, rgb: torch.Tensor) -> torch.Tensor:
    """uint8 (B, S, S, 3) RGB frames on the model's device -> decoded
    predictions (B, A, 4 + nc) f32: divide by 255, forward on the NCHW view of
    the NHWC memory, DFL decode. The device function below and the serving
    graph (engine/exporter.py) both run it."""
    feats = model((rgb.float() / 255.0).permute(0, 3, 1, 2))
    return decode_detections(feats, model.nc, model.stride)


def e2e_detections(model: DetectionModel, rgb: torch.Tensor, max_det: int) -> torch.Tensor:
    """uint8 (B, S, S, 3) RGB frames -> an end2end (v10) model's rows (B,
    min(max_det, A), 6) [x1, y1, x2, y2, conf, cls], sorted by confidence:
    its one2one branch decoded with the boxes kept xyxy, then the NMS-free
    top-k (ops/decode.py:nms_free_postprocess). No NMS and no keep kernel."""
    out = model((rgb.float() / 255.0).permute(0, 3, 1, 2))
    return nms_free_postprocess(decode_e2e(out["one2one"], model.nc, model.stride), max_det, model.nc)


def build_device_fn(model: DetectionModel, conf: float = CONF_THRES, iou: float = IOU_THRES, max_det: int = MAX_DET,
                    classes: Optional[Sequence[int]] = None, agnostic: bool = False,
                    pre_nms_topk: int = PRE_NMS_TOPK, half: bool = False, multi_label: bool = False,
                    augment: bool = False) -> Callable:
    """The device function of a predict, serve or val batch: fn(uint8 (B, S, S,
    1|3) letterboxed frames on the model's device) -> (out (B, max_det, 6), n
    (B,)), rows [x1, y1, x2, y2, conf, cls] in the JAX layout. Steps 2-5
    above, NMS over every (anchor, class) pair with `multi_label` (the
    validator's setting) and over each anchor's best class otherwise; with
    `augment` (predict's TTA, JAX's run_tta) the candidates are
    tta_predictions' three passes. The network in bf16 with `half` (an f32
    model is converted by set_dtype, which leaves it as it is) and in f32
    otherwise, everything else in full f32 (utils.full_f32: the DFL decode
    is a matmul). An end2end (v10) model runs JAX's NMS-free branch
    (engine/predictor.py:111-128, engine/validator.py:95-108) whatever the
    other settings: e2e_detections, n the rows above `conf`, and with
    `classes` the rows of other classes dropped too, the kept rows moved
    first in confidence order (a stable sort); iou, agnostic, pre_nms_topk,
    multi_label and augment are not read."""
    classes = None if classes is None else [classes] if isinstance(classes, int) else list(classes)
    model = model.set_dtype(torch.bfloat16 if half else torch.float32)
    if model.end2end:
        return _e2e_device_fn(model, conf, max_det, classes)

    @torch.inference_mode()
    @full_f32()
    def fn(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if augment:
            preds = tta_predictions(model, normalize(frames))
        else:
            preds = forward_decode(model, frames.expand(-1, -1, -1, 3).flip(-1))  # gray broadcast, BGR -> RGB
        return non_max_suppression(preds, conf_thres=conf, iou_thres=iou, nc=model.nc, multi_label=multi_label,
                                   agnostic=agnostic, max_det=max_det, pre_nms_topk=pre_nms_topk, classes=classes)

    return fn


def _e2e_device_fn(model: DetectionModel, conf: float, max_det: int, classes: Optional[List[int]]) -> Callable:
    @torch.inference_mode()
    @full_f32()
    def fn(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        det = e2e_detections(model, frames.expand(-1, -1, -1, 3).flip(-1), max_det)
        keep = det[..., 4] > conf
        if classes is not None:
            keep &= torch.isin(det[..., 5], torch.tensor(classes, dtype=det.dtype, device=det.device))
            order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
            det = det.gather(1, order[..., None].expand(-1, -1, det.shape[-1]))
        return det, keep.sum(-1).int()

    return fn


def build_segment_fn(model: DetectionModel, conf: float = CONF_THRES, iou: float = IOU_THRES, max_det: int = MAX_DET,
                     pre_nms_topk: int = 1024, half: bool = False, binary: bool = False) -> Callable:
    """The device function of a segment predict or val batch (JAX's
    SegmentationPredictor and SegmentationValidator device functions,
    engine/predictor.py:338, engine/validator.py:416): fn(uint8 (B, S, S,
    1|3) letterboxed BGR frames on the model's device) -> (out (B, max_det,
    6) [x1, y1, x2, y2, conf, cls], n (B,), masks (B, max_det, S / 4, S /
    4)). The frames normalised and forwarded, the boxes decoded, the
    coefficients (f32) carried through NMS with extras (each anchor's best
    class; the greedy keep kernel), the masks sigmoid(coefficients @
    prototypes) in f32, thresholded at 0.5 with `binary` (the validator's
    bool masks), and cropped to their boxes (crop_masks_device). The
    network in bf16 with `half`. Rows past n hold zeros and empty masks."""
    model = model.set_dtype(torch.bfloat16 if half else torch.float32)

    @torch.inference_mode()
    @full_f32()
    def fn(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        feats, mc, proto = model(nchw(normalize(frames)))
        preds = torch.cat([decode_detections(feats, model.nc, model.stride), mc.float()], -1)
        out, n = non_max_suppression_extras(preds, conf_thres=conf, iou_thres=iou, nc=model.nc, max_det=max_det,
                                            pre_nms_topk=pre_nms_topk)
        masks = torch.sigmoid(torch.einsum("bdk,bkhw->bdhw", out[..., 6:], proto.float()))
        masks = crop_masks_device(masks > 0.5 if binary else masks, out[..., :4], frames.shape[1:3])
        return out[..., :6], n, masks

    return fn


def build_pose_fn(model: DetectionModel, conf: float = CONF_THRES, iou: float = IOU_THRES, max_det: int = MAX_DET,
                  pre_nms_topk: int = 1024, half: bool = False) -> Callable:
    """The device function of a pose predict or val batch (JAX's
    PosePredictor and PoseValidator device functions, engine/predictor.py:
    503, engine/validator.py:539): fn(uint8 (B, S, S, 1|3) letterboxed BGR
    frames on the model's device) -> (out (B, max_det, 6 + nk * nd) [x1, y1,
    x2, y2, conf, cls, keypoints...], n (B,)). The frames normalised and
    forwarded, the boxes and the keypoints decoded (decode_kpts: letterbox
    pixels, the visibility a sigmoid when nd = 3), the keypoints carried
    through NMS with extras (each anchor's best class; the greedy keep
    kernel). The network in bf16 with `half`. Rows past n hold zeros."""
    model = model.set_dtype(torch.bfloat16 if half else torch.float32)

    @torch.inference_mode()
    @full_f32()
    def fn(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats, kpt_raw = model(nchw(normalize(frames)))
        kpts = decode_kpts(kpt_raw, model.kpt_shape, [tuple(b.shape[-2:]) for b, _ in feats], model.stride)
        preds = torch.cat([decode_detections(feats, model.nc, model.stride), kpts.flatten(2)], -1)
        return non_max_suppression_extras(preds, conf_thres=conf, iou_thres=iou, nc=model.nc, max_det=max_det,
                                          pre_nms_topk=pre_nms_topk)

    return fn


def build_obb_fn(model: DetectionModel, conf: float = CONF_THRES, iou: float = IOU_THRES, max_det: int = MAX_DET,
                 pre_nms_topk: int = 1024, half: bool = False) -> Callable:
    """The device function of an obb predict or val batch (JAX's
    OBBPredictor and OBBValidator device functions, engine/predictor.py:546,
    engine/validator.py:660): fn(uint8 (B, S, S, 1|3) letterboxed BGR frames
    on the model's device) -> (out (B, max_det, 7) [cx, cy, w, h, angle,
    conf, cls], n (B,)). The frames normalised and forwarded, the rotated
    boxes decoded (decode_obb: letterbox pixels, radians), then Fast-NMS
    over probiou (nms_rotated: each anchor's best class, class-agnostic); the
    greedy keep kernel does not run. The network in bf16 with `half`. Rows
    past n hold zeros."""
    model = model.set_dtype(torch.bfloat16 if half else torch.float32)

    @torch.inference_mode()
    @full_f32()
    def fn(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats, angle_raw = model(nchw(normalize(frames)))
        preds = decode_obb(feats, angle_raw, model.nc, model.stride)
        return nms_rotated(preds, conf_thres=conf, iou_thres=iou, nc=model.nc, max_det=max_det,
                           pre_nms_topk=pre_nms_topk)

    return fn


def normalize(frames: torch.Tensor) -> torch.Tensor:
    """uint8 (B, S, S, 1|3) BGR frames -> f32 (B, S, S, 3) RGB in [0, 1]: the
    gray broadcast, BGR -> RGB and / 255 of JAX's _norm_on_device."""
    return frames.expand(-1, -1, -1, 3).flip(-1).float() / 255.0


def nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of NHWC images, channels_last in memory on the card."""
    x = x.permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x


TTA_PASSES = ((1.0, False), (0.83, True), (0.67, False))  # (scale, left-right flip), JAX's run_tta
TTA_PAD = 0.447  # the pad value of a scaled pass (JAX's scale_img: the imagenet mean gray)


def tta_input(x: torch.Tensor, si: float, flip: bool, gs: int) -> torch.Tensor:
    """One TTA pass's network input from normalised NHWC frames (B, S, S, 3):
    flipped left-right with `flip`; at a scale other than 1 resized to
    int(S * si) (bilinear with antialiasing, as jax.image.resize shrinks) and
    padded right and bottom with TTA_PAD up to ceil(S * si / gs) * gs. NCHW."""
    x = nchw(x.flip(2) if flip else x)
    if si != 1.0:
        s = x.shape[2]
        s_new, pad_to = int(s * si), math.ceil(s * si / gs) * gs
        x = F.interpolate(x, size=(s_new, s_new), mode="bilinear", align_corners=False, antialias=True)
        x = F.pad(x, (0, pad_to - s_new, 0, pad_to - s_new), value=TTA_PAD)
        x = x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x
    return x


def tta_predictions(model: DetectionModel, x: torch.Tensor) -> torch.Tensor:
    """Decoded predictions (B, A', 4 + nc) of JAX's run_tta (engine/predictor.py:
    134-174) for normalised NHWC frames x (B, S, S, 3): each pass of
    TTA_PASSES forwarded and decoded, its boxes divided by its scale and
    un-flipped (x -> S - x), the 1.0 pass cut to its first two levels' anchors
    and the 0.67 pass's first level dropped (by the first two levels' counts
    whatever the level count, as JAX's code), concatenated along the anchors.
    The resize and pad run in f32 whatever the network's dtype."""
    gs, s = int(max(model.stride)), x.shape[1]
    merged = []
    for si, flip in TTA_PASSES:
        feats = model(tta_input(x, si, flip, gs))
        p = decode_detections(feats, model.nc, model.stride)
        xywh = p[..., :4] / torch.tensor(si, device=p.device)  # an IEEE division, as XLA's
        if flip:
            xywh = torch.cat([s - xywh[..., :1], xywh[..., 1:]], -1)
        p = torch.cat([xywh, p[..., 4:]], -1)
        counts = [b.shape[-2] * b.shape[-1] for b, _ in feats]
        if si == 1.0:
            p = p[:, : counts[0] + counts[1]]  # drop the P5 tail
        elif si == 0.67:
            p = p[:, counts[0]:]  # drop the P3 head
        merged.append(p)
    return torch.cat(merged, 1)


def build_ensemble_fn(models: Sequence[DetectionModel], conf: float = CONF_THRES, iou: float = IOU_THRES,
                      max_det: int = MAX_DET, classes: Optional[Sequence[int]] = None,
                      agnostic: bool = False) -> Callable:
    """The device function of a weight ensemble (JAX's EnsemblePredictor,
    engine/predictor.py:420-460): fn(uint8 (B, S, S, 1|3) letterboxed frames)
    -> (out (B, max_det, 6), n (B,)): the frames normalised, each member's
    forward decoded with its own strides, the predictions concatenated along
    the anchors in member order, one NMS (best class per anchor, its default
    pre_nms_topk 1024, as JAX's passes none). Each member runs in its own
    dtype (the predictor hands bf16 copies with half=True)."""
    classes = None if classes is None else [classes] if isinstance(classes, int) else list(classes)
    nc = models[0].nc

    @torch.inference_mode()
    @full_f32()
    def fn(frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = nchw(normalize(frames))
        preds = torch.cat([decode_detections(m(x), nc, m.stride) for m in models], 1)
        return non_max_suppression(preds, conf_thres=conf, iou_thres=iou, nc=nc, multi_label=False,
                                   agnostic=agnostic, max_det=max_det, classes=classes)

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
