"""The serving graph. Counterpart of spectrogram_yolov11_tpu/engine/exporter.py:51
build_inference_fn: the graph the KServe-v2 server (serve.py) and the
checkpoint AutoBackend (nn/autobackend.py) run, for the detect, segment,
pose, obb and classify tasks.

Its input contract is the exporter's: uint8 NHWC **RGB** frames, with no flip
on the device (the predictor's device function, engine/pipeline.py, flips BGR
frames; a client of this graph flips on its side, serve.py:_remote_forward).
Its outputs are JAX's table (:58-66), in JAX's layouts:

    task      nms=False                              nms=True
    classify  probs (B, nc)                          the same
    detect    preds (B, A, 4 + nc)                   det (B, max_det, 6), n_valid (B,)
    segment   preds + coefficients (B, A, 4+nc+nm),  det (B, max_det, 6), n_valid,
              prototypes (B, H/4, W/4, nm) NHWC      masks (B, max_det, H/4, W/4)
    pose      preds + keypoints (B, A, 4+nc+nk*nd)   det + keypoints (B, max_det, 6+nk*nd), n_valid
    obb       rboxes (B, A, 5 + nc)                  det (B, max_det, 7), n_valid
    v10/e2e   det (B, max_det, 6), n_valid           the same (the NMS-free head)

The segment masks are sigmoid(coefficients @ prototypes) cropped to their
boxes (ops/masks.py:crop_masks_device), the pose keypoints decode_kpts'
(input pixels), the NMS of detect, segment and pose the greedy keep kernel's
(ops/nms.py), OBB's Fast-NMS over probiou (nms_rotated, no keep kernel).
An end2end (v10) model gives its NMS-free rows with either setting, n_valid
the rows above conf (JAX :78-83: engine/pipeline.py:e2e_detections, no keep
kernel). The world branch is another model family (ROADMAP.md §1 item 11);
the Exporter class (the artifact formats) is not ported (item 9).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..nn.tasks import DetectionModel
from ..ops.decode import decode_detections, decode_kpts, decode_obb
from ..ops.masks import crop_masks_device
from ..ops.nms import nms_rotated, non_max_suppression, non_max_suppression_extras
from ..utils import full_f32
from .pipeline import e2e_detections, forward_decode, nchw


def build_inference_fn(model: DetectionModel, *, nms: bool = False, conf: float = 0.25, iou: float = 0.7,
                       max_det: int = 300) -> Callable:
    """fn(uint8 (B, H, W, 3) RGB frames on the model's device) -> the task's
    outputs of the module docstring's table, f32 (bf16 probs upcast), by
    the port's NMS at conf, iou and max_det with nms=True. The network runs
    in the model's dtype (f32, or bf16 for a copy from set_dtype)."""
    task = model.task

    @torch.inference_mode()
    @full_f32()
    def fn(imgs: torch.Tensor):
        if model.end2end:
            det = e2e_detections(model, imgs, max_det)
            return det, (det[..., 4] > conf).sum(-1).int()
        if task == "detect":
            preds = forward_decode(model, imgs)
            if nms:
                return non_max_suppression(preds, conf_thres=conf, iou_thres=iou, nc=model.nc, max_det=max_det)
            return preds
        out = model(nchw(imgs.float() / 255.0))
        if task == "classify":
            return torch.softmax(out, -1).float()
        nms_kw = dict(conf_thres=conf, iou_thres=iou, nc=model.nc, max_det=max_det)
        if task == "segment":
            feats, mc, proto = out
            preds = torch.cat([decode_detections(feats, model.nc, model.stride), mc.float()], -1)
            if not nms:
                return preds, proto.float().permute(0, 2, 3, 1)
            det, nv = non_max_suppression_extras(preds, **nms_kw)
            masks = torch.sigmoid(torch.einsum("bdk,bkhw->bdhw", det[..., 6:], proto.float()))
            return det[..., :6], nv, crop_masks_device(masks, det[..., :4], imgs.shape[1:3])
        if task == "pose":
            feats, kpt_raw = out
            kpts = decode_kpts(kpt_raw, model.kpt_shape, [tuple(b.shape[-2:]) for b, _ in feats], model.stride)
            preds = torch.cat([decode_detections(feats, model.nc, model.stride), kpts.flatten(2)], -1)
            return non_max_suppression_extras(preds, **nms_kw) if nms else preds
        if task == "obb":
            preds = decode_obb(*out, model.nc, model.stride)
            return nms_rotated(preds, **nms_kw) if nms else preds
        raise ValueError(f"no serving graph for the {task} task")

    return fn
