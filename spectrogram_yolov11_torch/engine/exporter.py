"""The serving graph. Counterpart of spectrogram_yolov11_tpu/engine/exporter.py:51
build_inference_fn, detect branch: the graph the KServe-v2 server
(serve.py) and the checkpoint AutoBackend (nn/autobackend.py) run.

Its input contract is the exporter's: uint8 NHWC **RGB** frames, with no flip
on the device (the predictor's device function, engine/pipeline.py, flips BGR
frames; a client of this graph flips on its side, serve.py:_remote_forward).
The port builds detect models only, so the other heads' branches of the JAX
function (:76-119) have no counterpart here (ROADMAP.md §1 items 10 and 11);
the Exporter class (the artifact formats) is not ported (item 9).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..nn.tasks import DetectionModel
from ..ops.nms import non_max_suppression
from ..utils import full_f32
from .pipeline import forward_decode


def build_inference_fn(model: DetectionModel, *, nms: bool = False, conf: float = 0.25, iou: float = 0.7,
                       max_det: int = 300) -> Callable:
    """fn(uint8 (B, H, W, 3) RGB frames on the model's device) ->
    nms=False: decoded predictions (B, A, 4 + nc) f32 (xywh, class scores);
    nms=True: (det (B, max_det, 6), n_valid (B,)), rows [x1, y1, x2, y2,
    conf, cls], by the port's NMS at conf, iou and max_det.
    The network runs in the model's dtype (f32, or bf16 for a copy from
    set_dtype); the predictions are f32 either way."""

    @torch.inference_mode()
    @full_f32()
    def fn(imgs: torch.Tensor):
        preds = forward_decode(model, imgs)
        if nms:
            return non_max_suppression(preds, conf_thres=conf, iou_thres=iou, nc=model.nc, max_det=max_det)
        return preds

    return fn
