"""Detection validator: mAP of a model over a dataset split.

Counterpart of spectrogram_yolov11_tpu/engine/validator.py:67
DetectionValidator (the non-end2end device function :113-121, init_metrics,
update_stats :132, get_metrics :209, get_dataloader :241, __call__ :251) and
its helpers _unletterbox_boxes :43 and _gt_native :53, with the reference's
protocol: NMS over every (anchor, class) pair at conf 0.001, iou 0.7,
max_det 300, pre_nms_topk 2048; detections and ground truth un-letterboxed
to each image's own pixels by its ratio_pad, then greedy TP matching at 10
IoU thresholds and AP per class (ops/metrics.py).

Per batch: worker threads read and decode the images and format the labels
(data/build.py), the card letterboxes the frames (scaleup=False), the device
function runs the forward with the fused bottleneck kernel, the DFL decode
and NMS with the greedy keep kernel (engine/pipeline.py:build_device_fn), and
the host un-letterboxes and accumulates the stats in numpy. The un-letterbox
keeps the JAX package's f32 arithmetic: the device output is f32, and the
ratio and pads are Python floats of the f32 ratio_pad.

half=True runs a bf16 copy of the model (DetectionModel.set_dtype), as the
JAX validator's set_dtype(bfloat16), and leaves the caller's f32 model as it
is. `split` picks the dataset split scored (data[split], "val" by default;
the JAX validator always scores "val"). The JAX validator's data-parallel
mesh branch is not ported here (DDP is ROADMAP.md §1 item 12); plots=True
and save_json=True raise, and so the confusion matrix, which only the plots
read, is not filled.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..cfg import DEFAULT_CFG_DICT, get_cfg
from ..data.augment import letterbox_batch
from ..data.build import DataLoader
from ..data.dataset import YOLODataset, check_det_dataset
from ..nn.tasks import DetectionModel
from ..ops.metrics import DetMetrics, box_iou_np, match_predictions
from ..utils import not_ported, resolve_device
from ..utils.callbacks import run_callbacks
from .pipeline import build_device_fn

VAL_PRE_NMS_TOPK = 2048


def _unletterbox_boxes(det: np.ndarray, ratio: float, dw: float, dh: float, ow: int, oh: int) -> np.ndarray:
    """Detections (n, 6) in the letterboxed frame -> the image's own pixels, in place, clipped to it."""
    if len(det):
        det[:, [0, 2]] -= dw
        det[:, [1, 3]] -= dh
        det[:, :4] /= ratio
        det[:, [0, 2]] = det[:, [0, 2]].clip(0, ow)
        det[:, [1, 3]] = det[:, [1, 3]].clip(0, oh)
    return det


def _gt_native(batch: dict, i: int, imgsz: int) -> tuple:
    """The ground truth of image i in its own pixels -> (cls int, xyxy)."""
    m = batch["mask_gt"][i]
    ratio, dw, dh = (float(x) for x in batch["ratio_pad"][i])
    gt_cls = batch["cls"][i][m].astype(int)
    g = batch["bboxes"][i][m] * imgsz
    gxyxy = np.stack([g[:, 0] - g[:, 2] / 2, g[:, 1] - g[:, 3] / 2, g[:, 0] + g[:, 2] / 2, g[:, 1] + g[:, 3] / 2], 1)
    if len(gxyxy):
        gxyxy[:, [0, 2]] -= dw
        gxyxy[:, [1, 3]] -= dh
        gxyxy /= ratio
    return gt_cls, gxyxy


class DetectionValidator:
    """validator(data) -> results_dict of P, R, mAP50, mAP50-95 and fitness."""

    def __init__(self, model: DetectionModel, overrides: Optional[dict] = None):
        args = get_cfg(DEFAULT_CFG_DICT, {"mode": "val", **(overrides or {})})
        args.conf = 0.001 if args.conf is None else args.conf
        if args.plots:
            raise not_ported("plots=True (PR curves and confusion matrix plots, utils/plotting.py)",
                              "item 8 (validator: val plots)")
        if args.save_json:
            raise not_ported("save_json=True (COCO-protocol JSON and eval, ops/cocoeval.py)",
                              "item 8 (validator: save_json)")
        self.args = args
        self.device = resolve_device(args.device or "cuda")
        fmt = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        self.model = model.set_dtype(torch.bfloat16 if args.half else torch.float32).to(self.device, memory_format=fmt)
        self.imgsz = int(args.imgsz if isinstance(args.imgsz, int) else args.imgsz[0])
        self.dataloader: Optional[DataLoader] = None
        self.iouv = np.linspace(0.5, 0.95, 10)
        self.names = dict(getattr(model, "names", None) or {})
        self._device_fn = None
        self.data: Optional[dict] = None
        self.speed = {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}
        self.callbacks: dict = {}

    def _build_device_fn(self):
        a = self.args
        return build_device_fn(self.model, conf=float(a.conf), iou=float(a.iou), max_det=int(a.max_det),
                               agnostic=bool(a.agnostic_nms or a.single_cls),
                               pre_nms_topk=int(a.pre_nms_topk or 0) or VAL_PRE_NMS_TOPK, half=bool(a.half),
                               multi_label=True)

    def init_metrics(self) -> None:
        self.stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}

    def update_stats(self, out: tuple, batch: dict, i: int) -> None:
        """Image i of a batch: its detections (out, n_valid on the host) and
        ground truth in its own pixels, and the TP matrix at 10 IoU thresholds."""
        out_np, nv = out
        n = int(nv[i])
        det = out_np[i, :n, :6].copy()
        ori_h, ori_w = (int(x) for x in batch["ori_shape"][i])
        ratio, dw, dh = (float(x) for x in batch["ratio_pad"][i])
        det = _unletterbox_boxes(det, ratio, dw, dh, ori_w, ori_h)
        gt_cls, gxyxy = _gt_native(batch, i, self.imgsz)
        self.stats["target_cls"].append(gt_cls)
        if n == 0:
            self.stats["tp"].append(np.zeros((0, 10), bool))
            self.stats["conf"].append(np.zeros(0))
            self.stats["pred_cls"].append(np.zeros(0))
            return
        iou = box_iou_np(gxyxy, det[:, :4]) if len(gt_cls) else np.zeros((0, n))
        tp = match_predictions(det[:, 5].astype(int), gt_cls, iou, self.iouv) if len(gt_cls) else np.zeros((n, 10), bool)
        self.stats["tp"].append(tp)
        self.stats["conf"].append(det[:, 4])
        self.stats["pred_cls"].append(det[:, 5])

    def get_metrics(self) -> DetMetrics:
        metrics = DetMetrics(names=self.names)
        if self.stats["conf"]:
            metrics.process(np.concatenate(self.stats["tp"]), np.concatenate(self.stats["conf"]),
                            np.concatenate(self.stats["pred_cls"]), np.concatenate(self.stats["target_cls"]))
        return metrics

    def get_dataloader(self, img_path, batch_size: int) -> DataLoader:
        ds = YOLODataset(img_path, imgsz=self.imgsz, max_gt=256, single_cls=self.args.single_cls)
        return DataLoader(ds, batch_size=batch_size, workers=self.args.workers)

    def preprocess(self, batch: dict) -> torch.Tensor:
        """The batch's frames letterboxed on the device: (B, imgsz, imgsz, 1|3) uint8 BGR."""
        return letterbox_batch(batch["img"], self.imgsz, self.device, scaleup=False)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, data=None) -> Dict[str, float]:
        run_callbacks(self.callbacks, "on_val_start", self)
        args = self.args
        self.data = check_det_dataset(data or args.data)
        self.names = self.data["names"]
        if not self.data.get(args.split):
            raise KeyError(f"dataset has no '{args.split}' split")
        self.dataloader = self.get_dataloader(self.data[args.split], int(args.batch))
        if self._device_fn is None:
            self._device_fn = self._build_device_fn()
        self.init_metrics()
        n_img = 0
        t = {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}
        for batch in self.dataloader:
            run_callbacks(self.callbacks, "on_val_batch_start", self)
            t0 = time.perf_counter()
            frames = self.preprocess(batch)
            self._sync()
            t1 = time.perf_counter()
            out, nv = self._device_fn(frames)
            out = (out.cpu().numpy(), nv.cpu().numpy())
            t2 = time.perf_counter()
            for i in range(int(batch["n_valid"])):
                self.update_stats(out, batch, i)
            n_img += int(batch["n_valid"])
            t3 = time.perf_counter()
            for k, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2)):
                t[k] += dt
            run_callbacks(self.callbacks, "on_val_batch_end", self)
        self.speed = {k: v / max(n_img, 1) * 1e3 for k, v in t.items()}
        self.metrics = self.get_metrics()
        self.metrics.speed.update(self.speed)
        res_dict = self.metrics.results_dict
        run_callbacks(self.callbacks, "on_val_end", self)
        return res_dict
