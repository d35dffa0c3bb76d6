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
the host un-letterboxes and accumulates the stats in numpy. BackendValidator
scores through an AutoBackend instead, a served model among them: the
backend's graph, the val NMS on the validator's device. The un-letterbox
keeps the JAX package's f32 arithmetic: the device output is f32, and the
ratio and pads are Python floats of the f32 ratio_pad.

half=True runs a bf16 copy of the model (DetectionModel.set_dtype), as the
JAX validator's set_dtype(bfloat16), and leaves the caller's f32 model as it
is. `split` picks the dataset split scored (data[split], "val" by default;
the JAX validator always scores "val"). The JAX validator's data-parallel
mesh branch is not ported here (DDP is ROADMAP.md §1 item 12).

plots=True, the default as in JAX, fills the confusion matrix (ops/metrics.py
ConfusionMatrix, JAX :127, :148-149, :156-157) and after the loop writes
PR_curve.png, F1_curve.png, P_curve.png, R_curve.png,
confusion_matrix_normalized.png and confusion_matrix.png (utils/plotting.py;
JAX _plot_curves :220-235) into the run directory (get_save_dir, name "val",
or `save_dir`); a failed plot is logged as a warning and does not fail the
run, as in JAX. save_json=True keeps COCO rows of each image's detections
and ground truth in its own pixels (_pred_to_json / _gt_to_json, JAX
:159-183; image_id the file's stem, an int when it is numeric), writes
predictions.json and annotations.json there, runs ops/cocoeval.py over them
(_save_json :185-207) and adds `metrics/coco_<key>` to the results (:308-310).
Both hold for BackendValidator too. JAX asks get_save_dir anew for the plots
and for the JSON, so an incremented run directory splits them in two
(val, val2); the port asks once per call and writes both into one directory.

SegmentationValidator is JAX's (:410-520) for the segment task: box and
mask mAP. Its device function (engine/pipeline.py:build_segment_fn) adds
each detection's mask, sigmoid(coefficients @ prototypes) > 0.5 cropped to
its box, at the prototypes' resolution (S / 4); only each image's first
n_valid masks leave the card. The mask TP matrix matches them by mask IoU
against the index-encoded ground truth at the same resolution (the val
dataset's `masks`). With save_json each mask is un-letterboxed to the
image's own size (_unletterbox_mask: the letterboxed region cropped,
resized as cv2's float INTER_LINEAR, ops/masks.py:resize_linear_f32, and
thresholded at 0.5), RLE-encoded into the rows, and the COCO protocol runs
for "segm" too, its keys suffixed (M).

PoseValidator is JAX's (:530-650) for the pose task: box and keypoint
(OKS) mAP. Its device function (engine/pipeline.py:build_pose_fn) carries
each detection's decoded keypoints through NMS at pre_nms_topk 2048. Per
image the predicted and ground-truth keypoints are un-letterboxed to its
own pixels ((xy - pad) / ratio, the ground truth from the val dataset's
normalised `keypoints`), and the keypoint TP matrix matches them by OKS
(ops/iou.py:kpt_iou, over the ground truth's visible points) with each
ground truth's area its box's times 0.53, and OKS_SIGMA at (17, 3)
keypoints, 1 / nk otherwise. A model whose kpt_shape is not the data's
raises JAX's ValueError. With save_json the rows carry the keypoints
([x, y, score] * nk rounded to 3 decimals; the ground truth's visibility
as 2 or 0, `num_keypoints` and area 0.53 x its box's), and the COCO
protocol runs for "keypoints" too (ops/cocoeval.py, the same sigmas), its
keys suffixed (P).

OBBValidator is JAX's (:655-715) for the obb task: rotated-box mAP. Its
device function (engine/pipeline.py:build_obb_fn) decodes the rotated boxes
and runs Fast-NMS over probiou (ops/nms.py:nms_rotated, each anchor's best
class, pre_nms_topk 2048); the greedy keep kernel does not run. Per image
the detections and the ground truth (the val dataset's normalised cx, cy,
w, h and angle) are un-letterboxed to its own pixels ((xy - pad) / ratio,
wh / ratio, unclipped) and the TP matrix matches them by probiou
(ops/iou.py:batch_probiou); the metrics are OBBMetrics. As in JAX, the
confusion matrix stays empty and save_json writes nothing: JAX's
update_stats keeps no COCO rows for rotated boxes, so predictions.json,
annotations.json and the coco keys are not written (ROADMAP.md §3.38).

ClassificationValidator is JAX's (:719-760) for the classify task: top-1
and top-5 accuracy (k = min(5, nc)) over the data's val/ folder (the folder
itself when it has none; `data` is the dataset's root), the val samples'
short-side resize and centre crop (data/dataset.py:ClassificationDataset),
each batch uploaded as uint8 RGB, / 255, forwarded in eval (C3k's
bottlenecks on the fused kernel) and its top-k indices taken on the device;
the padded tail trimmed by n_valid. As JAX's, it reads no `half` (the model
runs at its own dtype), its imgsz is the args' (640 unless given: the
trainer passes its 224), and it writes no plots or JSON.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..cfg import DEFAULT_CFG_DICT, get_cfg, get_save_dir
from ..data.augment import letterbox_batch
from ..data.build import DataLoader
from ..data.dataset import ClassificationDataset, YOLODataset, check_det_dataset
from ..nn.tasks import DetectionModel
from ..ops.iou import batch_probiou, kpt_iou, mask_iou
from ..ops.masks import resize_linear_f32
from ..ops.metrics import (OKS_SIGMA, ClassifyMetrics, ConfusionMatrix, DetMetrics, OBBMetrics, PoseMetrics,
                           SegmentMetrics, box_iou_np, match_predictions)
from ..ops.nms import non_max_suppression
from ..utils import LOGGER, full_f32, resolve_device
from ..utils.callbacks import run_callbacks
from .pipeline import build_device_fn, build_obb_fn, build_pose_fn, build_segment_fn, eval_network, nchw

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
        self.args = args
        self.device = resolve_device(args.device or "cuda")
        self.set_model(model)
        self.imgsz = int(args.imgsz if isinstance(args.imgsz, int) else args.imgsz[0])
        self.dataloader: Optional[DataLoader] = None
        self.iouv = np.linspace(0.5, 0.95, 10)
        self.names = dict(getattr(model, "names", None) or {})
        self.data: Optional[dict] = None
        self.speed = {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}
        self.callbacks: dict = {}

    def set_model(self, model: DetectionModel) -> None:
        """Score `model` from the next call on (a trainer's EMA, each epoch):
        its eval network is made now, a bf16 copy where the validator runs
        bf16, so a copy made earlier never scores stale weights."""
        self.source = model
        self.model, self._device_fn = eval_network(model, bool(self.args.half), self.device), None

    def _build_device_fn(self):
        a = self.args
        return build_device_fn(self.model, conf=float(a.conf), iou=float(a.iou), max_det=int(a.max_det),
                               agnostic=bool(a.agnostic_nms or a.single_cls),
                               pre_nms_topk=int(a.pre_nms_topk or 0) or VAL_PRE_NMS_TOPK,
                               half=self.model.dtype == torch.bfloat16, multi_label=True)

    def init_metrics(self) -> None:
        self.stats = {"tp": [], "conf": [], "pred_cls": [], "target_cls": []}
        nc = self.model.nc if self.model is not None else self.nc  # a backend's: its class count
        self.confusion_matrix = ConfusionMatrix(nc=nc, conf=self.args.conf)
        self.jdict: list = []  # COCO rows of the detections, with save_json
        self.gt_jdict: list = []  # and of the ground truth
        self._cur_im_file = ""

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
        if self.args.save_json:
            self._pred_to_json(det)
            self._gt_to_json(gt_cls, gxyxy)
        self.stats["target_cls"].append(gt_cls)
        if n == 0:
            self.stats["tp"].append(np.zeros((0, 10), bool))
            self.stats["conf"].append(np.zeros(0))
            self.stats["pred_cls"].append(np.zeros(0))
            if len(gt_cls) and self.args.plots:
                self.confusion_matrix.process_batch(None, gxyxy, gt_cls)
            return
        iou = box_iou_np(gxyxy, det[:, :4]) if len(gt_cls) else np.zeros((0, n))
        tp = match_predictions(det[:, 5].astype(int), gt_cls, iou, self.iouv) if len(gt_cls) else np.zeros((n, 10), bool)
        self.stats["tp"].append(tp)
        self.stats["conf"].append(det[:, 4])
        self.stats["pred_cls"].append(det[:, 5])
        if self.args.plots:
            self.confusion_matrix.process_batch(det, gxyxy, gt_cls)

    def _image_id(self):
        stem = Path(str(self._cur_im_file)).stem
        return int(stem) if stem.isnumeric() else stem

    def _pred_to_json(self, det: np.ndarray) -> None:
        """COCO rows of the current image's detections (JAX :159): xyxy -> top-left xywh."""
        image_id = self._image_id()
        for x1, y1, x2, y2, conf, cls in det.tolist():
            self.jdict.append({"image_id": image_id, "category_id": int(cls),
                               "bbox": [round(v, 3) for v in (x1, y1, x2 - x1, y2 - y1)],
                               "score": round(float(conf), 5)})

    def _gt_to_json(self, gt_cls: np.ndarray, gxyxy: np.ndarray) -> None:
        """COCO rows of the current image's ground truth (JAX :172)."""
        image_id = self._image_id()
        for c, (x1, y1, x2, y2) in zip(gt_cls.tolist(), gxyxy.tolist()):
            self.gt_jdict.append({"image_id": image_id, "category_id": int(c), "bbox": [x1, y1, x2 - x1, y2 - y1],
                                  "iscrowd": 0})

    def _save_json(self, save_dir: Path) -> dict:
        """predictions.json and annotations.json under save_dir, and the COCO
        protocol's stats over them (JAX :185-207)."""
        from ..ops.cocoeval import COCOeval

        save_dir.mkdir(parents=True, exist_ok=True)
        pred_path = save_dir / "predictions.json"
        pred_path.write_text(json.dumps(self.jdict))
        (save_dir / "annotations.json").write_text(json.dumps(self.gt_jdict))
        LOGGER.info(f"predictions saved to {pred_path} ({len(self.jdict)} detections)")
        stats = {}
        if self.gt_jdict:
            stats = COCOeval(self.gt_jdict, self.jdict).evaluate().stats
            LOGGER.info("COCO protocol: AP {AP:.4f}  AP50 {AP50:.4f}  AP75 {AP75:.4f}".format(**stats))
        return stats

    def _plot_curves(self, save_dir: Path) -> None:
        """The PR, F1, P and R curves and both confusion matrices under
        save_dir (JAX :220-235); a failure is logged, not raised."""
        from ..utils.plotting import plot_confusion_matrix, plot_val_curves

        try:
            plot_val_curves(self.metrics, self.names, save_dir)
            plot_confusion_matrix(self.confusion_matrix.matrix, self.names, save_dir, normalize=True)
            plot_confusion_matrix(self.confusion_matrix.matrix, self.names, save_dir, normalize=False)
            LOGGER.info(f"val plots saved to {save_dir}")
        except Exception as e:  # plotting must never fail a val run
            LOGGER.warning(f"val plotting failed: {e}")

    def get_metrics(self) -> DetMetrics:
        metrics = DetMetrics(names=self.names)
        if self.stats["conf"]:
            metrics.process(np.concatenate(self.stats["tp"]), np.concatenate(self.stats["conf"]),
                            np.concatenate(self.stats["pred_cls"]), np.concatenate(self.stats["target_cls"]))
        return metrics

    task = "detect"

    def get_dataloader(self, img_path, batch_size: int) -> DataLoader:
        ds = YOLODataset(img_path, imgsz=self.imgsz, max_gt=256, single_cls=self.args.single_cls, task=self.task,
                         mask_ratio=int(self.args.mask_ratio), kpt_shape=self.data.get("kpt_shape", (17, 3)))
        return DataLoader(ds, batch_size=batch_size, workers=self.args.workers)

    def to_host(self, out: tuple) -> tuple:
        """The device function's outputs on the host, as numpy."""
        return tuple(t.cpu().numpy() for t in out)

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
        # trained since this validator was built: score its weights as they are now
        if self.source is not None and self.source.training:
            self.set_model(self.source)
        if self._device_fn is None:
            self._device_fn = self._build_device_fn()
        self.init_metrics()
        n_img = 0
        t = {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}
        files = self.dataloader.dataset.im_files
        for batch in self.dataloader:
            run_callbacks(self.callbacks, "on_val_batch_start", self)
            t0 = time.perf_counter()
            frames = self.preprocess(batch)
            self._sync()
            t1 = time.perf_counter()
            out = self.to_host(self._device_fn(frames))
            t2 = time.perf_counter()
            for i in range(int(batch["n_valid"])):
                self._cur_im_file = files[n_img + i]
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
        if args.plots or (args.save_json and self.jdict):
            self.save_dir = get_save_dir(args, name="val")
        if args.plots:
            self._plot_curves(self.save_dir)
        if args.save_json and self.jdict:
            res_dict.update({f"metrics/coco_{k}": v for k, v in self._save_json(self.save_dir).items()})
        run_callbacks(self.callbacks, "on_val_end", self)
        return res_dict


class BackendValidator(DetectionValidator):
    """Validate through an AutoBackend (nn/autobackend.py), a served model
    among them. Counterpart of spectrogram_yolov11_tpu/engine/validator.py:364
    BackendValidator: the backend's graph gives the decoded predictions
    (B, A, 4 + nc); the val protocol's NMS runs on the validator's device
    (every (anchor, class) pair, agnostic as the validator sets it,
    pre_nms_topk 2048 unless set). The validator's frames are BGR (the
    predictor's device function flips them, engine/pipeline.py) and the
    serving graph takes RGB, so they are flipped before the backend's
    forward; the JAX val batch is RGB already and goes as it is.

    The class count is JAX's (:371-381): the backend's nc (a checkpoint's),
    else its first output's last dimension less 4, from one forward of a
    zero frame at imgsz; a served detect model's names give that width
    without the forward. A served segment, pose or OBB model is scored as
    JAX's scores it, as detect: its first output's columns past the boxes
    are all read as classes (the mask coefficients, the keypoints, the
    angle), against the data's boxes (ROADMAP.md §3.45). A served
    classifier raises ValueError: JAX's reads its probabilities as boxes
    and fails (§3.45). A served v10 model's NMS-free rows are read as
    decoded predictions too, as JAX's (end2end False, :386; §3.49)."""

    def __init__(self, backend, overrides: Optional[dict] = None):
        self.backend = backend
        super().__init__(None, overrides=overrides)
        if getattr(backend, "task", "detect") == "classify":
            raise ValueError(f"val of a served classifier ({backend.weights}): its probabilities have no boxes to "
                             "score (JAX's BackendValidator fails on them, ROADMAP.md §3.45); validate the "
                             "checkpoint with YOLO(ckpt).val")
        detect_nc = len(backend.names) if getattr(backend, "task", "detect") == "detect" else 0
        self.nc = getattr(backend, "nc", None) or detect_nc or self._probe_nc()

    def _probe_nc(self) -> int:
        """The class count JAX's BackendValidator reads off a backend without one: the last dimension of its
        first output for a zero frame at imgsz, less 4."""
        out = self.backend.forward(np.zeros((1, self.imgsz, self.imgsz, 3), np.uint8))
        out = out[0] if isinstance(out, (tuple, list)) else out
        return int(out.shape[-1]) - 4

    def set_model(self, model) -> None:
        """The backend holds the network: there is no model to score here."""
        self.source, self.model, self._device_fn = None, None, None

    def _build_device_fn(self):
        a, backend, dev, nc = self.args, self.backend, self.device, self.nc

        def fn(frames: torch.Tensor):
            out = backend.forward(frames.flip(-1))  # BGR -> RGB
            preds = out[0] if isinstance(out, (tuple, list)) else out
            preds = preds if torch.is_tensor(preds) else torch.tensor(preds)
            with torch.inference_mode():
                return non_max_suppression(preds.to(dev), conf_thres=float(a.conf), iou_thres=float(a.iou), nc=nc,
                                           multi_label=True, agnostic=bool(a.agnostic_nms or a.single_cls),
                                           max_det=int(a.max_det),
                                           pre_nms_topk=int(a.pre_nms_topk or 0) or VAL_PRE_NMS_TOPK)

        return fn


class SegmentationValidator(DetectionValidator):
    """validator(data) -> results_dict of box and mask P, R, mAP50, mAP50-95
    (the `(M)` keys) and fitness (their sum), JAX's SegmentationValidator
    (the module docstring)."""

    task = "segment"

    def _build_device_fn(self):
        a = self.args
        return build_segment_fn(self.model, conf=float(a.conf), iou=float(a.iou), max_det=int(a.max_det),
                                pre_nms_topk=int(a.pre_nms_topk or 0) or VAL_PRE_NMS_TOPK,
                                half=self.model.dtype == torch.bfloat16, binary=True)

    def to_host(self, out: tuple) -> tuple:
        """(out, n_valid, masks): each image's first n_valid masks, gathered on
        the card and copied in one transfer, as a list of (n, S / 4, S / 4) bool."""
        det, nv, masks = out
        nv = nv.cpu().numpy()
        packed = torch.cat([masks[i, : int(n)] for i, n in enumerate(nv)]).cpu().numpy()
        return det.cpu().numpy(), nv, np.split(packed, np.cumsum(nv)[:-1])

    def init_metrics(self) -> None:
        super().init_metrics()
        self.stats["tp_m"] = []

    @staticmethod
    def _unletterbox_mask(mask: np.ndarray, dw: float, dh: float, ow: int, oh: int, imgsz: int) -> np.ndarray:
        """A mask in the letterboxed frame at any resolution -> bool (oh, ow):
        the letterboxed region cropped (its offsets and size rounded at the
        mask's scale), resized as cv2's float INTER_LINEAR, > 0.5 (JAX :442)."""
        hm, wm = mask.shape
        sx, sy = wm / imgsz, hm / imgsz
        left, top = int(round(dw * sx)), int(round(dh * sy))
        w_c, h_c = max(1, int(round((imgsz - 2 * dw) * sx))), max(1, int(round((imgsz - 2 * dh) * sy)))
        crop = torch.from_numpy(np.ascontiguousarray(mask[top : top + h_c, left : left + w_c], np.float32))
        return resize_linear_f32(crop[None], oh, ow)[0].numpy() > 0.5

    def update_stats(self, out: tuple, batch: dict, i: int) -> None:
        """The box stats (DetectionValidator), then the mask TP matrix: mask
        IoU at the prototypes' resolution against the index-encoded ground
        truth (JAX :457-490); with save_json, the RLEs of the image's masks
        and ground truth in its own pixels for the JSON rows."""
        det, nv, masks = out
        n = int(nv[i])
        gt_inst = np.asarray(batch["masks"][i])
        n_gt = int(np.asarray(batch["mask_gt"][i]).sum())
        if self.args.save_json:
            from ..ops.cocoeval import rle_encode

            ori_h, ori_w = (int(x) for x in batch["ori_shape"][i])
            _, dw, dh = (float(x) for x in batch["ratio_pad"][i])
            self._cur_pred_rles = [rle_encode(self._unletterbox_mask(m, dw, dh, ori_w, ori_h, self.imgsz))
                                   for m in masks[i]]
            self._cur_gt_rles = [rle_encode(self._unletterbox_mask(gt_inst == j + 1, dw, dh, ori_w, ori_h, self.imgsz))
                                 for j in range(n_gt)]
        super().update_stats((det, nv), batch, i)
        gt_cls = self.stats["target_cls"][-1]
        if n == 0 or not len(gt_cls):
            self.stats["tp_m"].append(np.zeros((n, 10), bool))
            return
        m_gt = torch.from_numpy(np.stack([gt_inst == j + 1 for j in range(len(gt_cls))]).reshape(len(gt_cls), -1))
        iou = mask_iou(m_gt, torch.from_numpy(masks[i].reshape(n, -1))).numpy()
        self.stats["tp_m"].append(match_predictions(det[i, :n, 5].astype(int), gt_cls, iou, self.iouv))

    def _pred_to_json(self, det: np.ndarray) -> None:
        start = len(self.jdict)
        super()._pred_to_json(det)
        for row, rle in zip(self.jdict[start:], self._cur_pred_rles):
            row["segmentation"] = rle

    def _gt_to_json(self, gt_cls: np.ndarray, gxyxy: np.ndarray) -> None:
        start = len(self.gt_jdict)
        super()._gt_to_json(gt_cls, gxyxy)
        for row, rle in zip(self.gt_jdict[start:], self._cur_gt_rles):
            row["segmentation"] = rle

    def _save_json(self, save_dir: Path) -> dict:
        """The box protocol's stats, then the "segm" protocol's with the (M) suffix (JAX :504-515)."""
        from ..ops.cocoeval import COCOeval

        stats = super()._save_json(save_dir)
        if self.gt_jdict:
            m = COCOeval(self.gt_jdict, self.jdict, iou_type="segm").evaluate().stats
            LOGGER.info("COCO protocol (segm): AP {AP:.4f}  AP50 {AP50:.4f}".format(**m))
            stats.update({f"{k}(M)": v for k, v in m.items()})
        return stats

    def get_metrics(self) -> SegmentMetrics:
        metrics = SegmentMetrics(names=self.names)
        if self.stats["conf"]:
            metrics.process(np.concatenate(self.stats["tp"]), np.concatenate(self.stats["conf"]),
                            np.concatenate(self.stats["pred_cls"]), np.concatenate(self.stats["target_cls"]),
                            tp_m=np.concatenate(self.stats["tp_m"]))
        return metrics


class PoseValidator(DetectionValidator):
    """validator(data) -> results_dict of box and keypoint P, R, mAP50,
    mAP50-95 (the `(P)` keys) and fitness (their sum), JAX's PoseValidator
    (the module docstring)."""

    task = "pose"

    def set_model(self, model: DetectionModel) -> None:
        super().set_model(model)
        self.kpt_shape = tuple(getattr(model, "kpt_shape", (17, 3)))

    def _build_device_fn(self):
        a = self.args
        return build_pose_fn(self.model, conf=float(a.conf), iou=float(a.iou), max_det=int(a.max_det),
                             pre_nms_topk=int(a.pre_nms_topk or 0) or VAL_PRE_NMS_TOPK,
                             half=self.model.dtype == torch.bfloat16)

    def init_metrics(self) -> None:
        super().init_metrics()
        self.stats["tp_p"] = []

    def _sigmas(self) -> np.ndarray:
        nk = self.kpt_shape[0]
        return OKS_SIGMA if self.kpt_shape == (17, 3) else np.full(nk, 1.0 / nk)

    def update_stats(self, out: tuple, batch: dict, i: int) -> None:
        """The box stats (DetectionValidator), then the keypoint TP matrix:
        OKS of the image's keypoints in its own pixels against its ground
        truth's, the areas its boxes' times 0.53 (JAX :560-598)."""
        det, nv = out
        n = int(nv[i])
        dk = tuple(self.data.get("kpt_shape") or ()) if self.data else ()
        if dk and dk != self.kpt_shape:
            raise ValueError(
                f"model kpt_shape {self.kpt_shape} != dataset kpt_shape {dk}; build the model with the dataset's "
                "kpt_shape (train does this automatically; for standalone val pass a matching model/cfg)")
        ratio, dw, dh = (float(x) for x in batch["ratio_pad"][i])
        pk = det[i, :n, 6:].reshape(n, self.kpt_shape[0], (det.shape[-1] - 6) // self.kpt_shape[0]).copy()
        pk[..., 0] = (pk[..., 0] - dw) / ratio
        pk[..., 1] = (pk[..., 1] - dh) / ratio
        gk = batch["keypoints"][i][batch["mask_gt"][i]].copy()  # normalised, in the letterboxed frame
        gk[..., 0] = (gk[..., 0] * self.imgsz - dw) / ratio
        gk[..., 1] = (gk[..., 1] * self.imgsz - dh) / ratio
        self._cur_pred_kpts, self._cur_gt_kpts = pk, gk
        super().update_stats((det, nv), batch, i)
        gt_cls = self.stats["target_cls"][-1]
        if n == 0 or not len(gt_cls):
            self.stats["tp_p"].append(np.zeros((n, 10), bool))
            return
        _, gxyxy = _gt_native(batch, i, self.imgsz)
        area = (gxyxy[:, 2] - gxyxy[:, 0]) * (gxyxy[:, 3] - gxyxy[:, 1]) * 0.53
        iou = kpt_iou(torch.from_numpy(np.asarray(gk, np.float32)), torch.from_numpy(np.asarray(pk, np.float32)),
                      torch.from_numpy(np.asarray(area, np.float32)), self._sigmas()).numpy()
        self.stats["tp_p"].append(match_predictions(det[i, :n, 5].astype(int), gt_cls, iou, self.iouv))

    def _pred_to_json(self, det: np.ndarray) -> None:
        """The box rows with their keypoints, [x, y, score] * nk (score 1 when nd = 2), rounded to 3 decimals."""
        start = len(self.jdict)
        super()._pred_to_json(det)
        for row, kp in zip(self.jdict[start:], self._cur_pred_kpts):
            k = np.asarray(kp, float)
            score = k[:, 2] if k.shape[1] > 2 else np.ones(len(k))
            row["keypoints"] = np.stack([k[:, 0], k[:, 1], score], -1).reshape(-1).round(3).tolist()

    def _gt_to_json(self, gt_cls: np.ndarray, gxyxy: np.ndarray) -> None:
        """The ground truth's rows with their keypoints (visibility 2 where
        visible, else 0), num_keypoints, and area 0.53 x the box's, the factor
        of the OKS above (JAX :612-625)."""
        start = len(self.gt_jdict)
        super()._gt_to_json(gt_cls, gxyxy)
        for row, kp in zip(self.gt_jdict[start:], self._cur_gt_kpts):
            k = np.asarray(kp, float)
            vis = (k[:, 2] if k.shape[1] > 2 else np.ones(len(k))) > 0
            vis = vis.astype(float) * 2.0
            row["keypoints"] = np.stack([k[:, 0], k[:, 1], vis], -1).reshape(-1).round(3).tolist()
            row["num_keypoints"] = int((vis > 0).sum())
            row["area"] = 0.53 * row["bbox"][2] * row["bbox"][3]

    def _save_json(self, save_dir: Path) -> dict:
        """The box protocol's stats, then the "keypoints" protocol's with the (P) suffix (JAX :627-640)."""
        from ..ops.cocoeval import COCOeval

        stats = super()._save_json(save_dir)
        if self.gt_jdict:
            p = COCOeval(self.gt_jdict, self.jdict, iou_type="keypoints", kpt_sigmas=self._sigmas()).evaluate().stats
            LOGGER.info("COCO protocol (keypoints): AP {AP:.4f}  AP50 {AP50:.4f}".format(**p))
            stats.update({f"{k}(P)": v for k, v in p.items()})
        return stats

    def get_metrics(self) -> PoseMetrics:
        metrics = PoseMetrics(names=self.names)
        if self.stats["conf"]:
            metrics.process(np.concatenate(self.stats["tp"]), np.concatenate(self.stats["conf"]),
                            np.concatenate(self.stats["pred_cls"]), np.concatenate(self.stats["target_cls"]),
                            tp_p=np.concatenate(self.stats["tp_p"]))
        return metrics


class OBBValidator(DetectionValidator):
    """validator(data) -> results_dict of rotated-box P, R, mAP50, mAP50-95
    and fitness, JAX's OBBValidator (the module docstring)."""

    task = "obb"

    def _build_device_fn(self):
        a = self.args
        return build_obb_fn(self.model, conf=float(a.conf), iou=float(a.iou), max_det=int(a.max_det),
                            pre_nms_topk=int(a.pre_nms_topk or 0) or VAL_PRE_NMS_TOPK,
                            half=self.model.dtype == torch.bfloat16)

    def update_stats(self, out: tuple, batch: dict, i: int) -> None:
        """Image i: its rotated detections (n, 7) and ground truth (m, 5) in its
        own pixels, and the TP matrix by probiou at 10 thresholds (JAX :677-704)."""
        out_np, nv = out
        n = int(nv[i])
        ratio, dw, dh = (float(x) for x in batch["ratio_pad"][i])
        det = out_np[i, :n].copy()  # cx cy w h angle conf cls
        if n:
            det[:, 0] = (det[:, 0] - dw) / ratio
            det[:, 1] = (det[:, 1] - dh) / ratio
            det[:, 2:4] /= ratio
        m = batch["mask_gt"][i]
        gt_cls = batch["cls"][i][m].astype(int)
        g = batch["bboxes"][i][m].copy()  # normalised cx cy w h in the letterboxed frame, and the angle
        g[:, :4] *= self.imgsz
        g[:, 0] = (g[:, 0] - dw) / ratio
        g[:, 1] = (g[:, 1] - dh) / ratio
        g[:, 2:4] /= ratio
        self.stats["target_cls"].append(gt_cls)
        if n == 0:
            self.stats["tp"].append(np.zeros((0, 10), bool))
            self.stats["conf"].append(np.zeros(0))
            self.stats["pred_cls"].append(np.zeros(0))
            return
        if len(gt_cls):
            iou = batch_probiou(torch.from_numpy(np.ascontiguousarray(g, np.float32)),
                                torch.from_numpy(np.ascontiguousarray(det[:, :5], np.float32))).numpy()
            tp = match_predictions(det[:, 6].astype(int), gt_cls, iou, self.iouv)
        else:
            tp = np.zeros((n, 10), bool)
        self.stats["tp"].append(tp)
        self.stats["conf"].append(det[:, 5])
        self.stats["pred_cls"].append(det[:, 6])

    def get_metrics(self) -> OBBMetrics:
        metrics = OBBMetrics(names=self.names)
        if self.stats["conf"]:
            metrics.process(np.concatenate(self.stats["tp"]), np.concatenate(self.stats["conf"]),
                            np.concatenate(self.stats["pred_cls"]), np.concatenate(self.stats["target_cls"]))
        return metrics


class ClassificationValidator:
    """validator(data) -> results_dict of metrics/accuracy_top1,
    metrics/accuracy_top5 and fitness (the module docstring); `metrics` keeps
    the ClassifyMetrics."""

    task = "classify"

    def __init__(self, model: DetectionModel, overrides: Optional[dict] = None):
        self.args = get_cfg(DEFAULT_CFG_DICT, {"mode": "val", **(overrides or {})})
        self.device = resolve_device(self.args.device or "cuda")
        self.imgsz = int(self.args.imgsz if isinstance(self.args.imgsz, int) else self.args.imgsz[0])
        self.speed = {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}
        self.callbacks: dict = {}
        self.set_model(model)

    def set_model(self, model: DetectionModel) -> None:
        """Score `model` (at its own dtype, in eval mode, on the validator's device) from the next call on."""
        self.source, self.model = model, eval_network(model, False, self.device)

    def _topk(self, frames: torch.Tensor, k: int) -> torch.Tensor:
        """The top-k class indices (B, k) of uint8 (B, S, S, 3) RGB frames on the device."""
        with torch.inference_mode(), full_f32():
            return torch.topk(self.model(nchw(frames.float() / 255.0)), k, -1).indices

    def __call__(self, data=None) -> Dict[str, float]:
        run_callbacks(self.callbacks, "on_val_start", self)
        if self.source.training:  # trained since this validator was built
            self.set_model(self.source)
        root = Path(data or self.args.data)
        ds = ClassificationDataset(root / "val" if (root / "val").exists() else root, imgsz=self.imgsz)
        self.dataloader = DataLoader(ds, batch_size=int(self.args.batch), workers=self.args.workers)
        k = min(5, int(self.model.nc))  # top-5 caps at nc, as JAX's
        targets, top5, n_img = [], [], 0
        t = {"preprocess": 0.0, "inference": 0.0, "postprocess": 0.0}
        for batch in self.dataloader:
            run_callbacks(self.callbacks, "on_val_batch_start", self)
            t0 = time.perf_counter()
            frames = torch.from_numpy(np.stack(batch["img"])).to(self.device)
            t1 = time.perf_counter()
            nv = int(batch["n_valid"])
            top5.append(self._topk(frames, k)[:nv].cpu().numpy())
            targets.append(batch["cls"][:nv])
            t2 = time.perf_counter()
            n_img += nv
            for key, dt in zip(t, (t1 - t0, t2 - t1, 0.0)):
                t[key] += dt
            run_callbacks(self.callbacks, "on_val_batch_end", self)
        self.speed = {key: v / max(n_img, 1) * 1e3 for key, v in t.items()}
        m = ClassifyMetrics()
        m.process(np.concatenate(targets), np.concatenate(top5))
        m.speed.update(self.speed)
        self.metrics = m
        LOGGER.info(f"val[classify]: top1 {m.top1:.3f} top5 {m.top5:.3f}")
        run_callbacks(self.callbacks, "on_val_end", self)
        return m.results_dict
