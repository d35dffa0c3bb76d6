"""Detection and classification metrics on the host (numpy): TP matching at
10 IoU thresholds, the 101-point interpolated AP per class, the F1-max
operating point, the metric containers, the confusion matrix and top-1/top-5.

A copy of the detect, segment, pose, OBB and classify parts of
spectrogram_yolov11_tpu/ops/metrics.py (OKS_SIGMA :23, box_iou_np :29,
match_predictions :41, smooth :68, compute_ap :76, ap_per_class :86, Metric
:138, DetMetrics :202, SegmentMetrics :243, PoseMetrics :270, OBBMetrics :297,
ClassifyMetrics :301, ConfusionMatrix :328), which
reproduces the reference's mAP machinery; the port keeps its own copy because
it imports nothing of the JAX package. Accumulating stats over a dataset is
ragged host work, so it stays numpy here, and the results equal the JAX
module's exactly. fitness = 0.1 * mAP50 + 0.9 * mAP50-95.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# the COCO keypoints' OKS sigmas (JAX metrics.py:23): the pose loss and the
# pose validator use them when the data has 17 keypoints
OKS_SIGMA = (
    np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89])
    / 10.0
)


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Pairwise IoU (N,4) x (M,4) xyxy -> (N,M), numpy."""
    a1 = box1[:, None, :2]
    a2 = box1[:, None, 2:4]
    b1 = box2[None, :, :2]
    b2 = box2[None, :, 2:4]
    inter = np.clip(np.minimum(a2, b2) - np.maximum(a1, b1), 0, None).prod(-1)
    area1 = np.clip(box1[:, 2:4] - box1[:, :2], 0, None).prod(-1)
    area2 = np.clip(box2[:, 2:4] - box2[:, :2], 0, None).prod(-1)
    return inter / (area1[:, None] + area2[None] - inter + eps)


def match_predictions(
    pred_classes: np.ndarray,  # (n,)
    true_classes: np.ndarray,  # (m,)
    iou: np.ndarray,  # (m, n) GT x pred IoU
    iouv: np.ndarray,  # (T,) thresholds
) -> np.ndarray:
    """Greedy unique TP matrix (n, T) (reference: validator.py:224-264).

    For each threshold: consider class-consistent (gt, pred) pairs with
    iou >= thr, sort by IoU desc, match each GT and each pred at most once.
    """
    correct = np.zeros((pred_classes.shape[0], iouv.shape[0]), dtype=bool)
    correct_class = true_classes[:, None] == pred_classes[None, :]
    iou = np.where(correct_class, iou, 0.0)
    for i, thr in enumerate(iouv):
        matches = np.nonzero(iou >= thr)
        matches = np.array(matches).T  # (k, 2) [gt, pred]
        if matches.shape[0]:
            if matches.shape[0] > 1:
                order = iou[matches[:, 0], matches[:, 1]].argsort()[::-1]
                matches = matches[order]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing (reference: metrics.py:547)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """101-point interpolated AP (COCO style) (reference: metrics.py:605)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") else np.trapz(np.interp(x, mrec, mpre), x)
    return float(ap), mpre, mrec


def ap_per_class(
    tp: np.ndarray,  # (n, T) bool
    conf: np.ndarray,  # (n,)
    pred_cls: np.ndarray,  # (n,)
    target_cls: np.ndarray,  # (m,)
    eps: float = 1e-16,
) -> Dict[str, np.ndarray]:
    """Per-class AP at each IoU threshold + P/R/F1 at the F1-max operating
    point (reference: metrics.py:637-725)."""
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    x = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        i = pred_cls == c
        n_l, n_p = nt[ci], int(i.sum())
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[i]).cumsum(0)
        tpc = tp[i].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-x, -conf[i], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-x, -conf[i], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], _, _ = compute_ap(recall[:, j], precision[:, j])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = int(smooth(f1_curve.mean(0), 0.1).argmax())
    p, r, f1 = p_curve[:, i], r_curve[:, i], f1_curve[:, i]
    tp_count = (r * nt).round()
    fp_count = (tp_count / (p + eps) - tp_count).round()
    return {
        "tp": tp_count,
        "fp": fp_count,
        "p": p,
        "r": r,
        "f1": f1,
        "ap": ap,
        "unique_classes": unique_classes.astype(int),
        "p_curve": p_curve,
        "r_curve": r_curve,
        "f1_curve": f1_curve,
        "x": x,
    }


class Metric:
    """AP container (reference: metrics.py:726)."""

    def __init__(self):
        self.p = np.array([])
        self.r = np.array([])
        self.f1 = np.array([])
        self.all_ap = np.zeros((0, 10))
        self.ap_class_index = np.array([], dtype=int)
        self.nc = 0

    @property
    def ap50(self):
        return self.all_ap[:, 0] if len(self.all_ap) else np.array([])

    @property
    def ap(self):
        return self.all_ap.mean(1) if len(self.all_ap) else np.array([])

    @property
    def mp(self):
        return float(self.p.mean()) if len(self.p) else 0.0

    @property
    def mr(self):
        return float(self.r.mean()) if len(self.r) else 0.0

    @property
    def map50(self):
        return float(self.all_ap[:, 0].mean()) if len(self.all_ap) else 0.0

    @property
    def map75(self):
        return float(self.all_ap[:, 5].mean()) if len(self.all_ap) else 0.0

    @property
    def map(self):
        return float(self.all_ap.mean()) if len(self.all_ap) else 0.0

    def mean_results(self):
        return [self.mp, self.mr, self.map50, self.map]

    def class_result(self, i: int):
        return self.p[i], self.r[i], self.ap50[i], self.ap[i]

    @property
    def maps(self):
        maps = np.zeros(self.nc) + self.map
        for i, c in enumerate(self.ap_class_index):
            maps[int(c)] = self.ap[i]
        return maps

    def fitness(self) -> float:
        """0.1*mAP50 + 0.9*mAP50-95 (reference: metrics.py:848)."""
        return 0.1 * self.map50 + 0.9 * self.map

    def update(self, results: Dict[str, np.ndarray]):
        self.p = results["p"]
        self.r = results["r"]
        self.f1 = results["f1"]
        self.all_ap = results["ap"]
        self.ap_class_index = results["unique_classes"]


class DetMetrics:
    """Detection metrics aggregator (reference: metrics.py:898)."""

    def __init__(self, names: Optional[dict] = None):
        self.names = names or {}
        self.box = Metric()
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0, "postprocess": 0.0}
        self.task = "detect"

    def process(self, tp, conf, pred_cls, target_cls):
        if len(conf) == 0:
            return
        results = ap_per_class(np.asarray(tp), np.asarray(conf), np.asarray(pred_cls), np.asarray(target_cls))
        self.box.nc = len(self.names)
        self.box.update(results)
        self.curves_results = results  # full curves for PR/F1 plots (metrics.py:556)

    @property
    def keys(self):
        return ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)"]

    def mean_results(self):
        return self.box.mean_results()

    @property
    def fitness(self):
        return self.box.fitness()

    @property
    def results_dict(self):
        return dict(zip(self.keys + ["fitness"], self.mean_results() + [self.fitness]))

    @property
    def maps(self):
        return self.box.maps

    @property
    def ap_class_index(self):
        return self.box.ap_class_index


class SegmentMetrics(DetMetrics):
    """Box and mask metrics (JAX metrics.py:243): the mask TP matrix scored by
    ap_per_class as the box one, the `(M)` keys after the `(B)` ones, fitness
    the sum of both."""

    def __init__(self, names: Optional[dict] = None):
        super().__init__(names)
        self.seg = Metric()
        self.task = "segment"

    def process(self, tp, conf, pred_cls, target_cls, tp_m=None):
        super().process(tp, conf, pred_cls, target_cls)
        if tp_m is not None and len(conf):
            results = ap_per_class(np.asarray(tp_m), np.asarray(conf), np.asarray(pred_cls), np.asarray(target_cls))
            self.seg.nc = len(self.names)
            self.seg.update(results)

    @property
    def keys(self):
        return super().keys + ["metrics/precision(M)", "metrics/recall(M)", "metrics/mAP50(M)", "metrics/mAP50-95(M)"]

    def mean_results(self):
        return super().mean_results() + self.seg.mean_results()

    @property
    def fitness(self):
        return self.box.fitness() + self.seg.fitness()


class PoseMetrics(DetMetrics):
    """Box and keypoint metrics (JAX metrics.py:270): the OKS TP matrix
    scored by ap_per_class as the box one, the `(P)` keys after the `(B)`
    ones, fitness the sum of both."""

    def __init__(self, names: Optional[dict] = None):
        super().__init__(names)
        self.pose = Metric()
        self.task = "pose"

    def process(self, tp, conf, pred_cls, target_cls, tp_p=None):
        super().process(tp, conf, pred_cls, target_cls)
        if tp_p is not None and len(conf):
            results = ap_per_class(np.asarray(tp_p), np.asarray(conf), np.asarray(pred_cls), np.asarray(target_cls))
            self.pose.nc = len(self.names)
            self.pose.update(results)

    @property
    def keys(self):
        return super().keys + ["metrics/precision(P)", "metrics/recall(P)", "metrics/mAP50(P)", "metrics/mAP50-95(P)"]

    def mean_results(self):
        return super().mean_results() + self.pose.mean_results()

    @property
    def fitness(self):
        return self.box.fitness() + self.pose.fitness()


class OBBMetrics(DetMetrics):
    """Rotated-box metrics (JAX metrics.py:297): DetMetrics' keys and
    fitness over the TP matrix the OBB validator matches by probiou. An
    instance's `task` reads "detect" (DetMetrics sets it), as JAX's does."""

    task = "obb"


class ClassifyMetrics:
    """Top-1 and top-5 accuracy (JAX :301): process(targets (N,), pred_top5
    (N, k)) with k = min(5, nc), the validator's top-k indices; fitness their
    mean."""

    def __init__(self):
        self.top1 = 0.0
        self.top5 = 0.0
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0, "postprocess": 0.0}
        self.task = "classify"

    def process(self, targets: np.ndarray, pred_top5: np.ndarray) -> None:
        correct = pred_top5 == targets[:, None]
        self.top1 = float(correct[:, 0].mean())
        self.top5 = float(correct.any(1).mean())

    @property
    def fitness(self) -> float:
        return (self.top1 + self.top5) / 2

    @property
    def keys(self) -> list:
        return ["metrics/accuracy_top1", "metrics/accuracy_top5"]

    @property
    def results_dict(self) -> Dict[str, float]:
        return dict(zip(self.keys + ["fitness"], [self.top1, self.top5, self.fitness]))


class ConfusionMatrix:
    """Detection confusion matrix (reference: metrics.py:394)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = 0.25 if conf in {None, 0.001} else conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1))

    def process_batch(self, detections: Optional[np.ndarray], gt_bboxes: np.ndarray, gt_cls: np.ndarray):
        if gt_cls.shape[0] == 0:
            if detections is not None:
                detections = detections[detections[:, 4] > self.conf]
                for dc in detections[:, 5].astype(int):
                    self.matrix[dc, self.nc] += 1  # false positive
            return
        if detections is None:
            for gc in gt_cls.astype(int):
                self.matrix[self.nc, gc] += 1  # background FN
            return
        detections = detections[detections[:, 4] > self.conf]
        gt_classes = gt_cls.astype(int)
        det_classes = detections[:, 5].astype(int)
        iou = box_iou_np(gt_bboxes, detections[:, :4])
        x = np.nonzero(iou > self.iou_thres)
        matches = np.array(x).T
        if matches.shape[0]:
            order = iou[matches[:, 0], matches[:, 1]].argsort()[::-1]
            matches = matches[order]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        n = matches.shape[0] > 0
        m0, m1 = (matches[:, 0].astype(int), matches[:, 1].astype(int)) if n else (np.array([], int), np.array([], int))
        for i, gc in enumerate(gt_classes):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_classes[m1[j][0]], gc] += 1
            else:
                self.matrix[self.nc, gc] += 1
        for i, dc in enumerate(det_classes):
            if not (n and (m1 == i).any()):
                self.matrix[dc, self.nc] += 1
