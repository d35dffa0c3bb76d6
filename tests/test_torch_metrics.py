"""The port's detection metrics (ops/metrics.py) equal the JAX package's.

Seeded random detections and ground truth go through both modules: the IoU
matrix, the TP matrix at 10 IoU thresholds, AP per class and the F1-max
operating point, the metric containers and the confusion matrix. Both are
host numpy running the same arithmetic, so every result must be equal, not
close; the empty cases (no detections, no ground truth, a class with no
detections) are among the cases.
"""

import numpy as np
import pytest
from test_torch_train_step import one_torch_thread  # noqa: F401 (autouse: one torch thread in this module)

from spectrogram_yolov11_torch.ops import metrics as port
from spectrogram_yolov11_tpu.ops import metrics as jax_metrics

IOUV = np.linspace(0.5, 0.95, 10)


def _boxes(rng, n, scale=200.0):
    xy = rng.uniform(0, scale, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(5, 60, (n, 2))], -1).astype(np.float32)


def _scene(seed, n_pred, n_gt, nc):
    """Detections near the ground truth (and some far off), classes mostly right."""
    rng = np.random.default_rng(seed)
    gt = _boxes(rng, n_gt)
    gt_cls = rng.integers(0, nc, n_gt)
    near = gt[rng.integers(0, n_gt, n_pred)] if n_gt else _boxes(rng, n_pred)
    det = (near + rng.normal(0, 6, (n_pred, 4))).astype(np.float32)
    det[:, 2:] = np.maximum(det[:, 2:], det[:, :2] + 1)
    conf = rng.uniform(0.001, 1, n_pred).astype(np.float32)
    conf[: n_pred // 4] = np.round(conf[: n_pred // 4], 1)  # ties in score
    pred_cls = np.where(rng.uniform(size=n_pred) < 0.8, gt_cls[rng.integers(0, n_gt, n_pred)] if n_gt else 0,
                        rng.integers(0, nc, n_pred))
    return gt, gt_cls, det, conf, pred_cls


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


CASES = [(0, 60, 20, 4), (1, 300, 80, 2), (2, 5, 1, 2), (3, 0, 10, 2), (4, 40, 0, 3), (5, 1, 1, 1)]


@pytest.mark.parametrize("seed,n_pred,n_gt,nc", CASES)
def test_match_predictions_and_iou_equal_jax(seed, n_pred, n_gt, nc):
    gt, gt_cls, det, _, pred_cls = _scene(seed, n_pred, n_gt, nc)
    iou = port.box_iou_np(gt, det)
    _assert_same(iou, jax_metrics.box_iou_np(gt, det))
    got = port.match_predictions(pred_cls, gt_cls, iou, IOUV)
    _assert_same(got, jax_metrics.match_predictions(pred_cls, gt_cls, iou, IOUV))
    assert got.shape == (n_pred, 10)


def _stats(seed, n_pred, n_gt, nc):
    gt, gt_cls, det, conf, pred_cls = _scene(seed, n_pred, n_gt, nc)
    tp = jax_metrics.match_predictions(pred_cls, gt_cls, jax_metrics.box_iou_np(gt, det), IOUV)
    return tp, conf, pred_cls.astype(float), gt_cls


@pytest.mark.parametrize("seed,n_pred,n_gt,nc", [c for c in CASES if c[2]])
def test_ap_per_class_equals_jax(seed, n_pred, n_gt, nc):
    stats = _stats(seed, n_pred, n_gt, nc)
    _assert_same(port.ap_per_class(*stats), jax_metrics.ap_per_class(*stats))
    r = np.random.default_rng(seed).uniform(size=37)
    _assert_same(port.compute_ap(r, r[::-1]), jax_metrics.compute_ap(r, r[::-1]))
    _assert_same(port.smooth(r, 0.1), jax_metrics.smooth(r, 0.1))


@pytest.mark.parametrize("seed,n_pred,n_gt,nc", CASES)
def test_det_metrics_equal_jax(seed, n_pred, n_gt, nc):
    names = {i: f"c{i}" for i in range(nc)}
    stats = _stats(seed, n_pred, n_gt, nc)
    ours, theirs = port.DetMetrics(names=names), jax_metrics.DetMetrics(names=names)
    if n_gt:  # the validator calls process only when there are detections; ap_per_class needs a target
        ours.process(*stats)
        theirs.process(*stats)
    assert ours.results_dict == theirs.results_dict
    assert ours.mean_results() == theirs.mean_results() and ours.fitness == theirs.fitness
    assert list(ours.results_dict) == ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
                                       "metrics/mAP50-95(B)", "fitness"]
    _assert_same(ours.maps, theirs.maps)
    _assert_same(ours.ap_class_index, theirs.ap_class_index)
    _assert_same(ours.box.ap50, theirs.box.ap50)
    assert ours.box.map75 == theirs.box.map75


@pytest.mark.parametrize("seed,n_pred,n_gt,nc", CASES)
@pytest.mark.parametrize("conf", [0.001, 0.25, 0.5])
def test_confusion_matrix_equals_jax(seed, n_pred, n_gt, nc, conf):
    gt, gt_cls, det, score, pred_cls = _scene(seed, n_pred, n_gt, nc)
    dets = np.concatenate([det, score[:, None], pred_cls[:, None].astype(np.float32)], 1)
    ours, theirs = port.ConfusionMatrix(nc, conf=conf), jax_metrics.ConfusionMatrix(nc, conf=conf)
    for cm in (ours, theirs):
        cm.process_batch(dets, gt, gt_cls)
        cm.process_batch(None, gt, gt_cls)
        cm.process_batch(dets, gt[:0], gt_cls[:0])
    _assert_same(ours.matrix, theirs.matrix)
    assert ours.conf == theirs.conf
