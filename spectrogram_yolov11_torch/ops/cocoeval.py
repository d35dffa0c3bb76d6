"""The COCO evaluation protocol for boxes, masks and keypoints, on the host
(numpy, float64).

Counterpart of spectrogram_yolov11_tpu/ops/cocoeval.py for iou_type "bbox",
"segm" and "keypoints": _iou_xywh (:33), the compressed RLE codec rle_encode
(:52), _rle_counts (:84), rle_decode (:108), rle_area (:123), _iou_rle
(:127), COCO_KPT_SIGMAS (:141; here metrics.OKS_SIGMA, the same
numbers), _iou_oks (:147), and COCOeval (:177) with its
defaults, _evaluate_img (:238), evaluate (:292), _summ (:336) and _summarize
(:350). It is pycocotools' algorithm, which the validator runs on its
predictions.json and annotations.json rows when save_json=True
(engine/validator.py), the segment validator with "segm" too and the pose
validator with "keypoints":

- per (image, category) box IoU, the IoU of the RLE-decoded masks, a
  crowd ground truth's union being the detection's area, or the OKS of the
  keypoints (pycocotools' computeOks, with its branch for a ground truth
  without visible keypoints: the distance to the box grown by its size);
- greedy matching in score order at each IoU threshold, with ignore regions
  (crowd rows, ground truth outside the area range and, for keypoints,
  ground truth without labelled keypoints);
- 101-point interpolated precision accumulated over IoU x recall x category
  x area x max_dets, the matches made once at the largest max_dets and cut
  for the smaller ones;
- the summary: AP, AP50, AP75, AP{small,medium,large}, AR{1,10,100},
  AR{small,medium,large}; for keypoints max_dets (20,) and no "small".

Inputs are lists of dicts in the COCO JSON schema: ground truth {image_id,
category_id, bbox [x, y, w, h]} (optional area, iscrowd, id; `segmentation`,
an RLE, for "segm", whose area is the RLE's; `keypoints` [x, y, v] * K and
optional `num_keypoints` for "keypoints"), detections the same with score
(a keypoint detection's area, when absent, that of its keypoints' extent).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from .metrics import OKS_SIGMA


def _iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU of xywh boxes; a crowd ground truth's union is the detection's area."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.minimum(dx2[:, None], gx2[None]) - np.maximum(dx1[:, None], gx1[None])
    ih = np.minimum(dy2[:, None], gy2[None]) - np.maximum(dy1[:, None], gy1[None])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


def rle_encode(mask: np.ndarray) -> dict:
    """Binary (h, w) mask -> COCO compressed RLE {size, counts: str}, as
    pycocotools' encode: column-major runs alternating 0s and 1s from a run
    of 0s (maybe empty); each count written in 5-bit groups with 0x20 the
    continuation bit and 0x10 the sign, the counts from the fourth on as the
    difference from the one two before, each character offset by 48."""
    h, w = mask.shape
    flat = np.asarray(mask, dtype=np.uint8).flatten(order="F")
    bounds = np.concatenate([[0], np.flatnonzero(np.diff(flat)) + 1, [flat.size]])
    cnts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        cnts = [0] + cnts
    if not flat.size:
        cnts = [0]
    out = []
    for i, c in enumerate(cnts):
        x = int(c) - (int(cnts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            out.append(chr((ch | 0x20 if more else ch) + 48))
    return {"size": [int(h), int(w)], "counts": "".join(out)}


def _rle_counts(rle: dict) -> np.ndarray:
    """The run lengths of a compressed (str or bytes) or uncompressed (list) RLE."""
    counts = rle["counts"]
    if isinstance(counts, (list, tuple, np.ndarray)):
        return np.asarray(counts, dtype=np.int64)
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    cnts: list = []
    p = 0
    while p < len(counts):
        x, k, more = 0, 0, True
        while more:
            c = ord(counts[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return np.asarray(cnts, dtype=np.int64)


def rle_decode(rle: dict) -> np.ndarray:
    """A COCO RLE -> bool (h, w) mask; a count that does not cover h * w raises ValueError."""
    h, w = rle["size"]
    cnts = _rle_counts(rle)
    vals = np.zeros(len(cnts), dtype=bool)
    vals[1::2] = True
    flat = np.repeat(vals, cnts)
    if flat.size != h * w:
        raise ValueError(f"RLE decodes to {flat.size} px, expected {h}x{w}={h * w}")
    return flat.reshape((w, h)).T


def rle_area(rle: dict) -> float:
    """The mask's pixel count: the sum of the runs of 1s."""
    return float(_rle_counts(rle)[1::2].sum())


def _iou_rle(dts: List[dict], gts: List[dict], iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) IoU of the RLE masks; a crowd ground truth's union is the detection's area."""
    if not dts or not gts:
        return np.zeros((len(dts), len(gts)))
    dm = np.stack([rle_decode(d["segmentation"]).ravel() for d in dts])
    gm = np.stack([rle_decode(g["segmentation"]).ravel() for g in gts])
    inter = (dm[:, None, :] & gm[None, :, :]).sum(-1).astype(float)
    da = dm.sum(-1).astype(float)[:, None]
    ga = gm.sum(-1).astype(float)[None, :]
    union = np.where(iscrowd[None].astype(bool), da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


def _iou_oks(dts: List[dict], gts: List[dict], sigmas: np.ndarray) -> np.ndarray:
    """(D, G) OKS, pycocotools' computeOks: over a ground truth's visible
    keypoints, or, when it has none, over all of them with each detected
    point's distance to the ground truth's box grown by its width and height
    on each side."""
    if not dts or not gts:
        return np.zeros((len(dts), len(gts)))
    var = (sigmas * 2.0) ** 2
    k = len(sigmas)
    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], float)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int((vg > 0).sum())
        bx, by, bw, bh = gt["bbox"]
        x0, x1 = bx - bw, bx + 2 * bw
        y0, y1 = by - bh, by + 2 * bh
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], float)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                z = np.zeros(k)
                dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
            e = (dx ** 2 + dy ** 2) / var / (gt["area"] + np.spacing(1)) / 2.0
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0]
    return ious


class COCOeval:
    """COCOeval(gts, dts).evaluate().stats -> the summary dict."""

    def __init__(self, gts: List[dict], dts: List[dict], iou_thrs: Sequence[float] = None,
                 rec_thrs: Sequence[float] = None, max_dets: Sequence[int] = None,
                 area_rng: Dict[str, tuple] = None, iou_type: str = "bbox", kpt_sigmas: np.ndarray = None):
        if iou_type not in ("bbox", "segm", "keypoints"):  # JAX's asserts these three: none for rotated boxes
            from ..utils import not_ported

            raise not_ported(f"COCOeval(iou_type={iou_type!r}), which JAX's COCOeval lacks too", "item 10 (other heads)")
        self.iou_type = iou_type
        self.kpt_sigmas = np.asarray(kpt_sigmas if kpt_sigmas is not None else OKS_SIGMA)
        self.iou_thrs = np.asarray(iou_thrs if iou_thrs is not None else np.linspace(0.5, 0.95, 10))
        self.rec_thrs = np.asarray(rec_thrs if rec_thrs is not None else np.linspace(0.0, 1.0, 101))
        if max_dets is None:  # pycocotools' Params: (1, 10, 100), and (20,) for keypoints
            max_dets = (20,) if iou_type == "keypoints" else (1, 10, 100)
        self.max_dets = sorted(max_dets)
        if area_rng is None:
            area_rng = {"all": (0.0, 1e10), "small": (0.0, 32.0 ** 2), "medium": (32.0 ** 2, 96.0 ** 2),
                        "large": (96.0 ** 2, 1e10)}
            if iou_type == "keypoints":  # the keypoint protocol has no "small"
                area_rng.pop("small")
        self.area_rng = area_rng
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for i, g in enumerate(gts):
            g = dict(g)
            g.setdefault("id", i + 1)
            g.setdefault("iscrowd", 0)
            g.setdefault("area", self._area(g))
            g.setdefault("ignore", g["iscrowd"])
            if iou_type == "keypoints":  # pycocotools' _prepare: ground truth without labelled keypoints is ignored
                nk = g.get("num_keypoints")
                if nk is None:
                    nk = int((np.asarray(g["keypoints"], float)[2::3] > 0).sum())
                g["ignore"] = bool(g["ignore"]) or nk == 0
            self._gts[(g["image_id"], g["category_id"])].append(g)
        for d in dts:
            d = dict(d)
            if "area" not in d:  # for the out-of-range ignore (pycocotools' loadRes)
                d["area"] = self._kpt_area(d) if iou_type == "keypoints" else self._area(d)
            self._dts[(d["image_id"], d["category_id"])].append(d)
        self.img_ids = sorted({k[0] for k in list(self._gts) + list(self._dts)})
        self.cat_ids = sorted({k[1] for k in list(self._gts) + list(self._dts)})
        self.stats: Dict[str, float] = {}

    def _area(self, row: dict) -> float:
        """A row's area: its RLE's pixel count for "segm", its box's otherwise."""
        return rle_area(row["segmentation"]) if self.iou_type == "segm" else float(row["bbox"][2] * row["bbox"][3])

    @staticmethod
    def _kpt_area(row: dict) -> float:
        """A keypoint detection's area: that of its keypoints' extent."""
        kp = np.asarray(row["keypoints"], float)
        xs, ys = kp[0::3], kp[1::3]
        return float((xs.max() - xs.min()) * (ys.max() - ys.min())) if kp.size else 0.0

    def _evaluate_img(self, img_id, cat_id, arng, max_det):
        """pycocotools' evaluateImg for one image, category and area range."""
        gts = self._gts[(img_id, cat_id)]
        dts = sorted(self._dts[(img_id, cat_id)], key=lambda d: -d["score"])[:max_det]
        if not gts and not dts:
            return None
        g_ignore = np.array([bool(g["ignore"]) or g["area"] < arng[0] or g["area"] > arng[1] for g in gts], bool)
        order = np.argsort(g_ignore, kind="stable")  # the ground truth not ignored first
        gts = [gts[i] for i in order]
        g_ignore = g_ignore[order]
        crowd = np.array([g["iscrowd"] for g in gts], int)
        if self.iou_type == "segm":
            ious = _iou_rle(dts, gts, crowd)
        elif self.iou_type == "keypoints":
            ious = _iou_oks(dts, gts, self.kpt_sigmas)
        else:
            gbb = np.array([g["bbox"] for g in gts], float).reshape(-1, 4)
            dbb = np.array([d["bbox"] for d in dts], float).reshape(-1, 4)
            ious = _iou_xywh(dbb, gbb, crowd)

        T, D, G = len(self.iou_thrs), len(dts), len(gts)
        dt_m = np.zeros((T, D), int)
        gt_m = np.zeros((T, G), int)
        dt_ig = np.zeros((T, D), bool)
        for ti, t in enumerate(self.iou_thrs):
            for di in range(D):
                best, m = min(t, 1 - 1e-10), -1
                for gi in range(G):
                    if gt_m[ti, gi] and not crowd[gi]:
                        continue  # matched already, and not a crowd
                    if m > -1 and not g_ignore[m] and g_ignore[gi]:
                        break  # past the ground truth not ignored, with a match
                    if ious[di, gi] < best:
                        continue
                    best, m = ious[di, gi], gi
                if m == -1:
                    continue
                dt_ig[ti, di] = g_ignore[m]
                dt_m[ti, di] = gts[m]["id"]
                gt_m[ti, m] = 1
        d_areas = np.array([d["area"] for d in dts], float)
        out_rng = (d_areas < arng[0]) | (d_areas > arng[1])
        dt_ig = dt_ig | ((dt_m == 0) & out_rng[None])  # unmatched detections outside the area range
        return {"dt_scores": np.array([d["score"] for d in dts], float), "dt_matched": dt_m > 0,
                "dt_ignore": dt_ig, "n_gt": int((~g_ignore).sum())}

    def evaluate(self) -> "COCOeval":
        """pycocotools' evaluate and accumulate, then the summary into `stats`."""
        T, R = len(self.iou_thrs), len(self.rec_thrs)
        K, A, M = len(self.cat_ids), len(self.area_rng), len(self.max_dets)
        self.precision = -np.ones((T, R, K, A, M))
        self.recall = -np.ones((T, K, A, M))
        for ki, cat in enumerate(self.cat_ids):
            for ai, arng in enumerate(self.area_rng.values()):
                evs = [self._evaluate_img(i, cat, arng, self.max_dets[-1]) for i in self.img_ids]
                evs = [e for e in evs if e is not None]
                if not evs:
                    continue
                n_gt = sum(e["n_gt"] for e in evs)
                for mi, max_det in enumerate(self.max_dets):
                    if n_gt == 0:
                        continue
                    scores = np.concatenate([e["dt_scores"][:max_det] for e in evs])
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate([e["dt_matched"][:, :max_det] for e in evs], 1)[:, order]
                    ignored = np.concatenate([e["dt_ignore"][:, :max_det] for e in evs], 1)[:, order]
                    tp_sum = np.cumsum(matched & ~ignored, 1).astype(float)
                    fp_sum = np.cumsum(~matched & ~ignored, 1).astype(float)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        self.recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0.0
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):  # the precision envelope
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, self.rec_thrs, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        self.precision[ti, :, ki, ai, mi] = q
        self._summarize()
        return self

    def _summ(self, ap: bool = True, iou=None, area: str = "all", max_det: int = 100) -> float:
        ai = list(self.area_rng).index(area)
        mi = self.max_dets.index(max_det)
        s = self.precision[..., ai, mi] if ap else self.recall[:, :, ai, mi]
        if iou is not None:
            s = s[np.isclose(self.iou_thrs, iou)]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    def _summarize(self) -> None:
        md = self.max_dets[-1]
        areas = [a for a in ("small", "medium", "large") if a in self.area_rng]
        self.stats = {
            "AP": self._summ(True, None, "all", md),
            "AP50": self._summ(True, 0.5, "all", md),
            "AP75": self._summ(True, 0.75, "all", md),
            **{f"AP{a}": self._summ(True, None, a, md) for a in areas},
            **{f"AR{m}": self._summ(False, None, "all", m) for m in self.max_dets},
            **{f"AR{a}": self._summ(False, None, a, md) for a in areas},
        }
