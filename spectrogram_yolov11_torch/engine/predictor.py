"""Predictor for the detect task. Counterpart of
spectrogram_yolov11_tpu/engine/predictor.py:68 BasePredictor.

Per batch: the on-card letterbox of the frames (data/augment.py; a gray batch
goes up as one channel), the device function (engine/pipeline.py:
build_device_fn: normalise, forward with the fused bottleneck kernel, DFL
decode, NMS with the greedy keep kernel), then on the host scale_boxes per
image and Results. The last batch is padded with copies of its last frame, as
in the JAX predictor, and only the real frames are yielded. A call that is
not a stream then saves as JAX's (predictor.py:296-334, images): with save
(True by default) each image's plot as <stem>.jpg, with save_txt its label
rows under labels/, with save_crop its crops under crops/, all in one run
directory (runs/detect/predict*, or project/name), and logs where. The
images are saved in `workers` threads (the JPEG encoder releases the GIL),
one by one where two share a stem.

half=True runs the network in bf16, as the JAX predictor maps half=True to
bf16 (spectrogram_yolov11_tpu/engine/predictor.py:89): the predictor holds its
own bf16 copy of the model (DetectionModel.set_dtype), so the caller's f32
model, and a later half=False predictor on it, stay f32.

augment=True runs test-time augmentation, JAX's run_tta (:134-174):
engine/pipeline.py:build_device_fn with augment, three passes (scales 1,
0.83 flipped, 0.67) into one NMS. visualize=True writes, once per predictor, the feature maps
of the first batch's first frame through the predictor's network on its
device (one forward more), as JAX's _visualize_features (:192-220): every
top-level layer whose output is 4-D as a channel grid
(utils/plotting.py:feature_visualization) under <save_dir>/features,
stage{k}_model_{i}.png, k the rank of the layer's flax name among the
graph's intermediates in lexicographic order (feature_stages); a failure is
logged as a warning and predict goes on, as in JAX.

EnsemblePredictor is JAX's (:420-460) for YOLO([a, b]): the members' decoded
predictions, each at its own strides, concatenated into one NMS
(engine/pipeline.py:build_ensemble_fn).

SegmentationPredictor is JAX's (:338-393) for the segment task: the device
function (engine/pipeline.py:build_segment_fn: NMS with the mask
coefficients carried, each anchor's best class, pre_nms_topk 1024, classes
and agnostic_nms not read, as in JAX; sigmoid masks cropped to their boxes)
and, per image on the card, each kept mask resized to imgsz x imgsz as cv2's
float INTER_LINEAR (ops/masks.py:resize_linear_f32), cut to the letterboxed
region by JAX's round(pad -+ 0.1), resized to the image's size, thresholded
at 0.5 and cropped to its scaled box (truncated to int); only those bool
masks come to the host, for Results.masks. As in JAX, augment and
visualize are not read by the segment predictor.

PosePredictor is JAX's (:499-539) for the pose task: the device function
(engine/pipeline.py:build_pose_fn: NMS with the decoded keypoints carried,
each anchor's best class, pre_nms_topk 1024, classes and agnostic_nms not
read, as in JAX) and, per image on the host, the boxes scaled to its pixels
and the keypoints un-letterboxed as JAX's: (xy - pad) / gain with each pad
Python's round(pad - 0.1), for Results.keypoints. augment is not read, as
in JAX; visualize is BasePredictor's, as JAX's pose predictor inherits it.

OBBPredictor is JAX's (:543-577) for the obb task: the device function
(engine/pipeline.py:build_obb_fn: Fast-NMS over probiou, each anchor's best
class, pre_nms_topk 1024, classes and agnostic_nms not read, as in JAX; no
keep kernel) and, per image on the host, the rotated boxes un-letterboxed
as JAX's: (cx - pad) / gain, (cy - pad) / gain, (w, h) / gain, the pads
Python's round(pad - 0.1), unclipped, for Results.obb. augment is not read,
as in JAX; visualize is BasePredictor's.

ClassificationPredictor is JAX's (:463-496) for the classify task: each
frame squashed to imgsz x imgsz as cv2.resize(INTER_LINEAR) does
(data/augment.py:resize_linear_u8, on the predictor's device), / 255,
forwarded (C3k's bottlenecks on the fused kernel) and softmaxed on the
device in the network's dtype (bf16 with half=True), for Results.probs. JAX's
preprocess flips the frame to RGB and its device function flips it again
(_norm_on_device), so its network sees BGR: the port feeds BGR too
(ROADMAP.md §3.44). JAX runs one image per device call; the port runs
`batch_size` frames per call (1 by default, as JAX). As JAX's classify
predictor, it saves nothing (its stream_inference has no save step) and
reads neither augment nor visualize.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..cfg import DEFAULT_CFG_DICT, get_cfg, get_save_dir
from ..data.augment import letterbox_batch, resize_linear_u8
from ..data.loaders import load_inference_source
from ..nn.tasks import DetectionModel
from ..ops.boxes import scale_boxes
from ..utils import LOGGER, full_f32, resolve_device
from ..utils.callbacks import run_callbacks
from ..ops.masks import resize_linear_f32
from ..utils.plotting import feature_visualization
from .pipeline import (build_device_fn, build_ensemble_fn, build_obb_fn, build_pose_fn, build_segment_fn,
                       eval_network, nchw, normalize)
from .results import Results


def feature_stages(model: DetectionModel) -> List[tuple]:
    """(stage, name, module) of every top-level layer module of the network, by
    JAX's numbering: flax names its layers model_{i}, or model_{i}_{j} for
    the j-th of a layer repeated n > 1 times (the port's nn.Sequential), and
    the root's own output is the intermediate "__call__"; JAX's
    _visualize_features enumerates sorted(intermediates), so a layer's stage
    is its name's rank in lexicographic order, "__call__" at 0. An
    nn.Identity layer (yolov9e's layer 0) is no module in JAX's graph, so it
    has no stage."""
    mods = {}
    for i, layer in enumerate(model.model):
        if type(layer) is torch.nn.Identity:
            continue
        if isinstance(layer, torch.nn.Sequential):
            mods.update({f"model_{i}_{j}": m for j, m in enumerate(layer)})
        else:
            mods[f"model_{i}"] = layer
    return [(k, name, mods[name]) for k, name in enumerate(sorted(["__call__", *mods])) if name in mods]


def _host_frame(img) -> np.ndarray:
    """A frame as the host numpy image Results keeps (a device frame is made
    contiguous on the device, then copied)."""
    return img.contiguous().cpu().numpy() if torch.is_tensor(img) else img


class BasePredictor:
    """Detection predictor: predictor(source, stream=False, batch_size=1)."""

    def __init__(self, model: DetectionModel, overrides: Optional[dict] = None, names: Optional[dict] = None):
        args = get_cfg(DEFAULT_CFG_DICT, overrides or {})
        if args.conf is None:
            args.conf = 0.25
        self.args = args
        self.device = resolve_device(args.device or "cuda")
        self.source = model  # None for a predictor whose network runs elsewhere (serve.py:RemotePredictor)
        self.model = eval_network(model, bool(args.half), self.device) if model is not None else None
        self.imgsz = int(args.imgsz if isinstance(args.imgsz, int) else args.imgsz[0])
        self.batch_size = 1
        self.names = names if names is not None else {i: f"{i}" for i in range(model.nc)}
        self._device_fn = None
        self.results: List[Results] = []
        self.callbacks: dict = {}

    def _build_device_fn(self):
        a = self.args
        return build_device_fn(self.model, conf=float(a.conf), iou=float(a.iou), max_det=int(a.max_det),
                               classes=a.classes, agnostic=bool(a.agnostic_nms),
                               pre_nms_topk=int(a.pre_nms_topk or 0) or 1024,
                               half=self.model.dtype == torch.bfloat16, augment=bool(a.augment))

    def _visualize_features(self, batch: torch.Tensor) -> None:
        """visualize=True: the first frame of `batch` (letterboxed uint8 on the
        device) normalised and forwarded through the predictor's network, each
        top-level layer's output kept by a forward hook; every 4-D tensor one
        written as its channel grid, permuted to JAX's NHWC (a list output,
        such as CBLinear's pieces or a head's, is left out, as JAX's). A
        failure is logged and predict goes on, as JAX's."""
        self._visualized = True
        save_dir = get_save_dir(self.args) / "features"
        try:
            if not isinstance(self.model, DetectionModel):
                raise ValueError("the predictor holds no network (a served model)")
            outs, hooks = {}, []
            for _, name, mod in feature_stages(self.model):
                hooks.append(mod.register_forward_hook(lambda m, a, o, name=name: outs.setdefault(name, o)))
            try:
                with torch.inference_mode():
                    self.model(nchw(normalize(batch[:1])))
            finally:
                for h in hooks:
                    h.remove()
            for stage, name, _ in feature_stages(self.model):
                out = outs.get(name)
                if torch.is_tensor(out) and out.ndim == 4:
                    feature_visualization(out.permute(0, 2, 3, 1).float().cpu().numpy(), name, stage,
                                          save_dir=save_dir)
            LOGGER.info(f"feature maps saved to {save_dir}")
        except Exception as e:  # visualization must never fail inference
            LOGGER.warning(f"visualize=True failed: {e}")

    def preprocess(self, imgs: list, gray_state: Optional[list] = None) -> torch.Tensor:
        """Letterbox the frames on the device: (B, imgsz, imgsz, 1|3) uint8 BGR."""
        return letterbox_batch(imgs, self.imgsz, self.device, gray_state)

    def postprocess(self, out: np.ndarray, n_valid: np.ndarray, orig_imgs: list, paths: list, speed: dict) -> List[Results]:
        """Host side: slice each image's detections, scale them back to its pixels."""
        results = []
        for i, (img0, path) in enumerate(zip(orig_imgs, paths)):
            n = int(n_valid[i])
            det = out[i, :n].copy()
            img0 = _host_frame(img0)
            if n:
                det[:, :4] = scale_boxes((self.imgsz, self.imgsz), det[:, :4], img0.shape[:2])
            results.append(Results(img0, path, self.names, boxes=det, speed=speed))
        return results

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stream_inference(self, source, batch_size: int = 1) -> Iterator[Results]:
        # trained since this predictor was built: run its weights as they are now
        if self.source is not None and self.source.training:
            self.model, self._device_fn = eval_network(self.source, bool(self.args.half), self.device), None
        if self._device_fn is None or batch_size != self.batch_size:
            self._device_fn = self._build_device_fn()
            self.batch_size = batch_size
        run_callbacks(self.callbacks, "on_predict_start", self)
        loader = load_inference_source(source, device=self.device)
        gray_state = [None]
        buf_imgs, buf_paths = [], []

        def flush():
            nonlocal buf_imgs, buf_paths
            if not buf_imgs:
                return
            run_callbacks(self.callbacks, "on_predict_batch_start", self)
            n_real = len(buf_imgs)
            t0 = time.perf_counter()
            batch = self.preprocess(buf_imgs + [buf_imgs[-1]] * (batch_size - n_real), gray_state)
            if self.args.visualize and not getattr(self, "_visualized", False):
                self._visualize_features(batch)
            self._sync()
            t1 = time.perf_counter()
            dev = self._device_fn(batch)
            out, nv = dev[0][:n_real].cpu().numpy(), dev[1][:n_real].cpu().numpy()
            t2 = time.perf_counter()
            speed = {"preprocess": (t1 - t0) / n_real * 1e3, "inference": (t2 - t1) / n_real * 1e3, "postprocess": 0.0}
            res = self.postprocess(out, nv, buf_imgs, buf_paths, speed, *dev[2:])  # a segment batch's masks
            speed["postprocess"] = (time.perf_counter() - t2) / n_real * 1e3
            self.results = res
            run_callbacks(self.callbacks, "on_predict_postprocess_end", self)
            buf_imgs, buf_paths = [], []
            yield from res
            run_callbacks(self.callbacks, "on_predict_batch_end", self)

        for path, img, _ in loader:
            buf_imgs.append(img)
            buf_paths.append(path)
            if len(buf_imgs) == batch_size:
                yield from flush()
        yield from flush()
        run_callbacks(self.callbacks, "on_predict_end", self)

    def __call__(self, source, stream: bool = False, batch_size: int = 1):
        gen = self.stream_inference(source, batch_size=batch_size)
        if stream:
            return gen
        results = list(gen)
        a = self.args
        if a.save or a.save_txt or a.save_crop:
            save_dir = get_save_dir(a)
            save_dir.mkdir(parents=True, exist_ok=True)
            plot_kw = dict(line_width=a.line_width, show_conf=bool(a.show_conf), show_labels=bool(a.show_labels))

            def save_one(r: Results) -> None:
                stem = Path(r.path).stem or "image"
                if a.save:
                    r.save(save_dir / f"{stem}.jpg", **plot_kw)
                if a.save_txt:
                    r.save_txt(save_dir / "labels" / f"{stem}.txt", save_conf=a.save_conf)
                if a.save_crop:
                    r.save_crop(save_dir / "crops", f"{stem}.jpg")

            stems = [Path(r.path).stem or "image" for r in results]
            threads = min(int(a.workers), len(results)) if len(set(stems)) == len(stems) else 0
            if threads > 1:  # the encoder releases the GIL; images of one stem are saved in order, as JAX's
                with ThreadPoolExecutor(threads) as pool:
                    list(pool.map(save_one, results))
            else:
                for r in results:
                    save_one(r)
            LOGGER.info(f"Results saved to {save_dir}")
        return results


class EnsemblePredictor(BasePredictor):
    """JAX's EnsemblePredictor (engine/predictor.py:420-460) for a weight
    ensemble: `members` are detection models sharing nc (an AssertionError
    otherwise, as JAX's); the lead's (the first's) model and names serve
    the predictor, each member runs on the predictor's device (its bf16 copy
    with half=True), and build_ensemble_fn puts every member's decoded
    predictions into one NMS. augment is not read, as in JAX."""

    def __init__(self, members: List[DetectionModel], overrides: Optional[dict] = None,
                 names: Optional[dict] = None):
        assert len({m.nc for m in members}) == 1, "ensemble members must share nc"
        super().__init__(members[0], overrides=overrides, names=names)
        self.others = [eval_network(m, bool(self.args.half), self.device) for m in members[1:]]

    def _build_device_fn(self):
        a = self.args
        return build_ensemble_fn([self.model, *self.others], conf=float(a.conf), iou=float(a.iou),
                                 max_det=int(a.max_det), classes=a.classes, agnostic=bool(a.agnostic_nms))

    def _visualize_features(self, batch: torch.Tensor) -> None:
        """As JAX's, whose forward of the lead's graph on the members' tuple of
        variables fails: a warning, no files."""
        self._visualized = True
        LOGGER.warning("visualize=True failed: a weight ensemble has no single network to visualize")


class SegmentationPredictor(BasePredictor):
    """The segment predictor (the module docstring): Results with boxes and masks."""

    def _build_device_fn(self):
        a = self.args
        return build_segment_fn(self.model, conf=float(a.conf), iou=float(a.iou), max_det=int(a.max_det),
                                half=self.model.dtype == torch.bfloat16)

    def _visualize_features(self, batch: torch.Tensor) -> None:
        """Not read, as JAX's segment predictor does not (its stream_inference has no visualize step)."""
        self._visualized = True

    def process_masks(self, masks: torch.Tensor, boxes: np.ndarray, shape) -> np.ndarray:
        """(n, S / 4, S / 4) float masks of one image on the card and its (n, 4)
        boxes in its own pixels -> (n, h0, w0) bool on the host (JAX :365-393)."""
        s, (h0, w0) = self.imgsz, shape
        gain = min(s / h0, s / w0)
        pw, ph = (s - w0 * gain) / 2, (s - h0 * gain) / 2
        m = resize_linear_f32(masks, s, s)
        m = m[:, int(round(ph - 0.1)) : s - int(round(ph + 0.1)), int(round(pw - 0.1)) : s - int(round(pw + 0.1))]
        m = resize_linear_f32(m.contiguous(), h0, w0) > 0.5
        b = torch.from_numpy(boxes.astype(int)).to(m.device)
        x1, y1, x2, y2 = (b[:, k, None, None] for k in range(4))
        rows = torch.arange(h0, device=m.device)[:, None]
        cols = torch.arange(w0, device=m.device)[None, :]
        inside = (rows >= y1.clamp(min=0)) & (rows < y2) & (cols >= x1.clamp(min=0)) & (cols < x2)
        return (m & inside).cpu().numpy()

    def postprocess(self, out: np.ndarray, n_valid: np.ndarray, orig_imgs: list, paths: list, speed: dict,
                    masks: torch.Tensor) -> List[Results]:
        """Each image's detections scaled to its pixels and its masks (process_masks)."""
        results = []
        for i, (img0, path) in enumerate(zip(orig_imgs, paths)):
            n = int(n_valid[i])
            det = out[i, :n].copy()
            img0 = _host_frame(img0)
            mk = None
            if n:
                det[:, :4] = scale_boxes((self.imgsz, self.imgsz), det[:, :4], img0.shape[:2])
                with torch.inference_mode():
                    mk = self.process_masks(masks[i, :n], det[:, :4], img0.shape[:2])
            results.append(Results(img0, path, self.names, boxes=det, speed=speed, masks=mk))
        return results


class PosePredictor(BasePredictor):
    """The pose predictor (the module docstring): Results with boxes and keypoints."""

    def _build_device_fn(self):
        a = self.args
        return build_pose_fn(self.model, conf=float(a.conf), iou=float(a.iou), max_det=int(a.max_det),
                             half=self.model.dtype == torch.bfloat16)

    def postprocess(self, out: np.ndarray, n_valid: np.ndarray, orig_imgs: list, paths: list,
                    speed: dict) -> List[Results]:
        """Each image's detections scaled to its pixels and its keypoints (n, nk, nd) un-letterboxed."""
        nk = self.model.kpt_shape[0]
        nd = (out.shape[-1] - 6) // nk
        results = []
        for i, (img0, path) in enumerate(zip(orig_imgs, paths)):
            n = int(n_valid[i])
            img0 = _host_frame(img0)
            det = out[i, :n, :6].copy()
            kpts = out[i, :n, 6:].reshape(n, nk, nd).copy()
            if n:
                h0, w0 = img0.shape[:2]
                gain = min(self.imgsz / h0, self.imgsz / w0)
                pw, ph = round((self.imgsz - w0 * gain) / 2 - 0.1), round((self.imgsz - h0 * gain) / 2 - 0.1)
                det[:, :4] = scale_boxes((self.imgsz, self.imgsz), det[:, :4], (h0, w0))
                kpts[..., 0] = (kpts[..., 0] - pw) / gain
                kpts[..., 1] = (kpts[..., 1] - ph) / gain
            results.append(Results(img0, path, self.names, boxes=det, speed=speed, keypoints=kpts))
        return results


class OBBPredictor(BasePredictor):
    """The obb predictor (the module docstring): Results with rotated boxes."""

    def _build_device_fn(self):
        a = self.args
        return build_obb_fn(self.model, conf=float(a.conf), iou=float(a.iou), max_det=int(a.max_det),
                            half=self.model.dtype == torch.bfloat16)

    def postprocess(self, out: np.ndarray, n_valid: np.ndarray, orig_imgs: list, paths: list,
                    speed: dict) -> List[Results]:
        """Each image's rotated boxes (n, 7) un-letterboxed to its pixels (JAX :564-577)."""
        results = []
        for i, (img0, path) in enumerate(zip(orig_imgs, paths)):
            n = int(n_valid[i])
            img0 = _host_frame(img0)
            det = out[i, :n].copy()
            if n:
                h0, w0 = img0.shape[:2]
                gain = min(self.imgsz / h0, self.imgsz / w0)
                pw, ph = round((self.imgsz - w0 * gain) / 2 - 0.1), round((self.imgsz - h0 * gain) / 2 - 0.1)
                det[:, 0] = (det[:, 0] - pw) / gain
                det[:, 1] = (det[:, 1] - ph) / gain
                det[:, 2:4] /= gain
            results.append(Results(img0, path, self.names, speed=speed, obb=det))
        return results


class ClassificationPredictor(BasePredictor):
    """The classify predictor (the module docstring): Results with probs."""

    def _build_device_fn(self):
        model = self.model

        @torch.inference_mode()
        @full_f32()
        def fn(frames: torch.Tensor) -> torch.Tensor:
            return torch.softmax(model(nchw(frames.float() / 255.0)), -1)

        return fn

    def preprocess(self, imgs: list, gray_state: Optional[list] = None) -> torch.Tensor:
        """Each frame squashed to (imgsz, imgsz) on the device, gray broadcast to 3 channels: (B, S, S, 3) uint8 BGR."""
        s = self.imgsz
        out = []
        for im in imgs:
            t = (im if torch.is_tensor(im) else torch.from_numpy(np.ascontiguousarray(im))).to(self.device)
            t = t[..., None] if t.ndim == 2 else t
            out.append(resize_linear_u8(t[None], s, s)[0].expand(-1, -1, 3))
        return torch.stack(out)

    def stream_inference(self, source, batch_size: int = 1) -> Iterator[Results]:
        if self.source is not None and self.source.training:
            self.model, self._device_fn = eval_network(self.source, bool(self.args.half), self.device), None
        if self._device_fn is None:
            self._device_fn = self._build_device_fn()
        run_callbacks(self.callbacks, "on_predict_start", self)
        buf: list = []

        def flush():
            run_callbacks(self.callbacks, "on_predict_batch_start", self)
            t0 = time.perf_counter()
            frames = self.preprocess([img for _, img in buf])
            self._sync()
            t1 = time.perf_counter()
            probs = self._device_fn(frames).float().cpu().numpy()
            t2 = time.perf_counter()
            speed = {"preprocess": (t1 - t0) / len(buf) * 1e3, "inference": (t2 - t1) / len(buf) * 1e3,
                     "postprocess": 0.0}
            self.results = [Results(_host_frame(img), path, self.names, speed=speed, probs=p)
                            for (path, img), p in zip(buf, probs)]
            run_callbacks(self.callbacks, "on_predict_postprocess_end", self)
            buf.clear()
            yield from self.results
            run_callbacks(self.callbacks, "on_predict_batch_end", self)

        for path, img, _ in load_inference_source(source, device=self.device):
            buf.append((path, img))
            if len(buf) == batch_size:
                yield from flush()
        if buf:
            yield from flush()
        run_callbacks(self.callbacks, "on_predict_end", self)

    def __call__(self, source, stream: bool = False, batch_size: int = 1):
        gen = self.stream_inference(source, batch_size=batch_size)
        return gen if stream else list(gen)
