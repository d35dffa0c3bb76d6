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
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..cfg import DEFAULT_CFG_DICT, get_cfg, get_save_dir
from ..data.augment import letterbox_batch
from ..data.loaders import load_inference_source
from ..nn.tasks import DetectionModel
from ..ops.boxes import scale_boxes
from ..utils import LOGGER, resolve_device
from ..utils.callbacks import run_callbacks
from .pipeline import build_device_fn, eval_network
from .results import Results


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
                               half=self.model.dtype == torch.bfloat16)

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
            self._sync()
            t1 = time.perf_counter()
            out, nv = self._device_fn(batch)
            out, nv = out[:n_real].cpu().numpy(), nv[:n_real].cpu().numpy()
            t2 = time.perf_counter()
            speed = {"preprocess": (t1 - t0) / n_real * 1e3, "inference": (t2 - t1) / n_real * 1e3, "postprocess": 0.0}
            res = self.postprocess(out, nv, buf_imgs, buf_paths, speed)
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
