"""AutoBatch: the largest train batch whose step fits a share of the device's memory.

Counterpart of spectrogram_yolov11_tpu/utils/autobatch.py: device_memory_bytes
(:19), autobatch (:45) and check_train_batch_size (:63), with JAX's selection
rule: from `start`, double the batch while the probe's peak fits `fraction`
of the device's memory and `max_batch` is not passed; the first probe that is
over the limit, or fails, ends the search, and the last batch that fitted is
chosen (`start` when none did).

JAX asks XLA for the compiled step's peak without running it. The port runs
the step once: on the card, the peak of `torch.cuda.max_memory_allocated`
after `reset_peak_memory_stats` (an out-of-memory error counts as "does not
fit" and the cache is emptied), against the card's total memory; on the CPU,
the bytes autograd saves for the backward (saved_tensors_hooks, each storage
once) plus the parameters and their gradients, against JAX's CPU default of
16 GiB. Both count other things than XLA's memory analysis does, so the batch
chosen can differ from JAX's at the same settings (ROADMAP.md §3).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import torch

from . import LOGGER, full_f32

CPU_MEMORY = 16 * 1024**3  # JAX's default when the device reports no limit


def device_memory_bytes(device: Optional[torch.device] = None) -> int:
    """The device's memory: a card's total, else JAX's 16 GiB default."""
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return CPU_MEMORY


def autobatch(probe: Callable[[int], Optional[int]], fraction: float = 0.60, start: int = 16, max_batch: int = 256,
              device: Optional[torch.device] = None, probes: Optional[Dict[int, Optional[int]]] = None) -> int:
    """The largest power-of-two multiple of `start` up to max_batch whose
    probe(batch) -> peak bytes (None: failed) fits `fraction` of the device's
    memory, probing upwards and stopping at the first that does not fit.
    `probes`, a dict, receives each batch probed and its reading."""
    limit = device_memory_bytes(device) * fraction
    best, b = start, start
    while b <= max_batch:
        mem = probe(b)
        if probes is not None:
            probes[b] = mem
        if mem is None or mem > limit:
            break
        best = b
        b *= 2
    LOGGER.info(f"AutoBatch: selected batch={best} (target {fraction:.0%} of "
                f"{device_memory_bytes(device) / 1e9:.1f} GB)")
    return best


def check_train_batch_size(model, imgsz: int = 640, nc: int = 80, fraction: float = 0.60,
                           probes: Optional[Dict[int, Optional[int]]] = None) -> int:
    """autobatch over the train step of `model` on its device: a copy of it
    in training mode computing in f32, the forward, the task's loss (the
    detection loss, a segment model's segmentation loss over empty
    instance masks, a pose model's pose loss over empty keypoints, an obb
    model's OBB loss over empty rotated boxes, or an end2end (v10) model's
    dual-assignment loss; JAX's hands that head's dict to detection_loss,
    whose probe fails, and keeps its start batch 16: ROADMAP.md §3.48) and
    the backward to every parameter, on (b, 3, imgsz,
    imgsz) zeros with 128 empty label slots per image, as JAX's probe (:63)."""
    from ..ops.losses import detection_loss, e2e_detection_loss, obb_loss, pose_loss, segmentation_loss

    dev = next(model.parameters()).device
    m = copy.deepcopy(model).train()
    m.compute_dtype = torch.float32
    params = [p for p in m.parameters() if p.requires_grad]
    strides = tuple(float(s) for s in m.stride)
    fmt = torch.channels_last if dev.type == "cuda" else torch.contiguous_format

    def step(b: int) -> None:
        x = torch.zeros(b, 3, imgsz, imgsz, device=dev).contiguous(memory_format=fmt)
        cls = torch.zeros(b, 128, dtype=torch.int32, device=dev)
        boxes = torch.zeros(b, 128, 4, device=dev)
        mask = torch.zeros(b, 128, dtype=torch.bool, device=dev)
        with full_f32():
            out = m(x)
            if m.task == "obb":  # (feats, raw angles)
                rboxes = torch.zeros(b, 128, 5, device=dev)
                loss, _ = obb_loss(*out, cls, rboxes, mask, nc=nc, imgsz=imgsz, strides=strides)
            elif isinstance(out, tuple) and len(out) == 2:  # a pose model's (feats, raw keypoints)
                kpts = torch.zeros(b, 128, m.kpt_shape[0], 3, device=dev)
                loss, _ = pose_loss(*out, cls, boxes, mask, kpts, nc=nc, kpt_shape=m.kpt_shape, imgsz=imgsz,
                                    strides=strides)
            elif isinstance(out, tuple):  # a segment model's (feats, coefficients, prototypes)
                gt = torch.zeros(b, *out[2].shape[-2:], dtype=torch.int32, device=dev)
                loss, _ = segmentation_loss(*out, cls, boxes, mask, gt, nc=nc, imgsz=imgsz, strides=strides)
            else:
                loss_fn = e2e_detection_loss if isinstance(out, dict) else detection_loss
                loss, _ = loss_fn(out, cls, boxes, mask, nc=nc, imgsz=imgsz, strides=strides)
            torch.autograd.grad(loss, params)

    def probe_card(b: int) -> Optional[int]:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            step(b)
            torch.cuda.synchronize(dev)
            return int(torch.cuda.max_memory_allocated(dev))
        except torch.cuda.OutOfMemoryError:
            LOGGER.info(f"AutoBatch: batch={b} is out of memory")
            return None
        except Exception as e:
            LOGGER.warning(f"autobatch: probe at batch={b} failed: {e}")
            return None
        finally:
            torch.cuda.empty_cache()

    own = {p.untyped_storage().data_ptr() for p in params}
    fixed = 2 * sum(p.numel() * p.element_size() for p in params)  # the parameters and their gradients

    def probe_host(b: int) -> Optional[int]:
        saved: Dict[int, int] = {}

        def pack(t: torch.Tensor) -> torch.Tensor:
            st = t.untyped_storage()
            if st.data_ptr() not in own:
                saved[st.data_ptr()] = st.nbytes()
            return t

        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                step(b)
        except Exception as e:
            LOGGER.warning(f"autobatch: probe at batch={b} failed: {e}")
            return None
        return sum(saved.values()) + fixed

    return autobatch(probe_card if dev.type == "cuda" else probe_host, fraction=fraction, device=dev, probes=probes)
