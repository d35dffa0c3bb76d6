"""The detect training step on the card, and the validation of its EMA.

Counterpart of spectrogram_yolov11_tpu/engine/trainer.py: batch_images
(:75-96, the host-image path), compute_loss / forward_train /
_make_train_step (:251-336), the optimizer set-up and the warmup-ramped
accumulate of train() (:356-460), and validate (:524-537). One step:

  images / 255 -> forward in training mode (BN on batch statistics, its
  running statistics moved as flax moves them) -> TAL + CIoU/DFL/BCE loss ->
  grads added to the grad buffer -> on a step the trainer asks for
  (do_step, decided on the host by `step_due`): clip the buffer to global
  norm 10, SGD or AdamW at the lr of iteration ni, zero the buffer, and the
  EMA (f32) of the parameters and the BN statistics.

The step mutates the trainer's state, as the JAX step returns a new state
dict: the model (parameters and BN statistics), `state["opt"]` (step count
and both moments), `state["grad_buf"]`, `state["ema"]` and
`state["ema_updates"]`. Everything after the batch's upload is queued on the
card without a host sync; the host computes the schedule's scalars.

f32 work runs in full f32: the whole step, backward and update included,
runs under utils.full_f32, so cuDNN's backward convolutions do not fall back
to TF32 when the process has it on. amp=True (the JAX default, bf16 compute)
is not ported and raises. The epoch loop, the augmenting train loader and
checkpoint writing are not ported either (YOLO.train raises): a caller feeds
batches in JAX's train-batch layout, `img` (B, S, S, 3) uint8 RGB, `cls`
(B, max_gt), `bboxes` (B, max_gt, 4) normalised xywh, `mask_gt` (B, max_gt).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..cfg import DEFAULT_CFG_DICT, get_cfg
from ..data.dataset import YOLODataset, check_det_dataset
from ..nn.tasks import DetectionModel
from ..ops.losses import detection_loss
from ..utils import full_f32, not_ported, resolve_device
from .optim import (GROUPS, adamw_update_, choose_optimizer, clip_grad_norm_, ema_decay, ema_update_, lr_at,
                    param_groups, sgd_update_)
from .validator import DetectionValidator

TRAIN_BATCH_KEYS = ("img", "cls", "bboxes", "mask_gt")
BN_STATS = ("running_mean", "running_var")


def batch_images(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, 3, S, S) f32 images in [0, 1] from the batch's uint8 (B, S, S, 3): an
    NCHW view of the NHWC values, channels_last in memory."""
    return (batch["img"].float() / 255.0).permute(0, 3, 1, 2)


class DetectionTrainer:
    """The detect training step for `model` (a DetectionModel in f32) on the
    dataset `overrides["data"]` names: setup_model(), setup_optimizer(nb),
    then train_step(batch, ni, step_due(ni)) per batch, and validate() to
    score the EMA."""

    def __init__(self, model: DetectionModel, overrides: Optional[dict] = None):
        self.args = get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **(overrides or {})})
        if self.args.amp:
            raise not_ported("amp=True (bf16 training with f32 parameters, BN and EMA); pass amp=False",
                             "item 6b (bf16 training)")
        self.device = resolve_device(self.args.device or "cuda")
        self.batch_size = int(self.args.batch)
        self.imgsz = int(self.args.imgsz if isinstance(self.args.imgsz, int) else self.args.imgsz[0])
        self.data = check_det_dataset(self.args.data)
        self.model = model
        self.state: dict = {}
        self.ema_model: Optional[DetectionModel] = None
        self.validator: Optional[DetectionValidator] = None
        self.metrics: Dict[str, float] = {}
        self.split_events: Optional[list] = None  # a list: train_step records its split there (see _mark)

    def setup_model(self) -> None:
        """The model on the trainer's device (channels_last on the card), in training mode."""
        m = self.model
        if m.nc != self.data["nc"]:
            raise not_ported(f"training a model of nc={m.nc} on data of nc={self.data['nc']} (a rebuilt head)",
                             "item 8 (trainer loop: from-scratch init)")
        if m.dtype != torch.float32:
            raise ValueError(f"the trainer trains an f32 model, got {m.dtype}")
        fmt = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        self.model = m.to(self.device, memory_format=fmt).train()
        self.model.names = self.data["names"]

    def setup_optimizer(self, nb: Optional[int] = None) -> None:
        """The optimizer, its groups and the zeroed state, for `nb` batches per
        epoch (by default the train split's images // batch, as JAX's
        drop_last loader gives), as JAX's train() sets them up."""
        if nb is None:
            nb = len(YOLODataset(self.data["train"], imgsz=self.imgsz).im_files) // self.batch_size
        a = self.args
        self.accumulate = max(round(a.nbs / self.batch_size), 1)
        self.wd_scaled = float(a.weight_decay) * self.batch_size * self.accumulate / a.nbs
        self.opt = choose_optimizer(a, self.data["nc"], nb)
        named = list(self.model.named_parameters())
        groups = param_groups(self.model)
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.groups = {g: [i for i, n in enumerate(self.param_names) if groups[n] == g] for g in GROUPS}
        stats = [(n, b) for n, b in self.model.named_buffers() if n.rsplit(".", 1)[-1] in BN_STATS]
        self.stat_names = [n for n, _ in stats]
        self.stats = [b for _, b in stats]
        with torch.no_grad():
            self.state = {
                "opt": {"step": 0, "mu": [torch.zeros_like(p) for p in self.params],
                        "nu": [torch.zeros_like(p) for p in self.params]},
                "grad_buf": [torch.zeros_like(p) for p in self.params],
                "ema": {"params": [p.detach().float().clone() for p in self.params],
                        "batch_stats": [b.float().clone() for b in self.stats]},
                "ema_updates": 0,
            }
        self.last_opt_step = -1

    def step_due(self, ni: int) -> bool:
        """do_step for iteration ni: an optimizer step every `accumulate`
        iterations, the accumulate ramped from 1 to nbs / batch over the
        warmup (JAX trainer.py:452-460)."""
        acc, wi = self.accumulate, self.opt.warmup_iters
        if wi > 0 and ni <= wi:
            acc = max(1, int(np.interp(ni, [0, wi], [1, self.args.nbs / self.batch_size]).round()))
        if ni - self.last_opt_step >= acc:
            self.last_opt_step = ni
            return True
        return False

    def preprocess_batch(self, batch: dict) -> Dict[str, torch.Tensor]:
        """The train-batch keys as tensors on the trainer's device."""
        out = {}
        for k in TRAIN_BATCH_KEYS:
            v = batch[k]
            v = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
            out[k] = v.to(self.device, non_blocking=True)
        return out

    def forward_train(self, batch: Dict[str, torch.Tensor]):
        """The head's per-level (box, cls) logits in training mode; BN's running statistics move."""
        self.model.train()
        return self.model(batch_images(batch))

    def compute_loss(self, feats, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(total, items (box, cls, dfl)) of the detect loss at the batch's image size."""
        a = self.args
        return detection_loss(feats, batch["cls"], batch["bboxes"], batch["mask_gt"], nc=self.data["nc"],
                              imgsz=int(batch["img"].shape[1]), strides=tuple(float(s) for s in self.model.stride),
                              hyp_box=float(a.box), hyp_cls=float(a.cls), hyp_dfl=float(a.dfl))

    def accumulate_grads(self, loss: torch.Tensor) -> None:
        """Add the loss's gradient to the grad buffer."""
        torch._foreach_add_(self.state["grad_buf"], torch.autograd.grad(loss, self.params))

    @torch.no_grad()
    def optimizer_step(self, ni: int) -> None:
        """Clip the grad buffer, update the parameters at iteration ni's lr,
        zero the buffer, and move the EMA of the parameters and BN statistics."""
        st, opt = self.state, self.opt
        buf = st["grad_buf"]
        clip_grad_norm_(buf, opt.clip_norm)
        lr_main, lr_bias, mom = lr_at(opt, ni)
        st["opt"]["step"] += 1
        for g, idx in self.groups.items():
            if not idx:
                continue
            p, b, m, v = ([t[i] for i in idx] for t in (self.params, buf, st["opt"]["mu"], st["opt"]["nu"]))
            lr, wd = (lr_bias if g == "bias" else lr_main), (self.wd_scaled if g == "decay" else 0.0)
            if opt.kind == "sgd":
                sgd_update_(p, b, m, lr, mom, wd)
            else:
                adamw_update_(p, b, m, v, st["opt"]["step"], lr, opt.momentum, wd)
        torch._foreach_zero_(buf)
        st["ema_updates"] += 1
        d = ema_decay(st["ema_updates"])
        ema_update_(st["ema"]["params"], self.params, d)
        ema_update_(st["ema"]["batch_stats"], self.stats, d)

    def train_step(self, batch: dict, ni: int, do_step: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """One iteration on `batch` at iteration ni: forward, loss, grads into
        the buffer and, with do_step, the optimizer step and the EMA. Returns
        (loss, items (box, cls, dfl)) on the device, without gradient."""
        batch = self.preprocess_batch(batch)
        with full_f32():
            self._mark("start")
            feats = self.forward_train(batch)
            self._mark("forward")
            loss, items = self.compute_loss(feats, batch)
            self._mark("assigner_and_loss")
            self.accumulate_grads(loss)
            self._mark("backward")
            if do_step:
                self.optimizer_step(ni)
            self._mark("clip_update_ema")
        return loss.detach(), items

    def _mark(self, name: str) -> None:
        """With `split_events` set to a list, a CUDA event recorded after each
        part of the step (and one at its start), for its split; nothing
        otherwise."""
        if self.split_events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.split_events.append((name, ev))

    def ema_eval_model(self) -> DetectionModel:
        """The EMA's weights and BN statistics in an eval-mode copy of the
        model, its fused bottlenecks folded from them."""
        if self.ema_model is None:
            self.ema_model = copy.deepcopy(self.model).requires_grad_(False)
        m = self.ema_model
        with torch.no_grad():
            torch._foreach_copy_([p for p in m.parameters()], self.state["ema"]["params"])
            torch._foreach_copy_([b for n, b in m.named_buffers() if n.rsplit(".", 1)[-1] in BN_STATS],
                                 self.state["ema"]["batch_stats"])
        return m.eval()

    def validate(self) -> Dict[str, float]:
        """results_dict of the EMA on the data's val split, through one
        DetectionValidator kept for the trainer's life (f32, the trainer's
        device, imgsz and batch)."""
        model = self.ema_eval_model()
        if self.validator is None:
            a = self.args
            self.validator = DetectionValidator(model, overrides={
                "data": a.data, "imgsz": self.imgsz, "batch": self.batch_size, "workers": a.workers,
                "single_cls": a.single_cls, "device": str(self.device)})
        self.metrics = self.validator()
        return self.metrics
