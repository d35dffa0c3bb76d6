"""The detect trainer on the card: the training step, its epoch loop and checkpoints.

Counterpart of spectrogram_yolov11_tpu/engine/trainer.py: batch_images
(:75-90), EarlyStopping (:112-129), compute_loss / forward_train /
_make_train_step (:251-336), train (:339-522), validate (:524-537),
_save_ckpt (:539-565), _resume (:567-593) and _write_csv (:611). One step:

  the batch's upload -> its images: the train loader's tiles and parameters
  assembled on the card (ops/device_augment.py), or its uint8 `img` (the
  host-augmented loader's, or a caller's) -> images / 255 -> forward in training mode (BN on batch statistics, its
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

train() is JAX's loop: the augmenting train loader (data/build.py, shuffled
per epoch, drop_last), the warmup-ramped accumulation, close_mosaic for the
last epochs, the EMA validated every epoch (and on the last), results.csv,
last.ckpt / best.ckpt (and epoch{n}.ckpt every save_period) in the JAX
checkpoint layout, early stopping on fitness, the `time` budget, resume, and
the EMA's weights left on the model at the end. The loss items stay on the
card until the epoch ends, so a step needs no host sync.

amp=True, the default as in JAX, trains in bf16 as JAX's compute_dtype
(:171-181) does: the model computes in bf16 (set_compute_dtype: the input and
each conv's f32 weights cast to bf16, BN in f32 on the conv output upcast,
SiLU in f32, the result rounded to bf16), the loss upcasts the head's outputs
to f32, and the gradients reach the f32 parameters through the casts. The
parameters, the grad buffer, both moments, the EMA and the BN statistics stay
f32, and there is no loss scaling (JAX has no grad scaler). The EMA's val runs
a bf16 copy of the EMA (DetectionModel.set_dtype), made anew each epoch, as
JAX's validator runs the bf16 graph. amp=False trains in f32.

The model: the caller's (the facade's), or, given None, one built from
`args.model` (default yolo11n.yaml) with the data's nc and fresh weights
from `args.seed` (JAX :204-216). A model whose nc differs from the data's is
rebuilt with the data's nc, drawn from `args.seed`, and every leaf of the old
model whose path and shape match is grafted onto it (JAX :191-203,
nn/tasks.py:intersect_state_dicts); `rebuilt` records the nc change and the
grafted count. So YOLO("yolo11n.yaml") (nc 80) trains on 2-class data with
every leaf but the class branch's carried over.

f32 work runs in full f32: the whole step, backward and update included,
runs under utils.full_f32, so cuDNN's backward convolutions do not fall back
to TF32 when the process has it on.

plots=True, the default as in JAX, writes train_batch{0,1,2}.jpg from the
first three iterations (JAX :445-446, _plot_train_batch :595-609: in
device-augment mode the batch's images are assembled once more by
ops/device_augment.py:augment_batch, brought to the host as uint8 and drawn
by utils/plotting.py:plot_images) and results.png from results.csv at the end
(:505-513); a failed plot is logged, not raised, as in JAX. The EMA's
validator runs with plots=False, as JAX's (:528). profile=True records a
torch.profiler trace (CPU, and CUDA on the card) of the epochs and writes it
as a Chrome trace under <save_dir>/profile, where JAX writes its
jax.profiler trace (:410-415, :503-504). batch=-1 picks the batch by
AutoBatch (utils/autobatch.py; JAX :345-348), kept with its probes as
`autobatch`. The train loader augments in the mode
data/augment.py:resolve_device_augment picks (JAX :218-230); in host mode its
batches carry `img`. multi_scale (host mode; under device mode it warns and
is ignored, as in JAX :418-420) draws one size per step from the ladder
{max(32, round(S * f / 32) * 32)} for f in 0.5, 0.75, 1, 1.25, 1.5 with
default_rng(seed + 1234) (JAX :421-424, :447-450) and resizes the step's
images to it as cv2's INTER_LINEAR does (data/augment.py:resize_linear_u8,
integer tensor ops that give the same bytes on the card as on the host, so
they run after the upload); `ms_sizes_drawn` keeps the draws. A new size
costs cuDNN a new set of plans, not a recompile.
"""

from __future__ import annotations

import copy
import csv
import time
import warnings
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..cfg import DEFAULT_CFG_DICT, get_cfg, get_save_dir
from ..data.augment import resize_linear_u8
from ..data.build import DataLoader
from ..data.dataset import YOLODataset, check_det_dataset
from ..nn.tasks import DetectionModel, build_model, intersect_state_dicts
from ..ops.device_augment import augment_batch
from ..ops.losses import detection_loss
from ..utils import LOGGER, RUNS_DIR, full_f32, get_latest_run, plotting, resolve_device
from ..utils.callbacks import default_callbacks, run_callbacks
from ..utils.jax_compat import (opt_state_from_flax, opt_state_to_flax, state_dict_to_variables,
                                variables_to_state_dict)
from .checkpoint import load_checkpoint, save_checkpoint, strip_optimizer
from .optim import (GROUPS, adamw_update_, choose_optimizer, clip_grad_norm_, ema_decay, ema_update_, lr_at,
                    param_groups, sgd_update_)
from .validator import DetectionValidator

AUG_KEYS = ("aug_src", "aug_regions", "aug_pads", "aug_inv", "aug_hsv")
TRAIN_BATCH_KEYS = ("img", "cls", "bboxes", "mask_gt", *AUG_KEYS)  # a batch holds `img` or the aug_* keys
BN_STATS = ("running_mean", "running_var")
LOSS_NAMES = ("box_loss", "cls_loss", "dfl_loss")


def batch_images(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, 3, S, S) f32 images in [0, 1], an NCHW view of NHWC values: the
    batch's uint8 `img` (B, S, S, 3) RGB, or the images the train loader's
    tiles and parameters give (ops/device_augment.py), assembled here."""
    img = batch["img"].float() if "img" in batch else augment_batch(*(batch[k] for k in AUG_KEYS))
    return (img / 255.0).permute(0, 3, 1, 2)


def batch_imgsz(batch: Dict[str, torch.Tensor]) -> int:
    """The square image size of a train batch, in either layout."""
    return int(batch["img"].shape[1] if "img" in batch else batch["aug_src"].shape[2])


class EarlyStopping:
    """Stop after `patience` epochs without a fitness at least as good as the
    best (JAX :112-129); 0 never stops."""

    def __init__(self, patience: int = 100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: Optional[float]) -> bool:
        if fitness is None:
            return False
        if fitness >= self.best_fitness:
            self.best_epoch, self.best_fitness = epoch, fitness
        return (epoch - self.best_epoch) >= self.patience


class DetectionTrainer:
    """The detect trainer for `model` (a DetectionModel in f32, or None: one
    built from `overrides["model"]`) on the dataset `overrides["data"]`
    names: train() runs the whole loop; a caller that feeds its own batches
    runs setup_model(), setup_optimizer(nb), then train_step(batch, ni,
    step_due(ni)) per batch, and validate() to score the EMA."""

    def __init__(self, model: Optional[DetectionModel], overrides: Optional[dict] = None):
        self.args = get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **(overrides or {})})
        a = self.args
        if a.data is None:
            raise TypeError("training needs data=: a dataset YAML or dict")
        self.device = resolve_device(a.device or "cuda")
        self.batch_size = -1 if a.batch is None else int(a.batch)  # -1: AutoBatch picks it in train()
        self.epochs = int(a.epochs)
        self.imgsz = int(a.imgsz if isinstance(a.imgsz, int) else a.imgsz[0])
        self.data = check_det_dataset(a.data)
        self.model = model
        self.save_dir = get_save_dir(a)
        self.wdir = self.save_dir / "weights"
        self.last, self.best = self.wdir / "last.ckpt", self.wdir / "best.ckpt"
        self.csv = self.save_dir / "results.csv"
        self.callbacks = default_callbacks()
        self.state: dict = {}
        self.resumed: dict = {}
        self.start_epoch = 0
        self.best_fitness = 0.0
        self.ema_model: Optional[DetectionModel] = None
        self.validator: Optional[DetectionValidator] = None
        self.metrics: Dict[str, float] = {}
        self.epoch_log: list = []  # per epoch: seconds, loader wait, val seconds (train())
        self.split_events: Optional[list] = None  # a list: train_step records its split there (see _mark)
        self.rebuilt: Optional[dict] = None  # {"nc": (model's, data's), "grafted": leaves} after an nc rebuild
        self.autobatch: Optional[dict] = None  # {"batch", "probes" {batch: peak bytes or None}, "seconds"}
        self.ms_sizes_drawn: list = []  # multi_scale: the image size drawn for each step

    @property
    def compute_dtype(self) -> torch.dtype:
        """bfloat16 with amp=True (parameters, optimizer, EMA and BN statistics stay f32), else float32."""
        return torch.bfloat16 if self.args.amp else torch.float32

    def setup_model(self) -> None:
        """The model on the trainer's device (channels_last on the card), in
        training mode at the trainer's compute dtype, as JAX's setup_model
        retraces the facade's model in place (:178-181): rebuilt for the
        data's nc when it differs, or built from args.model when there is
        none (JAX :191-216)."""
        m, nc, seed = self.model, self.data["nc"], self.args.seed
        if m is not None and m.nc != nc:
            LOGGER.info(f"Overriding model nc={m.nc} with dataset nc={nc}")
            new = build_model({k: v for k, v in m.yaml.items() if k != "yaml_file"}, nc=nc).init(seed)
            merged, grafted = intersect_state_dicts(new.state_dict(), m.state_dict())
            new.load_state_dict(merged)
            self.rebuilt = {"nc": (m.nc, nc), "grafted": grafted}
            m = new
        if m is None:
            m = build_model(str(self.args.model or "yolo11n.yaml"), nc=nc).init(seed)
        if m.dtype != torch.float32:
            raise ValueError(f"the trainer trains an f32 model, got {m.dtype}")
        fmt = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        self.model = m.set_compute_dtype(self.compute_dtype).to(self.device, memory_format=fmt).train()
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
            r = self.resumed
            if r.get("opt_state") is not None:
                step, mu, nu = opt_state_from_flax(r["opt_state"], self.param_names, self.params)
                self.state["opt"]["step"] = step
                torch._foreach_copy_(self.state["opt"]["mu"], mu)
                torch._foreach_copy_(self.state["opt"]["nu"], nu)
            if r.get("ema") is not None:
                sd = variables_to_state_dict(r["ema"])
                torch._foreach_copy_(self.state["ema"]["params"], [sd[n] for n in self.param_names])
                torch._foreach_copy_(self.state["ema"]["batch_stats"], [sd[n] for n in self.stat_names])
            self.state["ema_updates"] = int(r.get("updates", 0))
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
        """The batch's train keys as tensors on the trainer's device (a
        non_blocking upload from the train loader's pinned memory)."""
        out = {}
        for k in TRAIN_BATCH_KEYS:
            if k in batch:
                v = batch[k]
                v = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
                out[k] = v.to(self.device, non_blocking=True)
        return out

    def forward_train(self, images: torch.Tensor):
        """The head's per-level (box, cls) logits in training mode; BN's running statistics move."""
        self.model.train()
        return self.model(images)

    def compute_loss(self, feats, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(total, items (box, cls, dfl)) of the detect loss at the batch's image size."""
        a = self.args
        return detection_loss(feats, batch["cls"], batch["bboxes"], batch["mask_gt"], nc=self.data["nc"],
                              imgsz=batch_imgsz(batch), strides=tuple(float(s) for s in self.model.stride),
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
        """One iteration on `batch` at iteration ni: upload, images, forward,
        loss, grads into the buffer and, with do_step, the optimizer step and
        the EMA. Returns (loss, items (box, cls, dfl)) on the device, without
        gradient."""
        self._mark("start")
        batch = self.preprocess_batch(batch)
        self._mark("upload")
        with full_f32():
            images = batch_images(batch)
            self._mark("augment")
            feats = self.forward_train(images)
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
        DetectionValidator kept for the trainer's life (the trainer's device,
        imgsz and batch). With amp the EMA model computes in bf16, so the
        validator scores a bf16 copy of it, made anew at each call
        (set_model), as JAX's validator applies the bf16 graph."""
        model = self.ema_eval_model()
        if self.validator is None:
            a = self.args
            self.validator = DetectionValidator(model, overrides={
                "data": a.data, "imgsz": self.imgsz, "batch": self.batch_size, "workers": a.workers,
                "single_cls": a.single_cls, "device": str(self.device), "plots": False})
        else:
            self.validator.set_model(model)
        self.metrics = self.validator()
        return self.metrics

    # -- the loop ------------------------------------------------------------
    def build_dataset(self) -> YOLODataset:
        """The train split (its augment mode from the args), the GT pad sized from its labels."""
        a = self.args
        return YOLODataset(self.data["train"], imgsz=self.imgsz, max_gt=0, single_cls=a.single_cls, augment=True,
                           hyp=a, fraction=a.fraction, cache=a.cache)

    def train(self) -> Dict[str, float]:
        """JAX's train() (:339-522) for the detect task; returns the last
        validation's results_dict. The EMA's weights are on the model after."""
        a = self.args
        self.setup_model()
        if a.resume:
            self._resume()
        if self.batch_size == -1:
            from ..utils.autobatch import check_train_batch_size

            t0, probes = time.perf_counter(), {}
            self.batch_size = check_train_batch_size(self.model, imgsz=self.imgsz, nc=self.data["nc"], probes=probes)
            self.autobatch = {"batch": self.batch_size, "probes": probes, "seconds": time.perf_counter() - t0}
            LOGGER.info(f"AutoBatch: using batch={self.batch_size}")
        self.wdir.mkdir(parents=True, exist_ok=True)
        train_ds = self.build_dataset()
        if a.close_mosaic and self.start_epoch > max(self.epochs - a.close_mosaic, 0):
            train_ds.close_mosaic()  # resumed past the close_mosaic boundary
        loader = DataLoader(train_ds, self.batch_size, workers=a.workers, shuffle=True, seed=a.seed, drop_last=True,
                            pin_memory=self.device.type == "cuda")
        nb = len(loader)
        if nb == 0:
            raise ValueError(f"training set too small for batch={self.batch_size}")
        self.setup_optimizer(nb)
        stopper = EarlyStopping(a.patience)
        save = a.save is not False  # True, the default, saves the checkpoints
        prof = self._start_profile() if a.profile else None
        try:
            self._epochs(train_ds, loader, nb, stopper, save)
        finally:
            if prof is not None:
                self._stop_profile(prof)
        if a.plots:
            try:
                if self.csv.exists():
                    plotting.plot_results(self.csv, self.save_dir)
            except Exception as e:  # plotting must never fail a training run
                LOGGER.warning(f"plot_results failed: {e}")
        if save and self.best.exists():
            strip_optimizer(self.best)
        run_callbacks(self.callbacks, "on_train_end", self)
        with torch.no_grad():  # the final weights on the model, for a chained val() or predict()
            torch._foreach_copy_(self.params, self.state["ema"]["params"])
            torch._foreach_copy_(self.stats, self.state["ema"]["batch_stats"])
        self.model.eval()
        return self.metrics

    def _start_profile(self):
        """A started torch.profiler over the CPU, and the card's kernels when training there."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        """Stop the profiler and write its Chrome trace under <save_dir>/profile."""
        prof.stop()
        trace_dir = self.save_dir / "profile"
        trace_dir.mkdir(parents=True, exist_ok=True)
        self.trace_path = trace_dir / "train.pt.trace.json"
        prof.export_chrome_trace(str(self.trace_path))
        LOGGER.info(f"torch.profiler trace -> {self.trace_path}")

    def _plot_train_batch(self, batch: dict, ni: int) -> None:
        """train_batch{ni}.jpg: the batch's mosaic (JAX :595-609); in
        device-augment mode its images are assembled once more on the trainer's
        device and brought to the host as uint8."""
        try:
            if "img" not in batch:
                dev = self.preprocess_batch(batch)
                with torch.no_grad():
                    img = augment_batch(*(dev[k] for k in AUG_KEYS)).to(torch.uint8).cpu().numpy()
                batch = {**batch, "img": img}
            plotting.plot_images(batch, self.model.names, self.save_dir / f"train_batch{ni}.jpg")
        except Exception as e:  # plotting must never fail a training run
            LOGGER.warning(f"train batch plot failed: {e}")

    def _epochs(self, train_ds: YOLODataset, loader: DataLoader, nb: int, stopper: EarlyStopping, save: bool) -> None:
        """The epoch loop of train(): steps, the EMA's val, results.csv, checkpoints, early stopping."""
        a = self.args
        run_callbacks(self.callbacks, "on_train_start", self)
        ms_sizes, ms_rng = None, None
        if a.multi_scale and train_ds.transform.device_mode:
            LOGGER.warning("multi_scale is not supported with device_augment; ignoring multi_scale")
        elif a.multi_scale:
            ms_sizes = sorted({max(32, int(round(self.imgsz * f / 32)) * 32) for f in (0.5, 0.75, 1.0, 1.25, 1.5)})
            ms_rng = np.random.default_rng(a.seed + 1234)
            LOGGER.info(f"Multi-scale training over {ms_sizes}")
        t_start = time.time()
        for epoch in range(self.start_epoch, self.epochs):
            self.epoch = epoch
            run_callbacks(self.callbacks, "on_train_epoch_start", self)
            if epoch == max(self.epochs - a.close_mosaic, 0) and a.close_mosaic:
                train_ds.close_mosaic()
            loader.set_epoch(epoch)
            t_epoch, wait, items = time.perf_counter(), 0.0, []
            t0 = t_epoch
            for i, batch in enumerate(loader):
                wait += time.perf_counter() - t0  # the host's wait for the loader
                ni = i + nb * epoch
                if a.plots and ni < 3:
                    self._plot_train_batch(batch, ni)
                if ms_sizes is not None:
                    sz = int(ms_rng.choice(ms_sizes))
                    self.ms_sizes_drawn.append(sz)
                    if sz != batch["img"].shape[1]:
                        img = batch["img"]
                        img = (img if torch.is_tensor(img) else torch.from_numpy(img)).to(self.device, non_blocking=True)
                        batch = {**batch, "img": resize_linear_u8(img, sz, sz)}
                items.append(self.train_step(batch, ni, self.step_due(ni))[1])
                run_callbacks(self.callbacks, "on_train_batch_end", self)
                t0 = time.perf_counter()
            mloss = np.zeros(len(LOSS_NAMES))
            for i, x in enumerate(torch.stack(items).cpu().numpy()):  # JAX's running mean, in float64
                mloss = (mloss * i + x) / (i + 1)
            self.label_loss = {f"train/{n}": v for n, v in zip(LOSS_NAMES, mloss)}
            fitness, t_val = None, time.perf_counter()
            if a.val or epoch == self.epochs - 1:
                self.metrics = self.validate()
                fitness = self.metrics.get("fitness", 0.0)
                if fitness >= self.best_fitness:
                    self.best_fitness = fitness
            self.epoch_log.append({"epoch": epoch, "seconds": time.perf_counter() - t_epoch, "steps": nb,
                                   "loader_wait_s": wait, "val_s": time.perf_counter() - t_val})
            self._write_csv(epoch, mloss, self.metrics)
            run_callbacks(self.callbacks, "on_fit_epoch_end", self)
            if save:
                self._save_ckpt(epoch, fitness)
            stop = stopper(epoch, fitness)
            if a.time and (time.time() - t_start) / 3600 > a.time:
                stop = True
            if stop:
                break

    def _flax(self, names, tensors) -> dict:
        return state_dict_to_variables(dict(zip(names, tensors)))

    def _save_ckpt(self, epoch: int, fitness: Optional[float]) -> None:
        """last.ckpt, best.ckpt when the fitness is the best so far, and
        epoch{n}.ckpt every save_period epochs, in the JAX layout: the weights
        and the EMA as flax trees, the optimizer state in tree form."""
        from .. import __version__

        st = self.state
        ema = self._flax(self.param_names, st["ema"]["params"])
        ema["batch_stats"] = self._flax(self.stat_names, st["ema"]["batch_stats"])["batch_stats"]
        kw = dict(variables=state_dict_to_variables(self.model.state_dict()), ema_variables=ema,
                  opt_state=opt_state_to_flax(st["opt"]["step"], self.param_names, st["opt"]["mu"], st["opt"]["nu"]),
                  epoch=epoch, best_fitness=self.best_fitness, updates=st["ema_updates"], train_args=dict(self.args),
                  model_yaml={k: v for k, v in self.model.yaml.items() if k != "yaml_file"},
                  names=self.model.names, nc=self.model.nc, version=__version__)
        save_checkpoint(self.last, **kw)
        if fitness is not None and fitness >= self.best_fitness:
            save_checkpoint(self.best, **kw)
        if self.args.save_period > 0 and (epoch + 1) % self.args.save_period == 0:
            save_checkpoint(self.wdir / f"epoch{epoch}.ckpt", **kw)

    def _resume(self) -> None:
        """The weights, epoch, best fitness, optimizer state, EMA and EMA
        update count of a checkpoint (JAX :567-593): this run's last.ckpt if
        it exists, else the path `resume` names, else (resume=True) the newest
        last*.ckpt under the project (or runs) dir. The optimizer state and
        the EMA are applied by setup_optimizer."""
        a = self.args
        path = self.last if self.last.exists() else Path(str(a.resume))
        if not path.exists() and str(a.resume).lower() in {"true", "1"}:
            latest = get_latest_run(Path(a.project) if a.project else RUNS_DIR)
            path = Path(latest) if latest else path
        if not path.exists():
            warnings.warn(f"resume checkpoint not found at {path}; training from the model's weights")
            return
        tree, meta = load_checkpoint(path)
        with torch.no_grad():
            self.model.load_state_dict(variables_to_state_dict(tree["variables"]))
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_fitness = float(meta.get("best_fitness", 0.0))
        self.resumed = {"opt_state": tree.get("opt_state"), "ema": tree.get("ema"),
                        "updates": int(meta.get("updates", 0))}

    def _write_csv(self, epoch: int, mloss, metrics: Dict[str, float]) -> None:
        row = {"epoch": epoch, **{f"train/{n}": float(v) for n, v in zip(LOSS_NAMES, mloss)},
               **{k: float(v) for k, v in metrics.items()}}
        write_header = not self.csv.exists()
        self.csv.parent.mkdir(parents=True, exist_ok=True)
        with open(self.csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if write_header:
                w.writeheader()
            w.writerow(row)
