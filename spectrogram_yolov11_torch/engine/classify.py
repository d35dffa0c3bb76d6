"""The classify trainer on the card: a supervised cross-entropy loop over a folder-per-class dataset.

Counterpart of spectrogram_yolov11_tpu/engine/classify.py:27
ClassificationTrainer. The imgsz default of 640 becomes 224 and batch -1 or
None becomes 16, as in JAX (:33-37). The data resolves as JAX's train()
does (:40-52): `data/train` when it exists, else a folder of class folders,
else a name or YAML that data/dataset.py:check_cls_dataset synthesises when
absent; the dataset's root is what each epoch's validator reads.

The model: the caller's (the facade's, which keeps its YAML's nc, 1000 for
yolo11-cls.yaml, whatever the data's: JAX's facade passes its model and
variables, and JAX rebuilds only a model it is not given, ROADMAP.md
§3.43), or, given None, one built from `args.model` (yolo11n-cls.yaml by
default) with the data's nc, the data's class names and fresh weights from
`args.seed` (JAX :53-57).

One step (engine/trainer.py:DetectionTrainer.train_step, which this class
inherits): the batch's uint8 RGB `img` (B, S, S, 3) and `cls` (B,) uploaded,
images / 255 forwarded in training mode in f32 (JAX's step reads no amp),
ops/losses.py:classification_loss, its gradient, then an optimizer step at
every iteration (no accumulation): the global-norm clip at 10, SGD or AdamW
from engine/optim.py:choose_optimizer with the lr and momentum of iteration
ni (JAX's lr_step = ni), weight decay `weight_decay` unscaled on the conv and
dense weights, and the EMA of the parameters and BN statistics. The
train loader is data/build.py's (shuffled per epoch, drop_last, each sample
from its own Generator, as JAX's DataLoader seeds it).

Each epoch ends with a ClassificationValidator on the EMA's weights at the
trainer's imgsz and batch; the loop returns the last results_dict and leaves
the EMA's weights on the model. As JAX's trainer, it writes no checkpoint, no
results.csv and no run files, runs no callbacks, and reads neither resume
nor amp (ROADMAP.md §3.42); YOLO.save(path) writes the trained model.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..cfg import DEFAULT_CFG_DICT, get_cfg, get_save_dir
from ..data.build import DataLoader
from ..data.dataset import ClassificationDataset, check_cls_dataset
from ..nn.tasks import DetectionModel, build_model
from ..ops.losses import classification_loss
from ..utils import LOGGER, resolve_device
from .trainer import DetectionTrainer
from .validator import ClassificationValidator


class ClassificationTrainer(DetectionTrainer):
    """The classify trainer for `model` (a ClassificationModel in f32, or
    None: one built from `overrides["model"]`) on `overrides["data"]`:
    train() runs the whole loop; a caller that feeds its own batches runs
    setup_data(), setup_model(), setup_optimizer(nb), then train_step(batch,
    ni, True) per batch, and validate()."""

    task = "classify"
    loss_names = ("loss",)
    default_model = "yolo11n-cls.yaml"

    def __init__(self, model: Optional[DetectionModel], overrides: Optional[dict] = None):
        self.args = a = get_cfg(DEFAULT_CFG_DICT, {"mode": "train", **(overrides or {})})
        if a.data is None:
            raise TypeError("training needs data=: a dataset folder, name or YAML")
        self.device = resolve_device(a.device or "cuda")
        self.imgsz = int(a.imgsz if isinstance(a.imgsz, int) else a.imgsz[0])
        if self.imgsz == 640:
            self.imgsz = 224  # the classify default, as JAX's
        self.batch_size = 16 if a.batch in (-1, None) else int(a.batch)
        self.epochs = int(a.epochs)
        self.model = model
        self.save_dir = get_save_dir(a)
        self.callbacks: dict = {}
        self.state: dict = {}
        self.resumed: dict = {}
        self.ema_model: Optional[DetectionModel] = None
        self.validator: Optional[ClassificationValidator] = None
        self.metrics: Dict[str, float] = {}
        self.epoch_log: list = []  # per epoch: {"epoch", "seconds", "steps", "loader_wait_s", "val_s", "loss"}
        self.split_events: Optional[list] = None
        self.data: Optional[dict] = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.float32  # JAX's classify step runs in f32 whatever amp says

    def setup_data(self) -> ClassificationDataset:
        """The train dataset (augmenting) and `data` {root, train, nc, names}, resolved as JAX's train()."""
        root = Path(self.args.data)
        if (root / "train").exists():
            train_dir = root / "train"
        elif root.exists() and any(d.is_dir() for d in root.iterdir()):
            train_dir = root  # a bare folder-per-class layout
        else:  # a name or YAML, synthesised when absent
            train_dir = Path(check_cls_dataset(self.args.data)["train"])
            root = train_dir.parent
        ds = ClassificationDataset(train_dir, imgsz=self.imgsz, augment=True)
        self.data = {"root": str(root), "train": str(train_dir), "nc": len(ds.names), "names": ds.names}
        return ds

    def setup_model(self) -> None:
        """The model on the trainer's device (channels_last on the card), in
        training mode in f32: the caller's, or one built with the data's nc
        and names from args.seed when there is none (JAX :53-57)."""
        m = self.model
        if m is None:
            m = build_model(str(self.args.model or self.default_model), nc=self.data["nc"]).init(self.args.seed)
            m.names = self.data["names"]
        if m.dtype != torch.float32:
            raise ValueError(f"the trainer trains an f32 model, got {m.dtype}")
        fmt = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        self.model = m.set_compute_dtype(torch.float32).to(self.device, memory_format=fmt).train()

    def setup_optimizer(self, nb: int) -> None:
        """DetectionTrainer's optimizer state for `nb` batches per epoch, with
        JAX's classify settings: a step every iteration, weight decay unscaled."""
        super().setup_optimizer(nb)
        self.accumulate, self.wd_scaled = 1, float(self.args.weight_decay)

    def compute_loss(self, logits: torch.Tensor, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(total, items (nll,)) of the cross-entropy against the batch's labels."""
        return classification_loss(logits, batch["cls"])

    def get_validator(self, model: DetectionModel) -> ClassificationValidator:
        """The EMA's validator (JAX :105-106): the data's root, the trainer's imgsz, batch and device."""
        return ClassificationValidator(model, overrides={"data": self.data["root"], "imgsz": self.imgsz,
                                                         "batch": self.batch_size, "workers": self.args.workers,
                                                         "device": str(self.device)})

    def validate(self) -> Dict[str, float]:
        """results_dict of the EMA on the data's val folder."""
        model = self.ema_eval_model()
        if self.validator is None:
            self.validator = self.get_validator(model)
        else:
            self.validator.set_model(model)
        self.metrics = self.validator(data=self.data["root"])
        return self.metrics

    def train(self) -> Dict[str, float]:
        """JAX's train() (:39-116); returns the last validation's results_dict."""
        a = self.args
        ds = self.setup_data()
        self.setup_model()
        loader = DataLoader(ds, self.batch_size, workers=a.workers, shuffle=True, seed=a.seed, drop_last=True,
                            pin_memory=self.device.type == "cuda")
        nb = len(loader)
        if nb == 0:
            raise ValueError(f"training set too small for batch={self.batch_size}")
        self.setup_optimizer(nb)
        for epoch in range(self.epochs):
            t0 = time.perf_counter()
            loader.set_epoch(epoch)
            batches, losses, wait = iter(loader), [], 0.0
            for i in range(nb):
                tw = time.perf_counter()
                batch = next(batches)
                wait += time.perf_counter() - tw
                losses.append(self.train_step(batch, i + nb * epoch, True)[0])
            batches.close()
            tot = float(torch.stack(losses).sum())
            LOGGER.info(f"epoch {epoch + 1}: loss {tot / nb:.4f}")
            tv = time.perf_counter()
            self.validate()
            self.epoch_log.append({"epoch": epoch + 1, "seconds": time.perf_counter() - t0, "steps": nb,
                                   "loader_wait_s": wait, "val_s": time.perf_counter() - tv, "loss": tot / nb})
        with torch.no_grad():  # the EMA's weights on the model, for a chained val(), predict() or save()
            torch._foreach_copy_(self.params, self.state["ema"]["params"])
            torch._foreach_copy_(self.stats, self.state["ema"]["batch_stats"])
        self.model.eval()
        return self.metrics
