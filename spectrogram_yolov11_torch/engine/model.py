"""The `YOLO` facade for the port. Counterpart of
spectrogram_yolov11_tpu/engine/model.py:40 YOLO for the detect, segment,
pose, obb and classify tasks on model YAMLs and the JAX package's `.ckpt` checkpoints:

    YOLO("runs_artifacts/spectrogram_yolo11n.ckpt").predict("capture.npy")
    YOLO("runs_artifacts/spectrogram_yolo11n.ckpt").val(data="spectrogram_synth.yaml", batch=32)
    YOLO("runs_artifacts/spectrogram_yolo11n.ckpt").train(data="spectrogram_synth.yaml", epochs=3)
    YOLO("yolo11n.yaml").train(data="spectrogram_synth.yaml", epochs=2)   # from scratch, the head rebuilt for nc=2
    YOLO("spectrogram_yolo11n.yaml").load("best.ckpt").val(data=...)    # transfer by path and shape
    YOLO("http://127.0.0.1:8000/spec").predict(frames)   # a served model (serve.py)
    YOLO(["run1/weights/best.ckpt", "run2/weights/best.ckpt"]).predict(frames)   # a weight ensemble
    YOLO("yolo11n-seg.yaml").train(data="shapes128-seg.yaml", epochs=3)   # the segment task
    YOLO("yolo11n-pose.yaml").train(data="shapes128-pose.yaml", epochs=3)   # the pose task
    YOLO("yolo11n-obb.yaml").train(data="shapes128-obb.yaml", epochs=3)   # the obb task
    YOLO("yolo11n-cls.yaml").train(data="imagenette160", epochs=3)   # the classify task

The task is the model's (its head: Segment -> "segment", Pose -> "pose",
OBB -> "obb", JAX's guess_model_task), and picks the predictor, validator
and trainer as JAX's task maps do (:289, :300-320): SegmentationPredictor
(Results with masks), SegmentationValidator (box and mask mAP) and
SegmentationTrainer for "segment"; PosePredictor (Results with keypoints),
PoseValidator (box and OKS keypoint mAP) and PoseTrainer for "pose";
OBBPredictor (Results with rotated boxes), OBBValidator (rotated-box mAP by
probiou) and OBBTrainer for "obb"; ClassificationPredictor (Results with
probs), ClassificationValidator (top-1 and top-5) and ClassificationTrainer
(engine/classify.py) for "classify" (JAX :250-253, :292, :320). As JAX's
facade, a model YAML puts its task in the overrides, so its training runs
under runs/<task>/, while predict and val drop it (their run directories
stay runs/detect/*). Ensembles of another task than detect raise (JAX's
assert).

A model YAML (a path, a packaged name such as `yolo11n.yaml`, or the bare
name `yolo11n`, read as `yolo11n.yaml`) builds the network with fresh weights
drawn from seed 0, as the JAX facade inits with PRNGKey(0) (_new :83-87,
_ensure_variables); `load` transfers a checkpoint's weights by path and
shape (:176), `reset_weights` draws them anew, `save` writes a checkpoint in
the JAX layout with epoch -1 (:378), `info` gives layers, parameters and
GFLOPs (:395), `fuse` is a no-op that logs, as JAX's (:428): the port folds
each fused bottleneck whenever the model goes to eval mode. A checkpoint's
weights (EMA before the raw variables) are read on the host, carried across
by the weight bridge and folded for the bottleneck kernel; predict moves the
model to its device, the card unless the caller passes device="cpu", and
raises without a card. Predictors are cached on their sorted overrides, as
in the JAX facade, `half` among them: predict(half=True) runs a bf16 copy of
the model and leaves the f32 model to half=False calls.
val builds a DetectionValidator per call (engine/validator.py), kept as
`self.validator`, with the same defaults and callbacks; train runs a
DetectionTrainer (engine/trainer.py), kept as `self.trainer`, which rebuilds
the head when the data's nc differs from the model's, and leaves the EMA's
weights on the model, at the compute dtype the trainer set: after an
amp=True run (the default) val() and predict() run the model's bf16 copy
even at half=False, as the JAX facade keeps the model whose dtype its
trainer's setup_model changed in place; a later train(amp=False) sets it
back to f32.
A KServe-v2 URL (http:// or https://) makes an inference-only facade over the
served model of any task, as JAX's _load_remote (:130): its task, names,
stride and kpt_shape come from the server's metadata; predict runs
serve.py:RemotePredictor (the task's predictor, its NMS on the client's
device, the card unless device="cpu") and val validator.py:BackendValidator
(scored as detect, as JAX's; a served classifier's val raises ValueError);
train, load, save and the other weight methods raise ValueError.
`embed` gives each image's feature vector (JAX :405-423) and `profile` the
per-layer params, GFLOPs and ms (JAX :399; nn/tasks.py:DetectionModel.profile),
both on the facade's device, the card unless device="cpu".
A list or tuple of model sources makes a weight ensemble, as JAX's facade
(:48-59): each member a YOLO of its own (checkpoints, YAMLs, the fork's
YAMLs; detect only, an AssertionError otherwise, as JAX's), the first, the
lead, giving the facade's model, overrides and names. predict runs
engine/predictor.py:EnsemblePredictor (every member's predictions into one
NMS; an AssertionError when the members' nc differ, as JAX's); train raises
ValueError (inference only, JAX :244); val, info, save, embed and profile use
the lead's model, as JAX's use its model and variables; load and
reset_weights change a copy of the lead held by the facade, not the
members, as JAX's replace the facade's variables only. A served model cannot
be a member (ValueError).
Other model sources and modes (reference .pt files, exported artifacts)
raise NotImplementedError naming the ROADMAP.md item that ports them;
augment=True and visualize=True in predict run TTA and write feature maps
(engine/predictor.py); show=True and video sources raise (ROADMAP.md §1
item 5).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional

import copy

import torch

from ..nn.tasks import build_model, intersect_state_dicts
from ..utils import LOGGER
from ..utils import not_ported as _not_ported
from ..utils.callbacks import default_callbacks
from ..utils.jax_compat import state_dict_to_variables, variables_to_state_dict
from .checkpoint import load_checkpoint, save_checkpoint
from .pipeline import load_model
from .classify import ClassificationTrainer
from .predictor import (BasePredictor, ClassificationPredictor, EnsemblePredictor, OBBPredictor, PosePredictor,
                        SegmentationPredictor)
from .trainer import TASK2TRAINER
from .validator import (BackendValidator, ClassificationValidator, DetectionValidator, OBBValidator, PoseValidator,
                        SegmentationValidator)

TASK2PREDICTOR = {"detect": BasePredictor, "segment": SegmentationPredictor, "pose": PosePredictor,
                  "obb": OBBPredictor, "classify": ClassificationPredictor}
TASK2VALIDATOR = {"detect": DetectionValidator, "segment": SegmentationValidator, "pose": PoseValidator,
                  "obb": OBBValidator, "classify": ClassificationValidator}
TASK2TRAINER = {**TASK2TRAINER, "classify": ClassificationTrainer}


class YOLO:
    """`YOLO('best.ckpt')` or `YOLO('yolo11n.yaml')` on the PyTorch port;
    `device` sets the default device of predict, val and train."""

    def __init__(self, model: str | Path | list | tuple = "yolo11n.yaml", task: Optional[str] = None,
                 verbose: bool = False, device: Optional[str] = None):
        self.callbacks = default_callbacks()
        self._ensemble: Optional[List["YOLO"]] = None
        if isinstance(model, (list, tuple)):  # a weight ensemble (JAX :48-59)
            members = [YOLO(m, task=task, device=device) for m in model]
            assert all(m.task == "detect" for m in members), "weight ensembling supports the detect task"
            if any(m.backend is not None for m in members):
                raise ValueError("a served model cannot be a member of a weight ensemble")
            lead = members[0]
            self._ensemble = members
            self.model_path, self.task, self.ckpt_meta = str(model[0]), lead.task, lead.ckpt_meta
            self.overrides = dict(lead.overrides)
            self.predictor = self._predictor_key = self.validator = self.trainer = self.ckpt_data = None
            self.model, self.backend = lead.model, None
            return
        self.model_path = str(model)
        self.ckpt_meta: Dict[str, Any] = {}
        self.overrides: Dict[str, Any] = {} if device is None else {"device": str(device)}
        self.predictor = None
        self._predictor_key = None
        self.validator = None
        self.trainer = None
        self.ckpt_data = None  # the dataset the checkpoint was trained on, val's default
        self.model = None
        self.backend = None  # the AutoBackend of a served model
        if task not in (None, "detect", "segment", "pose", "obb", "classify"):
            raise _not_ported(f"task {task!r}", "item 11 (other model families)")
        self.task = task or "detect"
        if self.model_path.startswith(("http://", "https://", "grpc://")):
            from ..nn.autobackend import AutoBackend

            self.backend = AutoBackend(self.model_path)
            self.task = task or self.backend.task
            return
        suffix = Path(self.model_path).suffix
        if suffix in {".yaml", ".yml"}:
            self._new(self.model_path)
        elif suffix == ".ckpt":
            self._load_ckpt(self.model_path)
        elif suffix == ".pt":
            raise _not_ported(f"reference .pt import ({self.model_path})", "item 11 (other model families)")
        elif suffix in {".stablehlo", ".tflite", ".onnx"} or (Path(self.model_path) / "saved_model.pb").exists():
            raise _not_ported(f"exported model {self.model_path!r}", "item 9 (the Exporter and the artifact kinds)")
        else:  # a bare name such as 'yolo11n', which the JAX facade reads as 'yolo11n.yaml'
            self._new(self.model_path + ".yaml")

    def _new(self, cfg_path: str) -> None:
        """The model of a YAML, with fresh weights from seed 0 (JAX :83-87 and
        _ensure_variables' PRNGKey(0)), on the host."""
        self.model = build_model(cfg_path).init(0)
        self.task = self.model.task
        self.overrides["model"] = cfg_path
        self.overrides["task"] = self.task

    def _load_ckpt(self, path: str) -> None:
        self.model, meta = load_model(path)
        self.task = self.model.task
        self.model.names = meta.get("names") or {i: f"{i}" for i in range(self.model.nc)}
        self.ckpt_meta = meta
        self.overrides["model"] = path
        self.ckpt_data = (meta.get("train_args") or {}).get("data") or None

    def _local(self, what: str) -> None:
        if self.backend is not None:
            raise ValueError(f"remote (served) models are inference-only: {what} needs a local model")

    def _weights_changed(self) -> None:
        self.predictor, self._predictor_key = None, None  # the next predict rebuilds

    def _own_lead(self) -> None:
        """For an ensemble, a copy of the lead's model on the facade before its
        weights change: JAX's load and reset_weights replace the facade's
        variables, not the members'."""
        if self._ensemble is not None and self.model is self._ensemble[0].model:
            self.model = copy.deepcopy(self.model)

    # -- weights -------------------------------------------------------------
    def load(self, weights: str | Path = "yolo11n.pt") -> "YOLO":
        """Transfer a checkpoint's weights (its EMA before its raw variables)
        into this model, every leaf whose path and shape match; the rest keep
        theirs (JAX :176, `YOLO('yolo11n.yaml').load('best.ckpt')`). The count
        of transferred leaves is logged, as JAX logs it, and kept as
        `self.transferred`. Reference .pt files raise (item 11)."""
        self._local("load")
        self._own_lead()
        path = str(weights)
        if Path(path).suffix == ".pt":
            raise _not_ported(f"reference .pt import ({path})", "item 11 (other model families)")
        tree, _ = load_checkpoint(path)
        src = variables_to_state_dict(tree.get("ema") or tree["variables"])
        merged, self.transferred = intersect_state_dicts(self.model.state_dict(), src)
        self.model.load_state_dict(merged)
        LOGGER.info(f"load({path}): transferred {self.transferred} matching weight leaves")
        self._weights_changed()
        return self

    def reset_weights(self) -> "YOLO":
        """Draw every weight anew from seed 0 (JAX :202)."""
        self._local("reset_weights")
        self._own_lead()
        self.model.init(0)
        self._weights_changed()
        return self

    def eval(self) -> "YOLO":
        """A no-op, as JAX's (:209): predict and val put the model in eval mode themselves."""
        return self

    @property
    def transforms(self):
        """None: no checkpoint carries inference transforms (JAX :223)."""
        return None

    def save(self, path: str | Path) -> None:
        """The model's weights as a checkpoint in the JAX layout (JAX :378):
        epoch -1, no EMA and no optimizer state, the model dict, names and nc
        in its header; YOLO(path) and JAX's facade read it back."""
        from .. import __version__

        self._local("save")
        m = self.model
        save_checkpoint(Path(path), variables=state_dict_to_variables(m.state_dict()), ema_variables=None,
                        opt_state=None, epoch=-1, best_fitness=0.0, updates=0,
                        model_yaml={k: v for k, v in m.yaml.items() if k != "yaml_file"}, names=m.names, nc=m.nc,
                        version=__version__)

    def info(self, imgsz: int = 640, flops: bool = True) -> str:
        """'<name> summary: L layers, P parameters, G GFLOPs @ imgsz px' (JAX :395; nn/tasks.py:DetectionModel.info)."""
        self._local("info")
        return self.model.info(imgsz=imgsz, flops=flops)

    def fuse(self) -> "YOLO":
        """A no-op that logs, as JAX's (:428): the port folds BN into each fused
        bottleneck's kernel weights whenever the model goes to eval mode."""
        LOGGER.info("fuse(): the fused bottlenecks fold BN at eval; conv+BN pairs run unfolded (cuDNN)")
        return self

    def _network(self):
        """The model as predict runs it, on the facade's device (the card unless device="cpu")."""
        from ..utils import resolve_device
        from .pipeline import eval_network

        return eval_network(self.model, False, resolve_device(self.overrides.get("device") or "cuda"))

    def profile(self, imgsz: int = 256, **kwargs) -> List[dict]:
        """Per-layer rows {i, type, params, gflops, ms} of a forward at imgsz,
        and the table logged (JAX :399; DetectionModel.profile takes batch and
        timed)."""
        self._local("profile")
        return self._network().profile(imgsz=imgsz, **kwargs)

    def embed(self, source, embed: Optional[list] = None, imgsz: int = 640, **kwargs) -> List:
        """One (C,) float32 feature vector per image of `source` (JAX :405-423):
        each image letterboxed alone to imgsz x imgsz (JAX's letterbox, scaled
        up or down, padded with 114), BGR -> RGB, / 255, and the outputs of the
        layers `embed` names (by default the one before the head, len(model) -
        2) mean-pooled over H and W and concatenated."""
        import numpy as np

        from ..data.augment import letterbox_train
        from ..data.loaders import load_inference_source

        self._local("embed")
        net = self._network()
        dev = next(net.parameters()).device
        idxs = tuple(embed) if embed else (len(net.model) - 2,)
        out = []
        with torch.inference_mode():
            for _path, img, _ in load_inference_source(source, device=dev):
                img = img.cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
                lb, _, _ = letterbox_train(img, int(imgsz))
                x = torch.from_numpy(np.ascontiguousarray(lb[None, ..., ::-1])).to(dev).float()
                x = x / torch.tensor(255.0, device=dev)  # an IEEE division on the card too, as numpy's
                out.append(net(x.permute(0, 3, 1, 2), embed=idxs)[0].float().cpu().numpy())
        return out

    # -- callbacks ---------------------------------------------------------
    def add_callback(self, event: str, func) -> None:
        """Attach `func` to `event`; it is forwarded to every predictor this model creates."""
        self.callbacks.setdefault(event, []).append(func)

    def clear_callback(self, event: str) -> None:
        self.callbacks[event] = []

    def reset_callbacks(self) -> None:
        self.callbacks = default_callbacks()

    def _merge_callbacks(self, runner) -> None:
        cbs = getattr(runner, "callbacks", None)
        if cbs is None:
            cbs = runner.callbacks = {}
        for e, fns in self.callbacks.items():
            for f in fns:
                if f not in cbs.setdefault(e, []):
                    cbs[e].append(f)

    # -- properties ----------------------------------------------------------
    @property
    def names(self) -> Dict[int, str]:
        return self.backend.names if self.backend is not None else self.model.names

    @property
    def stride(self):
        return tuple(float(s) for s in self.backend.stride) if self.backend is not None else self.model.stride

    @property
    def device(self) -> str:
        """The model's device; for a served model the client's, where its NMS runs."""
        if self.backend is not None:
            return str(torch.device(self.overrides.get("device") or "cuda"))
        return str(next(self.model.parameters()).device)

    # -- modes ---------------------------------------------------------------
    def predict(self, source=None, stream: bool = False, **kwargs) -> List:
        overrides = {k: v for k, v in {**self.overrides, **kwargs}.items() if k not in {"model", "task", "mode"}}
        key = tuple(sorted((k, repr(v)) for k, v in overrides.items()))
        if self.predictor is None or self._predictor_key != key:
            if self.backend is not None:
                from ..serve import RemotePredictor

                self.predictor = RemotePredictor(self.backend, overrides=overrides)
            elif self._ensemble is not None:
                self.predictor = EnsemblePredictor([m.model for m in self._ensemble], overrides=overrides,
                                                   names=self.names)
            else:
                self.predictor = TASK2PREDICTOR[self.task](self.model, overrides=overrides, names=self.names)
            self._predictor_key = key
        self.predictor.callbacks = self.callbacks  # shared, as in the JAX facade
        return self.predictor(source, stream=stream, batch_size=kwargs.get("batch", 1))

    def __call__(self, source=None, **kwargs):
        return self.predict(source, **kwargs)

    def train(self, **kwargs) -> Dict[str, float]:
        """Train the model on `data` (JAX facade :241-268): train(data=...,
        epochs=N, ...) -> the last validation's results_dict, in bf16 with f32
        parameters at the default amp=True, in f32 with amp=False. A model
        whose nc differs from the data's is rebuilt first, every matching leaf
        grafted (engine/trainer.py:setup_model). Afterwards the facade holds
        the trained model with the EMA's weights at the trainer's compute dtype
        (bf16 after amp: val() and predict() then run bf16), and the next
        predict builds its predictor anew; see engine/trainer.py for the
        options that raise."""
        if self._ensemble is not None:
            raise ValueError("weight ensembles are inference-only; train the members individually")
        if self.backend is not None:
            raise ValueError("remote (served) models are inference-only; train locally and re-serve")
        overrides = {k: v for k, v in {**self.overrides, **kwargs}.items() if k != "mode"}
        overrides.setdefault("model", self.model_path)
        trainer = TASK2TRAINER[self.task](self.model, overrides)
        self._merge_callbacks(trainer)
        metrics = trainer.train()
        self.model, self.trainer = trainer.model, trainer
        self._weights_changed()
        return metrics

    def val(self, **kwargs) -> Dict[str, float]:
        """mAP of the model over a dataset: val(data="spectrogram_synth.yaml",
        batch=32) -> results_dict; `data` is a dataset YAML (path or the name of
        one of the port's packaged copies) or a dict. Without it, the data the
        checkpoint was trained on (its train_args), as the JAX facade does; a
        TypeError when the checkpoint names none either."""
        overrides = {k: v for k, v in {**self.overrides, **kwargs}.items() if k not in {"model", "task", "mode"}}
        data = overrides.pop("data", None) or self.ckpt_data
        if data is None:
            raise TypeError("val() needs data=: a dataset YAML or dict (the checkpoint names none)")
        if self.backend is not None:  # scored through the served graph, the val NMS here
            validator = BackendValidator(self.backend, overrides=overrides)
        else:
            validator = TASK2VALIDATOR[self.task](self.model, overrides=overrides)
        validator.callbacks = self.callbacks  # shared, as in the JAX facade
        self.validator = validator
        return validator(data=data)

    def track(self, *args, **kwargs):
        raise _not_ported("tracking", "item 12 (host-side remainder: trackers)")

    def export(self, **kwargs):
        raise _not_ported("export", "item 9 (the Exporter and the artifact kinds)")

    def benchmark(self, **kwargs):
        raise _not_ported("benchmark", "item 12 (host-side remainder: benchmark)")
