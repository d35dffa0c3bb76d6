"""Model dict -> network graph, and the detection model of the port.

Counterpart of spectrogram_yolov11_tpu/nn/tasks.py: parse_model (:232), the
YOLOGraph routing (:379), DetectionModel and build_model, restricted to the
modules the trained spectrogram detector and the stock YOLO11 detect models
use. Scaling matches the JAX parse_model: channels make_divisible(min(c,
max_channels) * width, 8), repeats max(round(n * depth), 1). Any other module
name raises KeyError.

The model is built from a dict (a checkpoint's `model_yaml`), so the port
needs no YAML parser.
"""

from __future__ import annotations

import ast
import contextlib
import copy
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..utils import full_f32, make_divisible
from ..utils.jax_compat import variables_to_state_dict
from . import modules as M

MODULE_REGISTRY: Dict[str, type] = {
    "Conv": M.Conv,
    "DWConv": M.DWConv,
    "Bottleneck": M.Bottleneck,
    "C3k": M.C3k,
    "C3k2": M.C3k2,
    "SPPF": M.SPPF,
    "C2PSA": M.C2PSA,
    "HCoordAtt": M.HCoordAtt,
    "Concat": M.Concat,
    "nn.Upsample": M.Upsample,
    "Detect": M.Detect,
}
BASE_MODULES = {M.Conv, M.DWConv, M.Bottleneck, M.C3k, M.C3k2, M.SPPF, M.C2PSA, M.HCoordAtt}
REPEAT_MODULES = {M.C3k, M.C3k2, M.C2PSA}
SCALE_SENSITIVE = {M.C3k2}  # args[3] (c3k) flips on m/l/x scales


def parse_model(d: dict, ch: int) -> Tuple[List[nn.Module], List[Any], List[int]]:
    """Returns (layers, their `from` routes, sorted save list)."""
    legacy = True
    max_channels = float("inf")
    nc, scales = d.get("nc"), d.get("scales")
    depth, width = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0)
    scale = d.get("scale")
    if scales:
        scale = scale or tuple(scales.keys())[0]
        depth, width, max_channels = scales[scale]

    eval_ctx = {"nc": nc}
    ch_list = [ch]
    layers: List[nn.Module] = []
    routes: List[Any] = []
    save: List[int] = []
    for i, (f, n, m, args) in enumerate(d["backbone"] + d["head"]):
        if m not in MODULE_REGISTRY:
            raise KeyError(f"Unknown module '{m}' in model dict (layer {i}). Known: {sorted(MODULE_REGISTRY)}")
        cls = MODULE_REGISTRY[m]
        args = list(args)
        for j, a in enumerate(args):
            if isinstance(a, str):
                if a in eval_ctx:
                    args[j] = eval_ctx[a]
                else:
                    with contextlib.suppress(ValueError, SyntaxError):
                        args[j] = ast.literal_eval(a)
        n = max(round(n * depth), 1) if n > 1 else n
        kwargs: Dict[str, Any] = {}
        if cls in BASE_MODULES:
            c1, c2 = ch_list[f], args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            args = [c1, c2, *args[1:]]
            if cls in REPEAT_MODULES:
                args.insert(2, n)
                n = 1
            if cls in SCALE_SENSITIVE:
                legacy = False
                if scale in "mlx":
                    if len(args) > 3:
                        args[3] = True
                    else:
                        args.append(True)
        elif cls is M.Concat:
            c2 = sum(ch_list[x] for x in f)
        elif cls is M.Detect:
            args.append(tuple(ch_list[x] for x in f))
            kwargs["legacy"] = legacy
            c2 = None
        else:  # Upsample
            c2 = ch_list[f]

        layer = nn.Sequential(*(cls(*args, **kwargs) for _ in range(n))) if n > 1 else cls(*args, **kwargs)
        layers.append(layer)
        routes.append(f)
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            ch_list = []
        ch_list.append(c2)
    return layers, routes, sorted(set(save))


class DetectionModel(nn.Module):
    """The detection network built from a model dict. It is built in eval
    mode; `eval()` and `load_state_dict` fold the BN of every fused bottleneck
    into its kernel's weights, so a model whose weights moved in training runs
    the kernel on its current weights once it is back in eval mode. In
    training mode BN uses batch statistics (flax's semantics) and the
    bottlenecks run unfused. It runs in f32; a bf16 copy comes from
    `set_dtype`.

    `compute_dtype` is the dtype the f32 model computes in when it trains:
    float32, or bfloat16 after `set_compute_dtype` (amp training). Its
    parameters and BN statistics stay f32 either way. The predictor and the
    validator run such a model's bf16 copy, as the JAX graph that
    `set_dtype` retraced runs in bf16 in eval too.

    forward(x (B, 3, H, W) float) -> per-level (box, cls) logits, NCHW, in the
    model's dtype (in training mode, in its compute dtype)."""

    def __init__(self, cfg: dict, ch: int = 3, nc: Optional[int] = None):
        super().__init__()
        self.yaml = copy.deepcopy(cfg)
        if nc and nc != self.yaml.get("nc"):
            self.yaml["nc"] = nc
        self.nc = self.yaml["nc"]
        self.dtype = torch.float32  # the activations' dtype; parameters too, except BN's, which stay f32
        self.compute_dtype = torch.float32  # the activations' dtype in training; parameters stay f32
        layers, self.routes, self.save = parse_model(self.yaml, ch)
        self.model = nn.ModuleList(layers)
        self.eval()
        s = 256  # dummy forward for the strides, as the JAX BaseModel does
        with torch.no_grad():
            feats = self.forward(torch.zeros(1, ch, s, s))
        self.stride = tuple(s / box.shape[-2] for box, _ in feats)

    @full_f32()
    def forward(self, x: torch.Tensor):
        # a bf16 network rounds its input to bf16, as the JAX model's first conv does
        x = x.to(self.compute_dtype if self.training else self.dtype)
        y: List[Optional[torch.Tensor]] = []
        for i, (m, f) in enumerate(zip(self.model, self.routes)):
            if f != -1:
                x = y[f] if isinstance(f, int) else [x if j == -1 else y[j] for j in f]
            x = m(x)
            y.append(x if i in self.save else None)
        return x

    def train(self, mode: bool = True) -> "DetectionModel":
        """Training or eval mode; eval folds the fused bottlenecks again from the
        current weights. A bf16 copy keeps the packs set_dtype made: it holds no
        f32 weights to fold, and it does not train."""
        super().train(mode)
        if not mode and self.dtype == torch.float32:
            self.fold()
        return self

    def fold(self) -> None:
        """Fold BN into the weights of every fused bottleneck, packed for the
        kernel of the model's dtype."""
        for m in self.modules():
            if isinstance(m, M.Bottleneck) and m.fusable:
                m.fold(self.dtype)

    def set_compute_dtype(self, dtype: torch.dtype) -> "DetectionModel":
        """This f32 model, set to train at activation dtype `dtype` (float32 or
        bfloat16): the counterpart, for training, of JAX's BaseModel.set_dtype
        (spectrogram_yolov11_tpu/nn/tasks.py:517), which retraces the graph in
        place while the parameters stay f32. Nothing is copied or cast here:
        in training the forward casts the input, and each conv its weights,
        to `dtype`. Unlike `set_dtype`'s copy, it holds no bf16 weights."""
        if self.dtype != torch.float32 or dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"set_compute_dtype sets an f32 model to float32 or bfloat16, not {self.dtype} to {dtype}")
        self.compute_dtype = dtype
        return self

    def set_dtype(self, dtype: torch.dtype) -> "DetectionModel":
        """The network at activation dtype `dtype` (float32 or bfloat16): this
        model when it already runs in it, else a copy, and this model stays as
        it is. Counterpart of spectrogram_yolov11_tpu/nn/tasks.py:517
        BaseModel.set_dtype, whose parameters stay f32 while the compute
        changes. The copy holds its conv weights and biases in `dtype`; BN keeps
        its f32 scale, shift and running statistics, so each Conv normalises its
        bf16 conv output in f32 and rounds once, as the JAX eval BN does; the
        fused bottlenecks are folded again from the f32 weights and packed for
        the kernel of `dtype`. Only an f32 model is converted: a bf16 one no
        longer holds the f32 weights."""
        if dtype == self.dtype:
            return self
        if self.dtype != torch.float32 or dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"set_dtype converts an f32 model to float32 or bfloat16, not {self.dtype} to {dtype}")
        model = copy.deepcopy(self)
        model.dtype = dtype
        model.fold()
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype)
        return model

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        result = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.fold()
        return result


def build_model(cfg: dict, nc: Optional[int] = None, variables: Optional[dict] = None) -> DetectionModel:
    """DetectionModel from a model dict; with `variables` (flax {params,
    batch_stats} numpy trees) the weights are carried across by the bridge and
    loaded with strict=True."""
    model = DetectionModel(cfg, nc=nc)
    if variables is not None:
        model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model
