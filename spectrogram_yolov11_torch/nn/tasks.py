"""Model YAML or dict -> network graph, and the detection model of the port.

Counterpart of spectrogram_yolov11_tpu/nn/tasks.py: the module registry and
its sets (:40-193), parse_model (:232), the YOLOGraph routing (:379),
yaml_model_load (:459), guess_model_task (:475), DetectionModel with init /
_bias_init (:557, :575), info (:589) and profile (:603), the graph's `embed`
output (:404-450), and build_model (:848), with SegmentationModel (:683) for the
segment task, PoseModel (:687) for the pose task and OBBModel (:698) for
the obb task: the stock YOLO11 modules, the Segment, Pose and OBB heads
(yolo11-seg.yaml, yolo11-pose.yaml, yolo11-obb.yaml),
the trained spectrogram detector's and the fork's whole zoo
(nn/modules/fork.py; the 136 detect configs that build under
cfg/models/11/fork/). Scaling matches the JAX parse_model: channels
make_divisible(min(c, max_channels) * width, 8), repeats max(round(n *
depth), 1), and the Segment head's prototype width npr as
make_divisible(min(npr, max_channels) * width, 8) (JAX :355); the string
`kpt_shape` among a layer's arguments is the dict's (JAX :243, :261). The
YOLOv8 and YOLOv10 families' modules (C2, GhostBottleneck, C3Ghost,
ResNetLayer, SCDown, PSA, RepVGGDW, C2fCIB, v10Detect) are registered as
JAX's; `legacy` starts true and turns false at the first scale-sensitive
module, every Detect-family head receives it, and v10Detect (the Detect
class) is set end2end and not legacy (JAX :240, :292, :358-361); a model
whose head is end2end reports it (`end2end`, JAX :513). The YOLOv9, v3,
v5 and v6 families' modules (RepConv, RepCSP, RepNCSPELAN4, ELAN1, AConv,
ADown, SPPELAN, CBLinear, CBFuse, SPP, nn.MaxPool2d, nn.ZeroPad2d,
nn.ConvTranspose2d, nn.Identity) are registered as JAX's (:79, :100-102):
CBLinear's width is the list of its pieces' and CBFuse's its last input's
(JAX :316-320), and the graph carries a list output to the CBFuse that
reads it. The dict's `activation:` key is what every act=True builds (JAX
:242-256; ROADMAP.md §3.56). A module of JAX's registry the port lacks
raises NotImplementedError naming its ROADMAP.md item
(NOT_PORTED_MODULES); any other unknown name raises KeyError.

A model is built from a dict (a checkpoint's `model_yaml`) or from a model
YAML: a path, or a name that find_model_yaml (JAX cfg/__init__.py:349)
resolves under any folder of the port's cfg/models/ (11/, 11/fork/, v3/,
v5/, v6/, v8/, v9/, v10/, v10/fork/; the first hit in sorted order:
yolo11.yaml, spectrogram_yolo11.yaml, fork/*.yaml, yolov8.yaml,
yolov9c.yaml, yolov10n.yaml; `yolov8n.yaml` is yolov8.yaml at n,
`yolov5n.yaml` yolov5.yaml at n; `yolo11n.yaml` and the bare `yolo11n`
are yolo11.yaml at scale n, `yolo11n-seg.yaml` is yolo11-seg.yaml at n, `yolo11n-pose.yaml`
yolo11-pose.yaml at n, `yolo11n-obb.yaml` yolo11-obb.yaml at n,
`yolo11n_HCA.yaml` is fork/yolo11_HCA.yaml at n, `yolo11n-cls.yaml`
yolo11-cls.yaml at n), read by utils.yaml_load.

The classify task: ClassificationModel (JAX :702) for a model whose head is
Classify (yolo11-cls.yaml, fork/yolo11-cls-resnet18.yaml with JAX's
TorchVision ResNet stand-in, nn/modules/block.py): logits (B, nc), stride
(1.0,) as JAX's _calibrate_stride; C3k's same-width bottlenecks take the
fused kernel in eval as in DetectionModel. Classify is a base module, its
width the unscaled nc (JAX :176); TorchVision's first argument is its
output width and the rest its own (JAX :322), with the input's width added.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import math
import re
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from ..utils import LOGGER, full_f32, make_divisible, not_ported, yaml_load
from ..utils.jax_compat import variables_to_state_dict
from . import modules as M
from .modules.conv import default_act, resolve_act_name

MODELS_DIR = Path(__file__).resolve().parents[1] / "cfg" / "models"

FORK_MODULES = (
    "SELayer", "SaELayer", "Mix_SPPF", "SAPF", "HCoordAtt", "MaxHCoordAtt", "CoordAtt", "AKCBAM", "LDConv",
    "Cross_AKConv", "ConvOMN", "DDWConv", "MaxConv", "MaxConvHCA", "FilterMaxConv", "PartialConvMax", "ConvHCA",
    "GhostConvMax", "GhostMaxConv", "GhostConvHCA", "RecycleConv", "Fusion", "SelectChannel", "BiFPN_WConcat",
    "BiFPN_WConcat2", "BiFPN_WConcat3", "XCBAM2C2f", "C3GC", "C3k2GC", "C3MSCk2", "BottleNect", "GCT",
    "GlobalContext", "ECAAttention", "MSCSpatialAttention", "SobelSpatialAttention", "WeightedSpatialAttention",
    "DenseCross", "DualChannelHConv", "Faster_Block", "MSBottleneck",
)
MODULE_REGISTRY: Dict[str, type] = {
    **{name: getattr(M, name) for name in (
        "Conv", "DWConv", "GhostConv", "CBAM", "ChannelAttention", "SpatialAttention", "Concat", "Bottleneck",
        "C2f", "C3", "C3k", "C3k2", "C2PSA", "SPPF", "C3x", "Detect", "Segment", "Pose", "OBB", "Classify",
        "TorchVision", "C2", "GhostBottleneck", "C3Ghost", "ResNetLayer", "SCDown", "PSA", "RepVGGDW", "C2fCIB",
        "RepConv", "RepCSP", "RepNCSPELAN4", "ELAN1", "AConv", "ADown", "SPPELAN", "CBLinear", "CBFuse", "SPP",
        *FORK_MODULES)},
    "nn.Upsample": M.Upsample,
    "nn.MaxPool2d": nn.MaxPool2d,  # JAX's MaxPool2d and ZeroPad2d take torch's arguments
    "nn.ZeroPad2d": nn.ZeroPad2d,
    "nn.ConvTranspose2d": M.TorchConvTranspose2d,
    "nn.Identity": nn.Identity,  # JAX's None: the layer passes its input on
    "v10Detect": M.Detect,  # JAX's: the Detect class, set end2end (and not legacy) by parse_model
}
BASE_MODULES = {
    M.Conv, M.GhostConv, M.Bottleneck, M.SPPF, M.C2PSA, M.DWConv, M.C2f, M.C3k2, M.C3, M.C3k, M.CBAM, M.C3x,
    M.Classify, M.C2, M.GhostBottleneck, M.C3Ghost, M.SCDown, M.PSA, M.C2fCIB, M.SPP, M.RepConv,
    M.RepNCSPELAN4, M.ELAN1, M.AConv, M.ADown, M.SPPELAN, M.TorchConvTranspose2d,
    # the fork's base modules (JAX nn/tasks.py:179-181)
    M.RecycleConv, M.GhostConvHCA, M.LDConv, M.Cross_AKConv, M.Mix_SPPF, M.SELayer, M.SaELayer,
    M.SAPF, M.DDWConv, M.ConvOMN, M.MaxConv, M.GhostMaxConv, M.ConvHCA, M.GhostConvMax,
    M.FilterMaxConv, M.MaxConvHCA, M.C3k2GC, M.C3MSCk2, M.XCBAM2C2f, M.CoordAtt, M.HCoordAtt,
    M.MaxHCoordAtt, M.AKCBAM, M.C3GC,
}
REPEAT_MODULES = {M.C2f, M.C3k2, M.C3, M.C3x, M.C2PSA, M.C3k, M.C3k2GC, M.C3MSCk2, M.XCBAM2C2f, M.C3GC, M.C2,
                  M.C3Ghost, M.C2fCIB}
SCALE_SENSITIVE = {M.C3k2, M.C3k2GC, M.C3MSCk2, M.XCBAM2C2f}  # args[3] flips on m/l/x scales
# modules of JAX's registry (nn/tasks.py:41-170) that the port lacks, each with what it is and the
# ROADMAP.md item that queues it: a YAML naming one raises NotImplementedError, not KeyError
_ITEM11 = "item 11 (other model families: {})"
NOT_PORTED_MODULES = {
    **{m: (f"the YOLOv5-era module {m} (used by no shipped YAML)", _ITEM11.format("the rest")) for m in (
        "Focus", "C1", "BottleneckCSP", "C3TR")},
    "DyHeadBlock": ("the DyHead block (yolo11_DYHEAD.yaml)", _ITEM11.format("dyhead")),
    "Index": ("the Index layer (yolo11_DYHEAD.yaml)", _ITEM11.format("dyhead")),
    **{m: (f"the YOLO-World module {m}", _ITEM11.format("World")) for m in (
        "C2fAttn", "ImagePoolingAttn", "WorldDetect")},
    **{m: (f"the RT-DETR module {m}", _ITEM11.format("RT-DETR")) for m in (
        "HGStem", "HGBlock", "RepC3", "AIFI", "TransformerEncoderLayer", "RTDETRDecoder")},
    **{m: (f"the YOLO-NAS module {m}", _ITEM11.format("NAS")) for m in (
        "QARepVGG", "NASStage", "NASCSP", "NASReduce", "NASDown", "NASUpsample")},
    **{m: (f"the module {m}", _ITEM11.format("the rest")) for m in (
        "AGLU", "Conv2", "ConvE", "ConvGN", "LightConv", "ConvTranspose", "DWConvTranspose2d", "C2fPSA",
        "PSABlock", "C3f", "TransformerBlock", "Proto")},
}


def find_model_yaml(name: str | Path) -> Path:
    """A model YAML by path or by name under the port's cfg/models/ (JAX
    cfg/__init__.py:349): the name as given, then without its scale letter
    (yolo11n -> yolo11, yolo11n-seg -> yolo11-seg, yolo11n-cls -> yolo11-cls)."""
    p = Path(name)
    if p.exists():
        return p
    stem = p.stem
    unified = re.sub(r"(\d+)([nslmx])([-_]|$)", r"\1\3", stem)
    for cand in (stem, unified):
        hits = sorted(MODELS_DIR.rglob(f"{cand}.yaml"))
        if hits:
            return hits[0]
    raise FileNotFoundError(f"Model yaml '{name}' not found under {MODELS_DIR}")


def yaml_model_load(path: str | Path) -> dict:
    """A model YAML as a dict, with its scale from the file name (yolo11n.yaml
    -> n), else the YAML's `scale`, else its first scale; `yaml_file` and
    `yaml_name` (the stem) added, as JAX's yaml_model_load."""
    path = Path(str(path))
    name = path.stem
    m = re.match(r"^(.*?)(\d+)([nslmx])([-_].*)?$", name) or re.match(r"^(yolo\w*?)([nslmx])([-_].*)?$", name)
    scale = None
    if m:
        groups = m.groups()
        scale = groups[2] if len(groups) == 4 else groups[1]
    d = yaml_load(find_model_yaml(path), append_filename=True)
    d["scale"] = d.get("scale") or scale or (tuple(d["scales"].keys())[0] if d.get("scales") else None)
    d["yaml_name"] = name
    return d


def guess_model_task(d: dict) -> str:
    """The task of a model dict, from its last head module (JAX :475)."""
    head = d["head"][-1][2]
    return {"Detect": "detect", "Segment": "segment", "Pose": "pose", "OBB": "obb", "Classify": "classify",
            "RTDETRDecoder": "rtdetr", "v10Detect": "detect", "WorldDetect": "world"}.get(head.split(".")[-1], "detect")


def intersect_state_dicts(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> Tuple[dict, int]:
    """`dst` with every entry of `src` whose name and shape match it: the port's
    copy of JAX's _intersect_variables (engine/model.py:22), the transfer of
    `YOLO(yaml).load(ckpt)` and of the trainer's nc rebuild. Returns the merged
    state dict and the count of transferred leaves, counted as JAX counts
    them: torch's BN bookkeeping (`num_batches_tracked`) has no flax leaf and
    is left out of the count."""
    out, n = dict(dst), 0
    for k, v in dst.items():
        if k in src and tuple(src[k].shape) == tuple(v.shape):
            out[k] = src[k]
            n += not k.endswith(".num_batches_tracked")
    return out, n


def model_act(d: dict) -> str:
    """The activation a model dict's `activation:` key names (yolov6's
    `nn.ReLU()`), as a key of ACTS; SiLU when the key is absent, and, with a
    warning, when it names an activation JAX does not know (JAX :242-256)."""
    act = d.get("activation")
    name = resolve_act_name(act)
    if act and name is None:
        LOGGER.warning(f"unknown activation '{act}' in model yaml; keeping default")
    return name or "silu"


def parse_model(d: dict, ch: int, act: str = "silu") -> Tuple[List[nn.Module], List[Any], List[int], List[dict]]:
    """Returns (layers, their `from` routes, sorted save list, specs): each
    spec the layer's {type, n, args, kwargs, c2} as JAX's LayerSpec holds
    them (n the repeats after scaling, args the scaled arguments, c2 its
    output width). `act` (a key of ACTS, model_act's) is the activation of
    every `act=True` built here."""
    max_channels = float("inf")
    nc, scales = d.get("nc"), d.get("scales")
    depth, width = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0)
    scale = d.get("scale")
    if scales:
        scale = scale or tuple(scales.keys())[0]
        depth, width, max_channels = scales[scale]

    with default_act(act):  # what Conv(act=True) builds
        return _parse_layers(d, ch, nc, scale, depth, width, max_channels)


def _parse_layers(d: dict, ch: int, nc, scale, depth: float, width: float, max_channels: float):
    legacy = True
    eval_ctx = {"nc": nc, "kpt_shape": d.get("kpt_shape", 1.0)}  # JAX's default for an absent kpt_shape
    ch_list = [ch]
    layers: List[nn.Module] = []
    routes: List[Any] = []
    save: List[int] = []
    specs: List[dict] = []
    for i, (f, n, m, args) in enumerate(d["backbone"] + d["head"]):
        if m in NOT_PORTED_MODULES:
            raise not_ported(*NOT_PORTED_MODULES[m])
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
        elif cls in {M.Concat, M.BiFPN_WConcat2, M.BiFPN_WConcat3}:
            c2 = sum(ch_list[x] for x in f)
            if cls is not M.Concat:  # JAX's param `w` takes its length from the inputs at the first call
                kwargs["n"] = len(f)
        elif cls is M.BiFPN_WConcat:
            c2 = sum(ch_list[x] for x in f)
            args = [tuple(ch_list[x] for x in f), *args]
        elif cls is M.Fusion:
            # the reference hardcodes mode 'ESChannel'; the output has the first input's width
            inc = tuple(ch_list[x] for x in f)
            c2, args, kwargs["c1"] = ch_list[f[0]], [inc, "ESChannel"], ch_list[f[0]]
        elif cls is M.SelectChannel:
            c2, args = ch_list[f[0]], [ch_list[f[0]]]
        elif cls is M.CBLinear:  # its width is the list of its pieces' (JAX :316-317)
            c2, args = list(args[0]), [ch_list[f], list(args[0]), *args[1:]]
        elif cls is M.CBFuse:  # the last input's width (JAX :318-320)
            c2, args = ch_list[f[-1]], [list(args[0])] if args else [[]]
        elif cls is M.TorchVision:  # args[0] is the output width (JAX :322)
            c2, args, kwargs["c1"] = args[0], args[1:], ch_list[f]
        elif cls is M.ResNetLayer:  # the YAML holds (c1, c2, s, is_first, n); the stem keeps c2 (JAX :341-344)
            c2 = args[1] if args[3] else args[1] * 4
        elif cls in (M.Detect, M.Segment, M.Pose, M.OBB):
            args.append(tuple(ch_list[x] for x in f))
            if cls is M.Segment:  # the prototype width npr scales as a width (JAX :355)
                args[2] = make_divisible(min(args[2], max_channels) * width, 8)
            kwargs["legacy"] = legacy
            if m == "v10Detect":  # the light class branch and the dual assignments (JAX :358-361)
                kwargs["legacy"], kwargs["end2end"] = False, True
            c2 = None
        else:  # Upsample, the pools, pads, nn.Identity and the fork's other modules keep the width of their input
            c2 = ch_list[f]

        layer = nn.Sequential(*(cls(*args, **kwargs) for _ in range(n))) if n > 1 else cls(*args, **kwargs)
        layers.append(layer)
        routes.append(f)
        specs.append({"type": m, "n": n, "args": args, "kwargs": kwargs, "c2": c2})
        save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
        if i == 0:
            ch_list = []
        ch_list.append(c2)
    return layers, routes, sorted(set(save)), specs


def _meta_like(x, nb: int):
    """x (a tensor, or lists and tuples of them: CBFuse's input) as empty
    tensors on the meta device at batch nb."""
    if isinstance(x, (list, tuple)):
        return type(x)(_meta_like(t, nb) for t in x)
    return torch.empty(nb, *x.shape[1:], device="meta")


def fold_modules(root: nn.Module, dtype: torch.dtype = torch.float32) -> None:
    """Fold BN into the weights of every fused bottleneck under `root`, packed
    for the kernel of `dtype`, and the branches of every other RepConv into
    its one conv in `dtype` (a fused RepBottleneck's RepConv is in its pack)."""
    fused = [m for m in root.modules() if isinstance(m, M.Bottleneck) and m.fusable]
    for m in fused:
        m.fold(dtype)
    inside = {id(m.cv1) for m in fused}
    for m in root.modules():
        if isinstance(m, M.RepConv) and id(m) not in inside:
            m.fold(dtype)


@torch.no_grad()
def init_weights(module: nn.Module, g: torch.Generator) -> None:
    """Draw every weight of `module` in place from `g` as JAX's init draws it
    (DetectionModel.init): a conv or dense layer by its `init_kind` (torch:
    U(+-1/sqrt(fan_in)) kernel and bias; lecun: flax's lecun_normal, a normal
    truncated at +-2 of its unit normal and scaled, with a zero bias; zeros),
    BN and LayerNorm to scale 1, bias 0 (BN mean 0, variance 1), and the
    fork's bare parameters by their module's init_params."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in = max(m.weight[0].numel(), 1)  # a transposed conv's (in, out, kh, kw): out * kh * kw, as flax's
            kind = getattr(m, "init_kind", "torch")
            if kind == "torch":
                bound = 1.0 / math.sqrt(fan_in)
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=g))
                continue
            if kind == "lecun":
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                m.weight.copy_(torch.nn.init.trunc_normal_(torch.empty(m.weight.shape), 0.0, std, -2 * std, 2 * std,
                                                           generator=g))
            else:
                m.weight.zero_()
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
        elif hasattr(m, "init_params"):
            m.init_params(g)


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
    model's dtype (in training mode, in its compute dtype); with embed=(i,
    ...), the concatenation of those layers' outputs, each mean-pooled over H
    and W, (B, C) (JAX's graph __call__ :404-450). A model whose head is
    Segment returns (those pairs, mask coefficients (B, A, nm), prototypes
    (B, nm, H / 4, W / 4)) and is a SegmentationModel; one whose head is
    Pose returns (those pairs, raw keypoints (B, A, nk * nd)) and is a
    PoseModel; one whose head is OBB returns (those pairs, raw angles (B, A,
    1)) and is an OBBModel."""

    task = "detect"

    def __init__(self, cfg: dict, ch: int = 3, nc: Optional[int] = None):
        super().__init__()
        self.yaml = copy.deepcopy(cfg)
        if nc and nc != self.yaml.get("nc"):
            self.yaml["nc"] = nc
        self.nc = self.yaml["nc"]
        self.ch = ch
        self.names = {i: f"{i}" for i in range(self.nc)}  # the data's or a checkpoint's names replace these
        self.dtype = torch.float32  # the activations' dtype; parameters too, except BN's, which stay f32
        self.compute_dtype = torch.float32  # the activations' dtype in training; parameters stay f32
        self.default_act = model_act(self.yaml)  # what act=True built (JAX :497)
        layers, self.routes, self.save, self.specs = parse_model(self.yaml, ch, self.default_act)
        self.end2end = bool(self.specs[-1]["kwargs"].get("end2end", False))  # a v10Detect head (JAX :513)
        self.model = nn.ModuleList(layers)
        self.eval()
        self.stride = self._calibrate_stride()

    def _calibrate_stride(self) -> Tuple[float, ...]:
        """Each level's stride from a dummy forward at 256 px, as the JAX BaseModel's (:529)."""
        s = 256
        with torch.no_grad():
            out = self.forward(torch.zeros(1, self.ch, s, s))
        feats = out[0] if isinstance(out, tuple) else out  # a Segment, Pose or OBB head's pairs come first
        feats = feats["one2many"] if isinstance(feats, dict) else feats  # an end2end head's
        return tuple(s / box.shape[-2] for box, _ in feats)

    @full_f32()
    def forward(self, x: torch.Tensor, embed: Optional[Sequence[int]] = None):
        # a bf16 network rounds its input to bf16, as the JAX model's first conv does
        x = x.to(self.compute_dtype if self.training else self.dtype)
        y: List[Optional[torch.Tensor]] = []
        embeddings = []
        for i, (m, f) in enumerate(zip(self.model, self.routes)):
            if f != -1:
                x = y[f] if isinstance(f, int) else [x if j == -1 else y[j] for j in f]
            x = m(x)
            y.append(x if i in self.save else None)
            if embed and i in embed:  # a list output (CBLinear's) gives each piece's
                embeddings.extend(t.mean((2, 3)) if t.ndim == 4 else t for t in (x if isinstance(x, tuple) else (x,)))
        if embed:
            return torch.cat(embeddings, -1)
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
        """fold_modules(self, self.dtype)."""
        fold_modules(self, self.dtype)

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
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):  # flax's conv, dense and transposed conv
                # with dtype=bfloat16; bare params stay f32
                m.to(dtype)
        return model

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        result = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.fold()
        return result

    @torch.no_grad()
    def init(self, seed: int = 0) -> "DetectionModel":
        """Fresh weights in place, drawn from a torch.Generator seeded with
        `seed` (JAX's init and _bias_init, nn/tasks.py:557, :575), and folded:
        every conv weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with
        fan_in = cin/groups * kh * kw (JAX's torch_kernel_init and
        torch_bias_init, nn/modules/conv.py:90, :101), drawn in module order;
        where JAX leaves flax's default (a conv's or dense layer's
        `init_kind`), lecun_normal and a zero bias, or zeros; BN and
        LayerNorm scale 1, bias 0 (BN mean 0, variance 1); the fork's bare
        parameters by their module's init_params; then Detect's bias init
        (head.py). flax's threefry streams are not reproduced: the random
        leaves follow JAX's distributions, the deterministic ones equal
        JAX's. Returns the model."""
        if self.dtype != torch.float32:
            raise ValueError(f"init draws the weights of an f32 model, not of its {self.dtype} copy")
        init_weights(self, torch.Generator().manual_seed(int(seed)))
        for m in self.modules():  # after the draws: modules() visits the head before its convs
            if isinstance(m, M.Detect):
                m.bias_init(self.stride)
        self.fold()
        return self

    def get_flops(self, imgsz: int = 640) -> float:
        """GFLOPs of one forward of a (1, 3, imgsz, imgsz) image, counted from
        the layer shapes as 2 x the multiply-adds of every convolution and
        matrix product (torch.utils.flop_counter), on a copy on the meta
        device (no arithmetic runs) in training mode, where the fused
        bottlenecks run their two convs. JAX's get_flops asks XLA's cost
        analysis, which also counts the elementwise work (BN, SiLU, adds,
        pools, softmax)."""
        meta = copy.deepcopy(self).to("meta").train()
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            meta(torch.zeros(1, self.ch, int(imgsz), int(imgsz), device="meta"))
        return counter.get_total_flops() / 1e9

    @torch.no_grad()
    def profile(self, imgsz: int = 256, batch: int = 1, timed: bool = True) -> List[dict]:
        """Per-layer rows {i, type, params, gflops, ms} of a forward of
        (batch, 3, imgsz, imgsz) zeros, and the table logged (JAX :603-673):
        the graph replayed layer by layer in eval mode on the model's device
        (so C3k's bottlenecks run the fused kernel there); params counted as
        info counts them; GFLOPs of each layer by get_flops' count (a copy on
        the meta device in training mode); ms the mean of 3 runs after one
        warm-up, by CUDA events on the card and the host clock on the CPU."""
        dev = next(self.parameters()).device
        if self.training:
            self.eval()
        fmt = torch.channels_last if dev.type == "cuda" else torch.contiguous_format
        x = torch.zeros(batch, self.ch, int(imgsz), int(imgsz), device=dev, dtype=self.dtype).contiguous(
            memory_format=fmt)
        y: List[Any] = []
        rows: List[dict] = []
        kinds = [m for _, _, m, _ in self.yaml["backbone"] + self.yaml["head"]]  # as the model dict spells them
        for i, (m, f, kind) in enumerate(zip(self.model, self.routes, kinds)):
            xin = x if f == -1 else (y[f] if isinstance(f, int) else [x if j == -1 else y[j] for j in f])
            # counted at a batch of 2 or more (training-mode BN needs 2 values at 1 x 1), scaled to `batch`
            nb = max(batch, 2)
            meta = copy.deepcopy(m).to("meta").float().train()
            with FlopCounterMode(display=False) as counter:
                meta(_meta_like(xin, nb))
            t_ms = 0.0
            with full_f32():
                if timed:
                    m(xin)
                    if dev.type == "cuda":
                        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                        start.record()
                        for _ in range(3):
                            m(xin)
                        end.record()
                        end.synchronize()
                        t_ms = start.elapsed_time(end) / 3
                    else:
                        t0 = time.perf_counter()
                        for _ in range(3):
                            m(xin)
                        t_ms = (time.perf_counter() - t0) / 3 * 1e3
                x = m(xin)
            y.append(x if i in self.save else None)
            rows.append({"i": i, "type": kind, "params": sum(p.numel() for p in m.parameters()),
                         "gflops": counter.get_total_flops() / 1e9 * batch / nb, "ms": t_ms})
        LOGGER.info(f"{'idx':>4} {'module':<28}{'params':>10} {'GFLOPs':>9} {'ms':>8}")
        for r in rows:
            LOGGER.info(f"{r['i']:>4} {r['type']:<28}{r['params']:>10,} {r['gflops']:>9.3f} {r['ms']:>8.3f}")
        LOGGER.info(f"{'':>4} {'TOTAL':<28}{sum(r['params'] for r in rows):>10,} "
                    f"{sum(r['gflops'] for r in rows):>9.3f} {sum(r['ms'] for r in rows):>8.3f}")
        return rows

    def bottlenecks(self) -> Dict[str, List[Tuple[int, int]]]:
        """The same-width 3x3 bottlenecks, as (layer, C) pairs: "fused", those the
        kernel runs in eval (one launch each per forward), and "gated", those
        whose width it does not take (they run their two convs)."""
        out: Dict[str, List[Tuple[int, int]]] = {"fused": [], "gated": []}
        for i, layer in enumerate(self.model):
            for m in layer.modules():
                if isinstance(m, M.Bottleneck) and (m.fusable or m.gated):
                    out["fused" if m.fusable else "gated"].append((i, m.cv2.conv.out_channels))
        return out

    def info(self, imgsz: int = 640, flops: bool = True) -> str:
        """The summary line JAX's info (:589) logs and returns: layers (rows of
        the YAML), parameters (BN's scale and bias among them, no statistics)
        and GFLOPs at imgsz (get_flops); then, where the model has gated
        bottlenecks (a width the kernel does not take, ops/fused_conv.py:
        CHANNELS), the count of fused ones and the gated ones by layer and
        width. A model without gated bottlenecks prints JAX's line."""
        n_params = sum(p.numel() for p in self.parameters())
        msg = f"{self.yaml.get('yaml_name', 'model')} summary: {len(self.model)} layers, {n_params:,} parameters"
        if flops:
            msg += f", {self.get_flops(imgsz):.1f} GFLOPs @ {imgsz}px"
        b = self.bottlenecks()
        if b["gated"]:
            msg += (f"; {len(b['fused'])} fused bottlenecks, {len(b['gated'])} gated (layer, C): "
                    + ", ".join(f"({i}, {c})" for i, c in b["gated"]))
        LOGGER.info(msg)
        return msg


class SegmentationModel(DetectionModel):
    """The segment task's model (JAX nn/tasks.py:683): a DetectionModel whose
    head is Segment."""

    task = "segment"


class PoseModel(DetectionModel):
    """The pose task's model (JAX nn/tasks.py:687): a DetectionModel whose
    head is Pose, `kpt_shape` the dict's (JAX's default (17, 3)). The trainer
    puts the data's kpt_shape into the dict it builds from (JAX
    engine/trainer.py:204-210); JAX's `data_kpt_shape` argument, which no
    JAX caller passes, is left out."""

    task = "pose"

    def __init__(self, cfg: dict, ch: int = 3, nc: Optional[int] = None):
        super().__init__(cfg, ch=ch, nc=nc)
        self.kpt_shape = tuple(self.yaml.get("kpt_shape", (17, 3)))


class OBBModel(DetectionModel):
    """The obb task's model (JAX nn/tasks.py:698): a DetectionModel whose head
    is OBB."""

    task = "obb"


class ClassificationModel(DetectionModel):
    """The classify task's model (JAX nn/tasks.py:702): a DetectionModel whose
    head is Classify, forward(x) -> logits (B, nc), stride (1.0,) as JAX's
    _calibrate_stride. The softmax is the predictor's and the cross-entropy
    the trainer's."""

    task = "classify"

    def _calibrate_stride(self) -> Tuple[float, ...]:
        return (1.0,)


TASK2MODEL = {"detect": DetectionModel, "segment": SegmentationModel, "pose": PoseModel,
              "obb": OBBModel, "classify": ClassificationModel}  # JAX's task map (:839)


def build_model(cfg: Union[str, Path, dict], nc: Optional[int] = None,
                variables: Optional[dict] = None) -> DetectionModel:
    """The task's model (DetectionModel, SegmentationModel, PoseModel, OBBModel or
    ClassificationModel, by guess_model_task) from a model dict or a model YAML (yaml_model_load); with
    `variables` (flax {params, batch_stats} numpy trees) the weights are
    carried across by the bridge and loaded with strict=True, else the model
    holds torch's default init until `init(seed)` draws JAX's."""
    d = cfg if isinstance(cfg, dict) else yaml_model_load(cfg)
    for _, _, m, _ in d.get("backbone", []) + d.get("head", []):
        if m in NOT_PORTED_MODULES:
            raise not_ported(*NOT_PORTED_MODULES[m])
    task = guess_model_task(d) if d.get("head") else "detect"  # a headless dict fails in parse_model
    if task not in TASK2MODEL:
        raise not_ported(f"a {task} model ({d.get('yaml_name') or d['head'][-1][2]})", "item 11 (other model families)")
    model = TASK2MODEL[task](d, nc=nc)
    if variables is not None:
        model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model
