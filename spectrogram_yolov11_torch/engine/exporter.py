"""The serving graph and the Exporter. Counterpart of
spectrogram_yolov11_tpu/engine/exporter.py: export_formats (:33),
build_inference_fn (:51), the graph the KServe-v2 server (serve.py) and the
AutoBackend (nn/autobackend.py) run, for the detect, segment, pose, obb and
classify tasks, and Exporter (:135), which writes it as an artifact.

The graph's input contract is the exporter's: uint8 NHWC **RGB** frames, with no flip
on the device (the predictor's device function, engine/pipeline.py, flips BGR
frames; a client of this graph flips on its side, serve.py:_remote_forward).
Its outputs are JAX's table (:58-66), in JAX's layouts:

    task      nms=False                              nms=True
    classify  probs (B, nc)                          the same
    detect    preds (B, A, 4 + nc)                   det (B, max_det, 6), n_valid (B,)
    segment   preds + coefficients (B, A, 4+nc+nm),  det (B, max_det, 6), n_valid,
              prototypes (B, H/4, W/4, nm) NHWC      masks (B, max_det, H/4, W/4)
    pose      preds + keypoints (B, A, 4+nc+nk*nd)   det + keypoints (B, max_det, 6+nk*nd), n_valid
    obb       rboxes (B, A, 5 + nc)                  det (B, max_det, 7), n_valid
    v10/e2e   det (B, max_det, 6), n_valid           the same (the NMS-free head)

The segment masks are sigmoid(coefficients @ prototypes) cropped to their
boxes (ops/masks.py:crop_masks_device), the pose keypoints decode_kpts'
(input pixels), the NMS of detect, segment and pose the greedy keep kernel's
(ops/nms.py), OBB's Fast-NMS over probiou (nms_rotated, no keep kernel).
An end2end (v10) model gives its NMS-free rows with either setting, n_valid
the rows above conf (JAX :78-83: engine/pipeline.py:e2e_detections, no keep
kernel). The world branch is another model family (ROADMAP.md §1 item 11).

The artifact formats (export_formats, JAX's five rows and gates):

| format      | writes                                            | read by                       |
| ----------- | ------------------------------------------------- | ----------------------------- |
| ckpt        | <stem>.ckpt, JAX's checkpoint layout, epoch -1    | both packages' YOLO and AutoBackend |
| stablehlo   | <stem>.pt2, a torch.export program of the graph,  | the port's AutoBackend; the   |
|             | with <stem>.ckpt and the weights pack beside it   | pack for a native runner      |
| saved_model | needs tensorflow (jax2tf in JAX)                  | -                             |
| tflite      | needs tensorflow                                  | -                             |
| onnx        | needs tensorflow and tf2onnx                      | -                             |

The port writes no StableHLO: its `stablehlo` row is the torch counterpart,
a `torch.export` program (ROADMAP.md §3.50). Both kernels are registered
operators (`syt::fused_bottleneck_f32`, `syt::fused_bottleneck_bf16`,
`syt::greedy_keep`; ops/fused_conv.py, ops/nms_kernel.py), so the program
holds them as calls that run the plain version on the CPU and the kernel on
the card, after those modules are imported. Batch, height and width are
dynamic (height and width multiples of the model's largest stride, from two
strides up), so one program takes what the predictor, the validator and the
server's batch buckets hand it. The TensorFlow rows have no torch
counterpart yet (ROADMAP.md §1 item 9): without tensorflow they raise
ModuleNotFoundError, as JAX's do; with it, NotImplementedError naming that
item.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..cfg import DEFAULT_CFG_DICT, get_cfg, get_save_dir
from ..nn.tasks import DetectionModel
from ..ops.decode import decode_detections, decode_kpts, decode_obb
from ..ops.masks import crop_masks_device
from ..ops.nms import nms_rotated, non_max_suppression, non_max_suppression_extras
from ..utils import LOGGER, full_f32, not_ported, resolve_device
from .pipeline import e2e_detections, eval_network, forward_decode, nchw

PROGRAM_META = "export.json"  # the extra file of a .pt2 that holds its export arguments
MAX_BATCH, MAX_SIZE = 4096, 8192  # the dynamic dimensions' upper bounds (frames, pixels)


def export_formats() -> dict:
    """The formats and whether each can be written here (JAX :33): ckpt and
    stablehlo always; the TensorFlow rows when tensorflow (and tf2onnx) are
    installed."""
    tf_ok = importlib.util.find_spec("tensorflow") is not None
    return {
        "ckpt": {"suffix": ".ckpt", "available": True},
        "stablehlo": {"suffix": ".pt2", "available": True},
        "saved_model": {"suffix": "_saved_model", "available": tf_ok},
        "tflite": {"suffix": ".tflite", "available": tf_ok},
        "onnx": {"suffix": ".onnx", "available": tf_ok and importlib.util.find_spec("tf2onnx") is not None,
                 "experimental": True},
    }


class ServingGraph(torch.nn.Module):
    """The serving graph of `model` as a module: forward(uint8 (B, H, W, 3)
    RGB frames on the model's device) -> the task's outputs of the module
    docstring's table, f32 (bf16 probs upcast), by the port's NMS at conf,
    iou and max_det with nms=True. The network runs in the model's dtype
    (f32, or bf16 for a copy from set_dtype). It reads no tensor's value on
    the host, so torch.export traces it (export_program)."""

    def __init__(self, model: DetectionModel, nms: bool = False, conf: float = 0.25, iou: float = 0.7,
                 max_det: int = 300):
        super().__init__()
        self.model = model
        self.nms, self.conf, self.iou, self.max_det = bool(nms), float(conf), float(iou), int(max_det)

    def forward(self, imgs: torch.Tensor):
        model, task, nms = self.model, self.model.task, self.nms
        if model.end2end:
            det = e2e_detections(model, imgs, self.max_det)
            return det, (det[..., 4] > self.conf).sum(-1).int()
        nms_kw = dict(conf_thres=self.conf, iou_thres=self.iou, nc=model.nc, max_det=self.max_det)
        if task == "detect":
            preds = forward_decode(model, imgs)
            return non_max_suppression(preds, **nms_kw) if nms else preds
        out = model(nchw(imgs.float() / 255.0))
        if task == "classify":
            return torch.softmax(out, -1).float()
        if task == "segment":
            feats, mc, proto = out
            preds = torch.cat([decode_detections(feats, model.nc, model.stride), mc.float()], -1)
            if not nms:
                return preds, proto.float().permute(0, 2, 3, 1)
            det, nv = non_max_suppression_extras(preds, **nms_kw)
            masks = torch.sigmoid(torch.einsum("bdk,bkhw->bdhw", det[..., 6:], proto.float()))
            return det[..., :6], nv, crop_masks_device(masks, det[..., :4], imgs.shape[1:3])
        if task == "pose":
            feats, kpt_raw = out
            kpts = decode_kpts(kpt_raw, model.kpt_shape, [tuple(b.shape[-2:]) for b, _ in feats], model.stride)
            preds = torch.cat([decode_detections(feats, model.nc, model.stride), kpts.flatten(2)], -1)
            return non_max_suppression_extras(preds, **nms_kw) if nms else preds
        if task == "obb":
            preds = decode_obb(*out, model.nc, model.stride)
            return nms_rotated(preds, **nms_kw) if nms else preds
        raise ValueError(f"no serving graph for the {task} task")


def build_inference_fn(model: DetectionModel, *, nms: bool = False, conf: float = 0.25, iou: float = 0.7,
                       max_det: int = 300) -> Callable:
    """fn(uint8 (B, H, W, 3) RGB frames on the model's device) -> the
    ServingGraph's outputs, under inference mode and the port's f32 policy
    (utils.full_f32)."""
    graph = ServingGraph(model, nms=nms, conf=conf, iou=iou, max_det=max_det)

    @torch.inference_mode()
    @full_f32()
    def fn(imgs: torch.Tensor):
        return graph(imgs)

    return fn


def program_stride(model: DetectionModel) -> int:
    """The multiple a program's height and width keep: the model's largest
    stride; 32 for a classifier (its stride is 1, and its YAMLs downsample 32
    times)."""
    return 32 if model.task == "classify" else int(max(model.stride))


def export_program(model: DetectionModel, *, nms: bool = False, conf: float = 0.25, iou: float = 0.7,
                   max_det: int = 300, batch: int = 1, imgsz: int = 640) -> torch.export.ExportedProgram:
    """torch.export of the ServingGraph of `model` (in eval mode, on its
    device and in its dtype) on an example batch of zero frames at imgsz,
    batch, height and width dynamic: any batch up to MAX_BATCH, any height
    and width that are multiples of the model's largest stride from two
    strides up to MAX_SIZE. The example's batch is at least 2: torch.export
    fixes a dimension whose example size is 1. The program's parameters,
    buffers and the fused bottlenecks' weight packs (non-persistent buffers,
    lifted as constants) are its lifted inputs."""
    stride = program_stride(model)
    if imgsz % stride or imgsz < 2 * stride:
        raise ValueError(f"export imgsz={imgsz} must be a multiple of the model's largest stride {stride}, "
                         f"at least {2 * stride}")
    dev = next(model.parameters()).device
    x = torch.zeros((max(int(batch), 2), imgsz, imgsz, 3), dtype=torch.uint8, device=dev)
    h, w = (torch.export.Dim(n, min=2, max=MAX_SIZE // stride) for n in ("h", "w"))
    dims = {"imgs": {0: torch.export.Dim("batch", min=1, max=MAX_BATCH), 1: stride * h, 2: stride * w}}
    with torch.no_grad(), full_f32():
        return torch.export.export(ServingGraph(model, nms, conf, iou, max_det), (x,), dynamic_shapes=dims)


def program_leaves(ep: torch.export.ExportedProgram) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every lifted input of the program, in the order of
    its graph's placeholders (ep.graph_signature.input_specs), the frames
    excepted: parameters and persistent buffers from its state dict, the
    weight packs and the other constants from its constants."""
    out = []
    for spec in ep.graph_signature.input_specs:
        if spec.kind == torch.export.graph_signature.InputKind.USER_INPUT:
            continue
        src = ep.state_dict if spec.target in ep.state_dict else ep.constants
        out.append((spec.target, src[spec.target]))
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as numpy; bf16 (which numpy lacks) as its raw uint16 bits."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


class Exporter:
    """Exporter(model, overrides)(): the artifact of `format` (JAX :135-175),
    written under get_save_dir(args, name="export") as <stem>.* with the stem
    of args.model ("model": `task` and `model` are dropped from the
    overrides, as JAX's). Every format but ckpt exports the deploy form: the
    model in eval mode, its fused bottlenecks folded (BN folded into the
    kernels' weight packs), on args.device (the card unless "cpu"), in bf16
    with half=True."""

    def __init__(self, model: DetectionModel, overrides: Optional[dict] = None):
        self.model = model
        self.args = get_cfg(DEFAULT_CFG_DICT, {k: v for k, v in (overrides or {}).items() if k not in {"task", "model"}})
        self.imgsz = int(self.args.imgsz if isinstance(self.args.imgsz, int) else self.args.imgsz[0])

    def __call__(self) -> str:
        fmt = str(self.args.format or "stablehlo").lower()
        formats = export_formats()
        if fmt not in formats:
            raise ValueError(f"unknown export format '{fmt}'; choose from {list(formats)}")
        if not formats[fmt]["available"]:
            raise ModuleNotFoundError(
                f"format '{fmt}' needs optional deps not present in this environment "
                f"(availability matrix: { {k: v['available'] for k, v in formats.items()} })")
        save_dir = get_save_dir(self.args, name="export")
        save_dir.mkdir(parents=True, exist_ok=True)
        stem = Path(str(self.args.model or "model")).stem or "model"
        out = getattr(self, f"_export_{fmt}")(save_dir / stem)
        if fmt in {"saved_model", "tflite", "onnx"}:
            self._write_metadata(Path(out))
        LOGGER.info(f"Export complete: {out}")
        return str(out)

    def _write_metadata(self, artifact: Path) -> None:
        """The sidecar YAML of the TensorFlow rows (JAX :176): task, nc,
        names, stride, imgsz, nms and a pose model's kpt_shape, as
        metadata.yaml inside a directory or <stem>.metadata.yaml beside a
        file; nn/autobackend.py:_load_metadata reads it."""
        m = self.model
        md = {"task": m.task, "nc": int(m.nc), "names": {int(k): str(v) for k, v in m.names.items()},
              "stride": [float(s) for s in m.stride], "imgsz": self.imgsz, "nms": bool(self.args.nms)}
        if m.task == "pose":
            md["kpt_shape"] = [int(x) for x in m.kpt_shape]
        dest = artifact / "metadata.yaml" if artifact.is_dir() else artifact.with_suffix(".metadata.yaml")
        lines = []
        for k, v in md.items():
            if isinstance(v, dict):
                lines += [f"{k}:"] + [f"  {i}: {json.dumps(s)}" for i, s in v.items()]
            else:
                lines.append(f"{k}: {json.dumps(v)}")  # JSON's scalars and flat lists are YAML's
        dest.write_text("\n".join(lines) + "\n", encoding="utf-8")

    def _export_ckpt(self, base: Path) -> Path:
        """The model's train-form weights as a checkpoint in JAX's layout,
        epoch -1 (JAX :196): both packages' YOLO and AutoBackend read it."""
        from .. import __version__
        from ..utils.jax_compat import state_dict_to_variables
        from .checkpoint import save_checkpoint

        m, p = self.model, base.with_suffix(".ckpt")
        save_checkpoint(p, variables=state_dict_to_variables(m.state_dict()), ema_variables=None, opt_state=None,
                        epoch=-1, best_fitness=0.0, updates=0,
                        model_yaml={k: v for k, v in m.yaml.items() if k != "yaml_file"}, names=m.names, nc=m.nc,
                        version=__version__)
        return p

    def _export_stablehlo(self, base: Path) -> Path:
        """The graph artifact (JAX :208-251), as the port writes it: <stem>.pt2,
        a torch.export program of the ServingGraph at args' nms, conf, iou
        and max_det (export_program; the example batch JAX's: 1 when batch is
        None, -1 or 16, else batch), saved with its export arguments
        (PROGRAM_META); beside it the .ckpt (the task, names, stride, nc and
        kpt_shape AutoBackend reads) and the weights pack: <stem>.weights.bin,
        the program's lifted inputs in the order of its placeholders
        (program_leaves, bf16 as raw 16-bit words), and <stem>.weights.json,
        their manifest with the image input last, nms, task and names.
        Returns the .pt2 path."""
        a = self.args
        batch = 1 if a.batch in (None, -1, 16) else int(a.batch)
        graph = {"nms": bool(a.nms), "conf": float(a.conf or 0.25), "iou": float(a.iou), "max_det": int(a.max_det)}
        self._export_ckpt(base)
        net = eval_network(self.model, bool(a.half), resolve_device(a.device or "cuda"))
        ep = export_program(net, **graph, batch=batch, imgsz=self.imgsz)
        stride = program_stride(net)
        meta = {**graph, "half": net.dtype == torch.bfloat16, "imgsz": self.imgsz, "batch": batch, "task": net.task,
                "device": str(next(net.parameters()).device)}
        p = base.with_suffix(".pt2")
        torch.export.save(ep, str(p), extra_files={PROGRAM_META: json.dumps(meta)})
        manifest, blobs, off = [], [], 0
        for name, leaf in program_leaves(ep):
            arr = np.ascontiguousarray(_numpy(leaf))
            manifest.append({"name": name, "dtype": str(leaf.dtype).removeprefix("torch."), "shape": list(leaf.shape),
                             "offset": off, "nbytes": int(arr.nbytes)})
            blobs.append(arr.tobytes())
            off += arr.nbytes
        base.with_suffix(".weights.bin").write_bytes(b"".join(blobs))
        base.with_suffix(".weights.json").write_text(json.dumps({
            "args": manifest,
            "image_input": {"dtype": "uint8", "shape": [batch, self.imgsz, self.imgsz, 3],
                            "dynamic": {"batch": [1, MAX_BATCH], "height": [2 * stride, MAX_SIZE],
                                        "width": [2 * stride, MAX_SIZE], "multiple_of": stride}},
            "nms": bool(a.nms),
            "task": net.task,
            "names": {int(k): v for k, v in net.names.items()},
        }))
        return p

    def _export_tensorflow_row(self, base: Path) -> Path:
        """saved_model, tflite and onnx: export_formats gates them as JAX's;
        where tensorflow is installed they raise, since the port has no
        counterpart of jax2tf or tf2onnx yet."""
        raise not_ported(f"the {self.args.format} format (JAX's jax2tf and tf2onnx rows)", "item 9 (the TensorFlow rows)")

    _export_saved_model = _export_tflite = _export_onnx = _export_tensorflow_row
