"""Greedy NMS keep mask: the CUDA kernel (csrc/greedy_nms.cu), its wrapper and
its plain PyTorch version.

Replaces spectrogram_yolov11_tpu/ops/pallas_nms.py:70 pallas_greedy_keep
(kernel body `_nms_kernel`, :30) and is the suppression step of the port's
NMS, in the place of the Jacobi fixpoint ops/nms.py:32 `_greedy_keep`.

What bounds it on the H100: the greedy scan is a chain of dependent steps,
each of which decides whether a candidate survives before it may suppress
later ones, so its time is latency, not bytes (k*(4*4+2) bytes in and out) or
operations (k^2/2 pair tests). The design splits the work accordingly:
  (a) mask: the IoU tests of valid rows in parallel, grid (k/64 column blocks,
      k/64 row blocks, b), 64 threads; thread i sets bit j of one uint64 word
      when j > i is valid and IoU(i, j) > thres, into a (b, k, k/64) scratch.
      Blocks left of the diagonal, or whose rows or columns are all invalid,
      return at once;
  (b) scan: one warp per image holds the k/64 <= 32 words of `valid` and of
      `removed` in registers, one word a lane; a step jumps to the next
      candidate that is valid and not removed (ballot and find-first-set),
      keeps it and ORs its mask row into `removed`. The chain has one step
      per kept box; `valid` need not be a prefix.
The IoU repeats ops/iou.py:box_iou's operation order and the file is built
with -fmad=false, so the mask equals the plain version's bit for bit even with
the 7680-px class offsets on the boxes.
"""

from __future__ import annotations

import torch

from ..utils import kernels
from .iou import box_iou

MAX_K = 2048  # k/64 words of `removed` must fit one warp


def greedy_keep_reference(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Plain version: the Jacobi fixpoint of ops/nms.py:_greedy_keep, batched.

    boxes (b, k, 4) xyxy sorted by descending score (class offset applied),
    valid (b, k) bool -> keep (b, k) bool. keep[i] = valid[i] and no kept j < i
    has IoU(j, i) > iou_thres; the iteration reaches that unique fixpoint in
    at most suppression-chain-depth steps."""
    k = boxes.shape[1]
    iou = box_iou(boxes, boxes)
    sup = (iou > iou_thres) & torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    keep = valid.clone()  # a new tensor: the operator's output may not alias its input
    for _ in range(k):
        new_keep = valid & ~(sup & keep[:, :, None]).any(1)
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def greedy_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Exact greedy NMS keep mask (b, k) bool, by the operator
    `syt::greedy_keep`. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (k <= 2048) or raises."""
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"greedy_keep: unsupported device {boxes.device}")
    return torch.ops.syt.greedy_keep(boxes, valid, float(iou_thres))


# The operator greedy_keep calls, so that an eager NMS and a torch.export
# program of it (engine/exporter.py) run the same code: the plain version for
# a CPU tensor, the kernel for a CUDA one, and for the fake tensors of a
# trace a (b, k) bool output. The plain version's loop reads the mask on the
# host (torch.equal), which a trace cannot hold: the operator keeps it out.
def _greedy_keep_cuda(boxes, valid, iou_thres):
    b, k, four = boxes.shape
    if four != 4 or boxes.dtype != torch.float32 or not boxes.is_contiguous() or boxes.data_ptr() % 16:
        raise ValueError(f"greedy_keep: boxes must be contiguous 16-byte aligned float32 (b, k, 4), "
                         f"got {boxes.dtype} {tuple(boxes.shape)}")
    if valid.shape != (b, k) or valid.dtype != torch.bool or not valid.is_contiguous() or valid.device != boxes.device:
        raise ValueError(f"greedy_keep: valid must be a contiguous bool (b, k) tensor on {boxes.device}")
    if not 0 < k <= MAX_K:
        raise ValueError(f"greedy_keep: k={k} outside 1..{MAX_K}")
    words = (k + 63) // 64
    mask = torch.empty((b, k, words), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0:
        return keep
    lib = kernels.load("greedy_nms")
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.greedy_nms_keep(boxes.data_ptr(), valid.data_ptr(), mask.data_ptr(), keep.data_ptr(),
                                  b, k, float(iou_thres), stream)
    kernels.check(err, "greedy_nms_keep")
    kernels.count(greedy_keep)
    return keep


def _greedy_keep_fake(boxes, valid, iou_thres):
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


_LIB = torch.library.Library("syt", "FRAGMENT")  # registered as ops/fused_conv.py registers its operators
_LIB.define("greedy_keep(Tensor boxes, Tensor valid, float iou_thres) -> Tensor")
_LIB.impl("greedy_keep", greedy_keep_reference, "CPU")
_LIB.impl("greedy_keep", _greedy_keep_cuda, "CUDA")
torch.library.register_fake("syt::greedy_keep", _greedy_keep_fake, lib=_LIB)


greedy_keep.launches = 0
